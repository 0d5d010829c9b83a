"""Crash-safe checkpoint I/O: atomic writes, integrity manifests, rotation
(``distributed_training_comparison_tpu/resilience/ckpt_io.py``, the part
the checkpoint path uses; it imports no JAX and the port keeps its own
copy).

- ``atomic_write_bytes``: tmp file + ``flush`` + ``fsync`` + ``os.replace``
  + directory fsync, so the rename itself is durable, not just ordered;
- a sidecar **manifest** (``<name>.manifest.json``) carrying the payload's
  SHA-256, byte count and train-state metadata (step, epoch), written
  *after* the payload, so a crash between the two leaves a stale manifest
  that fails verification (never a fresh manifest blessing torn bytes);
  for the same bytes and metadata its JSON is the JAX package's;
- **rotation**: before a new ``last.ckpt`` lands, the previous one is
  renamed to ``prev-last.ckpt``, which restore falls back to when the
  newest file fails its manifest check.

A checkpoint without a manifest is accepted as legacy, as in the JAX
package.  The JAX module's quarantine sidecars come with the health
watchdog (ROADMAP.md queue 1).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import threading
from pathlib import Path

MANIFEST_SUFFIX = ".manifest.json"
PREV_PREFIX = "prev-"

# read/hash pipeline granularity: large enough that hashlib releases the
# GIL for real work per chunk, small enough that two in-flight chunks are
# noise next to a multi-GB state
HASH_CHUNK_BYTES = 8 << 20
# below this size the pipeline is pure overhead: a page-cached read is a
# memcpy the hash cannot hide behind, and the thread/chunking tax was
# measured in the JAX package at ~2x a plain read-then-hash — so small
# states keep a plain serial pass, and the pipeline engages only
# where it was designed to win: multi-GB states whose storage read is the
# long pole
PIPELINE_MIN_BYTES = 256 << 20


def read_and_hash(
    path: str | Path,
    chunk_bytes: int = HASH_CHUNK_BYTES,
    pipeline_min_bytes: int = PIPELINE_MIN_BYTES,
) -> tuple[bytes | bytearray, str]:
    """One-pass read + SHA-256 of a checkpoint payload, pipelined when the
    payload is large enough for overlap to pay.

    Verify-on-restore reads the file once and serves both the checksum and
    the restore from the same buffer.  Below ``pipeline_min_bytes`` that is
    a plain read-then-hash (fastest for warm/small files).  Above it, a
    reader thread ``readinto``s chunk *i+1* of a preallocated buffer while
    the main thread hashes chunk *i* (both sides release the GIL at these
    chunk sizes, so the overlap is real and assembly is zero-copy): for
    multi-GB states on real storage — where the read, not the hash, is the
    long pole — the wall-clock approaches ``max(read, hash)`` instead of
    their sum.

    Returns ``(data, hexdigest)`` — ``data`` is bytes-like (``bytes`` on the
    small path, the pipeline's ``bytearray`` on the large one: returning the
    buffer itself keeps peak host memory at ONE state's worth instead of
    doubling a multi-GB restore with a defensive copy).  Callers treat it as
    read-only; every consumer (``torch.load`` through ``io.BytesIO``, ``len``, ``sha256``) takes
    any buffer-protocol object.  Reader errors (including the file shrinking
    mid-read) re-raise here.
    """
    path = Path(path)
    size = path.stat().st_size
    if size < pipeline_min_bytes:
        data = path.read_bytes()
        return data, hashlib.sha256(data).hexdigest()
    buf = bytearray(size)
    view = memoryview(buf)
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def read() -> None:
        try:
            with open(path, "rb") as f:
                offset = 0
                while not stop.is_set() and offset < size:
                    want = min(chunk_bytes, size - offset)
                    got = f.readinto(view[offset : offset + want])
                    if not got:
                        raise OSError(
                            f"{path} truncated while reading: expected "
                            f"{size} bytes, got {offset}"
                        )
                    q.put((offset, got))
                    offset += got
                q.put(None)
        except BaseException as e:  # surfaced at the consumer
            q.put(e)

    thread = threading.Thread(target=read, name="dtc-ckpt-read", daemon=True)
    thread.start()
    digest = hashlib.sha256()
    try:
        while True:
            try:
                item = q.get(timeout=5.0)
            except queue.Empty:
                # a reader that died without enqueueing (not even its
                # exception) must not hang restore forever on a bare get
                if not thread.is_alive():
                    raise OSError(
                        f"{path}: checkpoint reader thread died without "
                        "delivering a result"
                    )
                continue
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            offset, got = item
            digest.update(view[offset : offset + got])
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=10.0)
    return buf, digest.hexdigest()


def hash_file(path: str | Path, chunk_bytes: int = HASH_CHUNK_BYTES) -> str:
    """Streaming SHA-256 of a file in O(chunk_bytes) host memory — the
    digest-only verify path must not allocate a whole multi-GB state just to
    throw the bytes away."""
    digest = hashlib.sha256()
    buf = bytearray(chunk_bytes)
    view = memoryview(buf)
    with open(path, "rb") as f:
        while True:
            got = f.readinto(view)
            if not got:
                break
            digest.update(view[:got])
    return digest.hexdigest()


def manifest_path(path: str | Path) -> Path:
    path = Path(path)
    return path.with_name(path.name + MANIFEST_SUFFIX)


def previous_path(path: str | Path) -> Path:
    """The rotation target for ``path`` (``last.ckpt`` → ``prev-last.ckpt``)."""
    path = Path(path)
    return path.with_name(PREV_PREFIX + path.name)


def _fsync_dir(directory: Path) -> None:
    """Make a rename in ``directory`` durable (POSIX: the rename is only on
    disk once the directory inode is)."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:  # e.g. O_RDONLY on a dir unsupported (some platforms)
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str | Path, data: bytes, durable: bool = True) -> Path:
    """Write ``data`` to ``path`` via tmp+fsync+rename: readers never observe
    a partial file, and after return the content survives power loss."""
    path = Path(path)
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(data)
        if durable:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if durable:
        _fsync_dir(path.parent)
    return path


def write_manifest(path: str | Path, data: bytes, meta: dict | None = None) -> Path:
    """Write the sidecar integrity manifest for a payload already at
    ``path`` whose bytes are ``data``.  Call AFTER the payload write: the
    crash window then holds a stale manifest (checksum mismatch → fallback),
    never a fresh manifest over torn bytes."""
    record = {
        "sha256": hashlib.sha256(data).hexdigest(),
        "bytes": len(data),
        **(meta or {}),
    }
    return atomic_write_bytes(
        manifest_path(path), json.dumps(record, indent=1).encode()
    )


def read_manifest(path: str | Path) -> dict | None:
    """The manifest dict for checkpoint ``path``, or None (missing/corrupt)."""
    mpath = manifest_path(path)
    try:
        return json.loads(mpath.read_bytes())
    except (OSError, ValueError):
        return None


def verify_checkpoint(
    path: str | Path,
    deep: bool = True,
    data: bytes | None = None,
    digest: str | None = None,
) -> tuple[bool, str]:
    """``(ok, reason)`` for the payload at ``path`` against its manifest.

    ``deep=False`` skips the checksum (size-only) — the cheap pre-rotation
    check, so each epoch's save does not re-hash the previous multi-GB file.
    ``data`` lets a caller that has already read the payload (to restore
    it) verify that buffer instead of paying a second full-file read;
    ``digest`` additionally skips re-hashing when the caller got both from
    ``read_and_hash`` (the hash was computed while the read was in flight —
    the whole verify then costs ~zero extra over the restore read).  A
    checkpoint without a manifest is accepted as legacy (pre-manifest run
    dirs must keep resuming); its parseability is the loader's problem.
    """
    path = Path(path)
    if not path.exists():
        return False, "missing"
    manifest = read_manifest(path)
    if manifest is None:
        # Absent manifest = legacy checkpoint, accepted.  A manifest that
        # EXISTS but does not parse is corruption in the same event that
        # may have torn the payload — rejecting it sends restore to the
        # verified prev- fallback instead of trusting unverifiable bytes
        # (and keeps rotate_previous from evicting the good prev copy).
        if manifest_path(path).exists():
            return False, "manifest present but unreadable (corrupted)"
        return True, "no manifest (legacy checkpoint, accepted unverified)"
    size = len(data) if data is not None else path.stat().st_size
    if size != manifest.get("bytes"):
        return False, f"size mismatch: {size} on disk vs {manifest.get('bytes')} in manifest"
    if deep:
        if data is not None and digest is not None:
            found = digest
        elif data is not None:
            found = hashlib.sha256(data).hexdigest()
        else:
            found = hash_file(path)
        if found != manifest.get("sha256"):
            return False, "checksum mismatch (torn or corrupted write)"
    return True, "verified"


def rotate_previous(path: str | Path) -> Path | None:
    """Rename an existing (size-valid) ``path`` + manifest to the ``prev-``
    slot, making room for a new write while keeping one good fallback.

    A size-invalid current file is NOT rotated — it would evict a good
    ``prev-`` checkpoint in favor of known-torn bytes.  Returns the rotated
    path, or None if nothing was rotated.
    """
    path = Path(path)
    if not path.exists():
        return None
    ok, _ = verify_checkpoint(path, deep=False)
    if not ok:
        return None
    prev = previous_path(path)
    os.replace(path, prev)
    mpath = manifest_path(path)
    prev_manifest = manifest_path(prev)
    if mpath.exists():
        os.replace(mpath, prev_manifest)
    else:  # legacy current had no manifest: drop any stale prev manifest
        prev_manifest.unlink(missing_ok=True)
    return prev
