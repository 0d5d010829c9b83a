"""Checkpointing: versioned run dirs, the best-only policy, the resumable
``last.ckpt`` (``distributed_training_comparison_tpu/train/checkpoint.py``,
its single-process functions, with the same names and rules).

Parity: the reference's ``save_checkpoint`` scans ``version-{n}`` dirs for
the first free slot (``src/single/trainer.py:52-59``) and, on a val-top1
improvement, replaces the best file ``best_model_epoch_{e}_acc_{a}``
(``:96-107``).  The reference saves only the model's weights; as in the JAX
package, ``last.ckpt`` carries the whole train state (params, BatchNorm
statistics, optimizer state, step, epoch, best accuracy), so a killed run
resumes.

Contents: the JAX package's.  A best file holds ``fmt``, ``params``,
``batch_stats``, ``epoch`` and ``val_acc``; ``last.ckpt`` holds ``fmt``,
``state`` (the JAX ``TrainState``'s state dict, ``train/state.py``),
``epoch`` and ``best_acc``; the trees have flax's names, layouts, shapes
and dtypes, and ``fmt`` is the JAX ``CKPT_FMT``.  File format: torch's,
``torch.save`` of CPU tensors, read back with ``torch.load(weights_only=True)``
(the JAX package writes msgpack; the port reads only its own files).
Writes are atomic, and ``last.ckpt`` carries an integrity manifest and a
rotated ``prev-last.ckpt`` (``resilience/ckpt_io.py``).

Under data parallelism process 0 alone writes, in the version dir it
claims and broadcasts (:func:`agreed_version_dir`); every process holds the
same state, so there is nothing to fetch across processes.  Left for later
(ROADMAP.md queue 1): the pipeline's canonical ``state_layout``, the
``--ckpt-comms-residual`` carry and ``FaultPlan.ckpt_hook``.
"""

from __future__ import annotations

import io
import logging
import pickle
import re
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..resilience.ckpt_io import (
    atomic_write_bytes,
    previous_path,
    read_and_hash,
    rotate_previous,
    verify_checkpoint,
    write_manifest,
)
from ..utils.logging import TRAIN_LOGGER

_log = logging.getLogger(f"{TRAIN_LOGGER}.checkpoint")

BEST_PREFIX = "best_model_"
LAST_NAME = "last.ckpt"

# The JAX package's checkpoint payload format (its ``CKPT_FMT``): 3 is the
# ViT's three separate q_proj/k_proj/v_proj Denses.  Every file the port
# writes is format 3.
CKPT_FMT = 3


def _to_torch(tree: Any) -> Any:
    """numpy leaves as CPU tensors (sharing their memory), for ``torch.save``."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):  # (``np.ascontiguousarray`` would make a 0-d leaf 1-d)
        return torch.from_numpy(tree if tree.flags.c_contiguous else tree.copy(order="C"))
    return tree


def _serialize(payload: dict) -> bytes:
    buf = io.BytesIO()
    torch.save(_to_torch(payload), buf)
    return buf.getvalue()


def _restore(data, path) -> dict:
    """A payload from its bytes: tensors, numbers and strings only."""
    try:
        raw = torch.load(io.BytesIO(data), map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise ValueError(
            f"{path} is not a checkpoint of the port (torch.save format); the port "
            "does not read the JAX package's msgpack checkpoints"
        ) from e
    fmt = raw.get("fmt", 1) if isinstance(raw, dict) else None
    if fmt != CKPT_FMT:
        raise ValueError(f"{path} is a format-{fmt} checkpoint; the port reads format {CKPT_FMT}")
    return raw


def _read(path) -> dict:
    return _restore(Path(path).read_bytes(), path)


def find_version_dir(ckpt_root: str | Path, create: bool = True) -> Path:
    """First nonexistent ``version-{n}`` under ``ckpt_root`` (reference
    ``src/single/trainer.py:52-59``).  The claim is the
    ``mkdir(exist_ok=False)``: two processes scanning at once cannot share
    a slot, the loser re-scans from the next index."""
    root = Path(ckpt_root)
    n = 0
    while True:
        d = root / f"version-{n}"
        if d.exists():
            n += 1
            continue
        if not create:
            return d
        try:
            d.mkdir(parents=True, exist_ok=False)
            return d
        except FileExistsError:  # lost the claim race; try the next slot
            n += 1


def agreed_version_dir(ckpt_root: str | Path, group=None) -> Path:
    """The version dir of a run of several processes: process 0 claims one
    (:func:`find_version_dir`) and the others take its pick, broadcast over
    ``group`` (``--ckpt-path`` is a filesystem every process shares).  A
    collective: every process of the group calls it.  Without a group, or
    in a group of one, the claim itself."""
    if group is None or dist.get_world_size(group) == 1:
        return find_version_dir(ckpt_root)
    pick = [find_version_dir(ckpt_root).name if dist.get_rank(group) == 0 else None]
    dist.broadcast_object_list(pick, src=0, group=group)
    return Path(ckpt_root) / pick[0]


def save_checkpoint(version_dir: str | Path, state, epoch: int, val_acc: float) -> Path:
    """Best-only save: write ``best_model_epoch_{e}_acc_{a:.4f}.ckpt`` with
    ``state.variables()`` (params and batch stats, what inference needs),
    then drop the previous best files, only after the new one is in place:
    a crash mid-save never leaves the version dir without a best file."""
    version_dir = Path(version_dir)
    variables = state.variables()
    payload = {
        "fmt": CKPT_FMT,
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "epoch": epoch,
        "val_acc": float(val_acc),
    }
    path = version_dir / f"{BEST_PREFIX}epoch_{epoch}_acc_{val_acc:.4f}.ckpt"
    atomic_write_bytes(path, _serialize(payload))
    for old in version_dir.glob(f"{BEST_PREFIX}*.ckpt"):
        if old != path:
            old.unlink()
    return path


def load_checkpoint(path: str | Path, state):
    """Restore params and batch stats from a best checkpoint into ``state``
    (a ``TrainState``: copied into its tensors); returns ``state``."""
    state.load_variables(_read(path))
    return state


def _version_dirs_newest_first(ckpt_root: str | Path) -> list[Path]:
    """``version-{n}`` dirs under ``ckpt_root``, numerically newest first:
    the one discovery rule --auto-resume and the serve engine share."""
    dirs = [d for d in Path(ckpt_root).glob("version-*") if d.name.split("-")[-1].isdigit()]
    return sorted(dirs, key=lambda d: -int(d.name.split("-")[-1]))


def find_latest_resume(ckpt_root: str | Path) -> Path | None:
    """The newest version dir's ``last.ckpt``, or None.  Only the newest
    version is considered: if it crashed before its first save (or ran with
    --no-save-last), auto-resume starts fresh rather than resuming an older,
    possibly completed run."""
    dirs = _version_dirs_newest_first(ckpt_root)
    if not dirs:
        return None
    path = dirs[0] / LAST_NAME
    return path if path.exists() else None


def valid_resume_bytes_in(version_dir: str | Path) -> tuple[Path, bytes] | None:
    """This version dir's ``last.ckpt`` if its integrity manifest checks
    out, else the rotated ``prev-last.ckpt``, else None, with the verified
    payload bytes (one read serves verify and restore)."""
    newest = Path(version_dir) / LAST_NAME
    for candidate in (newest, previous_path(newest)):
        if not candidate.exists():
            continue
        data, digest = read_and_hash(candidate)
        ok, reason = verify_checkpoint(candidate, data=data, digest=digest)
        if ok:
            if candidate != newest:
                _log.warning(
                    f"resume: {newest.name} failed verification; falling "
                    f"back to previous good checkpoint {candidate.name}"
                )
            return candidate, data
        _log.warning(f"resume: rejecting {candidate}: {reason}")
    return None


def find_valid_resume_bytes(ckpt_root: str | Path) -> tuple[Path, bytes] | None:
    """Verify-on-restore discovery for --auto-resume: the newest version
    dir's ``last.ckpt`` if it verifies, else its ``prev-last.ckpt``, else
    None; a torn ``last.ckpt`` costs one epoch of progress, never the run."""
    dirs = _version_dirs_newest_first(ckpt_root)
    if not dirs:
        return None
    return valid_resume_bytes_in(dirs[0])


def _best_sort_key(path: Path) -> tuple[int, float]:
    """(epoch, acc) parsed from ``best_model_epoch_{e}_acc_{a}.ckpt``:
    numeric, so ``epoch_9`` loses to ``epoch_10``; an unparseable name sorts
    first."""
    m = re.fullmatch(rf"{BEST_PREFIX}epoch_(\d+)_acc_([0-9.]+)\.ckpt", path.name)
    if not m:
        return (-1, -1.0)
    try:
        return (int(m.group(1)), float(m.group(2).rstrip(".")))
    except ValueError:  # e.g. acc "1.2.3": matched, but not a float
        return (-1, -1.0)


def find_best_checkpoint(version_dir: str | Path, cleanup: bool = False) -> Path | None:
    """The version dir's best file by numeric epoch (highest-acc
    tiebreak), as the reference's test phase globs it
    (``src/single/main.py:23-27``).  ``cleanup=True`` drops the stale
    losers a crash inside ``save_checkpoint`` can leave (only files of this
    naming scheme); a lookup mutates nothing by default."""
    hits = sorted(Path(version_dir).glob(f"{BEST_PREFIX}*.ckpt"), key=_best_sort_key)
    if not hits:
        return None
    best = hits[-1]
    if cleanup:
        for stale in hits[:-1]:
            if _best_sort_key(stale) != (-1, -1.0):
                stale.unlink(missing_ok=True)
    return best


def load_eval_variables(path: str | Path) -> tuple[dict, dict]:
    """``{"params", "batch_stats"}`` (flax layout, CPU tensors) from a best
    checkpoint or a ``last.ckpt`` (whose optimizer leaves are ignored), and
    its metadata: the epoch and the accuracy the file carries."""
    raw = _read(path)
    if "state" in raw:  # last.ckpt
        src, acc = raw["state"], float(raw.get("best_acc", 0.0))
    else:  # best_model_*
        src, acc = raw, float(raw.get("val_acc", 0.0))
    variables = {"params": src["params"], "batch_stats": src["batch_stats"]}
    return variables, {"epoch": int(raw.get("epoch", -1)), "acc": acc}


def find_serving_checkpoint(ckpt_root: str | Path) -> Path | None:
    """The newest version dir's best checkpoint (else its ``last.ckpt``):
    the serve engine's default discovery."""
    for d in _version_dirs_newest_first(ckpt_root):
        best = find_best_checkpoint(d)
        if best is not None:
            return best
        last = d / LAST_NAME
        if last.exists():
            return last
    return None


def save_resume_state(
    version_dir: str | Path, state, epoch: int, best_acc: float, meta: dict | None = None,
) -> Path:
    """Write the resumable ``last.ckpt`` of ``state.state_dict()``,
    crash-safely: the existing (size-valid) ``last.ckpt`` rotates to
    ``prev-last.ckpt``, the payload lands by tmp + fsync + rename, then the
    manifest (SHA-256, bytes, step, epoch, best accuracy, ``meta``) is
    written, so a crash between the two fails verification."""
    host_state = state.state_dict()
    payload = {"fmt": CKPT_FMT, "state": host_state, "epoch": epoch, "best_acc": float(best_acc)}
    path = Path(version_dir) / LAST_NAME
    data = _serialize(payload)
    rotate_previous(path)
    atomic_write_bytes(path, data)
    write_manifest(
        path,
        data,
        meta={
            "kind": "resume_state",
            "fmt": CKPT_FMT,
            "step": int(np.asarray(host_state["step"])),
            "epoch": int(epoch),
            "best_acc": float(best_acc),
            **(meta or {}),
        },
    )
    return path


def load_resume_state(path: str | Path, state, raw_bytes: bytes | None = None):
    """Restore ``state`` (a ``TrainState``, copied into its tensors) from a
    ``last.ckpt``; returns ``(state, next_epoch, best_acc)``.  ``raw_bytes``
    lets a caller that already read the file to verify it restore from the
    same buffer."""
    raw = _restore(raw_bytes, path) if raw_bytes is not None else _read(path)
    state.load_state_dict(raw["state"])
    return state, int(raw["epoch"]) + 1, float(raw["best_acc"])
