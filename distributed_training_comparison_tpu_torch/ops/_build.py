"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes plain C functions and compiles on its own
into ``build/kernels/lib<name>-<hash>.so`` at the repository root.
The hash covers the source, the shared headers (``csrc/*.cuh``) and the
compiler flags, so an edited source never loads a stale library.  A build
starts on first use (or through :func:`build`) and writes through a
temporary file that is renamed into place, so concurrent builds never see a
half-written library.
:func:`build_all` runs one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module, and a
machine without ``nvcc`` only fails when a kernel is actually asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = (
    "flash_attention_fwd", "flash_attention_bwd", "vit_block_fwd", "vit_block_bwd",
    "moe_gmm_fwd", "moe_gmm_bwd", "attention_small",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the .log
)

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], object] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
        shutil.which("nvcc"),
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the port's CUDA kernels build only where the CUDA toolkit is installed"
    )


def library_path(name: str) -> Path:
    """Where ``name``'s library lives for the current source and flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile kernel ``name``'s library unless it is built already, and
    return its path.  The compiler's output is kept beside it as ``.log``.

    Raises ``RuntimeError`` with that output when the build fails.
    """
    path = library_path(name)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    path.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"kernel build failed: {name} (nvcc exit {proc.returncode}):\n{proc.stdout}"
        )
    os.replace(tmp, path)
    return path


def build_all(names=KERNELS) -> dict[str, Path]:
    """Build every library in ``names`` at once (one ``nvcc`` process per
    source, started together) and return their paths by name."""
    names = tuple(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str, argtypes: list, restype=ctypes.c_int, symbol: str | None = None):
    """C function ``symbol`` (default ``name``) of kernel library ``name``,
    built first if needed, with its ``argtypes`` and ``restype`` declared."""
    symbol = symbol or name
    with _lock:
        fn = _functions.get((name, symbol))
        if fn is None:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(str(build(name)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = restype
            _functions[(name, symbol)] = fn
        return fn
