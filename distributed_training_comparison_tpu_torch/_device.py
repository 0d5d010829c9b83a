"""Device choice: the card unless the caller asks for the CPU.

Counterpart of the device selection in
``distributed_training_comparison_tpu/parallel/mesh.py::make_mesh``.  The
port's kernels are built for Hopper (``sm_90a``), so asking for ``cuda``
checks the card's compute capability before any kernel loads, and asking
for ``cuda`` where there is no card raises: nothing moves to the CPU
silently.

A resolved card also gets fp32 math pinned to fp32 (:func:`pin_fp32_math`):
PyTorch's default lets cuDNN run fp32 convolutions as TF32, which would
change the default precision's numerics against the reference.  And it
gets cuDNN held to its deterministic algorithms
(:func:`pin_deterministic_convolutions`): cuDNN's default fp32 weight
gradient sums with atomics, so one seed would not reproduce its own run,
and a run resumed from ``last.ckpt`` would not continue bit for bit.
``torch.use_deterministic_algorithms`` stays off: it fills every
``torch.empty`` with a kernel and makes cuBLAS raise without a workspace
setting, and no other training kernel of the port needs it.
"""

from __future__ import annotations

import torch

HOPPER = (9, 0)


def fp32_precision_knobs() -> dict:
    """The per-backend ``fp32_precision`` settings, by name.  cuDNN's rnn
    setting goes with conv's: the legacy ``cudnn.allow_tf32`` reads both and
    raises when they differ."""
    cudnn = torch.backends.cudnn
    return {"cudnn.conv": cudnn.conv, "cudnn.rnn": cudnn.rnn,
            "cuda.matmul": torch.backends.cuda.matmul}


def fp32_math_settings() -> dict[str, str]:
    """How the card runs fp32 convolutions and matmuls, as torch reads it,
    per backend: ``"ieee"`` (full fp32), ``"tf32"``, or ``"none"`` (torch's
    default: TF32 for cuDNN's convolutions, fp32 for cuBLAS's matmuls)."""
    return {name: knob.fp32_precision for name, knob in fp32_precision_knobs().items()}


def pin_fp32_math() -> dict[str, str]:
    """Pin cuDNN convolutions and cuBLAS matmuls to full fp32 (TF32 off)
    through the ``fp32_precision`` settings (never mixed with the legacy
    ``allow_tf32`` flags, which newer torch refuses to read after them) and
    return the settings read back.  bf16 work is unaffected."""
    for knob in fp32_precision_knobs().values():
        knob.fp32_precision = "ieee"
    settings = fp32_math_settings()
    if set(settings.values()) != {"ieee"}:
        raise RuntimeError(f"fp32 math did not pin to ieee: {settings}")
    return settings


def cudnn_determinism() -> dict[str, bool]:
    """cuDNN's algorithm choice as torch reads it: ``deterministic`` and
    ``benchmark``."""
    cudnn = torch.backends.cudnn
    return {"deterministic": bool(cudnn.deterministic), "benchmark": bool(cudnn.benchmark)}


def pin_deterministic_convolutions() -> dict[str, bool]:
    """Hold cuDNN to its deterministic algorithms, with no benchmarking
    (which may pick another algorithm from run to run), and return the
    settings read back (the original reference's ``fix_seed`` sets the
    same two)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    settings = cudnn_determinism()
    if settings != {"deterministic": True, "benchmark": False}:
        raise RuntimeError(f"cuDNN did not hold to deterministic algorithms: {settings}")
    return settings


def pin_card_math() -> dict:
    """The settings a resolved card runs under: :func:`pin_fp32_math` and
    :func:`pin_deterministic_convolutions`, both read back."""
    return {**pin_fp32_math(), **pin_deterministic_convolutions()}


def resolve_device(name: str = "cuda", local_rank: int | None = None) -> torch.device:
    """``torch.device`` for ``"cuda"`` (device 0, or ``"cuda:N"``) or
    ``"cpu"``; with ``local_rank`` (a data-parallel process's index on its
    host) ``"cuda"`` is that process's card, ``cuda:{local_rank}``, made
    the current device.  A card also gets :func:`pin_card_math` (fp32 math
    off TF32, cuDNN deterministic); the CPU changes no setting."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA device is available; "
            "pass --device cpu to run the plain PyTorch path on the CPU"
        )
    if local_rank is not None:
        if dev.index not in (None, local_rank):
            raise ValueError(f"device {name!r} is not local process {local_rank}'s card")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local process {local_rank} has no card: "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    cap = torch.cuda.get_device_capability(dev)
    if cap != HOPPER:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability {cap}; "
            f"the port's kernels are built for Hopper {HOPPER} (sm_90a)"
        )
    pin_card_math()
    return dev
