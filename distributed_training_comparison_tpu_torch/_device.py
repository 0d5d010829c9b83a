"""Device choice: the card unless the caller asks for the CPU.

Counterpart of the device selection in
``distributed_training_comparison_tpu/parallel/mesh.py::make_mesh``.  The
port's kernels are built for Hopper (``sm_90a``), so asking for ``cuda``
checks the card's compute capability before any kernel loads, and asking
for ``cuda`` where there is no card raises: nothing moves to the CPU
silently.

A resolved card also gets fp32 math pinned to fp32 (:func:`pin_fp32_math`):
PyTorch's default lets cuDNN run fp32 convolutions as TF32, which would
change the default precision's numerics against the reference.
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


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device`` for ``"cuda"`` (device 0, or ``"cuda:N"``) or
    ``"cpu"``; a card also gets :func:`pin_fp32_math`."""
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
    cap = torch.cuda.get_device_capability(dev)
    if cap != HOPPER:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability {cap}; "
            f"the port's kernels are built for Hopper {HOPPER} (sm_90a)"
        )
    pin_fp32_math()
    return dev
