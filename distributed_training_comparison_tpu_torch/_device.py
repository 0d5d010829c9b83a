"""Device choice: the card unless the caller asks for the CPU.

Counterpart of the device selection in
``distributed_training_comparison_tpu/parallel/mesh.py::make_mesh``.  The
port's kernels are built for Hopper (``sm_90a``), so asking for ``cuda``
checks the card's compute capability before any kernel loads, and asking
for ``cuda`` where there is no card raises: nothing moves to the CPU
silently.
"""

from __future__ import annotations

import torch

HOPPER = (9, 0)


def resolve_device(name: str = "cuda") -> torch.device:
    """``torch.device`` for ``"cuda"`` (device 0, or ``"cuda:N"``) or ``"cpu"``."""
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
    return dev
