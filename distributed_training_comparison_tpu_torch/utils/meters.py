"""Host-side scalar accumulators (``distributed_training_comparison_tpu/utils/meters.py``)."""

from __future__ import annotations


class AverageMeter:
    """Tracks the latest value and a running (weighted) average."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0
