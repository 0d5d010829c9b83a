"""Classification hits (``distributed_training_comparison_tpu/train/step.py:160-163``)."""

from __future__ import annotations

import torch


def topk_hits(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example (top-1, top-5) hit flags: one top-5 over the logits, top-1
    being its first entry."""
    top5 = torch.topk(logits, 5, dim=-1).indices
    hits = top5 == labels[:, None]
    return hits[:, :1].any(-1), hits.any(-1)
