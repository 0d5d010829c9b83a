"""``--remat``: rematerialize a residual block on the backward pass (flax
``nn.remat``, as the JAX package's ResNet and ViT wrap their blocks).

The block's forward runs under ``torch.utils.checkpoint`` without saving
its inner activations, and the backward recomputes them.  A recomputed
forward must not advance a BatchNorm's running statistics a second time
(flax's remat updates them once a step), so the recompute runs with every
``BatchNorm2d`` of the block marked ``recomputing``.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from .norms import BatchNorm2d


@contextlib.contextmanager
def _recomputing(block: torch.nn.Module):
    norms = [m for m in block.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.recomputing = True
    try:
        yield
    finally:
        for m in norms:
            m.recomputing = False


def remat_block(block: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)``, its activations recomputed on the backward pass."""
    return checkpoint(
        block, x, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recomputing(block)),
    )
