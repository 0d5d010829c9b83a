"""The fused block's weight-footprint gate
(``distributed_training_comparison_tpu/ops/vmem.py``).

The JAX package declines its fused ViT block kernel when the block's
weights, priced at the compute dtype's item size plus an fp32 gradient
accumulator each, exceed half of a TPU core's 16 MiB of VMEM.  The port
keeps that rule and that budget unchanged, so that ``block_fusion="auto"``
fuses exactly the configurations the JAX package fuses: ``vit_tiny``
(about 2.7 MB in bf16) fuses, ``vit_small`` (about 10.6 MB) composes.

The budget is the JAX package's decision rule, not a statement about the
H100's memory: the Hopper kernels stream the weights through shared memory
in tiles and hold none of them resident.
"""

from __future__ import annotations

import torch

# the JAX package's budget: half of a TPU core's 16 MiB VMEM planning number
WEIGHT_BUDGET_BYTES = 16 * 2**20 // 2


def fused_block_weight_bytes(dim: int, mlp_ratio: int, dtype: torch.dtype) -> int:
    """The JAX package's priced footprint of one fused block: the q/k/v/out
    and MLP weights and every bias and LayerNorm parameter, each element at
    the compute dtype's size plus 4 bytes (its fp32 gradient accumulator)."""
    kernels = (4 + 2 * mlp_ratio) * dim * dim
    biases = (4 + mlp_ratio + 1) * dim + 2 * 2 * dim
    return (kernels + biases) * (dtype.itemsize + 4)


def fits_weight_budget(nbytes: int) -> bool:
    """True when a footprint fits :data:`WEIGHT_BUDGET_BYTES`."""
    return nbytes <= WEIGHT_BUDGET_BYTES
