"""The LayerNorm dtype policy (``distributed_training_comparison_tpu/models/norms.py``).

Statistics reduce in ``norm_dtype`` (fp32 by default, under any compute
dtype) and the result is cast to the compute dtype; ``norm_dtype=None``
runs the norm on compute-dtype tensors instead (torch's kernel still
accumulates bf16 statistics in fp32).  eps is flax's default, 1e-6, not
torch's 1e-5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` under the zoo's ``norm_policy``; parameters
    ``weight`` (flax ``scale``) and ``bias`` are fp32."""

    def __init__(
        self,
        features: int,
        dtype: torch.dtype = torch.float32,
        norm_dtype: torch.dtype | None = torch.float32,
    ) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.norm_dtype = norm_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        work = self.norm_dtype if self.norm_dtype is not None else self.dtype
        y = F.layer_norm(
            x.to(work), self.weight.shape,
            self.weight.to(work), self.bias.to(work), eps=LN_EPS,
        )
        return y.to(self.dtype)
