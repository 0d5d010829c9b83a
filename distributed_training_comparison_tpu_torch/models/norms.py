"""The zoo's norm layers under the normalization-dtype policy
(``distributed_training_comparison_tpu/models/norms.py``).

Whenever ``norm_dtype`` is set (fp32 by default, the compute dtype under
``--bn-dtype compute``) the statistics reduce in fp32 and the affine runs
in fp32 on fp32 parameters, as flax's forced fp32 reductions do;
``norm_dtype=None`` runs the norm on compute-dtype tensors instead (torch's
kernels still accumulate bf16 statistics in fp32).

- ``LayerNorm``: eps is flax's default, 1e-6, not torch's 1e-5; the result
  is cast to the compute dtype (it feeds only dense layers, which cast
  their input to it).
- ``BatchNorm2d``: flax ``nn.BatchNorm`` as the ResNets configure it
  (``models/resnet.py``: decay 0.9, eps 1e-5), on NCHW tensors.  The batch
  statistics reduce over N, H and W, and the *biased* batch variance both
  normalizes and enters the running statistic (``torch.nn.BatchNorm2d``
  keeps the unbiased one).  The output is in ``norm_dtype`` (fp32 by
  default, so the ResNet's residual stream stays fp32 under bf16 compute).
  Given a process group (:func:`sync_batch_norm_`; the trainer gives one
  of more than one process), it reduces over the global batch, as the JAX
  BatchNorm does over a batch sharded on the mesh's data axis: each
  process's fp32 sums of x and x² and its count, all-reduced in one
  collective, give the global mean and the biased variance (flax's
  ``mean(x²) - mean(x)²``, held at 0 or above); the backward all-reduces
  their gradients, Σdy and Σdy·x in effect, in one more.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
# torch BatchNorm2d's eps and running-statistic update factor (flax's
# ``momentum`` is the decay of the running statistic: 0.9)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _work_dtype(norm_dtype: torch.dtype | None, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if norm_dtype is not None else dtype


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
        work = _work_dtype(self.norm_dtype, self.dtype)
        y = F.layer_norm(
            x.to(work), self.weight.shape,
            self.weight.to(work), self.bias.to(work), eps=LN_EPS,
        )
        return y.to(self.dtype)


class _AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over a process group, whose gradient is the sum
    of the output's gradients over the group: one collective each way."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm2d(nn.Module):
    """flax ``nn.BatchNorm`` under the zoo's ``norm_policy``, with the torch
    names: parameters ``weight`` (flax ``scale``) and ``bias``, buffers
    ``running_mean`` and ``running_var`` (flax ``batch_stats`` ``mean`` and
    ``var``), all fp32.  ``num_batches_tracked`` is kept so that a torch
    reference ``state_dict`` loads strictly; flax has no such counter, so it
    is never advanced or read.

    In train mode the batch statistics normalize and the running ones
    advance by ``BN_MOMENTUM``, unless ``recomputing`` is set (a
    rematerialized forward, ``models/remat.py``); in eval mode the running
    statistics normalize and stay as they are.  With ``group`` set to a
    process group, train mode reduces the batch statistics over the group
    (module docstring; a group of one process gives flax's formula over
    its own batch); eval mode issues no collective.
    """

    def __init__(
        self,
        features: int,
        dtype: torch.dtype = torch.float32,
        norm_dtype: torch.dtype | None = torch.float32,
    ) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.dtype = dtype
        self.norm_dtype = norm_dtype
        self.recomputing = False
        self.group = None

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over ``group``'s global batch: ``(x - mean) · γ /
        sqrt(var + eps) + β`` with the all-reduced fp32 statistics, the
        running ones advanced by them."""
        c = x.shape[1]
        xf = x.float()
        count = xf.new_full((1,), x.numel() // c)
        sums = _AllReduceSum.apply(
            torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3)), count]), self.group)
        mean = sums[:c] / sums[2 * c]
        var = (sums[c : 2 * c] / sums[2 * c] - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x - mean.to(x.dtype)[:, None, None]) * mul.to(x.dtype)[:, None, None]
        y = y + self.bias.to(x.dtype)[:, None, None]
        if not self.recomputing:
            with torch.no_grad():
                torch._foreach_lerp_([self.running_mean, self.running_var],
                                     [mean.detach(), var.detach()], BN_MOMENTUM)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(_work_dtype(self.norm_dtype, self.dtype))
        if not self.training:
            y = F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                training=False, eps=BN_EPS,
            )
        elif self.group is not None:
            y = self._synced(x)
        else:
            # the batch's mean and inverse std come back with the output:
            # the biased variance is invstd^-2 - eps, with no second pass
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, BN_EPS
            )
            if not self.recomputing:
                with torch.no_grad():
                    var = invstd.pow(-2).sub_(BN_EPS)
                    torch._foreach_lerp_(
                        [self.running_mean, self.running_var], [mean, var], BN_MOMENTUM
                    )
        return y.to(self.norm_dtype if self.norm_dtype is not None else self.dtype)


def sync_batch_norm_(model: nn.Module, group) -> int:
    """Reduce every :class:`BatchNorm2d` of ``model`` over ``group`` (None:
    each over its own batch, as without a group); returns how many."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in norms:
        m.group = group
    return len(norms)
