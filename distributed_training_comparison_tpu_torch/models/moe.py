"""Switch-style mixture-of-experts FFN
(``distributed_training_comparison_tpu/models/moe.py``).

Top-1 routing with the JAX layer's semantics: an fp32 router (``router``,
normal(0.02) weights), softmax, the chosen expert's probability as the
gate, and a static capacity ``cap = max(tile, ceil(ceil(n·cf/E)/tile)·tile)``
with ``tile = 8·4 // itemsize`` of the compute dtype (16 in bf16, 8 in
fp32), kept for parity; tokens past an expert's capacity are dropped (their
residual branch passes through unchanged).  The experts run in the compute
dtype from fp32 parameters ``w_up`` (E, d, h), ``b_up`` (E, h), ``w_down``
(E, h, d), ``b_down`` (E, d).

Three dispatches with bit-equal routing (every one keeps the first ``cap``
tokens of each expert in token order):

- ``"gmm"``: a counting-sort ``dest`` from a cumsum over the one-hot (held
  as (E, n), so that the cumsum runs along its contiguous axis: down the
  rows of an (n, E) one-hot the card's scan is serial over n), a row
  scatter into expert-sorted order, the grouped FFN (``ops/moe_gmm.py``:
  the CUDA kernels K7, and K8/K9 under autograd), then the gather back
  times the gate, in token order;
- ``"gather"``: a stable sort, a scatter into the (E·cap, d) capacity
  buffer, batched GEMMs, the gather back and the inverse permutation;
- ``"onehot"``: the GShard one-hot dispatch and combine contractions.

``"auto"`` takes ``gmm`` on a CUDA tensor when the JAX package's weight
budget admits it (``ops/vmem.py``: bf16 ``vit_moe`` does, fp32 does not),
else ``gather``, decided at call time (:meth:`SwitchFFN.resolved_dispatch`).
The JAX package's construction-time ``resolve_dispatch`` matters only under
expert parallelism, which the port does not have yet.  An explicit ``gmm``
on the CPU runs the kernels' plain versions.  The row scatter and gather
use ``index_copy`` and ``index_select`` on unique indices, so their
gradients are deterministic.

flax's ``sow`` becomes attributes set at every forward, as device tensors
(no host sync): ``aux_loss`` (``aux_weight · E · Σ_e f_e·P_e`` over the
pre-capacity assignment), ``dropped_frac`` and ``expert_load`` (E,).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.moe_gmm import grouped_ffn
from ..ops.vit_block import _gelu
from ..ops.vmem import fits_weight_budget, gmm_weight_bytes

DISPATCHES = ("auto", "gmm", "gather", "onehot")


def capacity(n: int, num_experts: int, capacity_factor: float, dtype: torch.dtype) -> int:
    """The static per-expert capacity of ``n`` tokens (the JAX formula)."""
    tile = 8 * 4 // dtype.itemsize
    cap = -(-n * capacity_factor // num_experts)
    return max(tile, int(math.ceil(cap / tile) * tile))


class SwitchFFN(nn.Module):
    """Top-1 (Switch) MoE feed-forward: router → dispatch → per-expert MLP →
    gate-weighted combine."""

    def __init__(
        self,
        dim: int,
        num_experts: int,
        mlp_ratio: int = 4,
        capacity_factor: float = 1.25,
        dtype: torch.dtype = torch.float32,
        aux_weight: float = 0.01,
        dispatch: str = "auto",
    ) -> None:
        super().__init__()
        if dispatch not in DISPATCHES:
            raise ValueError(f"unknown MoE dispatch {dispatch!r}")
        hidden = mlp_ratio * dim
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.aux_weight = aux_weight
        self.dispatch = dispatch
        self.router = nn.Linear(dim, num_experts)
        self.w_up = nn.Parameter(torch.empty(num_experts, dim, hidden))
        self.b_up = nn.Parameter(torch.zeros(num_experts, hidden))
        self.w_down = nn.Parameter(torch.empty(num_experts, hidden, dim))
        self.b_down = nn.Parameter(torch.zeros(num_experts, dim))
        self.aux_loss: torch.Tensor | None = None
        self.dropped_frac: torch.Tensor | None = None
        self.expert_load: torch.Tensor | None = None
        self.init_weights()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initializers: the router normal(0.02) with a zero bias; each
        expert's (d, h) and (h, d) matrices xavier-uniform over their own
        fans (flax ``batch_axis=0``), bound sqrt(6 / (d + h)); zero biases."""
        nn.init.normal_(self.router.weight, std=0.02, generator=generator)
        nn.init.zeros_(self.router.bias)
        for w in (self.w_up, self.w_down):
            bound = math.sqrt(6.0 / (w.shape[1] + w.shape[2]))
            nn.init.uniform_(w, -bound, bound, generator=generator)
        nn.init.zeros_(self.b_up)
        nn.init.zeros_(self.b_down)

    def resolved_dispatch(self, device: torch.device) -> str:
        """``dispatch`` with ``"auto"`` decided for ``device``."""
        if self.dispatch != "auto":
            return self.dispatch
        ne, d, h = self.w_up.shape
        fits = fits_weight_budget(gmm_weight_bytes(ne, d, h, self.dtype))
        return "gmm" if device.type == "cuda" and fits else "gather"

    def _experts(self, block_in, w_up, b_up, w_down, b_down):
        """(E, cap, d) → (E, cap, d): the batched expert MLP in the compute
        dtype (GEMMs accumulate in fp32, as cuBLAS does for bf16)."""
        h = torch.bmm(block_in, w_up) + b_up[:, None]
        return torch.bmm(_gelu(h), w_down) + b_down[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        n, ne = b * s, self.num_experts
        cd = self.dtype
        cap = capacity(n, ne, self.capacity_factor, cd)

        xt = x.reshape(n, d)
        logits = F.linear(xt.float(), self.router.weight.float(), self.router.bias.float())
        probs = torch.softmax(logits, dim=-1)  # (n, E) fp32
        gate = probs.amax(dim=-1)
        eid = probs.argmax(dim=-1)  # the first maximum, as jnp.argmax
        experts = torch.arange(ne, device=x.device)
        onehot_t = (eid[None, :] == experts[:, None]).long()  # (E, n)

        # Switch load-balance loss over the pre-capacity assignment, and the
        # routing health: every dispatch keeps the first cap tokens of each
        # expert of this same assignment
        frac = onehot_t.float().mean(1)
        self.aux_loss = self.aux_weight * (ne * (frac * probs.mean(0)).sum())
        counts = onehot_t.sum(1)
        self.dropped_frac = (counts - cap).clamp_min(0).sum().float() / n
        self.expert_load = frac

        w_up, b_up, w_down, b_down = (
            p.to(cd) for p in (self.w_up, self.b_up, self.w_down, self.b_down)
        )
        dispatch = self.resolved_dispatch(x.device)
        if dispatch == "gmm":
            # counting sort: a token's rank within its expert from a cumsum
            # over the one-hot; rank order is stable-sort order, so the kept
            # sets equal the gather dispatch's.  dest is a permutation of [0, n)
            pos = torch.cumsum(onehot_t, dim=1).gather(0, eid[None]).squeeze(0) - 1
            starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, dim=0)])
            dest = starts.index_select(0, eid) + pos
            xs = xt.new_zeros((n, d), dtype=cd).index_copy(0, dest, xt.to(cd))
            ys = grouped_ffn(xs, w_up, b_up, w_down, b_down, starts.to(torch.int32), cap)
            y = ys.index_select(0, dest) * gate.to(cd)[:, None]
        elif dispatch == "onehot":
            # a token's slot in its expert's buffer, -1 where not routed; a
            # slot at or past cap (dropped) one-hots to an all-zero row
            pos = (torch.cumsum(onehot_t, dim=1) * onehot_t - 1).T  # (n, E)
            disp = (pos[..., None] == torch.arange(cap, device=x.device)).to(cd)  # (n, E, cap)
            combine = disp * gate.to(cd)[:, None, None]
            expert_in = torch.einsum("nec,nd->ecd", disp, xt.to(cd))
            out_e = self._experts(expert_in, w_up, b_up, w_down, b_down)
            y = torch.einsum("ecd,nec->nd", out_e.float(), combine.float())
        elif dispatch == "gather":
            # stable sort by expert: within an expert, token order, so the
            # kept sets equal the cumsum formulation's
            order = torch.argsort(eid, stable=True)
            sorted_e = eid.index_select(0, order)
            first = torch.searchsorted(sorted_e, experts)
            pos_sorted = torch.arange(n, device=x.device) - first.index_select(0, sorted_e)
            # over-capacity tokens go to a trash row past the E·cap buffer
            slot = torch.where(pos_sorted < cap, sorted_e * cap + pos_sorted, ne * cap)
            buf = xt.new_zeros((ne * cap + 1, d), dtype=cd).index_copy(
                0, slot, xt.to(cd).index_select(0, order)
            )
            out_e = self._experts(buf[:-1].view(ne, cap, d), w_up, b_up, w_down, b_down)
            out_flat = torch.cat([out_e.reshape(ne * cap, d), out_e.new_zeros((1, d))])
            y_sorted = out_flat.index_select(0, slot) * gate.index_select(0, order).to(cd)[:, None]
            inv = torch.empty_like(order).index_copy_(0, order, torch.arange(n, device=x.device))
            y = y_sorted.index_select(0, inv)
        else:
            raise ValueError(f"unknown MoE dispatch {dispatch!r}")
        return y.reshape(b, s, d).to(cd)
