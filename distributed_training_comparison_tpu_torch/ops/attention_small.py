"""Short-sequence attention over the packed projection layout: the numerics
of ``distributed_training_comparison_tpu/ops/attention_small.py``
(``_softmax_small``, ``_head_probs``, ``head_fwd``) as plain PyTorch.

Per (item, head): fp32 scores times 1/√d, a max-shifted fp32 softmax
``e / Σe``, P rounded to the compute dtype, P·V accumulated in fp32 and
rounded once.  This is the attention stage of the fused ViT block (K5) and
the plain version its CUDA kernel ``block_attention`` is held against.

The TPU kernel stacks ``tb`` items into one ``(tb·S, tb·S)`` score matmul
masked block-diagonally to fill its matrix unit; off-diagonal blocks add
exact zeros, so per-item attention is the same function, and that is what
this module computes.  Non-causal only, as K5 is.
"""

from __future__ import annotations

import math

import torch


def head_fwd(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor, seq: int,
             scale: float) -> torch.Tensor:
    """One head's attention: ``qh``/``kh``/``vh`` are (B·S, D) rows of
    ``B`` items of ``seq`` tokens each; returns (B·S, D) in ``qh``'s dtype."""
    rows, d = qh.shape
    q, k, v = (t.reshape(rows // seq, seq, d).float() for t in (qh, kh, vh))
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(qh.dtype)
    o = torch.einsum("bqk,bkd->bqd", p.float(), v)
    return o.to(qh.dtype).reshape(rows, d)


def packed_attention_reference(
    qkv: torch.Tensor, *, seq: int, heads: int, scale: float | None = None
) -> torch.Tensor:
    """Multi-head attention of the packed ``(B·S, 3·dim)`` projections
    (q, k, v side by side, each ``heads`` columns blocks of ``dim // heads``)
    → ``(B·S, dim)`` in ``qkv``'s dtype, head-major columns as the output
    projection reads them."""
    rows, three_dim = qkv.shape
    dim = three_dim // 3
    if three_dim % 3 or dim % heads or rows % seq:
        raise ValueError(
            f"packed qkv {tuple(qkv.shape)} does not split into 3 x {heads} heads "
            f"over items of {seq} tokens"
        )
    d = dim // heads
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    outs = [
        head_fwd(
            qkv[:, h * d:(h + 1) * d],
            qkv[:, dim + h * d:dim + (h + 1) * d],
            qkv[:, 2 * dim + h * d:2 * dim + (h + 1) * d],
            seq, scale,
        )
        for h in range(heads)
    ]
    return torch.cat(outs, dim=1)
