"""The grouped expert FFN over expert-sorted tokens: the plain PyTorch
versions and the CUDA kernels that replace the Pallas kernels of
``distributed_training_comparison_tpu/ops/moe_gmm.py``: ``_ffn_kernel``
(K7, the forward), ``_dx_kernel`` (K8) and ``_dw_kernel`` (K9).

``grouped_ffn(xs, w1, b1, w2, b2, starts, cap)`` computes, for each expert
``e`` and each row of its kept range ``[starts[e], starts[e] +
min(starts[e+1] - starts[e], cap))``,

    gelu(xs[r] @ w1[e] + b1[e]) @ w2[e] + b2[e]

and exactly 0 for every other row (dropped past the capacity, or padding
past ``starts[E]``), with the JAX kernels' numerics: each product
accumulates in fp32 over its whole depth and is rounded to the compute
dtype once, before its bias add; the bias add is rounded to the compute
dtype; the tanh gelu is taken in fp32 on that sum and rounded once, the
rounding point of the port's K5 (``ops/vit_block.py``).  The layouts are
the JAX ones: W1 (E, d, h), W2 (E, h, d), no transposes.

Under autograd it goes through ``_GroupedFFN``, the counterpart of the JAX
``_gmm_core`` custom VJP: it saves xs, the weights and ``starts`` only,
and its backward recomputes the pre-gelu activation (``_dh_chain``): dx
through K8 and the four weight gradients, summed in fp32 and cast to the
weights' dtype, through K9.

A CPU tensor takes the plain versions (:func:`grouped_ffn_reference`,
:func:`grouped_ffn_dx_reference`, :func:`grouped_ffn_dw_reference`); a
CUDA tensor launches the kernels (``csrc/moe_gmm_fwd.cu``,
``csrc/moe_gmm_bwd.cu``) or raises.  Each wrapper counts its launches in a
plain-int ``launches`` attribute.  In bf16, K7 and K9 are Hopper kernels
(``moe_ffn_fwd_wgmma``, ``moe_ffn_dw_wgmma``: TMA, ``wgmma``, the
activation in registers) that read ``starts`` on the card themselves; the
host sizes their grids from shapes alone, and :func:`expert_tiles` and
:func:`dw_walks` mirror their schedules in plain Python for the tests.  K8
and the fp32 kernels are the first port's.
"""

from __future__ import annotations

import ctypes

import torch

from .vit_block import _gelu, _gelu_bwd, _operand, _stream

KERNEL_DTYPES = (torch.bfloat16, torch.float32)
KERNEL_DIMS = (192,)  # the kernels' model widths: vit_moe's
# the hidden width must be a multiple of the chunk the kernels walk it in:
# 64 columns in bf16 (one TMA box, K7's and K9's wgmma width), 32 in fp32
HIDDEN_MULTIPLE = {torch.bfloat16: 64, torch.float32: 32}
MAX_EXPERTS = 64
TILE_ROWS = 64  # a bf16 consumer warpgroup's rows: the wgmma M
UNIT_ROWS = 2 * TILE_ROWS  # K7's unit of work: a tile for each of its two warpgroups
K9_CLUSTER = 2  # CTAs (a cluster) each K9 owner's row walk splits over: kDwCluster


def kept_ranges(starts: torch.Tensor, cap: int, n: int) -> list[tuple[int, int]]:
    """Each expert's kept rows ``[lo, hi)``: the first ``min(count, cap)``
    rows of its group, never past ``n``.  Reads ``starts`` on the host."""
    st = [int(v) for v in starts.tolist()]
    return [(lo, min(lo + min(hi - lo, cap), n)) for lo, hi in zip(st[:-1], st[1:])]


def kept_mask(starts: torch.Tensor, cap: int, n: int) -> torch.Tensor:
    """(n,) bool: the rows that lie in some expert's kept range."""
    mask = torch.zeros(n, dtype=torch.bool, device=starts.device)
    for lo, hi in kept_ranges(starts, cap, n):
        if hi > lo:
            mask[lo:hi] = True
    return mask


def expert_tiles(starts: torch.Tensor, cap: int, n: int) -> list[tuple[int, int, int]]:
    """K7's bf16 schedule (``csrc/moe_gmm_hopper.cuh::expert_unit``) in plain
    Python, for the tests; nothing on the card path calls it, the kernel
    reads ``starts`` itself.  Tile ``2u + v`` is ``(e, lo, hi)``, the rows
    warpgroup v of unit u takes: units are up to ``UNIT_ROWS`` rows of one
    expert's kept range, expert by expert, and a unit's second tile is empty
    (``lo == hi``) where the unit has ``TILE_ROWS`` rows or fewer.  The launch
    sizes its grid from shapes alone, ``ceil(n / UNIT_ROWS) + E`` units: more
    than any routing of n rows over E experts needs."""
    tiles = []
    for e, (lo, hi) in enumerate(kept_ranges(starts, cap, n)):
        for u0 in range(lo, hi, UNIT_ROWS):
            u1 = min(u0 + UNIT_ROWS, hi)
            for v in range(2):
                t0 = min(u0 + v * TILE_ROWS, u1)
                tiles.append((e, t0, min(t0 + TILE_ROWS, u1)))
    return tiles


def dw_walks(starts: torch.Tensor, cap: int, n: int, hidden: int):
    """K9's bf16 schedule (``csrc/moe_gmm_bwd.cu::moe_ffn_dw_wgmma``) in plain
    Python, for the tests: for each CTA of the grid, in launch order, ``(e,
    c, lo, hi)``, the rows ``[lo, hi)`` of expert e's kept range it walks
    for hidden chunk c, the owner (e, c)'s 64-row steps split over
    ``K9_CLUSTER`` CTAs in order (a CTA of a short walk may get none)."""
    out = []
    for e, (lo, hi) in enumerate(kept_ranges(starts, cap, n)):
        steps = -(-(hi - lo) // TILE_ROWS) if hi > lo else 0
        for c in range(hidden // TILE_ROWS):
            for rank in range(K9_CLUSTER):
                k0, k1 = rank * steps // K9_CLUSTER, (rank + 1) * steps // K9_CLUSTER
                out.append((e, c, min(lo + TILE_ROWS * k0, hi), min(lo + TILE_ROWS * k1, hi)))
    return out


def _up(x, w1_e, b1_e):
    """The pre-gelu activation: ``round(x @ w1) + b1`` in the compute dtype."""
    return (x.float() @ w1_e.float()).to(x.dtype) + b1_e


def grouped_ffn_reference(xs, w1, b1, w2, b2, starts, cap: int) -> torch.Tensor:
    """The plain version of K7 (``_ffn_kernel``), expert by expert."""
    out = torch.zeros_like(xs)
    for e, (lo, hi) in enumerate(kept_ranges(starts, cap, xs.shape[0])):
        if hi > lo:
            g = _gelu(_up(xs[lo:hi], w1[e], b1[e]))
            out[lo:hi] = (g.float() @ w2[e].float()).to(xs.dtype) + b2[e]
    return out


def _dh(x, dym, w1_e, b1_e, w2_e):
    """``_dh_chain``: the pre-gelu cotangent and gelu(h1), compute dtype."""
    h1 = _up(x, w1_e, b1_e)
    dg = (dym.float() @ w2_e.float().T).to(x.dtype)
    return _gelu_bwd(h1, dg), _gelu(h1)


def grouped_ffn_dx_reference(xs, dy, w1, b1, w2, starts, cap: int) -> torch.Tensor:
    """The plain version of K8 (``_dx_kernel``): dx, 0 on the rows no
    expert keeps."""
    dx = torch.zeros_like(xs)
    for e, (lo, hi) in enumerate(kept_ranges(starts, cap, xs.shape[0])):
        if hi > lo:
            dh, _ = _dh(xs[lo:hi], dy[lo:hi], w1[e], b1[e], w2[e])
            dx[lo:hi] = (dh.float() @ w1[e].float().T).to(xs.dtype)
    return dx


def grouped_ffn_dw_reference(xs, dy, w1, b1, w2, starts, cap: int):
    """The plain version of K9 (``_dw_kernel``): ``(dw1, db1, dw2, db2)``
    in fp32, zero for an expert that keeps no row."""
    ne, d, h = w1.shape
    dw1 = torch.zeros((ne, d, h), device=xs.device)
    db1 = torch.zeros((ne, h), device=xs.device)
    dw2 = torch.zeros((ne, h, d), device=xs.device)
    db2 = torch.zeros((ne, d), device=xs.device)
    for e, (lo, hi) in enumerate(kept_ranges(starts, cap, xs.shape[0])):
        if hi > lo:
            x, dym = xs[lo:hi], dy[lo:hi]
            dh, g = _dh(x, dym, w1[e], b1[e], w2[e])
            dw1[e] = x.float().T @ dh.float()
            db1[e] = dh.float().sum(0)
            dw2[e] = g.float().T @ dym.float()
            db2[e] = dym.float().sum(0)
    return dw1, db1, dw2, db2


# ------------------------------------------------------------------ card


def _check_card(name: str, xs, w1, b1, w2, starts, b2=None, dy=None) -> None:
    """What the kernels take; raises on anything else."""
    if xs.dim() != 2 or xs.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} takes 2-D bf16 or fp32 tokens, got {xs.dtype} {tuple(xs.shape)}")
    n, d = xs.shape
    if w1.dim() != 3:
        raise ValueError(f"{name}: w1 must be (E, d, h), got {tuple(w1.shape)}")
    ne, _, h = w1.shape
    multiple = HIDDEN_MULTIPLE[xs.dtype]
    if d not in KERNEL_DIMS or h % multiple or not 1 <= ne <= MAX_EXPERTS:
        raise ValueError(
            f"{name}'s CUDA kernels take d in {KERNEL_DIMS}, hidden a multiple of "
            f"{multiple} in {xs.dtype} and 1 to {MAX_EXPERTS} experts, got d={d}, h={h}, E={ne}"
        )
    want = {"w1": (ne, d, h), "b1": (ne, h), "w2": (ne, h, d)}
    got = {"w1": w1, "b1": b1, "w2": w2}
    if b2 is not None:
        want["b2"], got["b2"] = (ne, d), b2
    if dy is not None:
        want["dy"], got["dy"] = (n, d), dy
    for key, t in got.items():
        if tuple(t.shape) != want[key] or t.dtype != xs.dtype or t.device != xs.device:
            raise ValueError(
                f"{name}: {key} must be {want[key]} {xs.dtype} on {xs.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if starts.shape != (ne + 1,) or starts.dtype != torch.int32 or starts.device != xs.device:
        raise ValueError(f"{name}: starts must be ({ne + 1},) int32 on {xs.device}")


def _launch(library: str, symbol: str, ptrs: list, ints: list, stream: int) -> None:
    from . import _build

    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = _build.load(library, [ptr] * len(ptrs) + [i32] * len(ints) + [ptr], symbol=symbol)
    err = fn(*ptrs, *ints, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def _dims(xs, w1, cap):
    n, d = xs.shape
    ne, _, h = w1.shape
    return [n, d, h, ne, int(cap), int(xs.dtype == torch.bfloat16)]


def grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, cap: int) -> torch.Tensor:
    """:func:`grouped_ffn_reference`'s function; on the card the CUDA
    kernel ``moe_gmm_fwd`` (K7: ``moe_ffn_fwd_wgmma`` in bf16, one block a
    unit of :func:`expert_tiles`), which takes d of 192 (``KERNEL_DIMS``),
    hidden a multiple of 64 in bf16 and 32 in fp32 (``HIDDEN_MULTIPLE``),
    up to 64 experts, all operands in the compute dtype and ``starts``
    int32 on the card.  ``grouped_ffn_fwd.launches`` counts its launches."""
    if xs.device.type == "cpu":
        return grouped_ffn_reference(xs, w1, b1, w2, b2, starts, cap)
    _check_card("grouped_ffn_fwd", xs, w1, b1, w2, starts, b2=b2)
    out = torch.empty_like(xs, memory_format=torch.contiguous_format)
    if xs.shape[0] == 0:
        return out
    ops = [_operand(t) for t in (xs, w1, b1, w2, b2, starts)]
    with torch.cuda.device(xs.device):
        _launch("moe_gmm_fwd", "moe_gmm_fwd", [t.data_ptr() for t in ops] + [out.data_ptr()],
                _dims(xs, w1, cap), _stream(xs))
    grouped_ffn_fwd.launches += 1
    return out


grouped_ffn_fwd.launches = 0


def grouped_ffn_dx(xs, dy, w1, b1, w2, starts, cap: int) -> torch.Tensor:
    """:func:`grouped_ffn_dx_reference`'s function; on the card the CUDA
    kernel ``moe_gmm_dx`` (K8), with K7's shape rules.
    ``grouped_ffn_dx.launches`` counts its launches."""
    if xs.device.type == "cpu":
        return grouped_ffn_dx_reference(xs, dy, w1, b1, w2, starts, cap)
    _check_card("grouped_ffn_dx", xs, w1, b1, w2, starts, dy=dy)
    dx = torch.empty_like(xs, memory_format=torch.contiguous_format)
    if xs.shape[0] == 0:
        return dx
    ops = [_operand(t) for t in (xs, dy, w1, b1, w2, starts)]
    with torch.cuda.device(xs.device):
        _launch("moe_gmm_bwd", "moe_gmm_dx", [t.data_ptr() for t in ops] + [dx.data_ptr()],
                _dims(xs, w1, cap), _stream(xs))
    grouped_ffn_dx.launches += 1
    return dx


grouped_ffn_dx.launches = 0


def grouped_ffn_dw(xs, dy, w1, b1, w2, starts, cap: int):
    """:func:`grouped_ffn_dw_reference`'s function, ``(dw1, db1, dw2,
    db2)`` in fp32; on the card the CUDA kernel ``moe_gmm_dw`` (K9: in bf16
    ``moe_ffn_dw_wgmma``, one owner per (expert, 64-column hidden chunk)
    walking the expert's kept rows, split over a cluster of ``K9_CLUSTER``
    CTAs whose partials are summed in rank order; in fp32 one block per
    (32-column chunk, expert) tile of dW1 or dW2), in a fixed order: two
    calls give bit-identical results.  K7's shape rules.  No rows: zero
    gradients, no launch.  ``grouped_ffn_dw.launches`` counts its launches."""
    if xs.device.type == "cpu":
        return grouped_ffn_dw_reference(xs, dy, w1, b1, w2, starts, cap)
    _check_card("grouped_ffn_dw", xs, w1, b1, w2, starts, dy=dy)
    ne, d, h = w1.shape
    dev = xs.device
    outs = [torch.empty(s, device=dev) for s in ((ne, d, h), (ne, h), (ne, h, d), (ne, d))]
    if xs.shape[0] == 0:
        return tuple(t.zero_() for t in outs)
    ops = [_operand(t) for t in (xs, dy, w1, b1, w2, starts)]
    with torch.cuda.device(dev):
        _launch("moe_gmm_bwd", "moe_gmm_dw", [t.data_ptr() for t in ops + outs],
                _dims(xs, w1, cap), _stream(xs))
    grouped_ffn_dw.launches += 1
    return tuple(outs)


grouped_ffn_dw.launches = 0


class _GroupedFFN(torch.autograd.Function):
    """The JAX ``_gmm_core`` custom VJP: the forward (K7) saves xs, the
    weights and ``starts`` only; the backward runs K8 for dx and K9 for the
    weight gradients, which it casts from fp32 to the weights' dtypes, as
    ``_gmm_core_bwd`` does."""

    @staticmethod
    def forward(ctx, xs, w1, b1, w2, b2, starts, cap):
        ctx.cap, ctx.b2_dtype = cap, b2.dtype
        ctx.save_for_backward(xs, w1, b1, w2, starts)
        return grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, cap)

    @staticmethod
    def backward(ctx, dy):
        xs, w1, b1, w2, starts = ctx.saved_tensors
        dy = dy.contiguous()
        dx = grouped_ffn_dx(xs, dy, w1, b1, w2, starts, ctx.cap)
        dw1, db1, dw2, db2 = grouped_ffn_dw(xs, dy, w1, b1, w2, starts, ctx.cap)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), None, None)


def grouped_ffn(xs, w1, b1, w2, b2, starts, cap: int) -> torch.Tensor:
    """The fused grouped MLP ``gelu(xs @ w1[e] + b1[e]) @ w2[e] + b2[e]``
    over the ragged expert groups of expert-sorted tokens (the JAX
    ``grouped_ffn`` without its TPU-only ``block_rows`` and ``interpret``).

    ``xs``: (n, d) tokens sorted by expert, in the compute dtype.
    ``w1``/``b1``/``w2``/``b2``: (E, d, h) / (E, h) / (E, h, d) / (E, d),
    already cast to the compute dtype.  ``starts``: (E+1,) int32 group
    boundaries; expert e owns rows ``[starts[e], starts[e+1])``.  ``cap``:
    the static per-expert capacity; rows past ``starts[e] + cap`` in a
    group are dropped (output exactly 0, Switch semantics).

    Returns (n, d) in the same sorted order.  Differentiable in xs and the
    four parameters through ``_GroupedFFN`` where autograd records the call.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xs, w1, b1, w2, b2)):
        return _GroupedFFN.apply(xs, w1, b1, w2, b2, starts, int(cap))
    return grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, int(cap))
