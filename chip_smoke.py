#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before the
last line:

1. device  — ``nvidia-smi`` name and power limit, the card's capability
             (Hopper, 9.0, is required);
2. build   — compiles every CUDA library of the port from ``ops/csrc/``,
             one ``nvcc`` per source, all started together;
3. kernel checks — each kernel against its plain PyTorch version on the
             card, at the shapes of the serve and train paths (bf16 and
             fp32) and the other regimes it covers, with the tolerance
             stated beside each and held against a planted fault it must
             reject; CUDA-event times of the kernel, the plain version and
             the one-call library yardstick: the flash-attention forward
             (K1/K2), then its dq (K3) and dk/dv (K4) kernels, then the
             fused ViT block chain (K5: ``block_gemm`` x 4 and
             ``block_attention``) against ``fused_vit_block_reference``,
             stage by stage and whole, with the composed cuBLAS + SDPA
             block as its library yardstick; then the fused block backward
             chain (K6: ``block_ln``, ``block_gemm_dgrad``,
             ``block_ln_bwd``, ``block_attention_bwd``,
             ``block_gemm_wgrad``, ``block_grad_reduce``, with K5's kernels
             for the recompute) against ``fused_vit_block_bwd_reference``,
             each wrapper against its plain version and the chain's dx and
             twelve gradients whole, two faults planted on the kernels'
             results (a row chunk dropped from the gradient reductions, a
             key tile left out of the attention backward), bit-identical
             results across two calls, with the composed block's autograd
             forward and backward as its library yardstick;
4. serve   — the port's main path through its user entry point
             (``entry.run``): ``vit_long`` at 256 px (4096 tokens), bf16,
             buckets 1,2,4,8, closed loop of 64 requests at concurrency 8,
             seeded fresh weights.  The kernel launch counters are zeroed
             just before and read just after; every flash-attention launch
             must belong to a dispatched batch (depth x batches), and the
             engine's logits must match the same weights run through the
             reference attention on the card; then one bucket-8 batch is
             timed with both attentions and profiled (device busy time,
             idle share, largest device consumers); the same batch in
             fp32 (the default without ``--amp``) is checked and timed too;
   serve_tiny — the same entry with ``vit_tiny --patch-size 2`` (12 blocks,
             dim 192, 256 tokens), bf16, buckets 1..32, 256 requests at
             concurrency 32: every block of every dispatched batch runs the
             fused K5 chain and no flash-attention kernel runs; the bucket-32
             logits are held against the composed reference engine in bf16
             and fp32, a bucket-32 dispatch is timed fused and with
             ``--block-fusion off`` and profiled;
5. train   — the port's training path through ``entry.run``: ``vit_long``
             at 256 px, bf16, batch 16, two epochs over 144 synthetic
             training images (18 steps) and 16 validation images.  The
             launch counters are zeroed just before and read just after:
             every block's forward launches the forward kernel in each
             train step and eval batch, every train step's backward the dq
             and dk/dv kernels once per block, every loss is finite and no
             step is skipped.  Then one step's loss and every parameter
             gradient through the kernels are held against the same seeded
             weights and batch through the reference attention (bf16, and
             fp32 without ``--amp``), with a bound that rejects a planted
             fault; images/s and ms/step, and a profile of one step;
   train_tiny — ``vit_tiny --patch-size 2`` at batch 128, bf16, two epochs
             over 1152 synthetic training images (18 steps) and 128
             validation images: every block's forward through K5 and its
             backward through K6, the launch counters of every wrapper
             checked against the chain (zero flash launches), every loss
             finite, no step skipped; one step's loss and gradients held
             against ``--block-fusion off`` and against the plain chains
             (bf16 and fp32) with a bound that rejects a planted fault; ms
             per step fused and off, and a step profile;
6. the ``{"kernels": [...]}`` line, then the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX.  Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "distributed_training_comparison_tpu_torch"

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # fp32 without TF32
PEAK_BYTES = 3.35e12

TRAIN_ARGV = [
    "--model", "vit_long", "--image-size", "256", "--amp", "--synthetic-data",
    "--limit-examples", "160", "--batch-size", "16", "--epoch", "2",
    "--lr-decay-step-size", "1",
]

SERVE_ARGV = [
    "--serve", "--model", "vit_long", "--image-size", "256", "--amp",
    "--serve-buckets", "1,2,4,8", "--serve-shape", "closed",
    "--serve-requests", "64", "--serve-concurrency", "8", "--seed", "0",
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, timed
    with CUDA events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b, h, sq, skv, d, causal, dtype) -> tuple[float, str]:
    """Least time the card could take: the larger of operations over the
    dtype's peak and bytes (each input read once, each output written once)
    over the memory rate.  Causal counts only the pairs it needs."""
    import torch

    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * skv)
    flops = 4 * pairs * d
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * h * sq * d + 2 * b * h * skv * d) * item + b * h * sq * 4
    name = str(dtype).removeprefix("torch.")
    t_ops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# (label, TPU kernel regime, dtype, B, H, S, D, causal, layout), inputs unit normal
KERNEL_CASES = [
    ("slice: vit_long bucket 8", "K1", "bfloat16", 8, 4, 4096, 128, False, "bshd"),
    ("K2 regime: S past the resident-K/V limit", "K2", "bfloat16", 1, 2, 16384, 128, False, "bhsd"),
    ("ragged causal", "K1", "bfloat16", 2, 4, 1030, 64, True, "bhsd"),
    ("fp32", "K1", "float32", 1, 4, 1000, 128, False, "bhsd"),
    ("fp32 serving shape: vit_long bucket 8 without --amp", "K1", "float32", 8, 4, 4096, 128, False, "bshd"),
]
# dtype -> (atol share, rtol, lse atol).  Out holds elementwise
# |kernel - plain| <= atol_share * rms(plain row) + rtol * |plain|, where a
# row is one query's D outputs: a row's output and its error are both sums
# over the keys it sees, so they scale together, from the one-key rows of
# a causal start (|out| ~ 4) to the 4096-key rows of the slice (~0.03).
# bf16: the kernel rounds the unnormalized P to bf16 where the plain
# version rounds the normalized P, each term by at most 2^-8 relative and
# independently, so the fp32 sums before out's own rounding differ by about
# 2^-8 * sqrt(2/3) * rms(row); 2^-5 * rms(row) is ten times that.  The two
# bf16 roundings of out differ by at most one ulp, 2^-7 |out|: rtol 2^-6.
# lse is fp32 from exact bf16 products; only summation order and exp2
# differ.  fp32: fp32 throughout, summation order and exp2 only.  Each case
# also holds the tolerance against a planted fault it must reject (see
# ``dropped_rows``).
TOLERANCES = {"bfloat16": (2**-5, 2**-6, 1e-3), "float32": (2**-10, 0.0, 1e-4)}
FAULT_KEYS = 64  # the kernel's K/V tile


def dropped_rows(x, layout, n=FAULT_KEYS):
    """``x`` with its first ``n`` sequence positions zeroed.  On ``v`` the
    plain forward is the kernel with one V tile left out of P·V while the
    softmax statistics stay right (a fault the lse check cannot see); the
    backward checks plant theirs the same way."""
    x = x.clone()
    (x[:, :n] if layout == "bshd" else x[:, :, :n]).zero_()
    return x


def atol_share_needed(got, want, rtol) -> float:
    """The least atol share (of each row's rms) under which ``got`` holds
    against ``want`` with ``rtol``: max of (|got - want| - rtol |want|) / rms."""
    w = want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
    return (((got.float() - w).abs() - rtol * w.abs()) / rms).max().item()


def kernel_checks(attn) -> list[dict]:
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for label, regime, dname, b, h, s, d, causal, layout in KERNEL_CASES:
        dtype = getattr(torch, dname)
        atol_share, rtol, tol_lse = TOLERANCES[dname]
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        q, k, v = (
            torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
            for _ in range(3)
        )
        # the kernel takes (B, H, S, D) views; bshd is the ViT's layout, read in place
        qt, kt, vt = (x.transpose(1, 2) if layout == "bshd" else x for x in (q, k, v))
        o, lse = attn.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        ref_o, ref_lse = attn.mha_reference(
            q, k, v, causal=causal, return_lse=True, layout=layout
        )
        if layout == "bshd":
            o = o.transpose(1, 2)
        err = (o.float() - ref_o.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        share = atol_share_needed(o, ref_o, rtol)
        fault_o = attn.mha_reference(
            q, k, dropped_rows(v, layout), causal=causal, layout=layout
        )
        fault_share = atol_share_needed(fault_o, ref_o, rtol)
        del fault_o
        ok = (
            share <= atol_share < fault_share
            and err_lse <= tol_lse
            and math.isfinite(err + err_lse)
        )
        big = s >= 4096
        ms = cuda_ms(lambda: attn.flash_attention(qt, kt, vt, causal=causal), 10 if big else 50)
        plain_ms = cuda_ms(
            lambda: attn.mha_reference(q, k, v, causal=causal, layout=layout),
            3 if big else 10, warmup=1,
        )
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
            10 if big else 50,
        )
        bound_ms, bound_by = attention_bound(b, h, s, s, d, causal, dtype)
        row = {
            "case": label, "regime": regime, "dtype": dname, "layout": layout,
            "shape": [b, h, s, d], "causal": causal,
            "max_abs_err": err, "max_abs_err_lse": err_lse,
            "atol_share": atol_share, "rtol": rtol, "tol_lse": tol_lse,
            "atol_share_needed": share, "fault_atol_share_needed": fault_share,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "ok": ok,
        }
        out.append(row)
        del q, k, v, qt, kt, vt, o, lse, ref_o, ref_lse
        torch.cuda.empty_cache()
    return out


def backward_bound(b, h, sq, skv, d, causal, dtype, kernel) -> tuple[float, str]:
    """Least time of the dq kernel (``kernel="dq"``: 3 products, s, dp and
    ds·K) or the dk/dv kernel (``"dkv"``: 4 products, s, dp, pᵀ·dO and
    dsᵀ·Q) on the card: operations over the dtype's peak against bytes
    (q, k, v, dO, lse and adj read once, the gradients written once) over
    the memory rate.  Causal counts only the pairs it needs."""
    import torch

    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * skv)
    products, outs = (3, 1) if kernel == "dq" else (4, 2)
    flops = 2 * products * pairs * d
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * h * sq * d + 2 * b * h * skv * d + outs * b * h * skv * d) * item
    nbytes += 2 * b * h * sq * 4
    name = str(dtype).removeprefix("torch.")
    t_ops, t_bytes = flops / PEAK_FLOPS[name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# (label, dtype, B, H, S, D, causal, layout, with a non-zero dlse), inputs
# unit normal; the first is one block's attention in the train step (batch
# 16: bh 64), the last the fp32 train step's (batch 2: bh 8)
BACKWARD_CASES = [
    ("slice: vit_long train step, batch 16", "bfloat16", 16, 4, 4096, 128, False, "bshd", False),
    ("ragged causal, dlse", "bfloat16", 2, 4, 1030, 64, True, "bhsd", True),
    ("fp32, dlse", "float32", 1, 4, 1000, 128, False, "bhsd", True),
    ("fp32 train step shape: batch 2 without --amp", "float32", 2, 4, 4096, 128, False, "bshd", False),
]
# Each gradient holds against the plain backward per row (one query's dq,
# one key's dk or dv): |kernel - plain| <= atol_share * rms(row) +
# rtol * |plain|, with the forward's TOLERANCES.  Why they hold: the kernel
# and the plain version compute the same fp32 scores, p, dp and ds and
# round p and ds to bf16 at the same points, so they differ by fp32
# summation order (~1e-6 relative), by the rare bf16 rounding flip that
# difference causes in p or ds (2^-8 on one term of a sum of S), and by
# one bf16 rounding of each gradient (<= 2^-8 |x|, held by rtol 2^-6);
# 2^-5 of the row's rms leaves room for the flips.  fp32: summation order
# and expf only.  The planted faults: dq with the first FAULT_KEYS keys left
# out of its sum, dk/dv with the first FAULT_KEYS queries left out of
# theirs; each must need more than the tolerance.


def backward_checks(attn) -> list[dict]:
    """K3 and K4 against ``flash_attention_bwd_reference`` at
    ``BACKWARD_CASES``: agreement, the planted faults, and times."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for label, dname, b, h, s, d, causal, layout, with_dlse in BACKWARD_CASES:
        dtype = getattr(torch, dname)
        atol_share, rtol, _ = TOLERANCES[dname]
        shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
        q, k, v, do = (
            torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)
            for _ in range(4)
        )
        dlse = (
            torch.randn((b, h, s), generator=gen, device="cuda") if with_dlse else None
        )
        bhsd = (lambda x: x.transpose(1, 2)) if layout == "bshd" else (lambda x: x)
        qt, kt, vt, dot = (bhsd(x) for x in (q, k, v, do))
        scale = d**-0.5
        o, lse = attn.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
        adj = attn._row_adjustment(o, dot, dlse)
        kw = dict(causal=causal, scale=scale)
        dq = attn.flash_attention_dq(qt, kt, vt, dot, lse, adj, **kw)
        dk, dv = attn.flash_attention_dkv(qt, kt, vt, dot, lse, adj, **kw)
        torch.cuda.synchronize()
        want = attn.flash_attention_bwd_reference(qt, kt, vt, o, lse, dot, dlse, **kw)
        fault_dq = attn.flash_attention_bwd_reference(
            qt, bhsd(dropped_rows(k, layout)), vt, o, lse, dot, dlse, **kw
        )[0]
        fault_dkv = attn.flash_attention_bwd_reference(
            bhsd(dropped_rows(q, layout)), kt, vt, o, lse,
            bhsd(dropped_rows(do, layout)), dlse, **kw,
        )[1:]
        grads = {}
        for name, got, ref, fault in zip(
            ("dq", "dk", "dv"), (dq, dk, dv), want, (fault_dq, *fault_dkv)
        ):
            grads[name] = {
                "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                "atol_share_needed": atol_share_needed(got, ref, rtol),
                "fault_atol_share_needed": atol_share_needed(fault, ref, rtol),
                "finite": bool(torch.isfinite(got).all()),
            }
        del want, fault_dq, fault_dkv
        ok = all(
            g["finite"] and g["atol_share_needed"] <= atol_share < g["fault_atol_share_needed"]
            for g in grads.values()
        )
        big = s >= 4096
        n = 5 if big else 50
        dq_ms = cuda_ms(lambda: attn.flash_attention_dq(qt, kt, vt, dot, lse, adj, **kw), n)
        dkv_ms = cuda_ms(lambda: attn.flash_attention_dkv(qt, kt, vt, dot, lse, adj, **kw), n)
        plain_ms = cuda_ms(
            lambda: attn.flash_attention_bwd_reference(qt, kt, vt, o, lse, dot, dlse, **kw),
            2 if big else 10, warmup=1,
        )
        # the library yardstick: one SDPA call's backward (fwd+bwd minus fwd)
        ql, kl, vl = (x.detach().requires_grad_() for x in (qt, kt, vt))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa_fwd(), (ql, kl, vl), dot)

        library_ms = cuda_ms(sdpa_fwd_bwd, n) - cuda_ms(sdpa_fwd, n)
        bound = {
            kernel: backward_bound(b, h, s, s, d, causal, dtype, kernel)
            for kernel in ("dq", "dkv")
        }
        pair_floor_ms = 2 * 5 * b * h * s * s * d / PEAK_FLOPS[dname] * 1e3
        out.append({
            "case": label, "dtype": dname, "layout": layout, "shape": [b, h, s, d],
            "causal": causal, "dlse": with_dlse, "atol_share": atol_share, "rtol": rtol,
            "grads": grads, "ok": ok,
            "dq_ms": dq_ms, "dkv_ms": dkv_ms, "plain_ms": plain_ms,
            "library_ms": library_ms,
            "dq_bound_ms": bound["dq"][0], "dq_bound_by": bound["dq"][1],
            "dkv_bound_ms": bound["dkv"][0], "dkv_bound_by": bound["dkv"][1],
            "pair_floor_ms_with_atomic_dq": pair_floor_ms,
        })
        del q, k, v, do, qt, kt, vt, dot, o, lse, adj, dq, dk, dv, ql, kl, vl
        torch.cuda.empty_cache()
    return out


def bound(flops: float, nbytes: float, dname: str) -> tuple[float, str]:
    """Least time in ms: operations over the dtype's peak against bytes over
    the memory rate, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def block_bounds(b, s, dim, heads, hidden, dname) -> dict[str, tuple[float, str]]:
    """Bounds of one fused block (K5) on the card: the whole chain, the four
    ``block_gemm`` launches together and ``block_attention``.  Each
    function's inputs are read once and its outputs written once: the chain
    reads x and the fp32 parameters and writes out; each GEMM launch reads
    its A, residual and parameters and writes its C; attention reads qkv
    and writes o."""
    rows, item = b * s, 2 if dname == "bfloat16" else 4
    params = (4 * dim * dim + 2 * dim * hidden + 9 * dim + hidden) * 4
    gemm_flops = 2 * rows * (4 * dim * dim + 2 * dim * hidden)
    attn_flops = 4 * rows * s * dim
    # (x in, qkv out), (o, x in, r1 out), (r1 in, hmid out), (hmid, r1 in, out)
    gemm_act = rows * (4 * dim + 3 * dim + dim + hidden + hidden + 2 * dim)
    return {
        "chain": bound(gemm_flops + attn_flops, 2 * rows * dim * item + params, dname),
        "gemm": bound(gemm_flops, gemm_act * item + params, dname),
        "attention": bound(attn_flops, 4 * rows * dim * item, dname),
    }


# (label, dtype, B, S, dim, heads); mlp ratio 4.  The first two are one
# block of the vit_tiny --patch-size 2 serve path at bucket 32 (bf16 with
# --amp, fp32 without), then a ragged S (a multiple of 8, not of 64) and
# the top of the gate's 128-512 token window.
BLOCK_CASES = [
    ("slice: vit_tiny p2 serve, bucket 32", "bfloat16", 32, 256, 192, 3),
    ("fp32 serve shape: vit_tiny p2 bucket 32 without --amp", "float32", 32, 256, 192, 3),
    ("ragged S", "bfloat16", 3, 136, 128, 2),
    ("window top: S 512", "bfloat16", 2, 512, 192, 3),
]
# Each output (the block's, each GEMM launch's, attention's) holds against
# its plain version per row: |kernel - plain| <= atol_share * rms(row) +
# rtol * |plain|, with the flash kernels' TOLERANCES and for the same
# reasons.  bf16: the kernel and the plain version round at the same points
# (each GEMM's product, bias add, gelu and residual add; P; attention's
# output), so they differ by fp32 summation order and exp/tanh (~1e-6
# relative), by the rare one-ulp bf16 flip that causes in an intermediate,
# which the next stage carries as 2^-8 of one term among dim or S, and by
# one bf16 rounding of the output itself (2^-8 |out|, held by rtol 2^-6);
# 2^-5 of the row's rms leaves room for the flips.  fp32: summation order
# and exp/tanh only.  The planted faults, each of which must need more than
# the tolerance: the block and attention with the first FAULT_KEYS keys of
# every item left out of the attention (one key tile of the kernel), each
# GEMM launch with the first 64 input columns of W zeroed (one K stage).


def _seeded_block_params(dim, heads, gen) -> dict:
    """A ``ViTBlock``'s parameters, seeded: xavier-uniform weights (the
    init) and non-trivial LayerNorm scales and biases, so every term of
    the block is exercised."""
    import torch

    from distributed_training_comparison_tpu_torch.models.vit import ViTBlock

    params = {}
    for name, p in ViTBlock(dim, heads).named_parameters():
        if p.dim() == 2:
            limit = math.sqrt(6.0 / sum(p.shape))
            t = (torch.rand(p.shape, generator=gen) * 2 - 1) * limit
        elif name.startswith("ln") and name.endswith("weight"):
            t = 1 + 0.1 * torch.randn(p.shape, generator=gen)
        else:
            t = 0.1 * torch.randn(p.shape, generator=gen)
        params[name] = t.cuda()
    return params


def attention_without_first_tile(qkv, *, seq, heads, n=FAULT_KEYS):
    """``packed_attention_reference`` with the first ``n`` keys of every
    item left out: the planted fault of the attention stage."""
    import torch

    rows, three_dim = qkv.shape
    dim = three_dim // 3
    d = dim // heads
    items = rows // seq
    outs = []
    for h in range(heads):
        q, k, v = (
            qkv[:, j * dim + h * d:j * dim + (h + 1) * d].reshape(items, seq, d).float()
            for j in range(3)
        )
        s = torch.einsum("bqd,bkd->bqk", q, k[:, n:]) * d**-0.5
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = (e / e.sum(-1, keepdim=True)).to(qkv.dtype).float()
        outs.append(torch.einsum("bqk,bkd->bqd", p, v[:, n:]).to(qkv.dtype).reshape(rows, d))
    return torch.cat(outs, dim=1)


def composed_library_block(x, params, heads):
    """The library yardstick of one block (timed here, never called by the
    port): the composed block with cuBLAS GEMMs (``F.linear``, weights cast
    beforehand), ``F.layer_norm`` and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    cd = x.dtype
    b, s, dim = x.shape
    w = {k: v.to(cd) for k, v in params.items() if not k.startswith("ln")}
    wqkv = torch.cat([w[f"{n}_proj.weight"] for n in "qkv"])
    bqkv = torch.cat([w[f"{n}_proj.bias"] for n in "qkv"])
    ln = {k: v for k, v in params.items() if k.startswith("ln")}

    def norm(t, name):
        return F.layer_norm(
            t.float(), (dim,), ln[f"{name}.weight"], ln[f"{name}.bias"], eps=1e-6
        ).to(cd)

    def run():
        qkv = F.linear(norm(x, "ln_attn"), wqkv, bqkv).view(b, s, 3, heads, dim // heads)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        o = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, s, dim)
        r1 = x + F.linear(o, w["proj.weight"], w["proj.bias"])
        h = F.gelu(F.linear(norm(r1, "ln_mlp"), w["mlp_up.weight"], w["mlp_up.bias"]),
                   approximate="tanh")
        return r1 + F.linear(h, w["mlp_down.weight"], w["mlp_down.bias"])

    return run


def _agreement(got, want, fault, rtol) -> dict:
    import torch

    return {
        "max_abs_err": (got.float() - want.float()).abs().max().item(),
        "atol_share_needed": atol_share_needed(got, want, rtol),
        "fault_atol_share_needed": atol_share_needed(fault, want, rtol),
        "finite": bool(torch.isfinite(got).all()),
    }


def timed(fn, iters: int = 20) -> tuple[float, float]:
    """(device-busy ms per call under torch.profiler, CUDA-event ms per call
    of back-to-back calls), both warmed up.  The first is the kernels' own
    time; the second adds the gaps the host's launch overhead leaves on the
    card between calls, which dominate calls of sub-0.1 ms kernels."""
    event_ms = cuda_ms(fn, iters)
    return profile_device(fn, iters)["device_busy_ms"], event_ms


def fused_block_checks(vb) -> list[dict]:
    """The K5 chain (``ops/vit_block.py``) against its plain version at
    ``BLOCK_CASES``: each ``block_gemm`` launch and ``block_attention`` on
    the plain chain's own intermediates, then the whole block; agreement,
    the planted faults, and the device times (``timed``) of the kernels,
    the plain versions and the library yardsticks."""
    import torch
    import torch.nn.functional as F

    from distributed_training_comparison_tpu_torch.ops.attention_small import (
        packed_attention_reference,
    )

    gen = torch.Generator().manual_seed(2)
    out = []
    for label, dname, b, s, dim, heads in BLOCK_CASES:
        dtype = getattr(torch, dname)
        atol_share, rtol, _ = TOLERANCES[dname]
        params = _seeded_block_params(dim, heads, gen)
        x = torch.randn((b, s, dim), generator=gen).to(device="cuda", dtype=dtype)
        rows, hidden = b * s, 4 * dim
        p = params
        x2 = x.reshape(rows, dim)
        # the plain chain's intermediates: every stage is checked on them
        stages = [
            dict(a=x2, weights=[p[f"{n}.weight"] for n in vb.QKV],
                 biases=[p[f"{n}.bias"] for n in vb.QKV],
                 ln=(p["ln_attn.weight"], p["ln_attn.bias"])),
            None,  # out-proj: a = o, residual = x
            None,  # up: a = r1, LN2, gelu
            None,  # down: a = hmid, residual = r1
        ]
        qkv = vb.block_gemm_reference(**stages[0])
        o = packed_attention_reference(qkv, seq=s, heads=heads)
        stages[1] = dict(a=o, weights=[p["proj.weight"]], biases=[p["proj.bias"]], residual=x2)
        r1 = vb.block_gemm_reference(**stages[1])
        stages[2] = dict(a=r1, weights=[p["mlp_up.weight"]], biases=[p["mlp_up.bias"]],
                         ln=(p["ln_mlp.weight"], p["ln_mlp.bias"]), gelu=True)
        hmid = vb.block_gemm_reference(**stages[2])
        stages[3] = dict(a=hmid, weights=[p["mlp_down.weight"]], biases=[p["mlp_down.bias"]],
                         residual=r1)
        names = ("ln1_qkv", "proj_residual", "ln2_up_gelu", "down_residual")

        gemm = {}
        for name, st in zip(names, stages):
            got = vb.block_gemm(**st)
            torch.cuda.synchronize()
            want = vb.block_gemm_reference(**st)
            faulty = dict(st, weights=[w.clone() for w in st["weights"]])
            for w in faulty["weights"]:
                w[:, :64] = 0
            gemm[name] = _agreement(got, want, vb.block_gemm_reference(**faulty), rtol)
            gemm[name]["ms"], gemm[name]["event_ms"] = timed(lambda: vb.block_gemm(**st))
            gemm[name]["plain_ms"], _ = timed(lambda: vb.block_gemm_reference(**st))
        attn_got = vb.block_attention(qkv, seq=s, heads=heads)
        torch.cuda.synchronize()
        attention = _agreement(
            attn_got, o, attention_without_first_tile(qkv, seq=s, heads=heads), rtol
        )
        attention["ms"], attention["event_ms"] = timed(
            lambda: vb.block_attention(qkv, seq=s, heads=heads)
        )
        attention["plain_ms"], _ = timed(
            lambda: packed_attention_reference(qkv, seq=s, heads=heads)
        )
        q, k, v = (t.transpose(1, 2) for t in qkv.view(b, s, 3, heads, dim // heads).unbind(2))
        attention["library_ms"], _ = timed(lambda: F.scaled_dot_product_attention(q, k, v))
        # the four GEMMs through cuBLAS alone (F.linear with cast weights and
        # bias): no LayerNorm prologue, gelu or residual epilogue
        linear_args = [
            (st["a"], torch.cat(st["weights"]).to(dtype), torch.cat(st["biases"]).to(dtype))
            for st in stages
        ]
        gemm_library_ms, _ = timed(lambda: [F.linear(*args) for args in linear_args])

        got = vb.fused_vit_block(x, params, heads=heads)
        torch.cuda.synchronize()
        want = vb.fused_vit_block_reference(x, params, heads=heads)
        fault = vb._chain(x, params, heads, True, vb.block_gemm_reference,
                          attention_without_first_tile)
        chain = _agreement(got.reshape(rows, dim), want.reshape(rows, dim),
                           fault.reshape(rows, dim), rtol)
        chain["ms"], chain["event_ms"] = timed(lambda: vb.fused_vit_block(x, params, heads=heads))
        chain["plain_ms"], _ = timed(lambda: vb.fused_vit_block_reference(x, params, heads=heads))
        chain["library_ms"], chain["library_event_ms"] = timed(
            composed_library_block(x, params, heads)
        )
        chain["library"] = "composed block: F.layer_norm, F.linear (cuBLAS), SDPA, gelu, adds"
        bounds = block_bounds(b, s, dim, heads, hidden, dname)
        for rec, key in ((chain, "chain"), (attention, "attention")):
            rec["bound_ms"], rec["bound_by"] = bounds[key]
        checked = [chain, attention, *gemm.values()]
        out.append({
            "case": label, "dtype": dname, "shape": [b, s, dim, heads], "rows": rows,
            "atol_share": atol_share, "rtol": rtol, "fault_keys": FAULT_KEYS,
            "chain": chain, "attention": attention, "gemm_launches": gemm,
            "gemm_ms": sum(g["ms"] for g in gemm.values()),
            "gemm_event_ms": sum(g["event_ms"] for g in gemm.values()),
            "gemm_plain_ms": sum(g["plain_ms"] for g in gemm.values()),
            "gemm_library_ms": gemm_library_ms,
            "gemm_library": "4 x F.linear (cuBLAS GEMM + bias); LayerNorm, gelu and residual excluded",
            "gemm_bound_ms": bounds["gemm"][0], "gemm_bound_by": bounds["gemm"][1],
            "ok": all(
                c["finite"] and c["atol_share_needed"] <= atol_share < c["fault_atol_share_needed"]
                for c in checked
            ),
        })
        del params, x, qkv, o, r1, hmid, got, want, fault, stages, linear_args
        torch.cuda.empty_cache()
    return out


def block_bwd_bounds(vb, b, s, dim, heads, hidden, dname) -> dict[str, tuple[float, str]]:
    """Bounds of one fused block backward (K6) on the card: the whole chain
    (x and dy read, dx written, the fp32 parameters read and their fp32
    gradients written) and each kernel over its launches in one chain, each
    launch's inputs read once and outputs written once.  Operations: the
    forward recompute (GEMMs and attention), the data and weight gradient
    GEMMs (twice the forward's), the attention backward's five products
    (QKᵀ, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q)."""
    rows, item = b * s, 2 if dname == "bfloat16" else 4
    nparams = 4 * dim * dim + 2 * dim * hidden + 9 * dim + hidden
    wparams = 4 * dim * dim + 2 * dim * hidden  # the weight matrices
    gemm_flops = 2 * rows * (4 * dim * dim + 2 * dim * hidden)
    attn_fwd, attn_bwd = 4 * rows * s * dim, 10 * rows * s * dim
    chunks = -(-rows // vb.WGRAD_CHUNK_ROWS)
    act = lambda *widths: rows * sum(widths) * item  # noqa: E731
    f32 = lambda *widths: rows * sum(widths) * 4  # noqa: E731
    return {
        "chain": bound(gemm_flops + attn_fwd + 2 * gemm_flops + attn_bwd,
                       3 * rows * dim * item + 2 * nparams * 4, dname),
        # LN1(x), LN2(r1): a row in, a row out each
        "block_ln": bound(2 * 8 * rows * dim, act(dim, dim, dim, dim) + 4 * dim * 4, dname),
        # qkv (ln1 in, qkv out), proj (o, x in, r1 out), up (ln2 in, up out)
        "block_gemm": bound(2 * rows * (4 * dim * dim + dim * hidden),
                            act(dim, 3 * dim, dim, dim, dim, dim, hidden)
                            + (4 * dim * dim + dim * hidden) * 4, dname),
        "block_attention": bound(attn_fwd, act(3 * dim, dim), dname),
        # dy·W_dn (dy, up in; dup, hmid out), dup·W_up (dup in, dLN2 fp32 out),
        # dr1c·W_o (in, dO out), dqkv·W_qkv (in, dLN1 fp32 out)
        "block_gemm_dgrad": bound(gemm_flops, act(dim, hidden, hidden, hidden, hidden, dim, dim, 3 * dim)
                                  + f32(dim, dim) + wparams * 4, dname),
        # (dLN2 fp32, r1, dy in; dr1 fp32, dr1c out), (dLN1 fp32, x in, dr1 fp32 in; dx out)
        "block_ln_bwd": bound(2 * 12 * rows * dim, act(dim, dim, dim, dim, dim)
                              + f32(dim, dim, dim, dim), dname),
        "block_attention_bwd": bound(attn_bwd, act(3 * dim, dim, 3 * dim), dname),
        # (dqkv, ln1), (dr1c, o, dr1 fp32), (dup, ln2), (dy, hmid) in; partials out
        "block_gemm_wgrad": bound(gemm_flops, act(3 * dim, dim, dim, dim, hidden, dim, dim, hidden)
                                  + f32(dim) + chunks * (wparams + 6 * dim + hidden) * 4, dname),
        "block_grad_reduce": bound(chunks * nparams, (chunks + 1) * nparams * 4, dname),
    }


# (label, dtype, B, S, dim, heads); mlp ratio 4.  The first two are one
# block of the vit_tiny --patch-size 2 train step at batch 128 (bf16 with
# --amp, fp32 without), then the top of the gate's token window and a
# ragged S with 2 heads (tiles cut by S and dim).
BWD_CASES = [
    ("slice: vit_tiny p2 train step, batch 128", "bfloat16", 128, 256, 192, 3),
    ("fp32 train shape: batch 128 without --amp", "float32", 128, 256, 192, 3),
    ("window top: S 512", "bfloat16", 16, 512, 192, 3),
    ("ragged S, dim 128, 2 heads", "bfloat16", 3, 136, 128, 2),
]
# dx holds against the plain backward per row as the forward's output does
# (TOLERANCES: bf16 2^-5 of the row's rms plus 2^-6·|dx|, fp32 2^-10 of the
# rms): the kernels and the plain version round at the same points, so
# they differ by fp32 summation order and exp/tanh, by the rare one-ulp
# bf16 flip that causes in an intermediate (2^-8 of one term of a sum) and
# by dx's own rounding.  Each parameter gradient holds against its own
# leaf's scale: max |kernel - plain| <= tol · max |plain|, tol 2^-7 in bf16
# (the flips above, averaged over a sum of up to 32768 rows, sit far
# below one bf16 ulp of the largest entry; 2^-7 is two such ulps) and 2^-14
# in fp32 (summation order over up to 32768 rows, ~1e-6 relative, with
# margin).  k_proj.bias is measured against k_proj.weight's scale: its exact
# gradient is zero (Σ_j ds_ij = 0 by softmax shift invariance), so both
# hold rounding noise there, and it compares absolutely.  Two faults are
# planted on the kernels' own results (``k6_fault``), and each must be
# rejected: the first row chunk's partials dropped from every reduction of
# more than one chunk (the weight gradients must reject it; in the ragged
# case of 408 rows only the LayerNorm partials have more than one), and dk
# and dv of each item's first key tile left zero in the attention backward
# (dx and the weight gradients must each reject it).
BWD_GRAD_TOL = {"bfloat16": 2**-7, "float32": 2**-14}


@contextlib.contextmanager
def k6_fault(vb, kind: str):
    """Context in which the K6 chain on the card returns a planted fault:
    ``"chunk"`` sums each partial of more than one chunk without its first
    chunk; ``"key_tile"`` zeroes dk and dv of the first ``FAULT_KEYS`` keys
    of every item in ``block_attention_bwd``'s result."""
    reduce, attention_bwd = vb.block_grad_reduce, vb.block_attention_bwd

    def reduce_without_first_chunk(partials, **kw):
        return reduce([t[1:] if t.shape[0] > 1 else t for t in partials], **kw)

    def attention_bwd_without_first_tile(qkv, do, *, seq, heads, **kw):
        out = attention_bwd(qkv, do, seq=seq, heads=heads, **kw)
        dim = qkv.shape[1] // 3
        out.view(-1, seq, 3 * dim)[:, :FAULT_KEYS, dim:] = 0
        return out

    # the wrapper counts its launch on the name it is bound to, the fault's
    # while it stands in, so the fault's launches leave the counters alone
    reduce_without_first_chunk.launches = attention_bwd_without_first_tile.launches = 0
    if kind == "chunk":
        vb.block_grad_reduce = reduce_without_first_chunk
    else:
        vb.block_attention_bwd = attention_bwd_without_first_tile
    try:
        yield
    finally:
        vb.block_grad_reduce, vb.block_attention_bwd = reduce, attention_bwd


def grad_leaf_errors(got: dict, want: dict) -> dict[str, float]:
    """max |got - want| / max |want| per leaf, ``k_proj.bias`` against
    ``k_proj.weight``'s scale (see ``BWD_GRAD_TOL``)."""
    out = {}
    for name, w in want.items():
        key = "k_proj.weight" if name == "k_proj.bias" else name
        scale = want[key].abs().max().clamp_min(1e-30)
        out[name] = ((got[name] - w).abs().max() / scale).item()
    return out


def composed_library_block_fwd_bwd(x, params, heads, dy):
    """The library yardstick of one block's backward (timed here, never
    called by the port): the composed block of ``composed_library_block``
    (cuBLAS ``F.linear``, SDPA) under autograd, forward and backward, so
    the forward the fused backward recomputes is inside it too."""
    import torch

    xl = x.detach().requires_grad_()
    pl = {k: v.detach().requires_grad_() for k, v in params.items()}
    run = composed_library_block(xl, pl, heads)

    def fwd_bwd():
        torch.autograd.grad(run(), (xl, *pl.values()), dy)

    return fwd_bwd


K6_KERNELS = {  # the CUDA kernels' own symbols, by wrapper
    "block_ln": ("ln_rows",),
    "block_gemm": ("vit_block_gemm_bf16", "vit_block_gemm_f32"),
    "block_attention": ("vit_block_attn_bf16", "vit_block_attn_f32"),
    "block_gemm_dgrad": ("dgrad_bf16", "dgrad_f32"),
    "block_ln_bwd": ("ln_bwd",),
    "block_attention_bwd": ("attn_dq_bf16", "attn_dq_f32", "attn_dkv_bf16", "attn_dkv_f32"),
    "block_gemm_wgrad": ("wgrad_bf16", "wgrad_f32"),
    "block_grad_reduce": ("grad_reduce",),
}
# the profiler's name of a kernel of the vit_block libraries, all defined in
# an anonymous namespace: "[void ](anonymous namespace)::<symbol>[<...>](...)";
# a library kernel (cuDNN's *wgrad*/*dgrad* convolution kernels, ATen's) does
# not match
_KERNEL_SYMBOL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def kernel_ms(device_ms_by_name: dict, wrappers) -> float:
    """Device ms of the profiled kernels whose symbol is one of the
    ``wrappers``' kernels (``K6_KERNELS``)."""
    symbols = {sym for w in wrappers for sym in K6_KERNELS[w]}
    total = 0.0
    for name, ms in device_ms_by_name.items():
        m = _KERNEL_SYMBOL.match(name)
        if m and m.group(1) in symbols:
            total += ms
    return total


def k6_stages(vb, x2, dy2, params, seq, heads) -> list[tuple]:
    """Every K6 launch of one block backward as (wrapper name, wrapper,
    plain version, args, kwargs, library call), its inputs the plain
    chain's own intermediates, in the chain's order
    (``ops/vit_block.py::_bwd_chain``).  The library calls are yardsticks
    of the same work: cuBLAS products, SDPA, ATen's LayerNorm forward and
    backward (its statistics taken outside the timed call), ``torch.sum``
    over the chunks of each partial."""
    import torch
    import torch.nn.functional as F

    p = params
    cd = x2.dtype
    qkvn = vb.QKV
    wqkv = [p[f"{n}.weight"] for n in qkvn]
    ln1 = vb.block_ln_reference(x2, p["ln_attn.weight"], p["ln_attn.bias"])
    qkv = vb.block_gemm_reference(ln1, wqkv, [p[f"{n}.bias"] for n in qkvn])
    o = vb.packed_attention_reference(qkv, seq=seq, heads=heads)
    r1 = vb.block_gemm_reference(o, [p["proj.weight"]], [p["proj.bias"]], residual=x2)
    ln2 = vb.block_ln_reference(r1, p["ln_mlp.weight"], p["ln_mlp.bias"])
    up = vb.block_gemm_reference(ln2, [p["mlp_up.weight"]], [p["mlp_up.bias"]])
    dup, hmid = vb.block_gemm_dgrad_reference(dy2, [p["mlp_down.weight"]], gelu_of=up)
    dln2 = vb.block_gemm_dgrad_reference(dup, [p["mlp_up.weight"]], out_f32=True)
    dr1, dr1c, *_ = vb.block_ln_bwd_reference(dln2, r1, p["ln_mlp.weight"], dy2)
    do = vb.block_gemm_dgrad_reference(dr1c, [p["proj.weight"]])
    dqkv = vb.packed_attention_bwd_reference(qkv, do, seq=seq, heads=heads)
    dln1 = vb.block_gemm_dgrad_reference(dqkv, wqkv, out_f32=True)
    wg = [(dqkv, ln1, dqkv), (dr1c, o, dr1), (dup, ln2, dup), (dy2, hmid, dy2)]
    partials = [t for args in wg for t in vb.block_gemm_wgrad_reference(*args)]
    cast = {n: p[f"{n}.weight"].to(cd) for n in vb.DENSE}
    ln = lambda t, n: lambda: F.layer_norm(  # noqa: E731
        t.float(), t.shape[-1:], p[f"{n}.weight"], p[f"{n}.bias"], eps=1e-6)
    ql, kl, vl = (t.view(-1, seq, heads, t.shape[1] // heads).transpose(1, 2).detach()
                  .requires_grad_() for t in qkv.chunk(3, dim=1))
    dol = do.view(-1, seq, heads, do.shape[1] // heads).transpose(1, 2)

    def sdpa_bwd():  # the library yardstick: SDPA's forward and backward
        torch.autograd.grad(F.scaled_dot_product_attention(ql, kl, vl), (ql, kl, vl), dol)

    def ln_bwd(dln, xin, n):  # the yardstick: ATen's LayerNorm backward (dx, dγ, dβ)
        xf, gamma, beta = xin.float(), p[f"{n}.weight"], p[f"{n}.bias"]
        _, mean, rstd = torch.ops.aten.native_layer_norm(xf, xf.shape[-1:], gamma, beta, 1e-6)
        return lambda: torch.ops.aten.native_layer_norm_backward(
            dln, xf, xf.shape[-1:], mean, rstd, gamma, beta, [True, True, True])

    return [
        ("block_ln", vb.block_ln, vb.block_ln_reference,
         (x2, p["ln_attn.weight"], p["ln_attn.bias"]), {}, ln(x2, "ln_attn")),
        ("block_ln", vb.block_ln, vb.block_ln_reference,
         (r1, p["ln_mlp.weight"], p["ln_mlp.bias"]), {}, ln(r1, "ln_mlp")),
        ("block_gemm_dgrad", vb.block_gemm_dgrad, vb.block_gemm_dgrad_reference,
         (dy2, [p["mlp_down.weight"]]), {"gelu_of": up}, lambda: dy2 @ cast["mlp_down"]),
        ("block_gemm_dgrad", vb.block_gemm_dgrad, vb.block_gemm_dgrad_reference,
         (dup, [p["mlp_up.weight"]]), {"out_f32": True}, lambda: dup @ cast["mlp_up"]),
        ("block_ln_bwd", vb.block_ln_bwd, vb.block_ln_bwd_reference,
         (dln2, r1, p["ln_mlp.weight"], dy2), {}, ln_bwd(dln2, r1, "ln_mlp")),
        ("block_gemm_dgrad", vb.block_gemm_dgrad, vb.block_gemm_dgrad_reference,
         (dr1c, [p["proj.weight"]]), {}, lambda: dr1c @ cast["proj"]),
        ("block_attention_bwd", vb.block_attention_bwd, vb.packed_attention_bwd_reference,
         (qkv, do), {"seq": seq, "heads": heads}, sdpa_bwd),
        ("block_gemm_dgrad", vb.block_gemm_dgrad, vb.block_gemm_dgrad_reference,
         (dqkv, wqkv), {"out_f32": True},
         lambda: dqkv @ torch.cat([cast[n] for n in qkvn])),
        ("block_ln_bwd", vb.block_ln_bwd, vb.block_ln_bwd_reference,
         (dln1, x2, p["ln_attn.weight"], dr1), {}, ln_bwd(dln1, x2, "ln_attn")),
        *[("block_gemm_wgrad", vb.block_gemm_wgrad, vb.block_gemm_wgrad_reference, args, {},
           (lambda g=args[0], a=args[1]: g.T @ a)) for args in wg],
        ("block_grad_reduce", vb.block_grad_reduce, vb.block_grad_reduce_reference,
         (partials,), {}, lambda: [torch.sum(t, 0) for t in partials]),
    ]


def k6_stage_checks(vb, x, dy, params, heads, rtol) -> dict[str, dict]:
    """Each K6 wrapper on the card against its plain version on the same
    inputs (``k6_stages``), per kernel over its launches in one block
    backward: the least atol share (of each output row's rms) it needs with
    ``rtol``, and the plain version's and the library call's device time."""
    import torch

    b, s, dim = x.shape
    out: dict[str, dict] = {}
    for name, wrapper, plain, args, kw, library in k6_stages(
        vb, x.view(b * s, dim), dy.view(b * s, dim), params, s, heads
    ):
        got = wrapper(*args, **kw)
        torch.cuda.synchronize()
        want = plain(*args, **kw)
        pairs = [(g, w) for g, w in zip(
            got if isinstance(got, (tuple, list)) else [got],
            want if isinstance(want, (tuple, list)) else [want],
        ) if g is not None]
        rec = out.setdefault(name, {"launches_checked": 0, "max_abs_err": 0.0,
                                    "atol_share_needed": 0.0, "finite": True,
                                    "plain_ms": 0.0, "library_ms": 0.0})
        rec["launches_checked"] += 1
        for g, w in pairs:
            rec["max_abs_err"] = max(rec["max_abs_err"], (g.float() - w.float()).abs().max().item())
            rec["atol_share_needed"] = max(rec["atol_share_needed"], atol_share_needed(g, w, rtol))
            rec["finite"] = rec["finite"] and bool(torch.isfinite(g).all())
        rec["plain_ms"] += timed(lambda: plain(*args, **kw), 5)[0]
        rec["library_ms"] += timed(library, 10)[0]
        del got, want, pairs
    return out


def fused_block_bwd_checks(vb) -> list[dict]:
    """The K6 chain (``ops/vit_block.py::fused_vit_block_bwd``) against
    ``fused_vit_block_bwd_reference`` at ``BWD_CASES``: dx and each of the
    twelve gradients, the planted faults, bit-identical results across two
    calls, and the device time of the chain and of each kernel (summed over
    its launches in one chain), the CUDA-event time, the plain version's and
    the library yardstick's."""
    import torch

    gen = torch.Generator().manual_seed(3)
    out = []
    for label, dname, b, s, dim, heads in BWD_CASES:
        dtype = getattr(torch, dname)
        atol_share, rtol, _ = TOLERANCES[dname]
        tol = BWD_GRAD_TOL[dname]
        params = _seeded_block_params(dim, heads, gen)
        x = torch.randn((b, s, dim), generator=gen).to(device="cuda", dtype=dtype)
        dy = torch.randn((b, s, dim), generator=gen).to(device="cuda", dtype=dtype)
        rows = b * s

        def run():
            return vb.fused_vit_block_bwd(x, dy, params, heads=heads)

        dx, grads = run()
        dx2, grads2 = run()
        torch.cuda.synchronize()
        identical = torch.equal(dx, dx2) and all(torch.equal(grads[n], grads2[n]) for n in grads)
        del dx2, grads2
        want_dx, want = vb.fused_vit_block_bwd_reference(x, dy, params, heads=heads)
        with k6_fault(vb, "chunk"):
            _, fault_chunk = run()
        with k6_fault(vb, "key_tile"):
            fault_dx, fault_tile = run()
        dx_rec = _agreement(dx.view(rows, dim), want_dx.view(rows, dim),
                            fault_dx.view(rows, dim), rtol)
        errors = grad_leaf_errors(grads, want)
        fault_errors = {"chunk": grad_leaf_errors(fault_chunk, want),
                        "key_tile": grad_leaf_errors(fault_tile, want)}
        finite = dx_rec["finite"] and all(bool(torch.isfinite(g).all()) for g in grads.values())
        del want, want_dx, fault_dx, fault_chunk, fault_tile

        stages = k6_stage_checks(vb, x, dy, params, heads, rtol)
        prof = profile_device(run, 10)
        per_kernel = {name: kernel_ms(prof["device_ms_by_name"], [name]) for name in K6_KERNELS}
        event_ms = cuda_ms(run, 10)
        plain_ms, _ = timed(lambda: vb.fused_vit_block_bwd_reference(x, dy, params, heads=heads), 5)
        library_ms, library_event_ms = timed(composed_library_block_fwd_bwd(x, params, heads, dy), 10)
        bounds = block_bwd_bounds(vb, b, s, dim, heads, 4 * dim, dname)
        ok = (
            finite and identical
            and dx_rec["atol_share_needed"] <= atol_share < dx_rec["fault_atol_share_needed"]
            and all(max(errors.values()) <= tol < max(f.values()) for f in fault_errors.values())
            and all(st["finite"] and st["atol_share_needed"] <= atol_share for st in stages.values())
        )
        out.append({
            "case": label, "dtype": dname, "shape": [b, s, dim, heads], "rows": rows,
            "atol_share": atol_share, "rtol": rtol, "grad_tol": tol,
            "dx": dx_rec, "grad_errors": errors, "stages": stages,
            "grad_error_max": max(errors.values()),
            "fault_grad_error_max": {k: max(f.values()) for k, f in fault_errors.items()},
            "bit_identical_across_calls": identical, "finite": finite,
            "chain_ms": prof["device_busy_ms"], "chain_event_ms": event_ms,
            "kernel_ms": per_kernel, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_event_ms": library_event_ms,
            "library": "composed block under autograd, forward and backward: F.layer_norm, "
                       "F.linear (cuBLAS), SDPA",
            "bound_ms": {k: v[0] for k, v in bounds.items()},
            "bound_by": {k: v[1] for k, v in bounds.items()},
            "ok": ok,
        })
        del params, x, dy, dx, grads
        torch.cuda.empty_cache()
    return out


def profile_device(fn, reps: int) -> dict:
    """Device time of ``reps`` calls of ``fn`` under torch.profiler: busy
    ms per call (the union of device activity), the idle share of the
    host-clock wall time, and device ms per call by kernel name.  A trace
    that holds no device activity at all (the tracer now and then delivers
    none for a short run) is taken again, at most three times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end))
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        if spans:
            break
    else:
        raise RuntimeError("the profiler saw no device activity in three traces")
    busy, start, end = 0.0, None, None
    for s0, s1 in sorted(spans):  # union of the device intervals
        if end is not None and s0 <= end:
            end = max(end, s1)
            continue
        if end is not None:
            busy += end - start
        start, end = s0, s1
    busy += end - start
    return {
        "wall_ms": wall_us / reps / 1e3,
        "device_busy_ms": busy / reps / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / wall_us),
        "device_ms_by_name": {name: us / reps / 1e3 for name, us in by_name.items()},
    }


def profile_batches(engine, images, reps: int = 5) -> dict:
    """``profile_device`` over ``reps`` dispatches of ``images``, with the
    largest device consumers by name."""
    prof = profile_device(lambda: engine.predict_logits(images), reps)
    top = sorted(prof["device_ms_by_name"].items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms_per_batch": prof["wall_ms"],
        "device_busy_ms_per_batch": prof["device_busy_ms"],
        "device_idle_share": prof["device_idle_share"],
        "top_device_ms_per_batch": {name[:60]: ms for name, ms in top},
    }


def serve_phase(attn) -> dict:
    import numpy as np
    import torch

    from distributed_training_comparison_tpu_torch import entry
    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    attn.flash_attention.launches = 0
    report = entry.run(SERVE_ARGV)
    launches = attn.flash_attention.launches
    engine_batches = sum(report["engine"]["bucket_counts"].values())

    # the same seeded weights through the kernel and through the reference
    # attention on the card, one batch of 8 (bucket 8: bh = 32, S = 4096).
    # Bound: the two paths round P to bf16 at different points (unnormalized
    # vs normalized), each of the 8 blocks adds that difference to a bf16
    # residual stream (2^-8 relative), so logits agree to a few bf16 ulps
    # of their own scale: 3e-2 absolute plus 3e-2 of the largest logit.
    hp = load_config(SERVE_ARGV)
    images = request_pool(8, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    kernel_engine = build_engine(hp)
    reference_engine = build_engine(hp, attn_impl="reference")
    logits = kernel_engine.predict_logits(images)
    ref = reference_engine.predict_logits(images)
    # one bucket-8 request batch end to end (uint8 upload, forward, logits
    # download; predict_logits returns host arrays, so the clock stops after
    # the card has finished): where the time of a dispatch goes
    forward_ms = {}
    for name, eng in (("kernel", kernel_engine), ("reference", reference_engine)):
        t0 = time.perf_counter()
        for _ in range(5):
            eng.predict_logits(images)
        forward_ms[name] = (time.perf_counter() - t0) / 5 * 1e3
    profiled = profile_batches(kernel_engine, images)
    err = float(np.abs(logits - ref).max())
    scale = float(np.abs(ref).max())
    tol = 3e-2 + 3e-2 * scale

    # the default precision (no --amp) serves fp32 through the kernel's fp32
    # path: the same batch, its launches and its time with each attention.
    # Bound: fp32 on both paths, where only attention's summation order and
    # exp2 differ (about 1e-6 relative), so 1e-3 of the logits' scale.
    hp32 = load_config([a for a in SERVE_ARGV if a != "--amp"])
    fp32 = {"precision": hp32.precision}
    for name, impl in (("kernel", "auto"), ("reference", "reference")):
        eng = build_engine(hp32, attn_impl=impl)
        before = attn.flash_attention.launches
        fp32[f"logits_{name}"] = eng.predict_logits(images)
        fp32[f"launches_{name}"] = attn.flash_attention.launches - before
        fp32[f"batch_ms_{name}"] = cuda_ms(lambda: eng.predict_logits(images), 3, warmup=1)
        del eng
    got32, want32 = fp32.pop("logits_kernel"), fp32.pop("logits_reference")
    fp32["logits_finite"] = bool(np.isfinite(got32).all() and np.isfinite(want32).all())
    fp32["logits_max_abs_err_vs_reference"] = float(np.abs(got32 - want32).max())
    fp32["logits_tol"] = 1e-3 * (1.0 + float(np.abs(want32).max()))
    return {
        "phase": "serve",
        "offered": report["offered"],
        "completed": report["completed"],
        "failed": report["failed"],
        "shed": report["shed"],
        "expired": report["expired"],
        "throughput_rps": report["throughput_rps"],
        "p50_ms": report["latency_ms"]["p50"],
        "p99_ms": report["latency_ms"]["p99"],
        "duration_s": report["duration_s"],
        "bucket_counts": report["engine"]["bucket_counts"],
        "engine_batches": engine_batches,
        "batcher_batches": report["batcher"]["batches"],
        "mean_batch_size": report["batcher"]["mean_batch_size"],
        "mean_service_ms": report["batcher"]["mean_service_ms"],
        "flash_launches": launches,
        "depth": len(kernel_engine.model.blocks),  # kernel launches per dispatch
        "logits_finite": bool(np.isfinite(logits).all() and np.isfinite(ref).all()),
        "logits_max_abs_err_vs_reference": err,
        "logits_scale": scale,
        "logits_tol": tol,
        "bucket8_batch_ms": forward_ms["kernel"],
        "bucket8_batch_ms_reference_attention": forward_ms["reference"],
        "bucket8_profile": profiled,
        "fp32_bucket8": fp32,
    }


SERVE_TINY_ARGV = [
    "--serve", "--model", "vit_tiny", "--patch-size", "2", "--amp",
    "--serve-buckets", "1,2,4,8,16,32", "--serve-shape", "closed",
    "--serve-requests", "256", "--serve-concurrency", "32", "--seed", "0",
]


def _block_counters(vb, attn) -> dict:
    return {"fused_vit_block": vb.fused_vit_block, "block_gemm": vb.block_gemm,
            "block_attention": vb.block_attention, "flash_attention": attn.flash_attention}


def serve_tiny_phase(vb, attn) -> dict:
    """``vit_tiny --patch-size 2`` served through ``entry.run``: every block
    of every dispatched batch through the fused K5 chain; the bucket-32
    logits against the composed reference engine in bf16 and fp32; one
    bucket-32 dispatch timed fused and composed, and profiled."""
    import numpy as np

    from distributed_training_comparison_tpu_torch import entry
    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    counters = _block_counters(vb, attn)
    for c in counters.values():
        c.launches = 0
    report = entry.run(SERVE_TINY_ARGV)
    launches = {name: c.launches for name, c in counters.items()}

    # the same seeded weights through the fused chain and through the
    # composed reference engine (attn_impl="reference" pins attention, so
    # the gate declines and every block composes), one batch of 32.
    # Bound, bf16: the paths round at different points (the composed Dense
    # adds its bias inside cuBLAS before rounding, its LayerNorm takes the
    # two-pass variance), each of the 12 blocks adds that ~2^-8 relative
    # difference to a bf16 residual stream, so the logits agree to a few
    # bf16 ulps of their scale: 3e-2 absolute plus 3e-2 of the largest.
    # fp32: summation order and the variance formula only, 1e-3 of the scale.
    checks = {}
    for precision, argv in (("bf16", SERVE_TINY_ARGV),
                            ("fp32", [a for a in SERVE_TINY_ARGV if a != "--amp"])):
        hp = load_config(argv)
        images = request_pool(32, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
        fused, reference = build_engine(hp), build_engine(hp, attn_impl="reference")
        before = vb.fused_vit_block.launches
        got = fused.predict_logits(images)
        fused_launches = vb.fused_vit_block.launches - before
        before = vb.fused_vit_block.launches
        want = reference.predict_logits(images)
        scale = float(np.abs(want).max())
        tol = 3e-2 + 3e-2 * scale if precision == "bf16" else 1e-3 * (1.0 + scale)
        rec = {
            "launches_fused": fused_launches,
            "launches_reference": vb.fused_vit_block.launches - before,
            "logits_finite": bool(np.isfinite(got).all() and np.isfinite(want).all()),
            "logits_max_abs_err_vs_reference": float(np.abs(got - want).max()),
            "logits_scale": scale, "logits_tol": tol,
        }
        if precision == "bf16":
            # one bucket-32 dispatch end to end (uint8 upload, forward,
            # logits download), fused and with --block-fusion off
            off = build_engine(load_config(argv + ["--block-fusion", "off"]))
            for name, eng in (("fused", fused), ("off", off), ("fused_again", fused),
                              ("off_again", off)):
                eng.predict_logits(images)
                t0 = time.perf_counter()
                for _ in range(5):
                    eng.predict_logits(images)
                rec[f"bucket32_batch_ms_{name}"] = (time.perf_counter() - t0) / 5 * 1e3
            prof = profile_device(lambda: fused.predict_logits(images), 5)
            k5 = sum(ms for name, ms in prof["device_ms_by_name"].items() if "vit_block_" in name)
            top = sorted(prof["device_ms_by_name"].items(), key=lambda kv: -kv[1])[:8]
            rec["bucket32_profile"] = {
                "wall_ms_per_batch": prof["wall_ms"],
                "device_busy_ms_per_batch": prof["device_busy_ms"],
                "device_idle_share": prof["device_idle_share"],
                "k5_device_ms_per_batch": k5,
                "k5_share_of_device_busy": k5 / prof["device_busy_ms"],
                "top_device_ms_per_batch": {name[:60]: ms for name, ms in top},
            }
            del off
        checks[precision] = rec
        depth = len(fused.model.blocks)
        del fused, reference
    return {
        "phase": "serve_tiny",
        "argv": SERVE_TINY_ARGV,
        "offered": report["offered"],
        "completed": report["completed"],
        "failed": report["failed"],
        "shed": report["shed"],
        "expired": report["expired"],
        "throughput_rps": report["throughput_rps"],
        "p50_ms": report["latency_ms"]["p50"],
        "p99_ms": report["latency_ms"]["p99"],
        "duration_s": report["duration_s"],
        "bucket_counts": report["engine"]["bucket_counts"],
        "engine_batches": sum(report["engine"]["bucket_counts"].values()),
        "mean_batch_size": report["batcher"]["mean_batch_size"],
        "mean_service_ms": report["batcher"]["mean_service_ms"],
        "depth": depth,
        "launches": launches,
        "bucket32": checks,
    }


# One step through the kernels (K) against the same seeded weights and
# batch through the reference attention (R, ``attn_impl="reference"``),
# and against P: the plain forward with the kernels' backward arithmetic
# (``flash_attention_bwd_reference``), no kernel.  precision -> (argv edit,
# batch, loss bound relative, bound on K vs R, bound on K vs P), the
# gradient bounds as relative L2 per parameter.  R is torch autograd
# through ``mha_reference``, which rounds the cotangent of P to bf16
# before the softmax backward subtracts its row mean; where that
# difference cancels (the q and k projections of the last blocks) R's own
# bf16 gradients are ~3% off, and P shows it: P vs R is the floor any
# correct kernel meets.  So in bf16 K vs R is held to 2^-4, above that
# floor, and K vs P, which differ only where the kernel forward rounds P
# unnormalised and by summation order, to 2^-6.  The planted fault (P with
# every block's dq missing its first 64 keys and dk/dv missing their first
# 64 queries: one tile of each kernel) must exceed both bounds.  The loss
# only sees the forward: 2^-6 relative.  fp32: only summation order and
# exp differ (~1e-6 relative): 1e-5 on the loss, 2^-13 on the gradients.
# bf16 runs a batch of 8: R keeps two fp32 (bh, S, S) tensors per block
# for its backward, 34 GB at batch 8.  fp32 runs the fp32 train step's
# batch of 2.
STEP_CHECKS = {
    "bf16": (lambda argv: argv, 8, 2**-6, 2**-4, 2**-6),
    "fp32": (lambda argv: [a for a in argv if a != "--amp"] + ["--batch-size", "2"],
             2, 1e-5, 2**-13, 2**-13),
}


def grad_errors(grads: dict, ref: dict) -> dict[str, float]:
    """Each gradient's relative L2 error against ``ref``'s.  ``k_proj.bias``
    is measured against its block's ``k_proj.weight`` gradient instead: its
    exact gradient is zero (softmax ignores a shift shared by a row's
    scores), so every path holds rounding noise there."""
    out = {}
    for name, g in grads.items():
        key = name.replace("bias", "weight") if name.endswith("k_proj.bias") else name
        out[name] = ((g - ref[name]).norm() / ref[key].norm().clamp_min(1e-30)).item()
    return out


def plain_attention(attn, fault: bool):
    """``models.vit``'s ``attention`` as the plain forward with the plain
    flash backward (``flash_attention_bwd_reference``).  ``fault`` plants
    one missing tile in each backward kernel's sum: dq without the first
    ``FAULT_KEYS`` keys (the plain dq on keys zeroed there, with the true
    lse), dk/dv without the first ``FAULT_KEYS`` queries (queries and their
    output cotangents zeroed there)."""
    import torch

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale):
            out, lse = attn.mha_reference(q, k, v, scale=scale, return_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.scale = scale
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            kw = dict(causal=False, scale=ctx.scale)
            dq, dk, dv = attn.flash_attention_bwd_reference(q, k, v, out, lse, do, None, **kw)
            if fault:
                dq = attn.flash_attention_bwd_reference(
                    q, dropped_rows(k, "bhsd"), v, out, lse, do, None, **kw
                )[0]
                dk, dv = attn.flash_attention_bwd_reference(
                    dropped_rows(q, "bhsd"), k, v, out, lse, dropped_rows(do, "bhsd"), None, **kw
                )[1:]
            return dq, dk, dv, None

    def attention(q, k, v, *, impl, layout):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # bshd -> bhsd views
        return PlainFlash.apply(qt, kt, vt, q.shape[-1] ** -0.5).transpose(1, 2)

    return attention


def _worst(errors: dict, n: int = 3) -> dict:
    return dict(sorted(errors.items(), key=lambda kv: -kv[1])[:n])


def step_check(attn, precision: str) -> dict:
    """One step's loss and gradients through the kernels against the same
    seeded weights and batch through the reference attention; the plain
    flash backward and the planted fault against the same reference."""
    import torch

    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.data import get_datasets
    from distributed_training_comparison_tpu_torch.models import vit
    from distributed_training_comparison_tpu_torch.train import build_model, forward_backward
    from distributed_training_comparison_tpu_torch.train.step import COMPUTE_DTYPES

    edit, batch, loss_tol, ref_tol, plain_tol = STEP_CHECKS[precision]
    hp = load_config(edit(TRAIN_ARGV))
    images, labels = get_datasets(hp)[0]
    images = torch.from_numpy(images[:batch]).cuda()
    labels = torch.from_numpy(labels[:batch]).long().cuda()
    counters = (attn.flash_attention, attn.flash_attention_dq, attn.flash_attention_dkv)
    runs = {}
    for name, impl, swap in (
        ("kernel", "auto", None), ("reference", "reference", None),
        ("plain", "reference", plain_attention(attn, fault=False)),
        ("fault", "reference", plain_attention(attn, fault=True)),
    ):
        model = build_model(hp, impl).cuda()
        before = [c.launches for c in counters]
        saved = vit.attention
        vit.attention = swap or saved
        try:
            loss, _ = forward_backward(
                model, images, labels, compute_dtype=COMPUTE_DTYPES[hp.precision]
            )
            torch.cuda.synchronize()
        finally:
            vit.attention = saved
        runs[name] = {
            "loss": loss.item(),
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "launches": [c.launches - n for c, n in zip(counters, before)],
            "depth": len(model.blocks),
        }
        del model, loss
        torch.cuda.empty_cache()
    ref, plain = runs["reference"]["grads"], runs["plain"]["grads"]
    errors = {name: grad_errors(runs[name]["grads"], ref) for name in ("kernel", "plain", "fault")}
    errors["kernel_vs_plain"] = grad_errors(runs["kernel"]["grads"], plain)
    errors["fault_vs_plain"] = grad_errors(runs["fault"]["grads"], plain)
    finite = all(bool(torch.isfinite(g).all()) for g in runs["kernel"]["grads"].values())
    loss_ref = runs["reference"]["loss"]
    loss_err = abs(runs["kernel"]["loss"] - loss_ref) / abs(loss_ref)
    worst = {name: max(e.values()) for name, e in errors.items()}
    depth = runs["kernel"]["depth"]
    return {
        "precision": precision, "batch": batch,
        "loss_kernel": runs["kernel"]["loss"], "loss_reference": loss_ref,
        "loss_rel_err": loss_err, "loss_tol": loss_tol,
        "grad_rel_l2_tol": ref_tol,
        "grad_rel_l2_max": worst["kernel"], "grad_rel_l2_worst": _worst(errors["kernel"]),
        "plain_flash_grad_rel_l2_max": worst["plain"],
        "plain_flash_grad_rel_l2_worst": _worst(errors["plain"]),
        "kernel_vs_plain_flash_tol": plain_tol,
        "kernel_vs_plain_flash_grad_rel_l2_max": worst["kernel_vs_plain"],
        "kernel_vs_plain_flash_worst": _worst(errors["kernel_vs_plain"]),
        "fault_grad_rel_l2_max": worst["fault"], "fault_grad_rel_l2_worst": _worst(errors["fault"]),
        "fault_vs_plain_flash_grad_rel_l2_max": worst["fault_vs_plain"],
        "grads_finite": finite,
        "launches_kernel": runs["kernel"]["launches"],
        "launches_reference": runs["reference"]["launches"],
        "depth": depth,
        "ok": (
            finite and loss_err <= loss_tol
            and worst["kernel"] <= ref_tol < worst["fault"]
            and worst["kernel_vs_plain"] <= plain_tol < worst["fault_vs_plain"]
            and runs["kernel"]["launches"] == [depth] * 3
            and runs["reference"]["launches"] == [0, 0, 0]
        ),
    }


def step_profile(trainer) -> dict:
    """Where one train step's device time goes: ``profile_device`` over two
    steps of ``trainer`` on its first batch, split into the flash forward,
    dq and dk/dv kernels, the cuBLAS GEMMs and the rest."""
    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.utils import step_generator

    hp = trainer.hparams
    images, labels = next(trainer.train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    trainer.step(images, labels, draws)  # warm
    prof = profile_device(lambda: trainer.step(images, labels, draws), 2)
    split = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0, "gemm": 0.0, "rest": 0.0}
    for name, ms in prof["device_ms_by_name"].items():
        low = name.lower()
        if "flash_fwd" in low:
            split["flash_fwd"] += ms
        elif "flash_bwd_dq" in low:
            split["flash_dq"] += ms
        elif "flash_bwd_dkv" in low:
            split["flash_dkv"] += ms
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            split["gemm"] += ms
        else:
            split["rest"] += ms
    top = sorted(prof["device_ms_by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms_per_step": prof["wall_ms"],
        "device_busy_ms_per_step": prof["device_busy_ms"],
        "device_idle_share": prof["device_idle_share"],
        "device_ms_per_step": split,
        "top_device_ms_per_step": {name[:60]: ms for name, ms in top},
    }


def train_phase(attn, smi: str) -> dict:
    import torch

    from distributed_training_comparison_tpu_torch import entry
    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.data import get_datasets
    from distributed_training_comparison_tpu_torch.train import Trainer

    counters = {"fwd": attn.flash_attention, "dq": attn.flash_attention_dq,
                "dkv": attn.flash_attention_dkv}
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    report = entry.run(TRAIN_ARGV)
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    hp = load_config(TRAIN_ARGV)
    epochs = report["fit"]["epochs"]
    val_examples = len(get_datasets(hp)[1][1])
    last = epochs[-1]
    checks = {p: step_check(attn, p) for p in STEP_CHECKS}
    trainer = Trainer(hp)
    profile = step_profile(trainer)
    del trainer
    torch.cuda.empty_cache()
    return {
        "phase": "train",
        "nvidia_smi": smi,
        "argv": TRAIN_ARGV,
        "train_steps": sum(e["steps"] for e in epochs),
        "eval_batches": len(epochs) * math.ceil(val_examples / hp.batch_size),
        "depth": checks["bf16"]["depth"],
        "launches": launches,
        "losses_finite": all(e["nonfinite_losses"] == 0 for e in epochs),
        "skipped_steps": sum(e["skipped"] for e in epochs),
        "epochs": epochs,
        "peak_memory_gb": peak_gb,
        "last_epoch_images_per_s": last["images_per_s"],
        "last_epoch_ms_per_step": last["seconds"] / last["steps"] * 1e3,
        "step_checks": checks,
        "step_profile": profile,
    }


TRAIN_TINY_ARGV = [
    "--model", "vit_tiny", "--patch-size", "2", "--amp", "--synthetic-data",
    "--limit-examples", "1280", "--batch-size", "128", "--epoch", "2",
    "--lr-decay-step-size", "1",
]
K6_COUNTERS = ("fused_vit_block_bwd", "block_ln", "block_gemm_dgrad", "block_ln_bwd",
               "block_attention_bwd", "block_gemm_wgrad", "block_grad_reduce")
# launches of each K6 wrapper per block backward
K6_PER_BLOCK = {"fused_vit_block_bwd": 1, "block_ln": 2, "block_gemm_dgrad": 4, "block_ln_bwd": 2,
                "block_attention_bwd": 1, "block_gemm_wgrad": 4, "block_grad_reduce": 1}


def _tiny_counters(vb, attn) -> dict:
    return {**_block_counters(vb, attn), **{n: getattr(vb, n) for n in K6_COUNTERS},
            "flash_attention_dq": attn.flash_attention_dq,
            "flash_attention_dkv": attn.flash_attention_dkv}


def plain_block_chains(vb, fault: bool):
    """Context that swaps the fused block's K5 forward and K6 backward on
    the card for their plain versions (the autograd Function stays).
    ``fault`` plants one missing tile in the attention backward of every
    block: dk and dv of the first ``FAULT_KEYS`` keys of every item left
    zero, as a dk/dv kernel that skipped its first key tile would leave
    them."""
    def forward(x, params, heads, norm_f32):
        return vb.fused_vit_block_reference(x, params, heads=heads, norm_f32=norm_f32)

    def attention_bwd(qkv, do, *, seq, heads):
        out = saved_attn(qkv, do, seq=seq, heads=heads)
        dim = qkv.shape[1] // 3
        out.view(-1, seq, 3 * dim)[:, :FAULT_KEYS, dim:] = 0
        return out

    saved = (vb._block_forward, vb.fused_vit_block_bwd, vb.packed_attention_bwd_reference)
    saved_attn = saved[2]

    @contextlib.contextmanager
    def swapped():
        vb._block_forward, vb.fused_vit_block_bwd = forward, vb.fused_vit_block_bwd_reference
        if fault:
            vb.packed_attention_bwd_reference = attention_bwd
        try:
            yield
        finally:
            vb._block_forward, vb.fused_vit_block_bwd, vb.packed_attention_bwd_reference = saved

    return swapped()


# One train step of vit_tiny --patch-size 2 through the kernels (K: every
# block's forward through K5, its backward through K6) against the same
# seeded weights and batch through --block-fusion off (R: the composed
# blocks, whose attention at 256 tokens is the plain mha_reference under
# autograd) and against P: the fused block's autograd Function with the
# plain forward and backward (no kernel).  precision -> (argv edit, loss
# bound relative, bound on K vs R, bound on K vs P), gradient bounds as
# relative L2 per parameter.  bf16: R rounds at other points than the
# fused block (its Dense adds the bias inside cuBLAS before rounding, its
# LayerNorm takes the two-pass variance, and autograd through
# mha_reference rounds the cotangent of P to bf16 before the softmax
# backward), 12 blocks deep; P vs R is the floor any correct kernel meets,
# as in the vit_long train phase, so K vs R is held to 2^-4 and K vs P,
# which differ only by summation order and the bf16 flips it causes, to
# 2^-6.  The planted fault (P with dk and dv of the first FAULT_KEYS keys of
# every item left zero in every block) must exceed both.  The loss only
# sees the forward: 2^-6.  fp32: summation order and the variance formula
# only: 1e-5 on the loss, 2^-13 on the gradients.  Batch 128, the train
# command's.
TINY_STEP_CHECKS = {
    "bf16": (lambda argv: argv, 2**-6, 2**-4, 2**-6),
    "fp32": (lambda argv: [a for a in argv if a != "--amp"], 1e-5, 2**-13, 2**-13),
}


def tiny_step_check(vb, attn, precision: str) -> dict:
    import torch

    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.data import get_datasets
    from distributed_training_comparison_tpu_torch.train import build_model, forward_backward
    from distributed_training_comparison_tpu_torch.train.step import COMPUTE_DTYPES

    edit, loss_tol, ref_tol, plain_tol = TINY_STEP_CHECKS[precision]
    hp = load_config(edit(TRAIN_TINY_ARGV))
    hp_off = load_config(edit(TRAIN_TINY_ARGV) + ["--block-fusion", "off"])
    images, labels = get_datasets(hp)[0]
    images = torch.from_numpy(images[:hp.batch_size]).cuda()
    labels = torch.from_numpy(labels[:hp.batch_size]).long().cuda()
    counters = (vb.fused_vit_block, vb.fused_vit_block_bwd)
    torch.manual_seed(hp.seed)
    state = build_model(hp).state_dict()
    runs = {}
    for name, h, swap in (
        ("kernel", hp, None), ("reference", hp_off, None),
        ("plain", hp, lambda: plain_block_chains(vb, fault=False)),
        ("fault", hp, lambda: plain_block_chains(vb, fault=True)),
    ):
        model = build_model(h)
        model.load_state_dict(state)
        model = model.cuda()
        before = [c.launches for c in counters]
        with swap() if swap else contextlib.nullcontext():
            loss, _ = forward_backward(
                model, images, labels, compute_dtype=COMPUTE_DTYPES[h.precision]
            )
            torch.cuda.synchronize()
        runs[name] = {
            "loss": loss.item(),
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "launches": [c.launches - n for c, n in zip(counters, before)],
            "depth": len(model.blocks),
        }
        del model, loss
        torch.cuda.empty_cache()
    ref, plain = runs["reference"]["grads"], runs["plain"]["grads"]
    errors = {name: grad_errors(runs[name]["grads"], ref) for name in ("kernel", "plain", "fault")}
    errors["kernel_vs_plain"] = grad_errors(runs["kernel"]["grads"], plain)
    errors["fault_vs_plain"] = grad_errors(runs["fault"]["grads"], plain)
    worst = {name: max(e.values()) for name, e in errors.items()}
    finite = all(bool(torch.isfinite(g).all()) for g in runs["kernel"]["grads"].values())
    loss_ref = runs["reference"]["loss"]
    loss_err = abs(runs["kernel"]["loss"] - loss_ref) / abs(loss_ref)
    depth = runs["kernel"]["depth"]
    return {
        "precision": precision, "batch": hp.batch_size,
        "loss_kernel": runs["kernel"]["loss"], "loss_reference": loss_ref,
        "loss_plain": runs["plain"]["loss"], "loss_rel_err": loss_err, "loss_tol": loss_tol,
        "grad_rel_l2_tol": ref_tol,
        "grad_rel_l2_max": worst["kernel"], "grad_rel_l2_worst": _worst(errors["kernel"]),
        "plain_grad_rel_l2_max": worst["plain"], "plain_grad_rel_l2_worst": _worst(errors["plain"]),
        "kernel_vs_plain_tol": plain_tol,
        "kernel_vs_plain_grad_rel_l2_max": worst["kernel_vs_plain"],
        "kernel_vs_plain_worst": _worst(errors["kernel_vs_plain"]),
        "fault_grad_rel_l2_max": worst["fault"],
        "fault_vs_plain_grad_rel_l2_max": worst["fault_vs_plain"],
        "grads_finite": finite,
        "launches_kernel": runs["kernel"]["launches"],
        "launches_reference": runs["reference"]["launches"],
        "launches_plain": runs["plain"]["launches"],
        "depth": depth,
        "ok": (
            finite and loss_err <= loss_tol
            and worst["kernel"] <= ref_tol < worst["fault"]
            and worst["kernel_vs_plain"] <= plain_tol < worst["fault_vs_plain"]
            and runs["kernel"]["launches"] == [depth, depth]
            and runs["reference"]["launches"] == [0, 0]
            and runs["plain"]["launches"] == [0, 0]
        ),
    }


def tiny_step_times(reps: int = 5) -> dict:
    """ms per train step (host clock around ``reps`` steps ending in a
    synchronise) of the train command's trainer, fused and with
    ``--block-fusion off``, in turns (fused, off, fused, off), and a
    profile of two fused steps: the K5 and K6 kernels' shares of the
    device's busy time, and its idle share."""
    import torch

    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.train import Trainer
    from distributed_training_comparison_tpu_torch.utils import step_generator

    trainers = {
        "fused": Trainer(load_config(TRAIN_TINY_ARGV)),
        "off": Trainer(load_config(TRAIN_TINY_ARGV + ["--block-fusion", "off"])),
    }
    hp = trainers["fused"].hparams
    images, labels = next(trainers["fused"].train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    out = {}
    for rnd in range(2):
        for name, tr in trainers.items():
            tr.step(images, labels, draws)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                tr.step(images, labels, draws)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / reps * 1e3
            out[f"ms_per_step_{name}" + ("_again" if rnd else "")] = ms
            out[f"images_per_s_{name}" + ("_again" if rnd else "")] = hp.batch_size / ms * 1e3
    prof = profile_device(lambda: trainers["fused"].step(images, labels, draws), 2)
    names = prof["device_ms_by_name"]
    k6 = kernel_ms(names, K6_COUNTERS[1:])
    k5 = kernel_ms(names, ["block_gemm", "block_attention"])
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    out["profile"] = {
        "wall_ms_per_step": prof["wall_ms"],
        "device_busy_ms_per_step": prof["device_busy_ms"],
        "device_idle_share": prof["device_idle_share"],
        "k5_kernels_device_ms_per_step": k5,
        "k5_kernels_share_of_busy": k5 / prof["device_busy_ms"],
        "k6_only_kernels_device_ms_per_step": k6,
        "k6_only_kernels_share_of_busy": k6 / prof["device_busy_ms"],
        "note": "K6's recompute runs K5's kernels, counted under k5",
        "top_device_ms_per_step": {n[:60]: ms for n, ms in top},
    }
    del trainers
    torch.cuda.empty_cache()
    return out


def train_tiny_phase(vb, attn, smi: str) -> dict:
    """``vit_tiny --patch-size 2`` trained through ``entry.run``: every
    block's forward through K5 and backward through K6, the launch counters
    zeroed just before and read just after; one step's loss and gradients
    against the composed path (bf16 and fp32); ms per step fused and
    composed; a step profile."""
    import torch

    from distributed_training_comparison_tpu_torch import entry
    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.data import get_datasets

    counters = _tiny_counters(vb, attn)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = entry.run(TRAIN_TINY_ARGV)
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hp = load_config(TRAIN_TINY_ARGV)
    epochs = report["fit"]["epochs"]
    val_examples = len(get_datasets(hp)[1][1])
    last = epochs[-1]
    checks = {p: tiny_step_check(vb, attn, p) for p in TINY_STEP_CHECKS}
    return {
        "phase": "train_tiny",
        "nvidia_smi": smi,
        "argv": TRAIN_TINY_ARGV,
        "run_seconds": seconds,
        "train_steps": sum(e["steps"] for e in epochs),
        "eval_batches": len(epochs) * math.ceil(val_examples / hp.batch_size),
        "depth": checks["bf16"]["depth"],
        "launches": launches,
        "losses_finite": all(e["nonfinite_losses"] == 0 for e in epochs),
        "skipped_steps": sum(e["skipped"] for e in epochs),
        "epochs": epochs,
        "peak_memory_gb": peak_gb,
        "last_epoch_images_per_s": last["images_per_s"],
        "last_epoch_ms_per_step": last["seconds"] / last["steps"] * 1e3,
        "step_checks": checks,
        "step_times": tiny_step_times(),
    }


def check_train_tiny(tiny: dict) -> None:
    depth, steps = tiny["depth"], tiny["train_steps"]
    fwd = depth * (steps + tiny["eval_batches"])
    bwd = depth * steps
    want = {"fused_vit_block": fwd, "block_gemm": 4 * fwd + 3 * bwd,
            "block_attention": fwd + bwd, "flash_attention": 0,
            "flash_attention_dq": 0, "flash_attention_dkv": 0,
            **{n: k * bwd for n, k in K6_PER_BLOCK.items()}}
    if tiny["launches"] != want:
        raise RuntimeError(f"train_tiny launches {tiny['launches']}, expected {want}")
    if not tiny["losses_finite"] or tiny["skipped_steps"]:
        raise RuntimeError("train_tiny: a non-finite loss or a skipped step")
    bad = {p: c for p, c in tiny["step_checks"].items() if not c["ok"]}
    if bad:
        raise RuntimeError(f"a vit_tiny p2 train step through K5/K6 disagrees: {bad}")


def main() -> int:
    if not (ROOT / PKG).is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository "
              f"(no {PKG}/)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # the plain versions and the fp32 kernel are held in true fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "capability": list(cap),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    if cap != (9, 0):
        raise RuntimeError(f"{kind} has capability {cap}; the port's kernels need (9, 0)")

    from distributed_training_comparison_tpu_torch.ops import _build

    # the module, not the ``attention`` function the package re-exports
    attn = importlib.import_module(f"{PKG}.ops.attention")
    vb = importlib.import_module(f"{PKG}.ops.vit_block")

    t0 = time.monotonic()
    paths = _build.build_all()
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in paths.items()}})
    for path in paths.values():
        log = path.with_suffix(".log")
        for line in (log.read_text() if log.exists() else "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {path.stem}: {line.strip()}", file=sys.stderr)

    checks = kernel_checks(attn)
    emit({"phase": "kernel_checks", "checks": checks})
    bad = [c["case"] for c in checks if not c["ok"]]
    if bad:
        raise RuntimeError(f"flash_attention_fwd disagrees with mha_reference: {bad}")

    bwd = backward_checks(attn)
    emit({"phase": "backward_kernel_checks", "nvidia_smi": smi, "checks": bwd})
    bad = [c["case"] for c in bwd if not c["ok"]]
    if bad:
        raise RuntimeError(f"flash-attention backward kernels disagree with the plain version: {bad}")

    blocks = fused_block_checks(vb)
    emit({"phase": "fused_block_checks", "nvidia_smi": smi, "checks": blocks})
    bad = [c["case"] for c in blocks if not c["ok"]]
    if bad:
        raise RuntimeError(f"the fused block kernels disagree with the plain version: {bad}")

    bwd_blocks = fused_block_bwd_checks(vb)
    emit({"phase": "fused_block_bwd_checks", "nvidia_smi": smi, "checks": bwd_blocks})
    bad = [c["case"] for c in bwd_blocks if not c["ok"]]
    if bad:
        raise RuntimeError(f"the fused block backward kernels disagree with the plain version: {bad}")

    serve = serve_phase(attn)
    emit(serve)
    if serve["completed"] != serve["offered"] or serve["failed"]:
        raise RuntimeError(f"serve phase lost requests: {serve}")
    if serve["flash_launches"] != serve["depth"] * serve["engine_batches"]:
        raise RuntimeError(
            f"{serve['flash_launches']} flash-attention launches for "
            f"{serve['engine_batches']} dispatched batches of a depth-"
            f"{serve['depth']} model"
        )
    if not serve["logits_finite"]:
        raise RuntimeError("non-finite logits")
    if serve["logits_max_abs_err_vs_reference"] > serve["logits_tol"]:
        raise RuntimeError("kernel-path logits disagree with the reference path")
    fp32 = serve["fp32_bucket8"]
    if (fp32["launches_kernel"], fp32["launches_reference"]) != (serve["depth"], 0):
        raise RuntimeError(f"fp32 batch of 8: launches {fp32}")
    if not fp32["logits_finite"] or (
        fp32["logits_max_abs_err_vs_reference"] > fp32["logits_tol"]
    ):
        raise RuntimeError(f"fp32 kernel-path logits disagree with the reference: {fp32}")

    tiny = serve_tiny_phase(vb, attn)
    emit(tiny)
    if tiny["completed"] != tiny["offered"] or tiny["failed"]:
        raise RuntimeError(f"serve_tiny phase lost requests: {tiny}")
    blocks_run = tiny["depth"] * tiny["engine_batches"]
    want = {"fused_vit_block": blocks_run, "block_gemm": 4 * blocks_run,
            "block_attention": blocks_run, "flash_attention": 0}
    if tiny["launches"] != want:
        raise RuntimeError(f"serve_tiny launches {tiny['launches']}, expected {want}")
    for precision, rec in tiny["bucket32"].items():
        if (rec["launches_fused"], rec["launches_reference"]) != (tiny["depth"], 0):
            raise RuntimeError(f"serve_tiny {precision} bucket-32 batch: launches {rec}")
        if not rec["logits_finite"] or rec["logits_max_abs_err_vs_reference"] > rec["logits_tol"]:
            raise RuntimeError(
                f"serve_tiny {precision}: fused logits disagree with the composed reference: {rec}"
            )

    train = train_phase(attn, smi)
    emit(train)
    depth, steps = train["depth"], train["train_steps"]
    want = {"fwd": depth * (steps + train["eval_batches"]), "dq": depth * steps,
            "dkv": depth * steps}
    if train["launches"] != want:
        raise RuntimeError(f"train phase launches {train['launches']}, expected {want}")
    if not train["losses_finite"] or train["skipped_steps"]:
        raise RuntimeError("train phase: a non-finite loss or a skipped step")
    bad = {p: c for p, c in train["step_checks"].items() if not c["ok"]}
    if bad:
        raise RuntimeError(f"a train step through the kernels disagrees with the reference: {bad}")

    tiny_train = train_tiny_phase(vb, attn, smi)
    emit(tiny_train)
    check_train_tiny(tiny_train)

    csrc = f"{PKG}/ops/csrc"
    replaces = {
        "K1": "distributed_training_comparison_tpu/ops/attention.py:170",
        "K2": "distributed_training_comparison_tpu/ops/attention.py:224",
        "K3": "distributed_training_comparison_tpu/ops/attention.py:370",
        "K4": "distributed_training_comparison_tpu/ops/attention.py:427",
    }
    # one entry per checked case and kernel.  The forward's ``launches`` is
    # its count on the serve path (``launches_train`` on the train path);
    # the backward kernels' on the train path.  The backward's ``plain_ms``
    # and ``library_ms`` time the whole backward (dq, dk and dv together).
    kernels = []
    for case in checks:
        kernels.append({
            "name": "flash_attention_fwd", "route": "cuda",
            "source": f"{csrc}/flash_attention_fwd.cu",
            "replaces": replaces[case["regime"]], "regime": case["regime"],
            "case": case["case"], "shape_bhsd": case["shape"], "dtype": case["dtype"],
            "causal": case["causal"],
            "launches": serve["flash_launches"],
            "launches_counted": "serve main path, one counter for every case",
            "launches_train": train["launches"]["fwd"],
            "max_abs_err": case["max_abs_err"], "max_abs_err_lse": case["max_abs_err_lse"],
            "atol_share": case["atol_share"], "rtol": case["rtol"],
            "tol_lse": case["tol_lse"], "atol_share_needed": case["atol_share_needed"],
            "fault_atol_share_needed": case["fault_atol_share_needed"],
            "ms": case["ms"], "kernel_ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
        })
    for case in bwd:
        for kernel, regime, grads in (("dq", "K3", ("dq",)), ("dkv", "K4", ("dk", "dv"))):
            kernels.append({
                "name": f"flash_attention_{kernel}", "route": "cuda",
                "source": f"{csrc}/flash_attention_bwd.cu",
                "replaces": replaces[regime], "regime": regime,
                "case": case["case"], "shape_bhsd": case["shape"], "dtype": case["dtype"],
                "causal": case["causal"], "dlse": case["dlse"],
                "launches": train["launches"][kernel],
                "launches_counted": "train main path, one counter for every case",
                "max_abs_err": max(case["grads"][g]["max_abs_err"] for g in grads),
                "atol_share": case["atol_share"], "rtol": case["rtol"],
                "atol_share_needed": max(case["grads"][g]["atol_share_needed"] for g in grads),
                "fault_atol_share_needed": min(
                    case["grads"][g]["fault_atol_share_needed"] for g in grads
                ),
                "ms": case[f"{kernel}_ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case[f"{kernel}_bound_ms"], "bound_by": case[f"{kernel}_bound_by"],
                "library_ms": case["library_ms"],
                "pair_floor_ms_with_atomic_dq": case["pair_floor_ms_with_atomic_dq"],
            })
    # K5: per case, block_gemm (its four launches of one block together)
    # and block_attention, with the whole chain's numbers beside them.
    # ``launches`` is the kernel's count on the serve_tiny path.
    for case in blocks:
        gemm = case["gemm_launches"].values()
        chain = case["chain"]
        common = {
            "route": "cuda", "source": f"{csrc}/vit_block_fwd.cu",
            "replaces": "distributed_training_comparison_tpu/ops/vit_block.py:166",
            "regime": "K5", "case": case["case"], "dtype": case["dtype"],
            "shape_b_s_dim_heads": case["shape"],
            "launches_counted": "serve_tiny main path, one counter for every case",
            "atol_share": case["atol_share"], "rtol": case["rtol"],
            "chain_ms": chain["ms"], "chain_event_ms": chain["event_ms"],
            "chain_plain_ms": chain["plain_ms"],
            "chain_bound_ms": chain["bound_ms"], "chain_bound_by": chain["bound_by"],
            "chain_library_ms": chain["library_ms"], "chain_library": chain["library"],
            "chain_atol_share_needed": chain["atol_share_needed"],
            "chain_fault_atol_share_needed": chain["fault_atol_share_needed"],
        }
        kernels.append({
            "name": "block_gemm", **common,
            "launches": tiny["launches"]["block_gemm"],
            "per_block_launches": 4,
            "max_abs_err": max(g["max_abs_err"] for g in gemm),
            "atol_share_needed": max(g["atol_share_needed"] for g in gemm),
            "fault_atol_share_needed": min(g["fault_atol_share_needed"] for g in gemm),
            "ms": case["gemm_ms"], "event_ms": case["gemm_event_ms"],
            "plain_ms": case["gemm_plain_ms"],
            "bound_ms": case["gemm_bound_ms"], "bound_by": case["gemm_bound_by"],
            "library_ms": case["gemm_library_ms"], "library": case["gemm_library"],
        })
        att = case["attention"]
        kernels.append({
            "name": "block_attention", **common,
            "launches": tiny["launches"]["block_attention"],
            "per_block_launches": 1,
            "max_abs_err": att["max_abs_err"], "atol_share_needed": att["atol_share_needed"],
            "fault_atol_share_needed": att["fault_atol_share_needed"],
            "ms": att["ms"], "event_ms": att["event_ms"], "plain_ms": att["plain_ms"],
            "bound_ms": att["bound_ms"], "bound_by": att["bound_by"],
            "library_ms": att["library_ms"], "library": "F.scaled_dot_product_attention",
        })
    # K6: per case, each kernel of the backward chain (its launches in one
    # block backward together), with the whole chain's numbers beside it.
    # ``launches`` is the kernel's count on the train_tiny path; the
    # recompute's block_gemm and block_attention are K5's kernels, listed
    # above, and their train_tiny counts are in that phase's line.
    for case in bwd_blocks:
        common = {
            "route": "cuda", "source": f"{csrc}/vit_block_bwd.cu",
            "replaces": "distributed_training_comparison_tpu/ops/vit_block.py:181",
            "regime": "K6", "case": case["case"], "dtype": case["dtype"],
            "shape_b_s_dim_heads": case["shape"],
            "launches_counted": "train_tiny main path, one counter for every case",
            "chain_max_abs_err_dx": case["dx"]["max_abs_err"],
            "dx_atol_share_needed": case["dx"]["atol_share_needed"],
            "grad_error_max": case["grad_error_max"], "grad_tol": case["grad_tol"],
            "fault_grad_error_max": case["fault_grad_error_max"],
            "bit_identical_across_calls": case["bit_identical_across_calls"],
            "chain_ms": case["chain_ms"], "chain_event_ms": case["chain_event_ms"],
            "chain_plain_ms": case["plain_ms"], "chain_library_ms": case["library_ms"],
            "chain_library": case["library"],
            "chain_bound_ms": case["bound_ms"]["chain"], "chain_bound_by": case["bound_by"]["chain"],
        }
        for name in K6_COUNTERS[1:]:
            kernels.append({
                "name": name, **common,
                "launches": tiny_train["launches"][name],
                "per_block_launches": K6_PER_BLOCK[name],
                "max_abs_err": case["stages"][name]["max_abs_err"],
                "atol_share_needed": case["stages"][name]["atol_share_needed"],
                "plain_ms": case["stages"][name]["plain_ms"],
                "library_ms": case["stages"][name]["library_ms"],
                "ms": case["kernel_ms"][name],
                "bound_ms": case["bound_ms"][name], "bound_by": case["bound_by"][name],
            })
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
