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
             block as its library yardstick;
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
6. the ``{"kernels": [...]}`` line, then the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

It imports nothing of JAX.  Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib
import json
import math
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


def profile_device(fn, reps: int) -> dict:
    """Device time of ``reps`` calls of ``fn`` under torch.profiler: busy
    ms per call (the union of device activity), the idle share of the
    host-clock wall time, and device ms per call by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    if not spans:
        raise RuntimeError("the profiler saw no device activity")
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
