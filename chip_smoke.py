#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero before the
last line:

1. device  — ``nvidia-smi`` name and power limit, the card's capability
             (Hopper, 9.0, is required);
2. build   — compiles every CUDA library of the port from ``ops/csrc/``,
             one ``nvcc`` per source, all started together, and reports
             the registers and spills of the flash forward's and
             backward's kernels, of the short-sequence attention's and of
             the fused block chains' bf16 GEMMs (``block_gemm_wgmma``,
             ``dgrad_wgmma``, ``wgrad_wgmma``) and attention kernels
             (``block_attn_wgmma``, ``attn_dq_wgmma``, ``attn_dkv_wgmma``)
             and of the grouped expert FFN's bf16 kernels
             (``moe_ffn_fwd_wgmma``, ``moe_ffn_dw_wgmma``) (``ptxas -v``; a
             bf16 flash kernel, a one-tile kernel, a fused block GEMM or
             attention kernel or an expert FFN kernel that spills fails
             the run) and each such kernel's dynamic shared memory at the
             main paths' shapes;
3. kernel checks — each kernel against its plain PyTorch version on the
             card, at the shapes of the serve and train paths (bf16 and
             fp32) and the other regimes it covers, with the tolerance
             stated beside each and held against a planted fault it must
             reject; CUDA-event times of the kernel, the plain version and
             the one-call library yardstick: the flash-attention forward
             (K1/K2, with TFLOP/s and the bound's share of its time; a
             bf16 case whose S ends inside a 128-row tile), then its dq
             (K3) and dk/dv (K4) kernels (bf16 cases at the tiles' edges,
             each replayed for bit-identical gradients), then the
             fused ViT block chain (K5: ``block_gemm`` x 4 and
             ``block_attention``) against ``fused_vit_block_reference``,
             stage by stage and whole, each launch's kernels by symbol
             (bf16: ``block_gemm_wgmma`` and ``block_attn_wgmma`` alone),
             with the composed cuBLAS + SDPA block as its library
             yardstick; then the fused block backward
             chain (K6: ``block_ln``, ``block_gemm_dgrad``,
             ``block_ln_bwd``, ``block_attention_bwd``,
             ``block_gemm_wgrad``, ``block_grad_reduce``, with K5's kernels
             for the recompute) against ``fused_vit_block_bwd_reference``,
             each wrapper against its plain version and the chain's dx and
             twelve gradients whole, two faults planted on the kernels'
             results (a row chunk dropped from the gradient reductions, a
             key tile left out of the attention backward), bit-identical
             results across two calls, the kernels each wrapper ran by
             symbol (the GEMMs' and the attention's the dtype's only; bf16
             ``attn_dq_wgmma`` then ``attn_dkv_wgmma``), with the composed
             block's autograd forward and backward as its library
             yardstick;
4. serve   — the port's main path through its user entry point
             (``entry.run``): ``vit_long`` at 256 px (4096 tokens), bf16,
             buckets 1,2,4,8, closed loop of 64 requests at concurrency 8,
             seeded fresh weights.  The kernel launch counters are zeroed
             just before and read just after; every flash-attention launch
             must belong to a dispatched batch (depth x batches), and the
             engine's logits must match the same weights run through the
             reference attention on the card within 2^-6 of the largest
             logit, which a planted fault (the first 64 keys' V left out of
             every block's forward) must exceed; then one bucket-8 batch is
             timed with both attentions and profiled (device busy time,
             idle share, largest device consumers), and one batch of each
             smaller bucket (1, 2, 4) is timed and profiled; the same
             batch in fp32 (the default without ``--amp``) is checked and
             timed too;
   serve_tiny — the same entry with ``vit_tiny --patch-size 2`` (12 blocks,
             dim 192, 256 tokens), bf16, buckets 1..32, 256 requests at
             concurrency 32: every block of every dispatched batch runs the
             fused K5 chain and no flash-attention kernel runs; the bucket-32
             logits are held against the composed reference engine in bf16
             and fp32, a bucket-32 dispatch is timed fused and with
             ``--block-fusion off`` and profiled (``dispatch_times``; its
             port GEMM and attention by symbol must be ``block_gemm_wgmma``
             and ``block_attn_wgmma`` alone);
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
             per step fused and off, and a step profile whose port GEMMs
             by symbol must be ``block_gemm_wgmma``, ``dgrad_wgmma`` and
             ``wgrad_wgmma`` alone, and its attention kernels
             ``block_attn_wgmma``, ``attn_dq_wgmma`` and ``attn_dkv_wgmma``;
6. vit_moe  — ``moe_gmm_checks``: the grouped expert FFN's kernels (K7
             forward, K8 dx, K9 dW) against their plain versions at the
             serve shape (bf16, n 2048, cap 320), the train shape (bf16 and
             fp32, n 16384, cap 2560) and a ragged case (n 1000: an empty
             group, two over capacity, the last ending at n): kept rows to
             a per-row tolerance, dropped and padding rows exactly 0, the
             gradients per leaf, K8/K9 bit-identical across two calls, two
             planted faults rejected (a start shifted by a row, a row tile
             left out of K9's walk), the kernels each wrapper ran by
             symbol (bf16: ``moe_ffn_fwd_wgmma``, ``moe_gmm_dx_kernel``,
             ``moe_ffn_dw_wgmma``), device ms under the profiler (and
             CUDA-event ms) of each kernel, its plain version and the
             composed cuBLAS form of the gather dispatch;
   serve_moe — ``vit_moe --amp`` (8 blocks, dim 192, 3 heads, 8 experts of
             hidden 768, 64 tokens) served through ``entry.run``, buckets
             1..32, 256 requests at concurrency 32: K7 in every block of
             every dispatched batch, no flash, K5 or K6 launch; the
             bucket-32 logits against ``--moe-dispatch gather`` within 2^-10
             of the largest, which a planted K7 fault exceeds; a bucket-32
             dispatch timed under gmm and gather and profiled, and the MoE
             layer's device time split into K7 and routing/permutation;
             the expert FFN kernels each profile shows by symbol must be
             ``moe_ffn_fwd_wgmma`` alone, with device time;
   train_moe — ``vit_moe --amp`` trained at batch 256 (the JAX package's
             ``vit_moe_bf16_bs256``), 2304 synthetic training images (18
             steps) and 256 validation images: K7 in every forward, K8 and
             K9 in every backward, every loss finite, no step skipped, the
             routing health reported; one step's loss and every gradient
             (the router's included) against ``--moe-dispatch gather`` and
             the plain kernels (bf16 and fp32) with a bound that rejects a
             planted fault, and in fp32 (2^-13) a TF32 control; ms per step
             under gmm and gather, profiles, the gmm step's expert FFN
             kernels by symbol ``moe_ffn_fwd_wgmma`` (K7),
             ``moe_gmm_dx_kernel`` (K8) and ``moe_ffn_dw_wgmma`` (K9) alone,
             each with device time;
7. vit_tiny at 64 tokens — ``small_attention_checks``: the short-sequence
             attention's kernels (K10 forward, K11 backward; bf16 at S <= 64
             one wgmma kernel each way, longer items and fp32 a forward
             kernel and a dq, then dk/dv, pair) against their plain
             versions at the serve shape (bf16, B 32, S 64, 3 heads of 64),
             the train shape (bf16 and fp32, B 256), a ragged causal case
             (S 24), one tile at head dim 128 (causal), a ragged one-tile
             case (S 40) and a causal multi-tile case (S 256, head dim 128):
             each output and gradient per row, K11 bit-identical across two
             calls, two planted faults rejected (the last keys left out of
             K10, a dk row block dropped from K11), the kernels each call
             launched by symbol (those the rule on S names, no other),
             device ms of each kernel, its plain version and SDPA's forward
             and backward;
   serve_small — ``vit_tiny --amp`` pinned to ``attn_impl="fused_small"``
             and served through the library entry points
             (``build_engine``, ``MicroBatcher``, ``closed_loop``), buckets
             1..32, 256 requests at concurrency 32: the counters zeroed
             after the warmup, K10 in every block of every dispatched batch
             and no other kernel (counters, and by symbol in the bucket-32
             profile: ``attn_small_fwd_onetile`` alone); the bucket-32
             logits against ``attn_impl="reference"`` (bf16, fp32) within a
             bound a planted K10 fault exceeds; a bucket-32 dispatch timed
             under fused_small and auto, and profiled;
   train_small — ``vit_tiny --amp`` at batch 256 pinned the same way and
             trained through ``Trainer(hparams, model=...)``, 18 steps: K10
             in every block of every step and eval batch, K11 in every
             block of every step, no other kernel (counters, and by symbol
             in the step profile: the two one-tile kernels alone), every
             loss finite, no step skipped; one step's loss and gradients
             against the reference attention and the plain kernels (bf16,
             fp32) with a bound a planted fault exceeds; ms per step under
             fused_small and auto, and step profiles;
8. the ``{"kernels": [...]}`` line, then the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

``python3 chip_smoke.py --turn CHECKOUT LABEL`` instead times one checkout
of the port (this one or a parent unpacked beside it) through the same
functions, for comparisons made in turns within one call (``turn``).

It imports nothing of JAX.  Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
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

# serve's bucket-8 logits against the reference attention, as a share of
# the largest logit (see ``serve_phase``).  Read on the H100: 0.015625, one
# bf16 ulp at the largest logit (2.78); the planted fault 0.109, seven ulps.
# 2^-6 of the largest (0.043) passes up to two ulps and rejects the fault;
# the earlier 3e-2 + 3e-2 of the largest (0.113) let the fault through.
SERVE_LOGITS_TOL = 2**-6

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
    ("bf16 tile edges: S 1000 ends inside a 128-row tile", "K1", "bfloat16", 2, 4, 1000, 128, False, "bshd"),
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
FAULT_KEYS = 64  # the first half of the bf16 kernel's first 128-key tile


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


_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '\w*?(flash_(?:fwd|bwd)_\w+?|attn_small_\w+?|"
    r"(?:block_gemm|dgrad|wgrad|block_attn|attn_dq|attn_dkv)_wgmma)ILi(\d+)E(\w*?)EEv"
)
# the grouped expert FFN's bf16 Hopper kernels, which are no templates
_PTXAS_PLAIN_ENTRY = re.compile(r"Compiling entry function '\w*?(moe_ffn_(?:fwd|dw)_wgmma)E")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_report(paths, libraries) -> dict:
    """Registers, static shared memory and spill bytes of each Hopper kernel
    instantiation (``_PTXAS_ENTRY``) of ``libraries``, as ``ptxas -v``
    logged them."""
    report = {}
    for lib in libraries:
        name = None
        for line in paths[lib].with_suffix(".log").read_text().splitlines():
            if m := _PTXAS_ENTRY.search(line):
                name = f"{m.group(1)}<{m.group(2)}{',' + m.group(3) if m.group(3) else ''}>"
                report[name] = {}
            elif m := _PTXAS_PLAIN_ENTRY.search(line):
                name = m.group(1)
                report[name] = {}
            elif "Compiling entry function" in line:
                name = None  # a kernel the report does not cover: its lines are not ours
            elif name and (m := _PTXAS_SPILL.search(line)):
                report[name]["spill_store_bytes"] = int(m.group(1))
                report[name]["spill_load_bytes"] = int(m.group(2))
            elif name and (m := _PTXAS_USED.search(line)):
                report[name]["registers"] = int(m.group(1))
                smem = _PTXAS_SMEM.search(line)
                report[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return report


def attention_build_report(build, paths) -> dict:
    """Each attention kernel instantiation's registers, static shared
    memory and spill bytes as ``ptxas -v`` logged them (the flash forward's
    and backward's libraries and the short-sequence attention's), with the
    dynamic shared memory each bf16 flash kernel and each one-tile kernel
    asks for at each head dim."""
    report = ptxas_report(paths, ("flash_attention_fwd", "flash_attention_bwd", "attention_small"))
    smem = {
        kernel: build.load(lib, [ctypes.c_int], symbol=symbol)
        for kernel, lib, symbol in (
            ("flash_fwd_bf16", "flash_attention_fwd", "flash_attention_fwd_smem"),
            ("flash_bwd_dq_bf16", "flash_attention_bwd", "flash_attention_bwd_dq_smem"),
            ("flash_bwd_dkv_bf16", "flash_attention_bwd", "flash_attention_bwd_dkv_smem"),
        )
    }
    onetile = build.load("attention_small", [ctypes.c_int, ctypes.c_int],
                         symbol="attention_small_onetile_smem")
    dynamic = {k: {d: fn(d) for d in (64, 128)} for k, fn in smem.items()}
    for backward, kernel in enumerate(("attn_small_fwd_onetile", "attn_small_bwd_onetile")):
        dynamic[kernel] = {d: onetile(backward, d) for d in (64, 128)}
    return {"kernels": report, "bf16_dynamic_smem_bytes": dynamic}


# (depth k, output columns n) of the fused block's bf16 GEMM launches on the
# main paths: block_gemm's qkv, proj, up, down; block_gemm_dgrad's dy·W_dn,
# dup·W_up, dr1c·W_o, dqkv·W_qkv; block_gemm_wgrad's input widths
GEMM_PATH_SHAPES = {
    "block_gemm": ((192, 576), (192, 192), (192, 768), (768, 192)),
    "block_gemm_dgrad": ((192, 768), (768, 192), (192, 192), (576, 192)),
    "block_gemm_wgrad": (192, 768),
}


# items the fused block's bf16 attention kernels are reported at: the
# ragged case, the vit_tiny p2 paths and the window top
ATTENTION_BUILD_SEQS = (136, 256, 512)


def gemm_build_report(build, paths, vb) -> dict:
    """The fused block's bf16 Hopper kernels: the GEMMs
    (``block_gemm_wgmma``, ``dgrad_wgmma``, ``wgrad_wgmma``, one
    instantiation per tile width) and the attention's
    (``block_attn_wgmma``, ``attn_dq_wgmma``, ``attn_dkv_wgmma``, one per
    count of key tiles): registers, static shared memory and spills from
    ``ptxas -v``, and the dynamic shared memory each launch of the main
    paths asks for (the attention's at ``ATTENTION_BUILD_SEQS``)."""
    i32 = ctypes.c_int
    smem = {
        "block_gemm": build.load("vit_block_fwd", [i32, i32], symbol="vit_block_gemm_smem"),
        "block_gemm_dgrad": build.load("vit_block_bwd", [i32, i32], symbol="vit_block_dgrad_smem"),
    }
    dynamic = {
        name: {f"k{k}_n{n}_bn{vb.slab_width(k, n)}": fn(k, vb.slab_width(k, n))
               for k, n in GEMM_PATH_SHAPES[name]}
        for name, fn in smem.items()
    }
    wgrad = build.load("vit_block_bwd", [i32], symbol="vit_block_wgrad_smem")
    dynamic["block_gemm_wgrad"] = {
        f"n_in{n}_bn{vb.wgrad_width(n)}": wgrad(vb.wgrad_width(n))
        for n in GEMM_PATH_SHAPES["block_gemm_wgrad"]
    }
    attn = build.load("vit_block_fwd", [i32], symbol="vit_block_attention_smem")
    attn_bwd = build.load("vit_block_bwd", [i32, i32], symbol="vit_block_attention_bwd_smem")
    dynamic["block_attn_wgmma"] = {f"s{s}": attn(s) for s in ATTENTION_BUILD_SEQS}
    for kernel, name in enumerate(("attn_dq_wgmma", "attn_dkv_wgmma")):
        dynamic[name] = {f"s{s}": attn_bwd(kernel, s) for s in ATTENTION_BUILD_SEQS}
    return {"kernels": ptxas_report(paths, ("vit_block_fwd", "vit_block_bwd")),
            "dynamic_smem_bytes": dynamic}


def moe_build_report(build, paths) -> dict:
    """The grouped expert FFN's bf16 Hopper kernels (``moe_ffn_fwd_wgmma``,
    K7; ``moe_ffn_dw_wgmma``, K9): registers, static shared memory and
    spills from ``ptxas -v``, and the dynamic shared memory each launch
    asks for (fixed: it does not depend on the shape)."""
    smem = {kernel: build.load(lib, [], symbol=f"{kernel}_smem")()
            for kernel, lib in (("moe_ffn_fwd_wgmma", "moe_gmm_fwd"), ("moe_ffn_dw_wgmma", "moe_gmm_bwd"))}
    return {"kernels": ptxas_report(paths, ("moe_gmm_fwd", "moe_gmm_bwd")), "dynamic_smem_bytes": smem}


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
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
        row = {
            "case": label, "regime": regime, "dtype": dname, "layout": layout,
            "shape": [b, h, s, d], "causal": causal,
            "max_abs_err": err, "max_abs_err_lse": err_lse,
            "atol_share": atol_share, "rtol": rtol, "tol_lse": tol_lse,
            "atol_share_needed": share, "fault_atol_share_needed": fault_share,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": 4 * pairs * d / ms / 1e9, "bound_share": bound_ms / ms, "ok": ok,
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
    ("bf16 tile edges: S 1000, a multiple of neither 128 keys nor 64 queries",
     "bfloat16", 2, 4, 1000, 128, False, "bshd", False),
    ("bf16 causal S 257 at D 64, dlse", "bfloat16", 2, 2, 257, 64, True, "bshd", True),
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
# theirs; each must need more than the tolerance.  Each kernel owns its
# output rows and sums in a fixed order (no atomics), so a second call on
# the same inputs must give bit-identical gradients.


def backward_checks(attn) -> list[dict]:
    """K3 and K4 against ``flash_attention_bwd_reference`` at
    ``BACKWARD_CASES``: agreement, the planted faults, a bitwise replay, and
    times."""
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
        replay = (
            attn.flash_attention_dq(qt, kt, vt, dot, lse, adj, **kw),
            *attn.flash_attention_dkv(qt, kt, vt, dot, lse, adj, **kw),
        )
        torch.cuda.synchronize()
        bit_identical = {
            name: torch.equal(a, b) for name, a, b in zip(("dq", "dk", "dv"), (dq, dk, dv), replay)
        }
        del replay
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
        ok = all(bit_identical.values()) and all(
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
            "grads": grads, "bit_identical_across_calls": bit_identical, "ok": ok,
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


def timed_kernels(fn, iters: int = 20) -> tuple[float, float, list[str]]:
    """(device-busy ms per call under torch.profiler, CUDA-event ms per call
    of back-to-back calls, the port's kernels by symbol that the profiled
    calls ran), warmed up.  The first is the kernels' own time; the second
    adds the gaps the host's launch overhead leaves on the card between
    calls, which dominate calls of sub-0.1 ms kernels."""
    event_ms = cuda_ms(fn, iters)
    prof = profile_device(fn, iters)
    return prof["device_busy_ms"], event_ms, sorted(_port_kernel_ms(prof["device_ms_by_name"]))


def timed(fn, iters: int = 20) -> tuple[float, float]:
    """``timed_kernels``' two times."""
    return timed_kernels(fn, iters)[:2]


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
            gemm[name]["ms"], gemm[name]["event_ms"], gemm[name]["kernels"] = timed_kernels(
                lambda: vb.block_gemm(**st))
            gemm[name]["plain_ms"], _ = timed(lambda: vb.block_gemm_reference(**st))
        attn_got = vb.block_attention(qkv, seq=s, heads=heads)
        torch.cuda.synchronize()
        attention = _agreement(
            attn_got, o, attention_without_first_tile(qkv, seq=s, heads=heads), rtol
        )
        attention["ms"], attention["event_ms"], attention["kernels"] = timed_kernels(
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
        # by symbol: the launches ran the dtype's GEMM kernel and attention
        # kernel and no other
        gemm_kernels = sorted({k for g in gemm.values() for k in g["kernels"]})
        want_gemm = path_symbols("block_gemm", dname)
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
            "gemm_kernels": gemm_kernels,
            "ok": gemm_kernels == want_gemm
            and attention["kernels"] == path_symbols("block_attention", dname) and all(
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


K6_KERNELS = {  # the CUDA kernels' own symbols, by wrapper: the Hopper (bf16) ones end in _wgmma
    "block_ln": ("ln_rows",),
    "block_gemm": ("block_gemm_wgmma", "vit_block_gemm_f32"),
    "block_attention": ("block_attn_wgmma", "vit_block_attn_f32"),
    "block_gemm_dgrad": ("dgrad_wgmma", "dgrad_f32"),
    "block_ln_bwd": ("ln_bwd",),
    "block_attention_bwd": ("attn_dq_wgmma", "attn_dkv_wgmma", "attn_dq_f32", "attn_dkv_f32"),
    "block_gemm_wgrad": ("wgrad_wgmma", "wgrad_f32"),
    "block_grad_reduce": ("grad_reduce",),
}
GEMM_WRAPPERS = ("block_gemm", "block_gemm_dgrad", "block_gemm_wgrad")
ATTENTION_WRAPPERS = ("block_attention", "block_attention_bwd")
# every GEMM and attention kernel of the fused block chains
GEMM_SYMBOLS = frozenset(s for w in GEMM_WRAPPERS for s in K6_KERNELS[w])
ATTENTION_SYMBOLS = frozenset(s for w in ATTENTION_WRAPPERS for s in K6_KERNELS[w])


def path_symbols(wrapper: str, dname: str) -> list[str]:
    """The kernels, by symbol, that a GEMM or attention ``wrapper`` of the
    fused block launches in ``dname``: its Hopper (``_wgmma``) kernels in
    bf16, its SIMT ones in fp32."""
    return sorted(s for s in K6_KERNELS[wrapper] if s.endswith("_wgmma") == (dname == "bfloat16"))
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
        ran = _port_kernel_ms(prof["device_ms_by_name"])
        kernels = {name: sorted(s for s in syms if s in ran) for name, syms in K6_KERNELS.items()}
        # by symbol: the chain's GEMMs and attention (its recompute and its
        # backward) ran the dtype's kernels and no other
        gemm_ok = all(kernels[w] == path_symbols(w, dname) for w in (*GEMM_WRAPPERS, *ATTENTION_WRAPPERS))
        event_ms = cuda_ms(run, 10)
        plain_ms, _ = timed(lambda: vb.fused_vit_block_bwd_reference(x, dy, params, heads=heads), 5)
        library_ms, library_event_ms = timed(composed_library_block_fwd_bwd(x, params, heads, dy), 10)
        bounds = block_bwd_bounds(vb, b, s, dim, heads, 4 * dim, dname)
        ok = (
            finite and identical and gemm_ok
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
            "kernel_ms": per_kernel, "kernels": kernels, "plain_ms": plain_ms,
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
    none for a short run, at times several in a row) is taken again after a
    pause, twice as long each time, at most five times in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(5):
        time.sleep(0.5 * attempt)
        reps_run = reps << attempt
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps_run):
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
        raise RuntimeError("the profiler saw no device activity in five traces")
    reps = reps_run
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


def bucket_dispatch(engine, hp, buckets=(1, 2, 4), reps: int = 20) -> dict:
    """One request batch of each bucket's size through ``engine`` as the
    serve path dispatches it (uint8 upload, forward, logits download; the
    host arrays returned stop the clock after the card has finished): ms a
    dispatch by the host clock over ``reps`` after one warm-up, and device
    busy ms and idle share under the profiler.  It reads only the serving
    API, so it times any checkout of the package put first on ``sys.path``
    as well (PERF.md gives the command)."""
    from distributed_training_comparison_tpu_torch.serve import request_pool

    out = {}
    for n in buckets:
        images = request_pool(n, image_size=hp.image_size, seed=hp.seed, fold=("check", n))
        engine.predict_logits(images)
        t0 = time.perf_counter()
        for _ in range(reps):
            engine.predict_logits(images)
        host_ms = (time.perf_counter() - t0) / reps * 1e3
        prof = profile_device(lambda: engine.predict_logits(images), 5)
        out[str(n)] = {"host_ms": host_ms, "device_busy_ms": prof["device_busy_ms"],
                       "device_idle_share": prof["device_idle_share"]}
    return out


@contextlib.contextmanager
def dropped_v_tile(attn):
    """Every flash-attention forward with the first ``FAULT_KEYS`` keys'
    values zeroed (``dropped_rows`` on v: one V tile left out of P·V, the
    softmax statistics right), in every call while the context lasts."""
    real = attn.flash_attention

    def without_first_tile(q, k, v, **kw):
        v = v.clone()  # keeps v's strides
        v[:, :, :FAULT_KEYS].zero_()
        return real(q, k, v, **kw)

    # the kernel counts into the name it runs under, now ``without_first_tile``:
    # these launches stay off the path's counter
    without_first_tile.launches = 0
    attn.flash_attention = without_first_tile
    try:
        yield
    finally:
        attn.flash_attention = real


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
    # The two paths round P to bf16 at different points (unnormalized vs
    # normalized), each of the 8 blocks adds that difference to a bf16
    # residual stream (2^-8 relative), so logits agree to a few bf16 ulps
    # of their own scale.  Bound: SERVE_LOGITS_TOL of the largest logit,
    # set from the readings, which a planted fault (``dropped_v_tile``)
    # must exceed.
    hp = load_config(SERVE_ARGV)
    images = request_pool(8, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    kernel_engine = build_engine(hp)
    reference_engine = build_engine(hp, attn_impl="reference")
    logits = kernel_engine.predict_logits(images)
    ref = reference_engine.predict_logits(images)
    with dropped_v_tile(attn):
        fault_logits = kernel_engine.predict_logits(images)
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
    smaller = bucket_dispatch(kernel_engine, hp)
    err = float(np.abs(logits - ref).max())
    scale = float(np.abs(ref).max())
    tol = SERVE_LOGITS_TOL * scale
    fault_err = float(np.abs(fault_logits - ref).max())

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
        "fault_logits_max_abs_err": fault_err,
        "bucket8_batch_ms": forward_ms["kernel"],
        "bucket8_batch_ms_reference_attention": forward_ms["reference"],
        "bucket8_profile": profiled,
        "dispatch_by_bucket": smaller,
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


def dispatch_times(fused, off, images) -> dict:
    """One bucket-32 dispatch end to end (uint8 upload, forward, logits
    download) through the ``fused`` engine and the ``off`` one
    (``--block-fusion off``) in turns, the median host-clock ms of 20
    dispatches each (the host's clock varies from dispatch to dispatch
    more than the device's time does), and a profile of the fused one:
    device busy ms, idle share, K5's kernels' device ms, the port's kernels
    that ran and which of them are GEMMs and attention."""
    rec = {}
    for name, eng in (("fused", fused), ("off", off), ("fused_again", fused), ("off_again", off)):
        eng.predict_logits(images)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            eng.predict_logits(images)
            times.append((time.perf_counter() - t0) * 1e3)
        rec[f"bucket32_batch_ms_{name}"] = sorted(times)[len(times) // 2]
    prof = profile_device(lambda: fused.predict_logits(images), 5)
    names = prof["device_ms_by_name"]
    port = _port_kernel_ms(names)
    # the port's kernels on this path are K5's; matched by the namespace, so
    # that a parent's symbols count too
    k5 = sum(ms for name, ms in names.items() if _KERNEL_SYMBOL.match(name))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    rec["bucket32_profile"] = {
        "wall_ms_per_batch": prof["wall_ms"],
        "device_busy_ms_per_batch": prof["device_busy_ms"],
        "device_idle_share": prof["device_idle_share"],
        "k5_device_ms_per_batch": k5,
        "k5_share_of_device_busy": k5 / prof["device_busy_ms"],
        "port_kernels": sorted(port),
        "gemm_kernels": sorted(GEMM_SYMBOLS & set(port)),
        "attention_kernels": sorted(ATTENTION_SYMBOLS & set(port)),
        "top_device_ms_per_batch": {name[:60]: ms for name, ms in top},
    }
    return rec


def tiny_dispatch() -> dict:
    """``dispatch_times`` of ``serve_tiny``'s engine (bf16) on one seeded
    batch of 32, built from whichever checkout of the port is first on
    ``sys.path``: run with a parent's unpacked checkout put there, it times
    the parent's kernels in the same call."""
    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    hp = load_config(SERVE_TINY_ARGV)
    images = request_pool(32, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    off = build_engine(load_config(SERVE_TINY_ARGV + ["--block-fusion", "off"]))
    return dispatch_times(build_engine(hp), off, images)


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
            off = build_engine(load_config(argv + ["--block-fusion", "off"]))
            rec.update(dispatch_times(fused, off, images))
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
            loss, _, _ = forward_backward(
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


def step_runs(variants, state: dict, counters, images, labels, compute_dtype) -> dict:
    """One forward and backward of each variant ``(name, build, swap)``:
    ``build()`` a model, load ``state``, run it on the card, under ``swap()``
    where given; its loss, every parameter gradient, the launches of each
    of ``counters`` and its depth, by name."""
    import torch

    from distributed_training_comparison_tpu_torch.train import forward_backward

    runs = {}
    for name, build, swap in variants:
        model = build()
        model.load_state_dict(state)
        model = model.cuda()
        before = [c.launches for c in counters]
        with swap() if swap else contextlib.nullcontext():
            loss, _, _ = forward_backward(model, images, labels, compute_dtype=compute_dtype)
            torch.cuda.synchronize()
        runs[name] = {
            "loss": loss.item(),
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "launches": [c.launches - n for c, n in zip(counters, before)],
            "depth": len(model.blocks),
        }
        del model, loss
        torch.cuda.empty_cache()
    return runs


def step_report(precision: str, batch: int, runs: dict, loss_tol, ref_tol, plain_tol) -> dict:
    """The step check of ``runs`` (``step_runs`` of kernel, reference,
    plain and fault): the kernel's loss against the reference's, its
    gradients against the reference's and the plain path's within their
    bounds, the fault beyond both, and each kernel counter launched once a
    block by the kernel run only."""
    import torch

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
        "precision": precision, "batch": batch,
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


def _first_batch(hp):
    """The first ``hp.batch_size`` training images and labels, on the card."""
    import torch

    from distributed_training_comparison_tpu_torch.data import get_datasets

    images, labels = get_datasets(hp)[0]
    return (torch.from_numpy(images[:hp.batch_size]).cuda(),
            torch.from_numpy(labels[:hp.batch_size]).long().cuda())


def tiny_step_check(vb, attn, precision: str) -> dict:
    import torch

    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.train import build_model
    from distributed_training_comparison_tpu_torch.train.step import COMPUTE_DTYPES

    edit, loss_tol, ref_tol, plain_tol = TINY_STEP_CHECKS[precision]
    hp = load_config(edit(TRAIN_TINY_ARGV))
    hp_off = load_config(edit(TRAIN_TINY_ARGV) + ["--block-fusion", "off"])
    torch.manual_seed(hp.seed)
    state = build_model(hp).state_dict()
    runs = step_runs(
        [("kernel", lambda: build_model(hp), None),
         ("reference", lambda: build_model(hp_off), None),
         ("plain", lambda: build_model(hp), lambda: plain_block_chains(vb, fault=False)),
         ("fault", lambda: build_model(hp), lambda: plain_block_chains(vb, fault=True))],
        state, (vb.fused_vit_block, vb.fused_vit_block_bwd), *_first_batch(hp),
        COMPUTE_DTYPES[hp.precision],
    )
    return step_report(precision, hp.batch_size, runs, loss_tol, ref_tol, plain_tol)


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
    port = _port_kernel_ms(names)
    out["profile"] = {
        "port_kernels": sorted(port),
        "gemm_kernels": sorted(GEMM_SYMBOLS & set(port)),
        "attention_kernels": sorted(ATTENTION_SYMBOLS & set(port)),
        "attention_kernels_device_ms_per_step": kernel_ms(names, ATTENTION_WRAPPERS),
        "gemm_kernels_device_ms_per_step": kernel_ms(names, GEMM_WRAPPERS),
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
    prof = tiny["step_times"]["profile"]
    want = {k: sorted(s for w in ws for s in path_symbols(w, "bfloat16"))
            for k, ws in (("gemm_kernels", GEMM_WRAPPERS), ("attention_kernels", ATTENTION_WRAPPERS))}
    for key, syms in want.items():
        if prof[key] != syms:
            raise RuntimeError(f"train_tiny's step ran the {key} {prof[key]}, expected {syms}")
    bad = {p: c for p, c in tiny["step_checks"].items() if not c["ok"]}
    if bad:
        raise RuntimeError(f"a vit_tiny p2 train step through K5/K6 disagrees: {bad}")


# ------------------------------------------------- vit_moe: K7, K8, K9

MOE_DIMS = (8, 192, 768)  # vit_moe: experts, dim, hidden
# expert shares of a skewed routing, so that the first experts overflow
MOE_SKEW = (0.2, 0.16, 0.14, 0.12, 0.1, 0.1, 0.09, 0.09)
# (label, dtype, n, cap, group counts or None for a skewed draw of n tokens)
MOE_GMM_CASES = [
    ("slice: vit_moe serve, bucket 32", "bfloat16", 2048, 320, None),
    ("slice: vit_moe train, batch 256", "bfloat16", 16384, 2560, None),
    ("fp32 train shape (--moe-dispatch gmm without --amp)", "float32", 16384, 2560, None),
    ("ragged: an empty group, two over capacity, the last ending at n", "bfloat16", 1000, 160,
     (150, 0, 200, 90, 110, 120, 130, 200)),
]
# Each output (K7's y, K8's dx) holds against its plain version on the kept
# rows per row, with the flash kernels' TOLERANCES and for the same
# reasons: the kernel and the plain version round at the same points (each
# product, each bias add, the gelu and its derivative), so they differ by
# fp32 summation order and tanh (~1e-6 relative), by the rare one-ulp bf16
# flip that causes in h1, g or dh, which the next product carries as 2^-8
# of one term among 192 or 768, and by the output's own rounding (held by
# rtol).  The rows no expert keeps must be exactly 0.  K9's four gradients
# hold in relative L2 against their leaf, bf16 2^-7 (the K6 bound: fp32
# sums of the same rounded dh and g in another order), fp32 2^-14.  Two
# planted faults must exceed those bounds: one expert's start shifted by one
# row (on all three) and K9 with the first 64-row tile of the first kept
# group left out of its walk.
GMM_GRAD_TOL = {"bfloat16": 2**-7, "float32": 2**-14}
# the kernels K7, K8 and K9 launch, by symbol: in bf16 the Hopper kernels of
# K7 and K9 and the first port's K8; in fp32 the first port's three
MOE_SYMBOLS = {
    "bfloat16": {"fwd": "moe_ffn_fwd_wgmma", "dx": "moe_gmm_dx_kernel", "dw": "moe_ffn_dw_wgmma"},
    "float32": {"fwd": "moe_gmm_fwd_kernel", "dx": "moe_gmm_dx_kernel", "dw": "moe_gmm_dw_kernel"},
}


def _moe_kernel_ms(device_ms_by_name: dict, csrc: Path | None = None) -> dict[str, float]:
    """Device ms of the grouped expert FFN's kernels (those
    ``moe_gmm_*.cu`` defines) by symbol."""
    return _port_kernel_ms(device_ms_by_name, "moe_gmm_*.cu", csrc)


def check_moe_kernels(where: str, kernels: dict, keys) -> None:
    """``kernels`` (symbol -> device ms) must be the bf16 kernels of
    ``keys`` ("fwd", "dx", "dw") alone, each with device time: a launched
    kernel whose symbol the profile does not show would read 0 ms."""
    want = {MOE_SYMBOLS["bfloat16"][k] for k in keys}
    if set(kernels) != want or not all(kernels[k] > 0 for k in want):
        raise RuntimeError(f"{where} ran the expert FFN kernels {kernels}, expected {sorted(want)} with device time")


def moe_gmm_bounds(n, d, h, ne, kept, dname) -> dict[str, tuple[float, str]]:
    """Least times of K7, K8 and K9 on the card, counting the kept rows'
    products only: K7 4·K·d·h operations against xs and y (n rows each) and
    the weights; K8 6·K·d·h against xs, dy, dx and the weights; K9 8·K·d·h
    against xs, dy, the weights read and the fp32 gradients written."""
    item = 2 if dname == "bfloat16" else 4
    weights = ne * (2 * d * h + h + d)
    return {
        "fwd": bound(4 * kept * d * h, (2 * n * d + weights) * item, dname),
        "dx": bound(6 * kept * d * h, (3 * n * d + weights) * item, dname),
        "dw": bound(8 * kept * d * h, (2 * n * d + weights) * item + weights * 4, dname),
    }


def composed_library_ffn(gm, xs, w1, b1, w2, b2, starts, cap, dy):
    """The library yardstick (timed here, never called on the gmm path):
    the gather dispatch's composed form on the same routing, two
    ``torch.bmm`` over the (E, cap, d) capacity buffer with bias and gelu,
    and its autograd backward.  Returns ``(forward, backward)`` callables."""
    import torch
    import torch.nn.functional as F

    ne, d, _ = w1.shape
    buf, dbuf = (xs.new_zeros((ne, cap, d)) for _ in range(2))
    for e, (lo, hi) in enumerate(gm.kept_ranges(starts, cap, xs.shape[0])):
        buf[e, :hi - lo], dbuf[e, :hi - lo] = xs[lo:hi], dy[lo:hi]

    def forward(a=buf, u=w1, bu=b1, v=w2, bv=b2):
        return torch.bmm(F.gelu(torch.bmm(a, u) + bu[:, None], approximate="tanh"), v) + bv[:, None]

    leaves = [t.detach().requires_grad_() for t in (buf, w1, b1, w2, b2)]
    out = forward(*leaves)
    return forward, lambda: torch.autograd.grad(out, leaves, dbuf, retain_graph=True)


def _first_kept(gm, starts, cap, n) -> tuple[int, int]:
    return next((lo, hi) for lo, hi in gm.kept_ranges(starts, cap, n) if hi > lo)


def moe_case_inputs(dname: str, n: int, counts=None):
    """A case of ``MOE_GMM_CASES`` on the card, from seed 5: ``(counts,
    starts, xs, dy, w1, b1, w2, b2)``, the group counts drawn with
    ``MOE_SKEW`` where the case gives none, the experts' weights at their
    xavier init."""
    import torch

    ne, d, h = MOE_DIMS
    dtype = getattr(torch, dname)
    gen = torch.Generator().manual_seed(5)
    if counts is None:
        draw = torch.multinomial(torch.tensor(MOE_SKEW), n, replacement=True, generator=gen)
        counts = torch.bincount(draw, minlength=ne).tolist()
    starts = torch.tensor([0, *torch.tensor(counts).cumsum(0).tolist()], dtype=torch.int32).cuda()
    limit = math.sqrt(6.0 / (d + h))  # the experts' xavier init
    w1, w2 = ((torch.rand(s, generator=gen) * 2 - 1) * limit for s in ((ne, d, h), (ne, h, d)))
    b1, b2 = (0.1 * torch.randn(s, generator=gen) for s in ((ne, h), (ne, d)))
    xs, dy = (torch.randn(n, d, generator=gen) for _ in range(2))
    xs, dy, w1, b1, w2, b2 = (t.to(device="cuda", dtype=dtype) for t in (xs, dy, w1, b1, w2, b2))
    return counts, starts, xs, dy, w1, b1, w2, b2


def moe_gmm_checks(gm) -> list[dict]:
    """K7, K8 and K9 (``ops/moe_gmm.py``) against their plain versions on
    the card at ``MOE_GMM_CASES``: agreement, exact zeros, bitwise replay,
    the two planted faults, the kernels each wrapper ran by symbol (the
    dtype's ``MOE_SYMBOLS`` alone), device ms of each kernel, its plain
    version and the composed cuBLAS yardstick (and CUDA-event ms), beside
    its bound."""
    import torch

    out = []
    ne, d, h = MOE_DIMS
    for label, dname, n, cap, counts in MOE_GMM_CASES:
        atol_share, rtol, _ = TOLERANCES[dname]
        counts, starts, xs, dy, w1, b1, w2, b2 = moe_case_inputs(dname, n, counts)
        kept = gm.kept_mask(starts, cap, n)
        k_rows = int(kept.sum())

        y = gm.grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, cap)
        dx = gm.grouped_ffn_dx(xs, dy, w1, b1, w2, starts, cap)
        dw = gm.grouped_ffn_dw(xs, dy, w1, b1, w2, starts, cap)
        torch.cuda.synchronize()
        replay = (gm.grouped_ffn_dx(xs, dy, w1, b1, w2, starts, cap),
                  *gm.grouped_ffn_dw(xs, dy, w1, b1, w2, starts, cap))
        bitwise = all(torch.equal(a, b) for a, b in zip((dx, *dw), replay))
        want_y = gm.grouped_ffn_reference(xs, w1, b1, w2, b2, starts, cap)
        want_dx = gm.grouped_ffn_dx_reference(xs, dy, w1, b1, w2, starts, cap)
        want_dw = gm.grouped_ffn_dw_reference(xs, dy, w1, b1, w2, starts, cap)
        # fault 1: the first non-empty expert past expert 0 starts a row late
        shifted = starts.clone()
        e_shift = next(e for e in range(1, ne) if counts[e] > 0)
        shifted[e_shift] += 1
        # fault 2: K9's walk misses the first row tile of the first kept group
        lo, _ = _first_kept(gm, starts, cap, n)
        dy_tile = dy.clone()
        dy_tile[lo:lo + 64] = 0

        def leaf_errors(got):
            return [float((g - w).norm() / w.norm().clamp_min(1e-30)) for g, w in zip(got, want_dw)]

        rec = {
            "case": label, "dtype": dname, "n": n, "cap": cap, "experts": ne, "dim": d,
            "hidden": h, "counts": counts, "kept_rows": k_rows,
            "atol_share": atol_share, "rtol": rtol, "grad_tol": GMM_GRAD_TOL[dname],
            "fwd": _agreement(y[kept], want_y[kept],
                              gm.grouped_ffn_reference(xs, w1, b1, w2, b2, shifted, cap)[kept], rtol),
            "dx": _agreement(dx[kept], want_dx[kept],
                             gm.grouped_ffn_dx_reference(xs, dy, w1, b1, w2, shifted, cap)[kept], rtol),
            "dropped_rows_exact_zero": bool((y[~kept] == 0).all() and (dx[~kept] == 0).all()),
            "dw_errors": leaf_errors(dw),
            "dw_max_abs_err": max(float((g - w).abs().max()) for g, w in zip(dw, want_dw)),
            "dw_fault_shifted_start": leaf_errors(
                gm.grouped_ffn_dw_reference(xs, dy, w1, b1, w2, shifted, cap)),
            "dw_fault_row_tile": leaf_errors(
                gm.grouped_ffn_dw_reference(xs, dy_tile, w1, b1, w2, starts, cap)),
            "bit_identical_across_calls": bitwise,
        }
        lib_fwd, lib_bwd = composed_library_ffn(gm, xs, w1, b1, w2, b2, starts, cap, dy)
        big = n >= 16384
        # device-busy ms under the profiler (the kernels' own time; CUDA
        # events over back-to-back calls would time the host's call overhead
        # where the kernel is faster), the event ms beside them, and the
        # kernels each call ran by symbol
        calls = {
            "fwd": lambda: gm.grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, cap),
            "dx": lambda: gm.grouped_ffn_dx(xs, dy, w1, b1, w2, starts, cap),
            "dw": lambda: gm.grouped_ffn_dw(xs, dy, w1, b1, w2, starts, cap),
        }
        rec["ms"], rec["event_ms"], rec["kernels"] = {}, {}, {}
        for k, fn in calls.items():
            rec["ms"][k], rec["event_ms"][k], rec["kernels"][k] = timed_kernels(fn, 20)
        rec["plain_ms"] = {
            "fwd": timed(lambda: gm.grouped_ffn_reference(xs, w1, b1, w2, b2, starts, cap), 3 if big else 10)[0],
            "dx": timed(lambda: gm.grouped_ffn_dx_reference(xs, dy, w1, b1, w2, starts, cap), 3 if big else 10)[0],
            "dw": timed(lambda: gm.grouped_ffn_dw_reference(xs, dy, w1, b1, w2, starts, cap), 3 if big else 10)[0],
        }
        rec["library_ms"], rec["library_event_ms"] = {}, {}
        for k, fn in (("fwd", lib_fwd), ("bwd", lib_bwd)):
            rec["library_ms"][k], rec["library_event_ms"][k] = timed(fn, 20)
        rec["library"] = ("gather dispatch's composed form on the same routing: "
                          "2 x torch.bmm over (E, cap, d) with bias and tanh gelu; bwd its autograd")
        bounds = moe_gmm_bounds(n, d, h, ne, k_rows, dname)
        rec["bound_ms"] = {k: v[0] for k, v in bounds.items()}
        rec["bound_by"] = {k: v[1] for k, v in bounds.items()}
        tol = GMM_GRAD_TOL[dname]
        rec["ok"] = (
            all(rec["kernels"][k] == [MOE_SYMBOLS[dname][k]] for k in calls)
            and all(r["finite"] and r["atol_share_needed"] <= atol_share < r["fault_atol_share_needed"]
                    for r in (rec["fwd"], rec["dx"]))
            and rec["dropped_rows_exact_zero"] and bitwise
            and max(rec["dw_errors"]) <= tol < max(rec["dw_fault_shifted_start"])
            and tol < max(rec["dw_fault_row_tile"])
            and all(bool(torch.isfinite(g).all()) for g in dw)
        )
        out.append(rec)
        del xs, dy, w1, b1, w2, b2, y, dx, dw, replay, want_y, want_dx, want_dw, dy_tile
        del lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    return out


SERVE_MOE_ARGV = [
    "--serve", "--model", "vit_moe", "--amp",
    "--serve-buckets", "1,2,4,8,16,32", "--serve-shape", "closed",
    "--serve-requests", "256", "--serve-concurrency", "32", "--seed", "0",
]
MOE_COUNTERS = ("grouped_ffn_fwd", "grouped_ffn_dx", "grouped_ffn_dw")


def _moe_path_counters(gm, vb, attn) -> dict:
    """Every kernel counter of the port: the MoE kernels' and the ones the
    vit_moe paths must not launch."""
    return {**{n: getattr(gm, n) for n in MOE_COUNTERS}, **_tiny_counters(vb, attn)}


def moe_layer_profile(engine, images) -> dict:
    """Device time of block 0's MoE layer alone on its input for the
    bucket-32 ``images``, split into K7 and the rest (routing: the fp32 router,
    softmax, argmax, one-hot and cumsums; permutation: the row scatter and
    gather and the gate multiply) or, under gather, the cuBLAS GEMMs and
    the rest."""
    import torch

    moe = engine.model.blocks[0].moe
    seen = []
    handle = moe.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    try:
        engine.predict_logits(images)
    finally:
        handle.remove()
    h = seen[-1]
    with torch.inference_mode():
        prof = profile_device(lambda: moe(h), 20)
    names = prof["device_ms_by_name"]
    moe = _moe_kernel_ms(names)
    k7 = moe.get(MOE_SYMBOLS["bfloat16"]["fwd"], 0.0)
    gemm = sum(ms for n, ms in names.items()
               if any(t in n.lower() for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")))
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    return {
        "device_busy_ms": prof["device_busy_ms"],
        "moe_kernels": moe, "k7_ms": k7, "cublas_gemm_ms": gemm,
        "routing_and_permutation_ms": prof["device_busy_ms"] - k7 - gemm,
        "top_device_ms": {n[:60]: ms for n, ms in top},
    }


@contextlib.contextmanager
def shifted_k7(gm):
    """K7 launched with the first non-empty expert past expert 0 starting a
    row late (the moe_gmm_checks fault), in every call while the context
    lasts; these launches are not the path's."""
    real = gm.grouped_ffn_fwd

    def shifted(xs, w1, b1, w2, b2, starts, cap):
        st = starts.tolist()
        e = next(e for e in range(1, len(st) - 1) if st[e + 1] > st[e])
        starts = starts.clone()
        starts[e] += 1
        return real(xs, w1, b1, w2, b2, starts, cap)

    # the wrapper counts into the module name it runs under, which is now
    # ``shifted``: these launches stay off the path's counter
    shifted.launches = 0
    gm.grouped_ffn_fwd = shifted
    try:
        yield
    finally:
        gm.grouped_ffn_fwd = real


def serve_moe_phase(gm, vb, attn) -> dict:
    """``vit_moe`` served through ``entry.run``: every block of every
    dispatched batch through K7 and no flash, K5 or K6 kernel; the bucket-32
    logits against the same weights under ``--moe-dispatch gather``; one
    bucket-32 dispatch timed under gmm and gather, profiled, and the MoE
    layer's device time split."""
    import numpy as np

    from distributed_training_comparison_tpu_torch import entry
    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    counters = _moe_path_counters(gm, vb, attn)
    for c in counters.values():
        c.launches = 0
    report = entry.run(SERVE_MOE_ARGV)
    launches = {name: c.launches for name, c in counters.items()}

    # the same seeded weights under gmm (auto, bf16) and under gather, one
    # padded batch of 32: the first block routes the same tokens by
    # construction, and K7 and the gather's cuBLAS GEMMs accumulate each
    # product in fp32 and round at the same points, so later blocks see the
    # same inputs unless a summation order flips a bf16 rounding that sends
    # a near-tie token to another expert.  At this seed none does: the
    # bound, 2^-10 of the largest logit, is set from that reading.  The
    # planted fault (every K7 launch with one expert's start a row late:
    # one token a block takes the wrong expert or none) must exceed it.
    hp = load_config(SERVE_MOE_ARGV)
    images = request_pool(32, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    engines = {"gmm": build_engine(hp),
               "gather": build_engine(load_config(SERVE_MOE_ARGV + ["--moe-dispatch", "gather"]))}
    rec = {}
    for name, eng in engines.items():
        before = gm.grouped_ffn_fwd.launches
        rec[f"logits_{name}"] = eng.predict_logits(images)
        rec[f"k7_launches_{name}"] = gm.grouped_ffn_fwd.launches - before
    with shifted_k7(gm):
        fault = engines["gmm"].predict_logits(images)
    got, want = rec.pop("logits_gmm"), rec.pop("logits_gather")
    scale = float(np.abs(want).max())
    rec.update({
        "logits_finite": bool(np.isfinite(got).all() and np.isfinite(want).all()),
        "logits_max_abs_err_vs_gather": float(np.abs(got - want).max()),
        "logits_scale": scale, "logits_tol": 2**-10 * scale,
        "fault_logits_max_abs_err_vs_gather": float(np.abs(fault - want).max()),
    })
    for rnd in ("", "_again"):
        for name, eng in engines.items():
            eng.predict_logits(images)
            t0 = time.perf_counter()
            for _ in range(5):
                eng.predict_logits(images)
            rec[f"bucket32_batch_ms_{name}{rnd}"] = (time.perf_counter() - t0) / 5 * 1e3
    rec["bucket32_profile_gmm"] = moe_dispatch_profile(engines["gmm"], images)
    rec["moe_layer_profile"] = {name: moe_layer_profile(eng, images) for name, eng in engines.items()}
    depth = len(engines["gmm"].model.blocks)
    del engines
    return {
        "phase": "serve_moe",
        "argv": SERVE_MOE_ARGV,
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
        "bucket32": rec,
    }


def moe_dispatch_profile(engine, images, csrc: Path | None = None) -> dict:
    """One bucket-32 dispatch of ``engine`` under the profiler: busy ms,
    idle share, the expert FFN kernels' device ms by symbol and K7's share."""
    prof = profile_device(lambda: engine.predict_logits(images), 5)
    moe = _moe_kernel_ms(prof["device_ms_by_name"], csrc)
    k7 = sum(moe.values())  # the serve path launches K7 alone
    top = sorted(prof["device_ms_by_name"].items(), key=lambda kv: -kv[1])[:8]
    return {
        "wall_ms_per_batch": prof["wall_ms"],
        "device_busy_ms_per_batch": prof["device_busy_ms"],
        "device_idle_share": prof["device_idle_share"],
        "moe_kernels": moe,
        "k7_device_ms_per_batch": k7,
        "k7_share_of_device_busy": k7 / prof["device_busy_ms"],
        "top_device_ms_per_batch": {n[:60]: ms for n, ms in top},
    }


def check_serve_moe(serve: dict) -> None:
    if serve["completed"] != serve["offered"] or serve["failed"]:
        raise RuntimeError(f"serve_moe lost requests: {serve}")
    want = {n: 0 for n in serve["launches"]}
    want["grouped_ffn_fwd"] = serve["depth"] * serve["engine_batches"]
    if serve["launches"] != want:
        raise RuntimeError(f"serve_moe launches {serve['launches']}, expected {want}")
    rec = serve["bucket32"]
    if (rec["k7_launches_gmm"], rec["k7_launches_gather"]) != (serve["depth"], 0):
        raise RuntimeError(f"serve_moe bucket-32 batch: launches {rec}")
    if not rec["logits_finite"] or rec["logits_max_abs_err_vs_gather"] > rec["logits_tol"]:
        raise RuntimeError(f"serve_moe: gmm logits disagree with gather: {rec}")
    if not rec["fault_logits_max_abs_err_vs_gather"] > rec["logits_tol"]:
        raise RuntimeError(f"serve_moe: the planted K7 fault passes the logits bound: {rec}")
    check_moe_kernels("serve_moe's bucket-32 dispatch", rec["bucket32_profile_gmm"]["moe_kernels"], ("fwd",))
    layer = rec["moe_layer_profile"]
    check_moe_kernels("serve_moe's MoE layer under gmm", layer["gmm"]["moe_kernels"], ("fwd",))
    check_moe_kernels("serve_moe's MoE layer under gather", layer["gather"]["moe_kernels"], ())


TRAIN_MOE_ARGV = [
    "--model", "vit_moe", "--amp", "--synthetic-data", "--batch-size", "256",
    "--limit-examples", "2560", "--epoch", "2", "--lr-decay-step-size", "1",
]
# One train step of vit_moe through K7-K9 (K, --moe-dispatch gmm) against
# the same seeded weights and batch through --moe-dispatch gather (R: cuBLAS
# batched GEMMs under autograd) and against P: the same autograd Function
# with the kernels' plain versions.  precision -> (argv edit, loss bound
# relative, bound on K vs R, bound on K vs P), gradient bounds as relative
# L2 per parameter.  The three round at the same points and differ by
# summation order; in bf16 that flips a rounded element by one ulp here and
# there, and a router downstream of a flip may send a near-tie token to
# another expert, which moves that token's share of two experts' gradients
# (P's products are fp32 SGEMMs, so it flips where K and R do not).  So
# bf16 holds both to 2^-4 of each whole parameter, and its loss, which only
# sees the forward, to 2^-6.  fp32 differs by summation order only (a flip
# needs a router input within ~1e-7 of a tie, and at this seed none is):
# 2^-13 on the loss and the gradients, the vit_tiny step's fp32 bound.
# The planted fault (P with every block's K9 walk missing the first 64-row
# tile of every expert's group: 512 of 16384 rows) must exceed both
# gradient bounds; in fp32 so must the TF32 control (P with the kernels'
# operands rounded to TF32, as a gmm path that lost fp32 would compute).
# Batch 256, the train command's.  precision -> (argv edit, loss bound,
# K vs R bound, K vs P bound, run the TF32 control).
MOE_STEP_CHECKS = {
    "bf16": (lambda argv: argv, 2**-6, 2**-4, 2**-4, False),
    "fp32": (lambda argv: [a for a in argv if a != "--amp"], 2**-13, 2**-13, 2**-13, True),
}


def tf32(t):
    """``t`` (fp32) rounded to TF32's 10-bit mantissa, to nearest even."""
    import torch

    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(t.dtype)


def plain_moe_kernels(gm, fault: bool, operands=None):
    """Context that swaps K7, K8 and K9 for their plain versions (the
    autograd Function stays).  ``fault`` leaves the first 64-row tile of
    every expert's kept rows out of every K9 walk; ``operands`` (e.g.
    :func:`tf32`) is applied to xs, dy, w1 and w2 before each plain call."""
    saved = tuple(getattr(gm, n) for n in MOE_COUNTERS)
    op = operands or (lambda t: t)

    def fwd(xs, w1, b1, w2, b2, starts, cap):
        return gm.grouped_ffn_reference(op(xs), op(w1), b1, op(w2), b2, starts, cap)

    def dx(xs, dy, w1, b1, w2, starts, cap):
        return gm.grouped_ffn_dx_reference(op(xs), op(dy), op(w1), b1, op(w2), starts, cap)

    def dw(xs, dy, w1, b1, w2, starts, cap):
        if fault:
            dy = dy.clone()
            for lo, hi in gm.kept_ranges(starts, cap, xs.shape[0]):
                dy[lo:min(lo + 64, hi)] = 0
        return gm.grouped_ffn_dw_reference(op(xs), op(dy), op(w1), b1, op(w2), starts, cap)

    @contextlib.contextmanager
    def swapped():
        gm.grouped_ffn_fwd, gm.grouped_ffn_dx, gm.grouped_ffn_dw = fwd, dx, dw
        try:
            yield
        finally:
            gm.grouped_ffn_fwd, gm.grouped_ffn_dx, gm.grouped_ffn_dw = saved

    return swapped()


def moe_step_check(gm, precision: str) -> dict:
    import torch

    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.data import get_datasets
    from distributed_training_comparison_tpu_torch.train import build_model, forward_backward
    from distributed_training_comparison_tpu_torch.train.step import COMPUTE_DTYPES

    edit, loss_tol, ref_tol, plain_tol, control = MOE_STEP_CHECKS[precision]
    hp = load_config(edit(TRAIN_MOE_ARGV) + ["--moe-dispatch", "gmm"])
    hp_ref = load_config(edit(TRAIN_MOE_ARGV) + ["--moe-dispatch", "gather"])
    images, labels = get_datasets(hp)[0]
    images = torch.from_numpy(images[:hp.batch_size]).cuda()
    labels = torch.from_numpy(labels[:hp.batch_size]).long().cuda()
    counters = tuple(getattr(gm, n) for n in MOE_COUNTERS)
    torch.manual_seed(hp.seed)
    state = build_model(hp).state_dict()
    runs = {}
    variants = [
        ("kernel", hp, None), ("reference", hp_ref, None),
        ("plain", hp, lambda: plain_moe_kernels(gm, fault=False)),
        ("fault", hp, lambda: plain_moe_kernels(gm, fault=True)),
    ]
    if control:
        variants.append(("tf32", hp, lambda: plain_moe_kernels(gm, fault=False, operands=tf32)))
    for name, h, swap in variants:
        model = build_model(h)
        model.load_state_dict(state)
        model = model.cuda()
        before = [c.launches for c in counters]
        with swap() if swap else contextlib.nullcontext():
            loss, _, extras = forward_backward(
                model, images, labels, compute_dtype=COMPUTE_DTYPES[h.precision]
            )
            torch.cuda.synchronize()
        runs[name] = {
            "loss": loss.item(),
            "health": {k: v.item() for k, v in extras.items()},
            "grads": {n: p.grad.detach().clone() for n, p in model.named_parameters()},
            "launches": [c.launches - n for c, n in zip(counters, before)],
            "depth": len(model.blocks),
        }
        del model, loss
        torch.cuda.empty_cache()
    ref, plain = runs["reference"]["grads"], runs["plain"]["grads"]
    controls = ("fault", "tf32") if control else ("fault",)
    errors = {name: grad_errors(runs[name]["grads"], ref) for name in ("kernel", "plain", *controls)}
    errors["kernel_vs_plain"] = grad_errors(runs["kernel"]["grads"], plain)
    for name in controls:
        errors[f"{name}_vs_plain"] = grad_errors(runs[name]["grads"], plain)
    worst = {name: max(e.values()) for name, e in errors.items()}
    finite = all(bool(torch.isfinite(g).all()) for g in runs["kernel"]["grads"].values())
    loss_ref = runs["reference"]["loss"]
    loss_err = abs(runs["kernel"]["loss"] - loss_ref) / abs(loss_ref)
    depth = runs["kernel"]["depth"]
    return {
        "precision": precision, "batch": hp.batch_size,
        "loss_kernel": runs["kernel"]["loss"], "loss_reference": loss_ref,
        "loss_plain": runs["plain"]["loss"], "loss_rel_err": loss_err, "loss_tol": loss_tol,
        "health_kernel": runs["kernel"]["health"], "health_reference": runs["reference"]["health"],
        "grad_rel_l2_tol": ref_tol,
        "grad_rel_l2_max": worst["kernel"], "grad_rel_l2_worst": _worst(errors["kernel"]),
        "plain_grad_rel_l2_max": worst["plain"],
        "kernel_vs_plain_tol": plain_tol,
        "kernel_vs_plain_grad_rel_l2_max": worst["kernel_vs_plain"],
        "kernel_vs_plain_worst": _worst(errors["kernel_vs_plain"]),
        **{f"{name}_grad_rel_l2_max": worst[name] for name in controls},
        **{f"{name}_vs_plain_grad_rel_l2_max": worst[f"{name}_vs_plain"] for name in controls},
        "router_grad_rel_l2_max": max(v for k, v in errors["kernel"].items() if ".router." in k),
        "grads_finite": finite,
        "launches_kernel": runs["kernel"]["launches"],
        "launches_reference": runs["reference"]["launches"],
        "launches_plain": runs["plain"]["launches"],
        "depth": depth,
        "ok": (
            finite and loss_err <= loss_tol
            and worst["kernel"] <= ref_tol and worst["kernel_vs_plain"] <= plain_tol
            and all(ref_tol < worst[c] and plain_tol < worst[f"{c}_vs_plain"] for c in controls)
            and runs["kernel"]["launches"] == [depth] * 3
            and runs["reference"]["launches"] == [0, 0, 0]
            and runs["plain"]["launches"] == [0, 0, 0]
        ),
    }


def moe_step_times(reps: int = 5, csrc: Path | None = None) -> dict:
    """ms per train step of the train command's trainer under gmm (auto)
    and ``--moe-dispatch gather``, in turns (gmm, gather, gmm, gather), and
    a profile of two steps of each: the expert FFN kernels' device ms by
    symbol (``csrc``'s, this checkout's by default), K7, K8 and K9's by
    their bf16 symbols, their share, and the idle share."""
    import torch

    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.train import Trainer
    from distributed_training_comparison_tpu_torch.utils import step_generator

    trainers = {
        "gmm": Trainer(load_config(TRAIN_MOE_ARGV)),
        "gather": Trainer(load_config(TRAIN_MOE_ARGV + ["--moe-dispatch", "gather"])),
    }
    hp = trainers["gmm"].hparams
    images, labels = next(trainers["gmm"].train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    out = {}
    for rnd in ("", "_again"):
        for name, tr in trainers.items():
            tr.step(images, labels, draws)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                tr.step(images, labels, draws)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / reps * 1e3
            out[f"ms_per_step_{name}{rnd}"] = ms
            out[f"images_per_s_{name}{rnd}"] = hp.batch_size / ms * 1e3
    for name, tr in trainers.items():
        prof = profile_device(lambda: tr.step(images, labels, draws), 2)
        names = prof["device_ms_by_name"]
        moe = _moe_kernel_ms(names, csrc)
        kernels = {k: moe.get(sym, 0.0) for k, sym in MOE_SYMBOLS["bfloat16"].items()}
        gemm = sum(ms for n, ms in names.items()
                   if any(t in n.lower() for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")))
        top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
        out[f"profile_{name}"] = {
            "wall_ms_per_step": prof["wall_ms"],
            "device_busy_ms_per_step": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "moe_kernels": moe,
            "moe_kernels_device_ms_per_step": kernels,
            "moe_kernels_share_of_busy": sum(moe.values()) / prof["device_busy_ms"],
            "cublas_gemm_device_ms_per_step": gemm,
            "top_device_ms_per_step": {n[:60]: ms for n, ms in top},
        }
    del trainers
    torch.cuda.empty_cache()
    return out


def train_moe_phase(gm, vb, attn, smi: str) -> dict:
    """``vit_moe`` trained through ``entry.run`` (bf16, batch 256, 18
    steps): every block's forward through K7 and backward through K8 and
    K9, the counters zeroed just before and read just after; every loss
    finite, no step skipped, the routing health reported; one step's loss
    and gradients against ``--moe-dispatch gather`` and the plain kernels
    (bf16 and fp32); ms per step under gmm and gather, and a step profile."""
    import torch

    from distributed_training_comparison_tpu_torch import entry
    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.data import get_datasets

    counters = _moe_path_counters(gm, vb, attn)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = entry.run(TRAIN_MOE_ARGV)
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hp = load_config(TRAIN_MOE_ARGV)
    epochs = report["fit"]["epochs"]
    val_examples = len(get_datasets(hp)[1][1])
    last = epochs[-1]
    checks = {p: moe_step_check(gm, p) for p in MOE_STEP_CHECKS}
    return {
        "phase": "train_moe",
        "nvidia_smi": smi,
        "argv": TRAIN_MOE_ARGV,
        "run_seconds": seconds,
        "train_steps": sum(e["steps"] for e in epochs),
        "eval_batches": len(epochs) * math.ceil(val_examples / hp.batch_size),
        "depth": checks["bf16"]["depth"],
        "launches": launches,
        "losses_finite": all(e["nonfinite_losses"] == 0 for e in epochs),
        "skipped_steps": sum(e["skipped"] for e in epochs),
        "routing_health_reported": all(
            math.isfinite(e.get("moe_dropped_frac", math.nan))
            and math.isfinite(e.get("moe_load_max", math.nan)) for e in epochs
        ),
        "epochs": epochs,
        "peak_memory_gb": peak_gb,
        "last_epoch_images_per_s": last["images_per_s"],
        "last_epoch_ms_per_step": last["seconds"] / last["steps"] * 1e3,
        "step_checks": checks,
        "step_times": moe_step_times(),
    }


def check_train_moe(train: dict) -> None:
    depth, steps = train["depth"], train["train_steps"]
    want = {n: 0 for n in train["launches"]}
    want["grouped_ffn_fwd"] = depth * (steps + train["eval_batches"])
    want["grouped_ffn_dx"] = want["grouped_ffn_dw"] = depth * steps
    if train["launches"] != want:
        raise RuntimeError(f"train_moe launches {train['launches']}, expected {want}")
    if not train["losses_finite"] or train["skipped_steps"]:
        raise RuntimeError("train_moe: a non-finite loss or a skipped step")
    if not train["routing_health_reported"]:
        raise RuntimeError("train_moe: moe_dropped_frac / moe_load_max missing from the epochs")
    bad = {p: c for p, c in train["step_checks"].items() if not c["ok"]}
    if bad:
        raise RuntimeError(f"a vit_moe train step through K7-K9 disagrees: {bad}")
    times = train["step_times"]
    check_moe_kernels("train_moe's gmm step", times["profile_gmm"]["moe_kernels"], ("fwd", "dx", "dw"))
    check_moe_kernels("train_moe's gather step", times["profile_gather"]["moe_kernels"], ())


# --------------------------------- vit_tiny at 64 tokens: K10, K11

# (label, dtype, B, S, H, D, causal): the serve path's bucket-32 attention
# and the train path's batch-256 attention (bf16, and fp32 as vit_tiny
# trains without --amp), a causal case with a ragged S (one partial key
# tile) and a causal multi-tile case (S 256: the causal tile skipping of
# both sweeps and of the dk/dv walk), unit-normal packed (B*S, H*D) inputs.
SMALL_CASES = [
    ("serve shape: vit_tiny bucket 32", "bfloat16", 32, 64, 3, 64, False),
    ("train shape: vit_tiny batch 256", "bfloat16", 256, 64, 3, 64, False),
    ("train shape fp32: vit_tiny batch 256 without --amp", "float32", 256, 64, 3, 64, False),
    ("ragged causal", "bfloat16", 6, 24, 2, 64, True),
    ("one tile at head dim 128, causal", "bfloat16", 8, 64, 2, 128, True),
    ("ragged one tile", "bfloat16", 6, 40, 3, 64, False),
    ("multi-tile causal", "bfloat16", 4, 256, 2, 128, True),
]
# Each output and gradient holds against the plain version per row (one
# token's D values of one head) with the flash kernels' TOLERANCES, for the
# same reasons: K10/K11 and the plain versions form the same fp32 scores,
# P, dp and ds and round P and ds to bf16 at the same points, so they differ
# by summation order, the rare bf16 flip it causes in one P or ds term, and
# one rounding of each result (rtol 2^-6).  The planted faults: K10 run
# with the values of the last FAULT_KEYS keys of every item zeroed (8 keys
# where S <= 64: there one tile is the whole item), as a kernel that left
# those keys out of P.V; K11's dk with the first key tile of item 0, head 0
# (one dk/dv block's rows) zeroed.  Each must need more than the tolerance.
SMALL_COUNTERS = ("small_mha_fwd", "small_mha_bwd")
# the kernels of the serve_small and train_small paths (bf16, 64 tokens),
# as small.kernel_symbols names them for that shape
SMALL_PATH_KERNELS = {"fwd": ("attn_small_fwd_onetile",), "bwd": ("attn_small_bwd_onetile",)}


def without_last_keys(v, seq: int, n: int):
    """Packed (B*S, H*D) ``v`` with the last ``n`` keys of every item
    zeroed: K10 run on it is K10 with those keys left out of P.V."""
    v = v.clone()
    v.view(-1, seq, v.shape[1])[:, seq - n:] = 0
    return v


def small_bounds(b, s, h, d, causal, dname) -> dict[str, tuple[float, str]]:
    """Least times of K10 (q, k, v read, o written; 2 products: s and P.V)
    and K11 (q, k, v, dO read, dq, dk, dv written; 5 products: s, dp, dq,
    dk, dv), causal counting only the pairs it needs."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    elems = b * s * h * d * (2 if dname == "bfloat16" else 4)
    return {"fwd": bound(4 * pairs * d, 4 * elems, dname),
            "bwd": bound(10 * pairs * d, 7 * elems, dname)}


_GLOBAL_FN = re.compile(r"__global__ void(?: __(?:cluster_dims|launch_bounds)__\((?:[^()]|\([^()]*\))*\))*\s+(\w+)\(")


def _port_kernel_ms(device_ms_by_name: dict, sources: str = "*.cu", csrc: Path | None = None) -> dict[str, float]:
    """Device ms of the port's kernels (every ``__global__`` function its
    ``csrc`` sources matching ``sources`` define; this checkout's unless
    ``csrc`` names another's) by symbol, template arguments summed."""
    names = {m.group(1) for f in (csrc or ROOT / PKG / "ops" / "csrc").glob(sources)
             for m in _GLOBAL_FN.finditer(f.read_text())}
    out = {}
    for name, ms in device_ms_by_name.items():
        if (m := _KERNEL_SYMBOL.match(name)) and m.group(1) in names:
            out[m.group(1)] = out.get(m.group(1), 0.0) + ms
    return out


def _small_kernel_ms(device_ms_by_name: dict) -> dict[str, float]:
    """Device ms of K10's and K11's kernels by symbol: the one-tile kernels
    (``attn_small_fwd_onetile``, ``attn_small_bwd_onetile``) and the tiled
    and fp32 ones (``attn_small_fwd_*``, ``attn_small_dq_*``,
    ``attn_small_dkv_*``); ``small.kernel_symbols`` says which a call
    launches."""
    return {n: ms for n, ms in _port_kernel_ms(device_ms_by_name).items()
            if n.startswith("attn_small_")}


def small_attention_checks(small) -> list[dict]:
    """K10 (``small_mha_fwd``) and K11 (``small_mha_bwd``) against
    ``small_mha_reference`` and ``small_mha_bwd_reference`` at
    ``SMALL_CASES``: agreement per row, the planted faults, K11's bitwise
    replay, the kernels each call launched (by symbol, under torch.profiler:
    those ``small.kernel_symbols`` names for the case, and no other), device
    times (``timed``) of the kernels, the plain versions and the library
    yardstick: ``F.scaled_dot_product_attention`` forward, and forward plus
    backward under autograd."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(6)
    out = []
    for label, dname, b, s, h, d, causal in SMALL_CASES:
        dtype = getattr(torch, dname)
        atol_share, rtol, _ = TOLERANCES[dname]
        q, k, v, do = (torch.randn((b * s, h * d), generator=gen).to(device="cuda", dtype=dtype)
                       for _ in range(4))
        kw = dict(seq=s, heads=h, causal=causal)
        o = small.small_mha_fwd(q, k, v, **kw)
        grads = small.small_mha_bwd(q, k, v, do, **kw)
        again = small.small_mha_bwd(q, k, v, do, **kw)
        torch.cuda.synchronize()
        view = [x.view(b, s, h, d) for x in (q, k, v, do)]
        want_o = small.small_mha_reference(*view[:3], causal=causal)
        want = small.small_mha_bwd_reference(*view, causal=causal)
        n = FAULT_KEYS if s > 64 else 8
        fault_o = small.small_mha_fwd(q, k, without_last_keys(v, s, n), **kw).view(b, s, h, d)
        dk_fault = grads[1].clone().view(b, s, h, d)
        dk_fault[0, :min(s, FAULT_KEYS), 0] = 0
        faults = {"out": fault_o, "dk": dk_fault}
        agree = {}
        for name, got, ref in zip(("out", "dq", "dk", "dv"), (o, *grads), (want_o, *want)):
            agree[name] = _agreement(got.view(b, s, h, d), ref, faults.get(name, ref), rtol)
            if name not in faults:
                del agree[name]["fault_atol_share_needed"]
        ok = all(a["finite"] and a["atol_share_needed"] <= atol_share for a in agree.values()) and all(
            atol_share < agree[name]["fault_atol_share_needed"] for name in faults
        )
        bitwise = all(torch.equal(x, y) for x, y in zip(grads, again))

        # each call launches the kernels the rule on S names, and no other
        launched = {}
        for key, fn in (("fwd", lambda: small.small_mha_fwd(q, k, v, **kw)),
                        ("bwd", lambda: small.small_mha_bwd(q, k, v, do, **kw))):
            launched[key] = _port_kernel_ms(profile_device(fn, 20)["device_ms_by_name"])
        kernels = small.kernel_symbols(dtype, s)
        named = all(set(launched[key]) == set(kernels[key]) for key in kernels)
        ms = {key: sum(by.values()) for key, by in launched.items()}
        event_ms = {"fwd": cuda_ms(lambda: small.small_mha_fwd(q, k, v, **kw), 50),
                    "bwd": cuda_ms(lambda: small.small_mha_bwd(q, k, v, do, **kw), 50)}
        plain_ms = {
            "fwd": timed(lambda: small.small_mha_reference(*view[:3], causal=causal))[0],
            "bwd": timed(lambda: small.small_mha_bwd_reference(*view, causal=causal))[0],
        }
        # the library yardstick, never called by the port: SDPA on the
        # (B, H, S, D) views of the same projections
        ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_() for x in view[:3])
        dol = view[3].transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (ql, kl, vl), dol)

        lib_fwd, lib_fwd_event = timed(sdpa)
        lib_fwd_bwd, lib_fwd_bwd_event = timed(sdpa_fwd_bwd)
        bounds = small_bounds(b, s, h, d, causal, dname)
        out.append({
            "case": label, "dtype": dname, "shape_b_s_h_d": [b, s, h, d], "causal": causal,
            "atol_share": atol_share, "rtol": rtol, "fault_keys_k10": n,
            "fault_dk_rows": min(s, FAULT_KEYS), "agreement": agree,
            "k11_bit_identical_across_calls": bitwise,
            "kernels": {key: list(names) for key, names in kernels.items()},
            "kernels_as_named": named,
            "ms": ms, "kernel_ms": launched, "event_ms": event_ms, "plain_ms": plain_ms,
            "library": "F.scaled_dot_product_attention (fwd; fwd+bwd under autograd)",
            "library_ms": {"fwd": lib_fwd, "bwd": lib_fwd_bwd - lib_fwd,
                           "fwd_bwd": lib_fwd_bwd},
            "library_event_ms": {"fwd": lib_fwd_event, "fwd_bwd": lib_fwd_bwd_event},
            "bound_ms": {key: bounds[key][0] for key in bounds},
            "bound_by": {key: bounds[key][1] for key in bounds},
            "ok": ok and bitwise and named,
        })
        del q, k, v, do, o, grads, again, want_o, want, fault_o, dk_fault, ql, kl, vl
        torch.cuda.empty_cache()
    return out


SERVE_SMALL_ARGV = [
    "--serve", "--model", "vit_tiny", "--amp",
    "--serve-buckets", "1,2,4,8,16,32", "--serve-shape", "closed",
    "--serve-requests", "256", "--serve-concurrency", "32", "--seed", "0",
]


def _small_path_counters(small, gm, vb, attn) -> dict:
    """Every kernel counter of the port: K10's and K11's, and the ones the
    fused_small paths must not launch."""
    return {**{n: getattr(small, n) for n in SMALL_COUNTERS}, **_moe_path_counters(gm, vb, attn)}


@contextlib.contextmanager
def dropped_keys_k10(small, n: int = 8):
    """Every K10 launch with the values of the last ``n`` keys of every item
    zeroed (the small_attention_checks fault), while the context lasts;
    these launches are not the path's."""
    real = small.small_mha_fwd

    def faulty(q, k, v, *, seq, heads, causal=False, scale=None):
        return real(q, k, without_last_keys(v, seq, n), seq=seq, heads=heads, causal=causal,
                    scale=scale)

    # the wrapper counts into the module name it runs under, which is now
    # ``faulty``: these launches stay off the path's counter
    faulty.launches = 0
    small.small_mha_fwd = faulty
    try:
        yield
    finally:
        small.small_mha_fwd = real


# The bucket-32 logits of vit_tiny pinned to fused_small (K10 in every
# block) against the same seeded weights with attn_impl="reference"
# (mha_reference: einsum scores, fp32 softmax, P rounded to the compute
# dtype before P.V, the same rounding points as K10).  precision -> (argv
# edit, bound as a share of the largest reference logit).  bf16: the paths
# differ by summation order, which flips a bf16 rounding of P or of an
# output now and then, and each of 12 blocks adds such flips to a bf16
# residual stream: 2^-6 of the largest logit (two bf16 ulps of it; at
# seed 0 they differ by one).  fp32: summation order only, through 12
# blocks: 2^-18 (at seed 0, ~2^-21.7).  The planted fault (every K10 launch
# with its last 8 keys' values zeroed) must exceed both.
SMALL_LOGIT_CHECKS = {
    "bf16": (lambda argv: argv, 2**-6),
    "fp32": (lambda argv: [a for a in argv if a != "--amp"], 2**-18),
}


def serve_small_phase(small, gm, vb, attn) -> dict:
    """``vit_tiny --amp`` at 32 px (64 tokens) served through the port's
    library entry points: ``build_engine(hparams, attn_impl="fused_small")``
    warmed, then ``MicroBatcher`` and ``closed_loop`` as ``serve_main``
    composes them.  The counters are zeroed after the warmup; every block of
    every dispatched batch runs K10 and no other kernel.  The bucket-32
    logits against ``attn_impl="reference"`` in bf16 and fp32 with a bound
    a planted K10 fault exceeds; a bucket-32 dispatch timed under fused_small
    and auto (the reference attention at 64 tokens) and profiled."""
    import numpy as np

    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.serve import (
        MicroBatcher,
        build_engine,
        closed_loop,
        request_pool,
    )

    hp = load_config(SERVE_SMALL_ARGV)
    engine = build_engine(hp, attn_impl="fused_small")
    engine.warmup()
    warm_batches = sum(engine.bucket_counts.values())
    images = request_pool(max(256, engine.max_bucket), image_size=engine.image_size,
                          seed=hp.seed, fold=("serve", 0))
    counters = _small_path_counters(small, gm, vb, attn)
    for c in counters.values():
        c.launches = 0
    batcher = MicroBatcher(engine, mode=hp.serve_mode, max_wait_ms=hp.max_wait_ms,
                           queue_limit=hp.queue_limit)
    try:
        report = closed_loop(batcher, images, num_requests=hp.serve_requests,
                             concurrency=hp.serve_concurrency, deadline_ms=hp.deadline_ms or None)
    finally:
        batcher.close()
    launches = {name: c.launches for name, c in counters.items()}
    batches = sum(engine.bucket_counts.values()) - warm_batches
    depth = len(engine.model.blocks)
    summary = batcher.metrics.summary()
    del engine

    checks = {}
    for precision, (edit, share) in SMALL_LOGIT_CHECKS.items():
        h = load_config(edit(SERVE_SMALL_ARGV))
        batch = request_pool(32, image_size=h.image_size, seed=h.seed, fold=("check", 0))
        engines = {"fused_small": build_engine(h, attn_impl="fused_small"),
                   "reference": build_engine(h, attn_impl="reference")}
        rec = {}
        for name, eng in engines.items():
            before = small.small_mha_fwd.launches
            rec[f"logits_{name}"] = eng.predict_logits(batch)
            rec[f"k10_launches_{name}"] = small.small_mha_fwd.launches - before
        with dropped_keys_k10(small):
            fault = engines["fused_small"].predict_logits(batch)
        got, want = rec.pop("logits_fused_small"), rec.pop("logits_reference")
        scale = float(np.abs(want).max())
        rec.update({
            "logits_finite": bool(np.isfinite(got).all() and np.isfinite(want).all()),
            "logits_max_abs_err_vs_reference": float(np.abs(got - want).max()),
            "logits_scale": scale, "logits_tol": share * scale, "logits_tol_share": share,
            "fault_logits_max_abs_err_vs_reference": float(np.abs(fault - want).max()),
        })
        if precision == "bf16":
            engines["auto"] = build_engine(h)
            for rnd in ("", "_again"):
                for name in ("fused_small", "auto"):
                    eng = engines[name]
                    eng.predict_logits(batch)
                    t0 = time.perf_counter()
                    for _ in range(5):
                        eng.predict_logits(batch)
                    rec[f"bucket32_batch_ms_{name}{rnd}"] = (time.perf_counter() - t0) / 5 * 1e3
            for name in ("fused_small", "auto"):
                prof = profile_device(lambda: engines[name].predict_logits(batch), 5)
                port = _port_kernel_ms(prof["device_ms_by_name"])
                k10 = sum(_small_kernel_ms(prof["device_ms_by_name"]).values())
                top = sorted(prof["device_ms_by_name"].items(), key=lambda kv: -kv[1])[:8]
                rec[f"bucket32_profile_{name}"] = {
                    "wall_ms_per_batch": prof["wall_ms"],
                    "device_busy_ms_per_batch": prof["device_busy_ms"],
                    "device_idle_share": prof["device_idle_share"],
                    "port_kernels": sorted(port),
                    "k10_device_ms_per_batch": k10,
                    "k10_share_of_device_busy": k10 / prof["device_busy_ms"],
                    "top_device_ms_per_batch": {n[:60]: ms for n, ms in top},
                }
        checks[precision] = rec
        del engines
    return {
        "phase": "serve_small",
        "argv": SERVE_SMALL_ARGV,
        "attn_impl": "fused_small",
        "offered": report["offered"],
        "completed": report["completed"],
        "failed": report["failed"],
        "shed": report["shed"],
        "expired": report["expired"],
        "throughput_rps": report["throughput_rps"],
        "p50_ms": report["latency_ms"]["p50"],
        "p99_ms": report["latency_ms"]["p99"],
        "duration_s": report["duration_s"],
        "engine_batches": batches,
        "warmup_batches": warm_batches,
        "mean_batch_size": summary["mean_batch_size"],
        "mean_service_ms": summary["mean_service_ms"],
        "depth": depth,
        "launches": launches,
        "bucket32": checks,
    }


def check_serve_small(serve: dict) -> None:
    if serve["completed"] != serve["offered"] or serve["failed"]:
        raise RuntimeError(f"serve_small lost requests: {serve}")
    want = {n: 0 for n in serve["launches"]}
    want["small_mha_fwd"] = serve["depth"] * serve["engine_batches"]
    if serve["launches"] != want:
        raise RuntimeError(f"serve_small launches {serve['launches']}, expected {want}")
    for precision, rec in serve["bucket32"].items():
        if (rec["k10_launches_fused_small"], rec["k10_launches_reference"]) != (serve["depth"], 0):
            raise RuntimeError(f"serve_small {precision} bucket-32 batch: launches {rec}")
        if not rec["logits_finite"] or rec["logits_max_abs_err_vs_reference"] > rec["logits_tol"]:
            raise RuntimeError(f"serve_small {precision}: K10 logits disagree with the reference: {rec}")
        if not rec["fault_logits_max_abs_err_vs_reference"] > rec["logits_tol"]:
            raise RuntimeError(f"serve_small {precision}: the planted K10 fault passes the bound: {rec}")
    # no other kernel of the port, by name: a bf16 dispatch at 64 tokens runs K10's one-tile kernel
    want_kernels = list(SMALL_PATH_KERNELS["fwd"])
    got_kernels = serve["bucket32"]["bf16"]["bucket32_profile_fused_small"]["port_kernels"]
    if got_kernels != want_kernels:
        raise RuntimeError(f"serve_small bucket-32 dispatch ran {got_kernels}, expected {want_kernels}")


TRAIN_SMALL_ARGV = [
    "--model", "vit_tiny", "--amp", "--synthetic-data", "--batch-size", "256",
    "--limit-examples", "2560", "--epoch", "2", "--lr-decay-step-size", "1",
]
# One train step of vit_tiny pinned to fused_small (K: K10 forward and K11
# backward in every block) against the same seeded weights and batch with
# attn_impl="reference" (R: mha_reference under autograd) and against P:
# the same autograd Function with K10 and K11 swapped for their plain
# versions.  precision -> (argv edit, loss bound relative, bound on K vs R,
# bound on K vs P), gradient bounds as relative L2 per parameter.  bf16:
# R's autograd rounds the cotangent of P to bf16 before the softmax
# backward subtracts its row mean, where K and P keep it in fp32 (the JAX
# head_bwd).  K and P differ only by summation order and the bf16 flips of
# P and ds it causes; the worst parameters are the last blocks' q and k
# projections, whose gradients are a cancelling sum of ds terms at
# initialisation (near-uniform P), so one flip moves them by ~1%: K vs P is
# held to 2^-6 and K vs R to 2^-5 (at seed 0 both read ~1.4%, P vs R
# ~0.5%).  fp32: summation order only, 2^-13, and 1e-5 on the loss.  The
# planted fault (P with dk of the last 8 keys of every item zeroed in every
# block: rows a dk/dv kernel would leave unwritten) must exceed every
# gradient bound.  Batch 256, the train command's.
SMALL_STEP_CHECKS = {
    "bf16": (lambda argv: argv, 2**-6, 2**-5, 2**-6),
    "fp32": (lambda argv: [a for a in argv if a != "--amp"], 1e-5, 2**-13, 2**-13),
}


def plain_small_kernels(small, fault: bool):
    """Context that swaps K10 and K11 for their plain versions on the card
    (the autograd Function stays).  ``fault`` zeroes dk of the last 8 keys
    of every item."""
    saved = tuple(getattr(small, n) for n in SMALL_COUNTERS)
    unpack = small._unpacked

    def fwd(q, k, v, *, seq, heads, causal=False, scale=None):
        o = small.small_mha_reference(*(unpack(t, seq, heads) for t in (q, k, v)),
                                      causal=causal, scale=scale)
        return o.reshape(q.shape)

    def bwd(q, k, v, do, *, seq, heads, causal=False, scale=None):
        dq, dk, dv = small.small_mha_bwd_reference(
            *(unpack(t, seq, heads) for t in (q, k, v, do)), causal=causal, scale=scale
        )
        if fault:
            dk[:, seq - 8:] = 0
        return dq.reshape(q.shape), dk.reshape(q.shape), dv.reshape(q.shape)

    @contextlib.contextmanager
    def swapped():
        small.small_mha_fwd, small.small_mha_bwd = fwd, bwd
        try:
            yield
        finally:
            small.small_mha_fwd, small.small_mha_bwd = saved

    return swapped()


def small_step_check(small, precision: str) -> dict:
    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.train import build_model
    from distributed_training_comparison_tpu_torch.train.step import COMPUTE_DTYPES

    edit, loss_tol, ref_tol, plain_tol = SMALL_STEP_CHECKS[precision]
    hp = load_config(edit(TRAIN_SMALL_ARGV))
    state = build_model(hp).state_dict()

    def pinned():
        return build_model(hp, attn_impl="fused_small")

    runs = step_runs(
        [("kernel", pinned, None),
         ("reference", lambda: build_model(hp, attn_impl="reference"), None),
         ("plain", pinned, lambda: plain_small_kernels(small, fault=False)),
         ("fault", pinned, lambda: plain_small_kernels(small, fault=True))],
        state, tuple(getattr(small, n) for n in SMALL_COUNTERS), *_first_batch(hp),
        COMPUTE_DTYPES[hp.precision],
    )
    return step_report(precision, hp.batch_size, runs, loss_tol, ref_tol, plain_tol)


def small_step_times(trainer, reps: int = 5) -> dict:
    """ms per train step (host clock around ``reps`` steps ending in a
    synchronise) of the fused_small ``trainer`` and of a trainer of the same
    command under auto (the reference attention at 64 tokens), in turns,
    and a profile of two steps of each: K10's and K11's device ms and
    shares, and the idle share."""
    import torch

    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.train import Trainer
    from distributed_training_comparison_tpu_torch.utils import step_generator

    hp = trainer.hparams
    trainers = {"fused_small": trainer, "auto": Trainer(hp)}
    images, labels = next(trainer.train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    out = {}
    for rnd in ("", "_again"):
        for name, tr in trainers.items():
            tr.step(images, labels, draws)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                tr.step(images, labels, draws)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / reps * 1e3
            out[f"ms_per_step_{name}{rnd}"] = ms
            out[f"images_per_s_{name}{rnd}"] = hp.batch_size / ms * 1e3
    for name, tr in trainers.items():
        prof = profile_device(lambda: tr.step(images, labels, draws), 2)
        names = prof["device_ms_by_name"]
        kernels = _small_kernel_ms(names)
        top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
        out[f"profile_{name}"] = {
            "wall_ms_per_step": prof["wall_ms"],
            "device_busy_ms_per_step": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "port_kernels": sorted(_port_kernel_ms(names)),
            "k10_k11_device_ms_per_step": kernels,
            "k10_k11_share_of_busy": sum(kernels.values()) / prof["device_busy_ms"],
            "top_device_ms_per_step": {n[:60]: ms for n, ms in top},
        }
    del trainers["auto"]
    torch.cuda.empty_cache()
    return out


def train_small_phase(small, gm, vb, attn, smi: str) -> dict:
    """``vit_tiny --amp`` at batch 256 (the JAX kernels' design point)
    trained through the port's library entry points:
    ``Trainer(hparams, model=build_model(hparams, attn_impl="fused_small"))``
    and ``fit``, the counters zeroed just before and read just after: K10
    in every block of every train step and eval batch, K11 in every block
    of every train step, no other kernel; every loss finite, no step
    skipped; one step's loss and gradients against the reference attention
    and the plain kernels (bf16 and fp32); ms per step under fused_small and
    auto, and step profiles."""
    import torch

    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.train import Trainer, build_model

    hp = load_config(TRAIN_SMALL_ARGV)
    trainer = Trainer(hp, model=build_model(hp, attn_impl="fused_small"))
    counters = _small_path_counters(small, gm, vb, attn)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = trainer.fit()
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    epochs = fit["epochs"]
    last = epochs[-1]
    checks = {p: small_step_check(small, p) for p in SMALL_STEP_CHECKS}
    return {
        "phase": "train_small",
        "nvidia_smi": smi,
        "argv": TRAIN_SMALL_ARGV,
        "attn_impl": "fused_small",
        "run_seconds": seconds,
        "train_steps": sum(e["steps"] for e in epochs),
        "eval_batches": len(epochs) * math.ceil(len(trainer.val_split) / hp.batch_size),
        "depth": len(trainer.model.blocks),
        "launches": launches,
        "losses_finite": all(e["nonfinite_losses"] == 0 for e in epochs),
        "skipped_steps": sum(e["skipped"] for e in epochs),
        "epochs": epochs,
        "peak_memory_gb": peak_gb,
        "last_epoch_images_per_s": last["images_per_s"],
        "last_epoch_ms_per_step": last["seconds"] / last["steps"] * 1e3,
        "step_checks": checks,
        "step_times": small_step_times(trainer),
    }


def check_train_small(train: dict) -> None:
    depth, steps = train["depth"], train["train_steps"]
    want = {n: 0 for n in train["launches"]}
    want["small_mha_fwd"] = depth * (steps + train["eval_batches"])
    want["small_mha_bwd"] = depth * steps
    if train["launches"] != want:
        raise RuntimeError(f"train_small launches {train['launches']}, expected {want}")
    if not train["losses_finite"] or train["skipped_steps"]:
        raise RuntimeError("train_small: a non-finite loss or a skipped step")
    bad = {p: c for p, c in train["step_checks"].items() if not c["ok"]}
    if bad:
        raise RuntimeError(f"a vit_tiny train step through K10/K11 disagrees: {bad}")
    # no other kernel of the port, by name: K10's and K11's one-tile kernels
    want_kernels = sorted(SMALL_PATH_KERNELS["fwd"] + SMALL_PATH_KERNELS["bwd"])
    got_kernels = train["step_times"]["profile_fused_small"]["port_kernels"]
    if got_kernels != want_kernels:
        raise RuntimeError(f"a train_small step ran {got_kernels}, expected {want_kernels}")


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
    gm = importlib.import_module(f"{PKG}.ops.moe_gmm")
    small = importlib.import_module(f"{PKG}.ops.attention_small")

    t0 = time.monotonic()
    paths = _build.build_all()
    attention_build = attention_build_report(_build, paths)
    gemm_build = gemm_build_report(_build, paths, vb)
    moe_build = moe_build_report(_build, paths)
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3),
          "libraries": {n: str(p.relative_to(ROOT)) for n, p in paths.items()},
          "attention": attention_build, "block_gemm": gemm_build, "moe_gmm": moe_build})
    for path in paths.values():
        log = path.with_suffix(".log")
        for line in (log.read_text() if log.exists() else "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {path.stem}: {line.strip()}", file=sys.stderr)
    built = {**attention_build["kernels"], **gemm_build["kernels"], **moe_build["kernels"]}
    missing = [k for k in MOE_SYMBOLS["bfloat16"].values() if k.endswith("_wgmma") and k not in built]
    if missing:
        raise RuntimeError(f"the build logs hold no ptxas report of {missing}")
    spilled = {
        name: r for name, r in built.items()
        # the bf16 flash, one-tile, fused block GEMM and attention, and
        # grouped expert FFN kernels
        if ("flash_" in name and "bf16" in name or "onetile" in name or "_wgmma" in name)
        and r.get("spill_store_bytes", 0) + r.get("spill_load_bytes", 0)
    }
    if spilled:
        raise RuntimeError(f"bf16 attention, GEMM or expert FFN kernels spill registers: {spilled}")

    checks = kernel_checks(attn)
    emit({"phase": "kernel_checks", "nvidia_smi": smi, "checks": checks})
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
    if serve["fault_logits_max_abs_err"] <= serve["logits_tol"]:
        raise RuntimeError(f"the serve logits bound does not reject a planted fault: {serve}")
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
    prof = tiny["bucket32"]["bf16"]["bucket32_profile"]
    for key, wrapper in (("gemm_kernels", "block_gemm"), ("attention_kernels", "block_attention")):
        if prof[key] != path_symbols(wrapper, "bfloat16"):
            raise RuntimeError(f"serve_tiny's bucket-32 dispatch ran the {key} {prof[key]}")
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

    moe_checks = moe_gmm_checks(gm)
    emit({"phase": "moe_gmm_checks", "nvidia_smi": smi, "checks": moe_checks})
    bad = [c["case"] for c in moe_checks if not c["ok"]]
    if bad:
        raise RuntimeError(f"the grouped expert FFN kernels disagree with the plain versions: {bad}")

    serve_moe = serve_moe_phase(gm, vb, attn)
    emit(serve_moe)
    check_serve_moe(serve_moe)

    train_moe = train_moe_phase(gm, vb, attn, smi)
    emit(train_moe)
    check_train_moe(train_moe)

    small_checks = small_attention_checks(small)
    emit({"phase": "small_attention_checks", "nvidia_smi": smi, "checks": small_checks})
    bad = [c["case"] for c in small_checks if not c["ok"]]
    if bad:
        raise RuntimeError(f"the short-sequence attention kernels disagree with the plain versions: {bad}")

    serve_small = serve_small_phase(small, gm, vb, attn)
    emit(serve_small)
    check_serve_small(serve_small)

    train_small = train_small_phase(small, gm, vb, attn, smi)
    emit(train_small)
    check_train_small(train_small)

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
            "tflops": case["tflops"], "bound_share": case["bound_share"],
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
                "bit_identical_across_calls": all(
                    case["bit_identical_across_calls"][g] for g in grads
                ),
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
            "kernels": case["gemm_kernels"],
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
            "fault_atol_share_needed": att["fault_atol_share_needed"], "kernels": att["kernels"],
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
                "ms": case["kernel_ms"][name], "kernels": case["kernels"][name],
                "bound_ms": case["bound_ms"][name], "bound_by": case["bound_by"][name],
            })
    # K7-K9: per case, one entry per kernel.  ``launches`` is K7's count on
    # the serve_moe path (``launches_train`` on train_moe) and K8's and K9's
    # on the train_moe path.  K8 and K9 share the library yardstick: the
    # composed form's whole autograd backward.
    moe_src = {"fwd": "moe_gmm_fwd.cu", "dx": "moe_gmm_bwd.cu", "dw": "moe_gmm_bwd.cu"}
    moe_body = {"fwd": 71, "dx": 114, "dw": 144}
    moe_regime = {"fwd": "K7", "dx": "K8", "dw": "K9"}
    moe_launches = {
        "fwd": serve_moe["launches"]["grouped_ffn_fwd"],
        "dx": train_moe["launches"]["grouped_ffn_dx"],
        "dw": train_moe["launches"]["grouped_ffn_dw"],
    }
    for case in moe_checks:
        for k in ("fwd", "dx", "dw"):
            entry = {
                "name": f"moe_gmm_{k}", "route": "cuda", "source": f"{csrc}/{moe_src[k]}",
                "replaces": f"distributed_training_comparison_tpu/ops/moe_gmm.py:{moe_body[k]}",
                "regime": moe_regime[k], "case": case["case"], "dtype": case["dtype"],
                "n_cap_experts_dim_hidden": [case["n"], case["cap"], case["experts"],
                                             case["dim"], case["hidden"]],
                "kept_rows": case["kept_rows"], "kernel": MOE_SYMBOLS[case["dtype"]][k],
                "launches": moe_launches[k],
                "launches_counted": ("serve_moe main path" if k == "fwd" else "train_moe main path")
                + ", one counter for every case",
                "ms": case["ms"][k], "event_ms": case["event_ms"][k], "kernels": case["kernels"][k],
                "plain_ms": case["plain_ms"][k],
                "bound_ms": case["bound_ms"][k], "bound_by": case["bound_by"][k],
                "library_ms": case["library_ms"]["fwd" if k == "fwd" else "bwd"],
                "library_event_ms": case["library_event_ms"]["fwd" if k == "fwd" else "bwd"],
                "library": case["library"],
                "bit_identical_across_calls": case["bit_identical_across_calls"],
                "dropped_rows_exact_zero": case["dropped_rows_exact_zero"],
            }
            if k == "fwd":
                entry["launches_train"] = train_moe["launches"]["grouped_ffn_fwd"]
            if k == "dw":
                entry.update({
                    "max_abs_err": case["dw_max_abs_err"], "grad_rel_l2_max": max(case["dw_errors"]),
                    "grad_tol": case["grad_tol"],
                    "fault_shifted_start_rel_l2_max": max(case["dw_fault_shifted_start"]),
                    "fault_row_tile_rel_l2_max": max(case["dw_fault_row_tile"]),
                })
            else:
                agree = case[k]
                entry.update({
                    "max_abs_err": agree["max_abs_err"], "atol_share": case["atol_share"],
                    "rtol": case["rtol"], "atol_share_needed": agree["atol_share_needed"],
                    "fault_atol_share_needed": agree["fault_atol_share_needed"],
                })
            kernels.append(entry)
    # K10/K11: per case, one entry per wrapper, with the kernels the case
    # launched (``kernels``, by symbol; ``kernel_ms`` each one's device ms).
    # K10's ``launches`` is its count on the serve_small path
    # (``launches_train`` on train_small); K11's, on train_small, counts
    # calls, each launching attn_small_bwd_onetile once at 64 tokens.
    small_launches = {"fwd": serve_small["launches"]["small_mha_fwd"],
                      "bwd": train_small["launches"]["small_mha_bwd"]}
    for case in small_checks:
        for key, regime, body, results in (("fwd", "K10", 160, ("out",)),
                                           ("bwd", "K11", 168, ("dq", "dk", "dv"))):
            agree = [case["agreement"][r] for r in results]
            entry = {
                "name": f"small_mha_{key}", "route": "cuda",
                "source": f"{csrc}/attention_small.cu",
                "replaces": f"distributed_training_comparison_tpu/ops/attention_small.py:{body}",
                "regime": regime, "case": case["case"], "dtype": case["dtype"],
                "shape_b_s_h_d": case["shape_b_s_h_d"], "causal": case["causal"],
                "launches": small_launches[key],
                "launches_counted": ("serve_small main path" if key == "fwd"
                                     else "train_small main path") + ", one counter for every case",
                "max_abs_err": max(a["max_abs_err"] for a in agree),
                "atol_share": case["atol_share"], "rtol": case["rtol"],
                "atol_share_needed": max(a["atol_share_needed"] for a in agree),
                "fault_atol_share_needed": case["agreement"]["out" if key == "fwd" else "dk"][
                    "fault_atol_share_needed"],
                "kernels": case["kernels"][key], "kernel_ms": case["kernel_ms"][key],
                "ms": case["ms"][key], "event_ms": case["event_ms"][key],
                "plain_ms": case["plain_ms"][key],
                "bound_ms": case["bound_ms"][key], "bound_by": case["bound_by"][key],
                "library_ms": case["library_ms"][key], "library": case["library"],
            }
            if key == "fwd":
                entry["launches_train"] = train_small["launches"]["small_mha_fwd"]
            else:
                entry.update({
                    "library_fwd_bwd_ms": case["library_ms"]["fwd_bwd"],
                    "bit_identical_across_calls": case["k11_bit_identical_across_calls"],
                })
            kernels.append(entry)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


def small_output_hashes(small) -> dict[str, str]:
    """sha256 of K10's output and K11's gradients at each bf16 case of
    ``SMALL_CASES`` on seeded inputs: two checkouts whose kernels compute
    bit-identical results print the same digests."""
    import hashlib

    import torch

    gen = torch.Generator().manual_seed(11)
    out = {}
    for label, dname, b, s, h, d, causal in SMALL_CASES:
        if dname != "bfloat16":
            continue
        q, k, v, do = (torch.randn((b * s, h * d), generator=gen).to(device="cuda", dtype=torch.bfloat16)
                       for _ in range(4))
        kw = dict(seq=s, heads=h, causal=causal)
        for key, res in (("fwd", [small.small_mha_fwd(q, k, v, **kw)]),
                         ("bwd", list(small.small_mha_bwd(q, k, v, do, **kw)))):
            digest = hashlib.sha256()
            for t in res:
                digest.update(t.view(torch.int16).cpu().numpy().tobytes())
            out[f"{label}: {key}"] = digest.hexdigest()[:16]
    return out


def moe_dispatch(csrc: Path | None = None, reps: int = 20) -> dict:
    """One bucket-32 batch of the ``serve_moe`` command's engine (gmm, bf16)
    as the serve path dispatches it: host ms a dispatch (median of ``reps``
    after one warm-up, twice), and its profile (``moe_dispatch_profile``)."""
    import statistics

    from distributed_training_comparison_tpu_torch.config import load_config
    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    hp = load_config(SERVE_MOE_ARGV)
    images = request_pool(32, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    engine = build_engine(hp)
    out = {}
    for rnd in ("", "_again"):
        engine.predict_logits(images)
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            engine.predict_logits(images)
            samples.append((time.perf_counter() - t0) * 1e3)
        out[f"bucket32_batch_ms{rnd}"] = statistics.median(samples)
    out["bucket32_profile"] = moe_dispatch_profile(engine, images, csrc)
    return out


def turn(checkout: Path, label: str) -> int:
    """One turn of a comparison of checkouts in one call: the port of
    ``checkout`` (put first on ``sys.path``; this tree or a parent unpacked
    by ``git archive``) built and driven through this script's timing
    functions: the fused block chains (``fused_block_checks``,
    ``fused_block_bwd_checks``), the ``train_tiny`` step and the bucket-32
    dispatch (``tiny_step_times``, ``tiny_dispatch``), K10/K11
    (``small_attention_checks``) and digests of their results
    (``small_output_hashes``), K7-K9 through their wrappers
    (``moe_gmm_checks``), the ``vit_moe`` train step (``moe_step_times``)
    and its bucket-32 dispatch (``moe_dispatch``).  Run parent, this tree,
    this tree, parent:

        python3 chip_smoke.py --turn PARENT_DIR parent

    It writes every record to ``chiprun_out/turns/<label>.json`` and prints
    a summary line; it checks nothing, so that a parent's kernels, whose
    symbols this script does not hold, are timed as they are."""
    import torch

    checkout = checkout.resolve()
    sys.path.insert(0, str(checkout))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    from distributed_training_comparison_tpu_torch.ops import _build

    if not Path(_build.__file__).resolve().is_relative_to(checkout):
        raise RuntimeError(f"the port imported from {_build.__file__}, not from {checkout}")
    vb = importlib.import_module(f"{PKG}.ops.vit_block")
    small = importlib.import_module(f"{PKG}.ops.attention_small")
    gm = importlib.import_module(f"{PKG}.ops.moe_gmm")
    csrc = checkout / PKG / "ops" / "csrc"
    _build.build_all()
    # the attention stages at the train shape (B 128), timed whatever their
    # kernels' symbols: K6's recompute (the forward) and its backward
    gen = torch.Generator().manual_seed(12)
    qkv = torch.randn((128 * 256, 576), generator=gen).to(device="cuda", dtype=torch.bfloat16)
    do = torch.randn((128 * 256, 192), generator=gen).to(device="cuda", dtype=torch.bfloat16)
    b128 = {"block_attention_ms": timed(lambda: vb.block_attention(qkv, seq=256, heads=3))[0],
            "block_attention_bwd_ms": timed(lambda: vb.block_attention_bwd(qkv, do, seq=256, heads=3))[0]}
    del qkv, do
    rec = {"turn": label, "checkout": str(checkout), "nvidia_smi": smi, "attention_b128": b128,
           "fused_block_checks": fused_block_checks(vb),
           "fused_block_bwd_checks": fused_block_bwd_checks(vb),
           "tiny_step_times": tiny_step_times(), "tiny_dispatch": tiny_dispatch(),
           "small_attention_checks": small_attention_checks(small),
           "small_output_hashes": small_output_hashes(small),
           "moe_gmm_checks": moe_gmm_checks(gm), "moe_step_times": moe_step_times(csrc=csrc),
           "moe_dispatch": moe_dispatch(csrc)}
    serve, train = rec["fused_block_checks"][0], rec["fused_block_bwd_checks"][0]
    step, disp = rec["tiny_step_times"], rec["tiny_dispatch"]["bucket32_profile"]
    moe_step, moe_disp = rec["moe_step_times"], rec["moe_dispatch"]
    summary = {
        "turn": label, "nvidia_smi": smi,
        "k5_serve_chain_ms": serve["chain"]["ms"],
        "block_attention_serve_ms": serve["attention"]["ms"],
        "block_attention_serve_sdpa_ms": serve["attention"]["library_ms"],
        "block_attention_serve_kernels": serve["attention"].get("kernels"),
        "k6_chain_ms": train["chain_ms"],
        "block_attention_b128_ms": b128["block_attention_ms"],
        "block_attention_bwd_b128_ms": b128["block_attention_bwd_ms"],
        "block_attention_bwd_sdpa_fwd_bwd_ms": train["stages"]["block_attention_bwd"]["library_ms"],
        "train_tiny_busy_ms": step["profile"]["device_busy_ms_per_step"],
        "train_tiny_idle_share": step["profile"]["device_idle_share"],
        "train_tiny_images_per_s": [step["images_per_s_fused"], step["images_per_s_fused_again"]],
        "bucket32_ms": [rec["tiny_dispatch"]["bucket32_batch_ms_fused"],
                        rec["tiny_dispatch"]["bucket32_batch_ms_fused_again"]],
        "bucket32_busy_ms": disp["device_busy_ms_per_batch"],
        "bucket32_idle_share": disp["device_idle_share"],
        "k10_k11_ms": {c["case"]: [c["ms"]["fwd"], c["ms"]["bwd"]] for c in rec["small_attention_checks"]},
        "small_output_hashes": rec["small_output_hashes"],
        "k7_k8_k9_ms": {c["case"]: [c["ms"]["fwd"], c["ms"]["dx"], c["ms"]["dw"]] for c in rec["moe_gmm_checks"]},
        "k7_k8_k9_kernels": {c["case"]: c["kernels"] for c in rec["moe_gmm_checks"]},
        "moe_gmm_checks_ok": {c["case"]: c["ok"] for c in rec["moe_gmm_checks"]},
        "moe_train_busy_ms": moe_step["profile_gmm"]["device_busy_ms_per_step"],
        "moe_train_idle_share": moe_step["profile_gmm"]["device_idle_share"],
        "moe_train_kernels_ms": moe_step["profile_gmm"]["moe_kernels"],
        "moe_train_images_per_s": [moe_step["images_per_s_gmm"], moe_step["images_per_s_gmm_again"]],
        "moe_train_gather_busy_ms": moe_step["profile_gather"]["device_busy_ms_per_step"],
        "moe_bucket32_ms": [moe_disp["bucket32_batch_ms"], moe_disp["bucket32_batch_ms_again"]],
        "moe_bucket32_busy_ms": moe_disp["bucket32_profile"]["device_busy_ms_per_batch"],
        "moe_bucket32_idle_share": moe_disp["bucket32_profile"]["device_idle_share"],
        "moe_bucket32_k7_ms": moe_disp["bucket32_profile"]["k7_device_ms_per_batch"],
    }
    out = ROOT / "chiprun_out" / "turns"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{label}.json").write_text(json.dumps(rec, indent=1))
    emit(summary)
    return 0


if __name__ == "__main__":
    try:
        if len(sys.argv) == 4 and sys.argv[1] == "--turn":
            sys.exit(turn(Path(sys.argv[2]), sys.argv[3]))
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
