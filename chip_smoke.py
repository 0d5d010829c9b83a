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
             backward's kernels, of the short-sequence attention's (the
             one-tile, tiled bf16 and 3xTF32 kernels) and of
             the fused block chains' bf16 GEMMs (``block_gemm_wgmma``,
             ``dgrad_wgmma``, ``wgrad_wgmma``) and attention kernels
             (``block_attn_wgmma``, ``attn_dq_wgmma``, ``attn_dkv_wgmma``),
             their fp32 (3xTF32) GEMMs (``block_gemm_tf32x3``,
             ``dgrad_tf32x3``, ``wgrad_tf32x3``) and attention kernels
             (``block_attn_tf32x3``, ``block_attn_dq_tf32x3``,
             ``block_attn_dkv_tf32x3``, each at head dims 64 and 128) and
             of the grouped expert FFN's bf16 kernels
             (``moe_ffn_fwd_wgmma``, ``moe_ffn_dx_wgmma``,
             ``moe_ffn_dw_wgmma``) and fp32 (3xTF32) K7, K8 and K9
             (``moe_ffn_fwd_tf32x3``, ``moe_ffn_dx_tf32x3``,
             ``moe_ffn_dw_tf32x3``) and of K6's LayerNorm kernels
             (``ln_rows``, ``ln_bwd``, every instantiation) (``ptxas -v``; a
             bf16 flash kernel, a short-sequence kernel, a fused block GEMM,
             attention (bf16 or fp32) or LayerNorm kernel or an expert FFN
             kernel that
             spills fails the run) and each such kernel's dynamic shared memory at the
             main paths' shapes;
3. kernel checks — each kernel against its plain PyTorch version on the
             card, at the shapes of the serve and train paths (bf16 and
             fp32) and the other regimes it covers, with the tolerance
             stated beside each and held against a planted fault it must
             reject; CUDA-event times of the kernel, the plain version and
             the one-call library yardstick: the flash-attention forward
             (K1/K2, with TFLOP/s and the bound's share of its time; a
             bf16 case whose S ends inside a 128-row tile; fp32 at
             ``train_long_fp32``'s shape, ragged causal at D 64 and at
             S 16384; the kernel each call launched by symbol, bf16
             ``flash_fwd_bf16``, fp32 the 3xTF32 ``flash_fwd_tf32x3``), then its dq
             (K3) and dk/dv (K4) kernels (bf16 and fp32 cases at the
             tiles' edges, each replayed for bit-identical gradients, the
             kernels each wrapper launched by symbol: bf16
             ``flash_bwd_dq_bf16`` / ``flash_bwd_dkv_bf16``, fp32 the 3xTF32
             ``flash_bwd_dq_tf32x3`` / ``flash_bwd_dkv_tf32x3``; SDPA's
             backward kernels by name beside its time), then the
             fused ViT block chain (K5: ``block_gemm`` x 4 and
             ``block_attention``) against ``fused_vit_block_reference``,
             stage by stage and whole, each launch's kernels by symbol
             (bf16: ``block_gemm_wgmma`` and ``block_attn_wgmma`` alone;
             fp32: ``block_gemm_tf32x3`` and ``block_attn_tf32x3`` alone;
             fp32 at the serve shape and at a ragged S),
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
             results across two calls, ``block_grad_reduce`` bit for bit
             against an in-order fp32 sum, the LayerNorm kernels
             (``ln_rows``, ``ln_bwd``) bit for bit across two calls and
             ``ln_bwd``'s dβ partials against the in-order sum of its
             schedule, the kernels each wrapper ran by
             symbol (the GEMMs' and the attention's the dtype's only; bf16
             ``attn_dq_wgmma`` then ``attn_dkv_wgmma``, fp32
             ``block_attn_dq_tf32x3`` then ``block_attn_dkv_tf32x3``; fp32
             at the train shape and at a ragged S), with the composed
             block's autograd forward and backward as its library
             yardstick; then ``block_ln_checks``: the LayerNorm kernels
             at edge shapes (1 to 1000 rows, n 16 to 1024, bf16 and fp32)
             against their plain versions, replayed, against the dβ
             order, and a NaN in x or dln landing where the plain versions
             put it; then ``fp32_nan_checks``: a NaN in one element of
             x reaches the fp32 chains' outputs (K5's out, K6's dx and
             gradients) exactly where it reaches the plain versions';
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
             and fp32, and in each a bucket-32 dispatch is timed fused and
             with ``--block-fusion off`` and profiled (``dispatch_times``;
             its port GEMM and attention by symbol must be bf16's
             ``block_gemm_wgmma`` and ``block_attn_wgmma`` alone, fp32's
             ``block_gemm_tf32x3`` and ``block_attn_tf32x3`` alone);
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
   train_long_fp32 — the same entry and model at the default precision
             (no ``--amp``: fp32), batch 16, one epoch of 3 steps: every
             block's forward through the 3xTF32 K1 and its backward
             through the 3xTF32 K3/K4 (launches 8 x steps, and by symbol
             in a step profile, no bf16 flash kernel), every loss finite,
             no step skipped; ms per step,
             peak memory and the step profile's split (flash forward, dq,
             dk/dv, GEMMs, the rest) with the device idle share;
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
   train_tiny_fp32 — the same model through ``entry.run`` at the default
             precision (no ``--amp``: fp32), batch 128, full width and
             depth, one epoch of 3 steps and one validation batch: every
             block's forward through the fp32 K5 chain and its backward
             through the fp32 K6 chain (the launch counters of every
             wrapper checked against the chain, and by symbol in a step
             profile the 3xTF32 kernels alone: no SIMT or bf16 GEMM or
             attention kernel), every loss finite, no step skipped; ms per
             step, images/s, peak memory, the idle share and the busy time
             split into the K5 kernels, the K6 kernels, the LayerNorm and
             sum kernels and the rest;
6. vit_moe  — ``moe_gmm_checks``: the grouped expert FFN's kernels (K7
             forward, K8 dx, K9 dW) against their plain versions at the
             serve shape (n 2048, cap 320), the train shape (n 16384, cap
             2560) and a ragged case (n 1000: an empty group, two over
             capacity, the last ending at n), each in bf16 and fp32: kept
             rows to a per-row tolerance, dropped and padding rows exactly
             0, the gradients per leaf, K7/K8/K9 bit-identical across two
             calls, two planted faults rejected (a start shifted by a row, a
             row tile left out of K9's walk), in fp32 a NaN in one element
             of x reaching K7's and K8's row and K9's gradients, and one in
             dy reaching K8's row, as in the plain versions, and the drift
             of K7's y, K8's dx and K9's gradients against fp64 sums, the
             kernels each wrapper ran by symbol (bf16:
             ``moe_ffn_fwd_wgmma``, ``moe_ffn_dx_wgmma``,
             ``moe_ffn_dw_wgmma``; fp32: the 3xTF32 ``moe_ffn_fwd_tf32x3``,
             ``moe_ffn_dx_tf32x3`` and ``moe_ffn_dw_tf32x3``),
             device ms under the profiler (and
             CUDA-event ms) of each kernel, its plain version and the
             composed cuBLAS form of the gather dispatch (its forward, its
             backward for dx alone with the forward it recomputes, and its
             whole backward);
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
             the plain kernels with a bound that rejects a planted fault;
             ms per step under gmm and gather, profiles, the gmm step's
             expert FFN kernels by symbol ``moe_ffn_fwd_wgmma`` (K7),
             ``moe_ffn_dx_wgmma`` (K8) and ``moe_ffn_dw_wgmma`` (K9) alone,
             each with device time;
   train_moe_fp32 — ``vit_moe --moe-dispatch gmm`` at the default precision
             (no ``--amp``: fp32), batch 256, one epoch of 3 steps and one
             validation batch through ``entry.run``: K7 in every forward,
             K8 and K9 in every backward, the same checks as train_moe, the
             one-step check in fp32 (2^-13, with a TF32 control that must
             exceed it), the step profile's expert FFN kernels by symbol
             ``moe_ffn_fwd_tf32x3``, ``moe_ffn_dx_tf32x3`` and
             ``moe_ffn_dw_tf32x3`` alone, each one's share of the busy time
             (K8's also on the phase's line);
   moe_fp32_dispatch — one bucket-32 batch of ``vit_moe --moe-dispatch gmm``
             in fp32: its logits against ``--moe-dispatch gather`` within
             2^-13 of the largest, which a planted K7 fault exceeds; both
             dispatches timed and profiled; no SIMT K7, K8 or K9 launched
             anywhere in the run (every profile's kernels);
7. vit_tiny at 64 tokens — ``small_attention_checks``: the short-sequence
             attention's kernels (K10 forward, K11 backward; bf16 at S <= 64
             one wgmma kernel each way, longer items and fp32 a forward
             kernel and a dq, then dk/dv, pair) against their plain
             versions at the serve shape (bf16, B 32, S 64, 3 heads of 64),
             the train shape (bf16 and fp32, B 256), a ragged causal case
             (S 24), one tile at head dim 128 (causal), a ragged one-tile
             case (S 40), a causal multi-tile case (S 256, head dim 128),
             ``vit_small --patch-size 2``'s serve and train shapes (bf16,
             B 32 and 128, S 256, 6 heads of 64: the tiled wgmma kernels)
             and a causal S of 328 at head dims 64 and 128 (past the keys a
             block holds: two sweeps):
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
   train_small_fp32 — the same model at the default precision (fp32),
             batch 256, 3 steps and one eval batch: the 3xTF32 K10/K11
             alone by symbol, ms per step, busy and idle shares;
   serve_vits_p2 — ``vit_small --patch-size 2 --amp`` (12 blocks, dim 384,
             6 heads of 64, 256 tokens) pinned to ``fused_small`` and served
             the same way, buckets 1..32, 128 requests at concurrency 32: K10
             in every block of every dispatched batch and no other kernel
             (counters, and by symbol in the bucket-32 profile:
             ``attn_small_fwd_bf16`` alone); the bucket-32 logits against
             ``attn_impl="reference"`` within 2^-6 of the largest, which a
             planted K10 fault (the last 64 keys' values zeroed) exceeds; a
             bucket-32 dispatch timed under fused_small and auto, profiled;
   train_vits_p2 — the same model trained at batch 128 through
             ``Trainer(hparams, model=build_model(hparams,
             attn_impl="fused_small"))``, 6 steps and one eval batch: K10 in
             every block of every step and eval batch, K11 in every block of
             every step, no other kernel (counters, and by symbol in the
             step profile: ``attn_small_fwd_bf16``, ``attn_small_dq_bf16``,
             ``attn_small_dkv_bf16`` alone), every loss finite, no step
             skipped; one step's loss and gradients against the reference
             attention and the plain kernels with ``train_small``'s bf16
             bounds, which a planted fault exceeds; ms per step under
             fused_small and auto by CUDA events, busy and idle shares and
             the busy time split into K10, K11, the GEMMs and the rest;
  serve_resnet — ``resnet18 --amp`` (the entry point's default model; no
             kernel of the port: cuDNN's convolutions) served through the
             library entry points, buckets 1..32, 128 requests at
             concurrency 32: no port kernel launched (counters); one
             dispatch of each bucket's size timed and profiled (bucket 32's
             busy ms and idle share); the bucket-32 logits against an fp32
             engine on the same weights within a bf16 bound a planted fault
             (a BatchNorm's running variance zeroed) exceeds;
  train_resnet — ``resnet18 --amp`` at batch 128 through ``entry.run``, 6
             steps and one eval batch: every loss finite, no step skipped, no
             port kernel launched; one step's loss and gradients against an
             fp32 step on the same weights and batch within bf16 bounds a
             planted fault (a BatchNorm on its running statistics) exceeds;
             ms per step by CUDA events, busy and idle share, busy split
             into convolutions, BatchNorm, the optimizer and the rest, the
             operation bound's share; the running statistics moved, eval
             mode read them; one step of ``resnet50 --stem imagenet
             --image-size 224 --remat`` at batch 32, its running statistics
             those of the step without ``--remat``;
  train_resnet_fp32 — the entry point with no ``--model`` and no
             ``--amp`` (ResNet-18, fp32), batch 128, 3 steps and one eval
             batch, cuDNN set to TF32 first: the entry path pins fp32 math
             back (the settings read ``ieee``, no profiled kernel holds
             ``tf32``); the first batch's logits and one step's gradients
             against the port's CPU path within fp32 bounds a TF32 control
             exceeds; ms per step against the fp32 operation bound;
8. step_program — every train and serve phase above already runs the step
             program (CUDA graphs: ``fit``'s replayed step and eval batch,
             the engines' bucket graphs; the launch counts unchanged); this
             phase holds it against eager on each train command
             (``STEP_PROGRAM_TRAIN``): 1 + 3 replayed steps against the same
             body run eagerly from one start, the state bit for bit on the
             first run on every path (the device choice holds cuDNN to its
             deterministic algorithms), the counters moved alike,
             the port's kernels by symbol in one replay those of an eager
             step, each launched on the device as often in one replay as
             in one eager step and as the graph's ledger counts
             (``ledger_against_device``), ms a step by CUDA events and
             busy and idle shares of each, and on ``train_resnet`` and
             ``train_tiny`` the guard and update alone (the flat gradients'
             gather and norm, the flat update and its selects:
             ``guard_update_profile``, busy ms, activities and kernels by
             name against the six passes of the flat parameters' bytes);
             and on a bucket-32 dispatch of
             ``serve_resnet``, ``serve_tiny`` and ``serve_moe`` against the
             engine's eager forward (logits bit for bit, the same launch
             checks, ms a dispatch, busy and idle).  A planted fault in a
             serve phase runs the engine's eager forward
             (``eager_logits``): a bucket graph replays what its capture
             called;
9. host_data — ``--data-mode host``: bf16 ResNet-18, 2 epochs of 4 steps
             of 128, chunks of 3 steps (each epoch ends on a partial
             chunk), a ring of 2 slots, the loader on 2 threads, against
             ``--data-mode device``: the state and every epoch's record bit
             for bit, both steps captured, the ring's host buffers pinned;
             then both modes at 30 steps an epoch (chunks of 8): ms a step
             by the host clock, busy ms a step and idle share, the ring's
             device MB, and one host-mode epoch traced: its pinned copies
             on a stream no kernel ran on, and the share of their time
             that overlapped a kernel;
10. checkpoint — the trainer's files: fp32 ResNet-18 (the entry point with
             no ``--model``) trained 2 epochs straight against 1 epoch and
             then 2 by ``--auto-resume`` in the same version dir, and
             ``vit_tiny --patch-size 2 --amp`` (K5 and K6 in every block of
             the resumed run, by the counters) the same by an explicit
             ``--resume`` into a fresh version dir, cuDNN set to benchmark
             with no determinism before every run (the entry pins it back):
             the final ``last.ckpt`` payloads (parameters, batch
             statistics, momentum, step) and every epoch's losses bit for
             bit; the straight ResNet run's ``--contain-test`` metrics
             equal to an eval of the best file it names loaded into a
             fresh trainer; ``--serve --serve-ckpt <best>`` through the
             entry point, and a bucket-32 batch's logits from engines of
             ``--serve-ckpt`` and of discovery under ``--ckpt-path`` bit for
             bit those of an engine on the trainer's in-memory weights; the
             ResNet-18 best and last files' MB, the device snapshot's ms
             (one copy of the flat state buffers),
             its device-to-host copy and each file's serialize and write
             seconds, and an epoch's seconds alone and with a ``last.ckpt``
             save in flight on the writer thread;
11. the ``{"kernels": [...]}`` line, then the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Every parse of the port's flags gets a ``--ckpt-path`` of its own under one
temporary directory (``run_dir``), removed at exit: runs write their
version dirs there, and no serve path discovers another path's checkpoint.

``python3 chip_smoke.py --turn CHECKOUT LABEL`` instead times one checkout
of the port (this one or a parent unpacked beside it) through the same
functions, for comparisons made in turns within one call (``turn``), and
``python3 chip_smoke.py --step-program`` (or ``--host-data``, or
``--checkpoint``, or any of them together) builds the kernels and runs
those phases alone.

It imports nothing of JAX.  Without a CUDA device, or outside a checkout of
the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import gc
import importlib
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "distributed_training_comparison_tpu_torch"

# Every parse of the port's flags here gets a ``--ckpt-path`` of its own: a
# fresh directory under one temporary root, removed when the script exits.
# Each run's version dirs, checkpoints, TensorBoard files and experiment.log
# land there, and a serve path discovers no checkpoint another path wrote.
_RUN_ROOT: list[Path] = []


def run_dir() -> str:
    """A fresh directory under the run root (made at the first call)."""
    if not _RUN_ROOT:
        _RUN_ROOT.append(Path(tempfile.mkdtemp(prefix="chip_smoke_runs_")))
        atexit.register(shutil.rmtree, _RUN_ROOT[0], True)
    return tempfile.mkdtemp(dir=_RUN_ROOT[0])


def ckpt_argv(argv: list, ckpt_path: str | None = None) -> list:
    """``argv`` with ``--ckpt-path`` ``ckpt_path``, or a fresh run dir."""
    return [*argv, "--ckpt-path", ckpt_path or run_dir()]


def load_config(argv: list, ckpt_path: str | None = None):
    """The port's ``config.load_config`` of ``ckpt_argv(argv, ckpt_path)``."""
    from distributed_training_comparison_tpu_torch.config import load_config as parse

    return parse(ckpt_argv(argv, ckpt_path))


def run_entry(argv: list, ckpt_path: str | None = None) -> dict:
    """The port's ``entry.run`` of ``ckpt_argv(argv, ckpt_path)``."""
    from distributed_training_comparison_tpu_torch import entry

    return entry.run(ckpt_argv(argv, ckpt_path))

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit
# ("float32": SIMT, no TF32; "tf32": the tensor cores' dense TF32 rate, which
# the 3xTF32 fp32 kernels spend three times on each fp32 product)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12

TRAIN_ARGV = [
    "--model", "vit_long", "--image-size", "256", "--amp", "--synthetic-data",
    "--limit-examples", "160", "--batch-size", "16", "--epoch", "2",
    "--lr-decay-step-size", "1",
]
# the same model trained at the entry point's default precision (no --amp:
# fp32, K1 and the 3xTF32 K3/K4), batch 16, one epoch over 58 synthetic
# training images (3 steps) and 6 validation images
TRAIN_LONG_FP32_ARGV = [
    "--model", "vit_long", "--image-size", "256", "--synthetic-data",
    "--limit-examples", "64", "--batch-size", "16", "--epoch", "1",
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
    peak (``flash_peak``: fp32 as the kernel runs it, three tf32 products
    a product, "operations (3xTF32)") and bytes (each input read once,
    each output written once) over the memory rate.  Causal counts only
    the pairs it needs."""
    import torch

    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * skv)
    flops = 4 * pairs * d
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * h * sq * d + 2 * b * h * skv * d) * item + b * h * sq * 4
    name = str(dtype).removeprefix("torch.")
    t_ops, t_bytes = flops / flash_peak(name), nbytes / PEAK_BYTES
    ops = "operations (3xTF32)" if name == "float32" else "operations"
    return max(t_ops, t_bytes) * 1e3, ops if t_ops >= t_bytes else "bytes"


def flash_peak(dname: str) -> float:
    """FLOP/s of the flash kernels' products at their peak: bf16 at the
    bf16 rate, fp32 as the kernels run them, three tf32 products each
    (3xTF32) at the TF32 rate."""
    return PEAK_FLOPS["tf32"] / 3 if dname == "float32" else PEAK_FLOPS[dname]


# (label, TPU kernel regime, dtype, B, H, S, D, causal, layout), inputs unit normal
KERNEL_CASES = [
    ("slice: vit_long bucket 8", "K1", "bfloat16", 8, 4, 4096, 128, False, "bshd"),
    ("K2 regime: S past the resident-K/V limit", "K2", "bfloat16", 1, 2, 16384, 128, False, "bhsd"),
    ("ragged causal", "K1", "bfloat16", 2, 4, 1030, 64, True, "bhsd"),
    ("fp32", "K1", "float32", 1, 4, 1000, 128, False, "bhsd"),
    ("fp32 serving shape: vit_long bucket 8 without --amp", "K1", "float32", 8, 4, 4096, 128, False, "bshd"),
    ("bf16 tile edges: S 1000 ends inside a 128-row tile", "K1", "bfloat16", 2, 4, 1000, 128, False, "bshd"),
    ("slice: train_long_fp32 step, batch 16", "K1", "float32", 16, 4, 4096, 128, False, "bshd"),
    ("fp32 ragged causal: S 1030 ends inside a 128-row block and a 64-key tile",
     "K1", "float32", 2, 4, 1030, 64, True, "bhsd"),
    ("fp32 K2 regime: S past the resident-K/V limit", "K2", "float32", 1, 2, 16384, 128, False, "bhsd"),
]
# the flash forward's kernel by symbol, per dtype
FORWARD_SYMBOLS = {"bfloat16": ["flash_fwd_bf16"], "float32": ["flash_fwd_tf32x3"]}
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
# differ.  fp32: the kernel runs each product as three tf32 products
# (3xTF32): the dropped small·small term and the rounding of small leave
# 2^-22 relative per operand (tests/test_torch_port_attention_fwd_tf32.py,
# whose sums round to nearest: ~3.6e-6 of a row's rms), the tensor cores'
# truncating sums a little more, each key tile's P·V summed apart; one tf32
# product alone (2e-3 to 2.4e-3 there) fails 2^-10.  lse: summation order
# and exp2.  Each case also holds the tolerance against a planted fault it
# must reject (see ``dropped_rows``).
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
    r"(?:block_gemm|dgrad|wgrad|block_attn|attn_dq|attn_dkv)_wgmma|"
    r"(?:block_attn|block_attn_dq|block_attn_dkv)_tf32x3)ILi(\d+)E(\w*?)EEv"
)
# the kernels that are no templates: the grouped expert FFN's bf16 and fp32
# (3xTF32) ones and the fused block chains' fp32 (3xTF32) GEMMs
_PTXAS_PLAIN_ENTRY = re.compile(
    r"Compiling entry function '\w*?(moe_ffn_(?:fwd|dx|dw)_(?:wgmma|tf32x3)|(?:block_gemm|dgrad|wgrad)_tf32x3)E"
)
# the fused block backward's LayerNorm kernels, ln_rows and ln_bwd<T, G, NV,
# RIF> (lanes a row, vectors a lane, rows in flight), as
# "ln_bwd<bf16,16,3,2>"; the instantiation of every path's rows of 192
_PTXAS_LN_ENTRY = re.compile(
    r"Compiling entry function '\w*?(ln_rows|ln_bwd)I(13__nv_bfloat16|f)Li(\d+)ELi(\d+)ELi(\d+)E"
)
LN_PATH_KERNELS = tuple(f"{k}<{t},16,3,2>" for k in ("ln_rows", "ln_bwd") for t in ("bf16", "f32"))
# the fused block chains' fp32 (3xTF32) kernels, as ptxas_report names them:
# the GEMMs, and the attention's at its two padded head dims
BLOCK_TF32_GEMMS = ("block_gemm_tf32x3", "dgrad_tf32x3", "wgrad_tf32x3")
BLOCK_TF32_ATTENTION = ("block_attn_tf32x3", "block_attn_dq_tf32x3", "block_attn_dkv_tf32x3")
BLOCK_TF32_KERNELS = (*BLOCK_TF32_GEMMS, *(f"{k}<{d}>" for k in BLOCK_TF32_ATTENTION for d in (64, 128)))
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_report(paths, libraries) -> dict:
    """Registers, static shared memory and spill bytes of each Hopper kernel
    instantiation (``_PTXAS_ENTRY``, ``_PTXAS_PLAIN_ENTRY``, ``_PTXAS_LN_ENTRY``)
    of ``libraries``, as ``ptxas -v`` logged them."""
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
            elif m := _PTXAS_LN_ENTRY.search(line):
                t = "f32" if m.group(2) == "f" else "bf16"
                name = f"{m.group(1)}<{t},{m.group(3)},{m.group(4)},{m.group(5)}>"
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
    dynamic shared memory each bf16 flash kernel, each 3xTF32 flash
    kernel and each one-tile kernel asks for at each head dim."""
    report = ptxas_report(paths, ("flash_attention_fwd", "flash_attention_bwd", "attention_small"))
    smem = {
        kernel: build.load(lib, [ctypes.c_int], symbol=symbol)
        for kernel, lib, symbol in (
            ("flash_fwd_bf16", "flash_attention_fwd", "flash_attention_fwd_smem"),
            ("flash_fwd_tf32x3", "flash_attention_fwd", "flash_attention_fwd_tf32x3_smem"),
            ("flash_bwd_dq_bf16", "flash_attention_bwd", "flash_attention_bwd_dq_smem"),
            ("flash_bwd_dkv_bf16", "flash_attention_bwd", "flash_attention_bwd_dkv_smem"),
            ("flash_bwd_dq_tf32x3", "flash_attention_bwd", "flash_attention_bwd_tf32x3_smem"),
            ("flash_bwd_dkv_tf32x3", "flash_attention_bwd", "flash_attention_bwd_tf32x3_smem"),
        )
    }
    onetile = build.load("attention_small", [ctypes.c_int, ctypes.c_int],
                         symbol="attention_small_onetile_smem")
    dynamic = {k: {d: fn(d) for d in (64, 128)} for k, fn in smem.items()}
    for backward, kernel in enumerate(("attn_small_fwd_onetile", "attn_small_bwd_onetile")):
        dynamic[kernel] = {d: onetile(backward, d) for d in (64, 128)}
    tiled = build.load("attention_small", [ctypes.c_int] * 3, symbol="attention_small_tiled_smem")
    for kernel, name in enumerate(("attn_small_fwd_bf16", "attn_small_dq_bf16", "attn_small_dkv_bf16")):
        dynamic[name] = {f"d{d}_s{s}": tiled(kernel, d, s) for d, s in TILED_BUILD_SHAPES}
    return {"kernels": report, "dynamic_smem_bytes": dynamic}


# (head dim, S) the tiled bf16 K10/K11 kernels' dynamic shared memory is
# reported at: the vit_small p2 paths', the multi-tile case's and a long
# item's (the LONG builds)
TILED_BUILD_SHAPES = ((64, 256), (128, 256), (64, 328))


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
    """The fused block's Hopper kernels: the bf16 GEMMs
    (``block_gemm_wgmma``, ``dgrad_wgmma``, ``wgrad_wgmma``, one
    instantiation per tile width) and attention's (``block_attn_wgmma``,
    ``attn_dq_wgmma``, ``attn_dkv_wgmma``, one per count of key tiles), the
    fp32 ones (``BLOCK_TF32_KERNELS``: the 3xTF32 GEMMs and attention):
    registers, static shared memory and spills from ``ptxas -v``, and the
    dynamic shared memory each launch of the main paths asks for (the bf16
    attention's at ``ATTENTION_BUILD_SEQS``; the 3xTF32 GEMMs' is one size,
    the 3xTF32 attention's one a padded head dim)."""
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
    tf32 = build.load("vit_block_fwd", [], symbol="vit_block_gemm_tf32x3_smem")()
    dynamic.update({k: {"any": tf32} for k in BLOCK_TF32_GEMMS})
    tf32_attn = build.load("vit_block_fwd", [i32], symbol="vit_block_attention_tf32x3_smem")
    tf32_attn_bwd = build.load("vit_block_bwd", [i32], symbol="vit_block_attention_bwd_tf32x3_smem")
    for name, fn in zip(BLOCK_TF32_ATTENTION, (tf32_attn, tf32_attn_bwd, tf32_attn_bwd)):
        dynamic[name] = {f"head_dim{d}": fn(d) for d in (64, 128)}
    dynamic["block_attn_wgmma"] = {f"s{s}": attn(s) for s in ATTENTION_BUILD_SEQS}
    for kernel, name in enumerate(("attn_dq_wgmma", "attn_dkv_wgmma")):
        dynamic[name] = {f"s{s}": attn_bwd(kernel, s) for s in ATTENTION_BUILD_SEQS}
    return {"kernels": ptxas_report(paths, ("vit_block_fwd", "vit_block_bwd")),
            "dynamic_smem_bytes": dynamic}


def moe_build_report(build, paths) -> dict:
    """The grouped expert FFN's Hopper kernels (bf16 ``moe_ffn_fwd_wgmma``,
    K7; ``moe_ffn_dx_wgmma``, K8; ``moe_ffn_dw_wgmma``, K9; fp32
    ``moe_ffn_fwd_tf32x3``, ``moe_ffn_dw_tf32x3``): registers,
    static shared memory and spills from ``ptxas -v``, and the dynamic
    shared memory each launch asks for (fixed: it does not depend on the
    shape)."""
    smem = {kernel: build.load(lib, [], symbol=f"{kernel}_smem")()
            for kernel, lib in (("moe_ffn_fwd_wgmma", "moe_gmm_fwd"), ("moe_ffn_dx_wgmma", "moe_gmm_bwd"),
                                ("moe_ffn_dw_wgmma", "moe_gmm_bwd"))}
    return {"kernels": ptxas_report(paths, ("moe_gmm_fwd", "moe_gmm_bwd")), "dynamic_smem_bytes": smem}


def kernel_checks(attn, csrc: Path | None = None) -> list[dict]:
    """K1/K2 against ``mha_reference`` at ``KERNEL_CASES``: agreement within
    ``TOLERANCES``, the planted fault, the kernels each call launched by
    symbol (``csrc``'s, this checkout's by default; ``FORWARD_SYMBOLS``
    alone), and CUDA-event times of the kernel, the plain version and
    SDPA."""
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
        launched = sorted(_port_kernel_ms(profile_device(
            lambda: attn.flash_attention(qt, kt, vt, causal=causal), 1)["device_ms_by_name"], csrc=csrc))
        ok = (
            share <= atol_share < fault_share
            and err_lse <= tol_lse
            and math.isfinite(err + err_lse)
            and launched == FORWARD_SYMBOLS[dname]
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
            "kernels": launched,
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
    dsᵀ·Q) on the card: operations over the peak against bytes (q, k, v,
    dO, lse and adj read once, the gradients written once) over the memory
    rate, the products at ``flash_peak`` ("operations (3xTF32)" for
    fp32).  Causal counts only the pairs it needs."""
    import torch

    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * skv)
    products, outs = (3, 1) if kernel == "dq" else (4, 2)
    flops = 2 * products * pairs * d
    item = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * h * sq * d + 2 * b * h * skv * d + outs * b * h * skv * d) * item
    nbytes += 2 * b * h * sq * 4
    name = str(dtype).removeprefix("torch.")
    t_ops, t_bytes = flops / flash_peak(name), nbytes / PEAK_BYTES
    ops = "operations (3xTF32)" if name == "float32" else "operations"
    return max(t_ops, t_bytes) * 1e3, ops if t_ops >= t_bytes else "bytes"


# (label, dtype, B, H, S, D, causal, layout, with a non-zero dlse), inputs
# unit normal; the first is one block's attention in the train step (batch
# 16: bh 64), the second the same in train_long_fp32's step, "fp32 train
# step shape" the fp32 step check's (batch 2: bh 8)
BACKWARD_CASES = [
    ("slice: vit_long train step, batch 16", "bfloat16", 16, 4, 4096, 128, False, "bshd", False),
    ("slice: train_long_fp32 step, batch 16", "float32", 16, 4, 4096, 128, False, "bshd", False),
    ("ragged causal, dlse", "bfloat16", 2, 4, 1030, 64, True, "bhsd", True),
    ("bf16 tile edges: S 1000, a multiple of neither 128 keys nor 64 queries",
     "bfloat16", 2, 4, 1000, 128, False, "bshd", False),
    ("bf16 causal S 257 at D 64, dlse", "bfloat16", 2, 2, 257, 64, True, "bshd", True),
    ("fp32, dlse", "float32", 1, 4, 1000, 128, False, "bhsd", True),
    ("fp32 train step shape: batch 2 without --amp", "float32", 2, 4, 4096, 128, False, "bshd", False),
    ("fp32 ragged causal, dlse", "float32", 2, 4, 1030, 64, True, "bhsd", True),
]
# Each gradient holds against the plain backward per row (one query's dq,
# one key's dk or dv): |kernel - plain| <= atol_share * rms(row) +
# rtol * |plain|, with the forward's TOLERANCES.  Why they hold: the kernel
# and the plain version compute the same fp32 scores, p, dp and ds and
# round p and ds to bf16 at the same points, so they differ by fp32
# summation order (~1e-6 relative), by the rare bf16 rounding flip that
# difference causes in p or ds (2^-8 on one term of a sum of S), and by
# one bf16 rounding of each gradient (<= 2^-8 |x|, held by rtol 2^-6);
# 2^-5 of the row's rms leaves room for the flips.  fp32: the kernels run
# each product as three tf32 products (3xTF32): the dropped small·small
# term and the rounding of small leave 2^-22 relative per operand
# (tests/test_torch_port_attention_tf32.py, whose sums round to nearest:
# ~5e-6 of the row's rms).  The tensor cores round each accumulation
# toward zero, which that emulation leaves out: on an H100 the kernels
# need 1.4e-5 to 5.4e-5 of a row's rms on these cases' inputs, and on
# other seeded inputs up to 4.4e-4 for dq in the ragged causal D 64 case
# (rows whose dS terms cancel).  So 2^-10 (9.8e-4) leaves about 2x there,
# and one tf32 product alone (3e-3 to 3e-2) fails it.  The planted faults:
# dq with the first FAULT_KEYS keys left out of its sum, dk/dv with the
# first FAULT_KEYS queries left out of theirs; each must need more than
# the tolerance.  Each kernel owns its output rows and sums in a fixed
# order (no atomics), so a second call on the same inputs must give
# bit-identical gradients.


# the kernels each backward wrapper launches, by symbol, per dtype
BACKWARD_SYMBOLS = {
    "bfloat16": {"dq": ["flash_bwd_dq_bf16"], "dkv": ["flash_bwd_dkv_bf16"]},
    "float32": {"dq": ["flash_bwd_dq_tf32x3"], "dkv": ["flash_bwd_dkv_tf32x3"]},
}


def backward_checks(attn, csrc: Path | None = None) -> list[dict]:
    """K3 and K4 against ``flash_attention_bwd_reference`` at
    ``BACKWARD_CASES``: agreement, the planted faults, a bitwise replay, the
    kernels each wrapper launched by symbol (``csrc``'s, this checkout's by
    default) and the SDPA yardstick's by name, and times."""
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
        del fault_dq, fault_dkv
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
        # one call of each under the profiler: which kernels ran
        launched = {
            kernel: sorted(_port_kernel_ms(profile_device(fn, 1)["device_ms_by_name"], csrc=csrc))
            for kernel, fn in (
                ("dq", lambda: attn.flash_attention_dq(qt, kt, vt, dot, lse, adj, **kw)),
                ("dkv", lambda: attn.flash_attention_dkv(qt, kt, vt, dot, lse, adj, **kw)),
            )
        }
        sdpa = profile_device(sdpa_fwd_bwd, 1)["device_ms_by_name"]
        library_kernels = {
            name[:100]: ms for name, ms in sorted(sdpa.items(), key=lambda kv: -kv[1])[:6]
        }
        # the yardstick's own gradients against the plain version (no lse
        # cotangent in SDPA: cases without one), by the same per-row measure
        library_share = None
        if not with_dlse:
            lib_grads = torch.autograd.grad(sdpa_fwd(), (ql, kl, vl), dot)
            library_share = {
                name: atol_share_needed(got, ref, rtol)
                for name, got, ref in zip(("dq", "dk", "dv"), lib_grads, want)
            }
            del lib_grads
        del want
        ok = ok and launched == BACKWARD_SYMBOLS[dname]
        bound = {
            kernel: backward_bound(b, h, s, s, d, causal, dtype, kernel)
            for kernel in ("dq", "dkv")
        }
        pair_floor_ms = 2 * 5 * b * h * s * s * d / flash_peak(dname) * 1e3
        out.append({
            "case": label, "dtype": dname, "layout": layout, "shape": [b, h, s, d],
            "causal": causal, "dlse": with_dlse, "atol_share": atol_share, "rtol": rtol,
            "grads": grads, "bit_identical_across_calls": bit_identical, "ok": ok,
            "dq_ms": dq_ms, "dkv_ms": dkv_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "kernels": launched,
            "library_kernels_ms_fwd_bwd": library_kernels,
            "library_atol_share_needed": library_share,
            "dq_bound_ms": bound["dq"][0], "dq_bound_by": bound["dq"][1],
            "dkv_bound_ms": bound["dkv"][0], "dkv_bound_by": bound["dkv"][1],
            "pair_floor_ms_with_atomic_dq": pair_floor_ms,
        })
        del q, k, v, do, qt, kt, vt, dot, o, lse, adj, dq, dk, dv, ql, kl, vl
        torch.cuda.empty_cache()
    return out


def bound(flops: float, nbytes: float, dname: str, tf32x3: bool = False) -> tuple[float, str]:
    """Least time in ms: operations over the dtype's peak against bytes over
    the memory rate, and which of the two bounds it.  ``tf32x3``: the
    kernel runs fp32 products as three tf32 products each (``flash_peak``,
    "operations (3xTF32)")."""
    peak = flash_peak(dname) if tf32x3 else PEAK_FLOPS[dname]
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    ops = "operations (3xTF32)" if tf32x3 and dname == "float32" else "operations"
    return max(t_ops, t_bytes) * 1e3, ops if t_ops >= t_bytes else "bytes"


def block_bounds(b, s, dim, heads, hidden, dname) -> dict[str, tuple[float, str]]:
    """Bounds of one fused block (K5) on the card: the whole chain, the four
    ``block_gemm`` launches together and ``block_attention``.  Each
    function's inputs are read once and its outputs written once: the chain
    reads x and the fp32 parameters and writes out; each GEMM launch reads
    its A, residual and parameters and writes its C; attention reads qkv
    and writes o.  fp32's products are the 3xTF32 kernels': three tf32
    products each at the TF32 rate."""
    rows, item = b * s, 2 if dname == "bfloat16" else 4
    params = (4 * dim * dim + 2 * dim * hidden + 9 * dim + hidden) * 4
    gemm_flops = 2 * rows * (4 * dim * dim + 2 * dim * hidden)
    attn_flops = 4 * rows * s * dim
    # (x in, qkv out), (o, x in, r1 out), (r1 in, hmid out), (hmid, r1 in, out)
    gemm_act = rows * (4 * dim + 3 * dim + dim + hidden + hidden + 2 * dim)
    return {
        "chain": bound(gemm_flops + attn_flops, 2 * rows * dim * item + params, dname, True),
        "gemm": bound(gemm_flops, gemm_act * item + params, dname, True),
        "attention": bound(attn_flops, 4 * rows * dim * item, dname, True),
    }


# (label, dtype, B, S, dim, heads); mlp ratio 4.  The first two are one
# block of the vit_tiny --patch-size 2 serve path at bucket 32 (bf16 with
# --amp, fp32 without), then a ragged S (a multiple of 8, not of 64) and
# the top of the gate's 128-512 token window, then the ragged S in fp32
# (the 3xTF32 kernels' rows and keys cut mid-tile).
BLOCK_CASES = [
    ("slice: vit_tiny p2 serve, bucket 32", "bfloat16", 32, 256, 192, 3),
    ("fp32 serve shape: vit_tiny p2 bucket 32 without --amp", "float32", 32, 256, 192, 3),
    ("ragged S", "bfloat16", 3, 136, 128, 2),
    ("window top: S 512", "bfloat16", 2, 512, 192, 3),
    ("fp32 ragged S", "float32", 3, 136, 128, 2),
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
        chain["digest"] = _digest([got])  # two checkouts' bit-identical chains print the same
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
    (QKᵀ, dO·Vᵀ, Pᵀ·dO, dS·K, dSᵀ·Q).  fp32's products are the 3xTF32
    kernels' (three tf32 products each at the TF32 rate); the LayerNorm and
    sum kernels' elementwise work is at the dtype's rate."""
    rows, item = b * s, 2 if dname == "bfloat16" else 4
    nparams = 4 * dim * dim + 2 * dim * hidden + 9 * dim + hidden
    wparams = 4 * dim * dim + 2 * dim * hidden  # the weight matrices
    gemm_flops = 2 * rows * (4 * dim * dim + 2 * dim * hidden)
    attn_fwd, attn_bwd = 4 * rows * s * dim, 10 * rows * s * dim
    chunks = -(-rows // vb.WGRAD_CHUNK_ROWS)
    ln_chunks = -(-rows // vb.LN_CHUNK_ROWS)
    ln_params = 4 * dim  # the LayerNorms' gamma and beta: block_ln_bwd's partials
    act = lambda *widths: rows * sum(widths) * item  # noqa: E731
    f32 = lambda *widths: rows * sum(widths) * 4  # noqa: E731
    return {
        "chain": bound(gemm_flops + attn_fwd + 2 * gemm_flops + attn_bwd,
                       3 * rows * dim * item + 2 * nparams * 4, dname, True),
        # LN1(x), LN2(r1): a row in, a row out each
        "block_ln": bound(2 * 8 * rows * dim, act(dim, dim, dim, dim) + 4 * dim * 4, dname),
        # qkv (ln1 in, qkv out), proj (o, x in, r1 out), up (ln2 in, up out)
        "block_gemm": bound(2 * rows * (4 * dim * dim + dim * hidden),
                            act(dim, 3 * dim, dim, dim, dim, dim, hidden)
                            + (4 * dim * dim + dim * hidden) * 4, dname, True),
        "block_attention": bound(attn_fwd, act(3 * dim, dim), dname, True),
        # dy·W_dn (dy, up in; dup, hmid out), dup·W_up (dup in, dLN2 fp32 out),
        # dr1c·W_o (in, dO out), dqkv·W_qkv (in, dLN1 fp32 out)
        "block_gemm_dgrad": bound(gemm_flops, act(dim, hidden, hidden, hidden, hidden, dim, dim, 3 * dim)
                                  + f32(dim, dim) + wparams * 4, dname, True),
        # (dLN2 fp32, r1, dy in; dr1 fp32, dr1c out), (dLN1 fp32, x in, dr1 fp32 in; dx out)
        "block_ln_bwd": bound(2 * 12 * rows * dim, act(dim, dim, dim, dim, dim)
                              + f32(dim, dim, dim, dim), dname),
        "block_attention_bwd": bound(attn_bwd, act(3 * dim, dim, 3 * dim), dname, True),
        # (dqkv, ln1), (dr1c, o, dr1 fp32), (dup, ln2), (dy, hmid) in; partials out
        "block_gemm_wgrad": bound(gemm_flops, act(3 * dim, dim, dim, dim, hidden, dim, dim, hidden)
                                  + f32(dim) + chunks * (wparams + 6 * dim + hidden) * 4, dname, True),
        # every partial read once, every sum written once
        "block_grad_reduce": bound(
            chunks * (nparams - ln_params) + ln_chunks * ln_params,
            ((chunks + 1) * (nparams - ln_params) + (ln_chunks + 1) * ln_params) * 4, dname),
    }


# (label, dtype, B, S, dim, heads); mlp ratio 4.  The first two are one
# block of the vit_tiny --patch-size 2 train step at batch 128 (bf16 with
# --amp, fp32 without), then the top of the gate's token window and a
# ragged S with 2 heads (tiles cut by S and dim), in bf16 and in fp32.
BWD_CASES = [
    ("slice: vit_tiny p2 train step, batch 128", "bfloat16", 128, 256, 192, 3),
    ("fp32 train shape: batch 128 without --amp", "float32", 128, 256, 192, 3),
    ("window top: S 512", "bfloat16", 16, 512, 192, 3),
    ("ragged S, dim 128, 2 heads", "bfloat16", 3, 136, 128, 2),
    ("fp32 ragged S, dim 128, 2 heads", "float32", 3, 136, 128, 2),
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


K6_KERNELS = {  # the CUDA kernels' own symbols, by wrapper: bf16's end in _wgmma, fp32's are the others
    "block_ln": ("ln_rows",),
    "block_gemm": ("block_gemm_wgmma", "block_gemm_tf32x3"),
    "block_attention": ("block_attn_wgmma", "block_attn_tf32x3"),
    "block_gemm_dgrad": ("dgrad_wgmma", "dgrad_tf32x3"),
    "block_ln_bwd": ("ln_bwd",),
    "block_attention_bwd": ("attn_dq_wgmma", "attn_dkv_wgmma", "block_attn_dq_tf32x3", "block_attn_dkv_tf32x3"),
    "block_gemm_wgrad": ("wgrad_wgmma", "wgrad_tf32x3"),
    "block_grad_reduce": ("grad_reduce",),
}
# The SIMT fp32 kernels the 3xTF32 ones replaced (the first port's), by
# wrapper: ``kernel_ms`` counts them too, so that ``--turn`` splits a
# parent's fp32 chains by wrapper; no check accepts them.
REPLACED_F32_KERNELS = {
    "block_gemm": ("vit_block_gemm_f32",), "block_attention": ("vit_block_attn_f32",),
    "block_gemm_dgrad": ("dgrad_f32",), "block_attention_bwd": ("attn_dq_f32", "attn_dkv_f32"),
    "block_gemm_wgrad": ("wgrad_f32",),
}
GEMM_WRAPPERS = ("block_gemm", "block_gemm_dgrad", "block_gemm_wgrad")
ATTENTION_WRAPPERS = ("block_attention", "block_attention_bwd")
# every GEMM and attention kernel of the fused block chains
GEMM_SYMBOLS = frozenset(s for w in GEMM_WRAPPERS for s in K6_KERNELS[w])
ATTENTION_SYMBOLS = frozenset(s for w in ATTENTION_WRAPPERS for s in K6_KERNELS[w])


def path_symbols(wrapper: str, dname: str) -> list[str]:
    """The kernels, by symbol, that a GEMM or attention ``wrapper`` of the
    fused block launches in ``dname``: its ``_wgmma`` kernels in bf16, its
    3xTF32 ones in fp32."""
    return sorted(s for s in K6_KERNELS[wrapper] if s.endswith("_wgmma") == (dname == "bfloat16"))
# the profiler's name of a kernel of the vit_block libraries, all defined in
# an anonymous namespace: "[void ](anonymous namespace)::<symbol>[<...>](...)";
# a library kernel (cuDNN's *wgrad*/*dgrad* convolution kernels, ATen's) does
# not match
_KERNEL_SYMBOL = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def kernel_ms(device_ms_by_name: dict, wrappers) -> float:
    """Device ms of the profiled kernels whose symbol is one of the
    ``wrappers``' kernels (``K6_KERNELS``, and ``REPLACED_F32_KERNELS`` for
    a parent's)."""
    symbols = {sym for w in wrappers
               for sym in (*K6_KERNELS[w], *REPLACED_F32_KERNELS.get(w, ()))}
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
    of the same work: cuBLAS products, SDPA, ATen's LayerNorm forward (on
    the compute-dtype rows) and backward (its statistics taken outside the
    timed call), ``torch.sum`` over the chunks of each partial."""
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
    # block_ln's yardstick: F.layer_norm on the rows in the compute dtype
    # (fp32 statistics inside), γ and β cast to it once, outside the timed
    # call, so that it reads and writes the kernel's bytes and no cast
    ln_params = {n: (p[f"{n}.weight"].to(cd), p[f"{n}.bias"].to(cd)) for n in ("ln_attn", "ln_mlp")}
    ln = lambda t, n: lambda: F.layer_norm(t, t.shape[-1:], *ln_params[n], eps=1e-6)  # noqa: E731
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


def in_order_sum(partials):
    """Each (chunks, ...) fp32 partial summed over its chunks in chunk order
    from 0, one fp32 add at a time: the order ``block_grad_reduce``'s kernel
    sums in, so that it must agree bit for bit (the plain version,
    ``torch.sum``, sums in another order)."""
    import functools

    import torch

    return [functools.reduce(torch.add, t.unbind(0), torch.zeros(t.shape[1:], device=t.device))
            for t in partials]


def _digest(tensors) -> str:
    """sha256 of fp32 (or bf16, two to a word) tensors' bits: two
    checkouts whose kernels give bit-identical results print the same
    digest."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.int32).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ln_schedule(csrc: Path) -> dict[str, int] | None:
    """The constants of ``ln_bwd``'s schedule in ``csrc/vit_block_bwd.cu``
    (None for a checkout whose kernel has none, such as a parent's)."""
    text = (csrc / "vit_block_bwd.cu").read_text()
    names = ("kLnThreads", "kLnNarrowMaxN", "kLnNarrowLanes", "kLnNarrowInFlight",
             "kLnWideLanes", "kLnWideInFlight")
    found = {n: re.findall(rf"constexpr int {n} = (\d+);", text) for n in names}
    return {n: int(v[0]) for n, v in found.items()} if all(len(v) == 1 for v in found.values()) else None


def ln_part_b_in_order(dln, chunk: int, csrc: Path):
    """``ln_bwd``'s dβ partials in its own order, by fp32 adds on dln's
    device, which the kernel must equal bit for bit: per chunk and column,
    row group g of the block's kLnThreads / G adds its rows r0 + (t groups
    + g) RIF + k one at a time from 0, then the groups' sums are added in
    group order from 0.  None where the source has no such schedule."""
    import torch

    c = ln_schedule(csrc)
    if c is None:
        return None
    m, n = dln.shape
    narrow = n <= c["kLnNarrowMaxN"]
    lanes = c["kLnNarrowLanes"] if narrow else c["kLnWideLanes"]
    rif = c["kLnNarrowInFlight"] if narrow else c["kLnWideInFlight"]
    groups = c["kLnThreads"] // lanes
    nc = -(-m // chunk)
    d = torch.cat([dln, dln.new_zeros(nc * chunk - m, n)]).view(nc, chunk, n)
    valid = (torch.arange(nc * chunk, device=dln.device) < m).view(nc, chunk, 1)
    total = dln.new_zeros(nc, n)
    for g in range(groups):
        acc = dln.new_zeros(nc, n)
        for t in range(-(-chunk // (groups * rif))):
            for k in range(rif):
                r = (t * groups + g) * rif + k
                if r < chunk:
                    acc = torch.where(valid[:, r], acc + d[:, r], acc)
        total = total + acc
    return total


def k6_stage_checks(vb, x, dy, params, heads, rtol, csrc: Path | None = None) -> dict[str, dict]:
    """Each K6 wrapper on the card against its plain version on the same
    inputs (``k6_stages``), per kernel over its launches in one block
    backward: the least atol share (of each output row's rms) it needs with
    ``rtol``, and the plain version's and the library call's device time;
    ``block_grad_reduce`` also against ``in_order_sum`` bit for bit, with
    digests of its partials and its sums; ``block_ln`` and ``block_ln_bwd``
    also a second call bit for bit, and ``block_ln_bwd``'s dβ partials
    against ``ln_part_b_in_order`` (of ``csrc``, this checkout's by
    default; None for a kernel whose source states no such order)."""
    import torch

    csrc = csrc or ROOT / PKG / "ops" / "csrc"
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
        if name == "block_grad_reduce":
            rec["bit_identical_to_in_order_sum"] = all(
                torch.equal(g, w) for g, w in zip(got, in_order_sum(*args)))
            rec["partials_digest"], rec["digest"] = _digest(args[0]), _digest(got)
        if name in ("block_ln", "block_ln_bwd"):
            again = wrapper(*args, **kw)
            same = all(torch.equal(g, a) for g, a in zip(
                got if isinstance(got, tuple) else [got], again if isinstance(again, tuple) else [again])
                if g is not None)
            rec["bit_identical_across_calls"] = rec.get("bit_identical_across_calls", True) and same
            del again
        if name == "block_ln_bwd":
            mirror = ln_part_b_in_order(args[0], vb.LN_CHUNK_ROWS, csrc)
            key = "part_b_bit_identical_to_in_order_sum"
            rec[key] = None if mirror is None else torch.equal(got[3], mirror) and rec.get(key, True)
        for g, w in pairs:
            rec["max_abs_err"] = max(rec["max_abs_err"], (g.float() - w.float()).abs().max().item())
            rec["atol_share_needed"] = max(rec["atol_share_needed"], atol_share_needed(g, w, rtol))
            rec["finite"] = rec["finite"] and bool(torch.isfinite(g).all())
        rec["plain_ms"] += timed(lambda: plain(*args, **kw), 5)[0]
        rec["library_ms"] += timed(library, 10)[0]
        del got, want, pairs
    return out


def fused_block_bwd_checks(vb, csrc: Path | None = None) -> list[dict]:
    """The K6 chain (``ops/vit_block.py::fused_vit_block_bwd``) against
    ``fused_vit_block_bwd_reference`` at ``BWD_CASES``: dx and each of the
    twelve gradients, the planted faults, bit-identical results across two
    calls, each stage against its plain version (``k6_stage_checks``, with
    ``csrc`` for the LayerNorm backward's dβ order), and the device time of
    the chain and of each kernel (summed over its launches in one chain),
    the CUDA-event time, the plain version's and the library yardstick's."""
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
        digest = _digest([dx, *grads.values()])  # two checkouts' bit-identical chains print the same
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

        stages = k6_stage_checks(vb, x, dy, params, heads, rtol, csrc)
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
            and stages["block_grad_reduce"]["bit_identical_to_in_order_sum"]
            and stages["block_ln"]["bit_identical_across_calls"]
            and stages["block_ln_bwd"]["bit_identical_across_calls"]
            and stages["block_ln_bwd"]["part_b_bit_identical_to_in_order_sum"] is True
        )
        out.append({
            "case": label, "dtype": dname, "shape": [b, s, dim, heads], "rows": rows,
            "atol_share": atol_share, "rtol": rtol, "grad_tol": tol,
            "dx": dx_rec, "grad_errors": errors, "stages": stages,
            "grad_error_max": max(errors.values()),
            "fault_grad_error_max": {k: max(f.values()) for k, f in fault_errors.items()},
            "bit_identical_across_calls": identical, "finite": finite, "digest": digest,
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


# (n, m) of block_ln_checks: the narrowest rows, the zoo's 128 and 192 and
# the widest the kernels take, each at one row, one short of a chunk, a
# chunk and two ragged last chunks (LN_CHUNK_ROWS 128); in bf16 and fp32.
# The NaN goes to row LN_NAN_AT[0], column LN_NAN_AT[1] of x or dln at n 192,
# m 408 (the third of four chunks).
LN_WIDTHS = (16, 128, 192, 1024)
LN_ROWS = (1, 127, 128, 408, 1000)
LN_NAN_AT = (300, 77)


def ln_case_inputs(n: int, m: int, dtype, gen):
    """x (mean and scale off 0 and 1), γ, β, dln and a base (fp32 for an
    even m, as the chain's dr1; the compute dtype for an odd one, as dy)."""
    import torch

    x = (1.5 * torch.randn(m, n, generator=gen) + 0.3).to(device="cuda", dtype=dtype)
    gamma = (1 + 0.1 * torch.randn(n, generator=gen)).cuda()
    beta = (0.1 * torch.randn(n, generator=gen)).cuda()
    dln = torch.randn(m, n, generator=gen).cuda()
    base = torch.randn(m, n, generator=gen).cuda()
    return x, gamma, beta, dln, base if m % 2 == 0 else base.to(dtype)


def block_ln_checks(vb, csrc: Path | None = None) -> list[dict]:
    """``block_ln`` (``ln_rows``) and ``block_ln_bwd`` (``ln_bwd``) at the
    edge shapes (``LN_WIDTHS`` × ``LN_ROWS``) in both dtypes against their
    plain versions within the K6 stage bounds (``TOLERANCES``: the least
    atol share of each output row's rms with the dtype's rtol), one launch a
    call, a second call bit-identical, the dβ partials bit-equal to
    ``ln_part_b_in_order``; then, at n 192 and m 408, a NaN in x and one in
    dln, each of which must make NaN exactly where the plain versions do."""
    import torch

    csrc = csrc or ROOT / PKG / "ops" / "csrc"
    gen = torch.Generator().manual_seed(23)
    out = []
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        atol_share, rtol, _ = TOLERANCES[dname]
        for n in LN_WIDTHS:
            for m in LN_ROWS:
                x, gamma, beta, dln, base = ln_case_inputs(n, m, dtype, gen)
                before = (vb.block_ln.launches, vb.block_ln_bwd.launches)
                got = [vb.block_ln(x, gamma, beta), *vb.block_ln_bwd(dln, x, gamma, base)]
                torch.cuda.synchronize()
                launches = [vb.block_ln.launches - before[0], vb.block_ln_bwd.launches - before[1]]
                want = [vb.block_ln_reference(x, gamma, beta), *vb.block_ln_bwd_reference(dln, x, gamma, base)]
                again = [vb.block_ln(x, gamma, beta), *vb.block_ln_bwd(dln, x, gamma, base)]
                mirror = ln_part_b_in_order(dln, vb.LN_CHUNK_ROWS, csrc)
                needed = max(atol_share_needed(g, w, rtol) for g, w in zip(got, want))
                rec = {
                    "dtype": dname, "n": n, "m": m, "base_f32": base.dtype == torch.float32,
                    "launches": launches, "atol_share": atol_share, "rtol": rtol,
                    "atol_share_needed": needed,
                    "max_abs_err": max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want)),
                    "finite": all(bool(torch.isfinite(g).all()) for g in got),
                    "bit_identical_across_calls": all(torch.equal(g, a) for g, a in zip(got, again)),
                    "part_b_bit_identical_to_in_order_sum": None if mirror is None else torch.equal(got[4], mirror),
                }
                rec["ok"] = (rec["finite"] and launches == [1, 1] and needed <= atol_share
                             and rec["bit_identical_across_calls"]
                             and rec["part_b_bit_identical_to_in_order_sum"] is True)
                out.append(rec)
        for where in ("x", "dln"):
            x, gamma, beta, dln, base = ln_case_inputs(192, 408, dtype, gen)
            (x if where == "x" else dln)[LN_NAN_AT] = float("nan")
            got = [vb.block_ln(x, gamma, beta), *vb.block_ln_bwd(dln, x, gamma, base)]
            torch.cuda.synchronize()
            want = [vb.block_ln_reference(x, gamma, beta), *vb.block_ln_bwd_reference(dln, x, gamma, base)]
            same = [torch.equal(torch.isnan(g), torch.isnan(w)) for g, w in zip(got, want)]
            nans = [int(torch.isnan(g).sum()) for g in got]
            out.append({"dtype": dname, "n": 192, "m": 408, "nan_in": where, "nan_at": list(LN_NAN_AT),
                        "nan_counts": nans, "nan_where_plain_puts_it": same,
                        "ok": all(same) and nans[1] >= 192})
    return out


# (B, S, dim, heads) of the fp32 NaN checks: the ragged case, so that the
# 3xTF32 kernels' masked rows and keys are on the path too; the NaN goes
# to x[ITEM, ROW, COL], bits each of NAN_BITS (the card's canonical NaN,
# a negative one, a signalling one)
NAN_CASE = (3, 136, 128, 2)
NAN_AT = (1, 70, 17)
NAN_BITS = (0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001)


def fp32_nan_checks(vb) -> list[dict]:
    """A NaN in one element of x through the fp32 chains on the card: K5's
    output and K6's dx and twelve gradients must be NaN exactly where the
    plain versions' are and finite everywhere else (the 3xTF32 split keeps
    a NaN as a NaN: big = tf32(x) + x·0; the rounding add alone would carry
    its payload into the exponent or the sign), for each of ``NAN_BITS``."""
    import torch

    b, s, dim, heads = NAN_CASE
    gen = torch.Generator().manual_seed(4)
    params = _seeded_block_params(dim, heads, gen)
    x0 = torch.randn((b, s, dim), generator=gen).cuda()
    dy = torch.randn((b, s, dim), generator=gen).cuda()
    out = []
    for bits in NAN_BITS:
        x = x0.clone()
        x.view(torch.int32)[NAN_AT] = bits - (1 << 32) if bits >> 31 else bits
        got = {"out": vb.fused_vit_block(x, params, heads=heads)}
        dx, grads = vb.fused_vit_block_bwd(x, dy, params, heads=heads)
        got.update({"dx": dx, **grads})
        torch.cuda.synchronize()
        want = {"out": vb.fused_vit_block_reference(x, params, heads=heads)}
        dx, grads = vb.fused_vit_block_bwd_reference(x, dy, params, heads=heads)
        want.update({"dx": dx, **grads})
        mismatched = sorted(
            k for k, w in want.items()
            if not (torch.equal(torch.isnan(got[k]), torch.isnan(w))
                    and bool(torch.isfinite(got[k][~torch.isnan(w)]).all()))
        )
        out.append({
            "case": f"fp32 NaN 0x{bits:08X} at x{list(NAN_AT)}", "shape": list(NAN_CASE),
            "nan_elements": {k: int(torch.isnan(g).sum()) for k, g in got.items()},
            "plain_nan_elements": {k: int(torch.isnan(w).sum()) for k, w in want.items()},
            "mismatched": mismatched,
            "ok": not mismatched and all(bool(torch.isnan(w).any()) for w in (want["out"], want["dx"])),
        })
    del params, x0, dy
    torch.cuda.empty_cache()
    return out


# every device kernel name a ``profile_device`` trace of this run showed
PROFILED_KERNELS: set[str] = set()


def profile_device(fn, reps: int) -> dict:
    """Device time of ``reps`` calls of ``fn`` under torch.profiler: busy
    ms per call (the union of device activity), the idle share of the
    host-clock wall time, and device ms per call by kernel name (each name
    also kept in ``PROFILED_KERNELS``).  A trace
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
    PROFILED_KERNELS.update(by_name)
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
        "device_activities_per_call": len(spans) / reps,
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


def eager_logits(engine, images):
    """The logits of ``images``, one whole bucket, by the engine's eager
    forward: what a dispatch uploads, runs and downloads, without the
    bucket's graph.  A planted fault runs here: a graph replays the
    wrappers its capture called, and a capture under the fault would keep
    it."""
    import torch

    if len(images) not in engine.buckets:
        raise ValueError(f"{len(images)} images fill no bucket of {engine.buckets}")
    return engine._forward(torch.from_numpy(images).to(engine.device)).cpu().numpy()


def serve_phase(attn) -> dict:
    import numpy as np
    import torch

    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    attn.flash_attention.launches = 0
    report = run_entry(SERVE_ARGV)
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
        fault_logits = eager_logits(kernel_engine, images)
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
# the same at the entry point's default precision (fp32: no --amp)
SERVE_TINY_FP32_ARGV = [a for a in SERVE_TINY_ARGV if a != "--amp"]


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


def tiny_dispatch(argv=SERVE_TINY_ARGV) -> dict:
    """``dispatch_times`` of ``serve_tiny``'s engine (bf16; fp32 with
    ``SERVE_TINY_FP32_ARGV``) on one seeded batch of 32, built from
    whichever checkout of the port is first on ``sys.path``: run with a
    parent's unpacked checkout put there, it times the parent's kernels in
    the same call."""
    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    hp = load_config(argv)
    images = request_pool(32, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    off = build_engine(load_config(argv + ["--block-fusion", "off"]))
    return dispatch_times(build_engine(hp), off, images)


def serve_tiny_phase(vb, attn) -> dict:
    """``vit_tiny --patch-size 2`` served through ``entry.run``: every block
    of every dispatched batch through the fused K5 chain; the bucket-32
    logits against the composed reference engine in bf16 and fp32; one
    bucket-32 dispatch in each timed fused and composed, and profiled."""
    import numpy as np

    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    counters = _block_counters(vb, attn)
    for c in counters.values():
        c.launches = 0
    report = run_entry(SERVE_TINY_ARGV)
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


# step_profile's split of a step's device time: (bucket, substrings of the
# lower-cased kernel name), the first match taking the kernel, the rest
# under "rest".  The flash-attention paths':
FLASH_STEP_BUCKETS = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_dq", ("flash_bwd_dq",)),
    ("flash_dkv", ("flash_bwd_dkv",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
)


def step_profile(trainer, csrc: Path | None = None, buckets=FLASH_STEP_BUCKETS) -> dict:
    """Where one train step's device time goes: ``profile_device`` over two
    steps of ``trainer`` on its first batch, split by kernel name into
    ``buckets`` (by default the flash forward, dq and dk/dv kernels, the
    cuBLAS GEMMs) and the rest, with the port's kernels by symbol
    (``csrc``'s, this checkout's by default) and every kernel whose name
    holds ``tf32``."""
    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.utils import step_generator

    hp = trainer.hparams
    images, labels = next(trainer.train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    trainer.step(images, labels, draws)  # warm
    prof = profile_device(lambda: trainer.step(images, labels, draws), 2)
    split = {name: 0.0 for name, _ in buckets} | {"rest": 0.0}
    for name, ms in prof["device_ms_by_name"].items():
        low = name.lower()
        bucket = next((b for b, keys in buckets if any(k in low for k in keys)), "rest")
        split[bucket] += ms
    top = sorted(prof["device_ms_by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {
        "wall_ms_per_step": prof["wall_ms"],
        "device_busy_ms_per_step": prof["device_busy_ms"],
        "device_idle_share": prof["device_idle_share"],
        "device_ms_per_step": split,
        "port_kernels_ms_per_step": _port_kernel_ms(prof["device_ms_by_name"], csrc=csrc),
        "tf32_kernels": sorted(n[:80] for n in prof["device_ms_by_name"] if "tf32" in n.lower()),
        "top_device_ms_per_step": {name[:60]: ms for name, ms in top},
    }


def train_phase(attn, smi: str) -> dict:
    import torch

    from distributed_training_comparison_tpu_torch.data import get_datasets
    from distributed_training_comparison_tpu_torch.train import Trainer

    counters = {"fwd": attn.flash_attention, "dq": attn.flash_attention_dq,
                "dkv": attn.flash_attention_dkv}
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    report = run_entry(TRAIN_ARGV)
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


def train_long_fp32_phase(attn, smi: str) -> dict:
    """``vit_long`` trained through ``entry.run`` at the default precision:
    ``TRAIN_LONG_FP32_ARGV``, full width and depth at batch 16 (bh 64).
    The launch counters are zeroed just before and read just after; then a
    step profile (``step_profile``) and ms per step timed over steps of one
    batch."""
    import torch

    from distributed_training_comparison_tpu_torch.data import get_datasets
    from distributed_training_comparison_tpu_torch.train import Trainer

    counters = {"fwd": attn.flash_attention, "dq": attn.flash_attention_dq,
                "dkv": attn.flash_attention_dkv}
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    report = run_entry(TRAIN_LONG_FP32_ARGV)
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hp = load_config(TRAIN_LONG_FP32_ARGV)
    epochs = report["fit"]["epochs"]
    val_examples = len(get_datasets(hp)[1][1])
    trainer = Trainer(hp)
    depth = len(trainer.model.blocks)
    times = long_fp32_step_times(trainer)
    del trainer
    torch.cuda.empty_cache()
    return {
        "phase": "train_long_fp32",
        "nvidia_smi": smi,
        "argv": TRAIN_LONG_FP32_ARGV,
        "precision": hp.precision,
        "batch": hp.batch_size,
        "train_steps": sum(e["steps"] for e in epochs),
        "eval_batches": len(epochs) * math.ceil(val_examples / hp.batch_size),
        "depth": depth,
        "launches": launches,
        "losses_finite": all(e["nonfinite_losses"] == 0 for e in epochs),
        "skipped_steps": sum(e["skipped"] for e in epochs),
        "epochs": epochs,
        "peak_memory_gb": peak_gb,
        "epoch_images_per_s": epochs[-1]["images_per_s"],
        **times,
    }


def long_fp32_step_times(trainer, csrc: Path | None = None) -> dict:
    """ms per ``vit_long`` fp32 train step (CUDA events over 3 steps of the
    trainer's first batch, after a warm step) and ``step_profile``'s
    split of one step, the flash dq and dk/dv kernels' share of its device
    time beside it."""
    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.utils import step_generator

    hp = trainer.hparams
    images, labels = next(trainer.train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    ms = cuda_ms(lambda: trainer.step(images, labels, draws), 3, warmup=1)
    profile = step_profile(trainer, csrc=csrc)
    split = profile["device_ms_per_step"]
    busy = profile["device_busy_ms_per_step"]
    return {
        "ms_per_step": ms,
        "images_per_s_timed": hp.batch_size / ms * 1e3,
        "step_profile": profile,
        "flash_dq_dkv_share_of_busy": (split["flash_dq"] + split["flash_dkv"]) / busy,
    }


def check_train_long_fp32(run: dict) -> None:
    depth, steps = run["depth"], run["train_steps"]
    want = {"fwd": depth * (steps + run["eval_batches"]), "dq": depth * steps, "dkv": depth * steps}
    if run["precision"] != "fp32" or run["batch"] != 16:
        raise RuntimeError(f"train_long_fp32 ran {run['precision']} at batch {run['batch']}")
    if run["launches"] != want:
        raise RuntimeError(f"train_long_fp32 launches {run['launches']}, expected {want}")
    if not run["losses_finite"] or run["skipped_steps"]:
        raise RuntimeError("train_long_fp32: a non-finite loss or a skipped step")
    ran = set(run["step_profile"]["port_kernels_ms_per_step"])
    want = {k for ks in (*BACKWARD_SYMBOLS["float32"].values(), FORWARD_SYMBOLS["float32"]) for k in ks}
    bf16 = {k for ks in (*BACKWARD_SYMBOLS["bfloat16"].values(), FORWARD_SYMBOLS["bfloat16"]) for k in ks}
    if not want <= ran or ran & bf16:
        raise RuntimeError(f"train_long_fp32's step ran the port kernels {sorted(ran)}")


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


def tiny_step_times(reps: int = 5, argv=TRAIN_TINY_ARGV) -> dict:
    """ms per train step (host clock around ``reps`` steps ending in a
    synchronise) of the train command's trainer (bf16; fp32 with
    ``TRAIN_TINY_FP32_RUN_ARGV``), fused and with ``--block-fusion off``, in
    turns (fused, off, fused, off), and a profile of two fused steps: the
    K5 and K6 kernels' shares of the device's busy time, each wrapper's
    kernels' device ms, and the idle share."""
    import torch

    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.train import Trainer
    from distributed_training_comparison_tpu_torch.utils import step_generator

    trainers = {
        "fused": Trainer(load_config(argv)),
        "off": Trainer(load_config(argv + ["--block-fusion", "off"])),
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
        "kernel_ms_per_step_by_wrapper": {w: kernel_ms(names, [w]) for w in K6_KERNELS},
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

    from distributed_training_comparison_tpu_torch.data import get_datasets

    counters = _tiny_counters(vb, attn)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = run_entry(TRAIN_TINY_ARGV)
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


# vit_tiny --patch-size 2 trained at the entry point's default precision
# (fp32: no --amp), batch 128, one epoch: 396 training images (3 steps) and
# 44 validation images (one batch)
TRAIN_TINY_FP32_RUN_ARGV = [
    "--model", "vit_tiny", "--patch-size", "2", "--synthetic-data",
    "--limit-examples", "440", "--batch-size", "128", "--epoch", "1",
    "--lr-decay-step-size", "1",
]


def tiny_fp32_step_times(trainer, csrc: Path | None = None) -> dict:
    """ms per fp32 ``vit_tiny --patch-size 2`` train step (CUDA events over
    3 steps of the trainer's first batch, after a warm step) and a profile
    of two steps: the device's busy time and idle share, each K5/K6
    wrapper's kernels' device ms (``kernel_ms``: a parent's SIMT kernels
    too), and the busy time split into the K5 kernels (the forward's and
    K6's recompute: one symbol), the K6 kernels, the LayerNorm and
    gradient-sum kernels and the rest; the port's kernels by symbol
    (``csrc``'s, this checkout's by default)."""
    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.utils import step_generator

    hp = trainer.hparams
    images, labels = next(trainer.train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    ms = cuda_ms(lambda: trainer.step(images, labels, draws), 3, warmup=1)
    prof = profile_device(lambda: trainer.step(images, labels, draws), 2)
    names = prof["device_ms_by_name"]
    busy = prof["device_busy_ms"]
    by_wrapper = {w: kernel_ms(names, [w]) for w in K6_KERNELS}
    split = {
        "k5_kernels": by_wrapper["block_gemm"] + by_wrapper["block_attention"],
        "k6_kernels": sum(by_wrapper[w] for w in ("block_gemm_dgrad", "block_gemm_wgrad",
                                                  "block_attention_bwd")),
        "ln_and_sum_kernels": sum(by_wrapper[w] for w in ("block_ln", "block_ln_bwd", "block_grad_reduce")),
    }
    split["rest"] = busy - sum(split.values())
    port = _port_kernel_ms(names, csrc=csrc)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
    return {
        "ms_per_step": ms,
        "images_per_s_timed": hp.batch_size / ms * 1e3,
        "wall_ms_per_step": prof["wall_ms"],
        "device_busy_ms_per_step": busy,
        "device_idle_share": prof["device_idle_share"],
        "device_ms_per_step": split,
        "kernel_ms_per_step_by_wrapper": by_wrapper,
        "port_kernels": sorted(port),
        "gemm_kernels": sorted(GEMM_SYMBOLS & set(port)),
        "attention_kernels": sorted(ATTENTION_SYMBOLS & set(port)),
        "top_device_ms_per_step": {n[:60]: t for n, t in top},
    }


def train_tiny_fp32_phase(vb, attn, smi: str) -> dict:
    """``vit_tiny --patch-size 2`` trained through ``entry.run`` at the
    default precision (``TRAIN_TINY_FP32_RUN_ARGV``: fp32, batch 128, 12
    blocks of dim 192): every block's forward through the fp32 K5 chain and
    its backward through the fp32 K6 chain.  The launch counters are zeroed
    just before and read just after; then ``tiny_fp32_step_times``."""
    import torch

    from distributed_training_comparison_tpu_torch.data import get_datasets
    from distributed_training_comparison_tpu_torch.train import Trainer

    counters = _tiny_counters(vb, attn)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = run_entry(TRAIN_TINY_FP32_RUN_ARGV)
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hp = load_config(TRAIN_TINY_FP32_RUN_ARGV)
    epochs = report["fit"]["epochs"]
    val_examples = len(get_datasets(hp)[1][1])
    trainer = Trainer(hp)
    depth = len(trainer.model.blocks)
    times = tiny_fp32_step_times(trainer)
    del trainer
    torch.cuda.empty_cache()
    return {
        "phase": "train_tiny_fp32",
        "nvidia_smi": smi,
        "argv": TRAIN_TINY_FP32_RUN_ARGV,
        "precision": hp.precision,
        "batch": hp.batch_size,
        "run_seconds": seconds,
        "train_steps": sum(e["steps"] for e in epochs),
        "eval_batches": len(epochs) * math.ceil(val_examples / hp.batch_size),
        "depth": depth,
        "launches": launches,
        "losses_finite": all(e["nonfinite_losses"] == 0 for e in epochs),
        "skipped_steps": sum(e["skipped"] for e in epochs),
        "epochs": epochs,
        "peak_memory_gb": peak_gb,
        "epoch_images_per_s": epochs[-1]["images_per_s"],
        **times,
    }


def check_train_tiny_fp32(run: dict) -> None:
    depth, steps = run["depth"], run["train_steps"]
    if run["precision"] != "fp32" or run["batch"] != 128 or depth != 12:
        raise RuntimeError(f"train_tiny_fp32 ran {run['precision']} at batch {run['batch']}, depth {depth}")
    if (steps, run["eval_batches"]) != (3, 1):
        raise RuntimeError(f"train_tiny_fp32 ran {steps} steps and {run['eval_batches']} eval batches")
    fwd, bwd = depth * (steps + run["eval_batches"]), depth * steps
    want = {"fused_vit_block": fwd, "block_gemm": 4 * fwd + 3 * bwd,
            "block_attention": fwd + bwd, "flash_attention": 0,
            "flash_attention_dq": 0, "flash_attention_dkv": 0,
            **{n: k * bwd for n, k in K6_PER_BLOCK.items()}}
    if run["launches"] != want:
        raise RuntimeError(f"train_tiny_fp32 launches {run['launches']}, expected {want}")
    if not run["losses_finite"] or run["skipped_steps"]:
        raise RuntimeError("train_tiny_fp32: a non-finite loss or a skipped step")
    want = {k: sorted(s for w in ws for s in path_symbols(w, "float32"))
            for k, ws in (("gemm_kernels", GEMM_WRAPPERS), ("attention_kernels", ATTENTION_WRAPPERS))}
    replaced = {s for syms in REPLACED_F32_KERNELS.values() for s in syms}
    for key, syms in want.items():
        if run[key] != syms:
            raise RuntimeError(f"train_tiny_fp32's step ran the {key} {run[key]}, expected {syms}")
    if replaced & set(run["port_kernels"]):
        raise RuntimeError(f"train_tiny_fp32's step ran SIMT kernels: {sorted(replaced & set(run['port_kernels']))}")


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
    ("fp32 serve shape, bucket 32 (--moe-dispatch gmm without --amp)", "float32", 2048, 320, None),
    ("fp32 ragged: an empty group, two over capacity, the last ending at n", "float32", 1000, 160,
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
# group left out of its walk.  In fp32 a NaN in one element of x must also
# reach K7's output and K9's gradients where the plain versions put it.
GMM_GRAD_TOL = {"bfloat16": 2**-7, "float32": 2**-14}
# the kernels K7, K8 and K9 launch, by symbol: in bf16 the Hopper kernels;
# in fp32 the 3xTF32 ones
MOE_SYMBOLS = {
    "bfloat16": {"fwd": "moe_ffn_fwd_wgmma", "dx": "moe_ffn_dx_wgmma", "dw": "moe_ffn_dw_wgmma"},
    "float32": {"fwd": "moe_ffn_fwd_tf32x3", "dx": "moe_ffn_dx_tf32x3", "dw": "moe_ffn_dw_tf32x3"},
}
MOE_TF32_KERNELS = tuple(MOE_SYMBOLS["float32"].values())
# the first port's fp32 K7, K8 and K9, which the 3xTF32 kernels replaced: no
# profile of the run may show them (``turn`` still times a parent's by them)
REPLACED_MOE_KERNELS = {"fwd": "moe_gmm_fwd_kernel", "dx": "moe_gmm_dx_kernel", "dw": "moe_gmm_dw_kernel"}


def _moe_kernel_ms(device_ms_by_name: dict, csrc: Path | None = None) -> dict[str, float]:
    """Device ms of the grouped expert FFN's kernels (those
    ``moe_gmm_*.cu`` defines) by symbol."""
    return _port_kernel_ms(device_ms_by_name, "moe_gmm_*.cu", csrc)


def check_moe_kernels(where: str, kernels: dict, keys, dname: str = "bfloat16") -> None:
    """``kernels`` (symbol -> device ms) must be the ``dname`` kernels of
    ``keys`` ("fwd", "dx", "dw") alone, each with device time: a launched
    kernel whose symbol the profile does not show would read 0 ms."""
    want = {MOE_SYMBOLS[dname][k] for k in keys}
    if set(kernels) != want or not all(kernels[k] > 0 for k in want):
        raise RuntimeError(f"{where} ran the expert FFN kernels {kernels}, expected {sorted(want)} with device time")


def moe_gmm_bounds(n, d, h, ne, kept, dname) -> dict[str, tuple[float, str]]:
    """Least times of K7, K8 and K9 on the card, counting the kept rows'
    products only: K7 4·K·d·h operations against xs and y (n rows each) and
    the weights; K8 6·K·d·h against xs, dy, dx and the weights; K9 8·K·d·h
    against xs, dy, the weights read and the fp32 gradients written.  In
    fp32 each runs every product as three tf32 products (3xTF32)."""
    item = 2 if dname == "bfloat16" else 4
    weights = ne * (2 * d * h + h + d)
    return {
        "fwd": bound(4 * kept * d * h, (2 * n * d + weights) * item, dname, tf32x3=True),
        "dx": bound(6 * kept * d * h, (3 * n * d + weights) * item, dname, tf32x3=True),
        "dw": bound(8 * kept * d * h, (2 * n * d + weights) * item + weights * 4, dname, tf32x3=True),
    }


def composed_library_ffn(gm, xs, w1, b1, w2, b2, starts, cap, dy):
    """The library yardstick (timed here, never called on the gmm path):
    the gather dispatch's composed form on the same routing, two
    ``torch.bmm`` over the (E, cap, d) capacity buffer with bias and gelu,
    and its autograd backward.  Returns ``(forward, backward, dx)``
    callables: ``dx`` is K8's work, the forward that K8 recomputes and the
    backward for the capacity buffer alone (``torch.autograd.grad`` with
    respect to it; the weights need no gradient)."""
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
    xb = buf.detach().requires_grad_()

    def dx():
        return torch.autograd.grad(forward(xb), (xb,), dbuf)

    return forward, lambda: torch.autograd.grad(out, leaves, dbuf, retain_graph=True), dx


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


def moe_nan_check(gm, xs, dy, w1, b1, w2, b2, starts, cap) -> dict:
    """A NaN in one element of x, in a kept row of the first expert that
    keeps more than 8 rows: K7's output, K8's dx and K9's gradients hold NaN
    exactly where the plain versions do (that row of the output and of dx;
    the expert's dW1, db1 and dW2 wholly) and the rows are NaN across; then
    a NaN in the same element of dy: K8's dx NaN in that row alone, as in
    the plain version."""
    import torch

    lo, hi = next((lo, hi) for lo, hi in gm.kept_ranges(starts, cap, xs.shape[0]) if hi - lo > 8)
    row = lo + 5
    x_nan, dy_nan = xs.clone(), dy.clone()
    x_nan[row, 17] = float("nan")
    dy_nan[row, 17] = float("nan")
    y = gm.grouped_ffn_fwd(x_nan, w1, b1, w2, b2, starts, cap)
    dx = gm.grouped_ffn_dx(x_nan, dy, w1, b1, w2, starts, cap)
    dw = gm.grouped_ffn_dw(x_nan, dy, w1, b1, w2, starts, cap)
    dx_dy = gm.grouped_ffn_dx(xs, dy_nan, w1, b1, w2, starts, cap)
    want_y = gm.grouped_ffn_reference(x_nan, w1, b1, w2, b2, starts, cap)
    want_dx = gm.grouped_ffn_dx_reference(x_nan, dy, w1, b1, w2, starts, cap)
    want_dw = gm.grouped_ffn_dw_reference(x_nan, dy, w1, b1, w2, starts, cap)
    want_dx_dy = gm.grouped_ffn_dx_reference(xs, dy_nan, w1, b1, w2, starts, cap)
    d = xs.shape[1]
    rec = {
        "row": row, "y_row_nan": bool(y[row].isnan().all()),
        "y_nan_where_plain": bool(torch.equal(y.isnan(), want_y.isnan())),
        "dx_row_nan": bool(dx[row].isnan().all()) and int(dx.isnan().sum()) == d,
        "dx_nan_where_plain": bool(torch.equal(dx.isnan(), want_dx.isnan())),
        "dw_nan_where_plain": [bool(torch.equal(g.isnan(), w.isnan())) for g, w in zip(dw, want_dw)],
        "dw1_nan_elements": int(dw[0].isnan().sum()),
        "dy_nan_dx_row_nan": bool(dx_dy[row].isnan().all()) and int(dx_dy.isnan().sum()) == d,
        "dy_nan_dx_nan_where_plain": bool(torch.equal(dx_dy.isnan(), want_dx_dy.isnan())),
    }
    rec["ok"] = rec["y_row_nan"] and rec["y_nan_where_plain"] and all(rec["dw_nan_where_plain"]) \
        and rec["dw1_nan_elements"] > 0 and rec["dx_row_nan"] and rec["dx_nan_where_plain"] \
        and rec["dy_nan_dx_row_nan"] and rec["dy_nan_dx_nan_where_plain"]
    return rec


def moe_fp64_drift(gm, xs, dy, w1, b1, w2, b2, starts, cap, y, dx, dw) -> dict:
    """K7's output ``y``, K8's ``dx`` and K9's gradients ``dw``, and their
    plain versions, against the same function summed in fp64 on the card: y
    and dx per kept row as a share of the row's rms (rtol 0), each gradient
    in relative L2.  A record of the 3xTF32 kernels' drift beside cuBLAS
    fp32's, not a bound."""
    import torch
    import torch.nn.functional as F

    x64, dy64, w1d, b1d, w2d, b2d = (t.double() for t in (xs, dy, w1, b1, w2, b2))
    y64, dx64 = torch.zeros_like(x64), torch.zeros_like(x64)
    g64 = [torch.zeros_like(t) for t in (w1d, b1d, w2d, b2d)]
    for e, (lo, hi) in enumerate(gm.kept_ranges(starts, cap, xs.shape[0])):
        if hi > lo:
            x, g = x64[lo:hi], dy64[lo:hi]
            v = (x @ w1d[e] + b1d[e]).requires_grad_()
            with torch.enable_grad():
                act = F.gelu(v, approximate="tanh")
                (grad,) = torch.autograd.grad(act.sum(), v)  # gelu' elementwise
            act = act.detach()
            y64[lo:hi] = act @ w2d[e] + b2d[e]
            dh = grad * (g @ w2d[e].T)
            dx64[lo:hi] = dh @ w1d[e].T
            for out, val in zip(g64, (x.T @ dh, dh.sum(0), act.T @ g, g.sum(0))):
                out[e] = val
    kept = gm.kept_mask(starts, cap, xs.shape[0])

    def share(got, want=y64):
        rms = want[kept].pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
        return float(((got[kept].double() - want[kept]).abs() / rms).max())

    def rel(got):
        return [float((a.double() - b).norm() / b.norm().clamp_min(1e-30)) for a, b in zip(got, g64)]

    return {
        "y_row_share": {"kernel": share(y), "plain": share(gm.grouped_ffn_reference(xs, w1, b1, w2, b2, starts, cap))},
        "dx_row_share": {"kernel": share(dx, dx64),
                         "plain": share(gm.grouped_ffn_dx_reference(xs, dy, w1, b1, w2, starts, cap), dx64)},
        "dw_rel_l2": {"kernel": rel(dw), "plain": rel(gm.grouped_ffn_dw_reference(xs, dy, w1, b1, w2, starts, cap))},
    }


def moe_gmm_checks(gm) -> list[dict]:
    """K7, K8 and K9 (``ops/moe_gmm.py``) against their plain versions on
    the card at ``MOE_GMM_CASES``: agreement, exact zeros, bitwise replay,
    the two planted faults, in fp32 a NaN in x (``moe_nan_check``) and the
    drift against fp64 sums (``moe_fp64_drift``), the kernels each wrapper
    ran by symbol (the dtype's ``MOE_SYMBOLS`` alone),
    device ms of each kernel, its plain version and the composed cuBLAS
    yardstick (and CUDA-event ms), beside its bound."""
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
        replay = (gm.grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, cap),
                  gm.grouped_ffn_dx(xs, dy, w1, b1, w2, starts, cap),
                  *gm.grouped_ffn_dw(xs, dy, w1, b1, w2, starts, cap))
        bitwise = all(torch.equal(a, b) for a, b in zip((y, dx, *dw), replay))
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
        if dname == "float32":
            rec["nan_in_x"] = moe_nan_check(gm, xs, dy, w1, b1, w2, b2, starts, cap)
            rec["fp64_drift"] = moe_fp64_drift(gm, xs, dy, w1, b1, w2, b2, starts, cap, y, dx, dw)
        lib_fwd, lib_bwd, lib_dx = composed_library_ffn(gm, xs, w1, b1, w2, b2, starts, cap, dy)
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
        for k, fn in (("fwd", lib_fwd), ("bwd", lib_bwd), ("dx", lib_dx)):
            rec["library_ms"][k], rec["library_event_ms"][k] = timed(fn, 20)
        rec["library"] = ("gather dispatch's composed form on the same routing: "
                          "2 x torch.bmm over (E, cap, d) with bias and tanh gelu; bwd its autograd; "
                          "dx its forward and its autograd for the capacity buffer alone")
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
            and rec.get("nan_in_x", {"ok": True})["ok"]
        )
        out.append(rec)
        del xs, dy, w1, b1, w2, b2, y, dx, dw, replay, want_y, want_dx, want_dw, dy_tile
        del lib_fwd, lib_bwd, lib_dx
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
        # the engine's eager forward: a replayed bucket graph runs no hook
        engine._forward(torch.from_numpy(images).to(engine.device))
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

    counters = _moe_path_counters(gm, vb, attn)
    for c in counters.values():
        c.launches = 0
    report = run_entry(SERVE_MOE_ARGV)
    launches = {name: c.launches for name, c in counters.items()}

    # the same seeded weights under gmm (auto, bf16) and under gather, one
    # padded batch of 32: the first block routes the same tokens by
    # construction, and K7 and the gather's cuBLAS GEMMs accumulate each
    # product in fp32 and round at the same points, so later blocks see the
    # same inputs unless a summation order flips a bf16 rounding that sends
    # a near-tie token to another expert.  At this seed none does: the
    # bound, 2^-10 of the largest logit, is set from that reading.
    rec, engines, images = bucket32_against_gather(gm, SERVE_MOE_ARGV, 2**-10)
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


def bucket32_against_gather(gm, argv: list, tol_share: float):
    """One padded batch of 32 through the engine of the serve command
    ``argv`` (gmm) and through the same seeded weights under ``--moe-dispatch
    gather``: the logits against gather within ``tol_share`` of the largest,
    which the planted fault (every K7 launch with one expert's start a row
    late: one token a block takes the wrong expert or none) must exceed;
    K7's launches; host ms a dispatch under each (5 after a warm-up,
    twice) and the gmm dispatch's profile.  Returns ``(rec, engines,
    images)``."""
    import numpy as np

    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    hp = load_config(argv)
    images = request_pool(32, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    engines = {"gmm": build_engine(hp),
               "gather": build_engine(load_config(argv + ["--moe-dispatch", "gather"]))}
    rec = {}
    for name, eng in engines.items():
        before = gm.grouped_ffn_fwd.launches
        rec[f"logits_{name}"] = eng.predict_logits(images)
        rec[f"k7_launches_{name}"] = gm.grouped_ffn_fwd.launches - before
    with shifted_k7(gm):
        fault = eager_logits(engines["gmm"], images)
    got, want = rec.pop("logits_gmm"), rec.pop("logits_gather")
    scale = float(np.abs(want).max())
    rec.update({
        "logits_finite": bool(np.isfinite(got).all() and np.isfinite(want).all()),
        "logits_max_abs_err_vs_gather": float(np.abs(got - want).max()),
        "logits_scale": scale, "logits_tol": tol_share * scale,
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
    return rec, engines, images


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


# vit_moe served at the default precision (fp32) with the kernels taken
# (``--moe-dispatch auto`` takes gather for fp32, the JAX budget rule)
SERVE_MOE_FP32_ARGV = [
    "--serve", "--model", "vit_moe", "--moe-dispatch", "gmm",
    "--serve-buckets", "1,2,4,8,16,32", "--seed", "0",
]


def moe_fp32_dispatch_phase(gm) -> dict:
    """One bucket-32 batch of ``SERVE_MOE_FP32_ARGV``'s engine against the
    same weights under gather (``bucket32_against_gather``).  In fp32 the
    two differ by summation order only (3xTF32 keeps fp32 accuracy, and a
    routing flip needs a router input within ~1e-7 of a tie), so the
    logits hold to 2^-13 of the largest, the fp32 train step's bound.  The
    gather dispatch is profiled beside."""
    rec, engines, images = bucket32_against_gather(gm, SERVE_MOE_FP32_ARGV, 2**-13)
    rec["bucket32_profile_gather"] = moe_dispatch_profile(engines["gather"], images)
    depth = len(engines["gmm"].model.blocks)
    del engines
    return {"phase": "moe_fp32_dispatch", "argv": SERVE_MOE_FP32_ARGV, "depth": depth, **rec}


def check_moe_fp32_dispatch(rec: dict) -> None:
    if (rec["k7_launches_gmm"], rec["k7_launches_gather"]) != (rec["depth"], 0):
        raise RuntimeError(f"moe_fp32_dispatch launches {rec}")
    if not rec["logits_finite"] or rec["logits_max_abs_err_vs_gather"] > rec["logits_tol"]:
        raise RuntimeError(f"moe_fp32_dispatch: gmm logits disagree with gather: {rec}")
    if not rec["fault_logits_max_abs_err_vs_gather"] > rec["logits_tol"]:
        raise RuntimeError(f"moe_fp32_dispatch: the planted K7 fault passes the logits bound: {rec}")
    check_moe_kernels("moe_fp32_dispatch under gmm", rec["bucket32_profile_gmm"]["moe_kernels"], ("fwd",), "float32")
    check_moe_kernels("moe_fp32_dispatch under gather", rec["bucket32_profile_gather"]["moe_kernels"], ())


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
# vit_moe trained at the default precision (fp32) with the kernels taken,
# batch 256: one epoch over 792 synthetic training images (3 steps) and 88
# validation images (one batch), as train_tiny_fp32
TRAIN_MOE_FP32_ARGV = [
    "--model", "vit_moe", "--moe-dispatch", "gmm", "--synthetic-data", "--batch-size", "256",
    "--limit-examples", "880", "--epoch", "1", "--lr-decay-step-size", "1",
]


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


def routing_stats(gm, starts, cap: int, n: int) -> dict:
    """A routing of n expert-sorted rows: group sizes, kept rows and the
    units of K7's and K8's schedule (``expert_tiles``): a launch is one
    block a unit."""
    ranges = gm.kept_ranges(starts, cap, n)
    return {
        "n": n, "cap": cap, "counts": [hi - lo for lo, hi in zip(starts.tolist(), starts.tolist()[1:])],
        "kept_rows": sum(hi - lo for lo, hi in ranges),
        "units": len(gm.expert_tiles(starts, cap, n)) // 2,
    }


def k8_at_step_routing(gm, trainer, images, labels, draws) -> dict:
    """K8 at the ``vit_moe`` train step's own routing: one step with
    ``grouped_ffn_dx`` wrapped to keep each block's inputs, then each
    block's launch timed alone on them (device ms under the profiler), with
    each routing's ``routing_stats``, beside the same for the train case of
    ``MOE_GMM_CASES``: K8 in the step reads more a launch than K8 in
    ``moe_gmm_checks`` either for the routing (its sizes, dropped rows,
    units) or for what surrounds the launch in the step (the caches, the
    clocks)."""
    import torch

    calls, dx = [], gm.grouped_ffn_dx

    def keep(*args):
        calls.append(args)
        return dx(*args)

    # the wrapper counts its launch on the name it is bound to: this one's
    # while it stands in
    keep.launches = 0
    gm.grouped_ffn_dx = keep
    try:
        trainer.step(images, labels, draws)
    finally:
        gm.grouped_ffn_dx = dx
    torch.cuda.synchronize()
    blocks = []
    for args in calls:
        xs, starts, cap = args[0], args[5], args[6]
        rec = routing_stats(gm, starts, cap, xs.shape[0])
        rec["ms_alone"] = timed_kernels(lambda a=args: dx(*a), 10)[0]
        blocks.append(rec)
    label, _, n, cap, _ = MOE_GMM_CASES[1]
    counts, starts, *_ = moe_case_inputs("bfloat16", n)
    check = routing_stats(gm, starts, cap, n)
    del calls
    torch.cuda.empty_cache()
    return {"blocks": blocks, "ms_alone_per_launch": sum(b["ms_alone"] for b in blocks) / max(len(blocks), 1),
            "check_case": label, "check_routing": check}


def moe_step_times(reps: int = 5, csrc: Path | None = None, argv: list = TRAIN_MOE_ARGV) -> dict:
    """ms per train step of the train command ``argv``'s trainer under gmm
    and ``--moe-dispatch gather``, in turns (gmm, gather, gmm, gather), and
    a profile of two steps of each: the expert FFN kernels' device ms by
    symbol (``csrc``'s, this checkout's by default), K7, K8 and K9's by
    their symbols in the command's dtype (a parent's first-port fp32
    kernels by theirs), their shares of the busy time,
    and the idle share; then, in bf16, K8 at the gmm step's routing
    (``k8_at_step_routing``)."""
    import torch

    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.train import Trainer
    from distributed_training_comparison_tpu_torch.utils import step_generator

    trainers = {
        "gmm": Trainer(load_config(argv)),
        "gather": Trainer(load_config(argv + ["--moe-dispatch", "gather"])),
    }
    dname = "bfloat16" if "--amp" in argv else "float32"
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
        kernels = {k: moe.get(sym, 0.0) + moe.get(REPLACED_MOE_KERNELS[k], 0.0)
                   for k, sym in MOE_SYMBOLS[dname].items()}
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
            "moe_kernel_shares_of_busy": {k: ms / prof["device_busy_ms"] for k, ms in kernels.items()},
            "cublas_gemm_device_ms_per_step": gemm,
            "top_device_ms_per_step": {n[:60]: ms for n, ms in top},
        }
    if dname == "bfloat16":
        gm = importlib.import_module(f"{PKG}.ops.moe_gmm")
        out["k8_at_step_routing"] = k8_at_step_routing(gm, trainers["gmm"], images, labels, draws)
    del trainers
    torch.cuda.empty_cache()
    return out


def train_moe_phase(gm, vb, attn, smi: str, argv: list = TRAIN_MOE_ARGV, phase: str = "train_moe") -> dict:
    """``vit_moe`` trained through ``entry.run`` by the command ``argv``
    (``TRAIN_MOE_ARGV``: bf16, batch 256, 18 steps; ``TRAIN_MOE_FP32_ARGV``:
    fp32, batch 256, 3 steps): every block's forward through K7 and
    backward through K8 and K9, the counters zeroed just before and read
    just after; every loss finite, no step skipped, the routing health
    reported; one step's loss and gradients in the command's precision
    against ``--moe-dispatch gather`` and the plain kernels
    (``moe_step_check``); ms per step under gmm and gather, a step profile
    (K8's share of its busy time beside) and the peak memory."""
    import torch

    from distributed_training_comparison_tpu_torch.data import get_datasets

    counters = _moe_path_counters(gm, vb, attn)
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = run_entry(argv)
    seconds = time.perf_counter() - t0
    launches = {name: c.launches for name, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hp = load_config(argv)
    epochs = report["fit"]["epochs"]
    val_examples = len(get_datasets(hp)[1][1])
    last = epochs[-1]
    check = moe_step_check(gm, hp.precision)
    times = moe_step_times(argv=argv)
    return {
        "phase": phase,
        "nvidia_smi": smi,
        "argv": argv,
        "dtype": "bfloat16" if hp.precision == "bf16" else "float32",
        "batch": hp.batch_size,
        "run_seconds": seconds,
        "train_steps": sum(e["steps"] for e in epochs),
        "eval_batches": len(epochs) * math.ceil(val_examples / hp.batch_size),
        "depth": check["depth"],
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
        "step_checks": {hp.precision: check},
        "step_times": times,
        "k8_share_of_busy": times["profile_gmm"]["moe_kernel_shares_of_busy"]["dx"],
    }


def check_train_moe(train: dict) -> None:
    depth, steps, phase = train["depth"], train["train_steps"], train["phase"]
    if phase == "train_moe_fp32" and (train["dtype"], train["batch"], depth, steps, train["eval_batches"]) != (
            "float32", 256, 8, 3, 1):
        raise RuntimeError(f"train_moe_fp32 ran {train['dtype']} at batch {train['batch']}, depth {depth}, "
                           f"{steps} steps and {train['eval_batches']} eval batches")
    want = {n: 0 for n in train["launches"]}
    want["grouped_ffn_fwd"] = depth * (steps + train["eval_batches"])
    want["grouped_ffn_dx"] = want["grouped_ffn_dw"] = depth * steps
    if train["launches"] != want:
        raise RuntimeError(f"{phase} launches {train['launches']}, expected {want}")
    if not train["losses_finite"] or train["skipped_steps"]:
        raise RuntimeError(f"{phase}: a non-finite loss or a skipped step")
    if not train["routing_health_reported"]:
        raise RuntimeError(f"{phase}: moe_dropped_frac / moe_load_max missing from the epochs")
    bad = {p: c for p, c in train["step_checks"].items() if not c["ok"]}
    if bad:
        raise RuntimeError(f"a vit_moe train step through K7-K9 disagrees: {bad}")
    times = train["step_times"]
    check_moe_kernels(f"{phase}'s gmm step", times["profile_gmm"]["moe_kernels"], ("fwd", "dx", "dw"),
                      train["dtype"])
    check_moe_kernels(f"{phase}'s gather step", times["profile_gather"]["moe_kernels"], ())


# --------------------------------- vit_tiny at 64 tokens: K10, K11

# (label, dtype, B, S, H, D, causal): the serve path's bucket-32 attention
# and the train path's batch-256 attention (bf16, and fp32 as vit_tiny
# trains without --amp), a causal case with a ragged S (one partial key
# tile) and a causal multi-tile case (S 256: the causal tile skipping of
# both sweeps and of the dk/dv walk), unit-normal packed (B*S, H*D) inputs;
# then the fp32 (3xTF32) kernels at the serve shape, a ragged causal tile,
# one tile at head dim 128 and a causal multi-tile item at head dim 128;
# then vit_small --patch-size 2's serve and train shapes (the tiled bf16
# kernels at 256 tokens) and a causal S of 328 at head dims 64 and 128 (the
# kernels' builds for items past 256 tokens, which sweep the keys twice).
SMALL_CASES = [
    ("serve shape: vit_tiny bucket 32", "bfloat16", 32, 64, 3, 64, False),
    ("train shape: vit_tiny batch 256", "bfloat16", 256, 64, 3, 64, False),
    ("train shape fp32: vit_tiny batch 256 without --amp", "float32", 256, 64, 3, 64, False),
    ("ragged causal", "bfloat16", 6, 24, 2, 64, True),
    ("one tile at head dim 128, causal", "bfloat16", 8, 64, 2, 128, True),
    ("ragged one tile", "bfloat16", 6, 40, 3, 64, False),
    ("multi-tile causal", "bfloat16", 4, 256, 2, 128, True),
    ("serve shape fp32: vit_tiny bucket 32 without --amp", "float32", 32, 64, 3, 64, False),
    ("ragged causal fp32", "float32", 6, 24, 2, 64, True),
    ("one tile at head dim 128, causal, fp32", "float32", 8, 64, 2, 128, True),
    ("multi-tile causal fp32", "float32", 4, 256, 2, 128, True),
    ("serve shape: vit_small p2 bucket 32", "bfloat16", 32, 256, 6, 64, False),
    ("train shape: vit_small p2 batch 128", "bfloat16", 128, 256, 6, 64, False),
    ("past the resident keys: two sweeps, S 328, causal", "bfloat16", 2, 328, 2, 64, True),
    ("past the resident keys at head dim 128: two sweeps, S 328, causal", "bfloat16", 2, 328, 2, 128, True),
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
# as small.kernel_symbols names them for that shape; and of their fp32
# dispatch and of train_small_fp32 (the 3xTF32 kernels)
SMALL_PATH_KERNELS = {"fwd": ("attn_small_fwd_onetile",), "bwd": ("attn_small_bwd_onetile",)}
SMALL_F32_KERNELS = {"fwd": ("attn_small_fwd_f32",), "bwd": ("attn_small_dq_f32", "attn_small_dkv_f32")}
# the kernels of the serve_vits_p2 and train_vits_p2 paths (bf16, 256 tokens:
# the tiled wgmma kernels), as small.kernel_symbols names them for that shape
SMALL_TILED_KERNELS = {"fwd": ("attn_small_fwd_bf16",), "bwd": ("attn_small_dq_bf16", "attn_small_dkv_bf16")}


def without_last_keys(v, seq: int, n: int):
    """Packed (B*S, H*D) ``v`` with the last ``n`` keys of every item
    zeroed: K10 run on it is K10 with those keys left out of P.V."""
    v = v.clone()
    v.view(-1, seq, v.shape[1])[:, seq - n:] = 0
    return v


def small_bounds(b, s, h, d, causal, dname) -> dict[str, tuple[float, str]]:
    """Least times of K10 (q, k, v read, o written; 2 products: s and P.V)
    and K11 (q, k, v, dO read, dq, dk, dv written; 5 products: s, dp, dq,
    dk, dv), causal counting only the pairs it needs; fp32 products as
    3xTF32, the kernels' arithmetic."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    elems = b * s * h * d * (2 if dname == "bfloat16" else 4)
    return {"fwd": bound(4 * pairs * d, 4 * elems, dname, tf32x3=True),
            "bwd": bound(10 * pairs * d, 7 * elems, dname, tf32x3=True)}


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


# (B, S, H, D) of small_fp32_nan_checks, and the packed (row, column) of
# its NaN: item 1, token 20, head 1, dimension 17
SMALL_NAN_CASE = (4, 64, 3, 64)
SMALL_NAN_AT = (64 + 20, 64 + 17)


def small_fp32_nan_checks(small) -> list[dict]:
    """A NaN in one element of q, of v and of dO through the fp32 K10 and
    K11 on the card: the output and dq, dk, dv must be NaN exactly where
    the plain versions' are and finite everywhere else, for each of
    ``NAN_BITS`` (the 3xTF32 split keeps a NaN as a NaN)."""
    import torch

    b, s, h, d = SMALL_NAN_CASE
    gen = torch.Generator().manual_seed(19)
    base = [torch.randn((b * s, h * d), generator=gen).cuda() for _ in range(4)]
    out = []
    for where in ("q", "v", "do"):
        for bits in NAN_BITS:
            tensors = dict(zip(("q", "k", "v", "do"), (x.clone() for x in base)))
            tensors[where].view(torch.int32)[SMALL_NAN_AT] = bits - (1 << 32) if bits >> 31 else bits
            q, k, v, do = tensors.values()
            got = dict(zip(("out", "dq", "dk", "dv"), (small.small_mha_fwd(q, k, v, seq=s, heads=h),
                                                      *small.small_mha_bwd(q, k, v, do, seq=s, heads=h))))
            torch.cuda.synchronize()
            view = [x.view(b, s, h, d) for x in (q, k, v, do)]
            want = dict(zip(("out", "dq", "dk", "dv"), (small.small_mha_reference(*view[:3]),
                                                        *small.small_mha_bwd_reference(*view))))
            got = {n: g.view(b, s, h, d) for n, g in got.items()}
            mismatched = sorted(
                n for n, w in want.items()
                if not (torch.equal(torch.isnan(got[n]), torch.isnan(w))
                        and bool(torch.isfinite(got[n][~torch.isnan(w)]).all()))
            )
            out.append({
                "case": f"fp32 NaN 0x{bits:08X} in {where} at packed {list(SMALL_NAN_AT)}",
                "shape_b_s_h_d": list(SMALL_NAN_CASE),
                "nan_elements": {n: int(torch.isnan(g).sum()) for n, g in got.items()},
                "plain_nan_elements": {n: int(torch.isnan(w).sum()) for n, w in want.items()},
                "mismatched": mismatched,
                "ok": not mismatched and any(bool(torch.isnan(w).any()) for w in want.values()),
            })
    del base
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


# The bucket-32 logits of a model pinned to fused_small (K10 in every block)
# against the same seeded weights with attn_impl="reference" (mha_reference:
# einsum scores, fp32 softmax, P rounded to the compute dtype before P.V,
# the same rounding points as K10).  precision -> (argv edit, bound as a
# share of the largest reference logit).  vit_tiny, bf16: the paths differ
# by summation order, which flips a bf16 rounding of P or of an output now
# and then, and each of 12 blocks adds such flips to a bf16 residual
# stream: 2^-6 of the largest logit (two bf16 ulps of it; at seed 0 they
# differ by one).  fp32: summation order only, through 12 blocks: 2^-18 (at
# seed 0, ~2^-21.7).  The planted fault (every K10 launch with the values
# of its last keys zeroed: 8 at 64 tokens) must exceed both.
SMALL_LOGIT_CHECKS = {
    "bf16": (lambda argv: argv, 2**-6),
    "fp32": (lambda argv: [a for a in argv if a != "--amp"], 2**-18),
}


def serve_pinned_phase(small, gm, vb, attn, phase: str, argv: list, logit_checks: dict,
                       fault_keys: int = 8) -> dict:
    """``argv``'s model served through the port's library entry points:
    ``build_engine(hparams, attn_impl="fused_small")`` warmed, then
    ``MicroBatcher`` and ``closed_loop`` as ``serve_main`` composes them.
    The counters are zeroed after the warmup; every block of every
    dispatched batch runs K10 and no other kernel.  For each precision of
    ``logit_checks`` (as ``SMALL_LOGIT_CHECKS``): the bucket-32 logits
    against ``attn_impl="reference"`` within its bound, which a planted K10
    fault (the values of the last ``fault_keys`` keys of every item zeroed)
    exceeds, and a bucket-32 dispatch timed and profiled under fused_small
    and auto (``bucket32_dispatch``)."""
    import numpy as np

    from distributed_training_comparison_tpu_torch.serve import (
        MicroBatcher,
        build_engine,
        closed_loop,
        request_pool,
    )

    hp = load_config(argv)
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
    depth, tokens = len(engine.model.blocks), engine.model.pos_emb.shape[1]
    summary = batcher.metrics.summary()
    del engine

    checks = {}
    for precision, (edit, share) in logit_checks.items():
        h = load_config(edit(argv))
        batch = request_pool(32, image_size=h.image_size, seed=h.seed, fold=("check", 0))
        engines = {"fused_small": build_engine(h, attn_impl="fused_small"),
                   "reference": build_engine(h, attn_impl="reference")}
        rec = {}
        for name, eng in engines.items():
            before = small.small_mha_fwd.launches
            rec[f"logits_{name}"] = eng.predict_logits(batch)
            rec[f"k10_launches_{name}"] = small.small_mha_fwd.launches - before
        with dropped_keys_k10(small, n=fault_keys):
            fault = eager_logits(engines["fused_small"], batch)
        got, want = rec.pop("logits_fused_small"), rec.pop("logits_reference")
        scale = float(np.abs(want).max())
        rec.update({
            "logits_finite": bool(np.isfinite(got).all() and np.isfinite(want).all()),
            "logits_max_abs_err_vs_reference": float(np.abs(got - want).max()),
            "logits_scale": scale, "logits_tol": share * scale, "logits_tol_share": share,
            "fault_keys": fault_keys,
            "fault_logits_max_abs_err_vs_reference": float(np.abs(fault - want).max()),
        })
        rec.update(bucket32_dispatch({"fused_small": engines["fused_small"], "auto": build_engine(h)},
                                     batch))
        checks[precision] = rec
        del engines
    return {
        "phase": phase,
        "argv": argv,
        "attn_impl": "fused_small",
        "tokens": tokens,
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


def bucket32_dispatch(engines: dict, batch, csrc: Path | None = None) -> dict:
    """One bucket-32 dispatch of ``batch`` through each of ``engines``
    (``fused_small`` and ``auto``): host ms a dispatch (5 after a warm one,
    in turns, twice) and a profile of 5: busy ms, idle share, the port's
    kernels by symbol (``csrc``'s, this checkout's by default) and K10's
    device ms and share."""
    rec = {}
    for rnd in ("", "_again"):
        for name, eng in engines.items():
            eng.predict_logits(batch)
            t0 = time.perf_counter()
            for _ in range(5):
                eng.predict_logits(batch)
            rec[f"bucket32_batch_ms_{name}{rnd}"] = (time.perf_counter() - t0) / 5 * 1e3
    for name, eng in engines.items():
        prof = profile_device(lambda: eng.predict_logits(batch), 5)
        port = _port_kernel_ms(prof["device_ms_by_name"], csrc=csrc)
        k10 = sum(t for n, t in port.items() if n.startswith("attn_small_"))
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
    return rec


def check_serve_pinned(serve: dict, kernels: dict) -> None:
    """A ``serve_pinned_phase`` record: no request lost, 12 blocks, K10 in
    every block of every dispatched batch and no other counter, each
    precision's bucket-32 logits within their bound and the planted fault
    past it, and its bucket-32 dispatch running ``kernels[precision]``'s
    forward kernels alone, by symbol."""
    phase = serve["phase"]
    if serve["completed"] != serve["offered"] or serve["failed"]:
        raise RuntimeError(f"{phase} lost requests: {serve}")
    want = {n: 0 for n in serve["launches"]}
    want["small_mha_fwd"] = serve["depth"] * serve["engine_batches"]
    if serve["depth"] != 12 or serve["launches"] != want:
        raise RuntimeError(f"{phase} launches {serve['launches']} at depth {serve['depth']}, expected {want}")
    if set(serve["bucket32"]) != set(kernels):
        raise RuntimeError(f"{phase} checked {sorted(serve['bucket32'])}, expected {sorted(kernels)}")
    for precision, rec in serve["bucket32"].items():
        if (rec["k10_launches_fused_small"], rec["k10_launches_reference"]) != (serve["depth"], 0):
            raise RuntimeError(f"{phase} {precision} bucket-32 batch: launches {rec}")
        if not rec["logits_finite"] or rec["logits_max_abs_err_vs_reference"] > rec["logits_tol"]:
            raise RuntimeError(f"{phase} {precision}: K10 logits disagree with the reference: {rec}")
        if not rec["fault_logits_max_abs_err_vs_reference"] > rec["logits_tol"]:
            raise RuntimeError(f"{phase} {precision}: the planted K10 fault passes the bound: {rec}")
        # no other kernel of the port, by name
        want_kernels = list(kernels[precision]["fwd"])
        got_kernels = rec["bucket32_profile_fused_small"]["port_kernels"]
        if got_kernels != want_kernels:
            raise RuntimeError(f"{phase} {precision} bucket-32 dispatch ran {got_kernels}, "
                               f"expected {want_kernels}")


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


def small_step_check(small, precision: str, argv: list = TRAIN_SMALL_ARGV) -> dict:
    """One step of ``argv``'s model pinned to fused_small against the
    reference attention and against the plain kernels, with
    ``SMALL_STEP_CHECKS[precision]``'s argv edit, bounds and planted
    fault."""
    from distributed_training_comparison_tpu_torch.train import build_model
    from distributed_training_comparison_tpu_torch.train.step import COMPUTE_DTYPES

    edit, loss_tol, ref_tol, plain_tol = SMALL_STEP_CHECKS[precision]
    hp = load_config(edit(argv))
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


def fit_pinned(small, gm, vb, attn, phase: str, smi: str, argv: list):
    """``argv``'s model trained through the port's library entry points,
    ``Trainer(hparams, model=build_model(hparams, attn_impl="fused_small"))``
    and ``fit``, the counters zeroed just before and read just after: the
    trainer, and the phase's record of the run."""
    import torch

    from distributed_training_comparison_tpu_torch.train import Trainer, build_model

    hp = load_config(argv)
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
    return trainer, {
        "phase": phase,
        "nvidia_smi": smi,
        "argv": argv,
        "attn_impl": "fused_small",
        "precision": hp.precision,
        "batch": hp.batch_size,
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
    }


def train_small_phase(small, gm, vb, attn, smi: str) -> dict:
    """``vit_tiny --amp`` at batch 256 (the JAX kernels' design point)
    trained through the port's library entry points (``fit_pinned``): K10
    in every block of every train step and eval batch, K11 in every block
    of every train step, no other kernel; every loss finite, no step
    skipped; one step's loss and gradients against the reference attention
    and the plain kernels (bf16 and fp32); ms per step under fused_small and
    auto, and step profiles."""
    trainer, record = fit_pinned(small, gm, vb, attn, "train_small", smi, TRAIN_SMALL_ARGV)
    record["step_checks"] = {p: small_step_check(small, p) for p in SMALL_STEP_CHECKS}
    record["step_times"] = small_step_times(trainer)
    return record


def check_train_pinned(run: dict, kernels: dict, shape: tuple | None = None,
                       profile: str = "fused_small") -> None:
    """A ``fit_pinned`` record: 12 blocks and, where given, ``shape``
    (precision, batch, train steps, eval batches); K10 in every block of
    every step and eval batch, K11 in every block of every step and no
    other counter; every loss finite, no step skipped, every step check
    within its bounds; the step profile (``run["step_times"][profile]``)
    running ``kernels`` alone, by symbol."""
    phase, depth, steps = run["phase"], run["depth"], run["train_steps"]
    got_shape = (run["precision"], run["batch"], steps, run["eval_batches"])
    if depth != 12 or shape is not None and got_shape != shape:
        raise RuntimeError(f"{phase} ran {got_shape} at depth {depth}, expected {shape} at depth 12")
    want = {n: 0 for n in run["launches"]}
    want["small_mha_fwd"] = depth * (steps + run["eval_batches"])
    want["small_mha_bwd"] = depth * steps
    if run["launches"] != want:
        raise RuntimeError(f"{phase} launches {run['launches']}, expected {want}")
    if not run["losses_finite"] or run["skipped_steps"]:
        raise RuntimeError(f"{phase}: a non-finite loss or a skipped step")
    bad = {p: c for p, c in run.get("step_checks", {}).items() if not c["ok"]}
    if bad:
        raise RuntimeError(f"a {phase} step through K10/K11 disagrees: {bad}")
    # no other kernel of the port, by name
    want_kernels = sorted(kernels["fwd"] + kernels["bwd"])
    got_kernels = run["step_times"][profile]["port_kernels"]
    if got_kernels != want_kernels:
        raise RuntimeError(f"a {phase} step ran {got_kernels}, expected {want_kernels}")


# vit_tiny at 64 tokens (32 px, patch 4) trained at the default precision
# (fp32: no --amp), batch 256, one epoch: 792 training images (3 steps) and
# 88 validation images (one batch)
TRAIN_SMALL_FP32_ARGV = [
    "--model", "vit_tiny", "--synthetic-data", "--batch-size", "256",
    "--limit-examples", "880", "--epoch", "1", "--lr-decay-step-size", "1",
]


def pinned_step_times(trainer, csrc: Path | None = None, rounds: int = 1) -> dict:
    """ms per train step (CUDA events over 3 steps of the trainer's first
    batch, after a warm step) of the fused_small ``trainer`` and of a
    trainer of the same command under auto (the reference attention), in
    turns, ``rounds`` times (the second round's keys end in ``_again``); a
    profile of two steps of each: busy time, idle share, the busy time
    split into K10's kernels, K11's, the GEMMs (cuBLAS, by name) and the
    rest, and the port's kernels by symbol (``csrc``'s, this checkout's by
    default)."""
    import torch

    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.train import Trainer
    from distributed_training_comparison_tpu_torch.utils import step_generator

    hp = trainer.hparams
    images, labels = next(trainer.train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    trainers = {"fused_small": trainer, "auto": Trainer(hp)}
    out = {name: {} for name in trainers}
    for rnd in ("", "_again")[:rounds]:
        for name, tr in trainers.items():
            ms = cuda_ms(lambda: tr.step(images, labels, draws), 3, warmup=1)
            out[name][f"ms_per_step{rnd}"] = ms
            out[name][f"images_per_s_timed{rnd}"] = hp.batch_size / ms * 1e3
    for name, tr in trainers.items():
        prof = profile_device(lambda: tr.step(images, labels, draws), 2)
        names, busy = prof["device_ms_by_name"], prof["device_busy_ms"]
        port = _port_kernel_ms(names, csrc=csrc)
        split = {
            "k10": sum(t for n, t in port.items() if n.startswith("attn_small_fwd")),
            "k11": sum(t for n, t in port.items() if n.startswith(("attn_small_dq", "attn_small_dkv",
                                                                   "attn_small_bwd"))),
            # cuBLAS: its bf16 GEMMs run as nvjet_* kernels on this card
            "gemm": sum(t for n, t in names.items() if "gemm" in n.lower() or n.startswith("nvjet")),
        }
        split["rest"] = busy - sum(split.values())
        top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
        out[name].update({
            "wall_ms_per_step": prof["wall_ms"],
            "device_busy_ms_per_step": busy,
            "device_idle_share": prof["device_idle_share"],
            "device_ms_per_step": split,
            "k10_k11_share_of_busy": (split["k10"] + split["k11"]) / busy,
            "port_kernels": sorted(port),
            "port_kernel_ms_per_step": port,
            "top_device_ms_per_step": {n[:60]: t for n, t in top},
        })
    del trainers["auto"]
    torch.cuda.empty_cache()
    return out


def train_small_fp32_phase(small, gm, vb, attn, smi: str) -> dict:
    """``vit_tiny`` at 64 tokens trained at the default precision
    (``TRAIN_SMALL_FP32_ARGV``: fp32, batch 256, 12 blocks of 3 heads of
    64) through ``fit_pinned``: K10 in every block of every step and eval
    batch, K11 in every block of every step; then ``pinned_step_times``."""
    import torch

    trainer, record = fit_pinned(small, gm, vb, attn, "train_small_fp32", smi, TRAIN_SMALL_FP32_ARGV)
    record["step_times"] = pinned_step_times(trainer)
    del trainer
    torch.cuda.empty_cache()
    return record


# vit_small --patch-size 2 (12 blocks, dim 384, 6 heads of 64, 256 tokens at
# 32 px) pinned to fused_small: the fusion gate declines it (pinned
# attention; its fused weights are over the 8 MiB budget), so every block
# runs the tiled bf16 K10 forward and K11 backward.  Serving: buckets 1..32,
# 128 requests at concurrency 32.  Training: batch 128, one epoch over 792
# synthetic training images (6 steps) and 88 validation images (one batch).
SERVE_VITS_P2_ARGV = [
    "--serve", "--model", "vit_small", "--patch-size", "2", "--amp",
    "--serve-buckets", "1,2,4,8,16,32", "--serve-shape", "closed",
    "--serve-requests", "128", "--serve-concurrency", "32", "--seed", "0",
]
TRAIN_VITS_P2_ARGV = [
    "--model", "vit_small", "--patch-size", "2", "--amp", "--synthetic-data", "--batch-size", "128",
    "--limit-examples", "880", "--epoch", "1", "--lr-decay-step-size", "1",
]
# The bucket-32 logits against attn_impl="reference" as a share of the
# largest: serve_small's bf16 bound, 2^-6, for its reason (summation order
# flips a bf16 rounding now and then in each of 12 blocks).  The planted
# fault zeroes the values of the last 64 of the 256 keys in every K10 launch
# (small_attention_checks' fault past one tile).
VITS_P2_LOGIT_CHECKS = {"bf16": SMALL_LOGIT_CHECKS["bf16"]}


def train_vits_p2_phase(small, gm, vb, attn, smi: str) -> dict:
    """``vit_small --patch-size 2 --amp`` at batch 128 trained through
    ``fit_pinned``: K10 in every block of every step and eval batch, K11 in
    every block of every step, no other kernel; every loss finite, no step
    skipped; one step against the reference attention and the plain
    kernels with ``train_small``'s bf16 bounds (``small_step_check``); ms per
    step under fused_small and auto in two rounds, busy and idle shares,
    K10/K11 shares (``pinned_step_times``)."""
    import torch

    trainer, record = fit_pinned(small, gm, vb, attn, "train_vits_p2", smi, TRAIN_VITS_P2_ARGV)
    record["step_checks"] = {"bf16": small_step_check(small, "bf16", TRAIN_VITS_P2_ARGV)}
    record["step_times"] = pinned_step_times(trainer, rounds=2)
    del trainer
    torch.cuda.empty_cache()
    return record


# ------------------------------------------- ResNet-18: no kernel of the port

# ResNet-18, the entry point's default model, served with --amp: buckets
# 1..32, 128 requests at concurrency 32.  Trained with --amp at batch 128,
# one epoch over 792 synthetic training images (6 steps) and 88 validation
# images (one batch); at the default precision (fp32, no --model, no --amp),
# 396 training images (3 steps) and 44 validation images (one batch).
SERVE_RESNET_ARGV = [
    "--serve", "--model", "resnet18", "--amp",
    "--serve-buckets", "1,2,4,8,16,32", "--serve-shape", "closed",
    "--serve-requests", "128", "--serve-concurrency", "32", "--seed", "0",
]
TRAIN_RESNET_ARGV = [
    "--model", "resnet18", "--amp", "--synthetic-data", "--batch-size", "128",
    "--limit-examples", "880", "--epoch", "1", "--lr-decay-step-size", "1",
]
TRAIN_RESNET_FP32_ARGV = [
    "--synthetic-data", "--batch-size", "128", "--limit-examples", "440", "--epoch", "1",
    "--lr-decay-step-size", "1",
]
# one step of the deepest bottleneck net the remat check runs, at ImageNet
# size: 36 training images, one batch of 32
RESNET_REMAT_ARGV = [
    "--model", "resnet50", "--stem", "imagenet", "--image-size", "224", "--amp", "--remat",
    "--synthetic-data", "--batch-size", "32", "--limit-examples", "40", "--epoch", "1",
]
# The bf16 engine's bucket-32 logits against an fp32 engine on the same
# seeded weights, as a share of the largest fp32 logit.  Fresh weights serve
# with fresh running statistics (mean 0, var 1), so eval mode does not
# normalize and the logits reach ~90; each of 20 convolutions rounds its
# input and weight to bf16 (2^-9 relative): the port's CPU path reads 0.7%
# of the largest, the H100 0.63%.  2^-5 of it; a planted fault, one
# BatchNorm's running variance zeroed, reads ~180x the largest on the CPU
# and on the H100.
RESNET_SERVE_SHARE = 2**-5
# One bf16 train step against an fp32 step on the same weights and batch.
# BatchNorm's backward makes this net's gradients ill-conditioned on the
# synthetic batches: the gradients of BatchNorm's scale and bias and of the
# layers before them are sums over N*H*W that cancel, so that fp32's own
# rounding moves them by 0.56% (median) to 0.93% from an fp64 step, and bf16
# rounding by ~30%: on the CPU the port's bf16 step reads 29% median and 40%
# at worst against its fp32 step, and the JAX package's own bf16 step 27%
# and 34% against its fp32 one (batch 64).  Bounds: the loss within 2^-8
# relative (reads 2^-12), every gradient within 2^-1 relative L2, the head's
# (well conditioned: reads 0.7%) within 2^-5; the H100 reads 30% median, 38%
# at worst and 0.67% at the head.  The planted fault, the fp32 step with one
# BatchNorm (layer3.0.bn1) normalizing by its running statistics, reads
# ~100% median and 9-10% at the head on the CPU and on the H100.
RESNET_STEP_TOL = {"loss": 2**-8, "grads": 2**-1, "head": 2**-5}
# The fp32 step on the card against the port's CPU path on the same weights
# and batch: the eval-mode logits within 2^-14 of the largest (the CPU path
# against fp64 reads 2^-20), the loss within 1e-5 relative, every gradient
# within 2^-5 relative L2 (the fp32 rounding above, ~1% against fp64 on
# either side).  A TF32 control (the same step with cuDNN's convolutions in
# TF32, 2^-11 relative a product) must exceed the gradient bound.  Read on
# the H100: logits 2^-19.6 of the largest, gradients 0.57% at worst, the
# TF32 control 13%.
RESNET_FP32_TOL = {"logits": 2**-14, "loss": 1e-5, "grads": 2**-5}
# step_profile's split of a ResNet step: cuDNN's convolutions (and the
# head's cuBLAS GEMM, ~0.1% of them), BatchNorm's kernels (the running
# statistics' foreach lerp included), the optimizer's and the guard's
# foreach kernels, and the rest (ReLU, the residual adds, casts and
# reductions).
RESNET_STEP_BUCKETS = (
    # the profiler's span of the optimizer step, over its kernels: not busy time of its own
    ("optimizer_span", ("optimizer.step#",)),
    ("batch_norm", ("batch_norm", "lerp")),
    ("optimizer", ("multi_tensor_apply",)),
    ("conv", ("conv", "xmma", "implicit", "cudnn", "cutlass", "sm90_", "sm80_", "nchw", "nhwc",
              "gemm", "nvjet")),
)


def resnet_forward_macs(model, image_size: int) -> int:
    """Multiply-adds of one image's forward through ``model``'s
    convolutions and head, from the output shapes of a batch-1 forward."""
    import torch

    macs = []

    def conv_hook(m, inputs, out):
        macs.append(out[0].numel() * m.weight[0].numel())

    def head_hook(m, inputs, out):
        macs.append(m.weight.numel())

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    hooks.append(model.linear.register_forward_hook(head_hook))
    was_training = model.training
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, image_size, image_size, 3, device=model.linear.weight.device))
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    return sum(macs)


def _running_stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def serve_resnet_phase(small, gm, vb, attn) -> dict:
    """``SERVE_RESNET_ARGV`` served through the port's library entry points
    (``build_engine`` warmed, then ``MicroBatcher`` and ``closed_loop`` as
    ``serve_main`` composes them), every kernel counter of the port zeroed
    after the warmup; then one dispatch of each bucket's size
    (``bucket_dispatch``: host ms, busy ms, idle share), and the bucket-32
    logits against an fp32 engine on the same weights within
    ``RESNET_SERVE_SHARE`` of the largest, which a planted fault (one
    BatchNorm's running variance zeroed) must exceed."""
    import numpy as np
    import torch

    from distributed_training_comparison_tpu_torch.serve import (
        MicroBatcher,
        build_engine,
        closed_loop,
        request_pool,
    )

    hp = load_config(SERVE_RESNET_ARGV)
    engine = build_engine(hp)
    engine.warmup()
    warm = dict(engine.bucket_counts)
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
    served = {b: engine.bucket_counts[b] - warm[b] for b in engine.buckets}
    dispatch = bucket_dispatch(engine, hp, buckets=engine.buckets)
    batch = request_pool(32, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    got = engine.predict_logits(batch)
    fp32 = build_engine(load_config([a for a in SERVE_RESNET_ARGV if a != "--amp"]))
    want = fp32.predict_logits(batch)
    with torch.no_grad():
        engine.model.layer2[1].bn1.running_var.zero_()
    fault = engine.predict_logits(batch)
    scale = float(np.abs(want).max())
    summary = batcher.metrics.summary()
    return {
        "phase": "serve_resnet",
        "argv": SERVE_RESNET_ARGV,
        "offered": report["offered"],
        "completed": report["completed"],
        "failed": report["failed"],
        "shed": report["shed"],
        "throughput_rps": report["throughput_rps"],
        "p50_ms": report["latency_ms"]["p50"],
        "p99_ms": report["latency_ms"]["p99"],
        "duration_s": report["duration_s"],
        "mean_batch_size": summary["mean_batch_size"],
        "mean_service_ms": summary["mean_service_ms"],
        "served_batches_by_bucket": served,
        "launches": launches,
        "bucket_dispatch": dispatch,
        "bucket32_busy_ms": dispatch["32"]["device_busy_ms"],
        "bucket32_idle_share": dispatch["32"]["device_idle_share"],
        "logits_finite": bool(np.isfinite(got).all()),
        "logits_max_abs_err_vs_fp32": float(np.abs(got - want).max()),
        "logits_scale": scale,
        "logits_tol": RESNET_SERVE_SHARE * scale,
        "logits_tol_share": RESNET_SERVE_SHARE,
        "fault_logits_max_abs_err_vs_fp32": float(np.abs(fault - want).max()),
    }


def check_serve_resnet(serve: dict) -> None:
    if serve["completed"] != serve["offered"] or serve["failed"]:
        raise RuntimeError(f"serve_resnet lost requests: {serve}")
    if any(serve["launches"].values()):
        raise RuntimeError(f"serve_resnet launched kernels of the port: {serve['launches']}")
    if sorted(serve["bucket_dispatch"]) != sorted(str(b) for b in (1, 2, 4, 8, 16, 32)):
        raise RuntimeError(f"serve_resnet dispatched the buckets {sorted(serve['bucket_dispatch'])}")
    if not serve["logits_finite"] or serve["logits_max_abs_err_vs_fp32"] > serve["logits_tol"]:
        raise RuntimeError(f"serve_resnet's bf16 logits disagree with fp32's: {serve}")
    if not serve["fault_logits_max_abs_err_vs_fp32"] > serve["logits_tol"]:
        raise RuntimeError(f"serve_resnet's bound passes a planted fault: {serve}")


def resnet_step_grads(hp, state: dict, images, labels, *, device: str, eval_bn: str | None = None):
    """One forward and backward of ``hp``'s model on ``state``, ``images``
    and ``labels`` (moved to ``device``) in train mode, with the BatchNorm
    ``eval_bn`` normalizing by its running statistics where given (a
    planted fault): the loss and every parameter's gradient, on the CPU."""
    from distributed_training_comparison_tpu_torch.train import build_model, forward_backward
    from distributed_training_comparison_tpu_torch.train.step import COMPUTE_DTYPES

    model = build_model(hp)
    model.load_state_dict(state)
    model = model.to(device).train()
    if eval_bn is not None:
        model.get_submodule(eval_bn).eval()
    loss, _, _ = forward_backward(model, images.to(device), labels.to(device),
                                  compute_dtype=COMPUTE_DTYPES[hp.precision])
    return loss.item(), {n: p.grad.detach().cpu() for n, p in model.named_parameters()}


def resnet_step_times(trainer, bound_ms: float, reps: int = 5) -> dict:
    """ms per train step (CUDA events over ``reps`` steps of the trainer's
    first batch after a warm one), its share of ``bound_ms``, and
    ``step_profile``'s split into convolutions, BatchNorm, the optimizer and
    the rest."""
    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.utils import step_generator

    hp = trainer.hparams
    images, labels = next(trainer.train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    ms = cuda_ms(lambda: trainer.step(images, labels, draws), reps, warmup=1)
    profile = step_profile(trainer, buckets=RESNET_STEP_BUCKETS)
    busy = profile["device_busy_ms_per_step"]
    return {
        "ms_per_step": ms,
        "images_per_s_timed": hp.batch_size / ms * 1e3,
        "bound_ms": bound_ms,
        "bound_share_of_step": bound_ms / ms,
        "bound_share_of_busy": bound_ms / busy,
        "busy_share": {k: v / busy for k, v in profile["device_ms_per_step"].items()
                       if k != "optimizer_span"},
        "step_profile": profile,
    }


def _resnet_fit(argv: list, counters: dict) -> dict:
    """``argv`` trained through ``entry.run``, the counters zeroed just
    before and read just after: the run's record."""
    import torch

    from distributed_training_comparison_tpu_torch.data import get_datasets

    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = run_entry(argv)
    seconds = time.perf_counter() - t0
    hp = load_config(argv)
    epochs = report["fit"]["epochs"]
    return {
        "argv": argv,
        "model": hp.model,
        "precision": hp.precision,
        "batch": hp.batch_size,
        "run_seconds": seconds,
        "train_steps": sum(e["steps"] for e in epochs),
        "eval_batches": len(epochs) * math.ceil(len(get_datasets(hp)[1][1]) / hp.batch_size),
        "launches": {name: c.launches for name, c in counters.items()},
        "losses_finite": all(e["nonfinite_losses"] == 0 for e in epochs),
        "skipped_steps": sum(e["skipped"] for e in epochs),
        "epochs": epochs,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }


def resnet_remat_check() -> dict:
    """One step of ``RESNET_REMAT_ARGV`` (ResNet-50, imagenet stem, 224 px,
    bf16, batch 32) with ``--remat`` and without, on the same seeded weights
    and batch: the loss finite, and the running statistics the same (the
    recompute does not advance them a second time); the peak memory of each
    step."""
    import torch

    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.train import Trainer
    from distributed_training_comparison_tpu_torch.utils import step_generator

    out = {}
    for name, argv in (("remat", RESNET_REMAT_ARGV),
                       ("plain", [a for a in RESNET_REMAT_ARGV if a != "--remat"])):
        hp = load_config(argv)
        trainer = Trainer(hp)
        images, labels = next(trainer.train_split.epoch_batches(hp.batch_size, hp.seed, 0))
        draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
        before = _running_stats(trainer.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m = trainer.step(images, labels, draws)
        after = _running_stats(trainer.model)
        out[name] = {"loss": m["loss"].item(), "skipped": m["skipped"].item(), "stats": after,
                     "moved": max((after[k] - before[k]).abs().max().item() for k in after),
                     "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "remat": trainer.model.remat}
        del trainer
        torch.cuda.empty_cache()
    remat, plain = out["remat"], out["plain"]
    scale = max(v.abs().max().item() for v in plain["stats"].values())
    diff = max((remat["stats"][k] - v).abs().max().item() for k, v in plain["stats"].items())
    return {
        "argv": RESNET_REMAT_ARGV,
        "loss_remat": remat["loss"], "loss_plain": plain["loss"],
        "skipped": remat["skipped"] + plain["skipped"],
        "remat_set": remat["remat"] and not plain["remat"],
        "stats_moved": plain["moved"],
        "stats_max_abs_diff": diff, "stats_scale": scale,
        "stats_tol": 2**-20 * scale,
        "stats_bit_identical": diff == 0.0,
        "peak_memory_gb_remat": remat["peak_memory_gb"],
        "peak_memory_gb_plain": plain["peak_memory_gb"],
    }


def train_resnet_phase(small, gm, vb, attn, smi: str) -> dict:
    """``TRAIN_RESNET_ARGV`` (ResNet-18, bf16, batch 128) trained through
    ``entry.run`` (``_resnet_fit``: no kernel of the port launches); one
    step against an fp32 step on the same weights and batch
    (``RESNET_STEP_TOL``, with its planted fault); a trainer of the same
    command timed (``resnet_step_times`` against the operation bound at
    the bf16 peak), its running statistics moved by those steps, and its
    eval-mode logits against its train-mode ones on one batch; then the
    remat check (``resnet_remat_check``)."""
    import torch

    from distributed_training_comparison_tpu_torch.data import normalize_images
    from distributed_training_comparison_tpu_torch.train import Trainer, build_model

    record = {"phase": "train_resnet", "nvidia_smi": smi,
              **_resnet_fit(TRAIN_RESNET_ARGV, _small_path_counters(small, gm, vb, attn))}
    hp = load_config(TRAIN_RESNET_ARGV)
    hp32 = load_config([a for a in TRAIN_RESNET_ARGV if a != "--amp"])
    state = build_model(hp32).state_dict()
    images, labels = _first_batch(hp)
    runs = {name: resnet_step_grads(h, state, images, labels, device="cuda", eval_bn=bn)
            for name, h, bn in (("bf16", hp, None), ("fp32", hp32, None),
                                ("fault", hp32, "layer3.0.bn1"))}
    want_loss, want = runs["fp32"]
    check = {"tol": RESNET_STEP_TOL}
    for name in ("bf16", "fault"):
        loss, grads = runs[name]
        errors = grad_errors(grads, want)
        check[name] = {
            "loss": loss, "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
            "grad_rel_l2_max": max(errors.values()),
            "grad_rel_l2_median": sorted(errors.values())[len(errors) // 2],
            "grad_rel_l2_worst": _worst(errors), "head_rel_l2": errors["linear.weight"],
            "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads.values()),
        }
    check["loss_fp32"] = want_loss
    record["step_check"] = check

    trainer = Trainer(hp)
    macs = resnet_forward_macs(trainer.model, hp.image_size)
    flops = 6 * macs * hp.batch_size  # forward, and twice its products backward
    record.update({"forward_macs_per_image": macs, "step_flops": flops})
    before = _running_stats(trainer.model)
    record["step_times"] = resnet_step_times(trainer, flops / PEAK_FLOPS["bfloat16"] * 1e3)
    after = _running_stats(trainer.model)
    record["running_stats_max_move"] = max((after[k] - before[k]).abs().max().item() for k in after)
    x = normalize_images(images, dtype=torch.bfloat16)
    with torch.no_grad():
        eval_logits = trainer.model.eval()(x)
        train_logits = trainer.model.train()(x)
    record["eval_vs_train_logits_max_abs_diff"] = (eval_logits - train_logits).abs().max().item()
    del trainer
    torch.cuda.empty_cache()
    record["remat"] = resnet_remat_check()
    return record


def check_train_resnet(run: dict) -> None:
    if (run["model"], run["precision"], run["batch"]) != ("resnet18", "bf16", 128):
        raise RuntimeError(f"train_resnet ran {run['model']} {run['precision']} at batch {run['batch']}")
    if (run["train_steps"], run["eval_batches"]) != (6, 1):
        raise RuntimeError(f"train_resnet ran {run['train_steps']} steps and {run['eval_batches']} eval batches")
    if any(run["launches"].values()):
        raise RuntimeError(f"train_resnet launched kernels of the port: {run['launches']}")
    if not run["losses_finite"] or run["skipped_steps"]:
        raise RuntimeError("train_resnet: a non-finite loss or a skipped step")
    if not run["running_stats_max_move"] > 0 or not run["eval_vs_train_logits_max_abs_diff"] > 0:
        raise RuntimeError(f"train_resnet: the running statistics did not move or eval ignored them: {run}")
    check, tol = run["step_check"], RESNET_STEP_TOL
    bf16, fault = check["bf16"], check["fault"]
    if not (bf16["grads_finite"] and bf16["loss_rel_err"] <= tol["loss"]
            and bf16["grad_rel_l2_max"] <= tol["grads"] and bf16["head_rel_l2"] <= tol["head"]):
        raise RuntimeError(f"train_resnet's bf16 step disagrees with fp32's: {check}")
    if not (fault["grad_rel_l2_median"] > tol["grads"] and fault["head_rel_l2"] > tol["head"]):
        raise RuntimeError(f"train_resnet's bounds pass a planted fault: {check}")
    remat = run["remat"]
    if not (remat["remat_set"] and remat["skipped"] == 0 and math.isfinite(remat["loss_remat"])
            and remat["stats_moved"] > 0 and remat["stats_max_abs_diff"] <= remat["stats_tol"]):
        raise RuntimeError(f"train_resnet's remat step: {remat}")


def train_resnet_fp32_phase(small, gm, vb, attn, smi: str) -> dict:
    """The entry point's default, ResNet-18 at the default precision (fp32:
    no ``--model``, no ``--amp``), trained through ``entry.run`` with cuDNN
    set to run fp32 convolutions as TF32, and to benchmark its algorithms
    with no determinism, first: the entry path pins them to fp32 and to
    cuDNN's deterministic algorithms, the settings read back ``ieee`` and
    deterministic, and no profiled kernel's name holds ``tf32``.  Its first-batch logits (eval mode) and one step's loss
    and gradients against the port's CPU path on the same weights and batch
    (``RESNET_FP32_TOL``; a TF32 control exceeds the gradient bound); ms per
    step against the operation bound at the fp32 peak."""
    import torch

    from distributed_training_comparison_tpu_torch import _device
    from distributed_training_comparison_tpu_torch.data import normalize_images
    from distributed_training_comparison_tpu_torch.train import Trainer, build_model

    knobs = _device.fp32_precision_knobs().values()
    for knob in knobs:
        knob.fp32_precision = "tf32"
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    settings_before = _device.fp32_math_settings()
    cudnn_before = _device.cudnn_determinism()
    record = {"phase": "train_resnet_fp32", "nvidia_smi": smi,
              **_resnet_fit(TRAIN_RESNET_FP32_ARGV, _small_path_counters(small, gm, vb, attn)),
              "fp32_math_before": settings_before,
              "fp32_math_after": _device.fp32_math_settings(),
              "cudnn_before": cudnn_before, "cudnn_after": _device.cudnn_determinism()}
    hp = load_config(TRAIN_RESNET_FP32_ARGV)
    trainer = Trainer(hp)
    macs = resnet_forward_macs(trainer.model, hp.image_size)
    flops = 6 * macs * hp.batch_size
    record.update({"forward_macs_per_image": macs, "step_flops": flops})
    record["step_times"] = resnet_step_times(trainer, flops / PEAK_FLOPS["float32"] * 1e3, reps=3)
    del trainer
    torch.cuda.empty_cache()

    state = build_model(hp).state_dict()
    images, labels = _first_batch(hp)
    logits = {}
    for device in ("cuda", "cpu"):
        model = build_model(hp)
        model.load_state_dict(state)
        with torch.no_grad():
            logits[device] = model.to(device).eval()(
                normalize_images(images.to(device), dtype=torch.float32)).cpu()
    runs = {device: resnet_step_grads(hp, state, images, labels, device=device)
            for device in ("cuda", "cpu")}
    for knob in knobs:
        knob.fp32_precision = "tf32"
    try:
        runs["tf32"] = resnet_step_grads(hp, state, images, labels, device="cuda")
    finally:
        _device.pin_card_math()
    want_loss, want = runs["cpu"]
    scale = logits["cpu"].abs().max().item()
    check = {"tol": RESNET_FP32_TOL,
             "logits_max_abs_err": (logits["cuda"] - logits["cpu"]).abs().max().item(),
             "logits_scale": scale, "logits_tol": RESNET_FP32_TOL["logits"] * scale,
             "loss_cpu": want_loss}
    for name in ("cuda", "tf32"):
        loss, grads = runs[name]
        errors = grad_errors(grads, want)
        check[name] = {"loss": loss, "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
                       "grad_rel_l2_max": max(errors.values()),
                       "grad_rel_l2_median": sorted(errors.values())[len(errors) // 2],
                       "grad_rel_l2_worst": _worst(errors)}
    record["cpu_check"] = check
    return record


def check_train_resnet_fp32(run: dict) -> None:
    if (run["model"], run["precision"], run["batch"]) != ("resnet18", "fp32", 128):
        raise RuntimeError(f"train_resnet_fp32 ran {run['model']} {run['precision']} at batch {run['batch']}")
    if (run["train_steps"], run["eval_batches"]) != (3, 1):
        raise RuntimeError(f"train_resnet_fp32 ran {run['train_steps']} steps and {run['eval_batches']} eval batches")
    if any(run["launches"].values()):
        raise RuntimeError(f"train_resnet_fp32 launched kernels of the port: {run['launches']}")
    if not run["losses_finite"] or run["skipped_steps"]:
        raise RuntimeError("train_resnet_fp32: a non-finite loss or a skipped step")
    if "tf32" not in run["fp32_math_before"].values() or set(run["fp32_math_after"].values()) != {"ieee"}:
        raise RuntimeError(f"train_resnet_fp32: the entry path left fp32 math at {run['fp32_math_after']} "
                           f"(set to {run['fp32_math_before']} before it)")
    if run["cudnn_after"] != {"deterministic": True, "benchmark": False}:
        raise RuntimeError(f"train_resnet_fp32: the entry path left cuDNN at {run['cudnn_after']} "
                           f"(set to {run['cudnn_before']} before it)")
    if run["step_times"]["step_profile"]["tf32_kernels"]:
        raise RuntimeError(f"train_resnet_fp32 ran TF32 kernels: {run['step_times']['step_profile']['tf32_kernels']}")
    check, tol = run["cpu_check"], RESNET_FP32_TOL
    card, tf32 = check["cuda"], check["tf32"]
    if not (check["logits_max_abs_err"] <= check["logits_tol"] and card["loss_rel_err"] <= tol["loss"]
            and card["grad_rel_l2_max"] <= tol["grads"]):
        raise RuntimeError(f"train_resnet_fp32's step on the card disagrees with the CPU path: {check}")
    if not tf32["grad_rel_l2_max"] > tol["grads"]:
        raise RuntimeError(f"train_resnet_fp32's gradient bound passes the TF32 control: {check}")


# The step program (``train/step.py``'s runners, ``serve/engine.py``'s
# bucket graphs): for each train path, the replayed step against the eager
# ``TrainStep`` and against the same step body run eagerly
# (``eager_body_step``) from one start; for each serve path, a replayed
# bucket-32 dispatch against the engine's eager forward (``eager_logits``).
# (label, argv, attn_impl or None for the entry point's own model)
STEP_PROGRAM_TRAIN = (
    ("train_resnet", TRAIN_RESNET_ARGV, None),
    ("train_resnet_fp32", TRAIN_RESNET_FP32_ARGV, None),
    ("train_resnet50_remat", RESNET_REMAT_ARGV, None),
    ("train_tiny", TRAIN_TINY_ARGV, None),
    ("train_moe", TRAIN_MOE_ARGV, None),
    ("train_small", TRAIN_SMALL_ARGV, "fused_small"),
    ("train_vits_p2", TRAIN_VITS_P2_ARGV, "fused_small"),
    ("train", TRAIN_ARGV, None),
)
STEP_PROGRAM_SERVE = (
    ("serve_resnet", SERVE_RESNET_ARGV),
    ("serve_tiny", SERVE_TINY_ARGV),
    ("serve_moe", SERVE_MOE_ARGV),
)
# Replayed steps against the same body run eagerly, after 1 + 3 steps from
# one start: the same kernels in the same order on the same inputs, so bit
# for bit, on every path and on the first run.  cuDNN's default fp32
# weight-gradient convolution sums with atomics (two eager runs of the fp32
# ResNet step differed, ~40% of a BatchNorm bias's momentum in four steps);
# the device choice holds cuDNN to its deterministic algorithms, so no path
# may differ.  A path that does is run again (``deterministic_rerun``: is
# the rerun bit for bit, where is the difference) and fails the phase.
STEP_PROGRAM_REPLAYS = 3


def _state_tensors(trainer) -> dict:
    """A trainer's parameters, buffers and momentum buffers by name."""
    out = dict(trainer.model.state_dict())
    for name, p in trainer.model.named_parameters():
        out[f"momentum:{name}"] = trainer.optimizer.state[p]["momentum_buffer"]
    return out


def state_agreement(got: dict, want: dict) -> dict:
    """Relative L2 error of each state tensor (``got`` against ``want``),
    the worst three, and whether every tensor is bit-identical."""
    import torch

    errors, bitwise = {}, True
    for name, w in want.items():
        g = got[name]
        bitwise &= bool(torch.equal(g, w))
        if w.is_floating_point():
            diff = (g.float() - w.float()).norm()
            errors[name] = float(diff / w.float().norm().clamp_min(1e-30)) if diff else 0.0
        else:
            errors[name] = float(not torch.equal(g, w))
    return {"bitwise": bitwise, "rel_l2_max": max(errors.values()), "worst": _worst(errors)}


def _counts(counters) -> list[int]:
    return [c.launches for c in counters]


# The port's kernels by the counted wrapper that launches them
# (``ops.COUNTED_WRAPPERS``), as (first, then): one call launches one kernel
# of ``first`` and, where it launches two, one of ``then`` after it (K6's
# attention dk/dv kernel after its dq kernel; K11's tiled dk/dv kernel after
# its dq kernel, where the one-tile kernel does not compute all three).
# K5's and K6's block wrappers launch nothing of their own: their chains
# count under the wrappers below them.
WRAPPER_KERNELS = {
    "flash_attention": (("flash_fwd_bf16", "flash_fwd_tf32x3"), ()),
    "flash_attention_dq": (("flash_bwd_dq_bf16", "flash_bwd_dq_tf32x3"), ()),
    "flash_attention_dkv": (("flash_bwd_dkv_bf16", "flash_bwd_dkv_tf32x3"), ()),
    "small_mha_fwd": (("attn_small_fwd_onetile", "attn_small_fwd_bf16", "attn_small_fwd_f32"), ()),
    "small_mha_bwd": (("attn_small_bwd_onetile", "attn_small_dq_bf16", "attn_small_dq_f32"),
                      ("attn_small_dkv_bf16", "attn_small_dkv_f32")),
    "grouped_ffn_fwd": (("moe_ffn_fwd_wgmma", "moe_ffn_fwd_tf32x3"), ()),
    "grouped_ffn_dx": (("moe_ffn_dx_wgmma", "moe_ffn_dx_tf32x3"), ()),
    "grouped_ffn_dw": (("moe_ffn_dw_wgmma", "moe_ffn_dw_tf32x3"), ()),
    "fused_vit_block": ((), ()),
    "block_gemm": (("block_gemm_wgmma", "block_gemm_tf32x3"), ()),
    "block_attention": (("block_attn_wgmma", "block_attn_tf32x3"), ()),
    "fused_vit_block_bwd": ((), ()),
    "block_ln": (("ln_rows",), ()),
    "block_gemm_dgrad": (("dgrad_wgmma", "dgrad_tf32x3"), ()),
    "block_ln_bwd": (("ln_bwd",), ()),
    "block_gemm_wgrad": (("wgrad_wgmma", "wgrad_tf32x3"), ()),
    "block_attention_bwd": (("attn_dq_wgmma", "block_attn_dq_tf32x3"),
                            ("attn_dkv_wgmma", "block_attn_dkv_tf32x3")),
    "block_grad_reduce": (("grad_reduce",), ()),
}


def _wrapper_names() -> list[str]:
    """The counted wrappers' names in ``ops.counted_wrappers()``'s order."""
    from distributed_training_comparison_tpu_torch import ops

    return [n for names in ops.COUNTED_WRAPPERS.values() for n in names]


def check_wrapper_kernels() -> None:
    """``WRAPPER_KERNELS`` names every counted wrapper and every kernel the
    checkout's sources define, each kernel under one wrapper."""
    symbols = [s for first, then in WRAPPER_KERNELS.values() for s in (*first, *then)]
    defined = {m.group(1) for f in (ROOT / PKG / "ops" / "csrc").glob("*.cu")
               for m in _GLOBAL_FN.finditer(f.read_text())}
    if sorted(_wrapper_names()) != sorted(WRAPPER_KERNELS) or sorted(symbols) != sorted(defined):
        raise RuntimeError(f"WRAPPER_KERNELS is not the registry's wrappers over the sources' "
                           f"kernels: {sorted(set(symbols) ^ defined)}")


def ledger_against_device(ledger, launches: dict) -> dict:
    """A graph's launch counts against the port's kernels one replay ran on
    the device: ``ledger`` the graph's ``LaunchLedger`` (each counted
    wrapper's movement over the capture, which every replay adds),
    ``launches`` one replay's launches by symbol under the profiler.  Each
    wrapper's ``WRAPPER_KERNELS`` first kernels must have launched as often
    as its count, and its then kernels at most as often; ``ok`` says
    whether all did."""
    rows, ok = {}, True
    for name, count in zip(_wrapper_names(), ledger.deltas):
        first, then = WRAPPER_KERNELS[name]
        on_device = sum(launches.get(s, 0) for s in first)
        after = sum(launches.get(s, 0) for s in then)
        good = (not first or on_device == count) and after <= count
        ok &= good
        if count or on_device or after:
            rows[name] = {"counted": count, "first_kernels_launched": on_device,
                          "then_kernels_launched": after, "ok": good}
    return {"ok": ok, "by_wrapper": rows}


def device_launches(fn, reps: int = 1, traces: int = 3) -> dict:
    """Launches a call by kernel name of ``reps`` calls of ``fn`` under the
    profiler, after one call that the tracer runs and discards (a
    schedule's warm-up step: a trace that begins with a replay can miss
    kernels at its start).  A trace can still drop a kernel's record (one
    of a ``train_vits_p2`` replay's twelve ``attn_small_fwd_bf16`` went
    missing in one trace) and never adds one, so each name's count is its
    most over ``traces`` traces with device activity; a trace with none is
    taken again, at most four times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    best: dict = {}
    taken = 0
    for attempt in range(traces + 4):  # at most four traces with no activity
        if taken == traces:
            break
        time.sleep(0.5 * (attempt - taken))
        counts: dict = {}

        def take(prof):
            for e in prof.events():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    counts[e.name] = counts.get(e.name, 0) + 1

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=take) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        if counts:
            taken += 1
            for name, n in counts.items():
                best[name] = max(best.get(name, 0), n)
    if not taken:
        raise RuntimeError(f"the profiler saw no device activity in {traces + 4} traces")
    return {name: n / reps for name, n in best.items()}


def eager_body_step(runner) -> None:
    """The runner's next step by its body, run eagerly in train mode."""
    runner.model.train()
    runner.program.body()


def _step_program_pair(hp, attn_impl: str | None) -> tuple:
    """Two trainers of ``hp`` on the same seeded weights: one steps its
    ``EpochRunner`` (a warm-up step, then the captured step replayed
    ``STEP_PROGRAM_REPLAYS`` times), the other runs the same runner's body
    eagerly (``eager_body_step``).  Returns the graphed trainer, the eager
    one, and the record of their agreement: per-step losses,
    ``state_agreement``, the counters' movement under each, the
    applied-step counts."""
    import torch

    from distributed_training_comparison_tpu_torch import ops
    from distributed_training_comparison_tpu_torch.train import Trainer, build_model

    def trainer():
        return Trainer(hp, model=build_model(hp, attn_impl=attn_impl) if attn_impl else None)

    graphed, eager = trainer(), trainer()
    steps = 1 + STEP_PROGRAM_REPLAYS
    step_of = {"eager": lambda: eager_body_step(eager.runner), "graphed": graphed.runner.step}
    counters = ops.counted_wrappers()
    launches = {}
    for name, t in (("eager", eager), ("graphed", graphed)):
        before = _counts(counters)
        t.runner.start_epoch(0)
        for _ in range(steps):
            step_of[name]()
        torch.cuda.synchronize()
        launches[name] = [n - b for n, b in zip(_counts(counters), before)]
    rows = min(steps, graphed.runner.steps)  # a one-step epoch wraps: its row holds the last step
    losses = {name: t.runner.metrics[:rows, 0].tolist() for name, t in (
        ("eager", eager), ("graphed", graphed))}
    return graphed, eager, {
        "steps": steps, "captured": graphed.runner.program.captured,
        "launches_eager_body": launches["eager"], "launches_replayed": launches["graphed"],
        "launches_equal": launches["eager"] == launches["graphed"],
        "losses_replayed": losses["graphed"], "losses_eager_body": losses["eager"],
        "loss_rel_err_max": max(abs(a - b) / abs(b) for a, b in zip(losses["graphed"],
                                                                     losses["eager"])),
        "skipped": float(graphed.runner.metrics[:rows, 3].sum()),
        "applied": [int(graphed.sgd.applied), int(eager.sgd.applied)],
        "state_vs_eager_body": state_agreement(_state_tensors(graphed), _state_tensors(eager)),
    }


def step_program_train(label: str, argv: list, attn_impl: str | None, reps: int = 10) -> dict:
    """One train path's step program record (``_step_program_pair``); where
    the replayed state is not bit-identical to the eager body's, the pair
    again with cuDNN held to its deterministic algorithms
    (``deterministic_rerun``, a record of the fault: ``check_step_program``
    fails the path whatever the rerun gives).  Then
    ms a step by CUDA events of the replayed step and of the eager
    ``TrainStep``, the device-busy ms and idle share of each under the
    profiler, the port's kernels by symbol in one replay and in one eager
    step, and their launches by symbol in one replay against one eager
    body step and against the graph's ledger (``ledger_against_device``)."""
    import torch

    from distributed_training_comparison_tpu_torch.data import draw_crop_flip
    from distributed_training_comparison_tpu_torch.utils import step_generator

    hp = load_config(argv)
    graphed, eager, agreement = _step_program_pair(hp, attn_impl)
    record = {"label": label, "argv": argv, "attn_impl": attn_impl, "precision": hp.precision,
              "batch": hp.batch_size, **agreement}
    if not agreement["state_vs_eager_body"]["bitwise"]:
        cudnn, was = torch.backends.cudnn, torch.backends.cudnn.deterministic
        cudnn.deterministic = True
        try:
            g, e, again = _step_program_pair(hp, attn_impl)
        finally:
            cudnn.deterministic = was
        record["deterministic_rerun"] = again
        del g, e

    images, labels = next(graphed.train_split.epoch_batches(hp.batch_size, hp.seed, 0))
    draws = draw_crop_flip(len(labels), step_generator(hp.seed, 0, 0))
    eager_ms = cuda_ms(lambda: eager.step(images, labels, draws), reps, warmup=1)
    replay_ms = cuda_ms(graphed.runner.step, reps, warmup=1)
    eager_prof = profile_device(lambda: eager.step(images, labels, draws), 2)
    replay_prof = profile_device(graphed.runner.step, 2)
    replay_launches = _port_kernel_ms(device_launches(graphed.runner.step))
    body_launches = _port_kernel_ms(device_launches(lambda: eager_body_step(eager.runner)))
    record.update({
        "ms_per_step_eager": eager_ms, "ms_per_step_replayed": replay_ms,
        "busy_ms_eager": eager_prof["device_busy_ms"],
        "busy_ms_replayed": replay_prof["device_busy_ms"],
        "idle_share_eager": eager_prof["device_idle_share"],
        "idle_share_replayed": replay_prof["device_idle_share"],
        "device_activities_eager": eager_prof["device_activities_per_call"],
        "device_activities_replayed": replay_prof["device_activities_per_call"],
        "port_kernels_eager": sorted(_port_kernel_ms(eager_prof["device_ms_by_name"])),
        "port_kernels_one_replay": sorted(replay_launches),
        "port_launches_one_replay": replay_launches,
        "port_launches_one_eager": body_launches,
        "ledger_vs_device": ledger_against_device(graphed.runner.program.ledger, replay_launches),
        "port_kernels_ms_replayed": _port_kernel_ms(replay_prof["device_ms_by_name"]),
        "top_device_ms_replayed": dict(sorted(
            ((n[:60], ms) for n, ms in replay_prof["device_ms_by_name"].items()),
            key=lambda kv: -kv[1])[:8]),
    })
    if label in GUARD_PROFILED:
        record["guard_update"] = guard_update_profile(eager)
    del graphed, eager
    gc.collect()
    torch.cuda.empty_cache()
    return record


def step_program_serve(label: str, argv: list, reps: int = 20) -> dict:
    """One serve path's step program record at bucket 32: an engine of
    ``argv`` and one seeded batch of 32, dispatched through the bucket's
    graph and run by the engine's eager forward (``eager_logits``); the
    logits of the eager run, the warm-up dispatch and two replays compared,
    the counters' movement of one dispatch under each, ms a dispatch by the
    host clock (upload, forward, logits download), device-busy ms and idle
    share of each under the profiler, and the port's kernels and their
    launches by symbol in one replay against one eager forward and against
    the graph's ledger (``ledger_against_device``)."""
    import numpy as np
    import torch

    from distributed_training_comparison_tpu_torch import ops
    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    hp = load_config(argv)
    images = request_pool(32, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    engine = build_engine(hp)
    dispatch = {"eager": lambda: eager_logits(engine, images),
                "graphed": lambda: engine.predict_logits(images)}
    counters = ops.counted_wrappers()
    want = dispatch["eager"]()
    got = [dispatch["graphed"]() for _ in range(3)]  # warm-up, capture, replay
    launches = {}
    for name, fn in dispatch.items():
        before = _counts(counters)
        fn()
        torch.cuda.synchronize()
        launches[name] = [n - b for n, b in zip(_counts(counters), before)]
    scale = float(np.abs(want).max())
    err = max(float(np.abs(g - want).max()) for g in got)
    out = {"label": label, "argv": argv, "bucket": 32,
           "captured": 32 in engine.stats()["captured_buckets"],
           "logits_bitwise": all(np.array_equal(g, want) for g in got),
           "logits_max_abs_err": err, "logits_scale": scale, "logits_err_share": err / scale,
           "launches_eager": launches["eager"], "launches_replayed": launches["graphed"],
           "launches_equal": launches["eager"] == launches["graphed"]}
    for name, fn in dispatch.items():
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[f"ms_per_dispatch_{name}"] = (time.perf_counter() - t0) / reps * 1e3
        prof = profile_device(fn, 5)
        out[f"busy_ms_{name}"] = prof["device_busy_ms"]
        out[f"idle_share_{name}"] = prof["device_idle_share"]
        out[f"device_activities_{name}"] = prof["device_activities_per_call"]
        out[f"port_kernels_{name}"] = sorted(_port_kernel_ms(prof["device_ms_by_name"]))
        out[f"port_launches_one_{name}"] = _port_kernel_ms(device_launches(fn))
    out["port_launches_one_replay"] = out.pop("port_launches_one_graphed")
    out["port_kernels_one_replay"] = sorted(out["port_launches_one_replay"])
    out["ledger_vs_device"] = ledger_against_device(engine._programs[32][1].ledger,
                                                    out["port_launches_one_replay"])
    del engine, dispatch
    gc.collect()
    torch.cuda.empty_cache()
    return out


# The paths whose guard and update (``train/step.py::guard_and_update``) the
# step program phase also profiles alone: bf16 ResNet-18 and bf16 vit_tiny p2.
GUARD_PROFILED = ("train_resnet", "train_tiny")


def guard_update_profile(trainer, reps: int = 10) -> dict:
    """The guard and update of one step alone, as the step body runs them
    after its backward (``guard_and_update`` after the running statistics'
    copy): the gradients gathered into the flat buffers, their norm, the
    finite flag, the flat update and one select a buffer, on ``trainer``'s
    live state and last gradients (each call applies an update).  Device
    busy ms, device activities and launches a call, ms by kernel name, the
    flat buffers' sizes, and ``floor_ms``: the flat parameters' bytes read
    as p, g and buf and written as p and buf, plus the norm's read of g
    (six passes), at the card's memory rate."""
    import torch

    from distributed_training_comparison_tpu_torch.train import (
        guard_and_update,
        statistics_buffers,
    )

    sgd, running = trainer.sgd, statistics_buffers(trainer.model)
    loss = torch.ones((), device=trainer.device)
    grad_accum = trainer.hparams.grad_accum

    def call():
        guard_and_update(sgd, loss, running, [t.clone() for t in running], grad_accum=grad_accum)

    call()
    torch.cuda.synchronize()
    prof = profile_device(call, reps)
    launches = device_launches(call)
    nbytes = {"params": sum(f.numel() * f.element_size() for f in sgd.flat_params),
              "statistics": sum(f.numel() * f.element_size() for f in running)}
    return {
        "busy_ms": prof["device_busy_ms"], "device_activities": prof["device_activities_per_call"],
        "launches": sum(launches.values()), "kernels_by_name": {
            n: {"ms": ms, "launches": launches.get(n, 0)}
            for n, ms in sorted(prof["device_ms_by_name"].items(), key=lambda kv: -kv[1])},
        "flat_buffers": {"params": len(sgd.flat_params), "momentum": len(sgd.flat_momentum),
                         "statistics": len(running)},
        "flat_bytes": nbytes, "floor_ms": 6 * nbytes["params"] / PEAK_BYTES * 1e3,
    }


def step_program_phase(smi: str) -> dict:
    """Every ``STEP_PROGRAM_TRAIN`` and ``STEP_PROGRAM_SERVE`` record."""
    check_wrapper_kernels()
    return {"phase": "step_program", "nvidia_smi": smi,
            "train": [step_program_train(*t) for t in STEP_PROGRAM_TRAIN],
            "serve": [step_program_serve(*s) for s in STEP_PROGRAM_SERVE]}


def _check_replayed_launches(r: dict) -> None:
    """One replay ran the port kernels of an eager run, each as often as
    that run launched it and as the graph's ledger counts: the counts are
    measured on the device."""
    if r["port_kernels_one_replay"] != r["port_kernels_eager"]:
        raise RuntimeError(f"step program {r['label']}: a replay ran the port kernels "
                           f"{r['port_kernels_one_replay']}, an eager run {r['port_kernels_eager']}")
    if (r["port_launches_one_replay"] != r["port_launches_one_eager"]
            or not r["ledger_vs_device"]["ok"]):
        raise RuntimeError(f"step program {r['label']}: launches by symbol in one replay "
                           f"{r['port_launches_one_replay']}, in one eager run "
                           f"{r['port_launches_one_eager']}, ledger {r['ledger_vs_device']}")


def check_step_program(rec: dict) -> None:
    for r in rec["train"]:
        for run in (r, r.get("deterministic_rerun", r)):
            if not (run["captured"] and run["launches_equal"] and run["skipped"] == 0
                    and run["applied"] == [run["steps"], run["steps"]]):
                raise RuntimeError(f"step program {r['label']}: {r}")
        # bit for bit on the first run, under the product's settings (cuDNN
        # held to its deterministic algorithms by the device choice)
        if not (r["state_vs_eager_body"]["bitwise"] and r["loss_rel_err_max"] == 0.0):
            raise RuntimeError(f"step program {r['label']}: replayed state disagrees: {r}")
        _check_replayed_launches(r)
    for r in rec["serve"]:
        # the same kernels on the same inputs: the logits bit for bit
        if not (r["captured"] and r["launches_equal"] and r["logits_bitwise"]):
            raise RuntimeError(f"step program {r['label']}: {r}")
        _check_replayed_launches(r)


# The checkpoint phase (``train/checkpoint.py``, ``train/state.py``,
# ``train/async_ckpt.py``): runs resumed from ``last.ckpt`` against the same
# runs made straight, at full width on small data.  The entry point's
# default, fp32 ResNet-18, resumes by ``--auto-resume`` in its own version
# dir; ``vit_tiny --patch-size 2 --amp`` (K5 and K6 in every block) by an
# explicit ``--resume`` in a fresh one.  Before every run cuDNN is set to
# benchmark with no determinism: the entry path must pin it back.
CKPT_RESNET_ARGV = ["--synthetic-data", "--batch-size", "128", "--limit-examples", "440",
                    "--lr-decay-step-size", "1"]
CKPT_TINY_ARGV = ["--model", "vit_tiny", "--patch-size", "2", "--amp", "--synthetic-data",
                  "--batch-size", "128", "--limit-examples", "440", "--lr-decay-step-size", "1"]
SERVE_CKPT_ARGV = ["--serve", "--serve-buckets", "1,2,4,8,16,32", "--serve-shape", "closed",
                   "--serve-requests", "64", "--serve-concurrency", "32", "--seed", "0"]
K5_K6_WRAPPERS = ("block_gemm", "block_attention", "block_ln", "block_gemm_dgrad", "block_ln_bwd",
                  "block_attention_bwd", "block_gemm_wgrad", "block_grad_reduce")


def _unpin_cudnn() -> None:
    import torch

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True


def _payload_leaves(path) -> dict:
    """A checkpoint file's payload as ``{path: leaf}``."""
    import torch

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items() for k, v in leaves(sub, f"{prefix}/{key}").items()}
        return {prefix: tree}

    return leaves(torch.load(path, weights_only=True))


def payload_agreement(got, want) -> dict:
    """Two checkpoint payloads leaf by leaf: the same paths, and every leaf
    bit for bit (tensors by ``torch.equal`` with their dtypes, numbers by
    value); at most eight mismatching paths."""
    import torch

    a, b = _payload_leaves(got), _payload_leaves(want)

    def same(x, y):
        if isinstance(y, torch.Tensor):
            return isinstance(x, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y)
        return x == y

    bad = sorted(k for k in b if k not in a or not same(a[k], b[k]))
    return {"leaves": len(b), "same_paths": sorted(a) == sorted(b),
            "bitwise": sorted(a) == sorted(b) and not bad, "mismatches": bad[:8]}


def resume_check(label: str, argv: list, resume: str, straight_extra: list = ()) -> dict:
    """``argv`` trained 2 epochs straight in one run dir, against 1 epoch
    and then 2 in another, resumed by ``--auto-resume`` (``resume="auto"``:
    the first run's version dir) or by ``--resume`` of the first run's
    ``last.ckpt`` (``"explicit"``: a fresh version dir).  The launch
    counters are zeroed just before the resumed run and read just after;
    cuDNN is unpinned before every run and read after it."""
    from distributed_training_comparison_tpu_torch import _device, ops

    straight_dir, resumed_dir = run_dir(), run_dir()
    cudnn_after = []
    _unpin_cudnn()
    straight = run_entry([*argv, "--epoch", "2", *straight_extra], straight_dir)
    cudnn_after.append(_device.cudnn_determinism())
    _unpin_cudnn()
    first = run_entry([*argv, "--epoch", "1"], resumed_dir)["fit"]
    cudnn_after.append(_device.cudnn_determinism())
    extra = (["--auto-resume"] if resume == "auto"
             else ["--resume", str(Path(resumed_dir) / "version-0" / "last.ckpt")])
    counters = ops.counted_wrappers()
    for c in counters:
        c.launches = 0
    _unpin_cudnn()
    t0 = time.perf_counter()
    resumed = run_entry([*argv, "--epoch", "2", *extra], resumed_dir)["fit"]
    seconds = time.perf_counter() - t0
    cudnn_after.append(_device.cudnn_determinism())
    keys = ("train_loss", "train_acc", "val_loss", "val_acc", "lr")
    return {
        "label": label, "argv": argv, "resume": resume, "version": resumed["version"],
        "resumed_epochs": [e["epoch"] for e in resumed["epochs"]],
        "resumed_seconds": seconds,
        "launches_resumed": {c.__name__: c.launches for c in counters if c.launches},
        "cudnn_after_each_run": cudnn_after,
        "epochs_straight": {k: [e[k] for e in straight["fit"]["epochs"]] for k in keys},
        "epochs_resumed": {k: [e[k] for e in first["epochs"] + resumed["epochs"]] for k in keys},
        "last_ckpt": payload_agreement(
            Path(resumed_dir) / f"version-{resumed['version']}" / "last.ckpt",
            Path(straight_dir) / "version-0" / "last.ckpt"),
        "straight_results": {k: v for k, v in straight.items() if k != "fit"},
    }


def contain_test_check(results: dict) -> dict:
    """The straight ResNet run's ``--contain-test`` against an eval of the
    best file it reports, loaded into a fresh trainer's weights: the test
    metrics equal."""
    import torch

    from distributed_training_comparison_tpu_torch.train import Trainer
    from distributed_training_comparison_tpu_torch.train import checkpoint as ckpt

    trainer = Trainer(load_config([*CKPT_RESNET_ARGV, "--epoch", "2"]))
    ckpt.load_checkpoint(results["test_checkpoint"], trainer.state)
    out = trainer._evaluate("test", trainer.test_split)
    trainer.close()
    del trainer
    torch.cuda.empty_cache()
    want = {"test_loss": out["loss"], "test_top1": out["top1"], "test_top5": out["top5"]}
    return {"test_checkpoint": results["test_checkpoint"],
            "reported": {k: results[k] for k in want}, "restored_eval": want,
            "equal": all(results[k] == v for k, v in want.items())}


def checkpoint_costs_and_serving(smi: str) -> dict:
    """fp32 ResNet-18 trained one epoch through ``Trainer`` (so the best
    file holds the in-memory weights), then:

    - serving: ``--serve --serve-ckpt <best>`` through the entry point, and
      a bucket-32 batch's logits from engines of ``--serve-ckpt`` and of
      discovery under the run's ``--ckpt-path``, against an engine built on
      the trainer's in-memory weights (bit for bit);
    - sizes and times: the best and last files' MB, the device snapshot's
      ms (CUDA events), its device-to-host copy, each file's serialize and
      write seconds, and the writer's overlap with the next epoch (an epoch
      alone, an epoch with a ``last.ckpt`` save in flight, and how long the
      drain after it still waited)."""
    import numpy as np
    import torch

    from distributed_training_comparison_tpu_torch.serve import (
        ServeEngine,
        build_engine,
        request_pool,
    )
    from distributed_training_comparison_tpu_torch.train import Trainer
    from distributed_training_comparison_tpu_torch.train import checkpoint as ckpt

    hp = load_config([*CKPT_RESNET_ARGV, "--epoch", "1"])
    trainer = Trainer(hp)
    fit = trainer.fit()
    best = ckpt.find_best_checkpoint(trainer.version_dir)
    last = trainer.version_dir / "last.ckpt"
    record = {"fit_writer": trainer.ckpt_writer.stats(), "fit_epoch_seconds": fit["epochs"][0]["seconds"],
              "best_mb": best.stat().st_size / 1e6, "last_mb": last.stat().st_size / 1e6}

    images = request_pool(32, image_size=hp.image_size, seed=0, fold=("check", 0))
    weights = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    reference = ServeEngine(model_name="resnet18", model_kw={"stem": hp.stem}, state_dict=weights,
                            buckets=(32,), precision="fp32", image_size=hp.image_size)
    want = [reference.predict_logits(images) for _ in range(3)][-1]  # warm-up, capture, replay
    report = run_entry([*SERVE_CKPT_ARGV, "--serve-ckpt", str(best)])
    serve = {"entry": {k: report[k] for k in ("offered", "completed", "failed", "checkpoint")},
             "best": str(best)}
    for name, shp in (("serve_ckpt", load_config([*SERVE_CKPT_ARGV, "--serve-ckpt", str(best)])),
                      ("discovered", load_config(SERVE_CKPT_ARGV, ckpt_path=hp.ckpt_path))):
        engine = build_engine(shp)
        got = [engine.predict_logits(images) for _ in range(3)]
        serve[name] = {"checkpoint": engine.checkpoint_meta,
                       "captured": 32 in engine.stats()["captured_buckets"],
                       "logits_bitwise": all(np.array_equal(g, want) for g in got),
                       "logits_max_abs_err": max(float(np.abs(g - want).max()) for g in got)}
        del engine
    record["serving"] = serve
    del reference

    out = Path(run_dir())
    snapshot_ms = cuda_ms(trainer.state.snapshot, 10)
    torch.cuda.synchronize()
    snap = trainer.state.snapshot()
    t0 = time.perf_counter()
    snap.host_tensors()
    host_copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save_resume_state(out, snap, 0, 0.0)
    last_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt.save_checkpoint(out, snap, 0, 0.0)
    best_s = time.perf_counter() - t0
    del snap
    overlap_dir = run_dir()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_epoch(1)
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    busy_before = trainer.ckpt_writer.stats()["busy_s"]
    t0 = time.perf_counter()
    snap = trainer.state.snapshot()
    trainer.ckpt_writer.submit(lambda s=snap: ckpt.save_resume_state(overlap_dir, s, 2, 0.0),
                               key="last")
    del snap
    trainer.train_epoch(2)
    torch.cuda.synchronize()
    during_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.ckpt_writer.wait()
    drain_s = time.perf_counter() - t0
    record["costs"] = {
        "nvidia_smi": smi, "snapshot_ms": snapshot_ms, "host_copy_s": host_copy_s,
        "save_last_s": last_s, "save_best_s": best_s,
        "epoch_alone_s": alone_s, "epoch_with_save_s": during_s,
        "writer_job_s": trainer.ckpt_writer.stats()["busy_s"] - busy_before,
        "drain_after_epoch_s": drain_s,
        "steps_per_epoch": trainer.steps_per_epoch,
    }
    trainer.close()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return record


def checkpoint_phase(smi: str) -> dict:
    """``resume_check`` of fp32 ResNet-18 (``--auto-resume``; its straight
    run under ``--contain-test``, held by ``contain_test_check``) and of
    bf16 ``vit_tiny`` p2 (``--resume``), then
    ``checkpoint_costs_and_serving``."""
    import torch

    resnet = resume_check("resnet18_fp32", CKPT_RESNET_ARGV, "auto", ["--contain-test"])
    resnet["contain_test"] = contain_test_check(resnet["straight_results"])
    gc.collect()
    torch.cuda.empty_cache()
    tiny = resume_check("vit_tiny_p2_bf16", CKPT_TINY_ARGV, "explicit")
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "checkpoint", "nvidia_smi": smi, "resume": [resnet, tiny],
            **checkpoint_costs_and_serving(smi)}


def check_checkpoint(rec: dict) -> None:
    pinned = {"deterministic": True, "benchmark": False}
    for r in rec["resume"]:
        want_version = 0 if r["resume"] == "auto" else 1
        if not (r["last_ckpt"]["bitwise"] and r["epochs_straight"] == r["epochs_resumed"]
                and r["version"] == want_version and r["resumed_epochs"] == [1]
                and all(c == pinned for c in r["cudnn_after_each_run"])):
            raise RuntimeError(f"checkpoint {r['label']}: the resumed run is not the straight run: {r}")
    tiny = rec["resume"][1]["launches_resumed"]
    if not all(tiny.get(name, 0) > 0 for name in K5_K6_WRAPPERS):
        raise RuntimeError(f"checkpoint: the resumed vit_tiny run launched {tiny}, not K5 and K6")
    contain = rec["resume"][0]["contain_test"]
    if not (contain["equal"] and "best_model_epoch_" in str(contain["test_checkpoint"])):
        raise RuntimeError(f"checkpoint: --contain-test did not test the best file: {contain}")
    serve = rec["serving"]
    entry_ok = (serve["entry"]["completed"] == serve["entry"]["offered"] and not serve["entry"]["failed"]
                and serve["entry"]["checkpoint"]["path"] == serve["best"])
    engines_ok = all(serve[n]["logits_bitwise"] and serve[n]["captured"]
                     and serve[n]["checkpoint"]["path"] == serve["best"]
                     for n in ("serve_ckpt", "discovered"))
    if not (entry_ok and engines_ok):
        raise RuntimeError(f"checkpoint: serving the best file: {serve}")


# The host data phase (``--data-mode host``, ``data/loader.py``): bf16
# ResNet-18 trained 2 epochs of 4 steps of 128 (522 training images) in the
# device mode and in the host mode, chunks of 3 steps (each epoch ends on a
# partial chunk), a ring of 2 slots and the loader on 2 threads: the host
# mode ends bit for bit where the device mode ends.  Then both modes timed
# over 2 epochs of 30 steps, chunks of 8, and one host-mode epoch traced:
# which stream each pinned copy ran on, and how much of it overlapped a
# kernel.
HOST_DATA_ARGV = [
    "--model", "resnet18", "--amp", "--synthetic-data", "--batch-size", "128",
    "--limit-examples", "580", "--epoch", "2", "--lr-decay-step-size", "1",
]
HOST_DATA_FLAGS = ["--data-mode", "host", "--host-chunk-steps", "3", "--device-prefetch", "2",
                   "--workers", "2"]
HOST_TIMING_ARGV = [
    "--model", "resnet18", "--amp", "--synthetic-data", "--batch-size", "128",
    "--limit-examples", "4300", "--epoch", "2", "--lr-decay-step-size", "1",
]
HOST_TIMING_FLAGS = ["--data-mode", "host", "--host-chunk-steps", "8", "--device-prefetch", "2",
                     "--workers", "2"]


def copy_streams(trainer, epoch: int) -> dict:
    """One host-mode epoch (``train_epoch``) under the profiler, its trace
    read back: the streams of the ring's pinned host-to-device copies and
    of the kernels, and the share of the copies' time that overlapped a
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch(epoch)
        torch.cuda.synchronize()
    path = Path(run_dir()) / "host_epoch_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "Pinned" in e.get("name", "") and "HtoD" in e.get("name", "")]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    overlap = 0.0
    for c in copies:
        c0, c1 = c["ts"], c["ts"] + c["dur"]
        overlap += sum(max(0.0, min(c1, k1) - max(c0, k0)) for k0, k1 in spans
                       if k0 < c1 and k1 > c0)
    copy_us = sum(c["dur"] for c in copies)
    return {
        "pinned_copies": len(copies),
        "copy_streams": sorted({c.get("args", {}).get("stream") for c in copies}, key=str),
        "kernel_streams": sorted({k.get("args", {}).get("stream") for k in kernels}, key=str),
        "copy_ms": copy_us / 1e3,
        "copy_share_overlapping_kernels": overlap / copy_us if copy_us else None,
    }


def _mode_times(trainer, epochs: int = 3) -> dict:
    """ms a step by the host clock over ``epochs`` replayed epochs (each
    ``train_epoch``: its start, its steps and its metrics fetch), each
    epoch's ms, the host's ms from an epoch's start to its first step's
    launch (its chunk's wait included), and under the host mode the ms the training thread waited on
    the ring for a chunk (``StagingRing.wait_seconds``); then the
    device-busy ms a step and idle share of one more epoch under the
    profiler."""
    import torch

    steps, ring = trainer.steps_per_epoch, trainer.runner.ring
    trainer.train_epoch(2)  # warm: every graph is captured after the fit
    torch.cuda.synchronize()
    epoch_ms, first_ms = [], []
    runner_step = trainer.runner.step
    waited = ring.wait_seconds if ring is not None else 0.0
    for e in range(epochs):
        marks = []

        def step():
            runner_step()
            if not marks:
                marks.append(time.perf_counter())

        trainer.runner.step = step
        t0 = time.perf_counter()
        trainer.train_epoch(3 + e)
        torch.cuda.synchronize()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
        first_ms.append((marks[0] - t0) * 1e3)
    trainer.runner.step = runner_step
    prof = profile_device(lambda: trainer.train_epoch(3 + epochs), 1)
    out = {"steps_per_epoch": steps, "ms_per_step": sum(epoch_ms) / (epochs * steps),
           "epoch_ms": epoch_ms, "ms_to_first_step": first_ms,
           "busy_ms_per_step": prof["device_busy_ms"] / steps,
           "idle_share": prof["device_idle_share"]}
    if ring is not None:
        out["chunk_wait_ms_per_epoch"] = (ring.wait_seconds - waited) * 1e3 / epochs
    return out


def host_data_phase(smi: str) -> dict:
    """The host mode against the device mode: the bit-for-bit pair
    (``HOST_DATA_ARGV``), then the timed pair (``HOST_TIMING_ARGV``), the
    ring's pinned buffers and device bytes, and the streams of its copies
    (``copy_streams``)."""
    import torch

    from distributed_training_comparison_tpu_torch.train import Trainer

    keys = ("steps", "skipped", "train_loss", "train_acc", "val_loss", "val_acc")
    trainers, fits = {}, {}
    for mode, extra in (("device", []), ("host", HOST_DATA_FLAGS)):
        trainers[mode] = Trainer(load_config([*HOST_DATA_ARGV, *extra]))
        fits[mode] = trainers[mode].fit()
    host = trainers["host"]
    ring = host.runner.ring
    record = {
        "phase": "host_data", "nvidia_smi": smi, "argv": HOST_DATA_ARGV,
        "host_flags": HOST_DATA_FLAGS,
        "captured": [t.runner.program.captured for t in trainers.values()],
        "state": state_agreement(_state_tensors(host), _state_tensors(trainers["device"])),
        "epochs_equal": [{k: e[k] for k in keys} for e in fits["host"]["epochs"]]
        == [{k: e[k] for k in keys} for e in fits["device"]["epochs"]],
        "epochs_host": [{k: e[k] for k in keys} for e in fits["host"]["epochs"]],
        "applied": [fits["host"]["applied_steps"], fits["device"]["applied_steps"]],
        "chunks_staged": ring.chunks_staged, "ring_slots": ring.slots,
        "ring_chunk_steps": ring.chunk,
        "pinned": all(t.is_pinned() for pair in ring.pinned for t in pair),
    }
    for t in trainers.values():
        t.close()
    del trainers, host, ring
    gc.collect()
    torch.cuda.empty_cache()
    timed = {}
    for mode, extra in (("device", []), ("host", HOST_TIMING_FLAGS)):
        t = Trainer(load_config([*HOST_TIMING_ARGV, *extra]))
        t.fit()
        timed[mode] = _mode_times(t)
        if mode == "host":
            timed[mode]["ring_mb"] = t.runner.ring.nbytes() / 1e6
            timed[mode]["copies"] = copy_streams(t, 9)
        t.close()
        del t
        gc.collect()
        torch.cuda.empty_cache()
    timed["host_over_device_ms"] = timed["host"]["ms_per_step"] / timed["device"]["ms_per_step"]
    timed["argv"], timed["host_flags"] = HOST_TIMING_ARGV, HOST_TIMING_FLAGS
    record["timed"] = timed
    return record


def check_host_data(rec: dict) -> None:
    """Bit for bit with the device mode on the first run, both captured, the
    ring's host buffers pinned, and its copies on a stream of their own."""
    copies = rec["timed"]["host"]["copies"]
    if not (all(rec["captured"]) and rec["state"]["bitwise"] and rec["epochs_equal"]
            and rec["applied"] == [8, 8] and rec["pinned"]):
        raise RuntimeError(f"host data mode: the host-mode run is not the device-mode run: {rec}")
    streams = set(copies["copy_streams"])
    if not (copies["pinned_copies"] and streams.isdisjoint(copies["kernel_streams"])):
        raise RuntimeError(f"host data mode: the ring's copies ran on a kernel stream: {copies}")


def init_profiler_for_graphs() -> None:
    """Start the profiler once before any CUDA graph is captured: with a
    CUDA runtime older than 12 the tracer sees no kernel of a graph
    instantiated before it first started (torch's own workaround)."""
    from torch.profiler import _utils

    if hasattr(_utils, "_init_for_cuda_graphs"):
        _utils._init_for_cuda_graphs()


def phases_main(flags: list) -> int:
    """``--step-program``, ``--host-data`` and/or ``--checkpoint`` (``PHASE_FLAGS``): the
    device line, the kernels built, and those phases alone, each checked
    after it is printed."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from distributed_training_comparison_tpu_torch._device import pin_card_math
    from distributed_training_comparison_tpu_torch.ops import _build

    pin_card_math()
    init_profiler_for_graphs()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    t0 = time.monotonic()
    _build.build_all()
    emit({"phase": "build", "seconds": round(time.monotonic() - t0, 3), "nvidia_smi": smi})
    for flag in flags:
        run, check = PHASE_FLAGS[flag]
        t0 = time.monotonic()
        rec = run(smi)
        rec["phase_seconds"] = round(time.monotonic() - t0, 3)
        emit(rec)
        check(rec)
    print(smi, flush=True)
    return 0


PHASE_FLAGS = {"--step-program": (step_program_phase, check_step_program),
               "--host-data": (host_data_phase, check_host_data),
               "--checkpoint": (checkpoint_phase, check_checkpoint)}


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
    from distributed_training_comparison_tpu_torch._device import pin_card_math

    # the plain versions and the fp32 kernel are held in true fp32, and the
    # kernel checks run under the product's settings (cuDNN deterministic)
    pin_card_math()
    init_profiler_for_graphs()

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
    missing = [k for k in (*MOE_SYMBOLS["bfloat16"].values(), *MOE_TF32_KERNELS) if k not in built]
    missing += [f"{k}<{d}>" for ks in (*BACKWARD_SYMBOLS["float32"].values(), FORWARD_SYMBOLS["float32"])
                for k in ks for d in (64, 128) if f"{k}<{d}>" not in built]
    missing += [k for k in BLOCK_TF32_KERNELS if k not in built]
    missing += [k for k in LN_PATH_KERNELS if k not in built]
    missing += [f"{k}<{d}>" for ks in SMALL_F32_KERNELS.values() for k in ks for d in (64, 128)
                if f"{k}<{d}>" not in built]
    # the tiled bf16 kernels, at both head dims (the forward and dq in a
    # build for items up to 256 tokens and one for longer items)
    missing += [f"{k}<{d}" for ks in SMALL_TILED_KERNELS.values() for k in ks for d in (64, 128)
                if not any(n.startswith(f"{k}<{d}") for n in built)]
    if missing:
        raise RuntimeError(f"the build logs hold no ptxas report of {missing}")
    spilled = {
        name: r for name, r in built.items()
        # the bf16 and 3xTF32 flash, one-tile, tiled bf16 and 3xTF32
        # short-sequence, fused block GEMM and attention (bf16 and fp32), and
        # grouped expert FFN kernels, and every LayerNorm kernel of K6
        if ("flash_" in name and ("bf16" in name or "tf32x3" in name) or "onetile" in name
            or name.startswith("attn_small_") and ("_f32<" in name or "_bf16<" in name)
            or "_wgmma" in name or name in BLOCK_TF32_KERNELS or name in MOE_TF32_KERNELS
            or name.startswith("ln_"))
        and r.get("spill_store_bytes", 0) + r.get("spill_load_bytes", 0)
    }
    if spilled:
        raise RuntimeError(f"Hopper attention, GEMM, expert FFN or LayerNorm kernels spill registers: {spilled}")

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

    ln_checks = block_ln_checks(vb)
    emit({"phase": "block_ln_checks", "nvidia_smi": smi, "checks": ln_checks})
    bad = [c for c in ln_checks if not c["ok"]]
    if bad:
        raise RuntimeError(f"the LayerNorm kernels disagree with the plain versions: {bad}")

    nans = fp32_nan_checks(vb)
    emit({"phase": "fp32_nan_checks", "nvidia_smi": smi, "checks": nans})
    bad = [c["case"] for c in nans if not c["ok"]]
    if bad:
        raise RuntimeError(f"a NaN in x does not reach the fp32 chains' outputs as in the plain version: {bad}")

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
    for precision, dname in (("bf16", "bfloat16"), ("fp32", "float32")):
        prof = tiny["bucket32"][precision]["bucket32_profile"]
        for key, wrapper in (("gemm_kernels", "block_gemm"), ("attention_kernels", "block_attention")):
            if prof[key] != path_symbols(wrapper, dname):
                raise RuntimeError(f"serve_tiny's {precision} bucket-32 dispatch ran the {key} {prof[key]}")
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

    long_fp32 = train_long_fp32_phase(attn, smi)
    emit(long_fp32)
    check_train_long_fp32(long_fp32)

    tiny_train = train_tiny_phase(vb, attn, smi)
    emit(tiny_train)
    check_train_tiny(tiny_train)

    tiny_fp32 = train_tiny_fp32_phase(vb, attn, smi)
    emit(tiny_fp32)
    check_train_tiny_fp32(tiny_fp32)

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

    train_moe_fp32 = train_moe_phase(gm, vb, attn, smi, TRAIN_MOE_FP32_ARGV, "train_moe_fp32")
    emit(train_moe_fp32)
    check_train_moe(train_moe_fp32)

    moe_fp32 = moe_fp32_dispatch_phase(gm)
    emit(moe_fp32)
    check_moe_fp32_dispatch(moe_fp32)

    small_checks = small_attention_checks(small)
    emit({"phase": "small_attention_checks", "nvidia_smi": smi, "checks": small_checks})
    bad = [c["case"] for c in small_checks if not c["ok"]]
    if bad:
        raise RuntimeError(f"the short-sequence attention kernels disagree with the plain versions: {bad}")

    small_nans = small_fp32_nan_checks(small)
    emit({"phase": "small_fp32_nan_checks", "nvidia_smi": smi, "checks": small_nans})
    bad = [c["case"] for c in small_nans if not c["ok"]]
    if bad:
        raise RuntimeError(f"a NaN does not reach the fp32 K10/K11 results as in the plain versions: {bad}")

    serve_small = serve_pinned_phase(small, gm, vb, attn, "serve_small", SERVE_SMALL_ARGV, SMALL_LOGIT_CHECKS)
    emit(serve_small)
    check_serve_pinned(serve_small, {"bf16": SMALL_PATH_KERNELS, "fp32": SMALL_F32_KERNELS})

    train_small = train_small_phase(small, gm, vb, attn, smi)
    emit(train_small)
    check_train_pinned(train_small, SMALL_PATH_KERNELS, profile="profile_fused_small")

    small_fp32 = train_small_fp32_phase(small, gm, vb, attn, smi)
    emit(small_fp32)
    check_train_pinned(small_fp32, SMALL_F32_KERNELS, shape=("fp32", 256, 3, 1))

    serve_p2 = serve_pinned_phase(small, gm, vb, attn, "serve_vits_p2", SERVE_VITS_P2_ARGV,
                                  VITS_P2_LOGIT_CHECKS, fault_keys=FAULT_KEYS)
    emit(serve_p2)
    check_serve_pinned(serve_p2, {"bf16": SMALL_TILED_KERNELS})

    train_p2 = train_vits_p2_phase(small, gm, vb, attn, smi)
    emit(train_p2)
    check_train_pinned(train_p2, SMALL_TILED_KERNELS, shape=("bf16", 128, 6, 1))

    serve_resnet = serve_resnet_phase(small, gm, vb, attn)
    emit(serve_resnet)
    check_serve_resnet(serve_resnet)

    train_resnet = train_resnet_phase(small, gm, vb, attn, smi)
    emit(train_resnet)
    check_train_resnet(train_resnet)

    train_resnet_fp32 = train_resnet_fp32_phase(small, gm, vb, attn, smi)
    emit(train_resnet_fp32)
    check_train_resnet_fp32(train_resnet_fp32)

    step_program = step_program_phase(smi)
    emit(step_program)
    check_step_program(step_program)

    host_data = host_data_phase(smi)
    emit(host_data)
    check_host_data(host_data)

    checkpoint = checkpoint_phase(smi)
    emit(checkpoint)
    check_checkpoint(checkpoint)

    csrc = f"{PKG}/ops/csrc"
    replaces = {
        "K1": "distributed_training_comparison_tpu/ops/attention.py:170",
        "K2": "distributed_training_comparison_tpu/ops/attention.py:224",
        "K3": "distributed_training_comparison_tpu/ops/attention.py:370",
        "K4": "distributed_training_comparison_tpu/ops/attention.py:427",
    }
    # one entry per checked case and kernel.  The forward's ``launches`` is
    # its count on the serve path (``launches_train`` on the train path,
    # ``launches_train_long_fp32`` on the fp32 one, which runs the fp32
    # kernel); the backward kernels' on the train path.  The backward's ``plain_ms``
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
            "launches_train_long_fp32": long_fp32["launches"]["fwd"],
            "at_main_path_shape": case["case"].startswith("slice:"),
            "kernels": case["kernels"],
            "max_abs_err": case["max_abs_err"], "max_abs_err_lse": case["max_abs_err_lse"],
            "atol_share": case["atol_share"], "rtol": case["rtol"],
            "tol_lse": case["tol_lse"], "atol_share_needed": case["atol_share_needed"],
            "fault_atol_share_needed": case["fault_atol_share_needed"],
            "ms": case["ms"], "kernel_ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"],
            "tflops": case["tflops"], "bound_share": case["bound_share"],
        })
    # the backward's ``launches``: bf16 on the train path, fp32 on train_long_fp32
    bwd_launches = {"bfloat16": (train["launches"], "train main path"),
                    "float32": (long_fp32["launches"], "train_long_fp32 main path")}
    for case in bwd:
        counts, path = bwd_launches[case["dtype"]]
        for kernel, regime, grads in (("dq", "K3", ("dq",)), ("dkv", "K4", ("dk", "dv"))):
            kernels.append({
                "name": f"flash_attention_{kernel}", "route": "cuda",
                "source": f"{csrc}/flash_attention_bwd.cu",
                "replaces": replaces[regime], "regime": regime,
                "case": case["case"], "shape_bhsd": case["shape"], "dtype": case["dtype"],
                "causal": case["causal"], "dlse": case["dlse"],
                "launches": counts[kernel],
                "launches_counted": f"{path}, one counter for every case of the dtype",
                "at_main_path_shape": case["case"].startswith("slice:"),
                "max_abs_err": max(case["grads"][g]["max_abs_err"] for g in grads),
                "atol_share": case["atol_share"], "rtol": case["rtol"],
                "atol_share_needed": max(case["grads"][g]["atol_share_needed"] for g in grads),
                "fault_atol_share_needed": min(
                    case["grads"][g]["fault_atol_share_needed"] for g in grads
                ),
                "ms": case[f"{kernel}_ms"], "plain_ms": case["plain_ms"],
                "bound_ms": case[f"{kernel}_bound_ms"], "bound_by": case[f"{kernel}_bound_by"],
                "library_ms": case["library_ms"], "kernels": case["kernels"][kernel],
                "library_kernels_ms_fwd_bwd": case["library_kernels_ms_fwd_bwd"],
                "bit_identical_across_calls": all(
                    case["bit_identical_across_calls"][g] for g in grads
                ),
                "pair_floor_ms_with_atomic_dq": case["pair_floor_ms_with_atomic_dq"],
            })
    # K5: per case, block_gemm (its four launches of one block together)
    # and block_attention, with the whole chain's numbers beside them.
    # ``launches`` is the kernel's count on the serve_tiny path in bf16, on
    # the train_tiny_fp32 path (its forward and K6's recompute) in fp32.
    for case in blocks:
        gemm = case["gemm_launches"].values()
        chain = case["chain"]
        fp32 = case["dtype"] == "float32"
        path, path_name = (tiny_fp32, "train_tiny_fp32") if fp32 else (tiny, "serve_tiny")
        common = {
            "route": "cuda", "source": f"{csrc}/vit_block_fwd.cu",
            "replaces": "distributed_training_comparison_tpu/ops/vit_block.py:166",
            "regime": "K5", "case": case["case"], "dtype": case["dtype"],
            "shape_b_s_dim_heads": case["shape"],
            "launches_counted": f"{path_name} main path, one counter for every case of the dtype",
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
            "launches": path["launches"]["block_gemm"],
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
            "launches": path["launches"]["block_attention"],
            "per_block_launches": 1,
            "max_abs_err": att["max_abs_err"], "atol_share_needed": att["atol_share_needed"],
            "fault_atol_share_needed": att["fault_atol_share_needed"], "kernels": att["kernels"],
            "ms": att["ms"], "event_ms": att["event_ms"], "plain_ms": att["plain_ms"],
            "bound_ms": att["bound_ms"], "bound_by": att["bound_by"],
            "library_ms": att["library_ms"], "library": "F.scaled_dot_product_attention",
        })
    # K6: per case, each kernel of the backward chain (its launches in one
    # block backward together), with the whole chain's numbers beside it.
    # ``launches`` is the kernel's count on the train_tiny path in bf16, on
    # train_tiny_fp32's in fp32; the recompute's block_gemm and
    # block_attention are K5's kernels, listed above.
    for case in bwd_blocks:
        fp32 = case["dtype"] == "float32"
        path, path_name = (tiny_fp32, "train_tiny_fp32") if fp32 else (tiny_train, "train_tiny")
        common = {
            "route": "cuda", "source": f"{csrc}/vit_block_bwd.cu",
            "replaces": "distributed_training_comparison_tpu/ops/vit_block.py:181",
            "regime": "K6", "case": case["case"], "dtype": case["dtype"],
            "shape_b_s_dim_heads": case["shape"],
            "launches_counted": f"{path_name} main path, one counter for every case of the dtype",
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
                "launches": path["launches"][name],
                "per_block_launches": K6_PER_BLOCK[name],
                "max_abs_err": case["stages"][name]["max_abs_err"],
                "atol_share_needed": case["stages"][name]["atol_share_needed"],
                "plain_ms": case["stages"][name]["plain_ms"],
                "library_ms": case["stages"][name]["library_ms"],
                "ms": case["kernel_ms"][name], "kernels": case["kernels"][name],
                "bound_ms": case["bound_ms"][name], "bound_by": case["bound_by"][name],
                **{k: case["stages"][name][k] for k in (
                    "bit_identical_across_calls", "part_b_bit_identical_to_in_order_sum")
                   if k in case["stages"][name]},
            })
    # no profile of the run showed the fp32 K7, K8 or K9 the 3xTF32 kernels replaced
    replaced = sorted({m.group(1) for n in PROFILED_KERNELS if (m := _KERNEL_SYMBOL.match(n))}
                      & set(REPLACED_MOE_KERNELS.values()))
    if replaced:
        raise RuntimeError(f"the run launched the replaced SIMT kernels {replaced}")
    # K7-K9: per case, one entry per kernel.  In bf16 ``launches`` is K7's
    # count on the serve_moe path (``launches_train`` on train_moe) and K8's
    # and K9's on the train_moe path; in fp32 all three counts are the
    # train_moe_fp32 path's.  K8's library yardstick is the composed form's
    # forward and its backward for dx alone (``library_bwd_ms``: its whole
    # backward, dx and dW together, K9's yardstick).
    moe_src = {"fwd": "moe_gmm_fwd.cu", "dx": "moe_gmm_bwd.cu", "dw": "moe_gmm_bwd.cu"}
    moe_body = {"fwd": 71, "dx": 114, "dw": 144}
    moe_regime = {"fwd": "K7", "dx": "K8", "dw": "K9"}
    moe_launches = {
        "bfloat16": {"fwd": serve_moe["launches"]["grouped_ffn_fwd"],
                     "dx": train_moe["launches"]["grouped_ffn_dx"],
                     "dw": train_moe["launches"]["grouped_ffn_dw"]},
        "float32": {k: train_moe_fp32["launches"][f"grouped_ffn_{k}"] for k in ("fwd", "dx", "dw")},
    }
    for case in moe_checks:
        fp32 = case["dtype"] == "float32"
        for k in ("fwd", "dx", "dw"):
            entry = {
                "name": f"moe_gmm_{k}", "route": "cuda", "source": f"{csrc}/{moe_src[k]}",
                "replaces": f"distributed_training_comparison_tpu/ops/moe_gmm.py:{moe_body[k]}",
                "regime": moe_regime[k], "case": case["case"], "dtype": case["dtype"],
                "n_cap_experts_dim_hidden": [case["n"], case["cap"], case["experts"],
                                             case["dim"], case["hidden"]],
                "kept_rows": case["kept_rows"], "kernel": MOE_SYMBOLS[case["dtype"]][k],
                "launches": moe_launches[case["dtype"]][k],
                "launches_counted": ("train_moe_fp32 main path" if fp32
                                     else "serve_moe main path" if k == "fwd" else "train_moe main path")
                + ", one counter for every case of the dtype",
                "ms": case["ms"][k], "event_ms": case["event_ms"][k], "kernels": case["kernels"][k],
                "plain_ms": case["plain_ms"][k],
                "bound_ms": case["bound_ms"][k], "bound_by": case["bound_by"][k],
                "library_ms": case["library_ms"]["bwd" if k == "dw" else k],
                "library_event_ms": case["library_event_ms"]["bwd" if k == "dw" else k],
                "library": case["library"],
                "bit_identical_across_calls": case["bit_identical_across_calls"],
                "dropped_rows_exact_zero": case["dropped_rows_exact_zero"],
            }
            if k == "fwd" and not fp32:
                entry["launches_train"] = train_moe["launches"]["grouped_ffn_fwd"]
            if fp32:
                entry["nan_in_x"] = case["nan_in_x"]
                entry["fp64_drift"] = case["fp64_drift"]
            if k == "dx":
                entry["library_bwd_ms"] = case["library_ms"]["bwd"]
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
    # In bf16 at 64 tokens K10's ``launches`` is its count on the serve_small
    # path (``launches_train`` on train_small); K11's, on train_small, counts
    # calls, each launching attn_small_bwd_onetile once.  In bf16 past 64
    # tokens (the tiled kernels) the counts are serve_vits_p2's and
    # train_vits_p2's (K11's calls each launch attn_small_dq_bf16 and
    # attn_small_dkv_bf16).  In fp32 both are counts on the train_small_fp32
    # path (K11's calls each launch attn_small_dq_f32 and attn_small_dkv_f32).
    for case in small_checks:
        tiled = case["dtype"] == "bfloat16" and case["shape_b_s_h_d"][1] > small.ONE_TILE
        if tiled:
            small_launches = {"fwd": serve_p2["launches"]["small_mha_fwd"],
                              "bwd": train_p2["launches"]["small_mha_bwd"]}
            counted = {"fwd": "serve_vits_p2 main path", "bwd": "train_vits_p2 main path"}
        elif case["dtype"] == "float32":
            small_launches = {"fwd": small_fp32["launches"]["small_mha_fwd"],
                              "bwd": small_fp32["launches"]["small_mha_bwd"]}
            counted = {"fwd": "train_small_fp32 main path", "bwd": "train_small_fp32 main path"}
        else:
            small_launches = {"fwd": serve_small["launches"]["small_mha_fwd"],
                              "bwd": train_small["launches"]["small_mha_bwd"]}
            counted = {"fwd": "serve_small main path", "bwd": "train_small main path"}
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
                "launches_counted": counted[key] + (", one counter for every bf16 case past 64 tokens" if tiled
                                                    else ", one counter for every case of the dtype"),
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
            if key == "fwd" and case["dtype"] == "bfloat16":
                entry["launches_train"] = (train_p2 if tiled else train_small)["launches"]["small_mha_fwd"]
            if key == "bwd":
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


# (label, dtype, B, H, S, D, causal) of ``flash_output_hashes``: the
# backward's fp32 and bf16 cases at the tiles' edges, causal and not
FLASH_HASH_CASES = [
    ("fp32, S 1000, D 128", "float32", 1, 4, 1000, 128, False),
    ("fp32 ragged causal, S 1030, D 64", "float32", 2, 4, 1030, 64, True),
    ("bf16, S 1000, D 128", "bfloat16", 2, 4, 1000, 128, False),
    ("bf16 causal, S 257, D 64", "bfloat16", 2, 2, 257, 64, True),
]


def flash_output_hashes(attn) -> dict[str, str]:
    """sha256 of the flash kernels' results at ``FLASH_HASH_CASES`` on seeded
    inputs: the forward's out and lse, and K3's and K4's gradients with an
    lse cotangent on residuals (out, lse) from the plain forward, so that
    the backward's digests do not depend on the forward kernel.  Two
    checkouts whose kernels compute bit-identical results print the same
    digests."""
    import hashlib

    import torch

    gen = torch.Generator().manual_seed(13)
    out = {}
    for label, dname, b, h, s, d, causal in FLASH_HASH_CASES:
        dtype = getattr(torch, dname)
        q, k, v, do = (torch.randn((b, h, s, d), generator=gen).to(device="cuda", dtype=dtype)
                       for _ in range(4))
        dlse = torch.randn((b, h, s), generator=gen).cuda()
        o, lse = attn.mha_reference(q, k, v, causal=causal, return_lse=True)
        adj = attn._row_adjustment(o, do, dlse)
        kw = dict(causal=causal, scale=d**-0.5)
        results = {"fwd": attn.flash_attention(q, k, v, causal=causal, return_lse=True),
                   "dq": [attn.flash_attention_dq(q, k, v, do, lse, adj, **kw)],
                   "dkv": attn.flash_attention_dkv(q, k, v, do, lse, adj, **kw)}
        for key, res in results.items():
            digest = hashlib.sha256()
            for t in res:
                digest.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
            out[f"{label}: {key}"] = digest.hexdigest()[:16]
    return out


def sdpa_fp32_forward(attn) -> dict:
    """SDPA's fp32 forward, the K1 yardstick, at the fp32 serving shape
    (bh 32, S 4096, D 128, bshd views): the kernels it runs by device ms,
    and its output's and the port's agreement with ``mha_reference`` (the
    least share of a row's rms, rtol 0: ``atol_share_needed``)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = (torch.randn((8, 4096, 4, 128), generator=gen, device="cuda") for _ in range(3))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = profile_device(lambda: F.scaled_dot_product_attention(qt, kt, vt), 1)["device_ms_by_name"]
    ref = attn.mha_reference(q, k, v, layout="bshd")
    lib = F.scaled_dot_product_attention(qt, kt, vt).transpose(1, 2)
    port = attn.flash_attention(qt, kt, vt).transpose(1, 2)
    return {
        "shape_bhsd": [8, 4, 4096, 128],
        "kernels_ms": {n[:120]: ms for n, ms in sorted(sdpa.items(), key=lambda kv: -kv[1])[:4]},
        "atol_share_needed": atol_share_needed(lib, ref, 0.0),
        "port_atol_share_needed": atol_share_needed(port, ref, 0.0),
    }


def moe_dispatch(csrc: Path | None = None, reps: int = 20, argv: list = SERVE_MOE_ARGV) -> dict:
    """One bucket-32 batch of the serve command ``argv``'s engine (the
    ``serve_moe`` command's by default: gmm, bf16) as the serve path
    dispatches it: host ms a dispatch (median of ``reps`` after one
    warm-up, twice), and its profile (``moe_dispatch_profile``)."""
    import statistics

    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool

    hp = load_config(argv)
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


def moe_output_hashes(gm) -> dict[str, str]:
    """sha256 of K7's output, K8's dx and K9's gradients at each case of
    ``MOE_GMM_CASES`` on its seeded inputs (``moe_case_inputs``), in fp32
    K8's dx apart: two checkouts whose kernels give bit-identical results
    print the same digests."""
    out = {}
    for label, dname, n, cap, counts in MOE_GMM_CASES:
        _, starts, xs, dy, w1, b1, w2, b2 = moe_case_inputs(dname, n, counts)
        y = gm.grouped_ffn_fwd(xs, w1, b1, w2, b2, starts, cap)
        dx = gm.grouped_ffn_dx(xs, dy, w1, b1, w2, starts, cap)
        dw = gm.grouped_ffn_dw(xs, dy, w1, b1, w2, starts, cap)
        if dname == "float32":
            out[f"{label}: K8"] = _digest([dx])
            out[f"{label}: K7, K9"] = _digest([y, *dw])
        else:
            out[label] = _digest([y, dx, *dw])
    return out


def card_state() -> str:
    """The card's SM clock, temperature, power draw and power limit now, as
    ``nvidia-smi`` reads them: a turn's readings beside the card's state."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def vits_p2_turn(csrc: Path) -> dict:
    """The ``vit_small --patch-size 2`` path for ``turn``: its train step
    (``pinned_step_times``, two rounds) and its bucket-32 dispatch
    (``bucket32_dispatch``), pinned to fused_small and under auto."""
    import torch

    from distributed_training_comparison_tpu_torch.serve import build_engine, request_pool
    from distributed_training_comparison_tpu_torch.train import Trainer, build_model

    hp = load_config(TRAIN_VITS_P2_ARGV)
    trainer = Trainer(hp, model=build_model(hp, attn_impl="fused_small"))
    step = pinned_step_times(trainer, csrc=csrc, rounds=2)
    del trainer
    torch.cuda.empty_cache()
    hp = load_config(SERVE_VITS_P2_ARGV)
    batch = request_pool(32, image_size=hp.image_size, seed=hp.seed, fold=("check", 0))
    dispatch = bucket32_dispatch({"fused_small": build_engine(hp, attn_impl="fused_small"),
                                  "auto": build_engine(hp)}, batch, csrc=csrc)
    torch.cuda.empty_cache()
    return {"step": step, "dispatch": dispatch}


def turn(checkout: Path, label: str) -> int:
    """One turn of a comparison of checkouts in one call: the port of
    ``checkout`` (put first on ``sys.path``; this tree or a parent unpacked
    by ``git archive``) built and driven through this script's timing
    functions: the flash forward's K1/K2 at every ``KERNEL_CASES`` case
    (``kernel_checks``), the flash backward's K3/K4 at every
    ``BACKWARD_CASES`` case (``backward_checks``), digests of both
    (``flash_output_hashes``), SDPA's fp32 forward (``sdpa_fp32_forward``),
    the ``vit_long`` fp32 train step at batch 16
    (``long_fp32_step_times``), the fused block chains (``fused_block_checks``,
    ``fused_block_bwd_checks``), the ``train_tiny`` step and the bucket-32
    dispatch (``tiny_step_times``, ``tiny_dispatch``), K10/K11
    (``small_attention_checks``) and digests of their results
    (``small_output_hashes``), K7-K9 through their wrappers
    (``moe_gmm_checks``) and digests of their results
    (``moe_output_hashes``), the ``vit_moe`` train step and K8 at its own
    routing (``moe_step_times``) and its bucket-32 dispatch
    (``moe_dispatch``), then both again in fp32 with the kernels taken
    (``TRAIN_MOE_FP32_ARGV``, ``SERVE_MOE_FP32_ARGV``);
    ``block_grad_reduce``'s digests come with the K6
    chain's records; last, the fp32 ``vit_tiny`` p2 step
    (``tiny_fp32_step_times``, ``tiny_step_times`` fused and off) and
    bucket-32 dispatch (``tiny_dispatch``), then the fp32 ``vit_tiny`` step
    at 64 tokens pinned to fused_small and under auto
    (``pinned_step_times``), and the card's clocks and power
    (``card_state``) at the start, before K10/K11 and K7-K9, before each
    fp32 step and at the end.  The summary splits every K5 and K6 case by
    stage, and gives K6's LayerNorm kernels (``k6_ln``) and the edge cases
    of ``block_ln_checks`` (a parent's kernel, whose source states no dβ
    order, reads None there).
    Last come the ``vit_small --patch-size 2`` train step and bucket-32
    dispatch pinned to fused_small and under auto (``vits_p2_turn``).  Run
    parent, this tree, this tree, parent:

        python3 chip_smoke.py --turn PARENT_DIR parent

    It writes every record to ``chiprun_out/turns/<label>.json`` and prints
    a summary line; it checks nothing, so that a parent's kernels, whose
    symbols this script does not hold, are timed as they are."""
    import torch

    checkout = checkout.resolve()
    sys.path.insert(0, str(checkout))
    try:
        from distributed_training_comparison_tpu_torch._device import pin_fp32_math
    except ImportError:  # a checkout from before the port pinned fp32 math itself
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        pin_fp32_math()
    # cuDNN held to its deterministic algorithms, as the product holds it
    # since its checkpoints (a parent's turn runs under the same setting)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
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
    attn = importlib.import_module(f"{PKG}.ops.attention")
    csrc = checkout / PKG / "ops" / "csrc"
    _build.build_all()
    from distributed_training_comparison_tpu_torch.train import Trainer, build_model

    fwd = kernel_checks(attn, csrc)
    hashes = flash_output_hashes(attn)
    sdpa = sdpa_fp32_forward(attn)
    torch.cuda.empty_cache()
    bwd = backward_checks(attn, csrc)
    trainer = Trainer(load_config(TRAIN_LONG_FP32_ARGV))
    long_fp32 = long_fp32_step_times(trainer, csrc=csrc)
    del trainer
    torch.cuda.empty_cache()
    # the attention stages at the train shape (B 128), timed whatever their
    # kernels' symbols: K6's recompute (the forward) and its backward
    gen = torch.Generator().manual_seed(12)
    qkv = torch.randn((128 * 256, 576), generator=gen).to(device="cuda", dtype=torch.bfloat16)
    do = torch.randn((128 * 256, 192), generator=gen).to(device="cuda", dtype=torch.bfloat16)
    b128 = {"block_attention_ms": timed(lambda: vb.block_attention(qkv, seq=256, heads=3))[0],
            "block_attention_bwd_ms": timed(lambda: vb.block_attention_bwd(qkv, do, seq=256, heads=3))[0]}
    del qkv, do
    rec = {"turn": label, "checkout": str(checkout), "nvidia_smi": smi, "card_start": card_state(),
           "kernel_checks": fwd, "flash_output_hashes": hashes, "sdpa_fp32_forward": sdpa,
           "backward_checks": bwd, "long_fp32_step": long_fp32, "attention_b128": b128,
           "fused_block_checks": fused_block_checks(vb),
           "fused_block_bwd_checks": fused_block_bwd_checks(vb, csrc),
           "block_ln_checks": block_ln_checks(vb, csrc),
           "tiny_step_times": tiny_step_times(), "tiny_dispatch": tiny_dispatch(),
           "card_before_small_moe": card_state(),
           "small_attention_checks": small_attention_checks(small),
           "small_output_hashes": small_output_hashes(small),
           "moe_gmm_checks": moe_gmm_checks(gm), "moe_output_hashes": moe_output_hashes(gm),
           "moe_step_times": moe_step_times(csrc=csrc), "moe_dispatch": moe_dispatch(csrc)}
    # the fp32 vit_moe step and bucket-32 dispatch through the kernels
    rec["card_before_moe_fp32"] = card_state()
    rec["moe_step_times_fp32"] = moe_step_times(csrc=csrc, argv=TRAIN_MOE_FP32_ARGV)
    rec["moe_dispatch_fp32"] = moe_dispatch(csrc, argv=SERVE_MOE_FP32_ARGV)
    # the fp32 vit_tiny p2 path last: the parent's SIMT and this tree's
    # 3xTF32 kernels load the card differently, so no other reading follows them
    rec["card_before_tiny_fp32"] = card_state()
    trainer = Trainer(load_config(TRAIN_TINY_FP32_RUN_ARGV))
    rec["tiny_fp32_step"] = tiny_fp32 = tiny_fp32_step_times(trainer, csrc=csrc)
    del trainer
    torch.cuda.empty_cache()
    rec["tiny_step_times_fp32"] = tiny_step_times(argv=TRAIN_TINY_FP32_RUN_ARGV)
    rec["tiny_dispatch_fp32"] = tiny_dispatch(SERVE_TINY_FP32_ARGV)
    # the fp32 vit_tiny step at 64 tokens pinned to fused_small (K10/K11 in fp32)
    rec["card_before_small_fp32"] = card_state()
    hp = load_config(TRAIN_SMALL_FP32_ARGV)
    trainer = Trainer(hp, model=build_model(hp, attn_impl="fused_small"))
    rec["small_fp32_step"] = small_fp32 = pinned_step_times(trainer, csrc=csrc)
    del trainer
    torch.cuda.empty_cache()
    rec["card_before_vits_p2"] = card_state()
    rec["vits_p2"] = vits_p2_turn(csrc)
    rec["card_end"] = card_state()
    serve, train = rec["fused_block_checks"][0], rec["fused_block_bwd_checks"][0]
    step, disp = rec["tiny_step_times"], rec["tiny_dispatch"]["bucket32_profile"]
    step32, disp32 = rec["tiny_step_times_fp32"], rec["tiny_dispatch_fp32"]
    moe_step, moe_disp = rec["moe_step_times"], rec["moe_dispatch"]
    moe32, disp_moe32 = rec["moe_step_times_fp32"], rec["moe_dispatch_fp32"]
    p2_step, p2_disp = rec["vits_p2"]["step"], rec["vits_p2"]["dispatch"]
    split = long_fp32["step_profile"]["device_ms_per_step"]
    summary = {
        "turn": label, "nvidia_smi": smi,
        "card": {k: rec[k] for k in ("card_start", "card_before_small_moe", "card_before_moe_fp32",
                                     "card_before_tiny_fp32",
                                     "card_before_small_fp32", "card_before_vits_p2", "card_end")},
        "k1_k2_ms": {c["case"]: c["ms"] for c in fwd},
        "k1_k2_bound_share": {c["case"]: c["bound_share"] for c in fwd},
        "k1_k2_atol_share_needed": {c["case"]: c["atol_share_needed"] for c in fwd},
        "k1_k2_kernels": {c["case"]: c["kernels"] for c in fwd},
        "k1_k2_ok": {c["case"]: c["ok"] for c in fwd},
        "k1_k2_sdpa_ms": {c["case"]: c["library_ms"] for c in fwd},
        "flash_output_hashes": hashes,
        "sdpa_fp32_forward": sdpa,
        "k3_k4_ms": {c["case"]: [c["dq_ms"], c["dkv_ms"]] for c in bwd},
        "k3_k4_kernels": {c["case"]: c["kernels"] for c in bwd},
        "k3_k4_ok": {c["case"]: c["ok"] for c in bwd},
        "k3_k4_sdpa_bwd_ms": {c["case"]: c["library_ms"] for c in bwd},
        "long_fp32_ms_per_step": long_fp32["ms_per_step"],
        "long_fp32_busy_ms": long_fp32["step_profile"]["device_busy_ms_per_step"],
        "long_fp32_idle_share": long_fp32["step_profile"]["device_idle_share"],
        "long_fp32_device_ms": split,
        "long_fp32_dq_dkv_share": long_fp32["flash_dq_dkv_share_of_busy"],
        "k5_serve_chain_ms": serve["chain"]["ms"],
        "block_attention_serve_ms": serve["attention"]["ms"],
        "block_attention_serve_sdpa_ms": serve["attention"]["library_ms"],
        "block_attention_serve_kernels": serve["attention"].get("kernels"),
        "k6_chain_ms": train["chain_ms"],
        "block_attention_b128_ms": b128["block_attention_ms"],
        "block_attention_bwd_b128_ms": b128["block_attention_bwd_ms"],
        "block_attention_bwd_sdpa_fwd_bwd_ms": train["stages"]["block_attention_bwd"]["library_ms"],
        # every K5 and K6 case split by stage: K5's four GEMM launches and its
        # attention, K6's kernels by wrapper (each over its launches in one block)
        "k5_split_ms": {c["case"]: {"chain": c["chain"]["ms"], "library": c["chain"]["library_ms"],
                                    **{n: g["ms"] for n, g in c["gemm_launches"].items()},
                                    "block_attention": c["attention"]["ms"]}
                        for c in rec["fused_block_checks"]},
        "k6_split_ms": {c["case"]: {"chain": c["chain_ms"], "library": c["library_ms"], **c["kernel_ms"]}
                        for c in rec["fused_block_bwd_checks"]},
        "k5_k6_digests": {c["case"]: c["chain"]["digest"] for c in rec["fused_block_checks"]}
        | {c["case"]: c["digest"] for c in rec["fused_block_bwd_checks"]},
        "train_tiny_fp32_step": {k: tiny_fp32[k] for k in (
            "ms_per_step", "images_per_s_timed", "device_busy_ms_per_step", "device_idle_share",
            "device_ms_per_step", "kernel_ms_per_step_by_wrapper", "port_kernels")},
        "train_tiny_fp32": {
            "ms_per_step": [step32["ms_per_step_fused"], step32["ms_per_step_fused_again"]],
            "ms_per_step_off": [step32["ms_per_step_off"], step32["ms_per_step_off_again"]],
            "busy_ms": step32["profile"]["device_busy_ms_per_step"],
            "idle_share": step32["profile"]["device_idle_share"],
            "kernel_ms_by_wrapper": step32["profile"]["kernel_ms_per_step_by_wrapper"],
            "port_kernels": step32["profile"]["port_kernels"],
        },
        "bucket32_fp32": {
            "ms": [disp32["bucket32_batch_ms_fused"], disp32["bucket32_batch_ms_fused_again"]],
            "ms_off": [disp32["bucket32_batch_ms_off"], disp32["bucket32_batch_ms_off_again"]],
            "busy_ms": disp32["bucket32_profile"]["device_busy_ms_per_batch"],
            "idle_share": disp32["bucket32_profile"]["device_idle_share"],
            "port_kernels": disp32["bucket32_profile"]["port_kernels"],
        },
        "train_tiny_busy_ms": step["profile"]["device_busy_ms_per_step"],
        "train_tiny_idle_share": step["profile"]["device_idle_share"],
        "train_tiny_images_per_s": [step["images_per_s_fused"], step["images_per_s_fused_again"]],
        "bucket32_ms": [rec["tiny_dispatch"]["bucket32_batch_ms_fused"],
                        rec["tiny_dispatch"]["bucket32_batch_ms_fused_again"]],
        "bucket32_busy_ms": disp["device_busy_ms_per_batch"],
        "bucket32_idle_share": disp["device_idle_share"],
        "k10_k11_ms": {c["case"]: [c["ms"]["fwd"], c["ms"]["bwd"]] for c in rec["small_attention_checks"]},
        "k10_k11_kernel_ms": {c["case"]: c["kernel_ms"] for c in rec["small_attention_checks"]},
        "k10_k11_sdpa_ms": {c["case"]: [c["library_ms"]["fwd"], c["library_ms"]["bwd"]]
                            for c in rec["small_attention_checks"]},
        "k10_k11_plain_ms": {c["case"]: [c["plain_ms"]["fwd"], c["plain_ms"]["bwd"]]
                             for c in rec["small_attention_checks"]},
        "k10_k11_atol_share_needed": {c["case"]: max(a["atol_share_needed"] for a in c["agreement"].values())
                                      for c in rec["small_attention_checks"]},
        "k10_k11_ok": {c["case"]: c["ok"] for c in rec["small_attention_checks"]},
        "small_output_hashes": rec["small_output_hashes"],
        "vits_p2_step": {name: {k: r[k] for k in (
            "ms_per_step", "ms_per_step_again", "device_busy_ms_per_step", "device_idle_share",
            "device_ms_per_step", "port_kernel_ms_per_step")} for name, r in p2_step.items()},
        "vits_p2_bucket32": {
            name: {"ms": [p2_disp[f"bucket32_batch_ms_{name}"], p2_disp[f"bucket32_batch_ms_{name}_again"]],
                   **{k: p2_disp[f"bucket32_profile_{name}"][k] for k in (
                       "device_busy_ms_per_batch", "device_idle_share", "k10_device_ms_per_batch", "port_kernels")}}
            for name in ("fused_small", "auto")},
        "train_small_fp32": {name: {k: r[k] for k in (
            "ms_per_step", "images_per_s_timed", "device_busy_ms_per_step", "device_idle_share",
            "device_ms_per_step", "port_kernels")} for name, r in small_fp32.items()},
        "k7_k8_k9_ms": {c["case"]: [c["ms"]["fwd"], c["ms"]["dx"], c["ms"]["dw"]] for c in rec["moe_gmm_checks"]},
        "k7_k8_k9_kernels": {c["case"]: c["kernels"] for c in rec["moe_gmm_checks"]},
        "moe_gmm_checks_ok": {c["case"]: c["ok"] for c in rec["moe_gmm_checks"]},
        "moe_train_busy_ms": moe_step["profile_gmm"]["device_busy_ms_per_step"],
        "moe_train_idle_share": moe_step["profile_gmm"]["device_idle_share"],
        "moe_train_kernels_ms": moe_step["profile_gmm"]["moe_kernels"],
        "moe_train_images_per_s": [moe_step["images_per_s_gmm"], moe_step["images_per_s_gmm_again"]],
        "moe_train_gather_busy_ms": moe_step["profile_gather"]["device_busy_ms_per_step"],
        "k8_dx_library_ms": {c["case"]: c["library_ms"]["dx"] for c in rec["moe_gmm_checks"]},
        "k8_alone_at_step_routing_ms": moe_step["k8_at_step_routing"]["ms_alone_per_launch"],
        "k8_step_routing": [{k: b[k] for k in ("kept_rows", "units", "ms_alone")}
                            for b in moe_step["k8_at_step_routing"]["blocks"]],
        # the LayerNorm kernels at every K6 case (device ms over a chain's two
        # launches each), beside their bound, plain and library times, their
        # agreement and bits; then the edge cases of block_ln_checks
        "k6_ln": {c["case"]: {name: {
            "ms": c["kernel_ms"][name], "bound_ms": c["bound_ms"][name],
            "plain_ms": c["stages"][name]["plain_ms"], "library_ms": c["stages"][name]["library_ms"],
            "atol_share_needed": c["stages"][name]["atol_share_needed"],
            "bit_identical_across_calls": c["stages"][name].get("bit_identical_across_calls"),
            "part_b_bit_identical_to_in_order_sum": c["stages"][name].get("part_b_bit_identical_to_in_order_sum"),
        } for name in ("block_ln", "block_ln_bwd")} for c in rec["fused_block_bwd_checks"]},
        "block_ln_checks_ok": f'{sum(c["ok"] for c in rec["block_ln_checks"])} of {len(rec["block_ln_checks"])}',
        "k6_grad_reduce_ms": {c["case"]: c["kernel_ms"]["block_grad_reduce"] for c in rec["fused_block_bwd_checks"]},
        "k6_grad_reduce_bits": {c["case"]: [c["stages"]["block_grad_reduce"][k] for k in (
            "partials_digest", "digest", "bit_identical_to_in_order_sum")] for c in rec["fused_block_bwd_checks"]},
        "moe_bucket32_ms": [moe_disp["bucket32_batch_ms"], moe_disp["bucket32_batch_ms_again"]],
        "moe_bucket32_busy_ms": moe_disp["bucket32_profile"]["device_busy_ms_per_batch"],
        "moe_bucket32_idle_share": moe_disp["bucket32_profile"]["device_idle_share"],
        "moe_bucket32_k7_ms": moe_disp["bucket32_profile"]["k7_device_ms_per_batch"],
        "moe_output_hashes": rec["moe_output_hashes"],
        "moe_fp32_train": {
            "ms_per_step": [moe32[f"ms_per_step_{n}{r}"] for n in ("gmm", "gather") for r in ("", "_again")],
            **{f"{k}_{n}": moe32[f"profile_{n}"][key] for n in ("gmm", "gather") for k, key in (
                ("busy_ms", "device_busy_ms_per_step"), ("idle_share", "device_idle_share"),
                ("moe_kernels_ms", "moe_kernels"))},
        },
        "moe_fp32_bucket32": {
            "ms": [disp_moe32["bucket32_batch_ms"], disp_moe32["bucket32_batch_ms_again"]],
            "busy_ms": disp_moe32["bucket32_profile"]["device_busy_ms_per_batch"],
            "idle_share": disp_moe32["bucket32_profile"]["device_idle_share"],
            "k7_ms": disp_moe32["bucket32_profile"]["k7_device_ms_per_batch"],
        },
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
        if sys.argv[1:] and set(sys.argv[1:]) <= set(PHASE_FLAGS):
            sys.exit(phases_main(sys.argv[1:]))
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
