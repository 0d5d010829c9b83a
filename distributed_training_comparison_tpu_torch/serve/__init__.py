"""Serving: bucketed engine, SLO-class micro-batcher, load generators.

Counterpart of ``distributed_training_comparison_tpu/serve/``:

- ``engine.py``  — bucketed inference on the card (or the CPU on request);
- ``batcher.py`` — the SLO-class request queue and the single-worker
  ``MicroBatcher`` (continuous and bucketed admission);
- ``loadgen.py`` — closed and open loops;
- ``metrics.py`` — latency percentiles and serving counters.

``serve_main`` is the ``--serve`` entry: one engine behind one
``MicroBatcher`` (the JAX package's single-replica path), driven by the
configured load shape, on ``--serve-ckpt`` or the checkpoint
``train/checkpoint.py::find_serving_checkpoint`` discovers under
``--ckpt-path`` (with neither, fresh weights seeded by ``--seed`` and a
warning).  The router and fleet, request tracing and the event bus come
with later slices.
"""

from __future__ import annotations

import logging
import warnings

from ..train.checkpoint import find_serving_checkpoint
from .batcher import (
    DEFAULT_CLASS,
    BatcherClosed,
    ClassQueue,
    DeadlineExceeded,
    MicroBatcher,
    QueueOverflow,
    ServeError,
    ServeFuture,
    SLOClass,
    SLOClassError,
    dispatch_batch,
    parse_slo_classes,
)
from .engine import DEFAULT_BUCKETS, ServeEngine
from .loadgen import closed_loop, fold_seed, open_loop, request_pool
from .metrics import ServeMetrics, latency_summary_ms

__all__ = [
    "BatcherClosed", "ClassQueue", "DEFAULT_BUCKETS", "DEFAULT_CLASS",
    "DeadlineExceeded", "MicroBatcher", "QueueOverflow", "SLOClass",
    "SLOClassError", "ServeEngine", "ServeError", "ServeFuture", "ServeMetrics",
    "build_engine", "closed_loop", "dispatch_batch", "fold_seed",
    "latency_summary_ms", "open_loop", "parse_slo_classes", "request_pool",
    "serve_main",
]

log = logging.getLogger(__name__)


def build_engine(hparams, attn_impl: str = "auto") -> ServeEngine:
    """A ``ServeEngine`` from a parsed flag namespace (``config.py``), with
    the JAX package's flag→model mapping: dtype from ``--precision`` /
    ``--amp``, ``--stem`` for every model, and for a ViT the image and
    patch sizing, the MoE dispatch and the block-fusion policy (the norms
    keep their fp32 default, as the JAX engine builds them).  Weights are
    ``--serve-ckpt``'s, else those of the newest version dir's best
    checkpoint under ``--ckpt-path`` (or its ``last.ckpt``); with neither
    the engine serves a fresh initialization seeded by ``--seed`` and warns
    (load-testing mode).  ``attn_impl`` pins a ViT's attention
    implementation, for holding the kernel path against the reference."""
    compute = "bf16" if hparams.precision == "bf16" else "fp32"
    model_kw: dict = {"stem": hparams.stem}
    if hparams.model.startswith("vit"):
        model_kw["attn_impl"] = attn_impl
        model_kw["image_size"] = hparams.image_size
        if hparams.patch_size:
            model_kw["patch"] = hparams.patch_size
        model_kw["moe_dispatch"] = hparams.moe_dispatch
        model_kw["block_fusion"] = hparams.block_fusion
    ckpt_path = hparams.serve_ckpt
    if ckpt_path is None:
        ckpt_path = find_serving_checkpoint(hparams.ckpt_path)
        if ckpt_path is None:
            warnings.warn(
                f"no checkpoint under {hparams.ckpt_path!r}; serving "
                "fresh-initialized weights (load-testing mode)",
                UserWarning,
            )
    return ServeEngine(
        model_name=hparams.model,
        model_kw=model_kw,
        checkpoint_path=ckpt_path,
        seed=hparams.seed,
        buckets=hparams.serve_buckets,
        precision=compute,
        image_size=hparams.image_size,
        device=hparams.device,
    )


def _run_load_shape(hparams, batcher, images, deadline) -> dict:
    shape = hparams.serve_shape
    if shape == "auto":
        shape = "open" if hparams.serve_rate > 0 else "closed"
    if shape == "closed":
        return closed_loop(
            batcher, images, num_requests=hparams.serve_requests,
            concurrency=hparams.serve_concurrency, deadline_ms=deadline,
        )
    return open_loop(
        batcher, images,
        rate_rps=hparams.serve_rate if hparams.serve_rate > 0 else 64.0,
        num_requests=hparams.serve_requests, deadline_ms=deadline,
        seed=hparams.seed,
    )


def serve_main(hparams) -> dict:
    """The ``--serve`` entry: engine + micro-batcher + load shape + report.

    Returns the load generator's report (offered, completed, shed, expired,
    failed, duration, throughput, latency percentiles) plus the engine's
    ``stats()`` under ``engine``, the batcher's counters under ``batcher``
    and the served checkpoint's ``checkpoint_meta`` (its path, epoch and
    accuracy; None for fresh weights) under ``checkpoint``.
    """
    engine = build_engine(hparams)
    engine.warmup()
    ck = engine.checkpoint_meta
    log.info(
        "[serve] model %s on %s (%s), buckets %s warmed, %s",
        hparams.model, engine.device, hparams.precision, list(engine.buckets),
        f"checkpoint epoch {ck['epoch']} (acc {ck['acc']:.4f})" if ck
        else f"fresh weights (seed {hparams.seed}, no checkpoint)",
    )
    images = request_pool(
        max(256, engine.max_bucket), image_size=engine.image_size,
        seed=hparams.seed, fold=("serve", 0),
    )
    batcher = MicroBatcher(
        engine,
        mode=hparams.serve_mode,
        max_wait_ms=hparams.max_wait_ms,
        queue_limit=hparams.queue_limit,
    )
    try:
        report = _run_load_shape(hparams, batcher, images, hparams.deadline_ms or None)
    finally:
        batcher.close()
    report["engine"] = engine.stats()
    report["checkpoint"] = ck
    report["batcher"] = batcher.metrics.summary()
    lat = report["latency_ms"]
    log.info(
        "[serve] %d ok / %d shed / %d expired / %d failed in %.1fs (%.1f req/s), "
        "latency ms p50 %.2f p99 %.2f",
        report["completed"], report["shed"], report["expired"], report["failed"],
        report["duration_s"], report["throughput_rps"], lat["p50"], lat["p99"],
    )
    return report
