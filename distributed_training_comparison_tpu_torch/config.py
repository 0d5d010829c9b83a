"""Command-line flags of the port: the serving subset of
``distributed_training_comparison_tpu/config.py``.

Same names, defaults and choices as the JAX package's flags, with two
written deltas: ``--device {cuda,cpu}`` (default ``cuda``) is new, and
``--serve-shape`` takes only ``auto``/``closed``/``open`` and
``--serve-replicas`` only 1 until the router and the fleet's load shapes
are ported.
"""

from __future__ import annotations

import argparse
from typing import Sequence

MODELS = (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "vit_tiny", "vit_small", "vit_long", "vit_moe",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_training_comparison_tpu_torch",
        description="PyTorch/CUDA port: serve a zoo model on the card",
    )
    p.add_argument("--seed", type=int, default=42, help="Seed for reproducibility")
    p.add_argument("--amp", action="store_true", default=False,
                   help="bfloat16 compute policy")
    p.add_argument("--precision", type=str, default=None, choices=["fp32", "bf16"],
                   help="Compute precision; overrides --amp when set")
    p.add_argument("--model", type=str, default="resnet18", choices=list(MODELS),
                   help="Model zoo entry (the port serves the vit_* models)")
    p.add_argument("--image-size", type=int, default=32,
                   help="Request image edge length (vit_long: 256)")
    p.add_argument("--patch-size", type=int, default=0,
                   help="ViT patch size override (0 = model default)")
    p.add_argument("--block-fusion", type=str, default="auto",
                   choices=["auto", "force", "off"],
                   help="fused ViT block kernel: not ported yet, so 'auto' and "
                   "'off' compose and 'force' raises")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Where the model runs; cuda without a card raises")
    p.add_argument("--serve", action="store_true", default=False,
                   help="Run the bucketed inference engine + load generator "
                   "and print a latency/throughput report")
    p.add_argument("--serve-buckets", type=str, default="1,2,4,8,16,32",
                   help="Comma-separated padded batch-size buckets; the "
                   "largest is the micro-batcher's max coalesced batch")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="Bucketed-mode coalescing window")
    p.add_argument("--serve-mode", type=str, default="continuous",
                   choices=("continuous", "bucketed"),
                   help="Batch admission policy")
    p.add_argument("--serve-replicas", type=int, default=1,
                   help="Engine replicas (only 1 until the router is ported)")
    p.add_argument("--serve-shape", type=str, default="auto",
                   choices=("auto", "closed", "open"),
                   help="Load shape: 'auto' = open loop when --serve-rate > 0, "
                   "else closed")
    p.add_argument("--queue-limit", type=int, default=256,
                   help="Load-shed bound on the queue depth")
    p.add_argument("--serve-rate", type=float, default=0.0,
                   help="Open-loop Poisson arrival rate in requests/sec")
    p.add_argument("--serve-requests", type=int, default=512,
                   help="Total requests the load generator offers")
    p.add_argument("--serve-concurrency", type=int, default=8,
                   help="Closed-loop in-flight requests")
    p.add_argument("--deadline-ms", type=float, default=0.0,
                   help="Per-request deadline (0 = none)")
    return p


def load_config(argv: Sequence[str] | None = None) -> argparse.Namespace:
    """Parse flags (``argv=None`` reads ``sys.argv``)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.precision is None:
        args.precision = "bf16" if args.amp else "fp32"
    try:
        buckets = tuple(sorted({int(t) for t in args.serve_buckets.split(",") if t.strip()}))
    except ValueError:
        buckets = ()
    if not buckets or buckets[0] < 1:
        parser.error(
            f"--serve-buckets must be positive integers, got {args.serve_buckets!r}"
        )
    args.serve_buckets = buckets
    if args.serve_replicas != 1:
        parser.error(
            f"--serve-replicas {args.serve_replicas}: the port serves one replica "
            "until the router is ported (ROADMAP.md queue 1)"
        )
    return args
