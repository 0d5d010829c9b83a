"""Command-line flags of the port: the training and serving subset of
``distributed_training_comparison_tpu/config.py``.

Same names, defaults and choices as the JAX package's flags (its ``single``
backend: one device, ``--epoch`` 200), with the written deltas of
``WRITTEN_DELTAS``.  The JAX package's other flags are not parsed yet.
"""

from __future__ import annotations

import argparse
from typing import Sequence

# flags that parse as in the JAX package but behave differently on purpose
# (or are new), until the ROADMAP item named lands
WRITTEN_DELTAS = {
    "device": "new: where the model runs, cuda (default) or cpu",
    "serve_shape": "only auto/closed/open until the fleet's load shapes are ported",
    "serve_replicas": "only 1 until the router is ported",
    "data_mode": "both modes take the host loader's numpy (seed, epoch) order; "
    "the JAX device mode permutes with threefry",
    "contain_test": "tests the final in-memory state; no checkpoint is written yet",
}

MODELS = (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "vit_tiny", "vit_small", "vit_long", "vit_moe",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distributed_training_comparison_tpu_torch",
        description="PyTorch/CUDA port: train or serve a zoo model on the card",
    )
    p.add_argument("--dset", type=str, default="cifar100")
    p.add_argument("--dpath", type=str, default="data/")
    p.add_argument("--seed", type=int, default=42, help="Seed for reproducibility")
    p.add_argument("--eval-step", type=int, default=300,
                   help="Log the batch loss every N global steps")
    p.add_argument("--amp", action="store_true", default=False,
                   help="bfloat16 compute policy")
    p.add_argument("--contain-test", action="store_true", default=False,
                   help="Test after fit (on the final state: no checkpoints yet)")
    p.add_argument("--epoch", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=128, help="GLOBAL batch size")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--weight-decay", type=float, default=0.0001)
    p.add_argument("--lr-decay-step-size", type=int, default=60)
    p.add_argument("--lr-decay-gamma", type=float, default=0.1)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="Split each global batch into N sequential micro-batches, "
                   "average their grads, apply ONE update")
    p.add_argument("--synthetic-data", action="store_true", default=False,
                   help="Train on generated data (no dataset on disk)")
    p.add_argument("--synthetic-noise", type=float, default=0.15,
                   help="Noise sigma around the per-class anchors of --synthetic-data")
    p.add_argument("--limit-examples", type=int, default=0,
                   help="Truncate each split to N examples (0 = full dataset)")
    p.add_argument("--data-mode", type=str, default="device", choices=["device", "host"],
                   help="Both keep the split resident on the device and take the "
                   "host loader's numpy epoch order")
    p.add_argument("--precision", type=str, default=None, choices=["fp32", "bf16"],
                   help="Compute precision; overrides --amp when set")
    p.add_argument("--model", type=str, default="resnet18", choices=list(MODELS),
                   help="Model zoo entry")
    p.add_argument("--bn-dtype", type=str, default="fp32", choices=["fp32", "compute"],
                   help="Dtype of the norms' output. 'fp32' (default) keeps BatchNorm's "
                   "output, and with it the ResNet's residual stream, in fp32 under the "
                   "bf16 policy; 'compute' casts it to the activation dtype. The "
                   "statistics reduce in fp32 either way, as the JAX package's norm "
                   "policy forces")
    p.add_argument("--remat", action="store_true", default=False,
                   help="Rematerialize residual blocks on backward "
                   "(torch.utils.checkpoint): ~1/3 extra FLOPs for a large cut in peak "
                   "activation memory; BatchNorm's running statistics advance once")
    p.add_argument("--stem", type=str, default="cifar", choices=["cifar", "imagenet"],
                   help="Model stem: 'cifar' = 3x3/1 conv, no maxpool (reference "
                   "parity); 'imagenet' = 7x7/2 conv + 3x3/2 maxpool for large images")
    p.add_argument("--image-size", type=int, default=32,
                   help="Image edge length (synthetic data and requests; vit_long: 256)")
    p.add_argument("--patch-size", type=int, default=0,
                   help="ViT patch size override (0 = model default)")
    p.add_argument("--moe-dispatch", type=str, default="auto",
                   choices=["auto", "gmm", "gather", "onehot"],
                   help="MoE token dispatch (vit_moe): 'gmm' = the grouped expert FFN "
                   "over expert-sorted tokens (the CUDA K7-K9 kernels; their plain "
                   "versions on the CPU); 'gather' = sort/scatter/gather with batched "
                   "GEMMs; 'onehot' = GShard dispatch/combine contractions; 'auto' "
                   "(default) = gmm on the card when the experts' weights fit the JAX "
                   "package's budget (bf16 vit_moe), else gather")
    p.add_argument("--block-fusion", type=str, default="auto",
                   choices=["auto", "force", "off"],
                   help="Fused ViT block (the CUDA K5 forward and K6 backward chains): "
                   "'auto' takes it on the card for dense blocks at 128-512 tokens "
                   "within the weight budget, 'force' also on the CPU (plain "
                   "versions), 'off' composes")
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
    if args.limit_examples < 0:
        parser.error(f"--limit-examples must be >= 0, got {args.limit_examples}")
    if args.grad_accum < 1:
        parser.error(f"--grad-accum must be >= 1, got {args.grad_accum}")
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
