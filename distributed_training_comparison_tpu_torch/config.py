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
    "data_mode": "both modes take one epoch order, the JAX host loader's numpy "
    "(seed, epoch) shuffle, and the SeedSequence crop/flip draws of utils/seed.py, so "
    "they train on the same batches; the JAX device mode permutes with threefry "
    "(data/sampler.py:64-68) and draws with split(fold_in(fold_in(data_key, epoch), 1), "
    "steps) (train/step.py:800-803). Kept on purpose: the port's tests hold it step by "
    "step against the JAX package on the same batches and draws, and host mode's "
    "yardstick is the device mode's run, bit for bit. Both modes replay one captured "
    "step a step where JAX compiles a scan over the epoch or the chunk",
    "workers": "host data mode: one host, no per-host sharding until data parallelism "
    "is ported (ROADMAP queue 1, item 5), and no quarantine of corrupt examples until "
    "the health watchdog is (item 7)",
    "device_prefetch": "'auto' needs the planner (ROADMAP queue 1, item 6) and raises "
    "until then; 0 stages each chunk on the training thread",
    "device_chunk_steps": "accepted and has no effect: every replayed step already "
    "returns to the host, which the JAX flag's chunks exist to allow",
    "resume": "reads the port's own checkpoints (torch.save of the JAX contents), "
    "not the JAX package's msgpack files",
    "save_last": "the write-behind writer has no ckpt_write span, no ckpt/jobs, "
    "ckpt/write_s or live ckpt/queue_depth metrics and no writer event until the "
    "event bus is ported; its stats reach TensorBoard once an epoch",
    "ckpt_path": "a run dir holds hparams.yaml, experiment.log, tb/ and the "
    "checkpoints; no event stream, goodput record or flight ring until the event "
    "bus is ported",
}

# host data mode defaults (the JAX package's config.py)
WORKERS_DEFAULT = 4
HOST_CHUNK_STEPS_DEFAULT = 32
DEVICE_PREFETCH_DEFAULT = 2

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
    p.add_argument("--ckpt-path", type=str, default="src/single/checkpoints/",
                   help="Root of the version-{n} run dirs (checkpoints, hparams.yaml, "
                   "experiment.log, tb/)")
    p.add_argument("--seed", type=int, default=42, help="Seed for reproducibility")
    p.add_argument("--workers", type=int, default=WORKERS_DEFAULT,
                   help="host data mode: batches assembled ahead on a background thread "
                   "(the reference DataLoader's num_workers); 0 assembles them on the "
                   "staging thread")
    p.add_argument("--eval-step", type=int, default=300,
                   help="Log the batch loss every N global steps")
    p.add_argument("--amp", action="store_true", default=False,
                   help="bfloat16 compute policy")
    p.add_argument("--contain-test", action="store_true", default=False,
                   help="Test the best checkpoint after fit")
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
    p.add_argument("--resume", type=str, default=None,
                   help="Path to a last.ckpt of the port to resume from (the whole "
                   "train state), in a fresh version dir")
    p.add_argument("--auto-resume", action="store_true", default=False,
                   help="Continue the newest run under --ckpt-path (its version dir "
                   "and its verified last.ckpt, else prev-last.ckpt) if one exists; "
                   "otherwise start fresh.  An explicit --resume wins")
    p.add_argument("--save-last", action=argparse.BooleanOptionalAction, default=True,
                   help="Also save a resumable last.ckpt (on top of the best-only "
                   "policy); --no-save-last for best-only")
    p.add_argument("--log-every-step", action="store_true", default=False,
                   help="Write a TensorBoard loss point for every step (from the "
                   "per-epoch metrics fetch)")
    p.add_argument("--save-last-every", type=int, default=1,
                   help="Write the resumable last.ckpt every N epochs (1 = every epoch)")
    p.add_argument("--save-last-min-secs", type=float, default=20.0,
                   help="Throttle resumable-state saves to at most one per this many "
                   "seconds (the final epoch always saves); 0 disables the throttle")
    p.add_argument("--data-mode", type=str, default="device", choices=["device", "host"],
                   help="'device': the whole train split resident on the device "
                   "(CIFAR-scale). 'host': the train split stays in host memory and "
                   "streams to the device in chunks (datasets that do not fit on the "
                   "device). Both take the same numpy (seed, epoch) batch order")
    p.add_argument("--host-chunk-steps", type=int, default=HOST_CHUNK_STEPS_DEFAULT,
                   help="host data mode: loader steps staged per host-to-device copy "
                   "(the loss trajectory is identical for any value)")
    p.add_argument("--device-chunk-steps", type=int, default=0,
                   help="device data mode: steps per dispatch in the JAX package; "
                   "accepted and has no effect here, where every replayed step returns "
                   "to the host")
    p.add_argument("--device-prefetch", type=str, default=str(DEVICE_PREFETCH_DEFAULT),
                   help="host data mode: staged device chunks in flight ahead of the "
                   "running steps (bounds the extra device memory at N chunk slots; "
                   "the copy hides behind compute). 0 = stage each chunk on the "
                   "training thread before its steps. 'auto' needs the planner and "
                   "raises until it is ported")
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
    p.add_argument("--serve-ckpt", type=str, default=None,
                   help="Checkpoint to serve (a best_model_*.ckpt or last.ckpt of the "
                   "port). Default: the newest version dir's best checkpoint under "
                   "--ckpt-path; if there is none the engine serves fresh weights "
                   "seeded by --seed, with a warning")
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
    if args.save_last_every < 1:
        parser.error(f"--save-last-every must be >= 1, got {args.save_last_every}")
    if args.grad_accum < 1:
        parser.error(f"--grad-accum must be >= 1, got {args.grad_accum}")
    if args.host_chunk_steps < 1:
        parser.error(f"--host-chunk-steps must be >= 1, got {args.host_chunk_steps}")
    if args.device_chunk_steps < 0:
        parser.error(f"--device-chunk-steps must be >= 0, got {args.device_chunk_steps}")
    if args.device_prefetch.strip().lower() == "auto":
        parser.error("--device-prefetch auto derives the depth from the free device memory "
                     "by the planner, which is not ported yet (ROADMAP.md queue 1, item 6)")
    try:
        args.device_prefetch = int(args.device_prefetch)
    except ValueError:
        parser.error(f"--device-prefetch must be an integer >= 0, got {args.device_prefetch!r}")
    if args.device_prefetch < 0:
        parser.error(f"--device-prefetch must be >= 0, got {args.device_prefetch}")
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
