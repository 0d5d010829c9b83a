"""Command-line flags of the port (``distributed_training_comparison_tpu/config.py``).

Every flag of the JAX package, with its name, default and choices, and the
JAX ``load_config(backend, argv)``: ``build_parser(backend)`` takes the
backend's defaults (``--epoch`` 200 under ``single``, 100 under ``dp`` and
``ddp``; ``--ckpt-path src/{backend}/checkpoints/``), and
:func:`load_config` sets ``args.backend``.  The port adds ``--backend``, so
that ``python -m distributed_training_comparison_tpu_torch --backend ddp``
picks the backend the JAX package takes from its entry script, and
``--device``.

A flag either drives the port, or behaves otherwise on purpose
(``WRITTEN_DELTAS``), or drives a module that is not ported yet
(``UNPORTED``, by the ROADMAP item that ports it): such a flag parses at
the JAX default and fails at the command line when it is set to anything
else.
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
    "workers": "host data mode: each process streams its shard of the epoch order "
    "(shard_indices, even) at B / world, as the JAX HostLoader streams one host's; "
    "under --grad-accum a > 1 across processes, micro-batch i is every process's "
    "local micro-batch i, not rows [i·B/a, (i+1)·B/a) of the processes' batches "
    "concatenated (which would move rows between processes). No quarantine of "
    "corrupt examples until the health watchdog is ported (ROADMAP queue 1, item 7)",
    "backend": "new flag: the JAX package takes the backend from its entry script "
    "(src/{single,dp,ddp}/main.py). dp and ddp are one program, as in the JAX package "
    "(one SPMD program over the data axis): one process per card, the flat gradients "
    "all-reduced inside the captured step, BatchNorm synced over the global batch; the "
    "reference's dp is nn.DataParallel in one process. The JAX tpu backend is not "
    "offered: its mesh is dp's",
    "dist_backend": "'xla' (the JAX default) means the platform's own collective "
    "fabric: nccl on the card, gloo on the CPU; nccl and gloo may be named where they "
    "run (nccl on the CPU is an error, and so is gloo on the card, whose captured step "
    "only nccl can join)",
    "world_size": "counts hosts, as in the JAX package; each host runs one process per "
    "card (--num-devices, 0 = every visible card; on the CPU --num-devices "
    "processes), so the process group's world is hosts × local processes, and "
    "--world-size > 1 needs --backend dp or ddp",
    "progress": "accepted; the port draws no progress bar (the epoch records are "
    "logged)",
    "scan_unroll": "accepted and has no effect: the port's ViT trunk is a loop of "
    "blocks, with no lax.scan to unroll",
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

# flags of modules not ported yet: each parses at its JAX default and fails at
# the command line when set to anything else, naming the ROADMAP item
_ITEM_6 = "ROADMAP queue 1, item 6 (the other parallel modules)"
_ITEM_7 = "ROADMAP queue 1, item 7 (health/, obs/, resilience/, ops/policy.py, parity/)"
_ITEM_8 = "ROADMAP queue 1, item 8 (serve/ beyond one replica)"
UNPORTED = {
    **dict.fromkeys((
        "model_parallel", "parallel_style", "pipeline_parallel", "pipeline_microbatches",
        "pipeline_virtual_stages", "pipeline_schedule", "pipeline_resident_layout",
        "shard_optim", "grad_comms", "parallel_plan", "ckpt_comms_residual",
    ), _ITEM_6),
    **dict.fromkeys((
        "profile_dir", "resilience", "supervise", "fleet_hosts", "fleet_min_hosts",
        "fleet_local_devices", "fleet_grace_secs", "fleet_poll_secs", "fleet_probe",
        "max_restarts", "restart_backoff", "fault_plan", "fault_seed", "parity_check",
        "parity_tol", "parity_corrupt", "goodput_json", "health", "health_window",
        "health_spike_mads", "health_bad_steps", "health_max_rollbacks",
        "health_desync_every", "health_quarantine", "health_json", "obs",
        "flight_recorder_size", "flight_ring", "metrics_flush_steps", "heartbeat_secs",
        "metrics_port", "alert", "policy", "policy_mode", "policy_max_actions",
        "control_boundary", "health_phase_baselines",
    ), _ITEM_7),
    **dict.fromkeys((
        "serve_transport", "serve_scale_target", "serve_trace_sample", "serve_port_base",
        "serve_max_replicas", "serve_classes", "serve_warm_buckets", "serve_aot_cache",
        "serve_flash_mult",
    ), _ITEM_8),
}

BACKENDS = ("single", "dp", "ddp")
DIST_BACKENDS = ("xla", "nccl", "gloo")

# host data mode defaults (the JAX package's config.py)
WORKERS_DEFAULT = 4
HOST_CHUNK_STEPS_DEFAULT = 32
DEVICE_PREFETCH_DEFAULT = 2

MODELS = (
    "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "vit_tiny", "vit_small", "vit_long", "vit_moe",
)


def build_parser(backend: str = "single") -> argparse.ArgumentParser:
    """The parser of every flag, with ``backend``'s defaults (``--backend``
    defaults to it)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    p = argparse.ArgumentParser(
        prog="python -m distributed_training_comparison_tpu_torch",
        description="PyTorch/CUDA port: train or serve a zoo model on the card",
    )
    p.add_argument("--backend", type=str, default=backend, choices=list(BACKENDS),
                   help="'single': one process, one card. 'dp' / 'ddp' (one program): "
                   "one process per card, the global batch split over them, the "
                   "gradients all-reduced and BatchNorm synced")
    p.add_argument("--dset", type=str, default="cifar100")
    p.add_argument("--dpath", type=str, default="data/")
    p.add_argument("--ckpt-path", type=str, default=f"src/{backend}/checkpoints/",
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
    # the reference's single variant trains 200 epochs, dp/ddp 100
    p.add_argument("--epoch", type=int, default=200 if backend == "single" else 100)
    p.add_argument("--batch-size", type=int, default=128,
                   help="GLOBAL batch size: split over --grad-accum micro-batches, each "
                   "split over the processes")
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
    # distributed (reference src/ddp/config.py:21-26; hosts, as in the JAX package)
    p.add_argument("--world-size", type=int, default=1, help="Total number of hosts")
    p.add_argument("--rank", type=int, default=0, help="This host's index")
    p.add_argument("--dist-backend", type=str, default="xla",
                   help="Collective backend: 'xla' (default) = the platform's own, "
                   "nccl on the card and gloo on the CPU; or 'nccl', 'gloo'")
    p.add_argument("--dist-url", type=str, default="127.0.0.1:3456",
                   help="Rendezvous address of host 0: host:port (tcp://), or a "
                   "tcp:// or file:// URL")
    p.add_argument("--num-devices", type=int, default=0,
                   help="dp/ddp: processes on this host, one per card (0 = every "
                   "visible card; on the CPU 0 means one)")
    p.add_argument("--legacy-test-stats", action="store_true", default=False,
                   help="Reproduce the reference's test-set normalization quirk "
                   "(ImageNet statistics at test time, src/single/dataset.py:130-133)")
    p.add_argument("--progress", action=argparse.BooleanOptionalAction, default=True,
                   help="Accepted; the port draws no progress bar")
    p.add_argument("--scan-unroll", type=int, default=0,
                   help="Accepted and has no effect (the ViT trunk is a loop of blocks)")
    _add_unported(p)
    return p


def _add_unported(p: argparse.ArgumentParser) -> None:
    """The flags of ``UNPORTED``, at the JAX package's names, types,
    defaults and choices."""
    def later(dest: str) -> str:
        return f"not ported yet ({UNPORTED[dest]}); only the default is accepted"

    bool_opt = argparse.BooleanOptionalAction
    # the other parallel modules
    p.add_argument("--model-parallel", type=int, default=1, help=later("model_parallel"))
    p.add_argument("--parallel-style", type=str, default="tensor",
                   choices=["tensor", "pipeline", "sequence", "sequence-ulysses"],
                   help=later("parallel_style"))
    p.add_argument("--pipeline-parallel", type=int, default=1, help=later("pipeline_parallel"))
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help=later("pipeline_microbatches"))
    p.add_argument("--pipeline-virtual-stages", type=int, default=0,
                   help=later("pipeline_virtual_stages"))
    p.add_argument("--pipeline-schedule", type=str, default="gpipe",
                   choices=["gpipe", "1f1b", "interleaved"], help=later("pipeline_schedule"))
    p.add_argument("--pipeline-resident-layout", action=bool_opt, default=True,
                   help=later("pipeline_resident_layout"))
    p.add_argument("--shard-optim", action=bool_opt, default=False, help=later("shard_optim"))
    p.add_argument("--grad-comms", type=str, default="fp32", choices=["fp32", "fp16", "int8"],
                   help=later("grad_comms"))
    p.add_argument("--parallel-plan", type=str, default="off", choices=["off", "auto", "dump"],
                   help=later("parallel_plan"))
    p.add_argument("--ckpt-comms-residual", action=bool_opt, default=False,
                   help=later("ckpt_comms_residual"))
    # health, observability, resilience, policy, parity
    p.add_argument("--profile-dir", type=str, default=None, help=later("profile_dir"))
    p.add_argument("--resilience", action="store_true", default=False, help=later("resilience"))
    p.add_argument("--supervise", action="store_true", default=False, help=later("supervise"))
    p.add_argument("--fleet-hosts", type=int, default=0, help=later("fleet_hosts"))
    p.add_argument("--fleet-min-hosts", type=int, default=1, help=later("fleet_min_hosts"))
    p.add_argument("--fleet-local-devices", type=int, default=0,
                   help=later("fleet_local_devices"))
    p.add_argument("--fleet-grace-secs", type=float, default=15.0, help=later("fleet_grace_secs"))
    p.add_argument("--fleet-poll-secs", type=float, default=1.0, help=later("fleet_poll_secs"))
    p.add_argument("--fleet-probe", type=str, default="", help=later("fleet_probe"))
    p.add_argument("--max-restarts", type=int, default=3, help=later("max_restarts"))
    p.add_argument("--restart-backoff", type=float, default=1.0, help=later("restart_backoff"))
    p.add_argument("--fault-plan", type=str, default=None, help=later("fault_plan"))
    p.add_argument("--fault-seed", type=int, default=0, help=later("fault_seed"))
    p.add_argument("--parity-check", type=int, default=0, help=later("parity_check"))
    p.add_argument("--parity-tol", type=str, default=f"ulp={1 << 26}", help=later("parity_tol"))
    p.add_argument("--parity-corrupt", type=str, default=None, help=later("parity_corrupt"))
    p.add_argument("--goodput-json", type=str, default=None, help=later("goodput_json"))
    p.add_argument("--health", action=bool_opt, default=True, help=later("health"))
    p.add_argument("--health-window", type=int, default=64, help=later("health_window"))
    p.add_argument("--health-spike-mads", type=float, default=8.0,
                   help=later("health_spike_mads"))
    p.add_argument("--health-bad-steps", type=int, default=3, help=later("health_bad_steps"))
    p.add_argument("--health-max-rollbacks", type=int, default=3,
                   help=later("health_max_rollbacks"))
    p.add_argument("--health-desync-every", type=int, default=1,
                   help=later("health_desync_every"))
    p.add_argument("--health-quarantine", action="store_true", default=False,
                   help=later("health_quarantine"))
    p.add_argument("--health-json", type=str, default=None, help=later("health_json"))
    p.add_argument("--obs", action=bool_opt, default=True, help=later("obs"))
    p.add_argument("--flight-recorder-size", type=int, default=256,
                   help=later("flight_recorder_size"))
    p.add_argument("--flight-ring", action=bool_opt, default=True, help=later("flight_ring"))
    p.add_argument("--metrics-flush-steps", type=int, default=50,
                   help=later("metrics_flush_steps"))
    p.add_argument("--heartbeat-secs", type=float, default=10.0, help=later("heartbeat_secs"))
    p.add_argument("--metrics-port", type=int, default=0, help=later("metrics_port"))
    p.add_argument("--alert", action="append", default=None, help=later("alert"))
    p.add_argument("--policy", action="append", default=None, help=later("policy"))
    p.add_argument("--policy-mode", type=str, default="dry-run",
                   choices=["off", "dry-run", "act"], help=later("policy_mode"))
    p.add_argument("--policy-max-actions", type=int, default=4, help=later("policy_max_actions"))
    p.add_argument("--control-boundary", type=str, default="chunk", choices=["chunk", "epoch"],
                   help=later("control_boundary"))
    p.add_argument("--health-phase-baselines", action=bool_opt, default=True,
                   help=later("health_phase_baselines"))
    # serving beyond one replica
    p.add_argument("--serve-transport", type=str, default="thread", choices=("thread", "process"),
                   help=later("serve_transport"))
    p.add_argument("--serve-scale-target", type=str, default="", help=later("serve_scale_target"))
    p.add_argument("--serve-trace-sample", type=float, default=0.0,
                   help=later("serve_trace_sample"))
    p.add_argument("--serve-port-base", type=int, default=0, help=later("serve_port_base"))
    p.add_argument("--serve-max-replicas", type=int, default=8, help=later("serve_max_replicas"))
    p.add_argument("--serve-classes", type=str, default="", help=later("serve_classes"))
    p.add_argument("--serve-warm-buckets", type=str, default="", help=later("serve_warm_buckets"))
    p.add_argument("--serve-aot-cache", type=str, default="auto", help=later("serve_aot_cache"))
    p.add_argument("--serve-flash-mult", type=float, default=8.0, help=later("serve_flash_mult"))


def _backend_of(argv: Sequence[str] | None, backend: str) -> str:
    """The ``--backend`` that ``argv`` names (``backend`` if none): the
    backend's defaults are the parser's, so it is read first."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--backend", type=str, default=backend, choices=list(BACKENDS))
    known, _ = pre.parse_known_args(argv)
    return known.backend


def load_config(argv: Sequence[str] | None = None, backend: str = "single") -> argparse.Namespace:
    """Parse flags (``argv=None`` reads ``sys.argv``) under ``backend``'s
    defaults, or those of the ``--backend`` that ``argv`` names, and set
    ``args.backend`` as the JAX ``load_config`` does."""
    parser = build_parser(_backend_of(argv, backend))
    args = parser.parse_args(argv)
    for dest, item in UNPORTED.items():
        if getattr(args, dest) != parser.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            parser.error(f"{flag} {getattr(args, dest)!r}: the port accepts only its "
                         f"default, {parser.get_default(dest)!r}, until {item} is ported")
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
    _check_distributed(parser, args)
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
    args.serve_warm_buckets = ()  # UNPORTED: only the default, the empty string, parses
    if args.serve_replicas != 1:
        parser.error(
            f"--serve-replicas {args.serve_replicas}: the port serves one replica "
            "until the router is ported (ROADMAP.md queue 1)"
        )
    return args


def _check_distributed(parser: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The distributed flags: hosts, the process count and the fabric."""
    if args.world_size < 1:
        parser.error(f"--world-size must be >= 1, got {args.world_size}")
    if not 0 <= args.rank < args.world_size:
        parser.error(f"--rank must be in [0, {args.world_size}), got {args.rank}")
    if args.world_size > 1 and args.backend == "single":
        parser.error(f"--world-size {args.world_size} counts hosts of a data-parallel run: "
                     "it needs --backend dp or ddp")
    if args.num_devices < 0:
        parser.error(f"--num-devices must be >= 0, got {args.num_devices}")
    if args.dist_backend not in DIST_BACKENDS:
        parser.error(f"--dist-backend must be one of {list(DIST_BACKENDS)}, got "
                     f"{args.dist_backend!r}")
    if args.dist_backend == "nccl" and args.device == "cpu":
        parser.error("--dist-backend nccl needs the card; --device cpu runs over gloo")
    if args.dist_backend == "gloo" and args.device == "cuda":
        parser.error("--dist-backend gloo on the card: the step program captures its "
                     "all-reduce in a CUDA graph, which only nccl can join")
