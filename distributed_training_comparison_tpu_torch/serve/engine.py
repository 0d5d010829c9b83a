"""The serving engine: bucketed batch inference on one device
(``distributed_training_comparison_tpu/serve/engine.py``).

Serving traffic is ragged; the engine owns a fixed ladder of batch-size
buckets.  A ragged batch rounds up to the nearest bucket with zero rows,
runs, and the padding is sliced back off; a batch above the largest bucket
runs in chunks.  Under ``vit_moe`` the padding rows' tokens are routed and
take expert capacity, as on the TPU, so a request's logits depend on the
bucket it rides in (and on its batch mates); compare them at one padded
batch.  Images travel to the device as uint8 into the bucket's static
input and are normalized there in fp32, then cast to the compute dtype;
logits come back fp32.

On a card each bucket is a CUDA graph, the counterpart of the JAX
engine's AOT-compiled bucket executables (``utils/graphs.py``):
``warmup()`` runs every bucket once, largest first, and captures it, all
buckets in one memory pool; a dispatch copies the padded batch into the
bucket's static input, replays the graph and copies the logits out.  A
bucket not warmed runs eagerly once and is captured at its second
dispatch.  On the CPU every dispatch runs eagerly.  There is no mesh.
Weights are a seeded fresh initialization, a checkpoint of the port
(``checkpoint_path``: a best file or a ``last.ckpt``, read by
``train/checkpoint.py::load_eval_variables`` and carried across by the
``models.*_from_jax`` maps; ``checkpoint_meta`` records its path, epoch
and accuracy), or a ``state_dict`` (for example ``models.vit_from_jax`` or
``models.resnet_from_jax`` of a JAX variable tree).  The model serves in
eval mode: a BatchNorm normalizes with its running statistics.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..data.augment import normalize_images
from ..models import get_model
from ..ops import counted_wrappers
from ..train.checkpoint import load_eval_variables
from ..train.state import model_state_dict
from ..utils.graphs import CapturedStep

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


class ServeEngine:
    """Bucketed inference on ``device`` (``"cuda"`` unless the caller asks
    for ``"cpu"``).  Thread-safe: one lock serializes device work."""

    def __init__(
        self,
        *,
        model: torch.nn.Module | None = None,
        model_name: str = "resnet18",
        model_kw: dict | None = None,
        state_dict: dict | None = None,
        checkpoint_path=None,
        seed: int = 0,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        precision: str = "bf16",
        image_size: int = 32,
        device: str = "cuda",
    ) -> None:
        if not buckets:
            raise ValueError("serve buckets must be non-empty")
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {self.buckets}")
        if precision not in ("bf16", "fp32"):
            raise ValueError(f"precision must be 'bf16' or 'fp32', got {precision!r}")
        self.device = resolve_device(device)
        self.image_size = int(image_size)
        self.compute_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        if model is None:
            kw = dict(model_kw or {})
            kw.setdefault("dtype", self.compute_dtype)
            if model_name.startswith("vit"):
                kw.setdefault("image_size", self.image_size)
            model = get_model(model_name, **kw)
            model.init_weights(torch.Generator().manual_seed(int(seed)))
        self.checkpoint_meta: dict | None = None
        if checkpoint_path is not None:
            if state_dict is not None:
                raise ValueError("pass a checkpoint_path or a state_dict, not both")
            variables, meta = load_eval_variables(checkpoint_path)
            self.checkpoint_meta = {"path": str(checkpoint_path), **meta}
            state_dict = model_state_dict(model, variables)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()
        self.num_classes = model.num_classes
        self._lock = threading.RLock()
        self.bucket_counts: dict[int, int] = {b: 0 for b in self.buckets}
        self._pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        # bucket -> (its static uint8 input, its step program)
        self._programs: dict[int, tuple[torch.Tensor, CapturedStep]] = {}

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` rows (caller chunks above max)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} exceeds the largest bucket {self.max_bucket}; "
            "chunk before dispatch (predict_logits does this for you)"
        )

    @torch.inference_mode()
    def _forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = normalize_images(images_u8, dtype=self.compute_dtype)  # CIFAR-100 stats
        return self.model(x).float()

    def _program(self, bucket: int, shape: tuple) -> tuple[torch.Tensor, CapturedStep]:
        """The bucket's static input and step program, made at first use."""
        if bucket not in self._programs:
            static = torch.zeros((bucket, *shape), dtype=torch.uint8, device=self.device)
            step = CapturedStep(lambda: self._forward(static), self.device,
                                counters=counted_wrappers, pool=self._pool)
            self._programs[bucket] = (static, step)
        return self._programs[bucket]

    def _run_bucket(self, images: np.ndarray) -> np.ndarray:
        """Run one <= max_bucket chunk: pad to its bucket, execute, unpad."""
        n = len(images)
        bucket = self.bucket_for(n)
        if n < bucket:
            pad = np.zeros((bucket - n, *images.shape[1:]), dtype=images.dtype)
            images = np.concatenate([images, pad], axis=0)
        self.bucket_counts[bucket] += 1
        static, step = self._program(bucket, images.shape[1:])
        static.copy_(torch.from_numpy(np.ascontiguousarray(images)))
        return step()[:n].cpu().numpy()

    def warmup(self) -> None:
        """Run every bucket once before traffic, largest first, and capture
        its graph on a card."""
        with self._lock:
            for b in reversed(self.buckets):
                self._run_bucket(
                    np.zeros((b, self.image_size, self.image_size, 3), np.uint8)
                )
                self._programs[b][1].prepare()

    def predict_logits(self, images: np.ndarray) -> np.ndarray:
        """uint8 NHWC batch (any size) → fp32 logits, chunked over buckets."""
        images = np.asarray(images)
        if images.ndim != 4:
            raise ValueError(f"expected NHWC uint8 batch, got {images.shape}")
        with self._lock:
            out = [
                self._run_bucket(images[i : i + self.max_bucket])
                for i in range(0, len(images), self.max_bucket)
            ]
        return np.concatenate(out) if out else np.zeros((0, self.num_classes), np.float32)

    def stats(self) -> dict:
        """Bucket ladder, per-bucket dispatch counts (warmup included) and
        the buckets replayed from a CUDA graph."""
        with self._lock:
            return {
                "buckets": list(self.buckets),
                "bucket_counts": dict(self.bucket_counts),
                "device": str(self.device),
                "dtype": str(self.compute_dtype).removeprefix("torch."),
                "captured_buckets": sorted(b for b, (_, step) in self._programs.items()
                                           if step.captured),
            }
