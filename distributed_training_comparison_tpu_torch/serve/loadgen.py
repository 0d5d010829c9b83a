"""Load generators: closed and open loops
(``distributed_training_comparison_tpu/serve/loadgen.py:57-210``).

- **Closed loop**: ``concurrency`` clients, each submitting its next request
  the moment the previous one completes; measures saturated throughput.
- **Open loop**: Poisson arrivals at ``rate_rps`` regardless of completions,
  paced on the clock from a seeded RNG; the shape that exposes queueing.

Request pools are numpy and byte-identical to the JAX package's for the
same seed and fold.  The diurnal, flash-crowd and mixed-tenant shapes come
with the serve-fleet slice.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np

from .batcher import BatcherClosed, DeadlineExceeded, QueueOverflow
from .metrics import latency_summary_ms


def fold_seed(seed: int, *parts) -> int:
    """Fold distinguishing parts (replica index, leg name, ...) into a base
    seed, stably across runs (hashlib, not ``hash()``)."""
    h = hashlib.blake2s(digest_size=4)
    h.update(str(int(seed)).encode())
    for p in parts:
        h.update(b"\x1f")
        h.update(str(p).encode())
    return int.from_bytes(h.digest(), "big")


def request_pool(n: int, image_size: int = 32, seed: int = 0, fold=()) -> np.ndarray:
    """A pool of synthetic uint8 NHWC request images the generators cycle over."""
    rng = np.random.default_rng(fold_seed(seed, *fold) if fold else seed)
    return rng.integers(0, 256, size=(n, image_size, image_size, 3), dtype=np.uint8)


def _collect(futures, offered: int, t0: float) -> dict:
    """Wait out in-flight futures and aggregate the run's report."""
    latencies, completed, expired, shed_after, failed = [], 0, 0, 0, 0
    for fut in futures:
        try:
            fut.result(timeout=60.0)
            completed += 1
            latencies.append(fut.latency_s)
        except DeadlineExceeded:
            expired += 1
        except QueueOverflow:
            # shed after submit returned: a class-eviction victim
            shed_after += 1
        except Exception:
            # the engine exception a batch failed with, or TimeoutError
            # (still in flight after 60 s): counted failed, the report stays
            failed += 1
    duration = max(time.monotonic() - t0, 1e-9)
    return {
        "offered": offered,
        "completed": completed,
        "shed": offered - len(futures) + shed_after,
        "expired": expired,
        "failed": failed,
        "duration_s": round(duration, 3),
        "throughput_rps": round(completed / duration, 2),
        "latency_ms": latency_summary_ms(latencies),
    }


def closed_loop(
    batcher,
    images: np.ndarray,
    *,
    num_requests: int = 256,
    concurrency: int = 8,
    deadline_ms: float | None = None,
    cls: str | None = None,
) -> dict:
    """``concurrency`` clients, back-to-back requests, ``num_requests`` total."""
    t0 = time.monotonic()
    counter = {"next": 0}
    counter_lock = threading.Lock()
    futures: list = []
    futures_lock = threading.Lock()

    def client() -> None:
        while True:
            with counter_lock:
                i = counter["next"]
                if i >= num_requests:
                    return
                counter["next"] = i + 1
            try:
                fut = batcher.submit(
                    images[i % len(images)], deadline_ms=deadline_ms, cls=cls
                )
            except QueueOverflow:
                continue  # shed; counted by offered - len(futures)
            except BatcherClosed:
                return  # the door is shut: the remainder counts as shed
            with futures_lock:
                futures.append(fut)
            try:
                fut.result(timeout=60.0)
            except Exception:  # tallied in _collect
                pass

    threads = [
        threading.Thread(target=client, daemon=True) for _ in range(max(1, concurrency))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report = _collect(futures, num_requests, t0)
    report["mode"] = "closed"
    report["concurrency"] = concurrency
    return report


def open_loop(
    batcher,
    images: np.ndarray,
    *,
    rate_rps: float,
    num_requests: int = 256,
    deadline_ms: float | None = None,
    seed: int = 0,
    cls: str | None = None,
) -> dict:
    """Poisson arrivals at ``rate_rps``, ``num_requests`` offered in total.
    A shed does not pause the arrival process: that is the open-loop
    property."""
    if rate_rps <= 0:
        raise ValueError(f"open loop needs rate_rps > 0, got {rate_rps}")
    rng = np.random.default_rng(seed)
    t0 = time.monotonic()
    futures: list = []
    next_t = t0
    for i in range(num_requests):
        next_t += float(rng.exponential(1.0 / rate_rps))
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            fut = batcher.submit(images[i % len(images)], deadline_ms=deadline_ms, cls=cls)
        except QueueOverflow:
            continue  # shed; the arrival clock keeps running
        except BatcherClosed:
            break
        futures.append(fut)
    report = _collect(futures, num_requests, t0)
    report["mode"] = "open"
    report["offered_rps"] = round(rate_rps, 2)
    return report
