"""Serving counters and latency percentiles
(``distributed_training_comparison_tpu/serve/metrics.py``).

The counters the batcher records: completions, sheds, expiries and
failures (globally and per SLO class), batch sizes, queue depths and
per-dispatch service time.  Raw samples are reservoir-sampled past
``RESERVOIR_CAP`` (Vitter's algorithm R); counts, means and maxima stay
exact.  The run-event bus, metric registry and TensorBoard wiring of the
JAX package come with the observability slice.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np

# past this many samples per series, switch to reservoir sampling; 8192
# keeps p99 of a uniform sample within ~±1.5% rank error
RESERVOIR_CAP = 8192


def latency_summary_ms(latencies_s) -> dict[str, float]:
    """p50/p95/p99/mean/max of a latency sample, in milliseconds."""
    if not len(latencies_s):
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0, "max": 0.0}
    ms = np.asarray(latencies_s, np.float64) * 1e3
    p50, p95, p99 = np.percentile(ms, [50.0, 95.0, 99.0])
    return {
        "p50": round(float(p50), 3),
        "p95": round(float(p95), 3),
        "p99": round(float(p99), 3),
        "mean": round(float(ms.mean()), 3),
        "max": round(float(ms.max()), 3),
    }


class _Reservoir:
    """Algorithm-R uniform reservoir + exact running count/sum/max.  Not
    thread-safe: callers hold the ``ServeMetrics`` lock.  Seeded, so two runs
    over the same stream keep the same sample."""

    def __init__(self, cap: int = RESERVOIR_CAP, seed: int = 0) -> None:
        self.cap = int(cap)
        self.values: list[float] = []
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._rng = random.Random(seed)

    def add(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.max = max(self.max, value)
        if len(self.values) < self.cap:
            self.values.append(value)
        else:
            j = self._rng.randrange(self.count)
            if j < self.cap:
                self.values[j] = value

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class _ClassStats:
    """Exact per-SLO-class accounting plus the class's latency sample."""

    __slots__ = ("completed", "ok_deadline", "expired", "shed", "failed", "reservoir")

    def __init__(self) -> None:
        self.completed = self.ok_deadline = self.expired = 0
        self.shed = self.failed = 0
        self.reservoir = _Reservoir()

    def payload(self) -> dict:
        terminal = self.completed + self.expired + self.shed + self.failed
        return {
            "completed": self.completed,
            "ok_deadline": self.ok_deadline,
            "expired": self.expired,
            "shed": self.shed,
            "failed": self.failed,
            "attainment": self.ok_deadline / terminal if terminal else None,
            "latency_ms": latency_summary_ms(self.reservoir.values),
        }


class ServeMetrics:
    """Counters + bounded samples for one serving run (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._latencies = _Reservoir()
        self._batch_sizes = _Reservoir()
        self._queue_depths = _Reservoir()
        self._service = _Reservoir()
        self.completed = self.shed = self.expired = 0
        self.failed = self.errors = 0
        self._classes: dict[str, _ClassStats] = {}

    def _cls(self, cls: str | None) -> _ClassStats:
        # under self._lock
        return self._classes.setdefault(cls or "default", _ClassStats())

    def record_request_done(
        self, latency_s: float, cls: str | None = None, within_deadline: bool = True
    ) -> None:
        with self._lock:
            self.completed += 1
            self._latencies.add(latency_s)
            st = self._cls(cls)
            st.completed += 1
            st.ok_deadline += int(within_deadline)
            st.reservoir.add(latency_s)

    def record_batch(self, batch_size: int, queue_depth: int) -> None:
        with self._lock:
            self._batch_sizes.add(int(batch_size))
            self._queue_depths.add(int(queue_depth))

    def record_shed(self, cls: str | None = None) -> None:
        with self._lock:
            self.shed += 1
            self._cls(cls).shed += 1

    def record_expired(self, cls: str | None = None) -> None:
        with self._lock:
            self.expired += 1
            self._cls(cls).expired += 1

    def record_service(self, service_s: float) -> None:
        """One completed dispatch: engine time for one coalesced batch."""
        with self._lock:
            self._service.add(service_s)

    def record_error(self) -> None:
        """One failed batch (engine exception)."""
        with self._lock:
            self.errors += 1

    def record_failed(self, cls: str | None = None) -> None:
        """One failed request: a terminal outcome in its class's denominator."""
        with self._lock:
            self.failed += 1
            self._cls(cls).failed += 1

    def summary(self) -> dict:
        """Everything a serving report needs.  Percentiles are reservoir
        estimates once the sample caps; counts, means and maxima are exact."""
        with self._lock:
            elapsed = max(time.monotonic() - self._t0, 1e-9)
            lat = latency_summary_ms(self._latencies.values)
            lat["mean"] = round(self._latencies.mean * 1e3, 3)
            lat["max"] = round(self._latencies.max * 1e3, 3)
            out = {
                "completed": self.completed,
                "shed": self.shed,
                "expired": self.expired,
                "failed": self.failed,
                "errors": self.errors,
                "duration_s": round(elapsed, 3),
                "throughput_rps": round(self.completed / elapsed, 2),
                "latency_ms": lat,
                "batches": self._batch_sizes.count,
                "mean_batch_size": round(self._batch_sizes.mean, 2),
                "mean_queue_depth": round(self._queue_depths.mean, 2),
                "max_queue_depth": int(self._queue_depths.max),
                "mean_service_ms": round(self._service.mean * 1e3, 3),
            }
            classes = {name: st.payload() for name, st in self._classes.items()}
        if classes and set(classes) != {"default"}:
            out["classes"] = classes
        return out
