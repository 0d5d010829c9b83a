"""Request queue + micro-batcher: coalescing, SLO classes, deadlines, load
shedding, and continuous batching.

An adapted copy of ``distributed_training_comparison_tpu/serve/batcher.py``
(pure Python there too): the same typed errors, SLO classes, priority queue
with class-aware shedding and take-time deadline expiry, and the two
admission policies:

- **bucketed**: dispatch when ``max_batch_size`` requests have gathered or
  the oldest queued request has waited ``max_wait_ms``;
- **continuous**: the moment the worker frees it takes whatever has
  coalesced, so the previous dispatch is the coalescing window.

Request tracing, the router's requeue/fail-all paths and its replica-death
error come with the slices that port them.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from .metrics import ServeMetrics

DEFAULT_CLASS = "default"


class ServeError(Exception):
    """Base class for typed serving errors."""


class QueueOverflow(ServeError):
    """Load shed: queue depth exceeded the configured bound at submit."""


class DeadlineExceeded(ServeError):
    """The request's deadline lapsed before it reached the device."""


class BatcherClosed(ServeError):
    """Submit after close(), or the batcher closed with this request queued."""


class SLOClassError(ValueError):
    """Malformed SLO class spec, or an unknown class name."""


class SLOClass:
    """One tenant class: shed priority (lower is more important), default
    deadline, and the attainment target."""

    __slots__ = ("name", "priority", "deadline_ms", "target")

    def __init__(
        self, name: str, priority: int = 1,
        deadline_ms: float | None = None, target: float = 0.0,
    ) -> None:
        self.name = str(name)
        self.priority = int(priority)
        self.deadline_ms = None if deadline_ms is None else float(deadline_ms)
        self.target = float(target)
        if not self.name:
            raise SLOClassError("SLO class name must be non-empty")
        if not 0.0 <= self.target <= 1.0:
            raise SLOClassError(
                f"SLO class {name!r}: target must be in [0, 1], got {target}"
            )
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise SLOClassError(
                f"SLO class {name!r}: deadline_ms must be > 0, got {deadline_ms}"
            )


def default_classes() -> dict[str, SLOClass]:
    """The single-tenant case: one ``default`` class."""
    return {DEFAULT_CLASS: SLOClass(DEFAULT_CLASS, priority=1)}


def parse_slo_classes(spec: str | None) -> dict[str, SLOClass]:
    """Compile a class spec into the class table.

    Grammar (comma-separated classes, colon-separated fields)::

        gold:priority=0:deadline_ms=250:target=0.99,batch:priority=2

    An empty spec yields the single ``default`` class; a spec without
    ``default`` gets one appended (priority 1) so class-less submits work.
    """
    if not spec or not str(spec).strip():
        return default_classes()
    out: dict[str, SLOClass] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        name = fields[0].strip()
        kw: dict = {}
        for pair in fields[1:]:
            key, sep, val = pair.partition("=")
            key, val = key.strip(), val.strip()
            if not sep or key not in ("priority", "deadline_ms", "target"):
                raise SLOClassError(
                    f"SLO class {part!r}: unknown field {key!r} "
                    "(known: priority, deadline_ms, target)"
                )
            try:
                kw[key] = int(val) if key == "priority" else float(val)
            except ValueError:
                raise SLOClassError(
                    f"SLO class {part!r}: {key} {val!r} is not a number"
                ) from None
        if name in out:
            raise SLOClassError(f"duplicate SLO class {name!r}")
        out[name] = SLOClass(name, **kw)
    if DEFAULT_CLASS not in out:
        out[DEFAULT_CLASS] = SLOClass(DEFAULT_CLASS, priority=1)
    return out


class ServeFuture:
    """Completion handle for one request (result row or typed error).
    Resolution is atomic and first-wins."""

    __slots__ = (
        "_event", "_value", "_error", "_resolve_lock", "submit_t", "done_t",
        "deadline_t", "cls",
    )

    def __init__(
        self, submit_t: float, deadline_t: float | None, cls: str = DEFAULT_CLASS
    ) -> None:
        self._event = threading.Event()
        self._resolve_lock = threading.Lock()
        self._value = None
        self._error: BaseException | None = None
        self.submit_t = submit_t
        self.done_t: float | None = None
        self.deadline_t = deadline_t
        self.cls = cls

    def _resolve(self, value, error) -> bool:
        with self._resolve_lock:
            if self._event.is_set():
                return False
            self._value, self._error = value, error
            self.done_t = time.monotonic()
            self._event.set()
            return True

    def set_result(self, value) -> bool:
        return self._resolve(value, None)

    def set_error(self, err: BaseException) -> bool:
        return self._resolve(None, err)

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("request still in flight")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_s(self) -> float | None:
        return None if self.done_t is None else self.done_t - self.submit_t

    @property
    def within_deadline(self) -> bool:
        """Completed inside its deadline (True for deadline-less requests)."""
        if self.done_t is None:
            return False
        return self.deadline_t is None or self.done_t <= self.deadline_t


class ClassQueue:
    """The priority-ordered, deadline-aware request queue.

    ``submit`` never blocks (full = typed shed decision); ``take`` blocks
    for the first live request, then applies the admission policy.  Expired
    requests fail at take time, before they take a bucket slot.
    """

    def __init__(
        self,
        *,
        classes: dict[str, SLOClass] | None = None,
        limit: int = 256,
        metrics: ServeMetrics | None = None,
    ) -> None:
        self.classes = dict(classes) if classes else default_classes()
        self.limit = int(limit)
        if self.limit < 1:
            raise ValueError("queue limit must be >= 1")
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self._cond = threading.Condition()
        # one FIFO per priority level; take() walks priorities ascending
        # (most important first), eviction walks descending
        self._lanes: dict[int, deque] = {}
        self._n = 0
        self._closed = False

    def resolve_class(self, cls: str | None) -> SLOClass:
        slo = self.classes.get(cls if cls is not None else DEFAULT_CLASS)
        if slo is None:
            raise SLOClassError(
                f"unknown SLO class {cls!r} (declared: {sorted(self.classes)})"
            )
        return slo

    def submit(
        self, image: np.ndarray, deadline_ms: float | None = None,
        cls: str | None = None,
    ) -> ServeFuture:
        """Enqueue one request.  Raises ``QueueOverflow`` when the queue is
        at its bound and nothing queued is less important (otherwise the
        newest least-important entry is shed in its place), and
        ``BatcherClosed`` after ``close()``."""
        slo = self.resolve_class(cls)
        now = time.monotonic()
        deadline = deadline_ms if deadline_ms else slo.deadline_ms
        deadline_t = now + deadline / 1e3 if deadline else None
        victim = None
        with self._cond:
            if self._closed:
                raise BatcherClosed("submit after close()")
            if self._n >= self.limit:
                victim = self._evict_below(slo.priority)
                if victim is None:
                    self.metrics.record_shed(slo.name)
                    raise QueueOverflow(
                        f"queue depth {self._n} at the configured limit "
                        f"{self.limit}; {slo.name!r} request shed (nothing "
                        "queued is lower-priority)"
                    )
            fut = ServeFuture(now, deadline_t, cls=slo.name)
            self._lanes.setdefault(slo.priority, deque()).append(
                (np.asarray(image), fut)
            )
            self._n += 1
            self._cond.notify()
        if victim is not None:
            # resolved outside the lock: the victim's waiter may react
            _, vfut = victim
            self.metrics.record_shed(vfut.cls)
            vfut.set_error(
                QueueOverflow(
                    f"{vfut.cls!r} request shed: queue full and a "
                    f"higher-priority {slo.name!r} request arrived"
                )
            )
        return fut

    def _evict_below(self, priority: int):
        """Pop the newest entry of the least important lane with priority
        strictly above ``priority`` (= less important), or None."""
        for p in sorted(self._lanes, reverse=True):
            if p <= priority:
                break
            lane = self._lanes[p]
            if lane:
                self._n -= 1
                return lane.pop()  # newest: it has waited the least
        return None

    def _oldest_submit_t(self) -> float | None:
        heads = [lane[0][1].submit_t for lane in self._lanes.values() if lane]
        return min(heads) if heads else None

    def _expire(self, fut: ServeFuture, now: float, where: str) -> None:
        self.metrics.record_expired(fut.cls)
        fut.set_error(
            DeadlineExceeded(
                f"deadline lapsed {(now - fut.deadline_t) * 1e3:.1f} ms {where}"
            )
        )

    def _pop_live(self, batch: list, max_n: int) -> None:
        """Move up to ``max_n - len(batch)`` live entries into ``batch`` in
        priority order, failing the expired ones on the way."""
        now = time.monotonic()
        for p in sorted(self._lanes):
            lane = self._lanes[p]
            while lane and len(batch) < max_n:
                image, fut = lane.popleft()
                self._n -= 1
                if fut.deadline_t is not None and now > fut.deadline_t:
                    self._expire(fut, now, "before dispatch")
                    continue
                batch.append((image, fut))
            if len(batch) >= max_n:
                break

    def take(
        self,
        max_n: int,
        *,
        window_s: float = 0.0,
        continuous: bool = True,
    ) -> list | None:
        """Coalesce the next batch (list of ``(image, future)``).

        ``continuous=True`` returns as soon as one live request is queued,
        with everything queued up to ``max_n``; ``continuous=False`` then
        waits until ``max_n`` have gathered or the oldest has waited
        ``window_s``.  Returns ``[]`` when every request taken had expired,
        ``None`` when the queue is closed and drained.
        """
        batch: list = []
        with self._cond:
            while True:
                self._pop_live(batch, max_n)
                if batch or self._closed:
                    break
                self._cond.wait(0.1)
            if not batch and self._closed and not self._n:
                return None  # closed and drained
            if not continuous:
                # the window is anchored at the oldest request's submit time
                anchor = min(
                    [f.submit_t for _, f in batch]
                    + [t for t in (self._oldest_submit_t(),) if t is not None]
                )
                window_end = anchor + window_s
                while len(batch) < max_n and not self._closed:
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    self._pop_live(batch, max_n)
                # a deadline can lapse during the window just waited out
                now = time.monotonic()
                live = []
                for image, fut in batch:
                    if fut.deadline_t is not None and now > fut.deadline_t:
                        self._expire(fut, now, "inside the coalescing window")
                    else:
                        live.append((image, fut))
                batch = live
            depth_after = self._n
        if batch:
            self.metrics.record_batch(len(batch), depth_after)
        return batch

    def close(self, drain: bool = True) -> None:
        with self._cond:
            self._closed = True
            if not drain:
                for lane in self._lanes.values():
                    while lane:
                        _, fut = lane.popleft()
                        self._n -= 1
                        fut.set_error(BatcherClosed("batcher closed undrained"))
            self._cond.notify_all()


class MicroBatcher:
    """Coalesce submitted requests into engine batches (one worker thread).

    ``engine`` needs ``predict_logits(images) -> logits`` and ``max_bucket``.
    ``mode`` is ``"bucketed"`` or ``"continuous"``.
    """

    def __init__(
        self,
        engine,
        *,
        max_batch_size: int | None = None,
        max_wait_ms: float = 2.0,
        queue_limit: int = 256,
        metrics: ServeMetrics | None = None,
        classes: dict[str, SLOClass] | None = None,
        mode: str = "bucketed",
    ) -> None:
        if mode not in ("bucketed", "continuous"):
            raise ValueError(f"mode must be 'bucketed' or 'continuous', got {mode!r}")
        self.engine = engine
        self.mode = mode
        self.max_batch_size = int(max_batch_size or engine.max_bucket)
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.queue = ClassQueue(classes=classes, limit=queue_limit, metrics=self.metrics)
        self._worker = threading.Thread(target=self._loop, name="serve-batcher", daemon=True)
        self._worker.start()

    def submit(
        self, image: np.ndarray, deadline_ms: float | None = None,
        cls: str | None = None,
    ) -> ServeFuture:
        """Enqueue one request (see :meth:`ClassQueue.submit`)."""
        return self.queue.submit(image, deadline_ms=deadline_ms, cls=cls)

    def _loop(self) -> None:
        while True:
            batch = self.queue.take(
                self.max_batch_size,
                window_s=self.max_wait_s,
                continuous=self.mode == "continuous",
            )
            if batch is None:
                return
            if batch:
                dispatch_batch(self.engine, batch, self.metrics)

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting work; by default let queued requests finish."""
        self.queue.close(drain=drain)
        self._worker.join(timeout)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def dispatch_batch(engine, batch: list, metrics: ServeMetrics) -> list:
    """Run one coalesced batch through ``engine`` and resolve its futures.
    An engine exception fails the batch (typed, counted) and the caller
    keeps serving.  Returns the futures that completed."""
    t0 = time.monotonic()
    try:
        logits = engine.predict_logits(np.stack([img for img, _ in batch]))
    except Exception as e:  # engine failure → fail the batch, keep serving
        metrics.record_error()
        for _, fut in batch:
            if fut.set_error(e):
                metrics.record_failed(fut.cls)
        return []
    metrics.record_service(time.monotonic() - t0)
    completed = []
    for (_, fut), row in zip(batch, logits):
        if fut.set_result(row):
            metrics.record_request_done(
                fut.latency_s, cls=fut.cls, within_deadline=fut.within_deadline
            )
            completed.append(fut)
    return completed
