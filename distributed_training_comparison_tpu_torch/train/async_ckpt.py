"""Write-behind checkpointing (``distributed_training_comparison_tpu/train/async_ckpt.py``).

The reference's ``save_checkpoint`` blocks the epoch loop while it
serializes (``src/single/trainer.py:96-107``).  ``AsyncCheckpointer`` moves
the device-to-host copy, the serialization and the write to one worker
thread, so they overlap the next epoch's compute.

Correctness notes:
- the step program updates the parameters, the running statistics and the
  momentum in place, so the trainer hands this writer a device-side
  snapshot (``train/state.py``'s ``TrainState.snapshot``: a copy on the
  compute stream and an event after it), taken only on epochs that save,
  never the live tensors;
- ``wait()`` drains the queue: before a checkpoint is read back (the test
  phase, the end of ``fit``) and on ``close()``;
- writes for one target are serialized by the single worker, so
  ``last.ckpt`` is always a complete, most-recent snapshot.

The JAX writer's span and metric hooks (``ckpt_write``, ``ckpt/queue_depth``,
``ckpt/write_s``, ``ckpt/jobs``) wait for the event bus (ROADMAP.md queue
1); ``stats()`` is kept, and the trainer logs it to TensorBoard.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable


class AsyncCheckpointer:
    """One background writer thread executing queued checkpoint jobs.

    Jobs submitted under the same ``key`` coalesce: if a newer snapshot for
    that key is queued before the old one started writing, the old one is
    dropped, so only the most recent state of each checkpoint target ever
    reaches the disk."""

    def __init__(self, max_pending: int = 16) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._latest: dict[str, Callable[[], object] | None] = {}
        self._lock = threading.Lock()
        self._errors: list[BaseException] = []
        self._busy_s = 0.0  # wall-clock the worker spent executing jobs
        self._depth = 0     # jobs submitted but not yet finished
        self._born = time.monotonic()
        self._thread = threading.Thread(target=self._worker, name="dtc-ckpt-writer", daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        while True:
            key = self._q.get()
            if key is None:
                self._q.task_done()
                return
            with self._lock:
                job = self._latest.get(key)
                self._latest[key] = None
            t0 = time.monotonic()
            try:
                if job is not None:  # None: superseded, already written
                    job()
            except BaseException as e:  # surfaced on wait()/close()
                with self._lock:
                    self._errors.append(e)
            finally:
                job = None  # the snapshot it holds goes now, not at the next job
                with self._lock:
                    self._busy_s += time.monotonic() - t0
                    self._depth -= 1
                self._q.task_done()

    def stats(self) -> dict:
        """Writer utilization: busy seconds (copy, serialize and write inside
        jobs) over the thread's lifetime, and the jobs submitted and not yet
        finished.  A busy fraction near 1, or a depth that climbs epoch over
        epoch, means write-behind no longer hides the checkpoint cost."""
        alive = max(time.monotonic() - self._born, 1e-9)
        with self._lock:
            busy, depth = self._busy_s, self._depth
        return {
            "busy_s": round(busy, 4),
            "alive_s": round(alive, 4),
            "busy_frac": round(min(busy / alive, 1.0), 4),
            "queue_depth": depth,
        }

    def submit(self, job: Callable[[], object], key: str = "default") -> None:
        """Enqueue a checkpoint job; newer jobs with the same key supersede
        queued-but-unstarted ones."""
        with self._lock:
            self._latest[key] = job
            self._depth += 1
        self._q.put(key)

    def _raise_collected(self) -> None:
        """A background save that failed is never swallowed: raise the first
        collected error (chained), noting how many followed, and clear them."""
        with self._lock:
            err, self._errors = self._errors[:], []
        if err:
            extra = f" (+{len(err) - 1} more)" if len(err) > 1 else ""
            raise RuntimeError(f"async checkpoint write failed: {err[0]!r}{extra}") from err[0]

    def wait(self) -> None:
        """Block until every queued job has finished; re-raise any failure."""
        self._q.join()
        self._raise_collected()

    def close(self) -> None:
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        self._raise_collected()
