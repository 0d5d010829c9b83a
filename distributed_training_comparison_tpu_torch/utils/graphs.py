"""CUDA graphs of the step program: a step captured once and replayed.

The counterpart of the JAX package's compiled programs (the scanned epoch
of ``train/step.py::make_epoch_runner``, ``make_eval_runner``, and the
serve buckets' AOT executables in ``serve/engine.py``).  A step body is a
function of no arguments that reads and writes static tensors (allocated
before it is first called) and may return tensors; the runners in
``train/step.py`` and ``serve/engine.py`` build theirs.

:class:`CapturedStep` runs its body eagerly on the CPU.  On a card it runs
the first call eagerly on a side stream (a real call: it does the lazy
work a capture must not, such as kernel builds, ``cudaFuncSetAttribute``
and cuBLAS workspaces), captures the body once with ``torch.cuda.graph``
under ``capture_error_mode="global"`` into the memory pool it is given, and
replays the graph from then on.  A capture that fails raises; nothing falls
back to eager.

The kernel wrappers count their launches on the host (``ops.counted_wrappers``):
a capture calls them though nothing runs, and a replay runs their kernels
without calling them.  :class:`LaunchLedger` keeps the counts true: each
counter's movement over the capture is taken back off, and added again at
every replay.

A capture in global mode forbids every other thread's potentially unsafe
CUDA calls (a blocking synchronize, a pinned host allocation) while it
lasts, and a call that breaks the rule invalidates the capture.
:data:`CAPTURE_LOCK` keeps them apart: :class:`CapturedStep` holds it while
it captures, and a thread that makes CUDA calls beside the step program
(``data/loader.py::StagingRing``'s staging thread, the checkpoint writer's
copy in ``train/state.py``) holds it around them.

A replay runs no Python: module hooks and other Python side effects of
the body happen at the warm-up and capture calls only, and a graph replays
what its capture recorded.  A step holds one graph: to run the body with
a wrapper, a module or a buffer swapped for another (a planted fault, a
plain version), call ``body`` itself, or build a new step.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

import torch

CAPTURE_LOCK = threading.Lock()


class LaunchLedger:
    """The launch counters' accounting across one capture and its replays."""

    def __init__(self, counters: Sequence) -> None:
        self.counters = list(counters)
        self.deltas = [0] * len(self.counters)

    @contextlib.contextmanager
    def capturing(self):
        """While the context lasts the body is captured: what the counters
        move by is recorded as the graph's launches and taken back off."""
        before = [c.launches for c in self.counters]
        try:
            yield
        finally:
            self.deltas = [c.launches - n for c, n in zip(self.counters, before)]
            for c, d in zip(self.counters, self.deltas):
                c.launches -= d

    def replayed(self) -> None:
        """One replay ran the captured launches: count them."""
        for c, d in zip(self.counters, self.deltas):
            c.launches += d


class CapturedStep:
    """``body`` run eagerly on the CPU, or on a card captured as a CUDA
    graph after one eager call and replayed; see the module docstring.
    ``counters()`` gives the counted wrappers at the capture
    (``ops.counted_wrappers``); ``pool`` is the graph memory pool shared by
    one model's graphs (``torch.cuda.graph_pool_handle()``).  A call
    returns what the body returned, a replay the tensors its capture
    returned (overwritten by every replay).  ``ledger`` is the capture's
    :class:`LaunchLedger`, None before it."""

    def __init__(
        self,
        body: Callable[[], object],
        device,
        *,
        counters: Callable[[], Sequence],
        pool=None,
    ) -> None:
        self.body = body
        self.cuda = torch.device(device).type == "cuda"
        self.counters = counters
        self.pool = pool
        self.warm = False  # the warm-up call is done
        self.graph: torch.cuda.CUDAGraph | None = None
        self.ledger: LaunchLedger | None = None
        self._out = None
        self._stream = None

    @property
    def captured(self) -> bool:
        """Whether a graph is held."""
        return self.graph is not None

    def __call__(self):
        if not self.cuda:
            return self.body()
        if self.graph is None:
            if not self.warm:
                return self._warm_up()
            self._capture()
        self.graph.replay()
        self.ledger.replayed()
        return self._out

    def prepare(self) -> bool:
        """Capture now, without replaying, if the warm-up call is done and
        no graph is held yet; returns whether a graph is held."""
        if self.cuda and self.warm and self.graph is None:
            self._capture()
        return self.captured

    def _warm_up(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        main = torch.cuda.current_stream()
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = self.body()
        main.wait_stream(self._stream)
        self.warm = True
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        ledger = LaunchLedger(self.counters())
        with CAPTURE_LOCK, ledger.capturing():
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="global"):
                out = self.body()
        self.graph, self.ledger, self._out = graph, ledger, out
