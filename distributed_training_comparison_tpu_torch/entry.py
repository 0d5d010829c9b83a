"""Entry point (``distributed_training_comparison_tpu/entry.py``).

Without ``--serve``: build the ``Trainer`` (which claims the run dir under
``--ckpt-path``, or resumes by ``--resume`` / ``--auto-resume``), ``fit()``,
then under ``--contain-test`` ``test()`` the run's best checkpoint, and
close the trainer's writers whatever happened.  With ``--serve``: the
serving subsystem, on ``--serve-ckpt`` or the checkpoint it discovers; it
serves from one engine whatever the backend (several replicas wait for
ROADMAP queue 1, items 6 and 8).

``--backend dp`` / ``ddp`` (the reference's ``src/{dp,ddp}/run_*.sh``)
trains with one process per local card (``parallel/dist.py``): a host of
one process runs it here, joined to the group in this process; more are
started with ``torch.multiprocessing.start_processes`` (``spawn``), and
the first one's results are returned.  A process that fails ends the
others, and its error is raised here.  The global batch (and ``vit_moe``,
which needs the global routing of ROADMAP queue 1, item 6) is checked
against the processes before any of them starts.  There is no supervisor and no
preemption handling yet.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Sequence

import torch

from .config import load_config
from .parallel import dist as pdist

LOG_FORMAT = "%(asctime)s %(message)s"


def _train(hparams) -> dict:
    """One process's training run: fit, and under ``--contain-test`` test."""
    from .train import Trainer

    trainer = Trainer(hparams)
    try:
        results = {"fit": trainer.fit()}
        if hparams.contain_test:
            results.update(trainer.test())
            results["test_checkpoint"] = (str(trainer.test_checkpoint)
                                          if trainer.test_checkpoint else None)
            results["test_examples"] = trainer.eval_counts["test"]
    finally:
        trainer.close()
    return results


def _process(local_rank: int, hparams, results, local: int) -> None:
    """A spawned process: local process ``local_rank`` of ``local``; the
    first puts its results on ``results``.  On the CPU the host's cores
    are shared out, unless ``OMP_NUM_THREADS`` sets the threads."""
    if hparams.device == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
    pdist.init_distributed(hparams, local_rank)
    out = _train(hparams)
    if local_rank == 0:
        results.put(out)
    pdist.destroy()  # after a success only: see run()


def _spawn(hparams, local: int, join_timeout: float | None) -> dict:
    """Run ``local`` processes and return the first one's results; past
    ``join_timeout`` seconds every process is killed and this raises."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_process, args=(hparams, results, local), nprocs=local,
                             join=False, start_method="spawn")
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    out = None
    while not ctx.join(timeout=1.0):
        if out is None and not results.empty():
            out = results.get()
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{local} training processes still running after "
                               f"{join_timeout} s: killed")
    if out is None:
        out = results.get()
    return out


def run(argv: Sequence[str] | None = None, *, join_timeout: float | None = None) -> dict:
    """Parse flags and run; prints and returns the results (a training
    run's ``fit`` records, and under ``--contain-test`` the test metrics,
    ``test_checkpoint``, the best file they were taken on, and
    ``test_examples``, the examples they counted).
    ``join_timeout`` bounds the wait for spawned processes (none by
    default)."""
    hparams = load_config(argv)
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
    if hparams.serve:
        from .serve import serve_main

        results = serve_main(hparams)
    elif hparams.backend == "single":
        results = _train(hparams)
    else:
        from .train.trainer import check_world

        local = pdist.local_world_size(hparams)
        check_world(hparams, hparams.world_size * local)
        if local > 1:
            results = _spawn(hparams, local, join_timeout)
        else:
            pdist.init_distributed(hparams, 0)
            results = _train(hparams)
            # Left after a success only.  An error's traceback keeps the
            # trainer, and with it the CUDA graphs of the group's NCCL
            # collectives, alive; NCCL's teardown of the group then waits
            # for them (seen on four cards), so a failed process exits
            # with the group as it is.
            pdist.destroy()
    if hparams.rank == 0:
        print(results)
    return results
