"""Entry point (``distributed_training_comparison_tpu/entry.py``).

Without ``--serve``: build the ``Trainer`` (which claims the run dir under
``--ckpt-path``, or resumes by ``--resume`` / ``--auto-resume``), ``fit()``,
then under ``--contain-test`` ``test()`` the run's best checkpoint, and
close the trainer's writers whatever happened.  With ``--serve``: the
serving subsystem, on ``--serve-ckpt`` or the checkpoint it discovers.
There is no supervisor and no preemption handling yet.
"""

from __future__ import annotations

import logging
from typing import Sequence

from .config import load_config


def run(argv: Sequence[str] | None = None) -> dict:
    """Parse flags and run; prints and returns the results (a training
    run's ``fit`` records, and under ``--contain-test`` the test metrics
    and ``test_checkpoint``, the best file they were taken on)."""
    hparams = load_config(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if hparams.serve:
        from .serve import serve_main

        results = serve_main(hparams)
    else:
        from .train import Trainer

        trainer = Trainer(hparams)
        try:
            results = {"fit": trainer.fit()}
            if hparams.contain_test:
                results.update(trainer.test())
                results["test_checkpoint"] = (str(trainer.test_checkpoint)
                                              if trainer.test_checkpoint else None)
        finally:
            trainer.close()
    print(results)
    return results
