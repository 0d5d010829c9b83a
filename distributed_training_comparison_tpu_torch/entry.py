"""Entry point (``distributed_training_comparison_tpu/entry.py``).

Without ``--serve``: build the ``Trainer``, ``fit()``, then under
``--contain-test`` ``test()`` the final state.  With ``--serve``: the
serving subsystem.  There is no supervisor and no preemption handling yet.
"""

from __future__ import annotations

import logging
from typing import Sequence

from .config import load_config


def run(argv: Sequence[str] | None = None) -> dict:
    """Parse flags and run; prints and returns the results."""
    hparams = load_config(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    if hparams.serve:
        from .serve import serve_main

        results = serve_main(hparams)
    else:
        from .train import Trainer

        trainer = Trainer(hparams)
        results = {"fit": trainer.fit()}
        if hparams.contain_test:
            results.update(trainer.test())
    print(results)
    return results
