"""Entry point (``distributed_training_comparison_tpu/entry.py:57-63``).

``--serve`` runs the serving subsystem.  Training is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Sequence

from .config import load_config


def run(argv: Sequence[str] | None = None) -> dict:
    """Parse flags and run; prints and returns the report."""
    hparams = load_config(argv)
    if not hparams.serve:
        raise NotImplementedError(
            "training is not ported to PyTorch yet (ROADMAP.md queue 1); "
            "pass --serve"
        )
    from .serve import serve_main

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    results = serve_main(hparams)
    print(results)
    return results
