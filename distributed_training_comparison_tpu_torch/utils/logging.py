"""Run logging setup (``distributed_training_comparison_tpu/utils/logging.py``).

Parity: the reference's ``src/single/trainer.py:65-69`` configures a logger
that writes ``%(asctime)s > %(message)s`` lines to ``experiment.log``
inside the versioned checkpoint dir.  The trainer logs through
``TRAIN_LOGGER``; the checkpoint modules' loggers are its children, so
their warnings reach the same handlers.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

TRAIN_LOGGER = "distributed_training_comparison_tpu_torch.train"


def setup_logger(
    log_dir: str | Path | None,
    name: str = TRAIN_LOGGER,
    is_main_process: bool = True,
    to_stdout: bool = True,
) -> logging.Logger:
    """The experiment logger ``name``: ``%(asctime)s > %(message)s`` lines
    to standard output and to ``log_dir/experiment.log``; it replaces (and
    closes) the handlers an earlier call gave it, and does not propagate.
    A process that is not the main one gets a silent logger."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    logger.propagate = False
    if not is_main_process:
        logger.addHandler(logging.NullHandler())
        return logger
    fmt = logging.Formatter("%(asctime)s > %(message)s")
    if to_stdout:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_dir / "experiment.log")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
