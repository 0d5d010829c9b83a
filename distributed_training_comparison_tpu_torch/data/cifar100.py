"""CIFAR-100 channel statistics and loading from the raw python-pickle
distribution (``distributed_training_comparison_tpu/data/cifar100.py``).

Accepted layouts under ``dpath``: ``cifar-100-python/{train,test}`` (the
extracted official tarball) or the same two files directly under
``dpath``; the tarball ``cifar-100-python.tar.gz`` itself; or a
``cifar100.npz`` with ``x_train, y_train, x_test, y_test``.  Nothing is
downloaded.
"""

from __future__ import annotations

import pickle
import tarfile
from pathlib import Path

import numpy as np

# the reference's train/val normalisation (src/single/dataset.py:41-44)
CIFAR100_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR100_STD = (0.2023, 0.1994, 0.2010)
# the reference's test-time statistics, a train/test mismatch
# (src/single/dataset.py:130-133), kept for --legacy-test-stats
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_SPLIT_FILES = {"train": "train", "test": "test"}


def _from_pickle(path: Path) -> tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        entry = pickle.load(f, encoding="bytes")
    data = entry[b"data"]  # (N, 3072) uint8, CHW-flattened
    labels = entry.get(b"fine_labels", entry.get(b"labels"))
    images = data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)  # NHWC
    return np.ascontiguousarray(images), np.asarray(labels, dtype=np.int32)


def _find_split_file(dpath: Path, split: str) -> Path | None:
    fname = _SPLIT_FILES[split]
    for cand in (dpath / "cifar-100-python" / fname, dpath / fname):
        if cand.is_file():
            return cand
    return None


def load_cifar100(dpath: str | Path, split: str) -> tuple[np.ndarray, np.ndarray]:
    """A CIFAR-100 split as ``(images u8 NHWC, fine_labels i32)``;
    ``split`` is ``"train"`` (50 000) or ``"test"`` (10 000)."""
    if split not in _SPLIT_FILES:
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    dpath = Path(dpath)
    npz = dpath / "cifar100.npz"
    if npz.is_file():
        with np.load(npz) as z:
            return z[f"x_{split}"], z[f"y_{split}"].astype(np.int32)
    f = _find_split_file(dpath, split)
    if f is None:
        tar = dpath / "cifar-100-python.tar.gz"
        if tar.is_file():
            with tarfile.open(tar) as t:
                t.extractall(dpath, filter="data")
            f = _find_split_file(dpath, split)
    if f is None:
        raise FileNotFoundError(
            f"CIFAR-100 not found under {dpath}. Place the extracted "
            "'cifar-100-python/' directory, the official tarball "
            "'cifar-100-python.tar.gz', or a 'cifar100.npz' cache there, or "
            "run with --synthetic-data."
        )
    return _from_pickle(f)
