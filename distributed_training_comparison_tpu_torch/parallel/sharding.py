"""Each process's rows of a global batch
(``distributed_training_comparison_tpu/parallel/sharding.py``).

The JAX package lays a global batch of ``B`` rows on the mesh's data axis:
under ``--grad-accum a`` micro-batch ``i`` is rows ``[i·B/a, (i+1)·B/a)``,
each split over the ``n`` devices of the axis, and BatchNorm reduces over
the whole micro-batch.  A process of the port takes the same rows
(:func:`rank_rows`): the global batch reshaped to ``(a, n, B/(a·n))``, its
slice ``[:, rank]``, so that its local micro-batch ``i`` is its part of
the global micro-batch ``i`` and the synced BatchNorm normalizes the same
rows as JAX's.  The parameters are replicated: every process holds the
same values, and the all-reduced gradients keep them so.
"""

from __future__ import annotations

import numpy as np


def check_global_batch(batch_size: int, grad_accum: int, n_data: int) -> None:
    """Raise, with the numbers, unless ``batch_size`` splits into
    ``grad_accum`` micro-batches over ``n_data`` processes."""
    unit = grad_accum * n_data
    if batch_size % unit:
        lower = batch_size // unit * unit
        raise ValueError(
            f"global batch {batch_size} does not split over {n_data} processes x "
            f"{grad_accum} micro-batches ({unit} parts); nearest legal batch sizes: "
            f"{[b for b in (lower, lower + unit) if b > 0]}"
        )


def host_local_batch_slice(global_batch_size: int, process_count: int) -> int:
    """A process's share of the global batch (the reference's
    ``batch_size //= ngpus_per_node``, ``src/ddp/trainer.py:34``)."""
    if global_batch_size % process_count:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by {process_count} processes"
        )
    return global_batch_size // process_count


def rank_rows(batch_size: int, grad_accum: int, world: int, rank: int) -> np.ndarray:
    """The positions in a global batch of ``batch_size`` rows that process
    ``rank`` of ``world`` takes, micro-batch by micro-batch: its
    contiguous part of each of the ``grad_accum`` micro-batches."""
    check_global_batch(batch_size, grad_accum, world)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} out of range for {world} processes")
    rows = np.arange(batch_size).reshape(grad_accum, world, batch_size // (grad_accum * world))
    return rows[:, rank].reshape(-1)
