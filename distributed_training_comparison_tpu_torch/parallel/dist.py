"""The process group of the ``dp``/``ddp`` backends
(``distributed_training_comparison_tpu/parallel/dist.py``).

The reference's DDP bootstrap (``src/ddp/main.py``): one process per card,
``init_process_group(backend, init_method=..., world_size, rank)`` with an
explicit address, world size and rank.  As in the JAX package,
``--world-size``, ``--rank`` and ``--dist-url`` count hosts: a host runs
:func:`local_world_size` processes, so the group's world is hosts × local
processes and a process's rank is ``host rank × local + local rank``.
``--dist-url host:port`` becomes ``tcp://host:port``; a ``tcp://`` or
``file://`` URL is taken as it is.  The fabric is nccl on the card and
gloo on the CPU (``--dist-backend xla``, the JAX default), or the one
named.

:func:`all_reduce_mean_` is the gradients' all-reduce inside the step
program: one collective a flat buffer.
"""

from __future__ import annotations

import gc
from typing import Sequence

import torch
import torch.distributed as dist

_LOCAL = {"rank": 0, "world": 1}


def local_world_size(hparams) -> int:
    """This host's processes: 1 under ``single``; under ``dp``/``ddp`` one
    per card, ``--num-devices`` of them (0 = every visible card; asking for
    more cards than there are raises), or on the CPU ``--num-devices``
    processes (0 = one)."""
    if hparams.backend == "single":
        return 1
    if hparams.device == "cpu":
        return max(1, hparams.num_devices)
    have = torch.cuda.device_count()
    want = hparams.num_devices or have
    if have == 0:
        raise RuntimeError(f"--backend {hparams.backend} asks for the cards, but no CUDA "
                           "device is available; pass --device cpu to run on the CPU")
    if want > have:
        raise ValueError(f"--num-devices {want}: requested {want} cards, have {have}")
    return want


def world_size_of(hparams) -> int:
    """The process group's world a run of ``hparams`` makes."""
    return hparams.world_size * local_world_size(hparams)


def fabric(hparams) -> str:
    """The collective backend: ``--dist-backend``, where ``xla`` is the
    platform's own (nccl on the card, gloo on the CPU)."""
    if hparams.dist_backend != "xla":
        return hparams.dist_backend
    return "gloo" if hparams.device == "cpu" else "nccl"


def init_method(url: str) -> str:
    """``--dist-url`` as ``init_process_group``'s ``init_method``."""
    return url if "://" in url else f"tcp://{url}"


def init_distributed(hparams, local_rank: int = 0):
    """Join this process to the run's group as local process
    ``local_rank`` of its host (on the card, after making
    ``cuda:{local_rank}`` the current device) and return the group."""
    local = local_world_size(hparams)
    if not 0 <= local_rank < local:
        raise ValueError(f"local rank {local_rank} out of range for {local} local processes")
    if hparams.device == "cuda":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        fabric(hparams), init_method=init_method(hparams.dist_url),
        world_size=hparams.world_size * local, rank=hparams.rank * local + local_rank,
    )
    _LOCAL.update(rank=local_rank, world=local)
    return dist.group.WORLD


def destroy() -> None:
    """Leave the group, if this process is in one.  The CUDA graphs that
    captured its collectives are freed first: a step program is only
    reachable through its own cycle (runner, graph, bound body) once its
    trainer is dropped, and the group's NCCL teardown must not meet a live
    graph of its collectives."""
    if dist.is_initialized():
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dist.destroy_process_group()
    _LOCAL.update(rank=0, world=1)


def local_rank() -> int:
    """This process's index among its host's processes."""
    return _LOCAL["rank"]


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """The rank-0 gate (the reference's ``self.rank in [0, -1]`` checks)."""
    return process_index() == 0


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group, divisor: int = 1) -> None:
    """Each tensor replaced by its mean over ``group``'s processes divided
    by ``divisor``, in place, with one collective a tensor.  Over nccl the
    collective averages (``ReduceOp.AVG``: a scaling by 1/world fused into
    the all-reduce, launched as a kernel even at world 1) and ``divisor``
    divides after it; over gloo, which has no average, it sums and one
    pass divides by world × ``divisor``.  For a world that is a power of
    two both round alike.  Every process ends with the same bits."""
    world = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        for t in tensors:
            dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
        scale = divisor
    else:
        for t in tensors:
            dist.all_reduce(t, group=group)
        scale = world * divisor
    if scale > 1:
        for t in tensors:
            t.div_(scale)
