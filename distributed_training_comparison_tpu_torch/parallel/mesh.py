"""The mesh's axis arithmetic (``distributed_training_comparison_tpu/parallel/mesh.py``).

The JAX mesh has three axes: ``data`` (the reference's DP/DDP world),
``model`` (tensor parallelism) and ``pipe`` (pipeline parallelism).
:func:`mesh_shape_for_backend` and :func:`elastic_mesh_shape` are the JAX
package's arithmetic, unchanged.  In the port the ``data`` axis is the
process group of the ``dp``/``ddp`` backends, one process per card
(``dist.py``); :func:`make_mesh` gives the shape of a run's mesh, and a
``model`` or ``pipe`` axis past 1 raises until tensor and pipeline
parallelism are ported.
"""

from __future__ import annotations

from typing import NamedTuple

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def mesh_shape_for_backend(
    backend: str,
    num_devices: int,
    model_parallel: int = 1,
    pipeline_parallel: int = 1,
) -> tuple[int, int, int]:
    """(data, model, pipe) mesh shape for a named backend variant.

    ``single`` pins a 1×1×1 mesh (reference ``src/single/``); ``dp``/
    ``ddp``/``tpu`` use every available device on the data axis, divided by
    any tensor-parallel × pipeline-parallel degree.
    """
    if backend == "single":
        return (1, 1, 1)
    cells = model_parallel * pipeline_parallel
    if num_devices % cells != 0:
        raise ValueError(
            f"num_devices={num_devices} not divisible by model_parallel="
            f"{model_parallel} x pipeline_parallel={pipeline_parallel}"
        )
    return (num_devices // cells, model_parallel, pipeline_parallel)


def elastic_mesh_shape(
    num_devices: int, model_parallel: int = 1, pipeline_parallel: int = 1
) -> tuple[int, int, int] | None:
    """The ``(data, model, pipe)`` axes for a re-rendered device count, or
    ``None`` when no legal mesh exists at that count: the model and pipe
    axes cannot shrink below their degrees, and the devices must tile them
    evenly."""
    if num_devices < 1 or model_parallel < 1 or pipeline_parallel < 1:
        return None
    cells = model_parallel * pipeline_parallel
    if num_devices < cells or num_devices % cells:
        return None
    return mesh_shape_for_backend("tpu", num_devices, model_parallel, pipeline_parallel)


class Mesh(NamedTuple):
    """A run's mesh shape; ``shape`` by axis name, as a JAX ``Mesh`` has."""

    data: int
    model: int = 1
    pipe: int = 1

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model, PIPE_AXIS: self.pipe}


def make_mesh(
    num_devices: int,
    model_parallel: int = 1,
    pipeline_parallel: int = 1,
    *,
    backend: str = "ddp",
) -> Mesh:
    """The ``(data, model, pipe)`` mesh of ``num_devices`` processes (the
    process group's world, one card each) under ``backend``.  Only the
    data axis may exceed 1."""
    shape = mesh_shape_for_backend(backend, num_devices, model_parallel, pipeline_parallel)
    if shape[1] > 1 or shape[2] > 1:
        raise NotImplementedError(
            f"a ({shape[0]}, {shape[1]}, {shape[2]}) mesh: the model and pipe axes wait for "
            "tensor and pipeline parallelism (ROADMAP queue 1, item 6)"
        )
    return Mesh(*shape)
