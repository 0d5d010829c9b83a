"""Data parallelism (``distributed_training_comparison_tpu/parallel/``):
the process group of the ``dp``/``ddp`` backends (``dist.py``), the mesh's
axis arithmetic (``mesh.py``) and each process's rows of a global batch
(``sharding.py``).  Tensor, sequence and pipeline parallelism, ZeRO and
the planner are not ported yet (ROADMAP queue 1, item 6)."""

from .dist import (
    all_reduce_mean_,
    init_distributed,
    is_main_process,
    local_rank,
    local_world_size,
    process_count,
    process_index,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    Mesh,
    elastic_mesh_shape,
    make_mesh,
    mesh_shape_for_backend,
)
from .sharding import check_global_batch, host_local_batch_slice, rank_rows

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "Mesh", "PIPE_AXIS", "all_reduce_mean_", "check_global_batch",
    "elastic_mesh_shape", "host_local_batch_slice", "init_distributed", "is_main_process",
    "local_rank", "local_world_size", "make_mesh", "mesh_shape_for_backend", "process_count",
    "process_index", "rank_rows",
]
