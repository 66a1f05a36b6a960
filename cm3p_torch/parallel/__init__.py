"""Parallel execution of the port over ``torch.distributed`` process groups: data parallelism across ranks
(``distributed.py``, ``mesh.py``) and sequence-parallel attention (``sequence.py``)."""
from .distributed import (
    all_processes_have,
    all_reduce_gradients,
    all_reduce_sum,
    choose_backend,
    data_shard_group,
    gather_rows,
    initialize_distributed,
    is_primary,
    process_count,
    process_index,
)
from .mesh import Mesh, make_mesh
from .sequence import sequence_sharded_attention

__all__ = [
    "Mesh",
    "all_processes_have",
    "all_reduce_gradients",
    "all_reduce_sum",
    "choose_backend",
    "data_shard_group",
    "gather_rows",
    "initialize_distributed",
    "is_primary",
    "make_mesh",
    "process_count",
    "process_index",
    "sequence_sharded_attention",
]
