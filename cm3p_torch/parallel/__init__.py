"""Parallel execution of the port over ``torch.distributed`` process groups."""
from .sequence import sequence_sharded_attention

__all__ = ["sequence_sharded_attention"]
