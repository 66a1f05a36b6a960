"""Batch assembly for training: the packing collator."""
from .packing_collator import packed_batches

__all__ = ["packed_batches"]
