"""Packing collator: variable-length samples → fixed packed training batches.

Takes the per-window samples the datasets yield (padded ids + attention
mask + per-window metadata) and emits fixed-shape packed batches for
``CM3PModel.forward_packed``: rows of ``seq_len`` tokens with segment IDs,
a padded window table (``window_valid`` marks real windows), aligned
metadata tensors, and packed MLM labels when present.

Shapes are fully static per (rows, max_windows) configuration, so one
compiled step serves every batch. The port's own copy of the JAX package's
``data/packing_collator.py``.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..processing.packing import pack_windows


def packed_batches(
    samples: Iterator[dict],
    rows: int,
    seq_len: int,
    pad_id: int,
    max_windows: Optional[int] = None,
    drop_last: bool = True,
) -> Iterator[dict]:
    """Greedily fill ``rows`` packed rows per batch, then emit.

    Admission is the EXACT first-fit-decreasing simulation ``pack_windows``
    will run, not a token-capacity heuristic: the old ``sum(lengths) <=
    rows*seq_len`` check admitted sets that FFD could not place in ``rows``
    rows, and the emit-time recovery split produced tiny fragment batches
    (down to a single real window — which is a degenerate contrastive batch;
    see l2_normalize's NaN note in models/cm3p.py for what that used to do).
    """
    max_windows = max_windows or rows * 8
    pending: list[dict] = []
    pending_lengths: list[int] = []

    def emit(batch_samples: list[dict]):
        """Yield one or more fixed-shape batches (splits on fragmentation)."""
        seqs = []
        label_seqs = []
        for s in batch_samples:
            length = int(np.asarray(s["attention_mask"]).sum())
            seqs.append(np.asarray(s["input_ids"])[:length])
            if "labels" in s and np.asarray(s["labels"]).ndim == 1:
                label_seqs.append(np.asarray(s["labels"])[:length])
        packed = pack_windows(seqs, seq_len, pad_id)
        n_rows = packed["input_ids"].shape[0]
        if n_rows > rows and len(batch_samples) > 1:
            # first-fit fragmentation overflowed the fixed row budget: split
            mid = len(batch_samples) // 2
            yield from emit(batch_samples[:mid])
            yield from emit(batch_samples[mid:])
            return
        w = len(seqs)

        input_ids = np.full((rows, seq_len), pad_id, np.int32)
        segment_ids = np.zeros((rows, seq_len), np.int32)
        input_ids[:n_rows] = packed["input_ids"]
        segment_ids[:n_rows] = packed["segment_ids"]

        window_rows = np.zeros(max_windows, np.int32)
        window_segments = np.full(max_windows, -1, np.int32)
        window_valid = np.zeros(max_windows, np.int32)
        window_rows[:w] = packed["window_to_row"]
        window_segments[:w] = packed["window_segment"]
        window_valid[:w] = 1

        batch = {
            "input_ids": input_ids,
            "segment_ids": segment_ids,
            "window_rows": window_rows,
            "window_segments": window_segments,
            "window_valid": window_valid,
        }

        if label_seqs:
            labels = np.full((rows, seq_len), -100, np.int32)
            for wi, lab in enumerate(label_seqs):
                r = packed["window_to_row"][wi]
                off = packed["window_offset"][wi]
                labels[r, off : off + len(lab)] = lab
            batch["labels"] = labels

        if "input_features" in batch_samples[0]:
            f0 = np.asarray(batch_samples[0]["input_features"])
            features = np.zeros((max_windows,) + f0.shape, np.float32)
            for wi, s in enumerate(batch_samples):
                features[wi] = s["input_features"]
            batch["input_features"] = features

        if "metadata_ids" in batch_samples[0]:
            m0 = np.asarray(batch_samples[0]["metadata_ids"])
            meta_shape = (max_windows,) + m0.shape
            metadata_ids = np.zeros(meta_shape, np.int32)
            metadata_mask = np.zeros(meta_shape, np.int32)
            for wi, s in enumerate(batch_samples):
                metadata_ids[wi] = s["metadata_ids"]
                metadata_mask[wi] = s["metadata_attention_mask"]
            batch["metadata_ids"] = metadata_ids
            batch["metadata_attention_mask"] = metadata_mask
            if "metadata_variation_classes" in batch_samples[0]:
                v = np.asarray(batch_samples[0]["metadata_variation_classes"]).shape[0]
                classes = np.full((max_windows, v), -1, np.int32)
                for wi, s in enumerate(batch_samples):
                    classes[wi] = s["metadata_variation_classes"]
                # dummy windows keep class -1 everywhere; give them a class-0
                # slot so argmax is well-defined (row is masked from the loss)
                classes[len(batch_samples):, 0] = 0
                batch["metadata_variation_classes"] = classes
        yield batch

    def ffd_rows(lengths: list[int]) -> int:
        """Rows first-fit-decreasing needs for ``lengths`` (mirrors
        pack_windows' placement exactly)."""
        space: list[int] = []
        for ln in sorted(lengths, reverse=True):
            for i, free in enumerate(space):
                if free >= ln:
                    space[i] -= ln
                    break
            else:
                space.append(seq_len - ln)
        return len(space)

    for sample in samples:
        length = int(np.asarray(sample["attention_mask"]).sum())
        length = min(length, seq_len)
        would_overflow = (
            len(pending) + 1 > max_windows
            or ffd_rows(pending_lengths + [length]) > rows
        )
        if would_overflow and pending:
            yield from emit(pending)
            pending, pending_lengths = [], []
        pending.append(sample)
        pending_lengths.append(length)

    if pending and not drop_last:
        yield from emit(pending)
