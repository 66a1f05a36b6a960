"""Sequence packing with segment IDs.

The TPU-native replacement for the reference's FA2 varlen unpadding
(``modeling_cm3p.py:65-134``, SURVEY.md §5): instead of concatenating the
batch into one ragged tensor with ``cu_seqlens``, short windows are greedily
first-fit packed into fixed-length rows and separated by integer segment
IDs (0 = padding). The flash-attention kernel and the dense mask path both
confine attention within a segment, and RoPE's shift invariance makes
absolute position offsets across segments harmless.

Pooling: packed rows contain several windows, so CLS pooling becomes a
gather of each segment's first token (:func:`segment_cls_pool`).
"""
from __future__ import annotations

import numpy as np


def pack_windows(
    sequences: list[np.ndarray],
    max_length: int,
    pad_id: int,
) -> dict:
    """First-fit pack variable-length token sequences into fixed rows.

    Args:
        sequences: list of 1-D int arrays (unpadded window token ids).
        max_length: packed row length (sequences longer than this are
            truncated to fit).
        pad_id: padding token id.

    Returns:
        dict with ``input_ids`` (R, max_length), ``segment_ids`` (R,
        max_length; 0 = padding, 1..S per row), ``attention_mask``, and
        ``window_to_row`` / ``window_segment`` (W,) locating each input
        window inside the packed batch.
    """
    sequences = [np.asarray(s)[:max_length] for s in sequences]
    order = sorted(range(len(sequences)), key=lambda i: -len(sequences[i]))

    rows: list[list[int]] = []  # window indices per row
    space: list[int] = []
    for idx in order:
        length = len(sequences[idx])
        placed = False
        for r, free in enumerate(space):
            if free >= length:
                rows[r].append(idx)
                space[r] -= length
                placed = True
                break
        if not placed:
            rows.append([idx])
            space.append(max_length - length)

    n_rows = len(rows)
    input_ids = np.full((n_rows, max_length), pad_id, np.int32)
    segment_ids = np.zeros((n_rows, max_length), np.int32)
    window_to_row = np.zeros(len(sequences), np.int32)
    window_segment = np.zeros(len(sequences), np.int32)
    window_offset = np.zeros(len(sequences), np.int32)

    for r, members in enumerate(rows):
        cursor = 0
        for s_idx, w in enumerate(members, start=1):
            seq = sequences[w]
            input_ids[r, cursor : cursor + len(seq)] = seq
            segment_ids[r, cursor : cursor + len(seq)] = s_idx
            window_to_row[w] = r
            window_segment[w] = s_idx
            window_offset[w] = cursor
            cursor += len(seq)

    return {
        "input_ids": input_ids,
        "segment_ids": segment_ids,
        "attention_mask": (segment_ids > 0).astype(np.int32),
        "window_to_row": window_to_row,
        "window_segment": window_segment,
        "window_offset": window_offset,
    }


def segment_cls_pool(hidden, window_to_row, window_offset):
    """Gather each packed window's first-token (CLS) hidden state.

    hidden: (R, L, H); returns (W, H) in the original window order.
    Works on numpy or jax arrays.
    """
    return hidden[window_to_row, window_offset]


def packing_efficiency(sequences: list[np.ndarray], max_length: int) -> tuple[float, float]:
    """(packed_fill_rate, padded_fill_rate): tokens / capacity."""
    total = sum(min(len(s), max_length) for s in sequences)
    packed = pack_windows(sequences, max_length, 0)
    packed_rate = total / (packed["input_ids"].shape[0] * max_length)
    padded_rate = total / (len(sequences) * max_length)
    return packed_rate, padded_rate
