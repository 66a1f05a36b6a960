"""ctypes layer of the native audio front end (``audio_fast.cpp``).

One library call decodes a WAVE buffer, downmixes it to mono and polyphase-resamples
it, bit-identical to ``cm3p_torch/audio/loading.py`` (``_load_wav_bytes`` +
``to_mono`` + ``resample``), which stays the source of truth and the fallback. The
resample plan (fraction capping, FIR design, expected output length) lives in
``loading.py``; this module only marshals it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import library

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)

SIGNATURES = {  # entry point -> (argtypes, restype)
    "ct_wav_probe": ([_u8p, ctypes.c_int64, _i64p], ctypes.c_int32),
    "ct_wav_decode_resample": (
        [_u8p, ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _f32p, ctypes.c_int64],
        ctypes.c_int32,
    ),
}


def probe(buf: bytes) -> Optional[tuple[int, int, int]]:
    """WAVE header probe -> (rate, frames, channels), or None if the buffer is not a WAVE the
    native decoder supports (the caller takes the Python path)."""
    raw = np.frombuffer(buf, np.uint8)
    info = np.zeros(3, np.int64)
    if library().ct_wav_probe(raw.ctypes.data_as(_u8p), len(raw), info.ctypes.data_as(_i64p)) != 0:
        return None
    return int(info[0]), int(info[1]), int(info[2])


def decode(buf: bytes, up: int, down: int, h_scaled: Optional[np.ndarray], expected: int) -> Optional[np.ndarray]:
    """Decode + downmix + resample to ``expected`` float32 samples, or None if declined.

    ``h_scaled``: the ``resample_poly`` FIR already multiplied by ``up`` (float32);
    None with ``up == down == 1`` for a pure decode.
    """
    raw = np.frombuffer(buf, np.uint8)
    out = np.empty(expected, np.float32)
    if h_scaled is None:
        hp, hl = None, 0
    else:
        h_scaled = np.ascontiguousarray(h_scaled, np.float32)
        hp, hl = h_scaled.ctypes.data_as(_f32p), len(h_scaled)
    rc = library().ct_wav_decode_resample(
        raw.ctypes.data_as(_u8p), len(raw), hp, hl, up, down, out.ctypes.data_as(_f32p), expected
    )
    return None if rc != 0 else out
