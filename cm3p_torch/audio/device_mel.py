"""Whisper log-mel on the GPU from raw PCM: the extraction tool's ``--mel-wire pcm``.

A Hann-windowed 400-point real DFT of hop-160 frames is a product of the frames
(a strided view of the padded PCM) with the windowed DFT basis, 402 columns of
cos / sin pairs; the mel filterbank, the log and the Whisper clamp are a matmul
and elementwise work. :class:`DeviceLogMel` computes the same compact form the host extractor emits
(dense frames plus the constant value of the zero tail, ``audio/mel.py``
``logmel_parts``) from PCM windows shipped to the device, so the tool rebuilds
the full mel from it exactly as from the compact bf16 wire.

The products run in full fp32 whatever the global TF32 settings say: TF32 would
move the mel by about 1e-3.
"""
from __future__ import annotations

import contextlib
import math
from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from .mel import mel_filter_bank


@contextlib.contextmanager
def _full_fp32():
    """cuBLAS's fp32 products in IEEE fp32 (no TF32) inside, and the setting as it was after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class DeviceLogMel:
    """PCM (W, f_cap * hop_length) -> (dense (W, n_mels, f_cap), tail (W,)) in fp32 on ``device``.

    The extraction tool ships each window zero-padded to ``f_cap * hop_length``
    samples, ``f_cap`` being the processor's ``_compact_frames`` for the window,
    so the dense / tail split matches the host's compact wire exactly.
    """

    def __init__(
        self,
        feature_size: int = 80,
        sampling_rate: int = 16000,
        hop_length: int = 160,
        n_fft: int = 400,
        device: Union[str, torch.device] = "cuda",
    ):
        self.feature_size = feature_size
        self.sampling_rate = sampling_rate
        self.hop_length = hop_length
        self.n_fft = n_fft
        # the windowed DFT basis: column k < bins is the cos (real) component, k >= bins the
        # sin (imaginary); power needs only re^2 + im^2, so signs do not matter
        bins = 1 + n_fft // 2
        window = np.hanning(n_fft + 1)[:-1].astype(np.float64)  # periodic Hann
        t = np.arange(n_fft, dtype=np.float64)
        k = np.arange(bins, dtype=np.float64)[:, None]
        cos_b = np.cos(2.0 * math.pi * k * t[None, :] / n_fft) * window[None, :]
        sin_b = np.sin(2.0 * math.pi * k * t[None, :] / n_fft) * window[None, :]
        basis = np.concatenate([cos_b, sin_b], axis=0).astype(np.float32)  # (2 * bins, n_fft)
        self._bins = bins
        self._dft_t = torch.as_tensor(np.ascontiguousarray(basis.T), device=device)  # (n_fft, 2 * bins)
        mel = mel_filter_bank(
            num_frequency_bins=bins,
            num_mel_filters=feature_size,
            min_frequency=0.0,
            max_frequency=8000.0,
            sampling_rate=sampling_rate,
        ).astype(np.float32)  # (bins, n_mels)
        self._mel = torch.as_tensor(mel, device=device)
        self._tail_raw = float(np.log10(1e-10))  # the zero tail's log10 before the clamp (audio/mel.py)

    def __call__(self, pcm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        w, s = pcm.shape
        hop, n_fft = self.hop_length, self.n_fft
        f_cap = s // hop
        pad = n_fft // 2
        # host parity: the left chunk edge is reflect-padded; right of the dense region lie
        # the chunk's zeros (the zero tail), so zero padding is exact there
        x = F.pad(pcm.float()[:, None, :], (pad, 0), mode="reflect")[:, 0]
        x = F.pad(x, (0, pad))
        # exactly f_cap frames: frame f_cap + 1 is the one the host drops
        frames = x[:, : f_cap * hop + (n_fft - hop)].unfold(1, n_fft, hop)  # (W, f_cap, n_fft)
        with _full_fp32():
            spec = torch.matmul(frames, self._dft_t)  # (W, f_cap, 2 * bins)
            power = spec[..., : self._bins] ** 2 + spec[..., self._bins:] ** 2
            mel = torch.matmul(power, self._mel).transpose(1, 2)  # (W, n_mels, f_cap)
        log_spec = torch.log10(torch.clamp(mel, min=1e-10))
        # Whisper clamp: the max over every frame of the 30 s chunk; the zero tail contributes
        # log10(1e-10), never the max for real audio, but an all-zero window must clamp as the host does
        gmax = torch.clamp(log_spec.amax(dim=(1, 2)), min=self._tail_raw)
        dense = (torch.maximum(log_spec, (gmax - 8.0)[:, None, None]) + 4.0) / 4.0
        tail = (torch.clamp(gmax - 8.0, min=self._tail_raw) + 4.0) / 4.0
        return dense, tail
