"""Whisper-compatible log-mel spectrogram front-end in pure numpy.

Replaces the reference's ``transformers.WhisperFeatureExtractor``
(``processing_cm3p.py:13,292``): Hann-window STFT (center=True, reflect
padding), power-2 spectrum, slaney-scale/slaney-norm mel filterbank,
log10 with the Whisper dynamic-range clamp ``max(log, max-8)`` and the
``(x + 4) / 4`` affine, dropping the trailing frame.

Runs host-side in data workers; the arrays it emits feed the TPU audio tower.
"""
from __future__ import annotations


from typing import Optional

import numpy as np

from ..utils.io import JsonConfigMixin


def hertz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    log_region = freq >= min_log_hertz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hertz) * logstep, mels)
    return mels


def mel_to_hertz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    log_region = mels >= min_log_mel
    freq = np.where(log_region, min_log_hertz * np.exp(logstep * (mels - min_log_mel)), freq)
    return freq


def mel_filter_bank(
    num_frequency_bins: int,
    num_mel_filters: int,
    min_frequency: float,
    max_frequency: float,
    sampling_rate: int,
) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank (freq_bins, mels)."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)
    mel_min = hertz_to_mel_slaney(np.array(min_frequency))
    mel_max = hertz_to_mel_slaney(np.array(max_frequency))
    mel_freqs = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz_slaney(mel_freqs)

    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))

    # slaney normalization: scale each filter by 2 / bandwidth
    enorm = 2.0 / (filter_freqs[2 : num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    fb *= np.expand_dims(enorm, 0)
    return fb


class LogMelExtractor(JsonConfigMixin):
    """Compute Whisper-style log-mel features: waveform -> (n_mels, frames)."""

    config_name = "preprocessor_config.json"

    def __init__(
        self,
        feature_size: int = 80,
        sampling_rate: int = 16000,
        hop_length: int = 160,
        chunk_length: int = 30,
        n_fft: int = 400,
        padding_value: float = 0.0,
        dither: float = 0.0,
        return_attention_mask: bool = False,
        **_unused,
    ):
        self.feature_size = feature_size
        self.sampling_rate = sampling_rate
        self.hop_length = hop_length
        self.chunk_length = chunk_length
        self.n_fft = n_fft
        self.padding_value = padding_value
        self.dither = dither
        self.return_attention_mask = return_attention_mask

        # filterbank/window are designed in float64 for accuracy, then cast:
        # the hot path (pad, frame, FFT, power, filter matmul) runs float32 —
        # scipy.fft computes complex64 natively (numpy's float32 FFT path is
        # ~11x slower than float64 on this host; scipy's is at parity), and
        # the result stays within ~1e-6 of the float64 WhisperFeatureExtractor
        # output (parity asserted at 1e-4, tests/test_audio_parity.py).
        self.window = np.hanning(n_fft + 1)[:-1].astype(np.float32)  # periodic hann
        self._stft_ws = None  # per-shape frame workspace (see _stft_power)
        self.mel_filters = mel_filter_bank(
            num_frequency_bins=1 + n_fft // 2,
            num_mel_filters=feature_size,
            min_frequency=0.0,
            max_frequency=8000.0,
            sampling_rate=sampling_rate,
        )
        self._filters32 = self.mel_filters.astype(np.float32)

    def __getstate__(self):
        # the scratch workspace must not ride the pickle to spawned loader
        # workers (it can be MBs and is rebuilt lazily per process)
        state = self.__dict__.copy()
        state["_stft_ws"] = None
        return state

    def get_config(self) -> dict:
        return {
            "feature_size": self.feature_size,
            "sampling_rate": self.sampling_rate,
            "hop_length": self.hop_length,
            "chunk_length": self.chunk_length,
            "n_fft": self.n_fft,
            "padding_value": self.padding_value,
            "dither": self.dither,
            "return_attention_mask": self.return_attention_mask,
        }

    def _stft_power(self, waveform: np.ndarray) -> np.ndarray:
        """Centered power spectrogram, shape (num_frames, 1 + n_fft//2)."""
        from scipy.fft import rfft  # float32-native (numpy's is pathologically slow)

        pad = self.n_fft // 2
        waveform = np.pad(np.asarray(waveform, dtype=np.float32), (pad, pad), mode="reflect")
        num_frames = 1 + (len(waveform) - self.n_fft) // self.hop_length
        # strided frame view, then batched rFFT
        stride = waveform.strides[0]
        frames = np.lib.stride_tricks.as_strided(
            waveform,
            shape=(num_frames, self.n_fft),
            strides=(self.hop_length * stride, stride),
            writeable=False,
        )
        # temporaries are ~20% of this function (r19 micro A/B, BASELINE):
        # window-multiply into a reused per-shape workspace, let pocketfft
        # consume it in place, square |spec| in place (|.|^2 vs re^2+im^2
        # differs ~1e-7 relative — far inside the 1e-4 Whisper-parity
        # budget, tests/test_audio_parity.py)
        ws = self._stft_ws
        if ws is None or ws.shape[0] != num_frames:
            ws = self._stft_ws = np.empty((num_frames, self.n_fft), np.float32)
        np.multiply(frames, self.window, out=ws)
        spec = rfft(ws, axis=1, overwrite_x=True)
        power = np.abs(spec)
        return np.square(power, out=power)

    def __call__(self, waveform: np.ndarray, total_samples: Optional[int] = None) -> np.ndarray:
        """waveform (T,) float -> log-mel (feature_size, T // hop_length).

        ``total_samples``: treat ``waveform`` as zero-padded on the right to
        this length WITHOUT materializing the zeros. Frames fully inside the
        zero tail have power exactly 0 (zeros through Hann/FFT/filterbank stay
        zero), so their log-mel is the constant ``log10(1e-10)`` pre-clamp —
        only frames whose n_fft span touches a real sample are FFT'd, and the
        tail is filled with the clamped constant. Bit-identical to padding
        (asserted by tests/test_audio_parity.py::test_sparse_mel_bit_exact);
        skips ~half the STFT work for 16 s windows in 30 s chunks plus the
        480 k-sample pad copy per window (processor._window_audio).
        """
        waveform = np.asarray(waveform)
        R = waveform.shape[-1]
        if total_samples is not None and total_samples > R:
            # Fall back to dense padding when the zero tail is too short for
            # the kept frames to be provably all-zero (right reflect-padding
            # would mirror real samples back in), or when dithering would
            # draw noise over the padded region too.
            if total_samples - R < self.n_fft or self.dither or R == 0:
                waveform = np.pad(waveform, (0, total_samples - R))
            else:
                return self._sparse_logmel(waveform, total_samples)
        if self.dither:
            waveform = waveform + self.dither * np.random.randn(*waveform.shape)
        power = self._stft_power(waveform)
        mel = (power @ self._filters32).T
        log_spec = np.log10(np.maximum(mel, np.float32(1e-10)))
        log_spec = log_spec[:, :-1]  # Whisper drops the final frame
        log_spec = np.maximum(log_spec, log_spec.max() - np.float32(8.0))
        log_spec += 4.0
        log_spec /= 4.0
        return log_spec

    def _sparse_logmel(self, real: np.ndarray, total_samples: int) -> np.ndarray:
        dense, tail, n_out = self.logmel_parts(real, total_samples)
        out = np.empty((dense.shape[0], n_out), dtype=np.float32)
        out[:, : dense.shape[1]] = dense
        out[:, dense.shape[1] :] = tail
        return out

    def max_real_frames(self, samples: int) -> int:
        """Upper bound on ``logmel_parts``'s dense width for ``samples``
        real samples (frame i touches a real sample iff i*hop - n_fft/2 <
        samples)."""
        return -(-(samples + self.n_fft // 2) // self.hop_length)

    def logmel_parts(
        self, real: np.ndarray, total_samples: int
    ) -> tuple[np.ndarray, np.float32, int]:
        """Log-mel of ``real`` + an implicit zero tail to ``total_samples``,
        as ``(dense (n_mels, n_real), tail_value, n_out)`` — the full
        (n_mels, n_out) array equals ``dense`` extended with the constant
        ``tail_value``. This is the compact wire form: the tail never has to
        be materialized, pickled across the loader boundary, or transferred
        to the device (the device broadcasts the scalar back).

        Preconditions (enforced by the caller):
        ``total_samples - len(real) >= n_fft``, which guarantees (a) no kept
        frame of the implicit dense array touches its right reflect-pad
        region with real samples in it, and (b) every frame not touching a
        real sample is exactly zero. ``len(real) == 0`` is handled (all
        frames take the tail constant).
        """
        pad = self.n_fft // 2
        hop = self.hop_length
        R = real.shape[-1]
        n_full = 1 + (total_samples + 2 * pad - self.n_fft) // hop
        n_out = n_full - 1  # Whisper drops the final frame
        if R == 0:
            zval = np.log10(np.float32(1e-10))
            tail = (np.maximum(zval, zval - np.float32(8.0)) + np.float32(4.0)) / np.float32(4.0)
            return np.zeros((self.feature_size, 0), np.float32), np.float32(tail), n_out
        # frame i spans unpadded samples [i*hop - pad, i*hop - pad + n_fft):
        # it touches a real sample iff i*hop - pad < R
        n_real = min(n_out, -(-(R + pad) // hop))
        # a short zero extension so frame n_real-1's span stays inside the
        # buffer and the buffer's own right reflect-pad (of zeros) is valid
        buf = np.zeros(R + self.n_fft, dtype=np.float32)
        buf[:R] = real
        power = self._stft_power(buf)[:n_real]
        mel = (power @ self._filters32).T  # (n_mels, n_real)
        log_real = np.log10(np.maximum(mel, np.float32(1e-10)))
        zval = np.log10(np.float32(1e-10))  # pre-clamp value of an all-zero frame
        max_val = log_real.max() if n_real > 0 else zval  # zval never exceeds real maxima
        floor = max_val - np.float32(8.0)
        dense = (np.maximum(log_real, floor) + np.float32(4.0)) / np.float32(4.0)
        tail = (np.maximum(zval, floor) + np.float32(4.0)) / np.float32(4.0)
        return dense, np.float32(tail), n_out
