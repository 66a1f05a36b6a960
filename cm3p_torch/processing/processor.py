"""CM3P multi-modal processor (beatmap + metadata + audio front-end).

Orchestrates parsing, sliding-window chunking, log-mel extraction,
audio-token accounting, metadata derivation/dropout/variation-expansion and
tokenization into rectangular numpy batches. Parity target:
``/root/reference/cm3p/processing_cm3p.py:195-643`` with one deliberate
TPU-first change: outputs are numpy arrays with bucketable static shapes
(``padding='max_length'`` + ``pad_to_multiple_of``) instead of torch tensors
with ragged lengths.
"""
from __future__ import annotations

import copy
import logging
import math
from os import PathLike
from pathlib import Path
from typing import IO, NamedTuple, Optional, Union

import numpy as np

from ..audio.loading import prepare_waveform
from ..audio.mel import LogMelExtractor
from ..beatmap.osu import Beatmap, HoldNote
from ..beatmap.parser import BeatmapEventParser, get_song_length, load_beatmap
from ..tokenize.beatmap_tokenizer import BatchTokens, BeatmapTokenizer
from ..tokenize.metadata_tokenizer import Metadata, MetadataTokenizer, merge_metadata_dicts
from ..utils.io import read_json, write_json

logger = logging.getLogger(__name__)

BeatmapInput = Union[str, PathLike, IO[str], Beatmap]

DEFAULT_KWARGS = {
    "beatmap_kwargs": {
        "max_length": 8000,
        "padding": "longest",
        "truncation": True,
        "window_length_sec": 30.0,
        "window_stride_sec": 30.0,
        "min_window_length_sec": 1.0,
    },
    "metadata_kwargs": {
        "max_length": 128,
        "padding": "longest",
        "truncation": True,
    },
    "audio_kwargs": {
        "sampling_rate": 16000,
        "pad_to_multiple_of": 480000,
        "max_source_positions": 3000,
        "hop_length": 160,
        "window_size": 400,
        "audio_length_per_tok": 8,
    },
}

# flat kwargs routed to their modality dict (processing_cm3p.py:362-419)
_BEATMAP_KEYS = set(DEFAULT_KWARGS["beatmap_kwargs"]) | {"pad_to_multiple_of"}
_METADATA_KEYS = set(DEFAULT_KWARGS["metadata_kwargs"])
_AUDIO_KEYS = set(DEFAULT_KWARGS["audio_kwargs"]) | {"compact_tail", "pcm_wire"}


class PcmFeatures(NamedTuple):
    """Raw-PCM wire form (``pcm_wire`` audio kwarg): per-window waveforms
    zero-padded to ``f_cap * hop_length`` samples; the log-mel runs ON
    DEVICE (audio/device_mel.py DFT-as-convolution) producing the same
    dense+tail compact pair. 4x the bytes of the compact bf16 mel but zero
    host mel CPU — the right trade on TPU-VM-class host links (the gate
    stays off elsewhere; measured: tools/bench_mel_wire.py --pcm)."""

    pcm: np.ndarray  # (chunks, f_cap * hop) float32


class CompactFeatures(NamedTuple):
    """Compact log-mel wire form: ``dense`` (chunks, n_mels, f_cap) holds the
    frames that can differ between windows; every frame past ``dense``'s
    width up to ``max_source_positions`` equals the per-window constant
    ``tail`` (chunks,) — the analytic value of a fully-zero-padded frame
    (audio/mel.py logmel_parts). Consumers reconstruct the exact full
    features with a broadcast; producers never materialize, pickle, or
    transfer the ~47% constant tail of a 16 s window in a 30 s chunk.
    Opt-in via the ``compact_tail`` audio kwarg."""

    dense: np.ndarray
    tail: np.ndarray


# ------------------------------------------------------- metadata derivation


def get_hold_note_ratio(beatmap: Beatmap) -> Optional[float]:
    notes = beatmap.hit_objects(stacking=False)
    if len(notes) == 0:
        return None
    hold = sum(1 for n in notes if isinstance(n, HoldNote))
    return hold / len(notes)


def get_scroll_speed_ratio(beatmap: Beatmap) -> Optional[float]:
    """Scroll-speed changes per distinct hit-object time (processing_cm3p.py:46-69)."""
    notes = beatmap.hit_objects(stacking=False)
    if len(notes) == 0:
        return None
    last_time = -1
    num_note_times = 0
    for note in notes:
        if note.time != last_time:
            num_note_times += 1
            last_time = note.time
    last_speed = -1.0
    num_changes = 0
    for tp in beatmap.timing_points:
        if tp.parent is None:
            last_speed = 1.0
        else:
            speed = -100.0 / tp.ms_per_beat
            if speed != last_speed and last_speed != -1:
                num_changes += 1
            last_speed = speed
    return num_changes / num_note_times


def get_hitsounded_status(beatmap: Beatmap) -> bool:
    return any(n.hitsound != 0 for n in beatmap.hit_objects(stacking=False))


def get_difficulty(beatmap_metadata, speed: float = 1.0) -> float:
    """Interpolate the per-speed StarRating array at ``speed``."""
    star_ratings = beatmap_metadata["StarRating"]
    speed_ratios = [0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0]
    return float(np.interp(speed, speed_ratios, star_ratings))


def get_metadata(
    beatmap_metadata=None,
    beatmap: Optional[Beatmap] = None,
    audio_samples: Optional[np.ndarray] = None,
    sampling_rate: Optional[int] = None,
    speed: float = 1.0,
    song_position: Optional[float] = None,
) -> Metadata:
    """Derive the 14-field metadata dict from dataset row and/or beatmap."""
    mode = (
        beatmap.mode
        if beatmap is not None
        else beatmap_metadata["ModeInt"]
        if beatmap_metadata is not None
        else None
    )
    circle_size = (
        beatmap.circle_size
        if beatmap is not None
        else beatmap_metadata["Cs"]
        if beatmap_metadata is not None
        else None
    )
    song_length = get_song_length(audio_samples, sampling_rate, beatmap)
    return {
        "difficulty": get_difficulty(beatmap_metadata, speed) if beatmap_metadata is not None else None,
        "year": beatmap_metadata["SubmittedDate"].year if beatmap_metadata is not None else None,
        "mode": mode,
        "status": beatmap_metadata["Status"] if beatmap_metadata is not None else None,
        "mapper": beatmap_metadata["UserId"] if beatmap_metadata is not None else None,
        "cs": circle_size if mode in (0, 2) else None,
        "hitsounded": get_hitsounded_status(beatmap) if beatmap is not None else None,
        "song_length": song_length,
        "song_position": song_position,
        "global_sv": beatmap.slider_multiplier if mode in (0, 2) and beatmap is not None else None,
        "mania_keycount": int(circle_size) if mode == 3 and beatmap is not None else None,
        "hold_note_ratio": get_hold_note_ratio(beatmap) if mode == 3 and beatmap is not None else None,
        "scroll_speed_ratio": get_scroll_speed_ratio(beatmap) if mode in (1, 3) and beatmap is not None else None,
        "tags": list(beatmap_metadata["TopTagIds"]) if beatmap_metadata is not None else None,
    }


class _NativeUnsupported(Exception):
    """Input/config the native front end doesn't cover; use the python path."""


def _metadata_from_summary(summary, song_length, song_position):
    """get_metadata(beatmap=...) equivalent from a native CtSummary.

    Field-for-field identical to :func:`get_metadata` with ``beatmap_metadata``
    None (the processor's populate path): the summary carries the same
    mode/cs/sv scalars and the hold/scroll/hitsounded scans run in C++ with
    the same arithmetic (beatmap_fast.cpp:ct_beatmap_summary).
    """
    import math

    mode = summary.mode
    no_notes = summary.n_hit_objects == 0
    return {
        "difficulty": None,
        "year": None,
        "mode": mode,
        "status": None,
        "mapper": None,
        "cs": summary.circle_size if mode in (0, 2) else None,
        "hitsounded": bool(summary.hitsounded),
        "song_length": song_length,
        "song_position": song_position,
        "global_sv": summary.slider_multiplier if mode in (0, 2) else None,
        "mania_keycount": int(summary.circle_size) if mode == 3 else None,
        "hold_note_ratio": (None if no_notes or math.isnan(summary.hold_note_ratio)
                            else summary.hold_note_ratio) if mode == 3 else None,
        "scroll_speed_ratio": (None if no_notes or math.isnan(summary.scroll_speed_ratio)
                               else summary.scroll_speed_ratio) if mode in (1, 3) else None,
        "tags": None,
    }


# ------------------------------------------------------------------ processor


class CM3PProcessor:
    """Bundle of the four front-end components with HF-style save/load.

    ``native`` (default True): beatmaps given as paths go through the host
    library's C++ parse -> lower -> window-tokenize (``native/beatmap_fast.cpp``)
    and WAVE files through its decoder, both bit-identical to the Python path;
    an input the C++ side does not cover takes the Python path. False runs the
    Python path only. ``host_counts`` counts the beatmaps parsed and the audio
    files decoded by each route.
    """

    attributes = ["audio_feature_extractor", "beatmap_parser", "beatmap_tokenizer", "metadata_tokenizer"]

    def __init__(
        self,
        audio_feature_extractor: Optional[LogMelExtractor] = None,
        beatmap_parser: Optional[BeatmapEventParser] = None,
        beatmap_tokenizer: Optional[BeatmapTokenizer] = None,
        metadata_tokenizer: Optional[MetadataTokenizer] = None,
        default_kwargs: Optional[dict] = None,
        rng: Optional[np.random.Generator] = None,
        native: bool = True,
    ):
        self.audio_feature_extractor = audio_feature_extractor or LogMelExtractor()
        self.beatmap_parser = beatmap_parser or BeatmapEventParser()
        self.beatmap_tokenizer = beatmap_tokenizer or BeatmapTokenizer()
        self.metadata_tokenizer = metadata_tokenizer or MetadataTokenizer()
        self.audio_token = self.beatmap_tokenizer.audio_token
        self.default_kwargs = copy.deepcopy(default_kwargs) if default_kwargs else copy.deepcopy(DEFAULT_KWARGS)
        self.rng = rng or np.random.default_rng()
        self.native = native
        self.host_counts = {"parse_native": 0, "parse_python": 0, "decode_native": 0, "decode_python": 0}

    # ----------------------------------------------------------------- audio

    @staticmethod
    def _pad_target(
        length: int,
        window_size: int = 400,
        pad_to_multiple_of: Optional[int] = 480000,
        **_,
    ) -> int:
        """Length the window's waveform zero-pads to (reference semantics:
        a multiple of ``pad_to_multiple_of``, `processing_cm3p.py:239-282`) —
        computed without materializing the padded array."""
        if pad_to_multiple_of:
            return math.ceil(length / pad_to_multiple_of) * pad_to_multiple_of
        return max(length, window_size)

    def _encode_audio(
        self,
        audio: np.ndarray,
        hop_length: int = 160,
        audio_length_per_tok: int = 8,
        **kwargs,
    ) -> tuple[np.ndarray, int, int]:
        """Audio-token count + target (padded) length for one window slice.

        Returns the waveform UNPADDED together with the length it pads to —
        the log-mel extractor handles the implicit zero tail analytically
        (``LogMelExtractor.__call__(total_samples=...)``), so the 480 k-sample
        zero pad is never materialized per window.
        """
        target = self._pad_target(audio.shape[-1], **kwargs)
        signal_length = target
        if signal_length % hop_length != 0:
            signal_length = math.ceil(signal_length / hop_length - 1)
        else:
            signal_length = signal_length // hop_length
        num_audio_tokens = math.ceil(signal_length / audio_length_per_tok)
        return audio, target, num_audio_tokens

    def _window_audio(
        self,
        audio_array: np.ndarray,
        song_length: float,
        window_length_sec: float,
        window_stride_sec: float,
        min_window_length_sec: float,
        sampling_rate: int,
        audio_kwargs: dict,
        max_source_positions: int,
        cache: Optional[dict],
        cache_token=None,
        cache_pin=None,
    ) -> tuple[list[int], np.ndarray]:
        """Per-window audio-token counts + log-mel features for one waveform.

        Depends only on the audio and the window/audio kwargs — NOT on the
        beatmap — so results are memoized in ``cache`` (caller-scoped, one
        per decoded track) and shared by every difficulty of a beatmapset.
        ``cache_token`` identifies the CALLER's audio (path string or
        original-array id); ``cache_pin`` is stored in the entry so an
        id-based token can't be recycled while the cache lives.
        """
        key = None
        if cache is not None and cache_token is not None:
            key = (
                cache_token,
                int(audio_array.shape[-1]),  # prepared length (covers resample)
                window_length_sec, window_stride_sec, min_window_length_sec,
                sampling_rate, max_source_positions,
                tuple(sorted((k, v) for k, v in audio_kwargs.items()
                             if isinstance(v, (int, float, str, bool, type(None))))),
            )
            if key in cache:
                counts, feats, _pin = cache[key]
                return counts, feats
        counts: list[int] = []
        slices: list[tuple[np.ndarray, int]] = []
        for start_sec in np.arange(0, song_length - min_window_length_sec, window_stride_sec):
            start_frame = int(start_sec * sampling_rate)
            end_frame = int((start_sec + window_length_sec) * sampling_rate)
            audio_slice, target, num_audio_tokens = self._encode_audio(
                audio_array[start_frame:end_frame], **audio_kwargs
            )
            counts.append(num_audio_tokens)
            slices.append((audio_slice, target))
        if audio_kwargs.get("pcm_wire"):
            f_cap = self._compact_frames(window_length_sec, sampling_rate)
            feats = self._retrieve_input_features_pcm(slices, max_source_positions, f_cap)
        elif audio_kwargs.get("compact_tail"):
            f_cap = self._compact_frames(window_length_sec, sampling_rate)
            if slices:
                feats = self._retrieve_input_features_compact(
                    slices, max_source_positions, f_cap
                )
            else:
                feats = CompactFeatures(
                    np.zeros((0, self.audio_feature_extractor.feature_size, f_cap), np.float32),
                    np.zeros((0,), np.float32),
                )
        elif slices:
            feats = self._retrieve_input_features(slices, max_source_positions)
        else:
            feats = np.zeros(
                (0, self.audio_feature_extractor.feature_size, max_source_positions),
                dtype=np.float32,
            )
        if key is not None:
            cache[key] = (counts, feats, cache_pin)
        return counts, feats

    def _compact_frames(self, window_length_sec: float, sampling_rate: int) -> int:
        """Dense width of the compact feature wire form for this window
        config: enough frames for the longest possible window slice, rounded
        up to a multiple of 8 (the round-up region still carries the exact
        tail constant)."""
        cap = self.audio_feature_extractor.max_real_frames(
            int(math.ceil(window_length_sec * sampling_rate)) + 1
        )
        return -(-cap // 8) * 8

    def _retrieve_input_features_compact(
        self, audio_list: list[tuple[np.ndarray, int]], max_source_positions: int, f_cap: int
    ) -> CompactFeatures:
        """Compact log-mel per window: ``(dense (chunks, n_mels, f_cap),
        tail (chunks,))`` where the full features equal ``dense`` extended
        with the per-window ``tail`` constant to ``max_source_positions``
        frames. Requires single-chunk windows whose zero tail is at least
        ``n_fft`` samples (every 16 s-window-in-30 s-chunk configuration);
        raises ``ValueError`` otherwise so callers opt in deliberately."""
        fe = self.audio_feature_extractor
        chunk_samples = fe.chunk_length * fe.sampling_rate
        dense = np.empty((len(audio_list), fe.feature_size, f_cap), np.float32)
        tails = np.empty((len(audio_list),), np.float32)
        for i, (audio_array, target) in enumerate(audio_list):
            real = int(np.asarray(audio_array).shape[-1])
            if target != chunk_samples or fe.dither or (real > 0 and target - real < fe.n_fft):
                raise ValueError(
                    "compact_tail requires single-chunk windows with a >= n_fft "
                    f"zero tail (window target {target}, chunk {chunk_samples}, "
                    f"real samples {real}); disable compact_tail for this "
                    "window configuration"
                )
            d, tail, n_out = fe.logmel_parts(np.asarray(audio_array), target)
            if n_out != max_source_positions or d.shape[1] > f_cap:
                raise ValueError(
                    f"compact_tail frame mismatch: chunk has {n_out} frames "
                    f"(expected {max_source_positions}), dense {d.shape[1]} "
                    f"(cap {f_cap})"
                )
            dense[i, :, : d.shape[1]] = d
            dense[i, :, d.shape[1] :] = tail
            tails[i] = tail
        return CompactFeatures(dense, tails)

    def _retrieve_input_features_pcm(
        self, audio_list: list[tuple[np.ndarray, int]], max_source_positions: int, f_cap: int
    ) -> PcmFeatures:
        """Raw per-window PCM padded to ``f_cap * hop`` samples (no host
        mel). Guards mirror the compact path: single-chunk windows, no
        dither, and the real slice must end >= n_fft//2 before the pad
        length so the device's zero right-padding is exact."""
        fe = self.audio_feature_extractor
        chunk_samples = fe.chunk_length * fe.sampling_rate
        s_cap = f_cap * fe.hop_length
        pcm = np.zeros((len(audio_list), s_cap), np.float32)
        for i, (audio_array, target) in enumerate(audio_list):
            arr = np.asarray(audio_array, np.float32)
            real = int(arr.shape[-1])
            # same guard as the compact path (the device output feeds the
            # same dense+tail reconstruction), plus the device-side
            # zero-right-padding condition
            if (
                target != chunk_samples
                or fe.dither
                or (real > 0 and target - real < fe.n_fft)
                or real > s_cap - fe.n_fft // 2
            ):
                raise ValueError(
                    "pcm_wire requires single-chunk windows with a >= n_fft "
                    f"zero tail inside the dense frame cap (real {real}, "
                    f"cap {s_cap}, chunk target {target}); disable pcm_wire "
                    "for this window configuration"
                )
            pcm[i, :real] = arr
        return PcmFeatures(pcm)

    def _retrieve_input_features(
        self, audio_list: list[tuple[np.ndarray, int]], max_source_positions: int, **_
    ) -> np.ndarray:
        """Log-mel per window, chunked to (chunks, n_mels, max_source_positions).

        Each entry is ``(waveform, target_len)``: the unpadded window slice and
        the length it zero-pads to (the mel extractor handles the implicit
        tail without materializing it).
        """
        features = []
        for audio_array, target in audio_list:
            mel = self.audio_feature_extractor(audio_array, total_samples=target)  # (80, frames)
            chunks = mel.reshape(self.audio_feature_extractor.feature_size, -1, max_source_positions)
            features.append(chunks.swapaxes(0, 1))
        return np.concatenate(features).astype(np.float32, copy=False)

    def _load_audio(
        self,
        sampling_rate: int,
        audio,
        audio_sampling_rate: Optional[Union[int, list[int]]] = None,
        speed: float = 1.0,
    ) -> list[np.ndarray]:
        from ..audio.loading import load_audio_file

        if isinstance(audio, (str, Path)):
            audio = [load_audio_file(audio, sampling_rate, speed, self.native, self.host_counts)]
            audio_sampling_rate = sampling_rate
        elif isinstance(audio, list) and all(isinstance(a, (str, Path)) for a in audio):
            audio = [load_audio_file(a, sampling_rate, speed, self.native, self.host_counts) for a in audio]
            audio_sampling_rate = sampling_rate
        elif isinstance(audio, np.ndarray) and audio.ndim <= 2:
            audio = [audio]

        if audio_sampling_rate is None:
            audio_sampling_rate = sampling_rate
        if isinstance(audio_sampling_rate, int):
            audio_sampling_rate = [audio_sampling_rate] * len(audio)

        return [prepare_waveform(a, s, sampling_rate) for a, s in zip(audio, audio_sampling_rate)]

    # ---------------------------------------------------------------- kwargs

    def _merge_kwargs(self, **kwargs) -> dict:
        out = copy.deepcopy(self.default_kwargs)
        for modality, keys in (
            ("beatmap_kwargs", _BEATMAP_KEYS),
            ("metadata_kwargs", _METADATA_KEYS),
            ("audio_kwargs", _AUDIO_KEYS),
        ):
            out.setdefault(modality, {})
            if modality in kwargs:
                out[modality].update(kwargs[modality])
        for key, value in kwargs.items():
            if key in ("beatmap_kwargs", "metadata_kwargs", "audio_kwargs"):
                continue
            # flat kwargs update every modality that knows the key
            if key in _BEATMAP_KEYS:
                out["beatmap_kwargs"][key] = value
            if key in _METADATA_KEYS and key != "pad_to_multiple_of":
                out["metadata_kwargs"][key] = value
            if key in _AUDIO_KEYS and key not in ("pad_to_multiple_of",):
                out["audio_kwargs"][key] = value
        return out

    # ------------------------------------------------------------------ call

    # --------------------------------------------------- beatmap batch paths

    @staticmethod
    def _set_input_features(encoding: BatchTokens, batch_features: list) -> None:
        """Concatenate per-beatmap window features into the encoding —
        full (chunks, n_mels, max_source_positions) arrays, or the compact
        dense+tail pair (``input_features`` + ``input_features_tail``)."""
        if batch_features and isinstance(batch_features[0], PcmFeatures):
            encoding["input_features_pcm"] = np.concatenate(
                [f.pcm for f in batch_features]
            ).astype(np.float32, copy=False)
            return
        if batch_features and isinstance(batch_features[0], CompactFeatures):
            encoding["input_features"] = np.concatenate(
                [f.dense for f in batch_features]
            ).astype(np.float32, copy=False)
            encoding["input_features_tail"] = np.concatenate(
                [f.tail for f in batch_features]
            ).astype(np.float32, copy=False)
        else:
            encoding["input_features"] = np.concatenate(batch_features).astype(
                np.float32, copy=False
            )

    def _native_tables(self):
        if getattr(self, "_native_tables_cache", None) is None:
            from ..native.beatmap import TokTables

            self._native_tables_cache = TokTables(self.beatmap_tokenizer)
        return self._native_tables_cache

    def __getstate__(self):
        """Drop the ctypes token-table handle: ctypes structures with
        pointers cannot cross a pickle boundary, and a processor that has
        parsed one beatmap natively would otherwise crash every spawn
        dataset-worker start (the loader pickles the dataset factory, which
        carries the processor). The tables rebuild lazily on first use."""
        state = self.__dict__.copy()
        state.pop("_native_tables_cache", None)
        return state

    def _process_beatmaps_native(
        self, beatmap, matched_metadata, audio, audio_cache_tokens, speed,
        multiply_metadata, populate_metadata, window_length_sec,
        window_stride_sec, min_window_length_sec, sampling_rate, audio_kwargs,
        max_source_positions, beatmap_kwargs, audio_features_cache,
    ):
        """C++ parse -> lower -> window-tokenize (beatmap_fast.cpp), one call
        per beatmap. Mirrors :meth:`_process_beatmaps` exactly; raises
        :class:`_NativeUnsupported` for anything it does not cover. The host
        library builds and loads first, outside any fallback: a failed build
        raises with the compiler's output."""
        from pathlib import Path as _Path

        from ..native import library
        from ..native.beatmap import NativeBeatmap, NativeDeclined

        library()
        max_length = beatmap_kwargs.get("max_length")
        padding = beatmap_kwargs.get("padding", "longest")
        truncation = beatmap_kwargs.get("truncation", True)
        pad_to_multiple_of = beatmap_kwargs.get("pad_to_multiple_of")
        if not truncation or max_length is None or padding not in ("longest", "max_length"):
            raise _NativeUnsupported
        if any(not isinstance(b, (str, _Path)) for b in beatmap):
            raise _NativeUnsupported

        tables = self._native_tables()
        pad_id = self.beatmap_tokenizer.pad_token_id
        new_metadata: list[Optional[Metadata]] = []
        batch_ids: list[np.ndarray] = []
        batch_masks: list[np.ndarray] = []
        batch_lens: list[np.ndarray] = []
        batch_features: list[np.ndarray] = []

        for b, m, audio_array, (cache_token, cache_pin) in zip(
            beatmap, matched_metadata, audio, audio_cache_tokens
        ):
            try:
                nb = NativeBeatmap.from_path(b)
            except (OSError, NativeDeclined):  # the file's read or parse: the python path raises the real error
                raise _NativeUnsupported
            summary = nb.summary()
            if summary.parse_error:
                raise _NativeUnsupported
            # get_song_length semantics (parser.py:37-60)
            if audio_array is not None:
                song_length = len(audio_array) / sampling_rate
            elif summary.n_hit_objects > 0:
                song_length = summary.last_ho_for_length / 1000.0 + 0.000999
            elif not np.isnan(summary.last_tp_offset):
                song_length = summary.last_tp_offset / 1000.0 + 0.01
            else:
                song_length = 0
            try:
                events = nb.parse_events(self.beatmap_parser, speed, song_length)
            except NativeDeclined:
                raise _NativeUnsupported
            last_ms = events.last_time()
            if audio_array is not None and last_ms is not None:
                if last_ms > song_length * 1000 + 2000:
                    logger.warning(
                        "beatmap extends %.1fs past its %.1fs audio; "
                        "%d ms of objects will not appear in any window",
                        last_ms / 1000 - song_length, song_length,
                        int(last_ms - song_length * 1000),
                    )

            def add_metadata(song_position: Optional[float] = None):
                if populate_metadata:
                    new_metadata.append(
                        merge_metadata_dicts(
                            m, _metadata_from_summary(summary, song_length, song_position)
                        )
                    )
                else:
                    new_metadata.append(m)

            if not multiply_metadata:
                add_metadata()

            if audio_array is not None:
                audio_counts, audio_feats = self._window_audio(
                    audio_array, song_length, window_length_sec,
                    window_stride_sec, min_window_length_sec,
                    sampling_rate, audio_kwargs, max_source_positions,
                    audio_features_cache, cache_token, cache_pin,
                )
                batch_features.append(audio_feats)
            else:
                audio_counts = None

            starts = np.arange(0, song_length - min_window_length_sec, window_stride_sec)
            if len(starts) == 0:
                continue
            start_ms = starts * 1000.0
            end_ms = (starts + window_length_sec) * 1000.0
            next_ms = (starts + window_stride_sec) * 1000.0
            nats = (np.asarray(audio_counts[: len(starts)], np.int32)
                    if audio_counts is not None else np.zeros(len(starts), np.int32))
            res = events.tokenize_windows(
                tables, start_ms, end_ms, next_ms, nats, max_length, max_length, pad_id
            )
            if res is None:
                raise _NativeUnsupported
            ids, mask, lens = res
            batch_ids.append(ids)
            batch_masks.append(mask)
            batch_lens.append(lens)
            if multiply_metadata:
                for start_sec in starts:
                    add_metadata(start_sec / song_length)

        if not batch_ids:
            raise _NativeUnsupported  # zero-window edge; python path builds it

        ids = np.concatenate(batch_ids)
        mask = np.concatenate(batch_masks)
        lens = np.concatenate(batch_lens)
        # pack_sequences target arithmetic (beatmap_tokenizer.py:442-467)
        target = max_length if padding == "max_length" else int(lens.max())
        if pad_to_multiple_of:
            target = -(-target // pad_to_multiple_of) * pad_to_multiple_of
        if target <= max_length:
            ids = np.ascontiguousarray(ids[:, :target])
            mask = np.ascontiguousarray(mask[:, :target])
        else:
            extra = target - max_length
            ids = np.pad(ids, ((0, 0), (0, extra)), constant_values=pad_id)
            mask = np.pad(mask, ((0, 0), (0, extra)))
        beatmap_encoding = BatchTokens(input_ids=ids, attention_mask=mask)
        if all(a is not None for a in audio):
            self._set_input_features(beatmap_encoding, batch_features)
        return beatmap_encoding, new_metadata

    def __call__(
        self,
        metadata: Optional[Union[Metadata, list[Metadata]]] = None,
        beatmap: Optional[Union[BeatmapInput, list[BeatmapInput]]] = None,
        audio=None,
        audio_sampling_rate: Optional[Union[int, list[int]]] = None,
        speed: float = 1.0,
        multiply_metadata: bool = False,
        populate_metadata: bool = False,
        metadata_dropout_prob: float = 0.0,
        metadata_variations: int = 1,
        audio_features_cache: Optional[dict] = None,
        **kwargs,
    ) -> BatchTokens:
        """Process beatmaps/metadata/audio into a model-ready batch.

        Output keys: ``input_ids``, ``attention_mask``, optionally
        ``input_features`` (chunks, n_mels, max_source_positions),
        ``metadata_ids``, ``metadata_attention_mask`` and
        ``metadata_variation_classes``.

        ``audio_features_cache``: optional caller-scoped dict memoizing the
        audio-only per-window work (slicing, token counts, log-mel) across
        calls that share the same decoded waveform — e.g. the difficulties
        of one beatmapset, whose windows derive from the audio alone. The
        caller owns the dict's lifetime (one per decoded track); entries
        are keyed by the waveform's identity plus the window/audio kwargs.
        """
        out_kwargs = self._merge_kwargs(**kwargs)
        beatmap_kwargs = dict(out_kwargs["beatmap_kwargs"])
        metadata_kwargs = dict(out_kwargs["metadata_kwargs"])
        audio_kwargs = dict(out_kwargs["audio_kwargs"])

        window_length_sec = beatmap_kwargs.pop("window_length_sec")
        window_stride_sec = beatmap_kwargs.pop("window_stride_sec")
        min_window_length_sec = beatmap_kwargs.pop("min_window_length_sec", 1.0)
        max_length = beatmap_kwargs.get("max_length", 8000)
        metadata_max_length = metadata_kwargs.get("max_length", 128)
        sampling_rate = audio_kwargs["sampling_rate"]
        max_source_positions = audio_kwargs.get("max_source_positions", 3000)

        beatmap_encoding = None

        if metadata is None and beatmap is None:
            raise ValueError("You have to specify either metadata or beatmap. Both cannot be none.")

        audio_cache_tokens = None
        if audio is not None:
            # cache keys derive from the CALLER's audio identity (path or
            # original array), not the prepared waveform — _load_audio makes
            # a fresh array every call, so its id() never repeats
            raw_audio = audio if isinstance(audio, list) else [audio]
            audio_cache_tokens = [
                (("path", str(a)), a)
                if isinstance(a, (str, Path))
                else (("arr", id(a), int(np.asarray(a).shape[-1])), a)
                for a in raw_audio
            ]
            audio = self._load_audio(sampling_rate, audio, audio_sampling_rate=audio_sampling_rate)

        if beatmap is not None:
            if not isinstance(beatmap, list):
                beatmap = [beatmap]

            if audio is not None:
                if len(beatmap) != len(audio):
                    raise ValueError(
                        f"The number of beatmaps ({len(beatmap)}) must match the number of audio ({len(audio)})"
                    )
            else:
                audio = [None] * len(beatmap)
            if audio_cache_tokens is None:
                audio_cache_tokens = [(None, None)] * len(audio)

            if (multiply_metadata or populate_metadata) and metadata is not None:
                matched_metadata = metadata if isinstance(metadata, list) else [metadata]
                if len(matched_metadata) != len(beatmap):
                    raise ValueError(
                        f"The number of metadata entries ({len(matched_metadata)}) must match the number "
                        f"of beatmaps ({len(beatmap)}) when multiply/populate_metadata is set."
                    )
            else:
                matched_metadata = [{} for _ in beatmap] if populate_metadata else [None] * len(beatmap)

            if self.native:
                try:
                    beatmap_encoding, new_metadata = self._process_beatmaps_native(
                        beatmap, matched_metadata, audio, audio_cache_tokens,
                        speed, multiply_metadata, populate_metadata,
                        window_length_sec, window_stride_sec,
                        min_window_length_sec, sampling_rate, audio_kwargs,
                        max_source_positions, beatmap_kwargs,
                        audio_features_cache,
                    )
                except _NativeUnsupported:
                    beatmap_encoding = None
            if beatmap_encoding is not None:
                self.host_counts["parse_native"] += len(beatmap)
                if populate_metadata or multiply_metadata:
                    metadata = new_metadata
                return self._finish_call(
                    beatmap_encoding, metadata, metadata_dropout_prob,
                    metadata_variations, metadata_kwargs, metadata_max_length,
                )
            self.host_counts["parse_python"] += len(beatmap)

            new_metadata: list[Optional[Metadata]] = []
            batch_start_ms: list[float] = []
            batch_groups: list[list] = []
            batch_features: list[np.ndarray] = []
            batch_num_audio_tokens: list[int] = []

            for b, m, audio_array, (cache_token, cache_pin) in zip(
                beatmap, matched_metadata, audio, audio_cache_tokens
            ):
                b = load_beatmap(b)
                song_length = get_song_length(audio_array, sampling_rate, b)
                beatmap_groups = self.beatmap_parser.parse_beatmap(b, speed=speed, song_length=song_length)
                if audio_array is not None and beatmap_groups:
                    # windows derive from the AUDIO length (reference
                    # semantics): a beatmap outlasting its audio silently
                    # loses its tail — surface that instead of hiding it
                    last_ms = beatmap_groups[-1].time
                    if last_ms > song_length * 1000 + 2000:
                        logger.warning(
                            "beatmap extends %.1fs past its %.1fs audio; "
                            "%d ms of objects will not appear in any window",
                            last_ms / 1000 - song_length, song_length,
                            int(last_ms - song_length * 1000),
                        )

                def add_metadata(song_position: Optional[float] = None):
                    if populate_metadata:
                        new_metadata.append(
                            merge_metadata_dicts(
                                m,
                                get_metadata(
                                    beatmap=b,
                                    audio_samples=audio_array,
                                    sampling_rate=sampling_rate,
                                    speed=speed,
                                    song_position=song_position,
                                ),
                            )
                        )
                    else:
                        new_metadata.append(m)

                if not multiply_metadata:
                    add_metadata()

                # audio-only per-window work (slices -> token counts + mel),
                # memoized across beatmaps sharing this waveform: windows
                # derive from the audio alone, so every difficulty of a
                # beatmapset reuses the same counts and features
                if audio_array is not None:
                    audio_counts, audio_feats = self._window_audio(
                        audio_array, song_length, window_length_sec,
                        window_stride_sec, min_window_length_sec,
                        sampling_rate, audio_kwargs, max_source_positions,
                        audio_features_cache, cache_token, cache_pin,
                    )
                    batch_features.append(audio_feats)
                else:
                    audio_counts = None

                # sliding-window slicing (processing_cm3p.py:515-554)
                groups_search_index = 0
                for wi, start_sec in enumerate(
                    np.arange(0, song_length - min_window_length_sec, window_stride_sec)
                ):
                    end_sec = start_sec + window_length_sec
                    num_audio_tokens = audio_counts[wi] if audio_counts is not None else 0

                    start_ms = start_sec * 1000
                    end_ms = end_sec * 1000
                    next_start_ms = (start_sec + window_stride_sec) * 1000
                    window_groups = []
                    for group in beatmap_groups[groups_search_index:]:
                        if group.time < next_start_ms:
                            groups_search_index += 1
                        if group.time < start_ms:
                            continue
                        elif group.time < end_ms:
                            window_groups.append(group)
                        else:
                            break

                    batch_start_ms.append(start_ms)
                    batch_groups.append(window_groups)
                    batch_num_audio_tokens.append(num_audio_tokens)

                    if multiply_metadata:
                        add_metadata(start_sec / song_length)

            if populate_metadata or multiply_metadata:
                metadata = new_metadata

            if len(batch_groups) > 0:
                beatmap_encoding = self.beatmap_tokenizer(
                    groups=batch_groups,
                    window_start_ms=batch_start_ms,
                    num_audio_tokens=batch_num_audio_tokens,
                    **beatmap_kwargs,
                )
                if all(a is not None for a in audio):
                    self._set_input_features(beatmap_encoding, batch_features)
            else:
                beatmap_encoding = BatchTokens(
                    input_ids=np.zeros((0, max_length), dtype=np.int32),
                    attention_mask=np.zeros((0, max_length), dtype=np.int32),
                )
                if all(a is not None for a in audio):
                    n_mels = self.audio_feature_extractor.feature_size
                    if audio_kwargs.get("compact_tail"):
                        f_cap = self._compact_frames(window_length_sec, sampling_rate)
                        beatmap_encoding["input_features"] = np.zeros((0, n_mels, f_cap), np.float32)
                        beatmap_encoding["input_features_tail"] = np.zeros((0,), np.float32)
                    else:
                        beatmap_encoding["input_features"] = np.zeros(
                            (0, n_mels, max_source_positions), dtype=np.float32
                        )

        return self._finish_call(
            beatmap_encoding, metadata, metadata_dropout_prob,
            metadata_variations, metadata_kwargs, metadata_max_length,
        )

    def _finish_call(
        self, beatmap_encoding, metadata, metadata_dropout_prob,
        metadata_variations, metadata_kwargs, metadata_max_length,
    ):
        """Metadata encoding + output assembly, shared by the python and
        native beatmap paths (the tail of the reference __call__)."""
        metadata_encoding = None
        metadata_variation_classes = None
        if metadata is not None and not (isinstance(metadata, list) and any(m is None for m in metadata)):
            if not isinstance(metadata, list):
                metadata = [metadata]

            if metadata_dropout_prob > 0.0:
                for m in metadata:
                    for key, value in m.items():
                        if value is not None and self.rng.random() < metadata_dropout_prob:
                            m[key] = None

            variation_sequences = None
            if metadata_variations > 1 and len(metadata) > 0:
                # base-splice fast path: tokenize each base once, overwrite
                # only the varied field's token per variation (identical ids
                # + rng stream to expanding the dicts and re-tokenizing)
                variation_sequences = []
                metadata_variation_classes = []
                for m in metadata:
                    seqs, m_classes = self.metadata_tokenizer.encode_variations(
                        m, metadata_variations - 1, rng=self.rng
                    )
                    variation_sequences.extend(seqs)
                    metadata_variation_classes.append(m_classes)
                assert len(variation_sequences) == len(metadata) * metadata_variations

            if len(metadata) > 0:
                if variation_sequences is not None:
                    metadata_encoding = self.metadata_tokenizer.pack_ids(
                        variation_sequences, **metadata_kwargs
                    )
                else:
                    metadata_encoding = self.metadata_tokenizer(metadata, **metadata_kwargs)
                if metadata_variations > 1:
                    # metadata still holds the B bases (the fast path never
                    # materializes the expanded dict list)
                    for k, v in metadata_encoding.items():
                        metadata_encoding[k] = v.reshape(
                            len(metadata), metadata_variations, -1
                        )
                if metadata_variation_classes is not None:
                    metadata_encoding["metadata_variation_classes"] = np.asarray(
                        metadata_variation_classes, dtype=np.int32
                    )
            else:
                metadata_encoding = BatchTokens(
                    input_ids=np.zeros((0, metadata_max_length), dtype=np.int32),
                    attention_mask=np.zeros((0, metadata_max_length), dtype=np.int32),
                )

        if metadata_encoding is not None and beatmap_encoding is not None:
            beatmap_encoding["metadata_ids"] = metadata_encoding["input_ids"]
            beatmap_encoding["metadata_attention_mask"] = metadata_encoding["attention_mask"]
            if "metadata_variation_classes" in metadata_encoding:
                beatmap_encoding["metadata_variation_classes"] = metadata_encoding["metadata_variation_classes"]
            return beatmap_encoding
        elif beatmap_encoding is not None:
            return beatmap_encoding
        return metadata_encoding

    def batch_decode(self, *args, **kwargs):
        return self.beatmap_tokenizer.batch_decode(*args, **kwargs)

    def decode(self, *args, **kwargs):
        return self.beatmap_tokenizer.decode(*args, **kwargs)

    # -------------------------------------------------------------- save/load

    def save_pretrained(self, save_directory: Union[str, PathLike]) -> list[str]:
        """Write each component into its own subfolder plus processor_config.json."""
        save_directory = Path(save_directory)
        save_directory.mkdir(parents=True, exist_ok=True)
        files = []
        for attribute_name in self.attributes:
            files += getattr(self, attribute_name).save_pretrained(save_directory / attribute_name)
        config_file = save_directory / "processor_config.json"
        write_json(
            config_file,
            {"processor_class": type(self).__name__, "default_kwargs": self.default_kwargs},
        )
        files.append(str(config_file))
        return files

    @classmethod
    def from_pretrained(cls, directory: Union[str, PathLike]) -> "CM3PProcessor":
        """Load from our native layout OR the HF/AutoProcessor layout (the
        reference's save_pretrained / interop.export_hf_processor bundles):
        the subfolder names match, the components tolerate the HF filenames
        and extra keys, and the HF default_kwargs schema (common_kwargs +
        truncation strategy strings) is normalized back to ours."""
        directory = Path(directory)
        config = read_json(directory / "processor_config.json")
        dk = config.get("default_kwargs")
        if dk:
            dk = {k: dict(v) for k, v in dk.items() if k != "common_kwargs"}
            for sub in dk.values():
                if sub.get("truncation") == "longest_first":
                    sub["truncation"] = True
                sub.pop("return_tensors", None)
                sub.pop("device", None)
        return cls(
            audio_feature_extractor=LogMelExtractor.from_pretrained(directory / "audio_feature_extractor"),
            beatmap_parser=BeatmapEventParser.from_pretrained(directory / "beatmap_parser"),
            beatmap_tokenizer=BeatmapTokenizer.from_pretrained(directory / "beatmap_tokenizer"),
            metadata_tokenizer=MetadataTokenizer.from_pretrained(directory / "metadata_tokenizer"),
            default_kwargs=dk,
        )
