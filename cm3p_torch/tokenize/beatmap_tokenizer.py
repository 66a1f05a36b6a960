"""Beatmap event tokenizer.

Builds the structured vocabulary programmatically (event types, quantized
time shifts / snappings / distances / positions / scroll speeds, hitsounds,
volumes) and serializes ``Group`` streams into token-id sequences. Parity
target: ``/root/reference/cm3p/tokenization_cm3p.py:14-302``, including the
exact vocab ordering and special-token placement (base vocab first, then the
seven core specials and the three audio specials, matching HF's added-token
numbering so converted checkpoints line up).

Outputs are numpy int32 arrays with static, bucketable shapes — the TPU
pipeline never sees ragged batches.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from ..beatmap.events import EVENT_TYPES_WITH_NEW_COMBO, EventType, Group
from ..utils.io import JsonConfigMixin

# HF appends specials in declaration order: the seven named ones, then
# additional_special_tokens (tokenization_cm3p.py:55-67).
CORE_SPECIAL_TOKENS = ["[BOS]", "[EOS]", "[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]"]
AUDIO_SPECIAL_TOKENS = ["[AUDIO_BOS]", "[AUDIO_EOS]", "[AUDIO]"]


class BatchTokens(dict):
    """Dict of numpy arrays with attribute access (input_ids, attention_mask)."""

    def __getattr__(self, item):
        try:
            return self[item]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(item) from e


class BeatmapTokenizer(JsonConfigMixin):
    config_name = "tokenizer_config.json"

    def __init__(
        self,
        vocab: Optional[dict[str, int]] = None,
        min_time: int = 0,
        max_time: int = 30000,
        time_step: int = 10,
        max_distance: int = 640,
        distance_step: int = 4,
        position_range: tuple[int, int, int, int] = (-256, 768, -256, 640),
        position_step: int = 4,
        position_split_axes: bool = True,
        add_cls_token: bool = False,
        separate_new_combo_token: bool = True,
        **_unused,
    ):
        self.min_time = min_time
        self.max_time = max_time
        self.time_step = time_step
        self.max_distance = max_distance
        self.distance_step = distance_step
        self.position_range = tuple(position_range)
        self.position_step = position_step
        self.position_split_axes = position_split_axes
        self.add_cls_token = add_cls_token
        self.separate_new_combo_token = separate_new_combo_token

        self.bos_token = "[BOS]"
        self.eos_token = "[EOS]"
        self.unk_token = "[UNK]"
        self.sep_token = "[SEP]"
        self.pad_token = "[PAD]"
        self.cls_token = "[CLS]"
        self.mask_token = "[MASK]"
        self.audio_bos_token = "[AUDIO_BOS]"
        self.audio_eos_token = "[AUDIO_EOS]"
        self.audio_token = "[AUDIO]"

        self.vocab = dict(vocab) if vocab is not None else self._build_vocab_from_config()
        # specials live after the base vocab, HF added-token style
        self.special_tokens = CORE_SPECIAL_TOKENS + AUDIO_SPECIAL_TOKENS
        self._full_vocab = dict(self.vocab)
        for tok in self.special_tokens:
            if tok not in self._full_vocab:
                self._full_vocab[tok] = len(self._full_vocab)
        self.ids_to_tokens = {i: t for t, i in self._full_vocab.items()}

        # hot-loop id memos: every emitted family has a bounded domain, so
        # the f-string + vocab lookup run at most once per distinct quantized
        # value and the serializer appends vocab IDS directly (the string
        # stage the reference pays per token is derived only on demand, see
        # tokenize_groups). Keys are the post-clamp quantized ints — the
        # clamp/round math (the tokenization CONTRACT) still runs per call.
        unk = self._full_vocab[self.unk_token]
        self._unk_id = unk
        vocab_get = self._full_vocab.get
        self._event_ids = {et: vocab_get(f"[{et.value.upper()}]", unk) for et in EventType}
        self._event_nc_ids = {
            et: vocab_get(f"[{et.value.upper()}_NEW_COMBO]", unk)
            for et in EVENT_TYPES_WITH_NEW_COMBO
        }
        self._snap_ids = {s: vocab_get(f"[SNAPPING_{s}]", unk) for s in range(0, 17)}
        self._vol_ids = {v: vocab_get(f"[VOLUME_{v}]", unk) for v in range(101)}
        self._memo_ts: dict[int, int] = {}
        self._memo_dist: dict[int, int] = {}
        self._memo_pos: dict = {}
        self._memo_ss: dict[int, int] = {}
        self._memo_hs: dict[tuple, int] = {}

    # ------------------------------------------------------------------ vocab

    def _build_vocab_from_config(self) -> dict[str, int]:
        vocab: list[str] = []

        for event_type in EventType:
            vocab.append(f"[{event_type.value.upper()}]")

        if not self.separate_new_combo_token:
            for event_type in EVENT_TYPES_WITH_NEW_COMBO:
                vocab.append(f"[{event_type.value.upper()}_NEW_COMBO]")

        for time in np.arange(self.min_time, self.max_time + 1e-5, self.time_step):
            vocab.append(f"[TIME_SHIFT_{int(time)}]")

        for snapping in range(0, 17):
            vocab.append(f"[SNAPPING_{snapping}]")

        for distance in range(0, self.max_distance + 1):
            vocab.append(f"[DISTANCE_{distance}]")

        if self.position_split_axes:
            for x in np.arange(self.position_range[0], self.position_range[1] + 1e-5, self.position_step):
                vocab.append(f"[POS_X_{int(x)}]")
            for y in np.arange(self.position_range[2], self.position_range[3] + 1e-5, self.position_step):
                vocab.append(f"[POS_Y_{int(y)}]")
        else:
            for x in np.arange(self.position_range[0], self.position_range[1] + 1e-5, self.position_step):
                for y in np.arange(self.position_range[2], self.position_range[3] + 1e-5, self.position_step):
                    vocab.append(f"[POS_{int(x)}_{int(y)}]")

        for mania_column in range(1, 19):
            vocab.append(f"[MANIA_COLUMN_{mania_column}]")

        for scroll_speed in np.arange(0.0, 10.0 + 1e-5, 0.01):
            vocab.append(f"[SCROLL_SPEED_{scroll_speed:.2f}]")

        if self.separate_new_combo_token:
            vocab.append("[NEW_COMBO]")

        for hitsound in range(8):
            for sampleset in range(1, 4):
                for additions in range(1, 4):
                    vocab.append(f"[HITSOUND_{hitsound << 1}_{sampleset}_{additions}]")

        for volume in range(101):
            vocab.append(f"[VOLUME_{volume}]")

        return {token: idx for idx, token in enumerate(vocab)}

    @property
    def vocab_size(self) -> int:
        return len(self._full_vocab)

    def get_vocab(self) -> dict[str, int]:
        return dict(self._full_vocab)

    def convert_tokens_to_ids(self, tokens: Union[str, Sequence[str]]):
        vocab = self._full_vocab
        unk = vocab.get(self.unk_token)
        if isinstance(tokens, str):
            return vocab.get(tokens, unk)
        return [vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: Union[int, Sequence[int]]):
        if isinstance(ids, (int, np.integer)):
            return self.ids_to_tokens.get(int(ids), self.unk_token)
        return [self.ids_to_tokens.get(int(i), self.unk_token) for i in ids]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False) -> str:
        tokens = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            specials = set(self.special_tokens)
            tokens = [t for t in tokens if t not in specials]
        return " ".join(tokens)

    def batch_decode(self, batch_ids, **kwargs) -> list[str]:
        return [self.decode(ids, **kwargs) for ids in batch_ids]

    @property
    def pad_token_id(self) -> int:
        return self._full_vocab[self.pad_token]

    @property
    def bos_token_id(self) -> int:
        return self._full_vocab[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self._full_vocab[self.eos_token]

    @property
    def mask_token_id(self) -> int:
        return self._full_vocab[self.mask_token]

    @property
    def audio_token_id(self) -> int:
        return self._full_vocab[self.audio_token]

    @property
    def all_special_ids(self) -> list[int]:
        return [self._full_vocab[t] for t in self.special_tokens]

    # ------------------------------------------------------------ tokenizing

    # NB: quantizers use builtin min/max, not np.clip — same result for the
    # scalar ints/floats the parser emits, ~20x cheaper (np.clip boxes every
    # scalar into a 0-d array; it was ~16% of the host pipeline, measured by
    # tools/bench_host_pipeline.py). Bit-parity pinned by
    # tests/test_tokenizer_parity.py.

    def _tokenize_time_shift(self, time: float) -> int:
        time = min(max(time, self.min_time), self.max_time)
        t = int(round(time / self.time_step) * self.time_step)
        tok = self._memo_ts.get(t)
        if tok is None:
            tok = self._memo_ts[t] = self._full_vocab.get(f"[TIME_SHIFT_{t}]", self._unk_id)
        return tok

    def _tokenize_distance(self, distance: int) -> int:
        distance = min(max(distance, 0), self.max_distance)
        distance = round(distance / self.distance_step) * self.distance_step
        tok = self._memo_dist.get(distance)
        if tok is None:
            tok = self._memo_dist[distance] = self._full_vocab.get(
                f"[DISTANCE_{distance}]", self._unk_id
            )
        return tok

    def _tokenize_position(self, pos_x: int, pos_y: int):
        pos_x = min(max(pos_x, self.position_range[0]), self.position_range[1])
        pos_y = min(max(pos_y, self.position_range[2]), self.position_range[3])
        pos_x = int(round(pos_x / self.position_step) * self.position_step)
        pos_y = int(round(pos_y / self.position_step) * self.position_step)
        vocab = self._full_vocab
        if self.position_split_axes:
            tok = self._memo_pos.get(("x", pos_x))
            if tok is None:
                tok = self._memo_pos[("x", pos_x)] = vocab.get(f"[POS_X_{pos_x}]", self._unk_id)
            yield tok
            tok = self._memo_pos.get(("y", pos_y))
            if tok is None:
                tok = self._memo_pos[("y", pos_y)] = vocab.get(f"[POS_Y_{pos_y}]", self._unk_id)
            yield tok
        else:
            tok = self._memo_pos.get((pos_x, pos_y))
            if tok is None:
                tok = self._memo_pos[(pos_x, pos_y)] = vocab.get(
                    f"[POS_{pos_x}_{pos_y}]", self._unk_id
                )
            yield tok

    def _tokenize_mania_column(self, mania_column: int) -> int:
        c = int(min(max(mania_column, 1), 18))
        return self._full_vocab.get(f"[MANIA_COLUMN_{c}]", self._unk_id)

    def _tokenize_scroll_speed(self, scroll_speed: float) -> int:
        scroll_speed = min(max(scroll_speed, 0.0), 10.0)
        key = round(scroll_speed / 0.01)
        tok = self._memo_ss.get(key)
        if tok is None:
            tok = self._memo_ss[key] = self._full_vocab.get(
                f"[SCROLL_SPEED_{key * 0.01:.2f}]", self._unk_id
            )
        return tok

    def _tokenize_hitsound(self, hitsound: int, sampleset: int, addition: int) -> int:
        # clamp BEFORE keying so the memo is bounded at 8*3*3 entries even
        # for unclamped producers (loader workers are long-lived)
        h = int(min(max(hitsound >> 1, 0), 7)) << 1
        s = int(min(max(sampleset, 1), 3))
        a = int(min(max(addition, 1), 3))
        key = (h, s, a)
        tok = self._memo_hs.get(key)
        if tok is None:
            tok = self._memo_hs[key] = self._full_vocab.get(
                f"[HITSOUND_{h}_{s}_{a}]", self._unk_id
            )
        return tok

    def encode_groups(self, groups: list[Group], window_start_ms: Optional[int] = None) -> list[int]:
        """Serialize one window of groups straight to vocab ids.

        This is the authoritative serializer (the string form in
        ``tokenize_groups`` derives from it): emitting ids directly skips
        the reference's per-token string stage + second vocab lookup
        (``tokenization_cm3p.py:166-207`` builds strings, then
        ``convert_tokens_to_ids`` maps them), which measured ~35% of the
        tokenizer's host time."""
        window_start_ms = window_start_ms or 0
        vocab = self._full_vocab
        ids: list[int] = []
        append = ids.append
        if self.add_cls_token:
            append(vocab[self.cls_token])
        append(vocab[self.bos_token])

        event_ids = self._event_ids
        event_nc_ids = self._event_nc_ids
        snap_ids = self._snap_ids
        vol_ids = self._vol_ids
        unk = self._unk_id
        sep_nc = self.separate_new_combo_token
        nc_id = vocab.get("[NEW_COMBO]", unk) if sep_nc else None

        for group in groups:
            if (
                group.new_combo
                and not sep_nc
                and group.event_type in EVENT_TYPES_WITH_NEW_COMBO
            ):
                append(event_nc_ids[group.event_type])
            else:
                append(event_ids[group.event_type])
            if group.has_time:
                append(self._tokenize_time_shift(group.time - window_start_ms))
                if group.snapping is not None:
                    s = group.snapping
                    tok = snap_ids.get(s)
                    append(vocab.get(f"[SNAPPING_{s}]", unk) if tok is None else tok)
            if group.distance is not None:
                append(self._tokenize_distance(group.distance))
            if group.x is not None and group.y is not None:
                ids.extend(self._tokenize_position(group.x, group.y))
            if group.mania_column is not None:
                append(self._tokenize_mania_column(group.mania_column))
            if group.new_combo and sep_nc:
                append(nc_id)
            if group.scroll_speed is not None:
                append(self._tokenize_scroll_speed(group.scroll_speed))
            for h, s, a, v in zip(group.hitsounds, group.samplesets, group.additions, group.volumes):
                append(self._tokenize_hitsound(h, s, a))
                tok = vol_ids.get(v)
                append(vocab.get(f"[VOLUME_{v}]", unk) if tok is None else tok)

        append(vocab[self.eos_token])
        return ids

    def tokenize_groups(self, groups: list[Group], window_start_ms: Optional[int] = None) -> list[str]:
        """Serialize one window of groups to token strings.

        Derived from :meth:`encode_groups` (ids are authoritative); any
        out-of-vocab family value therefore renders as ``[UNK]`` rather than
        the raw formatted string — identical to what the id stream encodes."""
        return self.convert_ids_to_tokens(self.encode_groups(groups, window_start_ms))

    def _encode_single(
        self,
        groups: list[Group],
        window_start_ms: Optional[int] = None,
        num_audio_tokens: Optional[int] = None,
    ) -> list[int]:
        token_ids = self.encode_groups(groups, window_start_ms)
        if num_audio_tokens is not None and num_audio_tokens > 0:
            vocab = self._full_vocab
            token_ids = (
                [vocab[self.audio_bos_token]]
                + [vocab[self.audio_token]] * num_audio_tokens
                + [vocab[self.audio_eos_token]]
                + token_ids
            )
        return token_ids

    def __call__(
        self,
        groups: Union[list[Group], list[list[Group]]],
        window_start_ms: Optional[Union[int, list[int]]] = None,
        num_audio_tokens: Optional[Union[int, list[int]]] = None,
        padding: str = "longest",
        truncation: bool = True,
        max_length: Optional[int] = None,
        pad_to_multiple_of: Optional[int] = None,
        **_unused,
    ) -> BatchTokens:
        """Encode one or more windows into padded id/mask arrays."""
        if len(groups) == 0:
            raise ValueError("Input groups list is empty.")

        if all(isinstance(g, Group) for g in groups):
            sequences = [self._encode_single(groups, window_start_ms, num_audio_tokens)]
        else:
            n = len(groups)
            window_start_ms = window_start_ms if window_start_ms is not None else [None] * n
            num_audio_tokens = num_audio_tokens if num_audio_tokens is not None else [None] * n
            if len(window_start_ms) != n or len(num_audio_tokens) != n:
                raise ValueError("window_start_ms / num_audio_tokens length must match groups")
            sequences = [
                self._encode_single(g, w, a) for g, w, a in zip(groups, window_start_ms, num_audio_tokens)
            ]

        return pack_sequences(
            sequences,
            pad_id=self.pad_token_id,
            padding=padding,
            truncation=truncation,
            max_length=max_length,
            pad_to_multiple_of=pad_to_multiple_of,
        )

    # -------------------------------------------------------------- save/load

    def get_config(self) -> dict:
        return {
            "min_time": self.min_time,
            "max_time": self.max_time,
            "time_step": self.time_step,
            "max_distance": self.max_distance,
            "distance_step": self.distance_step,
            "position_range": list(self.position_range),
            "position_step": self.position_step,
            "position_split_axes": self.position_split_axes,
            "add_cls_token": self.add_cls_token,
            "separate_new_combo_token": self.separate_new_combo_token,
        }

    def _save_extra(self, save_directory: Path) -> list[str]:
        vocab_file = Path(save_directory) / "vocab.json"
        with open(vocab_file, "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        return [str(vocab_file)]

    @classmethod
    def _load_extra(cls, directory: Path, config: dict) -> dict:
        vocab_file = Path(directory) / "vocab.json"
        if vocab_file.exists():
            with open(vocab_file, "r", encoding="utf-8") as f:
                config["vocab"] = json.load(f)
        return config


def pack_sequences(
    sequences: list[list[int]],
    pad_id: int,
    padding: str = "longest",
    truncation: bool = True,
    max_length: Optional[int] = None,
    pad_to_multiple_of: Optional[int] = None,
) -> BatchTokens:
    """Truncate/pad variable-length id sequences into rectangular arrays."""
    if truncation and max_length is not None:
        sequences = [s[:max_length] for s in sequences]

    longest = max(len(s) for s in sequences)
    if padding == "max_length" and max_length is not None:
        target = max_length
    else:
        target = longest
    if pad_to_multiple_of:
        target = -(-target // pad_to_multiple_of) * pad_to_multiple_of

    input_ids = np.full((len(sequences), target), pad_id, dtype=np.int32)
    attention_mask = np.zeros((len(sequences), target), dtype=np.int32)
    for i, seq in enumerate(sequences):
        n = min(len(seq), target)
        input_ids[i, :n] = seq[:n]
        attention_mask[i, :n] = 1
    return BatchTokens(input_ids=input_ids, attention_mask=attention_mask)
