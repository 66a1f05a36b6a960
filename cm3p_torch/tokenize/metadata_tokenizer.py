"""Metadata tokenizer: one quantized token per metadata field + variations.

Parity target: ``/root/reference/cm3p/tokenization_cm3p.py:305-803``.
The 14-field metadata schema maps to a fixed-order token sequence
([BOS] difficulty year mode status mapper cs hitsounded song_length
song_position global_sv mania_keycount hold_note_ratio scroll_speed_ratio
tag* [EOS]); absent fields emit their per-field ``[*_UNK]`` token.

``metadata_variations`` generates hard negatives by perturbing one field at a
time, round-robining the year / status / tags / mapper workers and padding
with empty metadata (class -1), exactly like the reference generator.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np

from ..utils.io import JsonConfigMixin
from .beatmap_tokenizer import BatchTokens, pack_sequences

# Metadata is a plain dict with these optional keys (tokenization_cm3p.py:305-336).
METADATA_FIELDS = (
    "difficulty",
    "year",
    "mode",
    "status",
    "mapper",
    "cs",
    "hitsounded",
    "song_length",
    "song_position",
    "global_sv",
    "mania_keycount",
    "hold_note_ratio",
    "scroll_speed_ratio",
    "tags",
)

Metadata = dict


def make_metadata(**fields) -> Metadata:
    """Construct a metadata dict restricted to the known schema."""
    unknown = set(fields) - set(METADATA_FIELDS)
    if unknown:
        raise ValueError(f"Unknown metadata fields: {sorted(unknown)}")
    return dict(fields)


def merge_metadata_dicts(m1: Optional[Metadata], m2: Optional[Metadata]) -> Optional[Metadata]:
    """Field-wise merge preferring non-None values of ``m1``."""
    if m1 is None:
        return m2
    if m2 is None:
        return m1
    merged = {}
    for key in METADATA_FIELDS:
        v1 = m1.get(key, None)
        v2 = m2.get(key, None)
        merged[key] = v2 if v1 is None else v1
    return merged


CORE_SPECIAL_TOKENS = ["[BOS]", "[EOS]", "[PAD]", "[CLS]"]
UNK_TOKENS = [
    "[DIFFICULTY_UNK]",
    "[YEAR_UNK]",
    "[MODE_UNK]",
    "[STATUS_UNK]",
    "[MAPPER_UNK]",
    "[CS_UNK]",
    "[HITSOUNDED_UNK]",
    "[SONG_LENGTH_UNK]",
    "[SONG_POSITION_UNK]",
    "[GLOBAL_SV_UNK]",
    "[MANIA_KEYCOUNT_UNK]",
    "[HOLD_NOTE_RATIO_UNK]",
    "[SCROLL_SPEED_RATIO_UNK]",
    "[TAG_UNK]",
]


class MetadataTokenizer(JsonConfigMixin):
    config_name = "tokenizer_config.json"

    def __init__(
        self,
        vocab: Optional[dict[str, int]] = None,
        modes: Optional[dict[int, str]] = None,
        statuses: Optional[dict[int, str]] = None,
        mappers: Optional[dict[int, str]] = None,
        tags: Optional[dict[int, dict]] = None,
        min_difficculty: float = 0.0,  # sic — keep the reference's misspelled kwarg
        max_difficulty: float = 14.0,
        difficulty_step: float = 0.1,
        min_year: int = 2000,
        max_year: int = 2023,
        max_song_length: int = 600,
        song_length_step: int = 10,
        song_position_step: float = 0.01,
        global_sv_step: float = 0.01,
        hold_note_ratio_step: float = 0.1,
        scroll_speed_ratio_step: float = 0.1,
        add_cls_token: bool = False,
        **_unused,
    ):
        self.min_difficulty = min_difficculty
        self.max_difficulty = max_difficulty
        self.difficulty_step = difficulty_step
        self.min_year = min_year
        self.max_year = max_year
        self.max_song_length = max_song_length
        self.song_length_step = song_length_step
        self.song_position_step = song_position_step
        self.global_sv_step = global_sv_step
        self.hold_note_ratio_step = hold_note_ratio_step
        self.scroll_speed_ratio_step = scroll_speed_ratio_step
        self.add_cls_token = add_cls_token

        self.bos_token = "[BOS]"
        self.eos_token = "[EOS]"
        self.pad_token = "[PAD]"
        self.cls_token = "[CLS]"

        def _intkeys(d):
            return {int(k): v for k, v in d.items()} if d else {}

        self.modes = _intkeys(modes)
        self.statuses = _intkeys(statuses)
        self.mappers = _intkeys(mappers)
        self.tags = _intkeys(tags)
        self.mode_names_to_ids = {v: k for k, v in self.modes.items()}
        self.mode_ids_to_names = dict(self.modes)
        self.status_names_to_ids = {v: k for k, v in self.statuses.items()}
        self.status_ids_to_names = dict(self.statuses)
        self.mapper_names_to_ids = {v: k for k, v in self.mappers.items()}
        self.mapper_ids_to_names = dict(self.mappers)
        self.tag_names_to_ids = {v["name"]: k for k, v in self.tags.items()}
        self.tag_ids_to_names = {k: v["name"] for k, v in self.tags.items()}

        self.vocab = dict(vocab) if vocab is not None else self._build_vocab_from_config()
        self.special_tokens = CORE_SPECIAL_TOKENS + UNK_TOKENS
        self._full_vocab = dict(self.vocab)
        for tok in self.special_tokens:
            if tok not in self._full_vocab:
                self._full_vocab[tok] = len(self._full_vocab)
        self.ids_to_tokens = {i: t for t, i in self._full_vocab.items()}

    # ------------------------------------------------------------------ vocab

    def _build_vocab_from_config(self) -> dict[str, int]:
        vocab: list[str] = []

        for difficulty in np.arange(self.min_difficulty, self.max_difficulty + 1e-5, self.difficulty_step):
            vocab.append(f"[DIFFICULTY_{difficulty:.1f}]")
        for year in range(self.min_year, self.max_year + 1):
            vocab.append(f"[YEAR_{year}]")
        for mode in self.mode_ids_to_names.values():
            vocab.append(f"[MODE_{mode}]")
        for status in self.status_ids_to_names.values():
            vocab.append(f"[STATUS_{status}]")
        for mapper in self.mapper_ids_to_names.keys():
            vocab.append(f"[MAPPER_{mapper}]")
        for cs in np.arange(0.0, 10.0 + 1e-5, 0.1):
            vocab.append(f"[CS_{cs:.1f}]")
        for hitsounded in [True, False]:
            vocab.append(f"[HITSOUNDED_{str(hitsounded).upper()}]")
        for song_length in np.arange(0, self.max_song_length + 1e-5, self.song_length_step):
            vocab.append(f"[SONG_LENGTH_{int(song_length)}]")
        for song_position in np.arange(0.0, 1.0 + 1e-5, self.song_position_step):
            vocab.append(f"[SONG_POSITION_{song_position:.2f}]")
        for global_sv in np.arange(0.4, 3.6 + 1e-5, self.global_sv_step):
            vocab.append(f"[GLOBAL_SV_{global_sv:.2f}]")
        for mania_keycount in range(1, 19):
            vocab.append(f"[MANIA_KEYCOUNT_{mania_keycount}]")
        for hold_note_ratio in np.arange(0.0, 1.0 + 1e-5, self.hold_note_ratio_step):
            vocab.append(f"[HOLD_NOTE_RATIO_{hold_note_ratio:.1f}]")
        for scroll_speed_ratio in np.arange(0.0, 1.0 + 1e-5, self.scroll_speed_ratio_step):
            vocab.append(f"[SCROLL_SPEED_RATIO_{scroll_speed_ratio:.1f}]")
        for tag in self.tag_ids_to_names.values():
            vocab.append(f"[TAG_{tag}]")

        return {token: idx for idx, token in enumerate(vocab)}

    @property
    def vocab_size(self) -> int:
        return len(self._full_vocab)

    def get_vocab(self) -> dict[str, int]:
        return dict(self._full_vocab)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._full_vocab.get(tokens)
        return [self._full_vocab.get(t) for t in tokens]

    @property
    def pad_token_id(self) -> int:
        return self._full_vocab[self.pad_token]

    @property
    def bos_token_id(self) -> int:
        return self._full_vocab[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self._full_vocab[self.eos_token]

    # ------------------------------------------------------- field tokenizers

    def _tokenize_difficulty(self, m: Metadata) -> str:
        v = m.get("difficulty", None)
        if v is None:
            return "[DIFFICULTY_UNK]"
        v = min(max(v, self.min_difficulty), self.max_difficulty)
        v = round(v / self.difficulty_step) * self.difficulty_step
        return f"[DIFFICULTY_{v:.1f}]"

    def _tokenize_year(self, m: Metadata) -> str:
        v = m.get("year", None)
        if v is None:
            return "[YEAR_UNK]"
        return f"[YEAR_{int(min(max(v, self.min_year), self.max_year))}]"

    def _tokenize_mode(self, m: Metadata) -> str:
        v = m.get("mode", None)
        if isinstance(v, (int, np.integer)):
            v = self.mode_ids_to_names.get(int(v), None)
        if v is None or v not in self.mode_names_to_ids:
            return "[MODE_UNK]"
        return f"[MODE_{v}]"

    def _tokenize_status(self, m: Metadata) -> str:
        v = m.get("status", None)
        if isinstance(v, (int, np.integer)):
            v = self.status_ids_to_names.get(int(v), None)
        if v is None or v not in self.status_names_to_ids:
            return "[STATUS_UNK]"
        return f"[STATUS_{v}]"

    def _tokenize_mapper(self, m: Metadata) -> str:
        v = m.get("mapper", None)
        if isinstance(v, str):
            v = self.mapper_names_to_ids.get(v, None)
        if v is None or v not in self.mapper_ids_to_names:
            return "[MAPPER_UNK]"
        return f"[MAPPER_{v}]"

    def _tokenize_cs(self, m: Metadata) -> str:
        v = m.get("cs", None)
        if v is None:
            return "[CS_UNK]"
        v = min(max(v, 0.0), 10.0)
        v = round(v / 0.1) * 0.1
        return f"[CS_{v:.1f}]"

    def _tokenize_hitsounded(self, m: Metadata) -> str:
        v = m.get("hitsounded", None)
        if v is None:
            return "[HITSOUNDED_UNK]"
        return f"[HITSOUNDED_{str(bool(v)).upper()}]"

    def _tokenize_song_length(self, m: Metadata) -> str:
        v = m.get("song_length", None)
        if v is None:
            return "[SONG_LENGTH_UNK]"
        v = min(max(v, 0), self.max_song_length)
        v = round(v / self.song_length_step) * self.song_length_step
        return f"[SONG_LENGTH_{int(v)}]"

    def _tokenize_song_position(self, m: Metadata) -> str:
        v = m.get("song_position", None)
        if v is None:
            return "[SONG_POSITION_UNK]"
        v = min(max(v, 0.0), 1.0)
        v = round(v / self.song_position_step) * self.song_position_step
        return f"[SONG_POSITION_{v:.2f}]"

    def _tokenize_global_sv(self, m: Metadata) -> str:
        v = m.get("global_sv", None)
        if v is None:
            return "[GLOBAL_SV_UNK]"
        v = min(max(v, 0.4), 3.6)
        v = round(v / self.global_sv_step) * self.global_sv_step
        return f"[GLOBAL_SV_{v:.2f}]"

    def _tokenize_mania_keycount(self, m: Metadata) -> str:
        v = m.get("mania_keycount", None)
        if v is None:
            return "[MANIA_KEYCOUNT_UNK]"
        return f"[MANIA_KEYCOUNT_{int(min(max(int(v), 1), 18))}]"

    def _tokenize_hold_note_ratio(self, m: Metadata) -> str:
        v = m.get("hold_note_ratio", None)
        if v is None:
            return "[HOLD_NOTE_RATIO_UNK]"
        v = min(max(v, 0.0), 1.0)
        v = round(v / self.hold_note_ratio_step) * self.hold_note_ratio_step
        return f"[HOLD_NOTE_RATIO_{v:.1f}]"

    def _tokenize_scroll_speed_ratio(self, m: Metadata) -> str:
        v = m.get("scroll_speed_ratio", None)
        if v is None:
            return "[SCROLL_SPEED_RATIO_UNK]"
        v = min(max(v, 0.0), 1.0)
        v = round(v / self.scroll_speed_ratio_step) * self.scroll_speed_ratio_step
        return f"[SCROLL_SPEED_RATIO_{v:.1f}]"

    def _validate_tags(self, tags) -> Optional[list[str]]:
        if tags is None:
            return None
        new_tags = []
        for tag in tags:
            if isinstance(tag, str) and tag in self.tag_names_to_ids:
                new_tags.append(tag)
            elif tag in self.tag_ids_to_names:
                new_tags.append(self.tag_ids_to_names[tag])
        return new_tags

    def _tokenize_tags(self, m: Metadata) -> list[str]:
        valid_tags = self._validate_tags(m.get("tags", None))
        if not valid_tags:
            return ["[TAG_UNK]"]
        return [f"[TAG_{tag}]" for tag in valid_tags]

    def tokenize_metadata(self, m: Metadata) -> list[str]:
        tokens: list[str] = []
        if self.add_cls_token:
            tokens.append(self.cls_token)
        tokens.extend(
            [
                self.bos_token,
                self._tokenize_difficulty(m),
                self._tokenize_year(m),
                self._tokenize_mode(m),
                self._tokenize_status(m),
                self._tokenize_mapper(m),
                self._tokenize_cs(m),
                self._tokenize_hitsounded(m),
                self._tokenize_song_length(m),
                self._tokenize_song_position(m),
                self._tokenize_global_sv(m),
                self._tokenize_mania_keycount(m),
                self._tokenize_hold_note_ratio(m),
                self._tokenize_scroll_speed_ratio(m),
            ]
        )
        tokens.extend(self._tokenize_tags(m))
        tokens.append(self.eos_token)
        return tokens

    def __call__(
        self,
        metadata: Union[Metadata, list[Metadata]],
        padding: str = "longest",
        truncation: bool = True,
        max_length: Optional[int] = None,
        pad_to_multiple_of: Optional[int] = None,
        **_unused,
    ) -> BatchTokens:
        if isinstance(metadata, dict):
            metadata = [metadata]
        sequences = [self.convert_tokens_to_ids(self.tokenize_metadata(m)) for m in metadata]
        return pack_sequences(
            sequences,
            pad_id=self.pad_token_id,
            padding=padding,
            truncation=truncation,
            max_length=max_length,
            pad_to_multiple_of=pad_to_multiple_of,
        )

    # -------------------------------------------------------------- variations

    def encode_variations(
        self, metadata: Metadata, num_variations: int, rng: Optional[np.random.Generator] = None
    ) -> tuple[list[list[int]], list[int]]:
        """Token-id sequences for ``[base] + num_variations`` perturbations,
        plus their classes (``[0] + ...``).

        Identical ids to tokenizing each :meth:`metadata_variations` dict in
        full (asserted by tests/test_tokenizers.py), at base-splice cost:
        every variation differs from the base in exactly ONE field, so the
        base is tokenized once and only the varied field's token is
        recomputed — the year/status/mapper slot is overwritten in place and
        a tags variation re-derives just the tag tail. ~10x less host work
        at the training V=256 expansion. rng consumption is unchanged (the
        dicts still come from the same generator), so seeded data streams
        are byte-stable vs the slow path.
        """
        base_ids = self.convert_tokens_to_ids(self.tokenize_metadata(metadata))
        off = 1 if self.add_cls_token else 0  # [CLS?] BOS diff year mode status mapper ...
        tags_start = off + 14  # BOS + 13 fixed field slots (tokenize_metadata order)
        vocab = self._full_vocab
        eos_id = self.eos_token_id
        seqs: list[list[int]] = [base_ids]
        classes: list[int] = [0]
        empty_ids: Optional[list[int]] = None
        for m, cls in self.metadata_variations(metadata, num_variations, rng=rng):
            if cls == 1:  # year
                ids = base_ids.copy()
                ids[off + 2] = vocab.get(self._tokenize_year(m))
            elif cls == 2:  # status
                ids = base_ids.copy()
                ids[off + 4] = vocab.get(self._tokenize_status(m))
            elif cls == 4:  # mapper
                ids = base_ids.copy()
                ids[off + 5] = vocab.get(self._tokenize_mapper(m))
            elif cls == 3:  # tags: re-derive the variable tail
                ids = base_ids[:tags_start] + [vocab.get(t) for t in self._tokenize_tags(m)]
                ids.append(eos_id)
            elif cls == -1:  # empty-metadata padding: constant sequence
                if empty_ids is None:
                    empty_ids = self.convert_tokens_to_ids(self.tokenize_metadata(m))
                ids = empty_ids
            else:  # future class: fall back to the full tokenize
                ids = self.convert_tokens_to_ids(self.tokenize_metadata(m))
            seqs.append(ids)
            classes.append(cls)
        return seqs, classes

    def pack_ids(
        self,
        sequences: list[list[int]],
        padding: str = "longest",
        truncation: bool = True,
        max_length: Optional[int] = None,
        pad_to_multiple_of: Optional[int] = None,
        **_unused,
    ) -> BatchTokens:
        """Batch pre-encoded id sequences with ``__call__``'s packing kwargs."""
        return pack_sequences(
            sequences,
            pad_id=self.pad_token_id,
            padding=padding,
            truncation=truncation,
            max_length=max_length,
            pad_to_multiple_of=pad_to_multiple_of,
        )

    def metadata_variations(
        self, metadata: Metadata, num_variations: int = 1000, rng: Optional[np.random.Generator] = None
    ) -> Iterator[tuple[Metadata, int]]:
        """Yield (variation, class) single-field perturbations.

        Classes: 1 year, 2 status, 3 tags (replace/add/remove), 4 mapper,
        -1 empty padding. The four workers are drained round-robin
        (tokenization_cm3p.py:691-780).
        """
        rng = rng or np.random.default_rng()

        # Variations are shallow dict copies: every field value is an
        # immutable scalar/string except `tags`, which is list-copied before
        # any mutation, so no variation aliases the base metadata's state.
        # Semantically identical to the reference's per-variation deepcopy
        # (tokenization_cm3p.py:691-780) at a fraction of the host cost —
        # at V=256 train variations the deepcopies were a measurable slice
        # of the data-worker profile.

        def year_variations():
            min_year = max(2007, self.min_year)
            year = metadata.get("year", None)
            if year is None or (min_year > year or year > self.max_year):
                return
            for y in range(min_year, self.max_year + 1):
                if y != year:
                    new_m = dict(metadata)
                    new_m["year"] = y
                    yield new_m, 1

        def status_variations():
            status = metadata.get("status", None)
            if status is None:
                return
            current = self.status_ids_to_names.get(status, None) or status
            if current not in self.status_names_to_ids:
                return
            for s in self.status_ids_to_names.values():
                if s != current:
                    new_m = dict(metadata)
                    new_m["status"] = s
                    yield new_m, 2

        def tags_variations():
            tags = metadata.get("tags", None)
            if tags is None or len(tags) <= 0:
                return
            current_tags = self._validate_tags(tags)
            if len(current_tags) <= 0:
                return
            for tag in self.tag_ids_to_names.values():
                if tag not in current_tags:
                    new_m = dict(metadata)
                    new_tags = list(metadata["tags"])
                    new_tags[int(rng.integers(0, len(new_tags)))] = tag
                    new_m["tags"] = new_tags
                    yield new_m, 3
            for tag in self.tag_ids_to_names.values():
                if tag not in current_tags:
                    new_m = dict(metadata)
                    new_tags = list(metadata["tags"])
                    new_tags.insert(int(rng.integers(0, len(new_tags) + 1)), tag)
                    new_m["tags"] = new_tags
                    yield new_m, 3
            if len(current_tags) <= 1:
                return
            for tag in current_tags:
                new_m = dict(metadata)
                new_m["tags"] = [t for t in current_tags if t != tag]
                yield new_m, 3

        def mapper_variations():
            mapper = metadata.get("mapper", None)
            if mapper is None:
                return
            current = self.mapper_names_to_ids.get(mapper, None) or mapper
            candidates = list(self.mapper_ids_to_names.keys())
            if current in self.mapper_ids_to_names:
                candidates.remove(current)
            rng.shuffle(candidates)
            for mp in candidates:
                new_m = dict(metadata)
                new_m["mapper"] = mp
                yield new_m, 4

        count = 0
        workers = [year_variations(), status_variations(), tags_variations(), mapper_variations()]
        index = 0
        while count < num_variations and len(workers) > 0:
            try:
                index = index % len(workers)
                item = next(workers[index])
                index += 1
                count += 1
                yield item
            except StopIteration:
                workers.remove(workers[index])

        while count < num_variations:
            count += 1
            yield {}, -1

    # -------------------------------------------------------------- save/load

    def get_config(self) -> dict:
        return {
            "modes": self.modes,
            "statuses": self.statuses,
            "mappers": self.mappers,
            "tags": self.tags,
            "min_difficculty": self.min_difficulty,
            "max_difficulty": self.max_difficulty,
            "difficulty_step": self.difficulty_step,
            "min_year": self.min_year,
            "max_year": self.max_year,
            "max_song_length": self.max_song_length,
            "song_length_step": self.song_length_step,
            "song_position_step": self.song_position_step,
            "global_sv_step": self.global_sv_step,
            "hold_note_ratio_step": self.hold_note_ratio_step,
            "scroll_speed_ratio_step": self.scroll_speed_ratio_step,
            "add_cls_token": self.add_cls_token,
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
