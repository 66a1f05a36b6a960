"""Write a processor in the reference's ``AutoProcessor`` layout.

The port's :meth:`~cm3p_torch.processing.processor.CM3PProcessor.save_pretrained`
writes its own layout; this module writes the one the reference's
``processing_cm3p.CM3PProcessor.save_pretrained`` writes, so a model trained
with the port goes back to the reference's users with a processor their
``CM3PProcessor.from_pretrained`` loads (and so does the port's). The layout:

* ``audio_feature_extractor/preprocessor_config.json`` (a stock
  ``WhisperFeatureExtractor``);
* ``beatmap_parser/preprocessor_config.json`` (``CM3PBeatmapParser``);
* ``beatmap_tokenizer/`` and ``metadata_tokenizer/``, each with
  ``tokenizer_config.json`` (``added_tokens_decoder``, the special tokens),
  ``special_tokens_map.json`` and ``vocab.json``;
* ``processor_config.json`` with the reference's ``default_kwargs`` schema.

``auto_map`` entries name the reference's dynamic modules (``parsing_cm3p``,
``tokenization_cm3p``, ``processing_cm3p``); the code files ship with the
reference package, not with the bundle. Only ``json`` and ``pathlib`` are
needed: nothing here runs on a device.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Union

__all__ = ["export_hf_processor"]

_ADDED_TOKEN_FIELDS = {
    "lstrip": False, "normalized": False, "rstrip": False,
    "single_word": False, "special": True,
}


def _write_json(path: Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=2, sort_keys=True, ensure_ascii=False)
        f.write("\n")


def _write_vocab(path: Path, vocab: dict) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(dict(vocab), f, ensure_ascii=False)


def _added_tokens_decoder(tokenizer, tokens: list) -> dict:
    """The reference tokenizer config's ``added_tokens_decoder``: id -> the special token's fields."""
    full = {t: i for i, t in tokenizer.ids_to_tokens.items()}
    return {str(full[t]): {"content": t, **_ADDED_TOKEN_FIELDS} for t in tokens}


def export_hf_processor(processor, out_dir: Union[str, Path], include_auto_map: bool = True) -> Path:
    """Write ``processor`` into ``out_dir`` in the reference's ``AutoProcessor`` layout; returns ``out_dir``.

    The vocabularies are written as they are, so the reference's
    ``CM3PProcessor.from_pretrained`` and the port's both rebuild a processor
    that tokenizes as ``processor`` does. The metadata tokenizer's minimum
    difficulty is written under the reference's own keyword spelling,
    ``min_difficculty``, so that its class reloads it. ``default_kwargs`` take
    the reference's schema: a ``common_kwargs`` entry with ``return_tensors:
    "pt"``, ``truncation: "longest_first"`` for ``True``, and the audio
    defaults (``device``, ``padding``, ``truncation``) where unset.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fe = processor.audio_feature_extractor
    parser = processor.beatmap_parser
    bt = processor.beatmap_tokenizer
    mt = processor.metadata_tokenizer

    _write_json(out / "audio_feature_extractor" / "preprocessor_config.json", {
        "chunk_length": fe.chunk_length,
        "dither": fe.dither,
        "feature_extractor_type": "WhisperFeatureExtractor",
        "feature_size": fe.feature_size,
        "hop_length": fe.hop_length,
        "n_fft": fe.n_fft,
        "n_samples": fe.chunk_length * fe.sampling_rate,
        "nb_max_frames": fe.chunk_length * fe.sampling_rate // fe.hop_length,
        "padding_side": "right",
        "padding_value": fe.padding_value,
        "processor_class": "CM3PProcessor",
        "return_attention_mask": fe.return_attention_mask,
        "sampling_rate": fe.sampling_rate,
    })

    # the reference parser has no mania-column option
    parser_cfg = {k: v for k, v in parser.get_config().items() if k != "emit_mania_column"}
    parser_cfg["feature_extractor_type"] = "CM3PBeatmapParser"
    parser_cfg["processor_class"] = "CM3PProcessor"
    if include_auto_map:
        parser_cfg["auto_map"] = {"AutoFeatureExtractor": "parsing_cm3p.CM3PBeatmapParser"}
    _write_json(out / "beatmap_parser" / "preprocessor_config.json", parser_cfg)

    audio_specials = [bt.audio_bos_token, bt.audio_eos_token, bt.audio_token]
    bt_specials = ["[BOS]", "[EOS]", "[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]", *audio_specials]
    bt_cfg = {
        "add_cls_token": bt.add_cls_token,
        "added_tokens_decoder": _added_tokens_decoder(bt, bt_specials),
        "additional_special_tokens": audio_specials,
        "bos_token": bt.bos_token, "eos_token": bt.eos_token, "unk_token": bt.unk_token,
        "sep_token": bt.sep_token, "pad_token": bt.pad_token, "cls_token": bt.cls_token,
        "mask_token": bt.mask_token,
        "clean_up_tokenization_spaces": False,
        "distance_step": bt.distance_step,
        "extra_special_tokens": {},
        "max_distance": bt.max_distance,
        "max_time": bt.max_time,
        "min_time": bt.min_time,
        "model_max_length": int(1e30),
        "position_range": list(bt.position_range),
        "position_split_axes": bt.position_split_axes,
        "position_step": bt.position_step,
        "processor_class": "CM3PProcessor",
        "separate_new_combo_token": bt.separate_new_combo_token,
        "time_step": bt.time_step,
        "tokenizer_class": "CM3PBeatmapTokenizer",
    }
    if include_auto_map:
        bt_cfg["auto_map"] = {"AutoTokenizer": ["tokenization_cm3p.CM3PBeatmapTokenizer", None]}
    _write_json(out / "beatmap_tokenizer" / "tokenizer_config.json", bt_cfg)
    _write_json(out / "beatmap_tokenizer" / "special_tokens_map.json", {
        "additional_special_tokens": audio_specials,
        "bos_token": bt.bos_token, "cls_token": bt.cls_token, "eos_token": bt.eos_token,
        "mask_token": bt.mask_token, "pad_token": bt.pad_token, "sep_token": bt.sep_token,
        "unk_token": bt.unk_token,
    })
    _write_vocab(out / "beatmap_tokenizer" / "vocab.json", bt.vocab)

    mt_unks = list(mt.special_tokens[4:])  # the per-field UNK tokens
    mt_cfg = {
        "add_cls_token": mt.add_cls_token,
        "added_tokens_decoder": _added_tokens_decoder(mt, list(mt.special_tokens)),
        "additional_special_tokens": mt_unks,
        "bos_token": mt.bos_token, "eos_token": mt.eos_token,
        "pad_token": mt.pad_token, "cls_token": mt.cls_token,
        "clean_up_tokenization_spaces": False,
        "difficulty_step": mt.difficulty_step,
        "extra_special_tokens": {},
        "global_sv_step": mt.global_sv_step,
        "hold_note_ratio_step": mt.hold_note_ratio_step,
        "mappers": {str(k): v for k, v in mt.mappers.items()},
        "max_difficulty": mt.max_difficulty,
        "max_song_length": mt.max_song_length,
        "max_year": mt.max_year,
        "min_difficculty": mt.min_difficulty,
        "min_year": mt.min_year,
        "model_max_length": int(1e30),
        "modes": {str(k): v for k, v in mt.modes.items()},
        "processor_class": "CM3PProcessor",
        "scroll_speed_ratio_step": mt.scroll_speed_ratio_step,
        "song_length_step": mt.song_length_step,
        "song_position_step": mt.song_position_step,
        "statuses": {str(k): v for k, v in mt.statuses.items()},
        "tags": {str(k): v for k, v in mt.tags.items()},
        "tokenizer_class": "CM3PMetadataTokenizer",
    }
    if include_auto_map:
        mt_cfg["auto_map"] = {"AutoTokenizer": ["tokenization_cm3p.CM3PMetadataTokenizer", None]}
    _write_json(out / "metadata_tokenizer" / "tokenizer_config.json", mt_cfg)
    _write_json(out / "metadata_tokenizer" / "special_tokens_map.json", {
        "additional_special_tokens": mt_unks,
        "bos_token": mt.bos_token, "cls_token": mt.cls_token,
        "eos_token": mt.eos_token, "pad_token": mt.pad_token,
    })
    _write_vocab(out / "metadata_tokenizer" / "vocab.json", mt.vocab)

    # the reference's _merge_kwargs reads default_kwargs["common_kwargs"] unconditionally and spells truncation
    # as the HF strategy string
    dk = {k: dict(v) for k, v in processor.default_kwargs.items()}
    for sub in dk.values():
        if sub.get("truncation") is True:
            sub["truncation"] = "longest_first"
    dk.setdefault("common_kwargs", {})["return_tensors"] = "pt"
    dk["audio_kwargs"].setdefault("device", "cpu")
    dk["audio_kwargs"].setdefault("padding", True)
    dk["audio_kwargs"].setdefault("truncation", False)
    proc_cfg = {"default_kwargs": dk, "processor_class": "CM3PProcessor"}
    if include_auto_map:
        proc_cfg["auto_map"] = {"AutoProcessor": "processing_cm3p.CM3PProcessor"}
    _write_json(out / "processor_config.json", proc_cfg)
    return out
