"""``CM3PConfig`` <-> the nested HF ``config.json``.

The port's copy of the JAX package's ``hf_config_dict`` (``interop/hf_export.py``)
and ``hf_config_to_cm3p`` (``interop/hf_import.py``): the reference's nested
composition (metadata_config / beatmap_config / audio_config) with
``auto_map`` entries naming the reference's dynamic modules, or the flat
``CM3PBeatmap`` layout of an MLM/classifier bundle.
"""
from __future__ import annotations

import dataclasses

from ..configs import AudioConfig, BeatmapConfig, CM3PConfig, MetadataConfig

_DROP_KEYS = {"tie_word_embeddings"}  # handled at the top level by HF


def _encoder_dict(cfg, extra_drop=()) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in _DROP_KEYS and k not in extra_drop}


def default_architecture(cfg) -> str:
    """The reference class that loads a checkpoint of this config type."""
    if hasattr(cfg, "beatmap_config"):
        return "CM3PModel"
    if getattr(cfg, "num_labels", 0) > 0 and getattr(cfg, "problem_type", None):
        return "CM3PForBeatmapClassification"
    return "CM3PForMaskedLM"


def hf_config_dict(cfg, architecture: str = "CM3PModel", include_auto_map: bool = True) -> dict:
    """Reference-compatible ``config.json`` payload for a nested CM3PConfig
    (``model_type: CM3P``) or a flat BeatmapConfig (``model_type: CM3PBeatmap``)."""
    if not hasattr(cfg, "beatmap_config"):
        flat = _encoder_dict(cfg, extra_drop=("audio_config",))
        flat["audio_config"] = _encoder_dict(cfg.audio_config)
        flat["audio_config"]["model_type"] = "CM3PAudio"
        flat["model_type"] = "CM3PBeatmap"
        flat["architectures"] = [architecture]
        flat["torch_dtype"] = "float32"
        flat["tie_word_embeddings"] = bool(getattr(cfg, "tie_word_embeddings", False))
        if include_auto_map:
            auto_model_key = {
                "CM3PForMaskedLM": "AutoModelForMaskedLM",
                "CM3PForBeatmapClassification": "AutoModelForSequenceClassification",
            }.get(architecture, "AutoModel")
            flat["auto_map"] = {
                "AutoConfig": "configuration_cm3p.CM3PBeatmapConfig",
                auto_model_key: "modeling_cm3p." + architecture,
            }
        return flat
    beatmap = _encoder_dict(cfg.beatmap_config, extra_drop=("audio_config",))
    beatmap["audio_config"] = _encoder_dict(cfg.beatmap_config.audio_config)
    beatmap["model_type"] = "CM3PBeatmap"
    beatmap["audio_config"]["model_type"] = "CM3PAudio"
    metadata = _encoder_dict(cfg.metadata_config)
    metadata["model_type"] = "CM3PMetadata"
    out = {
        "model_type": "CM3P",
        "architectures": [architecture],
        "projection_dim": cfg.projection_dim,
        "logit_scale_init_value": cfg.logit_scale_init_value,
        "initializer_factor": cfg.initializer_factor,
        "initializer_range": cfg.initializer_range,
        "has_decoder_head": cfg.has_decoder_head,
        "metadata_config": metadata,
        "beatmap_config": beatmap,
        "torch_dtype": "float32",
    }
    if include_auto_map:
        out["auto_map"] = {
            "AutoConfig": "configuration_cm3p.CM3PConfig",
            "AutoModel": "modeling_cm3p." + architecture,
        }
    return out


def hf_config_to_cm3p(data: dict):
    """HF-layout ``config.json`` dict -> the port's config (unknown keys dropped).

    A nested CM3PConfig for dual-tower bundles, or a flat BeatmapConfig for
    MLM/classifier bundles.
    """

    def pick(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return {k: v for k, v in d.items() if k in known}

    def beatmap_from(d: dict) -> BeatmapConfig:
        d = dict(d)
        ac = d.pop("audio_config", {}) or {}
        return BeatmapConfig(**{**pick(BeatmapConfig, d), "audio_config": AudioConfig(**pick(AudioConfig, ac))})

    if "beatmap_config" not in data and "metadata_config" not in data:
        # flat layout: the top level IS the beatmap config
        return beatmap_from(data)

    bc = dict(data.get("beatmap_config", {}))
    # HF hoists tie_word_embeddings to the top level on export; put it back
    bc.setdefault("tie_word_embeddings", bool(data.get("tie_word_embeddings", False)))
    beatmap = beatmap_from(bc)
    metadata = MetadataConfig(**pick(MetadataConfig, data.get("metadata_config", {})))
    top = pick(CM3PConfig, {k: v for k, v in data.items() if k not in ("beatmap_config", "metadata_config")})
    return CM3PConfig(metadata_config=metadata, beatmap_config=beatmap, **top)
