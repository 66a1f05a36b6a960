"""Model configuration dataclasses.

Mirrors the reference CM3P's nested config hierarchy
(``cm3p/configuration_cm3p.py``) as plain dataclasses, dropping the HF
machinery. Defaults are identical so a converted reference checkpoint loads
without surprises. The HF ``config.json`` is read and written by
:mod:`cm3p_torch.interop.hf_config`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class EncoderConfig:
    """Shared ModernBERT-style encoder hyperparameters."""

    vocab_size: int = 1000
    hidden_size: int = 256
    intermediate_size: int = 512
    num_hidden_layers: int = 6
    num_attention_heads: int = 4
    hidden_activation: str = "gelu"
    max_position_embeddings: int = 128
    initializer_range: float = 0.02
    initializer_cutoff_factor: float = 2.0
    norm_eps: float = 1e-5
    norm_bias: bool = False
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    global_rope_theta: float = 10000.0
    attention_bias: bool = False
    attention_dropout: float = 0.0
    global_attn_every_n_layers: int = 1
    local_attention: int = 128
    local_rope_theta: float = 10000.0
    embedding_dropout: float = 0.0
    mlp_bias: bool = False
    mlp_dropout: float = 0.0
    decoder_bias: bool = True
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def layer_is_global(self, layer_id: int) -> bool:
        return layer_id % self.global_attn_every_n_layers == 0

    def rope_theta_for_layer(self, layer_id: int) -> float:
        return self.global_rope_theta if self.layer_is_global(layer_id) else self.local_rope_theta


@dataclass
class MetadataConfig(EncoderConfig):
    """Metadata tower (configuration_cm3p.py:10-90)."""

    cls_embed: bool = True
    projection_dim: int = 512
    initializer_factor: float = 1.0


@dataclass
class AudioConfig(EncoderConfig):
    """Whisper-style audio encoder (configuration_cm3p.py:93-175)."""

    vocab_size: int = 1
    hidden_size: int = 512
    intermediate_size: int = 1024
    num_hidden_layers: int = 6
    num_attention_heads: int = 8
    max_position_embeddings: int = 4096
    global_rope_theta: float = 160000.0
    global_attn_every_n_layers: int = 3

    projector_intermediate_size: int = 2048  # 4 * hidden for 4x token reduction
    projector_dim: int = 768
    projector_hidden_act: str = "gelu"

    sample_rate: int = 16000
    n_ftt: int = 2048
    n_mels: int = 80
    hop_length: int = 128
    f_min: int = 0
    f_max: int = 8000
    pad_mode: str = "constant"


@dataclass
class BeatmapConfig(EncoderConfig):
    """Beatmap tower (configuration_cm3p.py:178-286)."""

    audio_config: AudioConfig = field(default_factory=AudioConfig)
    audio_sos_token_id: int = 3164
    audio_eos_token_id: int = 3165
    audio_token_id: int = 3166
    cls_embed: bool = True

    projection_dim: int = 512
    initializer_factor: float = 1.0

    vocab_size: int = 3167
    hidden_size: int = 768
    intermediate_size: int = 1152
    num_hidden_layers: int = 22
    num_attention_heads: int = 12
    max_position_embeddings: int = 8192
    global_rope_theta: float = 160000.0
    global_attn_every_n_layers: int = 3

    classifier_bias: bool = False
    classifier_activation: str = "gelu"
    sparse_prediction: bool = False
    sparse_pred_ignore_index: int = -100
    num_labels: int = 2
    problem_type: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.audio_config, dict):
            self.audio_config = AudioConfig(**self.audio_config)


@dataclass
class CM3PConfig:
    """Top-level dual-tower contrastive config (configuration_cm3p.py:289-335)."""

    metadata_config: MetadataConfig = field(default_factory=MetadataConfig)
    beatmap_config: BeatmapConfig = field(default_factory=BeatmapConfig)
    projection_dim: int = 512
    logit_scale_init_value: float = 2.6592
    initializer_factor: float = 1.0
    initializer_range: float = 0.02
    has_decoder_head: bool = False

    def __post_init__(self):
        if isinstance(self.metadata_config, dict):
            self.metadata_config = MetadataConfig(**self.metadata_config)
        if isinstance(self.beatmap_config, dict):
            self.beatmap_config = BeatmapConfig(**self.beatmap_config)


def tiny_cm3p_config(**overrides) -> CM3PConfig:
    """A small config for tests and CPU smoke runs."""
    beatmap = BeatmapConfig(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=96,
        num_hidden_layers=4,
        num_attention_heads=4,
        max_position_embeddings=512,
        audio_config=AudioConfig(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_attention_heads=4,
            projector_intermediate_size=128,
            projector_dim=64,
        ),
    )
    metadata = MetadataConfig(
        vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4
    )
    cfg = CM3PConfig(metadata_config=metadata, beatmap_config=beatmap, projection_dim=32)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
