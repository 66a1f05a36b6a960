from .cm3p import (
    AudioEncoder,
    BeatmapTransformer,
    CM3PBeatmapModel,
    CM3PModel,
    CM3POutput,
    MultiModalProjector,
    cm3p_loss,
    contrastive_loss,
    l2_normalize,
    similarity_logits,
)
from .modernbert import EncoderLayer, EncoderOptions, LayerNormF32, ModernBertEncoder, SelfAttention, pool_hidden

__all__ = [
    "AudioEncoder",
    "BeatmapTransformer",
    "CM3PBeatmapModel",
    "EncoderOptions",
    "CM3PModel",
    "CM3POutput",
    "EncoderLayer",
    "LayerNormF32",
    "ModernBertEncoder",
    "MultiModalProjector",
    "SelfAttention",
    "cm3p_loss",
    "contrastive_loss",
    "l2_normalize",
    "pool_hidden",
    "similarity_logits",
]
