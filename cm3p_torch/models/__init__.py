from .cm3p import AudioEncoder, BeatmapTransformer, CM3PBeatmapModel, MultiModalProjector, l2_normalize
from .modernbert import EncoderLayer, LayerNormF32, ModernBertEncoder, SelfAttention, pool_hidden

__all__ = [
    "AudioEncoder",
    "BeatmapTransformer",
    "CM3PBeatmapModel",
    "EncoderLayer",
    "LayerNormF32",
    "ModernBertEncoder",
    "MultiModalProjector",
    "SelfAttention",
    "l2_normalize",
    "pool_hidden",
]
