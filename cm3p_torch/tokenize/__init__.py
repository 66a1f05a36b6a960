from .beatmap_tokenizer import BatchTokens, BeatmapTokenizer, pack_sequences
from .metadata_tokenizer import (
    METADATA_FIELDS,
    Metadata,
    MetadataTokenizer,
    make_metadata,
    merge_metadata_dicts,
)

__all__ = [
    "BatchTokens",
    "BeatmapTokenizer",
    "METADATA_FIELDS",
    "Metadata",
    "MetadataTokenizer",
    "make_metadata",
    "merge_metadata_dicts",
    "pack_sequences",
]
