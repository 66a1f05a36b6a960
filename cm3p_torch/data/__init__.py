"""Data loading: the loose-file dataset, the worker loader, the packing collator."""
from .beatmap_files_dataset import (
    BeatmapFilesDataset,
    BeatmapFilesDatasetFactory,
    build_metadata_dataframe,
    build_metadata_rows,
)
from .data_utils import filter_mmrs_metadata, load_mmrs_metadata
from .loader import SampleLoader, batch_samples, batched_loader
from .packing_collator import packed_batches

__all__ = [
    "BeatmapFilesDataset",
    "BeatmapFilesDatasetFactory",
    "SampleLoader",
    "batch_samples",
    "batched_loader",
    "build_metadata_dataframe",
    "build_metadata_rows",
    "filter_mmrs_metadata",
    "load_mmrs_metadata",
    "packed_batches",
]
