"""Data loading: the loose-file and MMRS datasets, the worker loader, the packing collator."""
from .beatmap_files_dataset import (
    BeatmapFilesDataset,
    BeatmapFilesDatasetFactory,
    build_metadata_dataframe,
    build_metadata_rows,
)
from .data_utils import filter_mmrs_metadata, load_mmrs_metadata
from .loader import SampleLoader, batch_samples, batched_loader
from .mmrs_dataset import BeatmapDatasetIterable, DatasetConfig, MmrsDataset, MmrsDatasetFactory
from .packing_collator import packed_batches

__all__ = [
    "BeatmapDatasetIterable",
    "BeatmapFilesDataset",
    "BeatmapFilesDatasetFactory",
    "DatasetConfig",
    "MmrsDataset",
    "MmrsDatasetFactory",
    "SampleLoader",
    "batch_samples",
    "batched_loader",
    "build_metadata_dataframe",
    "build_metadata_rows",
    "filter_mmrs_metadata",
    "load_mmrs_metadata",
    "packed_batches",
]
