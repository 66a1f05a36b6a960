"""MMRS dataset pipeline: the port's copy of the JAX package's ``data/mmrs_dataset.py``.

Iterates Mapperator-style dataset roots (``metadata.parquet`` beside
``data/<set folder>/`` holding the ``.osu`` and audio files) through the
processor into per-window numpy dicts: a per-epoch beatmapset shuffle, a strided
shard per (process, loader worker), cycle-length interleaving, a per-track
audio and mel cache, the DT speed augmentation, the beatmap / metadata mismatch
augmentation, the 80/10/10 masked-LM corruption, ranked-classification labels,
and a logged skip of a bad audio file or beatmap. Samples have static shapes
(``padding="max_length"``).

The random draws follow the JAX package's stream sample for sample. It seeds
the global ``random`` and ``np.random`` and the processor's ``rng`` from one
mix of (seed, shard, epoch); here each iteration makes one ``random.Random`` and
one ``np.random.RandomState`` from that mix and passes them down, which gives
the same numbers as the seeded globals. Unseeded, both come from OS entropy.

The module imports neither torch nor pandas (pandas only inside functions):
spawned loader workers import it to unpickle the factory below.
"""
from __future__ import annotations

import dataclasses
import logging
import random
import traceback
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np

from ..processing.processor import CM3PProcessor, get_metadata
from .data_utils import filter_mmrs_metadata, load_mmrs_metadata

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DatasetConfig:
    """The ``dataset`` section of a training config."""

    train_dataset_paths: list = dataclasses.field(default_factory=list)
    train_dataset_start: Optional[int] = None
    train_dataset_end: Optional[int] = None
    test_dataset_paths: list = dataclasses.field(default_factory=list)
    test_dataset_start: Optional[int] = None
    test_dataset_end: Optional[int] = None
    cycle_length: int = 8
    drop_last: bool = True
    gamemodes: Optional[list] = None
    min_year: Optional[int] = None
    max_year: Optional[int] = None
    min_difficulty: Optional[float] = None
    max_difficulty: Optional[float] = None
    metadata_dropout_prob: float = 0.2
    dt_augment_prob: float = 0.5
    dt_augment_range: list = dataclasses.field(default_factory=lambda: [1.25, 1.5])
    dt_augment_sqrt: bool = False
    sampling_rate: int = 16000
    test_metadata_variations: int = 1000
    train_metadata_variations: int = 1
    labels: str = "none"
    include_metadata: bool = True
    include_audio: bool = True
    include_beatmap: bool = True
    include_source_metadata: bool = False
    masked_lm_prob: float = 0.25
    masked_lm_split: list = dataclasses.field(default_factory=lambda: [0.8, 0.1, 0.1])
    beatmap_mismatch_prob: float = 0.0


def data_mix(seed: int, shard: int, epoch: int) -> int:
    """The one seed of every generator an iteration of (seed, shard, epoch) draws from."""
    return (int(seed) * 1_000_003 + shard * 7919 + epoch) % (2**31 - 1)


class MmrsDataset:
    """Iterable over processed samples with worker sharding and interleaving."""

    def __init__(
        self,
        args: DatasetConfig,
        processor: CM3PProcessor,
        subset_ids: Optional[list[int]] = None,
        test: bool = False,
        worker_id: int = 0,
        num_workers: int = 1,
        process_id: int = 0,
        process_count: int = 1,
        seed: Optional[int] = None,
        epoch: int = 0,
    ):
        self.args = args
        self.processor = processor
        self.test = test
        self.paths = [Path(p) for p in (args.test_dataset_paths if test else args.train_dataset_paths)]
        self.start = args.test_dataset_start if test else args.train_dataset_start
        self.end = args.test_dataset_end if test else args.train_dataset_end
        self.metadata = load_mmrs_metadata([str(p) for p in self.paths])
        self.start = self.start or 0
        self.end = self.end or len(self.metadata.index.get_level_values(0).unique())
        self.subset_ids = subset_ids
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.process_id = process_id
        self.process_count = process_count
        self.seed = seed
        # the next iteration's epoch: a resume or a factory made anew each epoch continues the seeded shuffle
        self._epoch = epoch

    @property
    def host_counts(self) -> dict:
        """The processor's counts of beatmaps parsed and audio files decoded by each route."""
        return self.processor.host_counts

    def get_filtered_metadata(self):
        return filter_mmrs_metadata(
            self.metadata,
            start=self.start,
            end=self.end,
            subset_ids=self.subset_ids,
            gamemodes=self.args.gamemodes,
            min_year=self.args.min_year,
            max_year=self.args.max_year,
            min_difficulty=self.args.min_difficulty,
            max_difficulty=self.args.max_difficulty,
        )

    @property
    def shard(self) -> tuple[int, int]:
        """(this shard, shard count): (host process, loader worker) flattened into one stride."""
        return self.process_id * self.num_workers + self.worker_id, self.process_count * self.num_workers

    def get_sharded_metadata(self):
        """The filtered metadata of this (process, worker) shard: every worker of every process sees a
        disjoint slice."""
        filtered = self.get_filtered_metadata()
        shard, num_shards = self.shard
        if num_shards > 1:
            filtered = filtered[shard::num_shards]
            logger.info(
                "Shard %d/%d (process %d, worker %d) processing %d beatmaps.",
                shard, num_shards, self.process_id, self.worker_id, len(filtered),
            )
        return filtered

    def __iter__(self) -> Iterator[dict]:
        if self.processor.native:
            from ..native import library

            library()  # a failed build raises here, not in the per-file catches below
        filtered = self.get_sharded_metadata()

        epoch = self._epoch
        self._epoch += 1
        if self.seed is not None:
            mix = data_mix(self.seed, self.shard[0], epoch)
            draws = (random.Random(mix), np.random.RandomState(mix))
            self.processor.rng = np.random.default_rng(mix + 7)
            # a seeded shuffle that changes every epoch
            rng = np.random.default_rng(int(self.seed) + epoch)
        else:
            draws = (random.Random(), np.random.RandomState())
            rng = np.random.default_rng()
        if not self.test:
            subset_ids = filtered.index.get_level_values(0).unique().to_numpy().copy()
            rng.shuffle(subset_ids)
            filtered = filtered.loc[subset_ids]

        def factory(metadata) -> BeatmapDatasetIterable:
            return BeatmapDatasetIterable(metadata, self.args, self.processor, self.test, *draws)

        if self.args.cycle_length > 1:
            return InterleavingIterable(filtered, factory, self.args.cycle_length, self.args.drop_last)
        return iter(factory(filtered))


class InterleavingIterable:
    """Round-robin over ``cycle_length`` sub-iterators for batch variety; with ``drop_last`` the first
    exhausted one ends the whole stream."""

    __slots__ = ("workers", "cycle_length", "index", "drop_last")

    def __init__(self, metadata, iterable_factory: Callable, cycle_length: int, drop_last=False):
        self.workers = [iter(iterable_factory(metadata[i::cycle_length])) for i in range(cycle_length)]
        self.cycle_length = cycle_length
        self.index = 0
        self.drop_last = drop_last

    def __iter__(self):
        return self

    def __next__(self):
        num = len(self.workers)
        for _ in range(num):
            try:
                self.index = self.index % len(self.workers)
                item = next(self.workers[self.index])
                self.index += 1
                return item
            except StopIteration:
                if self.drop_last:
                    raise
                self.workers.remove(self.workers[self.index])
        raise StopIteration


class BeatmapDatasetIterable:
    """The samples of a metadata slice, track by track; ``py_rng`` draws the DT speed and the mismatch,
    ``np_rng`` the mismatched row and the masked-LM corruption."""

    def __init__(self, metadata, args: DatasetConfig, processor: CM3PProcessor, test: bool,
                 py_rng: random.Random, np_rng: np.random.RandomState):
        self.args = args
        self.metadata = metadata
        self.processor = processor
        self.test = test
        self.py_rng = py_rng
        self.np_rng = np_rng

        if self.args.labels == "masked_lm":
            tok = processor.beatmap_tokenizer
            exclude = {tok.audio_token_id}
            self.eligible_random_token_ids = np.array(
                [i for i in range(tok.vocab_size) if i not in exclude], dtype=np.int32
            )

    def _get_speed_augment(self) -> float:
        if self.test or self.py_rng.random() >= self.args.dt_augment_prob:
            return 1.0
        mi, ma = self.args.dt_augment_range
        base = self.py_rng.random()
        if self.args.dt_augment_sqrt:
            base = base**0.5
        return mi + (ma - mi) * base

    def _process_input_for_masked_lm(self, inputs: dict) -> None:
        """80/10/10 mask / random / keep corruption; labels -100 where nothing is to predict."""
        input_ids = inputs["input_ids"]
        tok = self.processor.beatmap_tokenizer
        to_predict = np.ones_like(input_ids, dtype=bool)
        for sid in tok.all_special_ids:
            to_predict &= input_ids != sid
        to_predict &= self.np_rng.rand(*input_ids.shape) < self.args.masked_lm_prob
        inputs["labels"] = np.where(to_predict, input_ids, -100).astype(np.int32)

        bounds = np.cumsum(self.args.masked_lm_split)
        rand = self.np_rng.rand(*input_ids.shape)
        masking = (rand < bounds[0]) & to_predict
        random_repl = (rand >= bounds[0]) & (rand < bounds[1]) & to_predict

        input_ids[masking] = tok.mask_token_id
        n_random = int(random_repl.sum())
        if n_random > 0:
            input_ids[random_repl] = self.eligible_random_token_ids[
                self.np_rng.randint(0, len(self.eligible_random_token_ids), n_random)
            ]

    def __iter__(self):
        return self._get_next_tracks()

    def _get_next_tracks(self) -> Iterator[dict]:
        for beatmapset_id in self.metadata.index.get_level_values(0).unique():
            metadata = self.metadata.loc[beatmapset_id]
            first = metadata.iloc[0]

            audio_cache: dict = {}
            # the audio-only window work (mel, token counts), shared by the track's difficulties
            features_cache: dict = {}
            speed = self._get_speed_augment()
            track_path = Path(first["Path"]) / "data" / first["BeatmapSetFolder"]

            for _, beatmap_metadata in metadata.iterrows():
                audio_path = track_path / beatmap_metadata["AudioFile"]
                beatmap_is_matched = True
                if self.py_rng.random() < self.args.beatmap_mismatch_prob:
                    beatmap_metadata = self.metadata.sample(n=1, random_state=self.np_rng).iloc[0]
                    beatmap_is_matched = False
                yield from self._get_next_beatmap(
                    audio_path, beatmap_metadata, speed, audio_cache, beatmap_is_matched, features_cache,
                )

    def _get_next_beatmap(self, audio_path, beatmap_metadata, speed: float, audio_cache: dict,
                          beatmap_is_matched: bool, features_cache: Optional[dict] = None) -> Iterator[dict]:
        beatmap_path = (
            Path(beatmap_metadata["Path"]) / "data" / beatmap_metadata["BeatmapSetFolder"]
            / beatmap_metadata["BeatmapFile"]
        )

        audio_samples = None
        if self.args.include_audio:
            try:
                if audio_path in audio_cache:
                    audio_samples = audio_cache[audio_path]
                else:
                    from ..audio.loading import load_audio_file

                    audio_samples = load_audio_file(audio_path, self.args.sampling_rate, speed,
                                                    self.processor.native, self.processor.host_counts)
                    audio_cache[audio_path] = audio_samples
            except Exception as e:
                logger.warning("Failed to load audio file: %s (%s)", audio_path, e)
                return

        try:
            results = self.processor(
                metadata=get_metadata(beatmap_metadata=beatmap_metadata, speed=speed)
                if self.args.include_metadata else None,
                beatmap=str(beatmap_path) if self.args.include_beatmap else None,
                audio=audio_samples,
                audio_sampling_rate=self.args.sampling_rate,
                speed=speed,
                multiply_metadata=self.args.include_metadata,
                populate_metadata=self.args.include_metadata,
                metadata_dropout_prob=self.args.metadata_dropout_prob if not self.test else 0.0,
                metadata_variations=self.args.test_metadata_variations if self.test
                else self.args.train_metadata_variations,
                padding="max_length",
                audio_features_cache=features_cache,
            )
            results = dict(results)

            if self.args.labels == "masked_lm":
                self._process_input_for_masked_lm(results)
            elif self.args.labels == "ranked_classification":
                is_ranked = beatmap_metadata["Status"] == "ranked" and beatmap_is_matched
                results["labels"] = np.full((results["input_ids"].shape[0],), int(is_ranked), np.int32)
        except Exception as e:
            logger.warning("Failed to process beatmap: %s (%s)", beatmap_path, e)
            traceback.print_exc()
            return

        for i in range(len(results["input_ids"])):
            sample = {key: results[key][i] for key in results}
            if self.args.include_source_metadata:
                sample["beatmap_id"] = beatmap_metadata.name
            yield sample


class MmrsDatasetFactory:
    """Picklable dataset factory (loader workers are spawned, so no closure): training streams, and with
    the defaults the extraction tool's (``--dataset-path``: one unseeded pass, no shard)."""

    def __init__(self, ds_cfg: DatasetConfig, processor: CM3PProcessor, test: bool, process_id: int = 0,
                 process_count: int = 1, seed: Optional[int] = None, epoch: int = 0):
        if processor.native:
            from ..native import library

            library()  # built once here, before loader workers start (a failed build raises in this process)
        self.ds_cfg = ds_cfg
        self.processor = processor
        self.test = test
        self.process_id = process_id
        self.process_count = process_count
        self.seed = seed
        self.epoch = epoch

    def __call__(self, worker_id: int, num_workers: int) -> MmrsDataset:
        return MmrsDataset(
            self.ds_cfg, self.processor, test=self.test, worker_id=worker_id, num_workers=num_workers,
            process_id=self.process_id, process_count=self.process_count, seed=self.seed, epoch=self.epoch,
        )
