"""Dataset over loose .osu / .osz files (no parquet metadata).

Counterpart of the JAX package's ``data/beatmap_files_dataset.py``: one
metadata row per beatmap, in the MMRS column schema, synthesised from the
parsed ``.osu`` file, and an iterator that runs every beatmap through the
processor and yields one sample per window.

The rows are plain dicts (``None`` where a loose file cannot provide a
column), sorted by (BeatmapSetId, Id), so iterating needs no pandas;
:func:`build_metadata_dataframe` and :attr:`BeatmapFilesDataset.metadata` give
the same table as a DataFrame indexed by (BeatmapSetId, Id), for the parquet
output, and import pandas only then.
"""
from __future__ import annotations

import logging
import tempfile
import zipfile
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..beatmap.parser import load_beatmap
from ..processing.processor import CM3PProcessor

logger = logging.getLogger(__name__)

REQUIRED_COLUMNS = [
    "Id", "Artist", "ArtistUnicode", "Creator", "FavouriteCount", "BeatmapSetId", "Nsfw", "Offset",
    "BeatmapSetPlayCount", "Source", "BeatmapSetStatus", "Spotlight", "Title", "TitleUnicode",
    "BeatmapSetUserId", "Video", "Description", "GenreId", "GenreName", "LanguageId", "LanguageName",
    "PackTags", "Ratings", "DownloadDisabled", "BeatmapSetBpm", "CanBeHyped", "DiscussionLocked",
    "BeatmapSetIsScoreable", "BeatmapSetLastUpdated", "BeatmapSetRanked", "RankedDate", "Storyboard",
    "SubmittedDate", "Tags", "DifficultyRating", "Mode", "Status", "TotalLength", "UserId", "Version",
    "Checksum", "MaxCombo", "Accuracy", "Ar", "Bpm", "CountCircles", "CountSliders", "CountSpinners",
    "Cs", "Drain", "HitLength", "IsScoreable", "LastUpdated", "ModeInt", "PassCount", "PlayCount",
    "Ranked", "Owners", "TopTagIds", "TopTagCounts", "StarRating", "OmdbTags", "AudioFile",
    "BeatmapSetFolder", "BeatmapFile",
]


def _collect_paths(paths: list[str]) -> list[Path]:
    collected: list[Path] = []
    for p in paths:
        pth = Path(p)
        if pth.is_file():
            if pth.suffix.lower() in {".osu", ".osz"}:
                collected.append(pth)
        elif pth.is_dir():
            for fp in sorted(pth.rglob("*")):
                if fp.is_file() and fp.suffix.lower() in {".osu", ".osz"}:
                    collected.append(fp)
    return collected


def _extract_osz(osz_path: Path, extract_root: Path) -> Path:
    target_dir = extract_root / osz_path.stem
    if target_dir.exists():
        return target_dir
    target_dir.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(osz_path, "r") as zf:
        zf.extractall(target_dir)
    return target_dir


def _parse_osu_file(osu_path: Path) -> dict:
    """Synthesize one metadata row from a .osu file via the real parser."""
    data: dict = {col: None for col in REQUIRED_COLUMNS}
    data["BeatmapSetFolder"] = osu_path.parent.name
    data["BeatmapFile"] = osu_path.name
    data["Path"] = str(osu_path.parent.parent)

    try:
        bm = load_beatmap(osu_path)
    except Exception:
        return data

    data["AudioFile"] = bm.audio_filename or None
    data["Title"] = bm.title or None
    data["Artist"] = bm.artist or None
    data["Creator"] = bm.creator or None
    data["Version"] = bm.version or None
    data["Id"] = bm.beatmap_id
    data["BeatmapSetId"] = bm.beatmap_set_id
    data["Cs"] = bm.circle_size
    data["Ar"] = bm.approach_rate
    data["Drain"] = bm.hp_drain_rate
    data["ModeInt"] = bm.mode
    data["Tags"] = " ".join(bm.tags) if bm.tags else None

    bpm = None
    for tp in bm.timing_points:
        if tp.bpm:
            bpm = tp.bpm
            break
    data["Bpm"] = bpm

    objs = bm.hit_objects()
    if objs:
        times = [o.time for o in objs]
        data["TotalLength"] = float((max(times) - min(times)) / 1000.0)
        data["HitLength"] = data["TotalLength"]
        from ..beatmap.osu import Circle, Slider, Spinner

        data["CountCircles"] = sum(isinstance(o, Circle) for o in objs)
        data["CountSliders"] = sum(isinstance(o, Slider) for o in objs)
        data["CountSpinners"] = sum(isinstance(o, Spinner) for o in objs)
    else:
        data["TotalLength"] = 0.0
        data["HitLength"] = 0.0
        data["CountCircles"] = data["CountSliders"] = data["CountSpinners"] = 0
    return data


def build_metadata_rows(paths: list[str], extract_root: Path) -> list[dict]:
    """One row per beatmap found under ``paths``, sorted by (BeatmapSetId, Id)."""
    files = _collect_paths(paths)
    extract_root.mkdir(exist_ok=True)

    rows: list[dict] = []
    for p in files:
        if p.suffix.lower() == ".osu":
            rows.append(_parse_osu_file(p))
        elif p.suffix.lower() == ".osz":
            folder = _extract_osz(p, extract_root)
            for osu in sorted(folder.rglob("*.osu")):
                rows.append(_parse_osu_file(osu))
    # files without embedded ids get synthetic, stable negative ids
    for key in ("Id", "BeatmapSetId"):
        missing = 0
        for row in rows:
            if row[key] is None:
                missing += 1
                row[key] = -missing
            row[key] = int(row[key])
    rows.sort(key=lambda r: (r["BeatmapSetId"], r["Id"]))
    return rows


def _rows_to_dataframe(rows: list[dict]):
    import pandas as pd

    df = pd.DataFrame([{k: (pd.NA if v is None else v) for k, v in row.items()} for row in rows])
    if len(df):
        df["Id"] = df["Id"].astype("int64")
        df["BeatmapSetId"] = df["BeatmapSetId"].astype("int64")
        df.set_index(["BeatmapSetId", "Id"], inplace=True)
        df.sort_index(inplace=True)
    return df


def build_metadata_dataframe(paths: list[str], extract_root: Path):
    """The metadata rows as a DataFrame indexed by (BeatmapSetId, Id) (needs pandas)."""
    return _rows_to_dataframe(build_metadata_rows(paths, extract_root))


def _safe_row_metadata(row: dict, speed: float = 1.0) -> Optional[dict]:
    """get_metadata for a synthesized row: tolerate missing columns."""
    meta: dict = {}
    sr = row.get("StarRating")
    if isinstance(sr, (list, np.ndarray)) and len(sr) == 7:
        meta["difficulty"] = float(np.interp(speed, [0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0], sr))
    elif row.get("DifficultyRating") is not None:
        meta["difficulty"] = float(row["DifficultyRating"])
    submitted = row.get("SubmittedDate")
    if submitted is not None and hasattr(submitted, "year"):
        meta["year"] = submitted.year
    if row.get("ModeInt") is not None:
        meta["mode"] = int(row["ModeInt"])
    if row.get("Status") is not None:
        meta["status"] = row["Status"]
    if row.get("UserId") is not None:
        meta["mapper"] = row["UserId"]
    tags = row.get("TopTagIds")
    if isinstance(tags, (list, np.ndarray)) and len(tags) > 0:
        meta["tags"] = list(tags)
    return meta or None


class BeatmapFilesDataset:
    """Iterate loose beatmap files through the processor.

    Yields one dict per window (the processor's keys, one window each) with
    ``beatmap_id`` = (BeatmapSetId, Id). Audio is read from the file each
    ``.osu`` names (``AudioFilename``) in its own folder, once per beatmapset.
    Each (rank, loader worker) takes a strided share of whole beatmaps (:attr:`shard`).
    """

    def __init__(
        self,
        beatmap_paths: list[str],
        processor: CM3PProcessor,
        sampling_rate: int = 16000,
        include_audio: bool = True,
        include_beatmap: bool = True,
        include_metadata: bool = True,
        worker_id: int = 0,
        num_workers: int = 1,
        process_id: int = 0,
        process_count: int = 1,
    ):
        self.beatmap_paths = beatmap_paths
        self._tmpdir = tempfile.TemporaryDirectory(prefix="cm3p_osz_")
        self._extract_root = Path(self._tmpdir.name)
        self.rows = build_metadata_rows(beatmap_paths, self._extract_root)
        self.processor = processor
        self.sampling_rate = sampling_rate
        self.include_audio = include_audio
        self.include_beatmap = include_beatmap
        self.include_metadata = include_metadata
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.process_id = process_id
        self.process_count = process_count

    @property
    def shard(self) -> tuple[int, int]:
        """(this shard, shard count): (rank, loader worker) flattened into one stride over the beatmaps."""
        return self.process_id * self.num_workers + self.worker_id, self.process_count * self.num_workers

    @property
    def host_counts(self) -> dict:
        """The processor's counts of beatmaps parsed and audio files decoded by each route."""
        return self.processor.host_counts

    @property
    def metadata(self):
        """The rows as a DataFrame indexed by (BeatmapSetId, Id) (needs pandas)."""
        return _rows_to_dataframe(self.rows)

    def __iter__(self) -> Iterator[dict]:
        rows = self.rows
        shard, num_shards = self.shard
        if num_shards > 1:
            rows = rows[shard::num_shards]
        return self._iter(rows)

    def __del__(self):
        try:
            if hasattr(self, "_tmpdir") and self._tmpdir is not None:
                self._tmpdir.cleanup()
        except Exception:
            pass

    def _iter(self, rows: list[dict]) -> Iterator[dict]:
        if self.processor.native:
            from ..native import library

            library()  # a failed build raises here, not in the per-file catches below
        set_ids = list(dict.fromkeys(row["BeatmapSetId"] for row in rows))
        for beatmapset_id in set_ids:
            subset = [row for row in rows if row["BeatmapSetId"] == beatmapset_id]
            first = subset[0]
            track_path = Path(first.get("Path") or ".") / str(first.get("BeatmapSetFolder") or "")

            audio_cache: dict = {}
            # audio-only window work (mel, token counts) shared across the
            # set's difficulties - see CM3PProcessor.audio_features_cache
            features_cache: dict = {}
            for row in subset:
                audio_samples = None
                audio_filename = row.get("AudioFile")
                if self.include_audio and audio_filename is not None:
                    audio_path = track_path / str(audio_filename)
                    try:
                        if audio_path in audio_cache:
                            audio_samples = audio_cache[audio_path]
                        else:
                            from ..audio.loading import load_audio_file

                            audio_samples = load_audio_file(audio_path, self.sampling_rate, 1.0,
                                                            self.processor.native, self.host_counts)
                            audio_cache[audio_path] = audio_samples
                    except Exception as e:
                        logger.warning("Failed to load audio file %s (%s); continuing without audio", audio_path, e)
                        audio_samples = None

                beatmap_path = track_path / str(row.get("BeatmapFile") or "")
                try:
                    results = self.processor(
                        metadata=_safe_row_metadata(row) if self.include_metadata else None,
                        beatmap=str(beatmap_path) if self.include_beatmap else None,
                        audio=audio_samples,
                        audio_sampling_rate=self.sampling_rate,
                        multiply_metadata=self.include_metadata,
                        populate_metadata=self.include_metadata,
                        padding="max_length",
                        audio_features_cache=features_cache,
                    )
                except Exception as e:
                    logger.warning("Failed to process beatmap: %s (%s)", beatmap_path, e)
                    continue

                for i in range(len(results["input_ids"])):
                    item = {k: results[k][i] for k in results}
                    item["beatmap_id"] = (row["BeatmapSetId"], row["Id"])
                    yield item


class BeatmapFilesDatasetFactory:
    """Picklable dataset factory for loose .osu/.osz extraction (loader workers are spawned).

    It lives here, among modules that import no torch, so that a spawned worker that
    unpickles it imports no torch either.
    """

    def __init__(self, paths, processor, include_audio: bool, process_id: int = 0, process_count: int = 1):
        if processor.native:
            from ..native import library

            library()  # built once here, before loader workers start (a failed build raises in this process)
        self.paths = paths
        self.processor = processor
        self.include_audio = include_audio
        self.process_id = process_id
        self.process_count = process_count

    def __call__(self, worker_id, num_workers):
        return BeatmapFilesDataset(
            self.paths, self.processor, include_audio=self.include_audio, include_metadata=False,
            worker_id=worker_id, num_workers=num_workers, process_id=self.process_id,
            process_count=self.process_count,
        )
