"""Dataset metadata loading/filtering for MMRS-layout dataset roots.

Copy of the JAX package's ``data/data_utils.py``. pandas is imported inside the
functions: the extraction path over loose files needs neither.
"""
from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Optional, Union


def load_mmrs_metadata(path: Union[str, list]):
    """Load and concat ``metadata.parquet`` from one or more dataset roots,
    indexed by (BeatmapSetId, Id)."""
    import pandas as pd

    if isinstance(path, (str, Path)):
        path = [path]

    df_list = []
    for p in path:
        df = pd.read_parquet(Path(p) / "metadata.parquet")
        df["BeatmapIdx"] = df.index
        df["Path"] = str(p)
        df.set_index(["BeatmapSetId", "Id"], inplace=True)
        df_list.append(df)

    df = pd.concat(df_list, ignore_index=False)
    df.sort_index(inplace=True)
    return df


def filter_mmrs_metadata(
    df,
    *,
    start: Optional[int] = None,
    end: Optional[int] = None,
    subset_ids: Optional[list[int]] = None,
    gamemodes: Optional[list[int]] = None,
    min_year: Optional[int] = None,
    max_year: Optional[int] = None,
    min_difficulty: Optional[float] = None,
    max_difficulty: Optional[float] = None,
):
    """Filter by split range / subset ids / gamemode / year / difficulty."""
    if start is not None and end is not None:
        first_level = df.index.get_level_values(0).unique()
        df = df.loc[first_level[start] : first_level[end - 1]]
    if subset_ids is not None:
        df = df.loc[subset_ids]
    if gamemodes is not None:
        df = df[df["ModeInt"].isin(gamemodes)]
    if min_year is not None:
        df = df[df["SubmittedDate"] >= datetime(min_year, 1, 1)]
    if max_year is not None:
        df = df[df["SubmittedDate"] < datetime(max_year + 1, 1, 1)]
    if min_difficulty is not None:
        df = df[df["DifficultyRating"] >= min_difficulty]
    if max_difficulty is not None:
        df = df[df["DifficultyRating"] <= max_difficulty]
    return df
