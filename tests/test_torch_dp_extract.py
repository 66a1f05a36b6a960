"""``python -m cm3p_torch.extract`` on two CPU ranks against the one-process tool.

``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
cm3p_torch.extract --device cpu --tiny-model`` over 6 maps of
``resources/perf_corpus`` (``--beatmap-files``) and over the MMRS root of
``tests/test_torch_mmrs.py`` (``--dataset-path``, 8 beatmaps), beside the
one-process tool on the same inputs: the same beatmap ids in the same order
(the dataset's order), per-beatmap cosine >= 0.9999, each
rank's share disjoint; ``--batch-size`` rounded up to a multiple of the world
size; ``--merge-with`` applied once, by rank 0; ``--no-mesh`` under the launcher
leaves the whole job to rank 0.
"""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "resources" / "perf_corpus"
N_MAPS = 6
COS_MIN = 0.9999
TIMEOUT_S = 240
COMMON = ["--device", "cpu", "--tiny-model", "--max-length", "512", "--no-audio"]


def _run(args, cwd: Path, ranks: int = 0) -> str:
    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={ranks}"]
                if ranks else [sys.executable])
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    proc = subprocess.run([*launcher, "-m", "cm3p_torch.extract", *COMMON, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout + proc.stderr


def _same(one: Path, two: Path) -> None:
    a, b = pd.read_parquet(one), pd.read_parquet(two)
    assert list(a["beatmap_id"]) == list(b["beatmap_id"])
    ea, eb = np.stack(a["embedding"].to_numpy()), np.stack(b["embedding"].to_numpy())
    cos = (ea * eb).sum(1) / np.linalg.norm(ea, axis=1) / np.linalg.norm(eb, axis=1)
    assert cos.min() >= COS_MIN, cos


@pytest.fixture(scope="module")
def maps(tmp_path_factory) -> tuple[Path, Path]:
    """A folder of the maps, and the one-process tool's parquet of them."""
    folder = tmp_path_factory.mktemp("maps")
    for path in sorted(CORPUS.glob("*.osu"))[:N_MAPS]:
        shutil.copy(path, folder)
    _run(["--beatmap-files", str(folder), "--output", "one.parquet"], folder.parent)
    return folder, folder.parent / "one.parquet"


def test_two_ranks_write_the_one_process_embeddings_of_beatmap_files(maps, tmp_path):
    folder, one = maps
    log = _run(["--beatmap-files", str(folder), "--output", "two.parquet", "--batch-size", "5"], tmp_path, ranks=2)
    _same(one, tmp_path / "two.parquet")
    assert "Rounded --batch-size up to 6 for 2 ranks" in log
    shares = [int(line.rsplit(":", 1)[1].split()[0]) for line in log.splitlines() if "beatmaps" in line
              and "rank " in line and " of 2:" in line]
    assert sorted(shares) == [N_MAPS // 2, N_MAPS // 2]
    assert log.count("Saved ") == 1  # rank 0 alone writes
    assert len(pd.read_parquet(tmp_path / "two.parquet")) == N_MAPS


def test_two_ranks_shard_an_mmrs_root_and_merge_once(tmp_path):
    from tests.test_torch_mmrs import build_mmrs_root

    root = build_mmrs_root(tmp_path / "mmrs")
    _run(["--dataset-path", str(root), "--output", "one.parquet"], tmp_path)
    first = pd.read_parquet(tmp_path / "one.parquet")
    # an earlier file with one beatmap of its own: the merge keeps it, and this run's rows win elsewhere
    earlier = first.iloc[:1].copy()
    earlier["Id"] = earlier["beatmap_id"] = 999
    earlier.to_parquet(tmp_path / "earlier.parquet", index=False)
    log = _run(["--dataset-path", str(root), "--output", "two.parquet", "--merge-with", "earlier.parquet"],
               tmp_path, ranks=2)
    assert log.count("Merged: existing=1 new=8 result=9") == 1
    merged = pd.read_parquet(tmp_path / "two.parquet")
    assert sorted(merged["Id"]) == sorted(list(first["Id"]) + [999])
    ours = merged[merged["Id"] != 999].set_index("Id").loc[first["Id"]]
    ea, eb = np.stack(first["embedding"].to_numpy()), np.stack(ours["embedding"].to_numpy())
    assert ((ea * eb).sum(1)).min() >= COS_MIN


def test_no_mesh_under_the_launcher_leaves_the_job_to_rank_0(maps, tmp_path):
    folder, one = maps
    log = _run(["--beatmap-files", str(folder), "--output", "solo.parquet", "--no-mesh"], tmp_path, ranks=2)
    assert "--no-mesh: rank 1 leaves the job to rank 0" in log and "--no-mesh: rank 0 runs the whole job" in log
    assert log.count("Packed-extracted ") == 1 and "of 2:" not in log
    _same(one, tmp_path / "solo.parquet")
