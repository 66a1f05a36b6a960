"""``python -m cm3p_torch.train`` on two CPU ranks from an MMRS root.

The tiny ``smoke_mmrs`` recipe (packed rows with audio, Muon, one loader
worker a rank) over the root ``tests/test_torch_mmrs.py`` builds (4 sets x 2
maps), launched both ways in: ``torch.distributed.run --standalone`` (the
``env://`` rendezvous of ``torchrun``) and ``training.multihost`` with a
``file://`` coordinator, one process per rank (the run that is killed). Checked: each rank's loader
workers read the data shard ``data_shard_group`` gives it, and the shards are
disjoint and cover the root; one ``train_log.jsonl`` with each step once, one
set of checkpoints, one final model; the same run SIGKILLed once its step-2
checkpoint is written and resumed on two ranks logs the losses and gradient
norms of the uninterrupted run;
an evaluation over shards of unequal length (5 beatmaps) stops both ranks
together and logs that it did. Each launch has a time limit, so a hang fails.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pandas as pd
import pytest

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
LAUNCH_TIMEOUT_S = 240


def _overrides(train_root, test_root, out, steps):
    return [f"dataset.train_dataset_paths=[{train_root}]", f"dataset.test_dataset_paths=[{test_root}]",
            f"training.output_dir={out}", f"training.max_steps={steps}", "training.num_workers=1",
            "training.per_device_eval_batch_size=1", "training.load_best_model_at_end=false"]


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    env.pop("RANK", None)
    return env


def torchrun(args, log: Path):
    """``python -m torch.distributed.run --standalone --nproc-per-node 2 -m cm3p_torch.train ...``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={WORLD}",
           "-m", "cm3p_torch.train", "--config-name", "smoke_mmrs", "--device", "cpu", *args]
    with open(log, "w") as f:
        proc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, env=_env(), timeout=LAUNCH_TIMEOUT_S,
                              cwd=log.parent)
    assert proc.returncode == 0, log.read_text()[-3000:]
    return log.read_text()


def multihost(args, store: Path, log: Path, kill_at: Path = None):
    """One ``python -m cm3p_torch.train ... training.multihost=true`` process per rank (``file://`` store);
    with ``kill_at``, both ranks are SIGKILLed once that file exists."""
    procs, files = [], []
    for rank in range(WORLD):
        cmd = [sys.executable, "-m", "cm3p_torch.train", "--config-name", "smoke_mmrs", "--device", "cpu", *args,
               "training.multihost=true", f"training.coordinator_address=file://{store}",
               f"training.num_processes={WORLD}", f"training.process_id={rank}",
               "training.heartbeat_timeout_seconds=120"]
        files.append(open(log.with_suffix(f".rank{rank}.log"), "w"))
        procs.append(subprocess.Popen(cmd, stdout=files[-1], stderr=subprocess.STDOUT, env=_env(), cwd=log.parent))
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if kill_at is not None and kill_at.exists():
                break
            time.sleep(0.02)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for f in files:
            f.close()
    texts = [log.with_suffix(f".rank{r}.log").read_text() for r in range(WORLD)]
    if kill_at is None:
        assert [p.returncode for p in procs] == [0] * WORLD, texts[0][-2000:] + texts[1][-2000:]
    else:
        assert kill_at.exists(), texts[0][-2000:] + texts[1][-2000:]
    return texts


def _records(out: Path):
    return [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]


def _steps(records):
    """(step, loss, grad_norm) of each logged step, its last record where a killed run logged it twice."""
    last = {r["step"]: (r["step"], r["loss"], r["grad_norm"]) for r in records if "loss" in r}
    return [last[s] for s in sorted(last)]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    from tests.test_torch_mmrs import build_mmrs_root

    train_root = build_mmrs_root(tmp_path_factory.mktemp("mmrs"))
    # the evaluation root: 5 of the 8 beatmaps, so that the two ranks' eval shards differ in length
    test_root = tmp_path_factory.mktemp("mmrs_eval")
    os.symlink(train_root / "data", test_root / "data")
    pd.read_parquet(train_root / "metadata.parquet").iloc[:5].to_parquet(test_root / "metadata.parquet")
    return train_root, test_root


@pytest.fixture(scope="module")
def runs(roots, tmp_path_factory):
    train_root, test_root = roots
    tmp = tmp_path_factory.mktemp("runs")
    whole, part = tmp / "whole", tmp / "part"
    outputs = {"whole": torchrun(_overrides(train_root, test_root, whole, 4), tmp / "whole.log")}
    # the same 4-step run (the learning-rate schedule spans max_steps), killed once its step-2 checkpoint is in
    outputs["first"] = multihost(_overrides(train_root, test_root, part, 4), tmp / "store", tmp / "first.log",
                                 kill_at=part / "checkpoints" / "step_2.pt")
    # step 2's checkpoint, or step 3's where this host was slow to see the run get there
    outputs["latest"] = max(int(p.stem.split("_")[1]) for p in (part / "checkpoints").glob("step_*.pt"))
    outputs["resumed"] = torchrun(_overrides(train_root, test_root, part, 4), tmp / "resumed.log")
    return whole, part, outputs


def test_the_ranks_read_disjoint_shards_of_the_root(roots, runs):
    from cm3p_torch.data import DatasetConfig, MmrsDataset
    from cm3p_torch.processing import CM3PProcessor

    train_root, _ = roots
    whole, _, _ = runs
    ids = []
    for group in range(WORLD):
        text = (whole / "dataloader" / f"shard{group}" / "worker_0.log").read_text()
        assert f"(process {group}, worker 0)" in text and f"Shard {group}/{WORLD}" in text
        ds = MmrsDataset(DatasetConfig(train_dataset_paths=[str(train_root)]), CM3PProcessor(),
                         process_id=group, process_count=WORLD)
        ids.append(set(ds.get_sharded_metadata().index.get_level_values(1)))
    assert not ids[0] & ids[1]
    assert ids[0] | ids[1] == set(pd.read_parquet(train_root / "metadata.parquet")["Id"])


def test_one_log_one_set_of_checkpoints_and_one_model(runs):
    whole, _, outputs = runs
    records = _records(whole)
    assert [s for s, _, _ in _steps(records)] == [1, 2, 3, 4]
    # step 3 is the best evaluation's
    assert sorted(p.name for p in (whole / "checkpoints").iterdir()) == ["step_2.pt", "step_3.pt", "step_4.pt"]
    assert (whole / "model" / "model.safetensors").exists() and (whole / "train_results.json").exists()
    assert outputs["whole"].count("backend gloo (CPU)") == WORLD
    assert outputs["whole"].count("Training complete") == WORLD
    assert "data shard 1 of 2" in outputs["whole"]


def test_a_resume_on_two_ranks_logs_the_uninterrupted_losses(runs):
    whole, part, outputs = runs
    resumed = _steps(_records(part))
    assert [s for s, _, _ in resumed] == [1, 2, 3, 4]
    assert resumed == _steps(_records(whole))
    assert outputs["latest"] in (2, 3)
    assert outputs["resumed"].count(f"Resuming from checkpoint step {outputs['latest']}") == WORLD


def test_eval_over_unequal_shards_stops_every_rank_together(runs):
    whole, _, outputs = runs
    records = _records(whole)
    assert any("eval_loss" in r and r["step"] == 3 for r in records)
    assert any("final_eval_loss" in r for r in records)
    assert "evaluate: stopping at batch" in outputs["whole"]
