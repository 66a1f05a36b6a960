"""The port's ``utils/profiling.py`` against the JAX package's, and the trainer's optional wandb hook, on the CPU.

``StepTimer.summary`` must equal the JAX summary exactly on the same list of times (the same numpy
arithmetic). ``trace`` writes a Chrome trace that names an ``annotate`` span. The wandb hook runs against a
stub ``wandb`` module: every ``train_log.jsonl`` record, without its ``step``, is logged at that step.
"""
import json
import logging
import sys
import types

import numpy as np
import pytest
import torch

from cm3p_tpu.utils import profiling as jax_profiling
from cm3p_torch.train.__main__ import main
from cm3p_torch.train.trainer import _wandb_run
from cm3p_torch.utils import profiling


@pytest.mark.parametrize("skip_warmup", [0, 1, 3, 10])
def test_step_timer_summary_equals_the_jax_summary(skip_warmup):
    times = list(np.random.default_rng(0).uniform(0.01, 0.2, 7))
    ours, theirs = profiling.StepTimer(), jax_profiling.StepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary(skip_warmup) == theirs.summary(skip_warmup)
    with ours:
        torch.ones(4).sum()
    assert len(ours.times) == 8 and ours.times[-1] > 0


def test_trace_writes_a_chrome_trace_that_names_the_span(tmp_path):
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("port_span"):
            (x @ x).sum()
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {event.get("name") for event in data["traceEvents"]}
    assert "port_span" in names and any("mm" in str(n) for n in names)


def test_memory_stats_and_the_link_probe_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the stats are those of its devices")
    assert profiling.device_memory_stats() == {}  # as the JAX function on a backend without stats
    with pytest.raises(RuntimeError, match="cuda"):
        profiling.probe_link(1)
    probe = profiling.probe_link(1, repeats=2, device="cpu")
    assert set(probe) == {"size_mb", "roundtrip_s", "mb_per_s", "device"} and probe["device"] == "cpu"


class _StubRun:
    def __init__(self, **kwargs):
        self.kwargs, self.logged, self.finished = kwargs, [], False

    def log(self, data, step=None):
        self.logged.append((step, data))

    def finish(self):
        self.finished = True


def test_the_trainer_logs_every_record_to_wandb(tmp_path, monkeypatch):
    runs = []

    def init(**kwargs):
        runs.append(_StubRun(**kwargs))
        return runs[-1]

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    out = tmp_path / "run"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny run is cheapest on one thread beside the suite's other workers
    try:
        main(["--config-name", "smoke", "--device", "cpu", f"training.output_dir={out}", "training.max_steps=2",
              "training.gradient_accumulation_steps=1", "training.eval_steps=2", "training.max_eval_batches=1",
              "training.load_best_model_at_end=false", "wandb_project=cm3p", "wandb_entity=team"])
    finally:
        torch.set_num_threads(threads)
    (run,) = runs
    assert run.kwargs["project"] == "cm3p" and run.kwargs["entity"] == "team"
    assert run.kwargs["mode"] == "offline" and run.kwargs["dir"] == str(out)  # configs/train/default.yaml's mode
    assert run.kwargs["config"]["training"]["max_steps"] == 2
    records = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert len(records) >= 3 and run.finished
    assert run.logged == [(r["step"], {k: v for k, v in r.items() if k != "step"}) for r in records]


def test_without_wandb_a_warning_and_the_jsonl_log_only(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # the import fails, as on a machine without the package
    with caplog.at_level(logging.WARNING, logger="cm3p_torch.train.trainer"):
        assert _wandb_run("cm3p", None, None, {}, tmp_path) is None
    assert "JSONL logging only" in caplog.text
