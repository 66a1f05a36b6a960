"""Preemption of the port's trainer: SIGKILL, then a resume (the counterpart of ``tests/test_preemption.py``).

* The one-process trainer (``python -m cm3p_torch.train --config-name smoke
  --device cpu``, 6 optimizer steps of 2 micro-steps, a checkpoint every 2)
  SIGKILLed just after its step-2 checkpoint lands, and again in the middle of
  a step (after step 3's log record, before step 4's checkpoint), with a stray
  ``*.tmp`` of a half-written save left in the checkpoint folder; each resume
  logs, from the checkpoint on, the losses and gradient norms of the
  uninterrupted run, and the stray file is ignored.
* Two ranks over gloo (``training.multihost``, a ``file://`` coordinator,
  ``training.heartbeat_timeout_seconds=10``): rank 1 SIGKILLed mid-run, rank 0
  exits non-zero within the timeout + 30 s instead of hanging.
"""
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
STEPS = 6
HEARTBEAT_S = 10
GRACE_S = 30
TIMEOUT_S = 240


def _argv(out: Path, steps: int = STEPS) -> list[str]:
    return ["--config-name", "smoke", "--device", "cpu", f"training.output_dir={out}", f"training.max_steps={steps}",
            "training.save_steps=2", "training.logging_steps=1", "training.eval_steps=0",
            "training.save_total_limit=10", "training.load_best_model_at_end=false"]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")


def _logged(out: Path) -> dict:
    """step -> (loss, grad_norm): the last record of each step (a killed run may have logged one the resume
    logs again)."""
    path = out / "train_log.jsonl"
    if not path.exists():
        return {}
    records = [json.loads(line) for line in path.read_text().splitlines() if line.strip()]
    return {r["step"]: (r["loss"], r["grad_norm"]) for r in records if "loss" in r}


def _launch(argv, log: Path) -> subprocess.Popen:
    with open(log, "w") as f:
        return subprocess.Popen([sys.executable, "-m", "cm3p_torch.train", *argv], stdout=f,
                                stderr=subprocess.STDOUT, env=_env(), cwd=log.parent)


def _kill_when(proc: subprocess.Popen, ready, log: Path) -> None:
    deadline = time.monotonic() + TIMEOUT_S
    while proc.poll() is None and time.monotonic() < deadline and not ready():
        time.sleep(0.01)
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    assert ready(), log.read_text()[-3000:]


def _run(argv, log: Path) -> None:
    proc = _launch(argv, log)
    assert proc.wait(timeout=TIMEOUT_S) == 0, log.read_text()[-3000:]


def test_a_sigkilled_trainer_resumes_to_the_uninterrupted_losses(tmp_path):
    # every run in a process of its own with the same threads: the sums of a step then go in one order
    _run(_argv(tmp_path / "whole"), tmp_path / "whole.log")
    want = _logged(tmp_path / "whole")
    assert sorted(want) == list(range(1, STEPS + 1))

    for label, ready in (
        ("after-save", lambda out: (out / "checkpoints" / "step_2.pt").exists()),
        ("mid-step", lambda out: 3 in _logged(out)),
    ):
        out = tmp_path / label
        proc = _launch(_argv(out), tmp_path / f"{label}.log")
        _kill_when(proc, lambda: ready(out), tmp_path / f"{label}.log")
        ckpts = out / "checkpoints"
        # step 2's checkpoint, or a later one where this host was slow to see the run get there
        latest = max(int(p.stem.split("_")[1]) for p in ckpts.glob("step_*.pt"))
        assert 2 <= latest < STEPS, sorted(os.listdir(ckpts))
        (ckpts / f"step_{latest + 2}.999.tmp").write_bytes(b"half a checkpoint")  # a save the kill cut short
        _run(_argv(out), tmp_path / f"{label}-resumed.log")
        assert f"Resuming from checkpoint step {latest}" in (tmp_path / f"{label}-resumed.log").read_text()
        assert sorted(p.name for p in ckpts.glob("*.pt")) == ["step_2.pt", "step_4.pt", "step_6.pt"]
        got = _logged(out)
        assert sorted(got) == list(range(1, STEPS + 1)), label
        for step in range(1, STEPS + 1):
            assert got[step] == want[step], (label, step, got[step], want[step])


def test_a_sigkilled_rank_makes_its_peer_exit_within_the_heartbeat_timeout(tmp_path):
    procs = []
    for rank in range(2):
        argv = _argv(tmp_path / "run", steps=10_000) + [
            "training.multihost=true", f"training.coordinator_address=file://{tmp_path / 'store'}",
            "training.num_processes=2", f"training.process_id={rank}",
            f"training.heartbeat_timeout_seconds={HEARTBEAT_S}",
        ]
        procs.append(_launch(argv, tmp_path / f"rank{rank}.log"))
    try:
        deadline = time.monotonic() + TIMEOUT_S
        while not _logged(tmp_path / "run") and time.monotonic() < deadline and procs[0].poll() is None:
            time.sleep(0.05)
        assert _logged(tmp_path / "run"), (tmp_path / "rank0.log").read_text()[-3000:]
        procs[1].send_signal(signal.SIGKILL)
        t0 = time.monotonic()
        try:
            code = procs[0].wait(timeout=HEARTBEAT_S + GRACE_S)
        except subprocess.TimeoutExpired:
            code = None
        waited = time.monotonic() - t0
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert code not in (None, 0), f"rank 0 still running (or exited 0) {waited:.1f} s after its peer was killed"
    assert waited <= HEARTBEAT_S + GRACE_S
