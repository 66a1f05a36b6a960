"""The port's data-parallel runtime (``cm3p_torch/parallel/distributed.py``, ``mesh.py``) on the CPU.

* ``data_shard_group`` against the JAX function on the same layouts of
  processes over a (data, model) grid: (4, 1), (2, 2) with the model axis
  inside processes and across them, and a layout where a process covers two
  data blocks (both raise). The JAX function reads a stand-in mesh whose
  devices carry ``process_index``, with ``jax.process_index`` patched.
* Three ranks spawned over gloo (a ``file://`` store, a per-rank timeout):
  ``gather_rows`` and ``all_reduce_sum`` forward and backward against a
  one-process reference of the sum of every rank's loss (the backward is the
  adjoint: rank r gets d(sum of the ranks' losses)/d(its rows)): the gather
  bit for bit, sums and gradients (fp64) within 1e-12;
  ``all_reduce_gradients`` (the mean, None kept), ``all_processes_have``,
  ``all_gather_ints``, ``broadcast_parameters``, ``make_mesh`` and
  ``data_shard_group`` on the live group, and ``initialize_distributed``
  called twice.
* The backend rule, the grid's batch placement, and ``training.model_axis=3``
  raising in ``python -m cm3p_torch.train``, naming the tower whose heads it
  does not divide.

:func:`run_ranks` is the spawn helper of the other data-parallel tests. JAX is
imported inside the test functions only, so the spawned ranks start without it.
"""
import multiprocessing as mp
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cm3p_torch.parallel import distributed
from cm3p_torch.parallel.mesh import Mesh, make_mesh

RANK_TIMEOUT_S = 120


def _rank_entry(rank: int, world: int, store: str, out_dir: str, fn, args: tuple) -> None:
    torch.set_num_threads(1)
    distributed.initialize_distributed(f"file://{store}", world, rank, heartbeat_timeout_seconds=RANK_TIMEOUT_S)
    try:
        torch.save(fn(rank, world, *args), Path(out_dir) / f"rank{rank}.pt")
    finally:
        distributed.shutdown()


def run_ranks(fn, world: int, tmp: Path, *args, timeout: float = RANK_TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes over a gloo group (``file://`` store in
    ``tmp``); returns each rank's result. A rank that fails or outlives ``timeout`` fails the call, and the
    others are stopped (a rank left in a collective would wait for ever)."""
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, world, str(tmp / "store"), str(tmp), fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.05)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- data_shard_group against the JAX function

LAYOUTS = {
    "4x1": [[0], [1], [2], [3]],
    "2x2-model-inside-processes": [[0, 0], [1, 1]],
    "2x2-model-across-processes": [[0, 1], [2, 3]],
    "a-process-on-two-data-blocks": [[0, 1], [1, 2]],
}


class _Device:
    def __init__(self, process_index):
        self.process_index = process_index


class _StandInMesh:
    axis_names = ("data", "model")

    def __init__(self, grid):
        self.devices = np.array([[_Device(p) for p in row] for row in grid], dtype=object)
        self.shape = dict(zip(self.axis_names, np.asarray(grid).shape))


def _outcome(call):
    try:
        return call()
    except ValueError:
        return "raises"


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_data_shard_group_matches_the_jax_function(layout, monkeypatch):
    import jax

    from cm3p_tpu.parallel.distributed import data_shard_group as jax_data_shard_group

    grid = LAYOUTS[layout]
    outcomes = []
    for pid in sorted({p for row in grid for p in row}):
        monkeypatch.setattr(jax, "process_index", lambda pid=pid: pid)
        want = _outcome(lambda: jax_data_shard_group(_StandInMesh(grid)))
        got = _outcome(lambda: distributed.data_shard_group(np.asarray(grid), process=pid))
        assert got == want, (layout, pid)
        outcomes.append(got)
    if layout == "a-process-on-two-data-blocks":
        assert "raises" in outcomes
    else:
        assert "raises" not in outcomes


def test_the_grid_places_batch_rows_by_data_index():
    mesh = Mesh(np.arange(4).reshape(2, 2))
    assert mesh.shape == {"data": 2, "model": 2}
    assert [mesh.local_rows(6, r) for r in range(4)] == [slice(0, 3), slice(0, 3), slice(3, 6), slice(3, 6)]
    with pytest.raises(ValueError, match="does not split"):
        mesh.local_rows(5, 0)
    single = make_mesh()  # no process group: one rank
    assert single.grid.tolist() == [[0]] and single.data_group is None
    assert distributed.data_shard_group(single) == (0, 1)
    with pytest.raises(ValueError, match="does not match"):
        make_mesh(data=2)


def test_the_backend_rule(monkeypatch):
    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    assert distributed.choose_backend(cpu, 1) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.choose_backend(gpu, 2) == "nccl"  # a GPU per rank
    assert distributed.choose_backend(gpu, 3) == "gloo"  # ranks share a GPU
    assert distributed.rank_device(gpu, 3) == torch.device("cuda", 1)
    assert distributed.rank_device(cpu, 3) == cpu


def test_no_process_group_is_a_no_op():
    assert not distributed.active()
    x = torch.randn(3, 2, requires_grad=True)
    assert distributed.gather_rows(x) is x and distributed.all_reduce_sum(x) is x
    grads = [torch.ones(2), None]
    assert distributed.all_reduce_gradients(grads) == grads
    assert distributed.all_processes_have(False) is False and distributed.all_processes_have(1) is True
    assert (distributed.process_index(), distributed.process_count(), distributed.is_primary()) == (0, 1, True)


def test_model_axis_above_one_raises(tmp_path):
    """A model axis that does not divide a tower's heads raises, naming the tower (3 against the 4 heads of
    every tower of the ``smoke`` model: the metadata tower is named with the others)."""
    from cm3p_torch.train.__main__ import main

    with pytest.raises(ValueError, match="the metadata tower's 4 heads"):
        main(["--config-name", "smoke", "--device", "cpu", f"training.output_dir={tmp_path}",
              "training.model_axis=3"])


# ---------------------------------------------------------------- the collectives on three ranks

WORLD = 3
ROWS, COLS = 2, 3


def _inputs(rank):
    return torch.from_numpy(np.random.default_rng(rank).standard_normal((ROWS, COLS)))


def _weights(rank):
    return torch.from_numpy(np.random.default_rng(10 + rank).standard_normal((WORLD * ROWS, COLS)))


def _rank_loss(rank, gathered, reduced):
    """Rank r's own loss of the gathered rows and the reduced sum: different on every rank."""
    return (_weights(rank) * gathered).sum() + (rank + 1) * (gathered ** 3).sum() + (rank + 2) * (reduced ** 2).sum()


def _collectives(rank, world):
    x = _inputs(rank).requires_grad_(True)
    gathered = distributed.gather_rows(x)
    reduced = distributed.all_reduce_sum(x.sum(0))
    _rank_loss(rank, gathered, reduced).backward()
    assert distributed.initialize_distributed() == "gloo"  # idempotent
    mesh = make_mesh()
    grads = distributed.all_reduce_gradients([torch.full((2, 2), float(rank)), None, torch.arange(3.0) * rank])
    module = torch.nn.Linear(2, 2)
    torch.nn.init.constant_(module.weight, float(rank))
    distributed.broadcast_parameters(module)
    return {
        "gathered": gathered.detach(), "reduced": reduced.detach(), "grad": x.grad,
        "grads": grads, "have": [distributed.all_processes_have(flag) for flag in (True, rank != 1)],
        "ints": distributed.all_gather_ints((10 * rank + 1, rank)),
        "shard": distributed.data_shard_group(mesh), "grid": mesh.grid.tolist(),
        "weight": module.weight.detach().clone(),
    }


def test_collectives_forward_and_backward_against_one_process(tmp_path):
    results = run_ranks(_collectives, WORLD, tmp_path)
    xs = [_inputs(r).requires_grad_(True) for r in range(WORLD)]
    gathered = torch.cat(xs)
    reduced = sum(x.sum(0) for x in xs)
    sum(_rank_loss(r, gathered, reduced) for r in range(WORLD)).backward()
    for rank, res in enumerate(results):
        assert torch.equal(res["gathered"], gathered.detach())
        torch.testing.assert_close(res["reduced"], reduced.detach(), rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(res["grad"], xs[rank].grad, rtol=1e-12, atol=1e-12)
        mean = sum(range(WORLD)) / WORLD
        assert torch.equal(res["grads"][0], torch.full((2, 2), mean)) and res["grads"][1] is None
        assert torch.equal(res["grads"][2], torch.arange(3.0) * mean)
        assert res["have"] == [True, False]
        assert res["ints"] == [[1, 0], [11, 1], [21, 2]]
        assert res["shard"] == (rank, WORLD) and res["grid"] == [[0], [1], [2]]
        assert torch.equal(res["weight"], torch.zeros(2, 2))  # rank 0's
