"""Sequence parallelism of the port against the JAX package on the CPU.

* The rectangular form of the segment attention (Lq != Lk, a key mask):
  ``segment_attention_rect_plain`` through ``ops.attention`` against the JAX
  ``flash_attention(q, k, v, key_mask=...)``, Pallas in interpret mode, fp32,
  atol 3e-5 (the JAX package's own sequence-parallel test).
* Two ranks over a gloo group (spawned processes, a ``file://`` store), fp32:
  ``sequence_sharded_attention`` for a global and a windowed layer against the
  JAX ``sequence_sharded_attention`` on a 2-device mesh of the CPU devices
  (atol 3e-5); the tiny-config beatmap tower with ``sp_group`` against
  ``CM3PModule(sp_mesh=...)`` ``get_beatmap_features`` at L = 512 with the same
  weights (``interop/from_jax.py``; atol 2e-4, the JAX model test's own), and
  its hidden states at every position and its features against the port's
  dense forward (atol 1e-5); packed segments and a length that does not divide
  over the ranks raise on each rank.

The ranks import torch and the port only; JAX is imported inside the test
functions, so the spawned processes start without it.
"""
import functools
import multiprocessing as mp
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cm3p_torch import ops
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.inference import load_model

WORLD = 2
ATOL_ATTN = 3e-5
ATOL_MODEL = 2e-4
ATOL_DENSE = 1e-5
B, L_ATTN, H, D = 2, 256, 2, 64
L_MODEL = 512
RANK_TIMEOUT_S = 240


def _attn_inputs():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, L_ATTN, H, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L_ATTN), np.int32)
    mask[0, 200:] = 0
    mask[1, 150:] = 0
    return q, k, v, mask


def _model_inputs():
    rng = np.random.default_rng(1)
    ids = rng.integers(5, 500, (1, L_MODEL)).astype(np.int64)
    mask = np.ones((1, L_MODEL), np.int32)
    mask[0, -100:] = 0
    return ids, mask


def _model_config():
    cfg = tiny_cm3p_config()
    cfg.beatmap_config.vocab_size = 512
    return cfg


# ---------------------------------------------------------------- the ranks


def _rank_work(rank: int, world: int, state_path: str) -> dict:
    from cm3p_torch.parallel import sequence_sharded_attention

    group = torch.distributed.group.WORLD
    out = {}
    q, k, v, mask = (torch.from_numpy(x) for x in _attn_inputs())
    rows = slice(rank * L_ATTN // world, (rank + 1) * L_ATTN // world)
    with torch.no_grad():
        for window in (None, 64):
            out[f"attn_{window}"] = sequence_sharded_attention(
                q[:, rows], k[:, rows], v[:, rows], mask[:, rows], group, window
            )
    model = load_model(_model_config(), torch.load(state_path), device="cpu", dtype=torch.float32)
    model.sp_group = group
    ids, mask = (torch.from_numpy(x) for x in _model_inputs())
    with torch.no_grad():
        out["hidden"] = model.beatmap_model(ids, attention_mask=mask, sp_group=group)
        out["features"] = model.get_beatmap_features(ids, attention_mask=mask, normalize=True)
        raised = {}
        for name, call in (
            ("packed", lambda: model.get_packed_beatmap_features(
                ids, torch.ones_like(ids, dtype=torch.int32), torch.tensor([0, 1]), torch.tensor([1, 1]))),
            ("divide", lambda: model.get_beatmap_features(ids[:, :-1], attention_mask=mask[:, :-1])),
        ):
            try:
                call()
            except ValueError as exc:
                raised[name] = str(exc)
        out["raised"] = raised
    return out


def _rank_main(rank: int, world: int, store: str, state_path: str, out_dir: str) -> None:
    torch.distributed.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        torch.save(_rank_work(rank, world, state_path), Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def _run_ranks(tmp: Path, state_path: Path) -> list[dict]:
    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=_rank_main, args=(r, WORLD, str(tmp / "store"), str(state_path), str(tmp)))
        for r in range(WORLD)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    # a rank that fails leaves the other waiting in a collective: stop both then
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.1)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"
    return [torch.load(tmp / f"rank{r}.pt") for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_interpret():
    import jax.experimental.pallas as pl

    from cm3p_tpu.ops import flash_attention as fa

    with pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        mp_.setattr(fa, "ONLINE_MAX", True)  # the port's running max (ROADMAP Queue 3)
        yield


@pytest.fixture(scope="module")
def jax_params():
    import jax
    import jax.numpy as jnp

    from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
    from cm3p_tpu.models import CM3PModule

    cfg = jax_tiny_config()
    cfg.beatmap_config.vocab_size = 512
    ids, mask = _model_inputs()
    model = CM3PModule(cfg, attn_impl="xla")
    feats = np.zeros((1, 80, 64), np.float32)  # creates the audio tower's parameters; the runs have no audio
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32), input_features=jnp.asarray(feats),
                        attention_mask=jnp.asarray(mask), method=CM3PModule.get_beatmap_features)
    return cfg, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def ranks(jax_params, tmp_path_factory):
    from cm3p_torch.interop import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("sp")
    state_path = tmp / "state.pt"
    torch.save(state_dict_from_jax(jax_params[1]), state_path)
    return _run_ranks(tmp, state_path)


def _mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(WORLD), ("seq",))


# ---------------------------------------------------------------- the tests


@pytest.mark.parametrize("lq, lk", [(128, 256), (100, 256), (320, 192)])
def test_rect_plain_matches_jax_flash_attention(jax_interpret, lq, lk):
    import jax.numpy as jnp

    from cm3p_tpu.ops.flash_attention import flash_attention

    rng = np.random.default_rng(lq + lk)
    q = rng.standard_normal((B, lq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, lk, H, D)).astype(np.float32) for _ in range(2))
    mask = np.ones((B, lk), np.int32)
    mask[0, lk - 70:] = 0
    mask[1, 64:128] = 0  # a fully masked key tile
    want = np.asarray(flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_mask=jnp.asarray(mask)))
    ops.reset_launch_counts()
    got = ops.attention(*(torch.from_numpy(x) for x in (q, k, v)), key_mask=torch.from_numpy(mask))
    assert got.shape == (B, lq, H, D)
    assert not any(ops.launch_counts().values())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_ATTN)


def test_rect_route_refuses_what_the_jax_package_never_runs():
    q = torch.randn(1, 64, H, D, requires_grad=True)
    k, v = torch.randn(1, 128, H, D), torch.randn(1, 128, H, D)
    with pytest.raises(ValueError, match="forward only"):
        ops.attention(q, k, v)
    q = q.detach()
    with pytest.raises(ValueError, match="window"):
        ops.attention(q, k, v, window=16)
    with pytest.raises(ValueError, match="rope_theta"):
        ops.attention(q, k, v, rope_theta=1e4)
    with pytest.raises(ValueError, match="segment_ids"):
        ops.attention(q, k, v, segment_ids=torch.ones(1, 128, dtype=torch.int32))
    assert ops.attention(q, k, v).shape == q.shape


def test_sequence_sharded_attention_refuses_autograd():
    from cm3p_torch.parallel import sequence_sharded_attention

    q = torch.randn(1, 64, H, D, requires_grad=True)
    with pytest.raises(ValueError, match="forward only"):
        sequence_sharded_attention(q, q, q, None, group=None)


@pytest.mark.parametrize("window", [None, 64])
def test_sequence_sharded_attention_matches_jax(jax_interpret, ranks, window):
    import jax.numpy as jnp

    from cm3p_tpu.parallel.sequence import sequence_sharded_attention as jax_ssa

    q, k, v, mask = _attn_inputs()
    with _mesh() as mesh:
        want = np.asarray(jax_ssa(*(jnp.asarray(x) for x in (q, k, v, mask)), mesh, seq_axis="seq", window=window))
    got = torch.cat([r[f"attn_{window}"] for r in ranks], dim=1).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL_ATTN)


def test_sp_beatmap_tower_matches_jax_and_the_dense_forward(jax_interpret, jax_params, ranks):
    import jax.numpy as jnp

    from cm3p_tpu.models import CM3PModule
    from cm3p_torch.interop import state_dict_from_jax

    cfg, params = jax_params
    ids, mask = _model_inputs()
    batch = dict(input_ids=jnp.asarray(ids, jnp.int32), attention_mask=jnp.asarray(mask))
    with _mesh() as mesh:
        sp = CM3PModule(cfg, attn_impl="pallas", sp_mesh=mesh)
        want = np.asarray(sp.apply(params, method=CM3PModule.get_beatmap_features, normalize=True, **batch))
    for r in ranks:  # every rank returns the whole sequence and the same features
        assert torch.equal(r["hidden"], ranks[0]["hidden"]) and torch.equal(r["features"], ranks[0]["features"])
    np.testing.assert_allclose(ranks[0]["features"].numpy(), want, atol=ATOL_MODEL)

    dense = load_model(_model_config(), state_dict_from_jax(params), device="cpu", dtype=torch.float32)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        hidden = dense.beatmap_model(t_ids, attention_mask=t_mask)
        feats = dense.get_beatmap_features(t_ids, attention_mask=t_mask, normalize=True)
    torch.testing.assert_close(ranks[0]["hidden"], hidden, atol=ATOL_DENSE, rtol=0)
    torch.testing.assert_close(ranks[0]["features"], feats, atol=ATOL_DENSE, rtol=0)


def test_sp_raises_on_packed_segments_and_on_a_length_that_does_not_divide(ranks):
    for r in ranks:
        assert "segment_ids" in r["raised"]["packed"]
        assert "does not divide" in r["raised"]["divide"]
