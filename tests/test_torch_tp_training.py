"""Tensor-parallel training steps of the port on gloo ranks against the JAX package on a ``(data, model)`` mesh.

Two ranks at ``model_axis=2`` hold one model in Megatron shards
(``parallel.tensor.shard_module``) and take the same packed batch; the JAX
side is ``make_train_step`` + ``shard_train_step`` on ``make_mesh(data=1,
model=2)`` over two CPU devices, from the same weights (``state_dict_from_jax``),
NS5 in fp32 on both sides. Cases: ``forward_packed`` over packed windows
with ``input_features``, so that the audio tower's sharded layers and the
projector's column / row pair run; and the same with ``remat=True`` (the
layers' collectives run again in the recompute; the JAX step is the same
math). Then four ranks on a 2x2 grid against the JAX ``(2, 2)`` mesh, each
data group on its own packed batch without audio (the data axis and the model
axis compose); and four ranks at ``model_axis=4`` against the JAX ``(1, 4)``
mesh on the audio batch, at a config with the shipped head counts (12 / 4 / 8
at head dim 8), so that a rank holds 3 / 1 / 2 local heads as on the card: an
odd local head count keeps rope outside the attention kernels. The JAX parameters are the port's seeded init in the flax
layout (no JAX init to compile).
Tolerances are those of ``tests/test_torch_dp_training.py``: the loss within
1e-5 relative, the gradient norm within 1e-4 relative, the gathered
parameters after the step within 1e-3 of the largest update. The ranks of a
row must hold bit-equal whole parameters and equal losses and norms.

The two-rank run also checks: the no-grad forward of the sharded model (the
evaluation's route) against the one-process forward; a checkpoint written at
``model_axis=2`` is whole, restores bit-equal in one process at
``model_axis=1`` and back into a sharded model; extraction options raise under
a model group. Last, ``torchrun --nproc-per-node 2 -m cm3p_torch.train`` on
the ``smoke`` config at ``training.model_axis=2``: two steps, a checkpoint,
and a ``model/`` bundle that load bit-equal in one process.

The ranks import torch and the port only (JAX is imported inside the test
functions).
"""
import importlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.data import packed_batches
from cm3p_torch.models import CM3PModel
from cm3p_torch.models.modernbert import EncoderOptions
from cm3p_torch.parallel.mesh import make_mesh
from cm3p_torch.parallel.tensor import gather_module_state, gather_optimizer_state, shard_module
from cm3p_torch.train import MuonAdamW, TrainStep, flax_layouts, lr_schedule, to_device
from cm3p_torch.train.checkpoint import CheckpointManager

from tests.test_torch_distributed import run_ranks
from tests.test_torch_dp_cli import _env
from tests.test_torch_dp_training import LR, MAX_STEPS, _ns5_f32, _rank_batches, global_batch
from tests.test_torch_tensor_parallel import hf_to_flax

AUDIO_ID, N_TOK = 500, 8
CASES = ("packed-audio", "packed-audio-remat")
TP4 = "model-axis-4"
TP4_LOCAL_HEADS = {"beatmap": 3, "metadata": 1, "audio": 2}
TP4_TIMEOUT_S = 240  # limit on the four ranks' run
muon_module = importlib.import_module("cm3p_torch.train.muon")


def _config(make=tiny_cm3p_config, shipped_heads=False):
    cfg = make()
    cfg.beatmap_config.cls_embed = False  # mean pooling: dummy windows pool to 0
    cfg.beatmap_config.audio_token_id = AUDIO_ID
    if shipped_heads:  # the shipped head counts at head dim 8; every width divides by 4
        bc, ac, mc = cfg.beatmap_config, cfg.beatmap_config.audio_config, cfg.metadata_config
        bc.hidden_size, bc.intermediate_size, bc.num_attention_heads = 96, 128, 12
        ac.hidden_size, ac.intermediate_size, ac.num_attention_heads = 64, 128, 8
        ac.projector_intermediate_size, ac.projector_dim = 128, 96
        mc.hidden_size, mc.intermediate_size, mc.num_attention_heads = 32, 64, 4
    return cfg


def _audio_batch(seed=3):
    """A packed batch of 4 windows with 8 [AUDIO] placeholders and mel features each."""
    rng = np.random.default_rng(seed)
    samples = []
    for _ in range(4):
        length = int(rng.integers(24, 60))
        ids, mask = np.zeros(96, np.int32), np.zeros(96, np.int32)
        ids[:length], mask[:length] = rng.integers(5, 490, length), 1
        ids[1: 1 + N_TOK] = AUDIO_ID
        meta_mask = (np.arange(12) < rng.integers(4, 13)).astype(np.int32)
        samples.append({"input_ids": ids, "attention_mask": mask,
                        "input_features": rng.standard_normal((80, N_TOK * 8)).astype(np.float32),
                        "metadata_ids": (rng.integers(3, 250, 12) * meta_mask).astype(np.int32),
                        "metadata_attention_mask": meta_mask})
    return next(iter(packed_batches(iter(samples), rows=2, seq_len=128, pad_id=0, max_windows=5, drop_last=False)))


def flax_params(state: dict) -> dict:
    """The JAX ``{'params': ...}`` tree of a port state dict (numpy leaves; kernels transposed back)."""
    tree: dict = {}
    for key, t in state.items():
        path = hf_to_flax(key)
        a = t.numpy()
        if path[-1] == "kernel":
            a = a.T if a.ndim == 2 else a.transpose(2, 1, 0)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(a)
    return {"params": tree}


def _by_name(state: dict) -> dict:
    """An optimizer state dict's per-parameter tensors by parameter name."""
    return {name: {k: v.clone() for k, v in state["state"][idx].items()}
            for g in state["param_groups"] for idx, name in zip(g["params"], g["names"]) if idx in state["state"]}


def _optimizer(model):
    return MuonAdamW(model.named_parameters(), flax_layouts(model), lr_schedule(LR, MAX_STEPS), adamw_lr_ratio=0.25,
                     adamw_betas=(0.9, 0.999), model_group=getattr(model, "model_group", None))


def _sharded_model(start, mesh, remat=False, shipped_heads=False):
    model = CM3PModel(_config(shipped_heads=shipped_heads), meta_pack=4)
    model.load_state_dict(start)
    model.set_remat(remat)
    model.set_data_group(mesh.data_group)
    return shard_module(model, mesh)


# ---------------------------------------------------------------- the ranks


def _rank_steps(rank, world, specs, data_axis, ckpt_dir):
    muon_module.zeropower_via_newtonschulz5 = _ns5_f32
    mesh = make_mesh(data=data_axis, model=world // data_axis)
    data_index = mesh.coords()[0]
    out = {}
    for spec in specs:
        model = _sharded_model(spec["start"], mesh, spec["remat"], spec.get("shipped_heads", False))
        batch = to_device(spec["batches"][data_index], "cpu", packed=True)
        if spec["name"] == CASES[0]:
            with torch.no_grad():
                out["eval_loss"] = float(model.forward_packed(**batch).loss)
            try:
                model.set_options(EncoderOptions(w8a8=True))
            except ValueError as e:
                out["options_refused"] = str(e)
        opt = _optimizer(model)
        metrics = TrainStep(model, opt, packed=True)(batch)
        out[spec["name"]] = {
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "applied": metrics["applied"],
            "whole": {n: t.clone() for n, t in gather_module_state(model).items()},
            "shards": {n: p.detach().clone() for n, p in model.named_parameters()},
            "local_heads": {name: enc.layers[0].attn.Wqkv.weight.shape[0] // (3 * enc.config.head_dim)
                            for name, enc in (("beatmap", model.beatmap_model.encoder),
                                              ("metadata", model.metadata_model.encoder),
                                              ("audio", model.beatmap_model.audio_encoder.encoder))},
        }
        if spec["name"] == CASES[0]:  # a whole checkpoint, and back into a sharded model
            manager = CheckpointManager(ckpt_dir)
            manager.save(1, model, opt, micro_step=1)
            out["optimizer_whole"] = _by_name(gather_optimizer_state(opt.state_dict(), model.model_group))
            fresh = _sharded_model(spec["start"], mesh)
            fresh_opt = _optimizer(fresh)
            manager.restore(fresh, fresh_opt)
            out["restored_equal"] = all(torch.equal(p, out[CASES[0]]["shards"][n]) for n, p in fresh.named_parameters())
            out["restored_momentum_equal"] = all(
                torch.equal(fresh_opt.state[p]["momentum"], opt.state[q]["momentum"])
                for p, q in zip(fresh.parameters(), model.parameters()) if q in opt.state and "momentum" in opt.state[q])
    return out


# ---------------------------------------------------------------- the JAX side and the fixture


def _jax_step(jmodel, params, batch, data, model):
    import jax
    import jax.numpy as jnp
    import optax

    from cm3p_tpu.models import CM3PModule
    from cm3p_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from cm3p_tpu.train.muon import muon as jax_muon
    from cm3p_tpu.train.train_state import TrainState, make_train_step, shard_train_step
    from cm3p_torch.interop import state_dict_from_jax

    tx = jax_muon(optax.linear_schedule(LR, 0.0, MAX_STEPS), adamw_lr_ratio=0.25, adamw_betas=(0.9, 0.999))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
                       opt_state=tx.init(jax.tree.map(jnp.asarray, params["params"])))
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[: data * model])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn, _, _ = shard_train_step(make_train_step(jmodel, tx, method=CM3PModule.forward_packed), mesh, state, jb)
    with mesh:
        new_state, metrics = fn(state, jb, jax.random.PRNGKey(1))
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            state_dict_from_jax(jax.tree.map(np.asarray, new_state.params)))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    import jax.numpy as jnp

    from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
    from cm3p_tpu.models import CM3PModule
    from cm3p_torch.interop import init_weights, state_dict_from_jax

    from tests.test_torch_train_ops import _ns5_f32_jax

    jmodel = CM3PModule(_config(jax_tiny_config), dtype=jnp.float32, attn_impl="xla", meta_pack=4)
    start = init_weights(_config(), torch.Generator().manual_seed(0), with_metadata=True)
    params = flax_params(start)
    assert all(torch.equal(t, start[k]) for k, t in state_dict_from_jax(params).items())
    jmodel4 = CM3PModule(_config(jax_tiny_config, shipped_heads=True), dtype=jnp.float32, attn_impl="xla",
                         meta_pack=4)
    start4 = init_weights(_config(shipped_heads=True), torch.Generator().manual_seed(0), with_metadata=True)
    audio = _audio_batch()
    grid = _rank_batches("packed-2d-metadata", seed=40)  # one packed batch per data group
    specs = [{"name": name, "start": start, "remat": name.endswith("remat"), "batches": [audio]} for name in CASES]
    tmp = tmp_path_factory.mktemp("tp")
    want = {}
    jax_muon_module = importlib.import_module("cm3p_tpu.train.muon")
    # the ranks run while the JAX steps compile
    with ThreadPoolExecutor(3) as pool, pytest.MonkeyPatch.context() as mp_:
        two = pool.submit(run_ranks, _rank_steps, 2, tmp / "two", specs, 1, str(tmp / "ckpt"))
        four = pool.submit(run_ranks, _rank_steps, 4, tmp / "four", [{"name": "2x2", "start": start, "remat": False,
                                                                       "batches": grid}], 2, str(tmp / "unused"))
        axis4 = pool.submit(run_ranks, _rank_steps, 4, tmp / "axis4",
                            [{"name": TP4, "start": start4, "remat": False, "batches": [audio],
                              "shipped_heads": True}], 1, str(tmp / "unused4"), timeout=TP4_TIMEOUT_S)
        mp_.setattr(jax_muon_module, "zeropower_via_newtonschulz5", _ns5_f32_jax)
        want[CASES[0]] = want[CASES[1]] = _jax_step(jmodel, params, audio, 1, 2)
        want["2x2"] = _jax_step(jmodel, params, global_batch(grid, True), 2, 2)
        want[TP4] = _jax_step(jmodel4, flax_params(start4), audio, 1, 4)
        two, four, axis4 = two.result(), four.result(), axis4.result()
    return start, want, two, four, audio, tmp / "ckpt", (start4, axis4)


def _check_row(got, start, want):
    want_loss, want_norm, want_params = want
    assert all(g["applied"] for g in got)
    assert len({(g["loss"], g["grad_norm"]) for g in got}) == 1, [(g["loss"], g["grad_norm"]) for g in got]
    assert abs(got[0]["loss"] - want_loss) <= 1e-5 * abs(want_loss), (got[0]["loss"], want_loss)
    assert abs(got[0]["grad_norm"] - want_norm) <= 1e-4 * want_norm, (got[0]["grad_norm"], want_norm)
    for name, p in got[0]["whole"].items():
        for other in got[1:]:
            assert torch.equal(p, other["whole"][name]), f"the row's ranks differ at {name}"
        update, ref = (p - start[name]).numpy(), (want_params[name] - start[name]).numpy()
        np.testing.assert_allclose(update, ref, atol=1e-3 * max(np.abs(ref).max(), 1e-12), err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_a_two_rank_tensor_parallel_step_equals_the_jax_step_on_a_model_mesh(steps, case):
    start, want, two, *_ = steps
    _check_row([r[case] for r in two], start, want[case])
    sharded = [n for n, p in two[0][case]["shards"].items() if p.shape != start[n].shape]
    assert sharded and all(two[0][case]["shards"][n].numel() * 2 == start[n].numel() for n in sharded)
    # the audio tower's layers and the projector pair were sharded and moved
    moved = [n for n in sharded if "audio_encoder" in n and not torch.equal(two[0][case]["whole"][n], start[n])]
    assert any("multi_modal_projector.linear_2" in n for n in moved) and any("layers" in n for n in moved)


def test_a_two_by_two_grid_step_equals_the_jax_step_on_a_two_by_two_mesh(steps):
    start, want, _, four, *_ = steps
    for row in (four[:2], four[2:]):  # ranks (0, 1) and (2, 3): the grid's rows
        _check_row([r["2x2"] for r in row], start, want["2x2"])
    for name, p in four[0]["2x2"]["whole"].items():  # the data groups step on the same global gradient
        assert torch.equal(p, four[2]["2x2"]["whole"][name]), name


def test_a_four_rank_model_axis_step_equals_the_jax_step_on_a_one_by_four_mesh(steps):
    _, want, *_, (start, axis4) = steps
    got = [r[TP4] for r in axis4]
    assert all(g["local_heads"] == TP4_LOCAL_HEADS for g in got), [g["local_heads"] for g in got]
    _check_row(got, start, want[TP4])
    sharded = [n for n, p in got[0]["shards"].items() if p.shape != start[n].shape]
    assert sharded and all(got[0]["shards"][n].numel() * 4 == start[n].numel() for n in sharded)
    for tower in ("beatmap_model.encoder.", "metadata_model.", "audio_encoder.encoder."):
        assert any(tower in n and "Wqkv" in n for n in sharded), tower


def test_the_sharded_no_grad_forward_is_the_one_process_forward(steps):
    start, _, two, _, packed, *_ = steps
    model = CM3PModel(_config(), meta_pack=4)
    model.load_state_dict(start)
    with torch.no_grad():
        want = float(model.forward_packed(**to_device(packed, "cpu", packed=True)).loss)
    assert two[0]["eval_loss"] == two[1]["eval_loss"]
    assert abs(two[0]["eval_loss"] - want) <= 1e-6 * abs(want), (two[0]["eval_loss"], want)
    assert "model group" in two[0]["options_refused"]


def test_a_tensor_parallel_checkpoint_is_whole_and_restores_at_either_model_axis(steps):
    start, _, two, _, _, ckpt, _ = steps
    assert two[0]["restored_equal"] and two[1]["restored_equal"]
    assert two[0]["restored_momentum_equal"] and two[1]["restored_momentum_equal"]
    model = CM3PModel(_config(), meta_pack=4)
    model.load_state_dict(start)
    opt = _optimizer(model)
    assert CheckpointManager(str(ckpt)).restore(model, opt) == {"step": 1, "micro_step": 1}
    for name, p in model.named_parameters():
        assert torch.equal(p, two[0][CASES[0]]["whole"][name]), name
    restored, params = _by_name(opt.state_dict()), dict(model.named_parameters())
    assert restored.keys() == two[0]["optimizer_whole"].keys()
    for name, entry in two[0]["optimizer_whole"].items():
        for key, t in entry.items():
            assert torch.equal(restored[name][key], t) and t.shape == params[name].shape, (name, key)


def test_the_cli_trains_at_model_axis_two_and_its_checkpoint_and_bundle_load_whole(tmp_path):
    from cm3p_torch.inference import load_pretrained
    from cm3p_torch.train.__main__ import CONFIG_DIR, build_model, build_processor, model_config
    from cm3p_torch.utils.config import load_config

    out = tmp_path / "out"
    overrides = [f"training.output_dir={out}", "training.max_steps=2", "training.save_steps=2",
                 "training.gradient_accumulation_steps=1", "training.eval_steps=0", "training.model_axis=2"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2", "-m",
           "cm3p_torch.train", "--config-name", "smoke", "--device", "cpu", *overrides]
    run = subprocess.run(cmd, capture_output=True, text=True, env=_env(), timeout=240, cwd=tmp_path)
    assert run.returncode == 0, (run.stdout + run.stderr)[-3000:]
    assert "model shard 1 of 2" in run.stdout + run.stderr
    args = load_config(str(CONFIG_DIR), "smoke", [o for o in overrides if "model_axis" not in o])
    cfg = model_config(args, build_processor(args))
    model = build_model(args, cfg, torch.device("cpu"), seed=0)
    assert CheckpointManager(str(out / "checkpoints")).restore(model) == {"step": 2, "micro_step": 2}
    _, bundle = load_pretrained(out / "model", device="cpu", dtype=torch.float32)
    got = bundle.state_dict()
    for name, p in model.state_dict().items():
        if name in got:
            assert torch.equal(p, got[name]), name
    assert all(name in got for name in model.state_dict() if "layers" in name)
