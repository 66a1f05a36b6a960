"""Freezing and the command-line tools over an MMRS root: the port against the JAX package, on the CPU.

The root is ``tests/test_torch_mmrs.py``'s. Cases:

* freezing: 3 optimizer steps of the port's ``build_optimizer`` against JAX
  ``train.build_optimizer`` (its ``optax.masked`` gate after the whole
  optimizer) on the same seeded gradients, AdamW and Muon (NS5 in fp32 on both
  sides), ``unfreeze_beatmap_model_at_step`` 2: parameters after every step
  within ``update_tol`` of ``tests/test_torch_mmrs_training.py``; the frozen
  towers bit-unchanged in the first two steps, moving in the third, the rest
  moving from the first;
* the CLIs: ``python -m cm3p_torch.train --config-name smoke_mmrs`` trains,
  checkpoints and resumes through the seek; ``python -m
  cm3p_torch.validate_dataset`` writes JAX ``validate_dataset.main``'s
  ``stats.json`` (rates aside); ``python -m cm3p_torch.extract --dataset-path``
  writes the JAX tool's beatmap ids and metadata columns, and the embeddings of
  the port's own ``--beatmap-files`` run over the same folders within 1e-6.
"""
import importlib
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

import extract_beatmap_embeddings as jax_extract
import train as jax_train
import validate_dataset as jax_validate
from cm3p_tpu.models import CM3PModule
from cm3p_torch.extract import main as extract_main
from cm3p_torch.interop import state_dict_from_jax
from cm3p_torch.train import to_device
from cm3p_torch.train.__main__ import build_model, build_optimizer, main, mmrs_batches, model_config
from cm3p_torch.validate_dataset import main as validate_main

from tests.test_torch_mmrs import build_mmrs_root
from tests.test_torch_mmrs_training import _pair, update_tol
from tests.test_torch_train_ops import _ns5_f32_jax, _ns5_f32_torch

jax_muon_module = importlib.import_module("cm3p_tpu.train.muon")
muon_module = importlib.import_module("cm3p_torch.train.muon")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_mmrs_root(tmp_path_factory.mktemp("mmrs_tools"))


# --------------------------------------------------------------------- freezing


def _grads_like(params: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (0.01 * rng.standard_normal(p.shape)).astype(np.float32), params)


@pytest.mark.parametrize("frozen", [("freeze_beatmap_model=true",),
                                    ("freeze_beatmap_model=true", "freeze_metadata_model=true")])
@pytest.mark.parametrize("optim", ["adamw", "muon"])
def test_freezing_matches_the_jax_optimizer_chain(root, optim, frozen, monkeypatch):
    monkeypatch.setattr(jax_muon_module, "zeropower_via_newtonschulz5", _ns5_f32_jax)
    monkeypatch.setattr(muon_module, "zeropower_via_newtonschulz5", _ns5_f32_torch)
    extra = [f"training.optim={optim}", "unfreeze_beatmap_model_at_step=2", "training.weight_decay=0.01",
             "training.max_steps=10", *frozen]
    args, proc, jargs, jproc = _pair(root, *extra)
    batch = next(iter(mmrs_batches(args, proc, test=False)()))
    _, jmodel = jax_train.build_model(jargs, jproc)
    jb = {k: jnp.asarray(v.numpy()) for k, v in to_device(batch, "cpu", True).items()}
    params = jax.tree.map(np.asarray, jax.jit(lambda r, b: jmodel.init(r, method=CM3PModule.forward_packed, **b))(
        jax.random.PRNGKey(0), jb))["params"]
    tx = jax_train.build_optimizer(jargs)
    opt_state = tx.init(jax.tree.map(jnp.asarray, params))
    jparams = jax.tree.map(jnp.asarray, params)

    start = state_dict_from_jax({"params": params})
    model = build_model(args, model_config(args, proc), torch.device("cpu"), seed=0)
    model.load_state_dict(start)
    opt = build_optimizer(args, model)
    towers = [t for t in ("beatmap_model", "metadata_model") if any(f.startswith(f"freeze_{t}") for f in frozen)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for t in range(3):
        grads = _grads_like(params, seed=t)
        updates, opt_state = jax.jit(tx.update)(jax.tree.map(jnp.asarray, grads), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jparams)})
        torch_grads = state_dict_from_jax({"params": grads})
        for name, p in model.named_parameters():
            p.grad = torch_grads[name].clone()
        opt.step()
        gate_open = t >= 2
        for name, p in model.named_parameters():
            moved = (want[name] - before[name]).numpy()
            got = (p.detach() - before[name]).numpy()
            np.testing.assert_allclose(got, moved, atol=update_tol(moved, before[name]),
                                       err_msg=f"step {t + 1} {name}")
            held = name.split(".", 1)[0] in towers and not gate_open
            assert torch.equal(p.detach(), before[name]) == held, f"step {t + 1} {name}: held {held}"
            assert held == (not moved.any()), f"step {t + 1} {name}"
        before = {n: p.detach().clone() for n, p in model.named_parameters()}


# --------------------------------------------------------------------- the CLIs


def test_the_training_cli_trains_checkpoints_and_resumes_through_the_seek(root, tmp_path, caplog):
    out = tmp_path / "run"
    common = ["--config-name", "smoke_mmrs", "--device", "cpu", f"dataset.train_dataset_paths=[{root}]",
              f"dataset.test_dataset_paths=[{root}]", f"training.output_dir={out}", "training.save_steps=2",
              "training.eval_steps=2", "training.max_eval_batches=1", "training.load_best_model_at_end=false"]
    caplog.set_level(logging.INFO)
    trainer = main(common + ["training.max_steps=2"])
    assert trainer.ckpt.steps() == [2]
    trainer = main(common + ["training.max_steps=3"])
    assert "resume seek: replaying 2 batches" in caplog.text
    records = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records if "loss" in r)
    assert any("final_eval_loss" in r for r in records)
    assert trainer.ckpt.steps() == [2, 3]
    assert (out / "model" / "model.safetensors").exists() and (out / "dataloader").is_dir()


def test_validate_dataset_writes_the_jax_stats(root, tmp_path):
    overrides = [f"dataset.train_dataset_paths=[{root}]", "dataset.dt_augment_prob=0.5"]
    ours = validate_main(["--config-name", "smoke_mmrs", "--output-dir", str(tmp_path / "a"), *overrides])
    jax_validate.main(["--config-name", "smoke_mmrs", "--output-dir", str(tmp_path / "b"), *overrides])
    a, b = (json.loads((tmp_path / d / "stats.json").read_text()) for d in "ab")
    for stats in (a, b):
        del stats["samples_per_sec"], stats["tokens_per_sec"]
    assert a == b and a["num_samples"] == ours["num_samples"] > 0
    assert a["year_distribution_per_slice"]


def test_extract_from_a_dataset_root(root, tmp_path):
    common = ["--tiny-model", "--max-length", "1024"]
    extract_main(["--dataset-path", str(root), "--device", "cpu", "--output", str(tmp_path / "a.parquet"), *common])
    jax_extract.main(["--dataset-path", str(root), "--cpu", "--output", str(tmp_path / "b.parquet"), *common])
    folders = sorted(str(p) for p in (root / "data").iterdir())
    files = extract_main(["--device", "cpu", "--output", str(tmp_path / "c.parquet"), *common,
                          *[arg for f in folders for arg in ("--beatmap-files", f)]])
    a, b, c = (pd.read_parquet(tmp_path / f"{x}.parquet") for x in "abc")
    assert sorted(a["beatmap_id"]) == sorted(b["beatmap_id"]) == sorted(c["beatmap_id"]) and len(a) == 8
    assert list(a.columns) == list(b.columns)
    a, b = a.set_index("beatmap_id").sort_index(), b.set_index("beatmap_id").sort_index()
    for col in ("BeatmapSetId", "BeatmapFile", "Status", "Creator"):
        assert a[col].tolist() == b[col].tolist(), col
    for bid, vec in a["embedding"].items():
        np.testing.assert_allclose(np.asarray(vec), files[bid], atol=1e-6, err_msg=str(bid))
