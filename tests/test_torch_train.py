"""One packed contrastive training step of the port against the JAX package, and the trainer.

The whole ``forward_packed`` step on a tiny fp32 config: the JAX
``make_train_step(CM3PModule(tiny, attn_impl="xla", meta_pack=4), muon,
method=forward_packed)`` and the port's ``TrainStep`` with ``MuonAdamW`` start
from the same weights (``state_dict_from_jax``) and see the same packed batch
(ragged metadata masks, a padded window table with dummy windows, mean pooling
so that dummy windows pool to zero vectors). Tolerances: loss 1e-5 relative;
each gradient 2e-4 of its largest entry (fp32 sums in another order through 4
beatmap and 2 metadata layers); parameters after one step 1e-3 of the largest
update, with NS5 in fp32 on both sides (NS5 amplifies the gradients' 1e-4
differences; bf16 NS5 is compared by cosine in ``test_torch_train_ops.py``).

The trainer: ``python -m cm3p_torch.train --config-name smoke --device cpu``
in-process, then a resume; its final model loads with ``load_pretrained`` and
embeds the bundled map.
"""
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.data.packing_collator import packed_batches as jax_packed_batches
from cm3p_tpu.models import CM3PModule
from cm3p_tpu.train.muon import muon as jax_muon
from cm3p_tpu.train.train_state import TrainState, make_train_step
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.data import packed_batches
from cm3p_torch.inference import embed_beatmap, load_pretrained
from cm3p_torch.interop import state_dict_from_jax
from cm3p_torch.models import CM3PModel
from cm3p_torch.train import MuonAdamW, TrainStep, flax_layouts, lr_schedule, to_device
from cm3p_torch.train.__main__ import main

from tests.test_torch_train_ops import _ns5_f32_jax, _ns5_f32_torch

LR, MAX_STEPS = 1e-3, 10
BUNDLED_MAP = str(Path(__file__).resolve().parent.parent / "resources"
                  / "Denkishiki Karen Ongaku Shuudan - Aoki Kotou no Anguis (OliBomby) [Ardens Spes].osu")
jax_muon_module = importlib.import_module("cm3p_tpu.train.muon")
muon_module = importlib.import_module("cm3p_torch.train.muon")


def _samples(n=5, v=3, meta_len=12, seq_max=96, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(24, seq_max))
        ids = np.zeros(seq_max, np.int32)
        mask = np.zeros(seq_max, np.int32)
        ids[:length], mask[:length] = rng.integers(5, 500, length), 1
        meta_mask = (np.arange(meta_len)[None, :] < rng.integers(4, meta_len + 1, (v, 1))).astype(np.int32)
        classes = np.arange(v, dtype=np.int32)
        out.append({
            "input_ids": ids, "attention_mask": mask,
            "metadata_ids": (rng.integers(3, 250, (v, meta_len)) * meta_mask).astype(np.int32),
            "metadata_attention_mask": meta_mask,
            "metadata_variation_classes": classes,
        })
    return out


def _configs():
    jcfg, tcfg = jax_tiny_config(), tiny_cm3p_config()
    for cfg in (jcfg, tcfg):
        cfg.beatmap_config.cls_embed = False  # mean pooling: dummy windows pool to 0
    return jcfg, tcfg


@pytest.fixture(scope="module")
def step_pair():
    samples = _samples()
    (batch,) = packed_batches(iter(samples), rows=3, seq_len=128, pad_id=0, max_windows=7, drop_last=False)
    (jbatch,) = jax_packed_batches(iter(samples), rows=3, seq_len=128, pad_id=0, max_windows=7, drop_last=False)
    for key in jbatch:
        np.testing.assert_array_equal(batch[key], jbatch[key])
    assert batch["window_valid"].tolist() == [1] * 5 + [0] * 2
    jcfg, tcfg = _configs()
    jmodel = CM3PModule(jcfg, dtype=jnp.float32, attn_impl="xla", meta_pack=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = np.random.default_rng(1)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(rng.integers(5, 500, (2, 64)).astype(np.int32)),
        input_features=jnp.asarray(rng.standard_normal((2, 80, 64)).astype(np.float32)),
        metadata_ids=jb["metadata_ids"][:2],
    )
    return jcfg, tcfg, jmodel, jax.tree.map(np.asarray, params), batch, jb


def test_forward_packed_train_step_matches_the_jax_package(step_pair, monkeypatch):
    monkeypatch.setattr(jax_muon_module, "zeropower_via_newtonschulz5", _ns5_f32_jax)
    monkeypatch.setattr(muon_module, "zeropower_via_newtonschulz5", _ns5_f32_torch)
    _, tcfg, jmodel, params, batch, jb = step_pair

    def loss_fn(p):
        return jmodel.apply({"params": p}, **jb, method=CM3PModule.forward_packed).loss

    jgrads = jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, params["params"]))
    tx = jax_muon(optax.linear_schedule(LR, 0.0, MAX_STEPS), adamw_lr_ratio=0.25, adamw_betas=(0.9, 0.999))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
                       opt_state=tx.init(jax.tree.map(jnp.asarray, params["params"])))
    new_state, metrics = jax.jit(make_train_step(jmodel, tx, method=CM3PModule.forward_packed))(
        state, jb, jax.random.PRNGKey(1)
    )
    want_grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    want_params = state_dict_from_jax(jax.tree.map(np.asarray, new_state.params))

    start = state_dict_from_jax(params)
    model = CM3PModel(tcfg, meta_pack=4)
    model.load_state_dict(start)
    opt = MuonAdamW(model.named_parameters(), flax_layouts(model), lr_schedule(LR, MAX_STEPS),
                    adamw_lr_ratio=0.25, adamw_betas=(0.9, 0.999))
    step = TrainStep(model, opt, packed=True)
    dev = to_device(batch, "cpu", packed=True)
    loss, grads, norm = step.grads(dev)
    assert abs(float(loss) - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
    assert abs(float(norm) - float(metrics["grad_norm"])) <= 1e-4 * float(metrics["grad_norm"])
    names = [n for n, _ in model.named_parameters()]
    for name, g in zip(names, grads):
        want = want_grads[name].numpy()
        if g is None:  # the audio tower: forward_packed without audio never calls it
            assert name.startswith("beatmap_model.audio_encoder.") and not want.any(), name
            continue
        assert np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), want, atol=2e-4 * max(np.abs(want).max(), 1e-12), err_msg=name)

    metrics_port = step(dev)
    assert metrics_port["applied"]
    for name, p in model.named_parameters():
        got = (p.detach() - start[name]).numpy()
        ref = (want_params[name] - start[name]).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-3 * max(np.abs(ref).max(), 1e-12), err_msg=name)


def test_gradient_accumulation_applies_the_mean_gradient(step_pair):
    _, tcfg, _, params, batch, _ = step_pair
    start = state_dict_from_jax(params)
    dev = to_device(batch, "cpu", packed=True)
    model = CM3PModel(tcfg, meta_pack=4)
    model.load_state_dict(start)
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    step = TrainStep(model, opt, packed=True, accumulation_steps=2)
    _, grads, _ = step.grads(dev)
    assert not step(dev)["applied"]
    assert all(torch.equal(p.detach(), start[n]) for n, p in model.named_parameters())
    assert step(dev)["applied"]
    for (name, p), g in zip(model.named_parameters(), grads):
        want = start[name] if g is None else start[name] - g
        torch.testing.assert_close(p.detach(), want, atol=1e-6, rtol=1e-5)


def test_smoke_cli_trains_logs_checkpoints_and_resumes(tmp_path):
    out = tmp_path / "run"
    common = ["--config-name", "smoke", "--device", "cpu", f"training.output_dir={out}",
              "training.eval_steps=2", "training.save_steps=2", "training.save_total_limit=2",
              "training.load_best_model_at_end=false"]
    trainer = main(common + ["training.max_steps=2"])
    records = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    steps = [r for r in records if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in steps)
    assert any("eval_loss" in r for r in records) and any("final_eval_loss" in r for r in records)
    assert trainer.ckpt.steps() == [2]
    assert json.loads((out / "train_results.json").read_text())["final_step"] == 2
    assert (out / "model" / "model.safetensors").exists() and (out / "model" / "config.json").exists()

    trainer = main(common + ["training.max_steps=4"])  # resumes from step 2
    records = [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4]
    assert trainer.ckpt.steps() == [2, 4]
    state = torch.load(trainer.ckpt.path(4), weights_only=True)
    assert state["micro_step"] == 4 * 2  # smoke accumulates 2 micro-steps
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(value, state["model"][name]), name


def test_smoke_cli_output_loads_with_load_pretrained_and_embeds(tmp_path):
    out = tmp_path / "run"
    trainer = main(["--config-name", "smoke", "--device", "cpu", f"training.output_dir={out}",
                    "training.max_steps=1", "training.load_best_model_at_end=false"])
    processor, model = load_pretrained(out / "model", device="cpu", dtype=torch.float32)
    assert isinstance(model, CM3PModel)
    assert processor.beatmap_tokenizer.vocab_size == model.config.beatmap_config.vocab_size
    trained = trainer.model.state_dict()
    assert set(model.state_dict()) == set(trained)
    for name, value in model.state_dict().items():
        assert torch.equal(value, trained[name].float()), name
    emb = embed_beatmap(model, processor, BUNDLED_MAP, device="cpu")
    assert emb.shape == (model.config.projection_dim,)
    assert np.isfinite(emb).all() and abs(float(np.linalg.norm(emb)) - 1.0) < 1e-5
