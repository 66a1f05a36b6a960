"""The port's heads and single-tower models against the JAX package on the CPU.

A tiny fp32 config: the JAX modules (``attn_impl="xla"``) and the port's share
weights through ``state_dict_from_jax`` and see the same numpy inputs (seeded
ids with [AUDIO] placeholders, mel features, ragged attention masks, labels).
Tolerances: logits and losses within 1e-5 of the reference's largest entry
(``_close``); embeddings at cosine >= 0.99999; one train step with the
gradient and update limits of ``tests/test_torch_train.py`` (each gradient
within 2e-4 of its largest entry, parameters after one Muon step within 1e-3
of the largest update, NS5 in fp32 on both sides).

Covered: ``cross_entropy_ignore_index`` (and its gradient), ``PredictionHead``,
``MaskedLMModule`` tied and untied, dense and sparse (the rows that reach the
loss, and their order, at budgets above and below the masked count),
``ClassifierModule`` for the three problem types and the inferred one, both
``WithProjection`` modules, ``CM3PModule`` with the decoder head through
``__call__`` and ``forward_packed``, the HF key names against
``flax_to_hf_state_dict``, and the train step of ``MaskedLMModule`` and
``ClassifierModule`` against ``make_train_step``.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.data.packing_collator import packed_batches as jax_packed_batches
from cm3p_tpu.interop.hf_export import flax_to_hf_state_dict
from cm3p_tpu.models import (
    BeatmapModelWithProjection as JaxBeatmapWithProjection,
    ClassifierModule,
    CM3PModule,
    MaskedLMModule,
    MetadataModelWithProjection as JaxMetadataWithProjection,
)
from cm3p_tpu.models.cm3p import PredictionHead as JaxPredictionHead
from cm3p_tpu.models.cm3p import cross_entropy_ignore_index as jax_ce
from cm3p_tpu.train.muon import muon as jax_muon
from cm3p_tpu.train.train_state import TrainState, make_train_step
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.data import packed_batches
from cm3p_torch.interop import state_dict_from_jax
from cm3p_torch.interop.safetensors_io import load_file
from cm3p_torch.inference import save_pretrained
from cm3p_torch.models import (
    BeatmapModelWithProjection,
    ClassifierModel,
    CM3PModel,
    MaskedLMModel,
    MetadataModelWithProjection,
    PredictionHead,
    cross_entropy_ignore_index,
)
from cm3p_torch.train import MuonAdamW, TrainStep, flax_layouts, lr_schedule, to_device

from tests.test_torch_train_ops import _ns5_f32_jax, _ns5_f32_torch

AUDIO_ID = 500
N_TOK = 8
COS_MIN = 0.99999
LR, MAX_STEPS = 1e-3, 10
jax_muon_module = importlib.import_module("cm3p_tpu.train.muon")
muon_module = importlib.import_module("cm3p_torch.train.muon")


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-12), (what, err)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _configs(**beatmap):
    """(JAX, port) tiny configs with the same beatmap-config overrides."""
    out = []
    for make in (jax_tiny_config, tiny_cm3p_config):
        cfg = make()
        cfg.beatmap_config.audio_token_id = AUDIO_ID
        for k, v in beatmap.items():
            setattr(cfg.beatmap_config, k, v)
        out.append(cfg)
    return out


def _inputs(lengths=(64, 50), seed=0):
    """Ids with [AUDIO] placeholders, ragged masks and mel features for N_TOK audio tokens a window."""
    rng = np.random.default_rng(seed)
    length = max(lengths)
    ids = np.zeros((len(lengths), length), np.int32)
    mask = np.zeros((len(lengths), length), np.int32)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(5, 490, n)
        ids[i, 1 : 1 + N_TOK] = AUDIO_ID
        mask[i, :n] = 1
    feats = rng.standard_normal((len(lengths), 80, N_TOK * 8)).astype(np.float32)
    return ids, mask, feats


def _mlm_labels(ids, mask, prob, seed=1):
    rng = np.random.default_rng(seed)
    return np.where((rng.random(ids.shape) < prob) & (mask == 1), ids, -100).astype(np.int32)


def _jax_batch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _init(jmodel, batch: dict):
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), **_jax_batch(batch))
    return jax.tree.map(np.asarray, params)


def _port(cls, config, params):
    model = cls(config)
    model.load_state_dict(state_dict_from_jax(params))
    return model.eval()


def _torch_batch(batch: dict) -> dict:
    return to_device(batch, "cpu", packed=False)


# --------------------------------------------------------------------- the loss and the head


@pytest.mark.parametrize("case", ["some ignored", "all ignored", "other ignore index"])
def test_cross_entropy_ignore_index_and_its_gradient(case):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    ignore = -7 if case == "other ignore index" else -100
    drop = rng.random((3, 7)) < 0.4 if case != "all ignored" else np.ones((3, 7), bool)
    labels = np.where(drop, ignore, labels).astype(np.int32)
    want, want_grad = jax.value_and_grad(lambda x: jax_ce(x, jnp.asarray(labels), ignore))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    got = cross_entropy_ignore_index(x, torch.as_tensor(labels), ignore)
    got.backward()
    if case == "all ignored":
        assert float(got.detach()) == 0.0 == float(want) and not x.grad.any()
    _close(got.detach(), want, what="loss")
    _close(x.grad, want_grad, what="gradient")


@pytest.mark.parametrize("bias", [False, True])
def test_prediction_head(bias):
    jcfg, tcfg = _configs(classifier_bias=bias, norm_bias=bias)
    hidden = np.random.default_rng(4).standard_normal((2, 9, 64)).astype(np.float32)
    head = JaxPredictionHead(jcfg.beatmap_config)
    params = jax.tree.map(np.array, head.init(jax.random.PRNGKey(0), jnp.asarray(hidden)))
    if bias:  # nonzero biases, so that a dropped one shows
        params["params"]["dense"]["bias"] += 0.1
        params["params"]["norm"]["LayerNorm_0"]["bias"] += 0.2
    want = head.apply(params, jnp.asarray(hidden))
    state = state_dict_from_jax({"params": {"head": params["params"]}})
    port = PredictionHead(tcfg.beatmap_config)
    port.load_state_dict({k.removeprefix("head."): v for k, v in state.items()})
    _close(port(torch.as_tensor(hidden)).detach(), want)


# --------------------------------------------------------------------- masked LM


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("sparse", [None, 0.15, 0.6], ids=["dense", "sparse-below-budget", "sparse-above-budget"])
def test_masked_lm_matches_the_jax_module(tied, sparse):
    """Sparse: 128 positions give a budget of 38 rows; 15 % masked leaves unmasked rows inside the
    budget (the masked ones first, then the others in index order), 60 % leaves masked rows out."""
    jcfg, tcfg = _configs(tie_word_embeddings=tied, sparse_prediction=sparse is not None)
    ids, mask, feats = _inputs()
    labels = _mlm_labels(ids, mask, sparse or 0.15)
    batch = dict(input_ids=ids, input_features=feats, attention_mask=mask, labels=labels)
    jmodel = MaskedLMModule(jcfg.beatmap_config, dtype=jnp.float32, attn_impl="xla")
    params = _init(jmodel, batch)
    assert ("decoder_bias" in params["params"]) == tied and ("decoder" in params["params"]) != tied
    want = jmodel.apply(params, **_jax_batch(batch))
    model = _port(MaskedLMModel, tcfg.beatmap_config, params)
    with torch.no_grad():
        got = model(**_torch_batch(batch))
    if sparse is not None:
        flat = labels.reshape(-1)
        n_masked, budget = int((flat != -100).sum()), int(flat.size * 0.3)
        assert got.logits.shape[0] == budget and (n_masked < budget) == (sparse < 0.3)
        # the rows jax.lax.top_k picks: masked positions in index order, then unmasked ones
        _, idx = jax.lax.top_k(jnp.asarray(flat != -100).astype(jnp.int32), budget)
        dense = model.decode(model.head(model.beatmap_model(
            torch.as_tensor(ids, dtype=torch.int64), torch.as_tensor(feats), torch.as_tensor(mask))))
        rows = torch.as_tensor(np.array(idx), dtype=torch.int64)
        _close(got.logits, dense.reshape(-1, dense.shape[-1])[rows].detach(), what="rows and their order")
    _close(got.logits, want.logits, what="logits")
    _close(got.loss, want.loss, what="loss")


# --------------------------------------------------------------------- classifier


@pytest.mark.parametrize("problem_type,num_labels,label_kind", [
    ("regression", 1, "float"),
    ("single_label_classification", 3, "int"),
    ("multi_label_classification", 3, "multi"),
    (None, 3, "int"),
    (None, 3, "multi"),
    (None, 1, "float"),
])
def test_classifier_losses(problem_type, num_labels, label_kind):
    jcfg, tcfg = _configs(problem_type=problem_type, num_labels=num_labels, cls_embed=False)
    ids, mask, feats = _inputs()
    rng = np.random.default_rng(5)
    labels = {
        "float": rng.standard_normal((2, num_labels)).astype(np.float32),
        "int": rng.integers(0, num_labels, (2,)).astype(np.int32),
        "multi": (rng.random((2, num_labels)) < 0.5).astype(np.float32),
    }[label_kind]
    batch = dict(input_ids=ids, input_features=feats, attention_mask=mask, labels=labels)
    jmodel = ClassifierModule(jcfg.beatmap_config, dtype=jnp.float32, attn_impl="xla")
    params = _init(jmodel, batch)
    want = jmodel.apply(params, **_jax_batch(batch))
    model = _port(ClassifierModel, tcfg.beatmap_config, params)
    with torch.no_grad():
        got = model(**_torch_batch(batch))
    _close(got.logits, want.logits, what="logits")
    _close(got.loss, want.loss, what="loss")


# --------------------------------------------------------------------- single-tower projections


@pytest.mark.parametrize("normalize", [False, True])
def test_beatmap_model_with_projection(normalize):
    jcfg, tcfg = _configs()
    ids, mask, feats = _inputs()
    batch = dict(input_ids=ids, input_features=feats, attention_mask=mask)
    jmodel = JaxBeatmapWithProjection(jcfg.beatmap_config, dtype=jnp.float32, attn_impl="xla")
    params = _init(jmodel, batch)
    want = jmodel.apply(params, **_jax_batch(batch), normalize=normalize)
    model = _port(BeatmapModelWithProjection, tcfg.beatmap_config, params)
    with torch.no_grad():
        got = model(**_torch_batch(batch), normalize=normalize)
    assert got.shape == (2, tcfg.beatmap_config.projection_dim)
    assert (_cos(got, want) >= COS_MIN).all()


@pytest.mark.parametrize("normalize", [False, True])
def test_metadata_model_with_projection(normalize):
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(6)
    mask = (np.arange(12)[None, :] < np.array([[12], [7], [4]])).astype(np.int32)
    ids = (rng.integers(3, 250, (3, 12)) * mask).astype(np.int32)
    jmodel = JaxMetadataWithProjection(jcfg.metadata_config, dtype=jnp.float32, attn_impl="xla")
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask)))
    want = jmodel.apply(params, jnp.asarray(ids), jnp.asarray(mask), normalize=normalize)
    model = _port(MetadataModelWithProjection, tcfg.metadata_config, params)
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.int64), torch.as_tensor(mask), normalize=normalize)
    assert (_cos(got, want) >= COS_MIN).all()


# --------------------------------------------------------------------- CM3PModule's decoder head


def _head_configs():
    jcfg, tcfg = _configs(cls_embed=False)
    jcfg.has_decoder_head = tcfg.has_decoder_head = True
    return jcfg, tcfg


def test_cm3p_decoder_head_forward():
    jcfg, tcfg = _head_configs()
    ids, mask, feats = _inputs()
    rng = np.random.default_rng(7)
    batch = dict(
        input_ids=ids, input_features=feats, attention_mask=mask,
        metadata_ids=rng.integers(3, 250, (2, 3, 12)).astype(np.int32),
        metadata_variation_classes=np.tile(np.arange(3, dtype=np.int32), (2, 1)),
        labels=_mlm_labels(ids, mask, 0.15),
    )
    jmodel = CM3PModule(jcfg, dtype=jnp.float32, attn_impl="xla")
    params = _init(jmodel, batch)
    want = jmodel.apply(params, **_jax_batch(batch))
    model = CM3PModel(tcfg)
    model.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = model(**_torch_batch(batch))
        no_labels = model(**_torch_batch({k: v for k, v in batch.items() if k != "labels"}))
    _close(got.logits, want.logits, what="logits")
    _close(got.logits_per_beatmap, want.logits_per_beatmap, what="similarity")
    _close(got.loss, want.loss, what="loss")
    # contrastive + 0.5 x the decoder's cross entropy
    ce = cross_entropy_ignore_index(got.logits, torch.as_tensor(batch["labels"]))
    _close(got.loss, no_labels.loss + 0.5 * ce, rel=1e-6, what="loss composition")


def test_cm3p_decoder_head_forward_packed():
    jcfg, tcfg = _head_configs()
    rng = np.random.default_rng(8)
    samples = []
    for _ in range(5):
        n = int(rng.integers(24, 96))
        ids = np.zeros(96, np.int32)
        msk = np.zeros(96, np.int32)
        ids[:n], msk[:n] = rng.integers(5, 490, n), 1
        meta_mask = (np.arange(12)[None, :] < rng.integers(4, 13, (3, 1))).astype(np.int32)
        samples.append({
            "input_ids": ids, "attention_mask": msk, "metadata_attention_mask": meta_mask,
            "metadata_ids": (rng.integers(3, 250, (3, 12)) * meta_mask).astype(np.int32),
            "metadata_variation_classes": np.arange(3, dtype=np.int32),
        })
    (batch,) = packed_batches(iter(samples), rows=3, seq_len=128, pad_id=0, max_windows=7, drop_last=False)
    (jbatch,) = jax_packed_batches(iter(samples), rows=3, seq_len=128, pad_id=0, max_windows=7, drop_last=False)
    batch = dict(batch)
    batch["labels"] = np.where((rng.random(batch["input_ids"].shape) < 0.15) & (batch["segment_ids"] > 0),
                               batch["input_ids"], -100).astype(np.int32)
    jbatch = {**jbatch, "labels": batch["labels"]}
    jmodel = CM3PModule(jcfg, dtype=jnp.float32, attn_impl="xla", meta_pack=4)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(rng.integers(5, 490, (2, 64)).astype(np.int32)),
        input_features=jnp.asarray(rng.standard_normal((2, 80, 64)).astype(np.float32)),
        metadata_ids=jnp.asarray(batch["metadata_ids"][:2]),
    ))
    want = jmodel.apply(params, **_jax_batch(jbatch), method=CM3PModule.forward_packed)
    model = CM3PModel(tcfg, meta_pack=4)
    model.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = model.forward_packed(**to_device(batch, "cpu", packed=True))
    # at real positions only: the XLA reference spreads a padding query's attention uniformly, the port zeroes it
    real = batch["segment_ids"] > 0
    _close(got.logits[torch.as_tensor(real)], np.asarray(want.logits)[real], what="logits")
    _close(got.loss, want.loss, what="loss")


# --------------------------------------------------------------------- HF names


@pytest.mark.parametrize("kind", ["cm3p-decoder-head", "mlm", "mlm-tied", "classifier"])
def test_hf_key_names_match_flax_to_hf_state_dict(kind, tmp_path):
    ids, mask, feats = _inputs()
    if kind == "cm3p-decoder-head":
        jcfg, tcfg = _head_configs()
        batch = dict(input_ids=ids, input_features=feats, attention_mask=mask,
                     metadata_ids=np.random.default_rng(0).integers(3, 250, (2, 3, 12)).astype(np.int32))
        jmodel, cls, config, tied = CM3PModule(jcfg, attn_impl="xla"), CM3PModel, tcfg, False
    else:
        tied = kind == "mlm-tied"
        jcfg, tcfg = _configs(tie_word_embeddings=tied, problem_type="single_label_classification")
        batch = dict(input_ids=ids, input_features=feats, attention_mask=mask)
        jcls, cls = (ClassifierModule, ClassifierModel) if kind == "classifier" else (MaskedLMModule, MaskedLMModel)
        jmodel, config = jcls(jcfg.beatmap_config, attn_impl="xla"), tcfg.beatmap_config
    params = _init(jmodel, batch)
    want = flax_to_hf_state_dict(params, tie_word_embeddings=tied)
    save_pretrained(_port(cls, config, params), tmp_path)
    got = load_file(tmp_path / "model.safetensors")
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], np.asarray(value, np.float32), err_msg=name)


# --------------------------------------------------------------------- one train step


@pytest.mark.parametrize("kind", ["MaskedLMModule", "ClassifierModule"])
def test_train_step_matches_make_train_step(kind, monkeypatch):
    monkeypatch.setattr(jax_muon_module, "zeropower_via_newtonschulz5", _ns5_f32_jax)
    monkeypatch.setattr(muon_module, "zeropower_via_newtonschulz5", _ns5_f32_torch)
    ids, mask, feats = _inputs()
    if kind == "MaskedLMModule":
        jcfg, tcfg = _configs()
        labels = _mlm_labels(ids, mask, 0.15)
        jmodel, cls = MaskedLMModule(jcfg.beatmap_config, attn_impl="xla"), MaskedLMModel
    else:
        jcfg, tcfg = _configs(problem_type="single_label_classification", cls_embed=False)
        labels = np.array([1, 0], np.int32)
        jmodel, cls = ClassifierModule(jcfg.beatmap_config, attn_impl="xla"), ClassifierModel
    batch = dict(input_ids=ids, input_features=feats, attention_mask=mask, labels=labels)
    params = _init(jmodel, batch)
    jb = _jax_batch(batch)
    jgrads = jax.jit(jax.grad(lambda p: jmodel.apply({"params": p}, **jb).loss))(
        jax.tree.map(jnp.asarray, params["params"]))
    tx = jax_muon(optax.linear_schedule(LR, 0.0, MAX_STEPS), adamw_lr_ratio=0.25, adamw_betas=(0.9, 0.999))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
                       opt_state=tx.init(jax.tree.map(jnp.asarray, params["params"])))
    new_state, metrics = jax.jit(make_train_step(jmodel, tx))(state, jb, jax.random.PRNGKey(1))
    want_grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    want_params = state_dict_from_jax(jax.tree.map(np.asarray, new_state.params))

    start = state_dict_from_jax(params)
    model = cls(tcfg.beatmap_config)
    model.load_state_dict(start)
    opt = MuonAdamW(model.named_parameters(), flax_layouts(model), lr_schedule(LR, MAX_STEPS),
                    adamw_lr_ratio=0.25, adamw_betas=(0.9, 0.999))
    step = TrainStep(model, opt, packed=False)
    dev = _torch_batch(batch)
    assert dev["labels"].dtype == torch.int64
    loss, grads, norm = step.grads(dev)
    assert abs(float(loss) - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
    assert abs(float(norm) - float(metrics["grad_norm"])) <= 1e-4 * float(metrics["grad_norm"])
    for (name, _), g in zip(model.named_parameters(), grads):
        want = want_grads[name].numpy()
        assert g is not None and np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), want, atol=2e-4 * max(np.abs(want).max(), 1e-12), err_msg=name)
    assert step(dev)["applied"]
    for name, p in model.named_parameters():
        got = (p.detach() - start[name]).numpy()
        ref = (want_params[name] - start[name]).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-3 * max(np.abs(ref).max(), 1e-12), err_msg=name)


def test_configs_agree():
    """The two tiny configs are the same numbers, so the comparisons above compare like with like."""
    jcfg, tcfg = _configs()
    assert dataclasses.asdict(jcfg.beatmap_config) == dataclasses.asdict(tcfg.beatmap_config)
