"""Data-parallel training steps of the port on two gloo ranks against the JAX package on a ``data=2`` mesh.

Each case gives every rank its own batch; the global batch is their
rank-ordered concatenation (the JAX ``put_global_batch``; a packed batch's
window table indexes its own rank's rows, so rank 1's ``window_rows`` are
offset by rank 0's rows in the global batch the JAX step sees). The JAX side
is ``make_train_step`` + ``shard_train_step`` on ``make_mesh(data=2,
model=1)`` over two CPU devices, the port's is ``TrainStep`` with
``MuonAdamW`` on each rank with the model's ``dp_group`` set, from the same
weights (``state_dict_from_jax``), NS5 in fp32 on both sides. Tolerances
are those of ``tests/test_torch_train.py``: the loss within 1e-5 relative,
the gradient norm within 1e-4 relative, the parameters after the step within
1e-3 of the largest update; and the two ranks' parameters bit-equal, their
losses and gradient norms equal.

Cases: ``forward_packed`` with 2-D metadata, with 3-D metadata variations
and the decoder head's labels masked far more on one rank than on the other
(the cross entropy's count is global), and the sparse masked-LM head
(``MaskedLMModule``, unpacked) with masked shares that make the global
budget differ from a per-rank budget: rank 0 spilling into rank 1's share,
and rank 0 taking the whole budget (rank 1 decodes no row). Then two
micro-steps of accumulation (SGD) against the one-process port on the two
global batches, and the classifier's loss against the one-process port on the
global batch (1e-6 relative).

The ranks import torch and the port only (JAX is imported inside the test
functions).
"""
import importlib

import numpy as np
import pytest
import torch

from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.data import packed_batches
from cm3p_torch.models import ClassifierModel, CM3PModel, MaskedLMModel
from cm3p_torch.train import MuonAdamW, TrainStep, flax_layouts, lr_schedule, to_device
from cm3p_torch.train.muon import NS_COEFFS

from tests.test_torch_distributed import run_ranks

WORLD = 2
LR, MAX_STEPS = 1e-3, 10
ROWS, SEQ, MAX_WINDOWS = 2, 128, 5
AUDIO_ID, N_TOK = 500, 8
PACKED_CASES = ("packed-2d-metadata", "packed-3d-variations-decoder-labels")
SPARSE_CASES = {"sparse-mlm-budget-spills-over-ranks": (0.5, 0.02), "sparse-mlm-one-rank-takes-the-budget": (0.9, 0.3)}
muon_module = importlib.import_module("cm3p_torch.train.muon")


def _ns5_f32(g, steps=6, eps=1e-7):
    """NS5 in fp32 (the bf16 iteration amplifies summation-order differences past a tight comparison)."""
    a, b, c = NS_COEFFS
    x = g.float()
    x = x / (torch.linalg.vector_norm(x) + eps)
    transpose = g.shape[0] > g.shape[1]
    x = x.t() if transpose else x
    for _ in range(steps):
        xxt = x @ x.t()
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return x.t() if transpose else x


# ---------------------------------------------------------------- batches


def _samples(n, variations, seed, label_prob=None):
    """Packed-path samples: ragged beatmap windows, ragged metadata masks (2-D metadata with ``variations``
    None), labels masked with ``label_prob`` at real positions."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(24, 60))  # two windows a row of 128: every window in the first batch
        ids = np.zeros(96, np.int32)
        mask = np.zeros(96, np.int32)
        ids[:length], mask[:length] = rng.integers(5, 490, length), 1
        v = variations or 1
        meta_mask = (np.arange(12)[None, :] < rng.integers(4, 13, (v, 1))).astype(np.int32)
        meta_ids = (rng.integers(3, 250, (v, 12)) * meta_mask).astype(np.int32)
        sample = {"input_ids": ids, "attention_mask": mask}
        if variations:
            sample.update(metadata_ids=meta_ids, metadata_attention_mask=meta_mask,
                          metadata_variation_classes=np.arange(v, dtype=np.int32))
        else:
            sample.update(metadata_ids=meta_ids[0], metadata_attention_mask=meta_mask[0])
        if label_prob is not None:
            sample["labels"] = np.where((rng.random(96) < label_prob) & (mask == 1), ids, -100).astype(np.int32)
        out.append(sample)
    return out


def _packed(samples):
    return next(iter(packed_batches(iter(samples), rows=ROWS, seq_len=SEQ, pad_id=0, max_windows=MAX_WINDOWS,
                                    drop_last=False)))


def _rank_batches(case, seed=0):
    """Each rank's packed batch: 4 windows on rank 0, 3 on rank 1 (their dummy slots differ)."""
    variations = 3 if "3d" in case else None
    probs = (0.5, 0.02) if "labels" in case else (None, None)
    return [_packed(_samples(4 - r, variations, seed + 10 * r, probs[r])) for r in range(WORLD)]


def _unpacked_rank_batches(probs):
    """Each rank's two windows with [AUDIO] placeholders, mel features and masked-LM labels."""
    out = []
    for r, prob in enumerate(probs):
        rng = np.random.default_rng(20 + r)
        ids = np.zeros((2, 64), np.int32)
        mask = np.zeros((2, 64), np.int32)
        for i, n in enumerate((64, 50)):
            ids[i, :n] = rng.integers(5, 490, n)
            ids[i, 1: 1 + N_TOK] = AUDIO_ID
            mask[i, :n] = 1
        labels = np.where((rng.random(ids.shape) < prob) & (mask == 1), ids, -100).astype(np.int32)
        feats = rng.standard_normal((2, 80, N_TOK * 8)).astype(np.float32)
        out.append(dict(input_ids=ids, input_features=feats, attention_mask=mask, labels=labels))
    return out


def global_batch(batches, packed):
    """The rank-ordered concatenation; a packed window table's rows offset to the global rows."""
    out = {}
    for key in batches[0]:
        parts = [np.asarray(b[key]) for b in batches]
        if packed and key == "window_rows":
            parts = [p + r * ROWS for r, p in enumerate(parts)]
        out[key] = np.concatenate(parts)
    return out


# ---------------------------------------------------------------- the ranks


def _port_model(spec):
    if spec["packed"]:
        return CM3PModel(spec["tcfg"], meta_pack=4)
    return MaskedLMModel(spec["tcfg"].beatmap_config)


def _rank_steps(rank, world, specs, accum, classifier):
    muon_module.zeropower_via_newtonschulz5 = _ns5_f32
    group = torch.distributed.group.WORLD
    out = {}
    for spec in specs:
        model = _port_model(spec)
        model.load_state_dict(spec["start"])
        model.set_data_group(group)
        opt = MuonAdamW(model.named_parameters(), flax_layouts(model), lr_schedule(LR, MAX_STEPS),
                        adamw_lr_ratio=0.25, adamw_betas=(0.9, 0.999))
        metrics = TrainStep(model, opt, packed=spec["packed"])(to_device(spec["batches"][rank], "cpu", spec["packed"]))
        out[spec["name"]] = {
            "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "applied": metrics["applied"],
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
        }
    model = CM3PModel(accum["tcfg"], meta_pack=4)
    model.load_state_dict(accum["start"])
    model.set_data_group(group)
    step = TrainStep(model, torch.optim.SGD(model.parameters(), lr=1.0), packed=True, accumulation_steps=2)
    applied = [step(to_device(b[rank], "cpu", True))["applied"] for b in accum["micro_batches"]]
    out["accumulation"] = {"applied": applied, "params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    model = ClassifierModel(classifier["tcfg"].beatmap_config)
    model.load_state_dict(classifier["start"])
    model.set_data_group(group)
    with torch.no_grad():
        out["classifier"] = float(model(**to_device(classifier["batches"][rank], "cpu", packed=False)).loss)
    return out


# ---------------------------------------------------------------- the JAX side and the fixture


def _jax_step(jmodel, method, params, batch):
    import jax
    import jax.numpy as jnp
    import optax

    from cm3p_tpu.parallel.mesh import make_mesh
    from cm3p_tpu.train.muon import muon as jax_muon
    from cm3p_tpu.train.train_state import TrainState, make_train_step, shard_train_step
    from cm3p_torch.interop import state_dict_from_jax

    tx = jax_muon(optax.linear_schedule(LR, 0.0, MAX_STEPS), adamw_lr_ratio=0.25, adamw_betas=(0.9, 0.999))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
                       opt_state=tx.init(jax.tree.map(jnp.asarray, params["params"])))
    mesh = make_mesh(data=WORLD, model=1, devices=jax.devices()[:WORLD])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fn, _, _ = shard_train_step(make_train_step(jmodel, tx, method=method), mesh, state, jb)
    with mesh:
        new_state, metrics = fn(state, jb, jax.random.PRNGKey(1))
    return (float(metrics["loss"]), float(metrics["grad_norm"]),
            state_dict_from_jax(jax.tree.map(np.asarray, new_state.params)))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import pytest as _pytest

    from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
    from cm3p_tpu.models import CM3PModule, MaskedLMModule
    from cm3p_torch.interop import state_dict_from_jax

    from tests.test_torch_train_ops import _ns5_f32_jax

    jax_muon_module = importlib.import_module("cm3p_tpu.train.muon")
    specs, want = [], {}
    with _pytest.MonkeyPatch.context() as mp_:
        mp_.setattr(jax_muon_module, "zeropower_via_newtonschulz5", _ns5_f32_jax)
        for case in PACKED_CASES:
            jcfg, tcfg = jax_tiny_config(), tiny_cm3p_config()
            for cfg in (jcfg, tcfg):
                cfg.beatmap_config.cls_embed = False  # mean pooling: dummy windows pool to 0
                cfg.has_decoder_head = "labels" in case
            batches = _rank_batches(case)
            jmodel = CM3PModule(jcfg, dtype=jnp.float32, attn_impl="xla", meta_pack=4)
            rng = np.random.default_rng(1)
            params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
                jax.random.PRNGKey(0), jnp.asarray(rng.integers(5, 490, (2, 64)).astype(np.int32)),
                input_features=jnp.asarray(rng.standard_normal((2, 80, 64)).astype(np.float32)),
                metadata_ids=jnp.asarray(batches[0]["metadata_ids"][:2]),
            ))
            want[case] = _jax_step(jmodel, CM3PModule.forward_packed, params, global_batch(batches, True))
            specs.append({"name": case, "packed": True, "tcfg": tcfg, "batches": batches,
                          "start": state_dict_from_jax(params)})
        for case, probs in SPARSE_CASES.items():
            jcfg, tcfg = jax_tiny_config(), tiny_cm3p_config()
            for cfg in (jcfg, tcfg):
                cfg.beatmap_config.audio_token_id = AUDIO_ID
                cfg.beatmap_config.sparse_prediction = True
            batches = _unpacked_rank_batches(probs)
            jmodel = MaskedLMModule(jcfg.beatmap_config, attn_impl="xla")
            glob = global_batch(batches, False)
            params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
                jax.random.PRNGKey(0), **{k: jnp.asarray(v) for k, v in glob.items()}))
            want[case] = _jax_step(jmodel, None, params, glob)
            specs.append({"name": case, "packed": False, "tcfg": tcfg, "batches": batches,
                          "start": state_dict_from_jax(params), "probs": probs})
    accum = {"tcfg": specs[1]["tcfg"], "start": specs[1]["start"],
             "micro_batches": [_rank_batches(PACKED_CASES[1], seed) for seed in (0, 100)]}
    tcfg = tiny_cm3p_config()
    tcfg.beatmap_config.audio_token_id = AUDIO_ID
    tcfg.beatmap_config.problem_type = "single_label_classification"
    batches = _unpacked_rank_batches((0.1, 0.1))
    for r, batch in enumerate(batches):
        batch["labels"] = np.array([r, 1], np.int32)
    classifier = {"tcfg": tcfg, "batches": batches,
                  "start": ClassifierModel(tcfg.beatmap_config).state_dict()}
    results = run_ranks(_rank_steps, WORLD, tmp_path_factory.mktemp("ranks"), specs, accum, classifier)
    return specs, want, accum, classifier, results


@pytest.mark.parametrize("case", list(PACKED_CASES) + list(SPARSE_CASES))
def test_a_two_rank_step_equals_the_jax_step_on_a_data_mesh(steps, case):
    specs, want, _, _, results = steps
    spec = next(s for s in specs if s["name"] == case)
    want_loss, want_norm, want_params = want[case]
    got = [r[case] for r in results]
    assert all(g["applied"] for g in got)
    assert got[0]["loss"] == got[1]["loss"] and got[0]["grad_norm"] == got[1]["grad_norm"]
    assert abs(got[0]["loss"] - want_loss) <= 1e-5 * abs(want_loss), (got[0]["loss"], want_loss)
    assert abs(got[0]["grad_norm"] - want_norm) <= 1e-4 * want_norm, (got[0]["grad_norm"], want_norm)
    for name, p in got[0]["params"].items():
        assert torch.equal(p, got[1]["params"][name]), f"replicas differ at {name}"
        update, ref = (p - spec["start"][name]).numpy(), (want_params[name] - spec["start"][name]).numpy()
        np.testing.assert_allclose(update, ref, atol=1e-3 * max(np.abs(ref).max(), 1e-12), err_msg=name)


def test_the_cases_exercise_what_they_name(steps):
    specs, _, _, _, _ = steps
    by_name = {s["name"]: s for s in specs}
    dummies = [int((b["window_valid"] == 0).sum()) for b in by_name[PACKED_CASES[0]]["batches"]]
    assert dummies[0] != dummies[1]  # the ranks pad their window tables differently
    assert by_name[PACKED_CASES[0]]["batches"][0]["metadata_ids"].ndim == 2
    assert by_name[PACKED_CASES[1]]["batches"][0]["metadata_ids"].ndim == 3
    masked = [float((b["labels"] != -100).mean()) for b in by_name[PACKED_CASES[1]]["batches"]]
    assert masked[0] > 10 * masked[1]
    for case in SPARSE_CASES:
        per_rank = [int((b["labels"] != -100).sum()) for b in by_name[case]["batches"]]
        n = by_name[case]["batches"][0]["labels"].size
        budget, own = int(WORLD * n * 0.3), max(1, int(n * 0.3))
        assert per_rank[0] > own  # rank 0's masked share exceeds a per-rank budget
        if case.endswith("spills-over-ranks"):
            assert sum(per_rank) < budget  # every masked position and some of rank 0's unmasked ones
        else:
            assert per_rank[0] >= budget  # the global budget takes none of rank 1's positions


def test_two_micro_steps_of_accumulation_apply_the_global_mean_gradient(steps):
    _, _, accum, _, results = steps
    model = CM3PModel(accum["tcfg"], meta_pack=4)
    model.load_state_dict(accum["start"])
    step = TrainStep(model, torch.optim.SGD(model.parameters(), lr=1.0), packed=True)
    grads = [step.grads(to_device(global_batch(b, True), "cpu", True))[1] for b in accum["micro_batches"]]
    assert [r["accumulation"]["applied"] for r in results] == [[False, True]] * WORLD
    for (name, _), g1, g2 in zip(model.named_parameters(), *grads):
        got = results[0]["accumulation"]["params"][name]
        assert torch.equal(got, results[1]["accumulation"]["params"][name]), name
        update = torch.zeros_like(got) if g1 is None else -(g1 + g2) / 2
        # parameters of magnitude 1 hold an update of 1e-3 to their fp32 rounding: rtol 1e-6
        torch.testing.assert_close(got, accum["start"][name] + update, rtol=1e-6,
                                   atol=1e-4 * max(float(update.abs().max()), 1e-12))


def test_the_classifier_loss_is_the_global_batch_mean(steps):
    _, _, _, classifier, results = steps
    model = ClassifierModel(classifier["tcfg"].beatmap_config)
    model.load_state_dict(classifier["start"])
    with torch.no_grad():
        want = float(model(**to_device(global_batch(classifier["batches"], False), "cpu", packed=False)).loss)
    assert results[0]["classifier"] == results[1]["classifier"]
    assert abs(results[0]["classifier"] - want) <= 1e-6 * abs(want)
