"""Training from an MMRS root: the port against the JAX package, on the CPU at a tiny size.

The root is ``tests/test_torch_mmrs.py``'s (four beatmapsets with audio, one
of them 44.1 kHz stereo). Cases:

* batch streams: the port's ``mmrs_batches`` yields JAX ``train.mmrs_batches``'
  batches, packed and unpacked, over two epochs (ids, masks, labels and window
  tables exactly, mel features within 1e-5); a ``start_step`` seek, with and
  without ``training.batches_per_epoch``, starts at the batch an uninterrupted
  stream is at;
* one training step on an MMRS batch with audio against ``make_train_step``
  (``CM3PModel`` packed and unpacked, ``MaskedLMModel`` with ``masked_lm``
  labels, ``ClassifierModel`` with ``ranked_classification``), the tolerances
  of ``tests/test_torch_train.py``: loss 1e-5 relative, gradients 2e-4 of each
  tensor's largest entry; the port's optimizer on the JAX gradients (Muon's
  NS5 amplifies their summation-order differences) gives the parameters of
  the JAX step within 1e-3 of the largest update plus the parameter's own
  fp32 rounding (``update_tol``), with NS5 in fp32 on both sides;
* remat: ``True`` and ``"dots"`` give the loss and gradients of ``False``
  within 1e-6 (relative, of each tensor's largest entry), with audio and
  ``meta_pack``, and run each checkpointed layer's forward twice.

Freezing and the command-line tools are in ``tests/test_torch_mmrs_tools.py``.
"""
import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jax_train
from cm3p_tpu.models import CM3PModule
from cm3p_tpu.train.train_state import TrainState, make_train_step
from cm3p_torch.interop import state_dict_from_jax
from cm3p_torch.models import EncoderLayer
from cm3p_torch.train import TrainStep, to_device
from cm3p_torch.train.__main__ import (
    CONFIG_DIR,
    build_model,
    build_optimizer,
    build_processor,
    mmrs_batches,
    model_config,
)
from cm3p_torch.utils.config import load_config

from tests.test_torch_mmrs import build_mmrs_root
from tests.test_torch_train_ops import _ns5_f32_jax, _ns5_f32_torch

FEATURE_TOL = 1e-5
REMAT_TOL = 1e-6
jax_muon_module = importlib.import_module("cm3p_tpu.train.muon")
muon_module = importlib.import_module("cm3p_torch.train.muon")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_mmrs_root(tmp_path_factory.mktemp("mmrs_train"))


def _args(root, *extra, name="smoke_mmrs"):
    overrides = [f"dataset.train_dataset_paths=[{root}]", f"dataset.test_dataset_paths=[{root}]",
                 "training.num_workers=0", *extra]
    return load_config(CONFIG_DIR, name, overrides)


def _pair(root, *extra, name="smoke_mmrs"):
    """(port args, port processor, JAX args, JAX processor) of one configuration."""
    args, jargs = _args(root, *extra, name=name), _args(root, *extra, name=name)
    jproc = jax_train.build_processor(jargs, jax_train_dataset_config(jargs))
    return args, build_processor(args), jargs, jproc


def jax_train_dataset_config(args):
    from cm3p_tpu.data import DatasetConfig

    return DatasetConfig(**{k: v for k, v in args["dataset"].items() if k != "synthetic"})


def assert_same_batches(ours, ref):
    assert len(ours) == len(ref) and ours, (len(ours), len(ref))
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.keys() == b.keys(), (i, sorted(a), sorted(b))
        for key in a:
            if key == "input_features":
                np.testing.assert_allclose(a[key], b[key], atol=FEATURE_TOL, err_msg=f"batch {i}")
            else:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"batch {i} {key}")


STREAMS = {
    "packed": (),
    "unpacked": ("training.packed=false",),
    "packed-masked-lm": ("dataset.labels=masked_lm", "dataset.dt_augment_prob=0.5"),
    "unpacked-ranked": ("training.packed=false", "dataset.labels=ranked_classification",
                        "dataset.include_metadata=false", "dataset.beatmap_mismatch_prob=0.5"),
}


@pytest.mark.parametrize("stream", list(STREAMS))
def test_batches_equal_the_jax_batches(root, stream):
    args, proc, jargs, jproc = _pair(root, *STREAMS[stream])
    ours, ref = mmrs_batches(args, proc, test=False), jax_train.mmrs_batches(jargs, jproc, test=False)
    for _ in range(2):  # two epochs: the counter advances the seeded shuffle alike
        assert_same_batches(list(ours()), list(ref()))
    assert_same_batches(list(mmrs_batches(args, proc, test=True)()),
                        list(jax_train.mmrs_batches(jargs, jproc, test=True)()))


def update_tol(update, start) -> float:
    """1e-3 of the largest entry of a parameter's update, plus the fp32 rounding of the updated
    parameter itself (an update is read as the difference of two rounded parameters)."""
    return 1e-3 * max(float(np.abs(update).max()), 1e-12) + float(np.spacing(np.float32(np.abs(start.numpy()).max())))


def _ids(batches):
    return [b["input_ids"].tobytes() for b in batches]


@pytest.mark.parametrize("packed", [True, False])
def test_the_resume_seek_starts_where_an_uninterrupted_stream_is(root, packed, caplog):
    # unpacked, one track at a time and no DT: every epoch has the same batch count, the case
    # training.batches_per_epoch describes; packed with DT the count varies and the seek trusts the setting
    extra = ["dataset.dt_augment_prob=0.5"] if packed else ["training.packed=false", "dataset.cycle_length=1"]
    args = _args(root, *extra)
    proc = build_processor(args)
    stream = mmrs_batches(args, proc, test=False)
    epochs = [list(stream()) for _ in range(3)]  # what the trainer draws, epoch after epoch
    flat = [b for e in epochs for b in e]
    bpe = len(epochs[0])
    assert bpe >= 2
    if not packed:
        assert all(len(e) == bpe for e in epochs)
    caplog.set_level(logging.INFO)
    for start in (1, bpe - 1):  # a replay within epoch 0
        assert _ids([next(mmrs_batches(args, proc, test=False)(start_step=start))]) == _ids([flat[start]])
    assert "replaying" in caplog.text
    # a replay past the end of epoch 0 continues at the start of epoch 1
    assert _ids([next(mmrs_batches(args, proc, test=False)(start_step=bpe + 1))]) == _ids([epochs[1][0]])
    assert "continuing at epoch 1" in caplog.text
    seek_args = _args(root, *extra, f"training.batches_per_epoch={bpe}")
    for start in (bpe, bpe + 1, 2 * bpe + 1):  # whole epochs skipped, the rest replayed
        epoch, rest = divmod(start, bpe)
        seek = mmrs_batches(seek_args, proc, test=False)
        assert _ids(list(seek(start_step=start))) == _ids(epochs[epoch][rest:])
        if not packed:
            assert _ids(epochs[epoch][rest:]) == _ids(flat[start:(epoch + 1) * bpe])
        if epoch + 1 < len(epochs):
            assert _ids(list(seek())) == _ids(epochs[epoch + 1])
    assert "epoch 2 + 1-batch replay" in caplog.text
    unseeded = _args(root, *extra, "training.seed=null")
    fresh = mmrs_batches(unseeded, proc, test=False)(start_step=5)
    assert next(fresh)["input_ids"].shape == flat[0]["input_ids"].shape
    assert "unseeded data stream" in caplog.text


# --------------------------------------------------------------------- one training step


STEPS = {
    "cm3p-packed": (),
    "cm3p-unpacked": ("training.packed=false",),
    "masked-lm": ("training.packed=false", "model_cls=MaskedLMModule", "dataset.labels=masked_lm",
                  "dataset.include_metadata=false", "dataset.dt_augment_prob=0.5"),
    "classifier": ("training.packed=false", "model_cls=ClassifierModule", "dataset.labels=ranked_classification",
                   "dataset.include_metadata=false", "model.beatmap_config.problem_type=single_label_classification",
                   "model.beatmap_config.num_labels=2", "model.beatmap_config.cls_embed=false"),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_a_training_step_on_an_mmrs_batch_matches_make_train_step(root, case, monkeypatch):
    monkeypatch.setattr(jax_muon_module, "zeropower_via_newtonschulz5", _ns5_f32_jax)
    monkeypatch.setattr(muon_module, "zeropower_via_newtonschulz5", _ns5_f32_torch)
    args, proc, jargs, jproc = _pair(root, "training.learning_rate=1e-3", *STEPS[case])
    packed = bool(args["training"]["packed"])
    batch = next(iter(mmrs_batches(args, proc, test=False)()))
    assert "input_features" in batch
    if case == "masked-lm":
        assert (batch["labels"] != -100).any() and (batch["labels"] == -100).any()
    if case == "classifier":
        assert batch["labels"].shape == (batch["input_ids"].shape[0],)
    dev = to_device(batch, "cpu", packed)
    jb = {k: jnp.asarray(v.numpy()) for k, v in dev.items()}
    jcfg, jmodel = jax_train.build_model(jargs, jproc)
    method = CM3PModule.forward_packed if packed else None
    init = jmodel.init if method is None else (lambda *a, **k: jmodel.init(*a, method=method, **k))
    params = jax.tree.map(np.asarray, jax.jit(init)(jax.random.PRNGKey(0), **jb))
    tx = jax_train.build_optimizer(jargs)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
                       opt_state=tx.init(jax.tree.map(jnp.asarray, params["params"])))
    train_step = jax.jit(make_train_step(jmodel, tx, method=method))
    new_state, metrics = train_step(state, jb, jax.random.PRNGKey(1))
    want_params = state_dict_from_jax(jax.tree.map(np.asarray, new_state.params))
    jgrads = jax.jit(jax.grad(lambda p: jmodel.apply({"params": p}, **jb, **({"method": method} if method else {})).loss))(
        jax.tree.map(jnp.asarray, params["params"]))
    want_grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})

    start = state_dict_from_jax(params)
    model = build_model(args, model_config(args, proc), torch.device("cpu"), seed=0)
    model.load_state_dict(start)
    step = TrainStep(model, build_optimizer(args, model), packed)
    loss, grads, norm = step.grads(dev)
    assert abs(float(loss) - float(metrics["loss"])) <= 1e-5 * abs(float(metrics["loss"]))
    assert abs(float(norm) - float(metrics["grad_norm"])) <= 1e-4 * float(metrics["grad_norm"])
    audio = [g for (n, _), g in zip(model.named_parameters(), grads) if n.startswith("beatmap_model.audio_encoder.")]
    assert audio and all(g is not None for g in audio) and any(g.abs().max() > 0 for g in audio)  # it trains
    for (name, _), g in zip(model.named_parameters(), grads):
        want = want_grads[name].numpy()
        assert g is not None and np.isfinite(g.numpy()).all(), name
        np.testing.assert_allclose(g.numpy(), want, atol=2e-4 * max(np.abs(want).max(), 1e-12), err_msg=name)
    # the optimizer on the JAX gradients: NS5 amplifies the fp32 summation-order differences above
    for name, p in model.named_parameters():
        p.grad = want_grads[name].clone()
    step.optimizer.step()
    for name, p in model.named_parameters():
        got = (p.detach() - start[name]).numpy()
        ref = (want_params[name] - start[name]).numpy()
        np.testing.assert_allclose(got, ref, atol=update_tol(ref, start[name]), err_msg=name)


# --------------------------------------------------------------------- remat


def test_remat_changes_no_number_and_recomputes_each_layer(root, monkeypatch):
    args = _args(root, "meta_pack=2", "dataset.train_metadata_variations=3")
    proc = build_processor(args)
    cfg = model_config(args, proc)
    dev = to_device(next(iter(mmrs_batches(args, proc, test=False)())), "cpu", True)
    assert "input_features" in dev and dev["metadata_ids"].shape[1] == 3
    model = build_model(args, cfg, torch.device("cpu"), seed=0)
    assert model.meta_pack == 2
    layers = [layer for enc in model.encoders() for layer in enc.layers]
    calls = {"n": 0}
    layer_forward = EncoderLayer.forward

    def counted(self, *args, **kwargs):  # module hooks do not run in a recompute: count the forward itself
        calls["n"] += 1
        return layer_forward(self, *args, **kwargs)

    monkeypatch.setattr(EncoderLayer, "forward", counted)
    results = {}
    for mode in (False, True, "dots"):
        model.set_remat(mode)
        calls["n"] = 0
        step = TrainStep(model, build_optimizer(args, model), packed=True)
        loss, grads, _ = step.grads(dev)
        results[mode] = (loss, grads, calls["n"])
    assert model.metadata_model.encoder.remat is True  # "dots" is the beatmap and audio towers' only
    loss, grads, n = results[False]
    assert n == len(layers)
    for mode in (True, "dots"):
        loss_r, grads_r, n_r = results[mode]
        assert n_r == 2 * len(layers), mode
        assert abs(float(loss_r) - float(loss)) <= REMAT_TOL * abs(float(loss)), mode
        for (name, _), g, gr in zip(model.named_parameters(), grads, grads_r):
            assert (g is None) == (gr is None), name
            if g is not None:
                np.testing.assert_allclose(gr.numpy(), g.numpy(), rtol=0,
                                           atol=REMAT_TOL * max(float(g.abs().max()), 1e-12), err_msg=f"{mode} {name}")
    with torch.no_grad():  # inference takes no checkpoint
        calls["n"] = 0
        model.forward_packed(**dev)
        assert calls["n"] == len(layers)
    with pytest.raises(ValueError):
        model.set_remat("all")
