"""The port's inference API and flat bundles against the JAX package on the CPU, and the trainer's heads.

On the bundled map under ``resources/`` with tiny fp32 models whose weights
cross over through ``state_dict_from_jax`` (or a bundle of the JAX package's
``export_hf_checkpoint``):

* ``masked_predict`` against the JAX function: masked positions and true ids
  equal, the logits at them within 1e-5 of the largest (``_close``), the top-k
  ids equal wherever the gaps between the sorted logits exceed that;
* ``zero_shot_classify`` against the JAX function: (windows, 4) logits within
  1e-5;
* ``save_pretrained`` / ``load_pretrained`` round trips of the flat MLM (tied
  and untied) and classifier bundles and of ``CM3PModel`` with the decoder
  head: the same class, parameters and logits bit for bit, ``architectures``
  from ``default_architecture``;
* bundles of ``export_hf_checkpoint`` (``CM3PForMaskedLM`` tied,
  ``CM3PForBeatmapClassification``, ``CM3PModel`` with ``has_decoder_head``)
  load and give the JAX logits;
* the trainer: ``-cn v6_mask``, ``-cn v7`` and ``-cn v7_classifier`` (with a
  ``from_pretrained`` the test writes) for two steps at a tiny width with
  ``attn_impl=xla``, ``from_pretrained``'s errors, and the ``NotImplementedError``
  of ``--beatmap-files`` with ``dataset.labels``.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3p_tpu import inference as jax_inference
from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.interop.hf_export import export_hf_checkpoint
from cm3p_tpu.models import ClassifierModule, CM3PModule, MaskedLMModule
from cm3p_tpu.processing import CM3PProcessor as JaxProcessor
from cm3p_tpu.tokenize import MetadataTokenizer as JaxMetadataTokenizer
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.inference import load_pretrained, masked_predict, save_pretrained, zero_shot_classify
from cm3p_torch.interop import init_weights, state_dict_from_jax
from cm3p_torch.models import ClassifierModel, CM3PBeatmapModel, CM3PModel, MaskedLMModel
from cm3p_torch.processing import CM3PProcessor
from cm3p_torch.tokenize import MetadataTokenizer
from cm3p_torch.train.__main__ import main
from cm3p_torch.train.trainer import from_pretrained

ROOT = Path(__file__).resolve().parent.parent
BUNDLED_MAP = str(ROOT / "resources" / "Denkishiki Karen Ongaku Shuudan - Aoki Kotou no Anguis (OliBomby) [Ardens Spes].osu")
MAX_LENGTH = 384
METADATA_VOCAB = dict(modes={0: "osu"}, mappers={0: "OliBomby", 1: "peppy"}, statuses={1: "ranked", -2: "graveyard"})
CANDIDATES = [
    {"mapper": "OliBomby", "mode": "osu"},
    {"mapper": "peppy", "mode": "osu"},
    {"mapper": "OliBomby", "mode": "osu", "status": "graveyard"},
    {"mapper": "peppy", "mode": "osu", "status": "ranked"},
]
# a tiny trainer run: synthetic batches, plain PyTorch ops, two optimizer steps
TINY_RUN = [
    "attn_impl=xla", "dataset.synthetic=true", "meta_pack=0",
    "training.per_device_train_batch_size=2", "training.per_device_eval_batch_size=2",
    "training.gradient_accumulation_steps=1", "training.max_steps=2", "training.eval_steps=2",
    "training.max_eval_batches=1", "training.logging_steps=1", "training.save_steps=2",
    "training.load_best_model_at_end=false",
    "dataset.train_metadata_variations=2", "dataset.test_metadata_variations=2",
    "model.projection_dim=32",
    "model.beatmap_config.hidden_size=64", "model.beatmap_config.intermediate_size=96",
    "model.beatmap_config.num_hidden_layers=2", "model.beatmap_config.num_attention_heads=4",
    "model.beatmap_config.audio_config.hidden_size=32", "model.beatmap_config.audio_config.intermediate_size=64",
    "model.beatmap_config.audio_config.num_hidden_layers=2", "model.beatmap_config.audio_config.num_attention_heads=4",
    "model.beatmap_config.audio_config.projector_intermediate_size=128",
    "model.beatmap_config.audio_config.projector_dim=64",
    "model.metadata_config.hidden_size=32", "model.metadata_config.intermediate_size=64",
    "model.metadata_config.num_hidden_layers=2",
    "processor.default_kwargs.beatmap_kwargs.max_length=256",
    "processor.default_kwargs.audio_kwargs.pad_to_multiple_of=12800",
    "processor.default_kwargs.audio_kwargs.max_source_positions=80",
]


def _close(got, want, rel=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * max(float(np.abs(want).max()), 1e-12), (what, err)


@pytest.fixture(scope="module")
def processors():
    jproc = JaxProcessor(metadata_tokenizer=JaxMetadataTokenizer(**METADATA_VOCAB))
    proc = CM3PProcessor(metadata_tokenizer=MetadataTokenizer(**METADATA_VOCAB))
    for p in (jproc, proc):
        p.default_kwargs["beatmap_kwargs"]["max_length"] = MAX_LENGTH
    assert proc.beatmap_tokenizer.vocab_size == jproc.beatmap_tokenizer.vocab_size
    return jproc, proc


def _configs(proc, **beatmap):
    """(JAX, port) tiny configs with the tokenizers' vocabularies."""
    out = []
    for make in (jax_tiny_config, tiny_cm3p_config):
        cfg = make()
        bc = cfg.beatmap_config
        bc.vocab_size = proc.beatmap_tokenizer.vocab_size
        bc.audio_token_id = proc.beatmap_tokenizer.audio_token_id
        cfg.metadata_config.vocab_size = proc.metadata_tokenizer.vocab_size
        for k, v in beatmap.items():
            setattr(bc, k, v)
        out.append(cfg)
    return out


def _jax_params(jmodel, audio_id, **extra):
    """Every parameter, the audio tower's included: init with audio placeholders and features."""
    ids = np.full((1, 24), 7, np.int32)
    ids[0, 1:3] = audio_id
    feats = np.random.default_rng(0).standard_normal((1, 80, 16)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids), input_features=jnp.asarray(feats),
                                  **extra)
    return jax.tree.map(np.asarray, params)


def _port(cls, config, params):
    model = cls(config)
    model.load_state_dict(state_dict_from_jax(params))
    return model.eval()


def _tied_topk_equal(got, want, logits, tol):
    """Top-k ids equal wherever the sorted logits' gaps exceed ``tol``: each prefix that ends at
    such a gap holds the same ids."""
    ordered = -np.sort(-logits, axis=-1)[:, : got.shape[1] + 1]
    for row in range(got.shape[0]):
        for j in range(1, got.shape[1] + 1):
            if ordered[row, j - 1] - ordered[row, j] > tol:
                assert set(got[row, :j]) == set(want[row, :j]), (row, j)


@pytest.mark.parametrize("kind", ["mlm", "cm3p-decoder-head"])
def test_masked_predict_matches_the_jax_function(processors, kind):
    jproc, proc = processors
    if kind == "mlm":
        jcfg, tcfg = _configs(proc)
        jmodel = MaskedLMModule(jcfg.beatmap_config, attn_impl="xla")
        params = _jax_params(jmodel, tcfg.beatmap_config.audio_token_id)
        model = _port(MaskedLMModel, tcfg.beatmap_config, params)
    else:
        jcfg, tcfg = _configs(proc)
        jcfg.has_decoder_head = tcfg.has_decoder_head = True
        jmodel = CM3PModule(jcfg, attn_impl="xla")
        params = _jax_params(jmodel, tcfg.beatmap_config.audio_token_id, metadata_ids=jnp.ones((1, 8), jnp.int32))
        model = _port(CM3PModel, tcfg, params)
    want = jax_inference.masked_predict(jmodel, params, jproc, BUNDLED_MAP, seed=3)
    got = masked_predict(model, proc, BUNDLED_MAP, seed=3, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert len(got[0]) > 10 and got[2].shape == want[2].shape == (len(got[0]), 5)
    # the logits at the masked positions, from the corrupted window masked_predict built
    ids = np.asarray(proc(beatmap=BUNDLED_MAP)["input_ids"])[:1].copy()
    mask = np.asarray(proc(beatmap=BUNDLED_MAP)["attention_mask"])[:1]
    assert (ids[0, got[0]] == got[1]).all()
    ids[0, got[0]] = proc.beatmap_tokenizer.mask_token_id
    jlogits = np.asarray(jmodel.apply(params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask)).logits)
    with torch.no_grad():
        tlogits = model(input_ids=torch.as_tensor(ids, dtype=torch.int64), attention_mask=torch.as_tensor(mask)).logits
    _close(tlogits.numpy()[0, got[0]], jlogits[0, got[0]], what="logits at the masked positions")
    _tied_topk_equal(got[2], want[2], jlogits[0, got[0]], 1e-5 * float(np.abs(jlogits).max()))


def test_zero_shot_classify_matches_the_jax_function(processors):
    jproc, proc = processors
    jcfg, tcfg = _configs(proc)
    jmodel = CM3PModule(jcfg, attn_impl="xla")
    params = _jax_params(jmodel, tcfg.beatmap_config.audio_token_id, metadata_ids=jnp.ones((1, 8), jnp.int32))
    want = jax_inference.zero_shot_classify(jmodel, params, jproc, BUNDLED_MAP, CANDIDATES)
    got = zero_shot_classify(_port(CM3PModel, tcfg, params), proc, BUNDLED_MAP, CANDIDATES, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 4 and got.shape[0] > 1
    _close(got, want, what="logits_per_beatmap")


def _flat_model(proc, kind, seed=0):
    _, tcfg = _configs(proc, tie_word_embeddings=kind == "mlm-tied", problem_type="single_label_classification")
    gen = torch.Generator().manual_seed(seed)
    if kind == "cm3p-decoder-head":
        tcfg.has_decoder_head = True
        model = CM3PModel(tcfg)
        model.load_state_dict(init_weights(tcfg, gen, with_metadata=True))
        return model
    bc = tcfg.beatmap_config
    if kind == "classifier":
        model = ClassifierModel(bc)
        model.load_state_dict(init_weights(bc, gen, head="classifier"))
    else:
        bc.problem_type = None
        model = MaskedLMModel(bc)
        model.load_state_dict(init_weights(bc, gen, head="mlm"))
    return model


ARCHITECTURES = {"mlm": "CM3PForMaskedLM", "mlm-tied": "CM3PForMaskedLM",
                 "classifier": "CM3PForBeatmapClassification", "cm3p-decoder-head": "CM3PModel"}


@pytest.mark.parametrize("kind", list(ARCHITECTURES))
def test_save_and_load_pretrained_round_trip(processors, kind, tmp_path):
    _, proc = processors
    model = _flat_model(proc, kind).eval()
    save_pretrained(model, tmp_path, processor=proc)
    assert json.loads((tmp_path / "config.json").read_text())["architectures"] == [ARCHITECTURES[kind]]
    proc2, loaded = load_pretrained(tmp_path, device="cpu", dtype=torch.float32)
    assert type(loaded) is type(model)
    a, b = model.state_dict(), loaded.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    inputs = proc2(beatmap=BUNDLED_MAP)
    ids = torch.as_tensor(np.asarray(inputs["input_ids"])[:2], dtype=torch.int64)
    mask = torch.as_tensor(np.asarray(inputs["attention_mask"])[:2])
    with torch.no_grad():
        assert torch.equal(model(ids, attention_mask=mask).logits, loaded(ids, attention_mask=mask).logits)


def test_decoder_head_bundle_without_metadata_tower_loads_as_beatmap_model(processors, tmp_path):
    _, proc = processors
    model = _flat_model(proc, "cm3p-decoder-head")
    save_pretrained(model, tmp_path)
    _, full = load_pretrained(tmp_path, device="cpu", dtype=torch.float32)
    assert isinstance(full, CM3PModel) and full.config.has_decoder_head
    state = {k: v for k, v in model.state_dict().items() if k.startswith(("beatmap_model.", "beatmap_projection."))}
    sub = CM3PBeatmapModel(model.config)
    sub.load_state_dict(state)
    save_pretrained(sub, tmp_path / "sub")
    _, loaded = load_pretrained(tmp_path / "sub", device="cpu", dtype=torch.float32)
    assert type(loaded) is CM3PBeatmapModel


@pytest.mark.parametrize("kind", ["mlm-tied", "classifier", "cm3p-decoder-head"])
def test_jax_export_loads_and_gives_the_jax_logits(processors, kind, tmp_path):
    jproc, proc = processors
    jcfg, tcfg = _configs(proc, tie_word_embeddings=kind == "mlm-tied", problem_type="single_label_classification")
    audio_id = tcfg.beatmap_config.audio_token_id
    if kind == "cm3p-decoder-head":
        jcfg.has_decoder_head = tcfg.has_decoder_head = True
        jmodel, cfg = CM3PModule(jcfg, attn_impl="xla"), jcfg
        params = _jax_params(jmodel, audio_id, metadata_ids=jnp.ones((1, 8), jnp.int32))
        cls = CM3PModel
    elif kind == "classifier":
        jmodel, cfg, cls = ClassifierModule(jcfg.beatmap_config, attn_impl="xla"), jcfg.beatmap_config, ClassifierModel
        params = _jax_params(jmodel, audio_id)
    else:
        jcfg.beatmap_config.problem_type = None
        jmodel, cfg, cls = MaskedLMModule(jcfg.beatmap_config, attn_impl="xla"), jcfg.beatmap_config, MaskedLMModel
        params = _jax_params(jmodel, audio_id)
    export_hf_checkpoint(params, cfg, tmp_path)
    _, model = load_pretrained(tmp_path, device="cpu", dtype=torch.float32)
    assert type(model) is cls
    inputs = proc(beatmap=BUNDLED_MAP)
    ids, mask = np.asarray(inputs["input_ids"])[:2], np.asarray(inputs["attention_mask"])[:2]
    want = jmodel.apply(params, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask)).logits
    with torch.no_grad():
        got = model(torch.as_tensor(ids, dtype=torch.int64), attention_mask=torch.as_tensor(mask)).logits
    _close(got, want, what="logits")


# --------------------------------------------------------------------- the trainer


def _records(out):
    return [json.loads(line) for line in (out / "train_log.jsonl").read_text().splitlines()]


def test_trainer_cli_v6_mask_v7_and_v7_classifier(tmp_path):
    v7 = tmp_path / "v7"
    trainer = main(["-cn", "v7", "--device", "cpu", f"training.output_dir={v7}"] + TINY_RUN)
    assert isinstance(trainer.model, CM3PModel) and trainer.model.config.has_decoder_head
    records = _records(v7)
    assert [r["step"] for r in records if "loss" in r] == [1, 2]
    assert any("final_eval_accuracy_masked_lm" in r for r in records)

    mlm = tmp_path / "v6_mask"
    trainer = main(["-cn", "v6_mask", "--device", "cpu", f"training.output_dir={mlm}"] + TINY_RUN)
    assert isinstance(trainer.model, MaskedLMModel)
    records = _records(mlm)
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    assert any("final_eval_top5_accuracy_masked_lm" in r for r in records)
    _, loaded = load_pretrained(mlm / "model", device="cpu", dtype=torch.float32)
    assert isinstance(loaded, MaskedLMModel)

    cls = tmp_path / "v7_classifier"
    trainer = main(["-cn", "v7_classifier", "--device", "cpu", f"training.output_dir={cls}",
                    f"from_pretrained={v7 / 'model'}"] + TINY_RUN)
    assert isinstance(trainer.model, ClassifierModel)
    records = _records(cls)
    assert [r["step"] for r in records if "loss" in r] == [1, 2]
    assert any("final_eval_accuracy_classification" in r for r in records)
    _, loaded = load_pretrained(cls / "model", device="cpu", dtype=torch.float32)
    assert isinstance(loaded, ClassifierModel)


def test_from_pretrained_rules(processors, tmp_path):
    _, proc = processors
    source = _flat_model(proc, "cm3p-decoder-head")
    save_pretrained(source, tmp_path)
    target = _flat_model(proc, "classifier", seed=1)
    seeded = {k: v.clone() for k, v in target.state_dict().items()}
    with pytest.raises(ValueError, match="missing params"):
        from_pretrained(target, tmp_path)
    info = from_pretrained(target, tmp_path, allow_missing=True)
    assert info["missing"] == ["classifier.bias", "classifier.weight"]
    assert "metadata_projection.weight" in info["ignored"] and "decoder.weight" in info["ignored"]
    state, src = target.state_dict(), source.state_dict()
    for name in state:
        want = seeded[name] if name.startswith("classifier.") else src[name]
        assert torch.equal(state[name], want), name
    other = _flat_model(proc, "mlm")
    other.beatmap_model.encoder.embeddings.tok_embeddings = torch.nn.Embedding(7, 64)
    with pytest.raises(ValueError, match="shape mismatch"):
        from_pretrained(other, tmp_path, allow_missing=True)
    stranger = torch.nn.Linear(3, 3)
    with pytest.raises(ValueError, match="no overlapping"):
        from_pretrained(stranger, tmp_path, allow_missing=True)


def test_beatmap_files_with_labels_raise(tmp_path):
    with pytest.raises(NotImplementedError, match=r"labels come from MMRS roots \(dataset.train_dataset_paths\)"):
        main(["-cn", "v6_mask", "--device", "cpu", "--beatmap-files", str(ROOT / "resources"),
              f"training.output_dir={tmp_path}", "dataset.include_audio=false"]
             + [o for o in TINY_RUN if o != "dataset.synthetic=true"])
