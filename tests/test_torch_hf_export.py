"""The port's reference-layout export against the JAX package's, on the CPU.

``cm3p_torch.interop.export_hf_processor`` against
``cm3p_tpu.interop.hf_export.export_hf_processor`` on processors built with
the same settings (the default one, and one with non-default
``default_kwargs`` and filled metadata vocabularies), with and without
``auto_map``: the same relative paths, every JSON file equal once parsed,
every ``vocab.json`` byte-equal. The port's ``CM3PProcessor.from_pretrained``
reads the export back as the JAX package's reader does, into a processor that
tokenizes the bundled map (and metadata) as the source processor does.

The weights' direction: the port's ``save_pretrained`` on weights carried
from JAX parameters (``state_dict_from_jax``) against ``export_hf_checkpoint``
on the same parameters, tensor for tensor and ``config.json`` key for key,
for the dual-tower model, a tied masked-LM model and a classifier.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.interop.hf_export import export_hf_checkpoint
from cm3p_tpu.interop.hf_export import export_hf_processor as jax_export_hf_processor
from cm3p_tpu.models import ClassifierModule, CM3PModule, MaskedLMModule
from cm3p_tpu.processing import CM3PProcessor as JaxProcessor
from cm3p_tpu.tokenize import MetadataTokenizer as JaxMetadataTokenizer
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.inference import save_pretrained
from cm3p_torch.interop import export_hf_processor, state_dict_from_jax
from cm3p_torch.interop.safetensors_io import load_file
from cm3p_torch.models import ClassifierModel, CM3PModel, MaskedLMModel
from cm3p_torch.processing import CM3PProcessor
from cm3p_torch.tokenize import MetadataTokenizer

ROOT = Path(__file__).resolve().parent.parent
BUNDLED_MAP = next((ROOT / "resources").glob("*.osu"))
METADATA_VOCAB = dict(
    modes={0: "osu", 1: "taiko", 3: "mania"},
    statuses={1: "ranked", 4: "loved", -2: "graveyard"},
    mappers={7: "OliBomby", 2: "peppy"},
    tags={1: {"name": "tech"}, 5: {"name": "stream"}},
    min_year=2010,
)
PROCESSORS = ("default", "custom")


def _processor(cls, mt_cls, kind):
    if kind == "default":
        return cls()
    proc = cls(metadata_tokenizer=mt_cls(**METADATA_VOCAB))
    dk = proc.default_kwargs
    dk["beatmap_kwargs"].update(max_length=2048, window_length_sec=16.0, window_stride_sec=16.0)
    dk["metadata_kwargs"].update(max_length=64, truncation=False)
    dk["audio_kwargs"].update(pad_to_multiple_of=256000, max_source_positions=1600)
    return proc


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("auto_map", [True, False], ids=["auto_map", "no-auto_map"])
@pytest.mark.parametrize("kind", PROCESSORS)
def test_the_export_writes_the_jax_packages_files(kind, auto_map, tmp_path):
    jax_out = jax_export_hf_processor(_processor(JaxProcessor, JaxMetadataTokenizer, kind), tmp_path / "jax",
                                      include_auto_map=auto_map)
    out = export_hf_processor(_processor(CM3PProcessor, MetadataTokenizer, kind), tmp_path / "port",
                              include_auto_map=auto_map)
    want, got = _tree(Path(jax_out)), _tree(out)
    assert set(got) == set(want) and len(got) == 9, sorted(got)
    for rel, path in got.items():
        if rel.endswith("vocab.json"):
            assert path.read_bytes() == want[rel].read_bytes(), rel
        else:
            assert json.loads(path.read_text()) == json.loads(want[rel].read_text()), rel
    text = "".join(p.read_text() for p in got.values() if p.name != "vocab.json")
    assert ("auto_map" in text) == auto_map
    mt_cfg = json.loads(got["metadata_tokenizer/tokenizer_config.json"].read_text())
    assert "min_difficculty" in mt_cfg and "min_difficulty" not in mt_cfg
    assert "emit_mania_column" not in json.loads(got["beatmap_parser/preprocessor_config.json"].read_text())
    dk = json.loads(got["processor_config.json"].read_text())["default_kwargs"]
    assert dk["common_kwargs"] == {"return_tensors": "pt"}
    assert dk["beatmap_kwargs"]["truncation"] == "longest_first"
    assert {"device", "padding", "truncation"} <= set(dk["audio_kwargs"])


@pytest.mark.parametrize("kind", PROCESSORS)
def test_the_export_reads_back_into_a_processor_that_tokenizes_alike(kind, tmp_path):
    source = _processor(CM3PProcessor, MetadataTokenizer, kind)
    loaded = CM3PProcessor.from_pretrained(export_hf_processor(source, tmp_path))
    # the reference schema's audio defaults stay, as the JAX package's reader keeps them (no call reads them)
    assert loaded.default_kwargs == JaxProcessor.from_pretrained(tmp_path).default_kwargs
    audio = dict(loaded.default_kwargs["audio_kwargs"])
    assert {k: audio.pop(k) for k in ("padding", "truncation")} == {"padding": True, "truncation": False}
    assert {**loaded.default_kwargs, "audio_kwargs": audio} == source.default_kwargs
    assert loaded.beatmap_tokenizer.vocab == source.beatmap_tokenizer.vocab
    assert loaded.metadata_tokenizer.vocab == source.metadata_tokenizer.vocab
    want, got = source(beatmap=str(BUNDLED_MAP)), loaded(beatmap=str(BUNDLED_MAP))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    meta = {"difficulty": 5.5, "year": 2015, "mode": "osu", "mapper": "OliBomby", "status": "ranked"}
    np.testing.assert_array_equal(loaded(metadata=meta)["input_ids"], source(metadata=meta)["input_ids"])


# --------------------------------------------------------------------- the weights' direction


def _jax_params(jmodel, audio_id, **extra):
    """Every parameter, the audio tower's included: init with audio placeholders and features."""
    ids = np.full((1, 24), 7, np.int32)
    ids[0, 1:3] = audio_id
    feats = np.random.default_rng(0).standard_normal((1, 80, 16)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids), input_features=jnp.asarray(feats),
                                  **extra)
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("kind", ["cm3p", "mlm-tied", "classifier"])
def test_save_pretrained_writes_what_export_hf_checkpoint_writes(kind, tmp_path):
    jcfg, tcfg = jax_tiny_config(), tiny_cm3p_config()
    for cfg in (jcfg, tcfg):
        cfg.beatmap_config.audio_token_id = 500
        cfg.beatmap_config.tie_word_embeddings = kind == "mlm-tied"
        cfg.beatmap_config.problem_type = "single_label_classification" if kind == "classifier" else None
        cfg.beatmap_config.num_labels = 3
    if kind == "cm3p":
        jmodel, cls, jconfig, tconfig = CM3PModule(jcfg, attn_impl="xla"), CM3PModel, jcfg, tcfg
        params = _jax_params(jmodel, 500, metadata_ids=jnp.ones((1, 8), jnp.int32))
    else:
        jcls, cls = (ClassifierModule, ClassifierModel) if kind == "classifier" else (MaskedLMModule, MaskedLMModel)
        jmodel, jconfig, tconfig = jcls(jcfg.beatmap_config, attn_impl="xla"), jcfg.beatmap_config, tcfg.beatmap_config
        params = _jax_params(jmodel, 500)
    export_hf_checkpoint(params, jconfig, tmp_path / "jax")
    model = cls(tconfig)
    state = state_dict_from_jax(params)
    if kind == "mlm-tied":
        state.pop("decoder.weight", None)
    model.load_state_dict(state, strict=True)
    save_pretrained(model, tmp_path / "port")
    want, got = load_file(tmp_path / "jax" / "model.safetensors"), load_file(tmp_path / "port" / "model.safetensors")
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)
    want_cfg = json.loads((tmp_path / "jax" / "config.json").read_text())
    got_cfg = json.loads((tmp_path / "port" / "config.json").read_text())
    assert got_cfg == want_cfg
    assert got_cfg["architectures"] == [{"cm3p": "CM3PModel", "mlm-tied": "CM3PForMaskedLM",
                                         "classifier": "CM3PForBeatmapClassification"}[kind]]
