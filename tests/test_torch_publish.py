"""``python -m cm3p_torch.publish`` on the CPU, offline.

Bundles as the port's trainer writes them (``save_pretrained`` with the
processor into ``model/``, the processor alone into ``processor/``) at a tiny
width, for the dual-tower model and the flat masked-LM and classifier
models: ``model/`` and ``processor/`` copied as they are, a card naming the
architecture of the config, and with ``--hf`` an ``hf/`` whose weight file is
byte-equal to ``model/``'s, whose ``config.json`` is ``model/``'s, whose
processor is in the reference's ``AutoProcessor`` layout, and which
``load_pretrained`` loads. The Hub push runs against a stub
``huggingface_hub`` in ``sys.modules`` (the call order of
``publish_model.py``: ``create_repo``, ``create_branch`` for ``--revision``,
``upload_folder`` with ``create_pr``); a failed push and a missing package
each return 1 and leave the bundle whole.
"""
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cm3p_torch import publish
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.inference import load_pretrained, save_pretrained
from cm3p_torch.interop import init_weights
from cm3p_torch.interop.safetensors_io import load_file
from cm3p_torch.models import ClassifierModel, CM3PModel, MaskedLMModel
from cm3p_torch.processing import CM3PProcessor

ROOT = Path(__file__).resolve().parent.parent
BUNDLED_MAP = next((ROOT / "resources").glob("*.osu"))
KINDS = {"cm3p": ("CM3PModel", CM3PModel), "mlm": ("CM3PForMaskedLM", MaskedLMModel),
         "classifier": ("CM3PForBeatmapClassification", ClassifierModel)}
REFERENCE_FILES = ("processor_config.json", "audio_feature_extractor/preprocessor_config.json",
                   "beatmap_parser/preprocessor_config.json", "beatmap_tokenizer/tokenizer_config.json",
                   "beatmap_tokenizer/special_tokens_map.json", "beatmap_tokenizer/vocab.json",
                   "metadata_tokenizer/tokenizer_config.json", "metadata_tokenizer/special_tokens_map.json",
                   "metadata_tokenizer/vocab.json")


def _trainer_output(root: Path, kind: str) -> list:
    """A trainer's ``model/`` and ``processor/`` for ``kind`` at a tiny width; returns publish's arguments."""
    proc = CM3PProcessor()
    cfg = tiny_cm3p_config()
    cfg.beatmap_config.vocab_size = proc.beatmap_tokenizer.vocab_size
    cfg.beatmap_config.audio_token_id = proc.beatmap_tokenizer.audio_token_id
    cfg.metadata_config.vocab_size = proc.metadata_tokenizer.vocab_size
    gen = torch.Generator().manual_seed(0)
    if kind == "cm3p":
        model = CM3PModel(cfg)
        model.load_state_dict(init_weights(cfg, gen, with_metadata=True))
    else:
        bc = cfg.beatmap_config
        if kind == "classifier":
            bc.num_labels, bc.problem_type = 3, "single_label_classification"
        model = KINDS[kind][1](bc)
        model.load_state_dict(init_weights(bc, gen, head=kind))
    save_pretrained(model, root / "out" / "model", processor=proc)
    proc.save_pretrained(root / "out" / "processor")
    return ["--model-dir", str(root / "out" / "model"), "--processor-dir", str(root / "out" / "processor"),
            "--output", str(root / "release")]


@pytest.mark.parametrize("kind", list(KINDS))
def test_publish_hf_writes_a_card_and_a_bit_equal_reference_bundle(kind, tmp_path):
    architecture, cls = KINDS[kind]
    args = _trainer_output(tmp_path, kind)
    assert publish.main(args + ["--hf", "--name", "org/cm3p-test", "--training-details", "two steps"]) == 0
    release = tmp_path / "release"
    for sub in ("model", "processor"):
        src = tmp_path / "out" / sub
        for path in src.rglob("*"):
            if path.is_file():
                assert (release / sub / path.relative_to(src)).read_bytes() == path.read_bytes(), path
    card = (release / "README.md").read_text()
    assert "library_name: cm3p_torch" in card and "- pytorch" in card and "- cuda" in card
    assert "- jax" not in card and "- tpu" not in card
    assert f"`{architecture}`" in card and f"{architecture}.from_pretrained(\"org/cm3p-test/hf\")" in card
    assert "load_pretrained" in card and "CM3PProcessor.from_pretrained" in card and "two steps" in card

    hf = release / "hf"
    assert (hf / "model.safetensors").read_bytes() == (release / "model" / "model.safetensors").read_bytes()
    want, got = load_file(release / "model" / "model.safetensors"), load_file(hf / "model.safetensors")
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype and np.array_equal(got[name], value), name
    assert json.loads((hf / "config.json").read_text()) == json.loads((release / "model" / "config.json").read_text())
    for rel in REFERENCE_FILES:
        assert (hf / rel).is_file(), rel
    assert "common_kwargs" in json.loads((hf / "processor_config.json").read_text())["default_kwargs"]

    proc, model = load_pretrained(hf, device="cpu", dtype=torch.float32)
    assert type(model) is cls
    source = load_pretrained(release / "model", device="cpu", dtype=torch.float32)[1].state_dict()
    assert all(torch.equal(t, source[k]) for k, t in model.state_dict().items())
    want_ids = CM3PProcessor.from_pretrained(release / "processor")(beatmap=str(BUNDLED_MAP))["input_ids"]
    np.testing.assert_array_equal(proc(beatmap=str(BUNDLED_MAP))["input_ids"], want_ids)


def test_publish_without_hf_writes_no_hf_bundle(tmp_path):
    assert publish.main(_trainer_output(tmp_path, "mlm")) == 0
    release = tmp_path / "release"
    assert not (release / "hf").exists()
    card = (release / "README.md").read_text()
    assert "# release" in card and "`CM3PForMaskedLM`" in card and "hf/" not in card


def _stub_hub(monkeypatch, fail=False):
    calls = {"create_repo": [], "create_branch": [], "upload_folder": []}

    class StubApi:
        def create_repo(self, repo_id, exist_ok=False):
            calls["create_repo"].append({"repo_id": repo_id, "exist_ok": exist_ok})

        def create_branch(self, repo_id, branch, exist_ok=False):
            calls["create_branch"].append({"repo_id": repo_id, "branch": branch})

        def upload_folder(self, **kw):
            if fail:
                raise RuntimeError("no network")
            calls["upload_folder"].append(kw)

    stub = types.ModuleType("huggingface_hub")
    stub.HfApi = StubApi
    monkeypatch.setitem(sys.modules, "huggingface_hub", stub)
    return calls


@pytest.fixture(scope="module")
def trainer_output(tmp_path_factory):
    root = tmp_path_factory.mktemp("publish")
    return root, _trainer_output(root, "cm3p")


def test_push_with_revision_and_pr(trainer_output, tmp_path, monkeypatch):
    _, args = trainer_output
    calls = _stub_hub(monkeypatch)
    out = tmp_path / "pushed"
    rc = publish.main(args[:-1] + [str(out), "--repo-id", "someone/CM3P", "--revision", "v2", "--create-pr"])
    assert rc == 0
    assert calls["create_repo"] == [{"repo_id": "someone/CM3P", "exist_ok": True}]
    assert calls["create_branch"] == [{"repo_id": "someone/CM3P", "branch": "v2"}]
    (up,) = calls["upload_folder"]
    assert up["repo_id"] == "someone/CM3P" and up["revision"] == "v2" and up["create_pr"] is True
    assert up["folder_path"] == str(out) and up["commit_message"] == "Upload pushed"


def test_push_without_revision_creates_no_branch(trainer_output, tmp_path, monkeypatch):
    _, args = trainer_output
    calls = _stub_hub(monkeypatch)
    assert publish.main(args[:-1] + [str(tmp_path / "r"), "--repo-id", "someone/CM3P"]) == 0
    assert calls["create_branch"] == [] and calls["upload_folder"][0]["create_pr"] is False
    assert calls["upload_folder"][0]["revision"] is None


@pytest.mark.parametrize("failure", ["push-fails", "no-package"])
def test_a_failed_push_returns_1_and_keeps_the_bundle(trainer_output, failure, tmp_path, monkeypatch):
    _, args = trainer_output
    if failure == "push-fails":
        _stub_hub(monkeypatch, fail=True)
    else:
        monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # import raises ImportError
    out = tmp_path / "release"
    assert publish.main(args[:-1] + [str(out), "--hf", "--repo-id", "someone/CM3P"]) == 1
    for rel in ("README.md", "model/model.safetensors", "model/config.json", "processor/processor_config.json",
                "hf/model.safetensors", "hf/config.json", *(f"hf/{f}" for f in REFERENCE_FILES)):
        assert (out / rel).is_file(), rel

