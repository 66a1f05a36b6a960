"""Checkpoints in every form the JAX package reads, and Hub ids from a local cache, on the CPU.

A seeded tiny bundle written by ``save_pretrained`` is rewritten as two safetensors shards, as an fp32 and a
bf16 ``pytorch_model.bin``, and as a Hub id in a cache tree; ``load_pretrained`` of each must give
parameters bit-equal to the single-file bundle's (the bf16 forms to a bundle saved in bf16). The shards and
the fp32 ``.bin`` must also give the JAX package's ``load_hf_checkpoint`` the same parameters as the
single file. ``resolve_artifact`` must return the directory that the JAX resolver (``huggingface_hub``'s
offline ``snapshot_download``) returns for the same cache tree.
"""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cm3p_tpu.interop import load_hf_checkpoint
from cm3p_tpu.interop.hub import looks_like_repo_id as jax_looks_like_repo_id
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.inference import load_model, load_pretrained, read_bundle, save_pretrained
from cm3p_torch.interop import init_weights
from cm3p_torch.interop.hub import looks_like_repo_id, resolve_artifact
from cm3p_torch.interop.safetensors_io import load_file, save_file
from cm3p_torch.processing import CM3PProcessor

REPO = Path(__file__).resolve().parent.parent
COMMIT = "0123456789abcdef0123456789abcdef01234567"


def _model(vocab=None):
    proc = CM3PProcessor()
    cfg = tiny_cm3p_config()
    cfg.beatmap_config.vocab_size = vocab or proc.beatmap_tokenizer.vocab_size
    cfg.beatmap_config.audio_token_id = cfg.beatmap_config.vocab_size - 1
    return proc, load_model(cfg, init_weights(cfg, torch.Generator().manual_seed(0)), device="cpu",
                            dtype=torch.float32)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """The single-file bundle in fp32 and in bf16, with the processor."""
    root = tmp_path_factory.mktemp("bundles")
    proc, model = _model()
    return save_pretrained(model, root / "fp32", processor=proc), save_pretrained(model, root / "bf16", bf16=True)


def _state(model):
    return model.state_dict()


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _copy_config(src: Path, dst: Path) -> Path:
    dst.mkdir(parents=True)
    (dst / "config.json").write_text((src / "config.json").read_text())
    return dst


def _sharded(src: Path, dst: Path) -> Path:
    """Two shards and an index, as the Hub writes a large checkpoint."""
    state = load_file(src / "model.safetensors")
    names = sorted(state)
    half = len(names) // 2
    index = {}
    for i, part in enumerate((names[:half], names[half:]), 1):
        fname = f"model-0000{i}-of-00002.safetensors"
        save_file({k: state[k] for k in part}, dst / fname, metadata={"format": "pt"})
        index.update({k: fname for k in part})
    (dst / "model.safetensors.index.json").write_text(json.dumps({"metadata": {}, "weight_map": index}))
    return dst


def _bin(src: Path, dst: Path, dtype) -> Path:
    state = {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32 else torch.from_numpy(v)
             for k, v in load_file(src / "model.safetensors").items()}
    torch.save(state, dst / "pytorch_model.bin")
    return dst


def _cache_tree(root: Path, repo_id: str, bundle: Path, revision="main") -> Path:
    repo = root / ("models--" + repo_id.replace("/", "--"))
    snapshot = repo / "snapshots" / COMMIT
    shutil.copytree(bundle, snapshot)
    (repo / "refs").mkdir()
    (repo / "refs" / revision).write_text(COMMIT)
    (repo / "blobs").mkdir()
    return root


def test_shards_and_bin_files_load_bit_equal_to_the_single_file(bundles, tmp_path):
    fp32, bf16 = bundles
    _, want = load_pretrained(fp32, device="cpu", dtype=torch.float32)
    _, want_bf16 = load_pretrained(bf16, device="cpu", dtype=torch.float32)
    shards = _sharded(fp32, _copy_config(fp32, tmp_path / "shards"))
    bin32 = _bin(fp32, _copy_config(fp32, tmp_path / "bin32"), torch.float32)
    bin16 = _bin(bf16, _copy_config(bf16, tmp_path / "bin16"), torch.bfloat16)
    for directory, ref in ((shards, want), (bin32, want), (bin16, want_bf16)):
        _, got = load_pretrained(directory, device="cpu", dtype=torch.float32)
        _assert_bit_equal(_state(got), _state(ref))
    assert all(v.dtype != torch.bfloat16 for v in read_bundle(bin16)[1].values())  # made fp32

    # the JAX package's reader gives the same parameters from the shards and the fp32 .bin as from the file
    _, jref = load_hf_checkpoint(fp32)
    for directory in (shards, bin32):
        _, jgot = load_hf_checkpoint(directory)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), jgot, jref)


def test_f16_shards_are_read_as_fp32(bundles, tmp_path):
    fp32, _ = bundles
    directory = _copy_config(fp32, tmp_path / "f16")
    state = load_file(fp32 / "model.safetensors")
    save_file({k: v.astype(np.float16) if v.dtype == np.float32 else v for k, v in state.items()},
              directory / "model.safetensors")
    _, got = read_bundle(directory)
    ref = read_bundle(fp32)[1]
    for k, v in got.items():
        assert v.dtype == ref[k].dtype and torch.equal(v, ref[k].half().float()), k


@pytest.mark.parametrize("name", ["OliBomby/CM3P", "org/name", "org-1/name.v2", "a/b/c", "name", "org/na me",
                                  "./rel", "", "org/", "/abs/path", "__exists__"])
def test_looks_like_repo_id_agrees_with_the_jax_package(name, tmp_path):
    if name == "__exists__":  # an existing path is never a repo id
        (tmp_path / "org").mkdir()
        name = str(tmp_path / "org")
    assert looks_like_repo_id(name) == jax_looks_like_repo_id(name)


def _jax_resolve(cache: Path, repo_id: str, revision=None) -> str:
    """The JAX package's ``resolve_artifact`` in a process of its own, offline over ``cache``."""
    spec = f"importlib.util.spec_from_file_location('hub', {str(REPO / 'cm3p_tpu' / 'interop' / 'hub.py')!r})"
    script = (
        f"import importlib.util, json\nspec = {spec}\nhub = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(hub)\n"
        f"try:\n    print(json.dumps(hub.resolve_artifact({repo_id!r}, revision={revision!r})))\n"
        "except FileNotFoundError as e:\n    print(json.dumps({'error': type(e.__cause__).__name__}))\n"
    )
    env = {**os.environ, "HF_HUB_OFFLINE": "1", "HF_HUB_CACHE": str(cache), "HF_HOME": str(cache.parent / "home")}
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_resolve_artifact_finds_the_snapshot_the_jax_resolver_finds(bundles, tmp_path):
    pytest.importorskip("huggingface_hub")
    cache = _cache_tree(tmp_path / "hub", "org/model", bundles[0])
    want = str(cache / "models--org--model" / "snapshots" / COMMIT)
    assert resolve_artifact("org/model", cache_dir=cache) == want == _jax_resolve(cache, "org/model")
    assert resolve_artifact("org/model", revision=COMMIT, cache_dir=cache) == want
    assert resolve_artifact(str(bundles[0]), cache_dir=cache) == str(bundles[0])  # a local path passes
    with pytest.raises(FileNotFoundError, match="downloads nothing") as err:
        resolve_artifact("org/missing", cache_dir=cache)
    assert "org/missing" in str(err.value) and str(cache) in str(err.value) and "'main'" in str(err.value)
    assert _jax_resolve(cache, "org/missing") == {"error": "LocalEntryNotFoundError"}


def test_a_hub_id_loads_with_its_processor_and_keeps_the_vocabulary_rule(bundles, tmp_path):
    fp32, _ = bundles
    cache = _cache_tree(tmp_path / "hub", "org/model", fp32)
    proc, model = load_pretrained("org/model", device="cpu", dtype=torch.float32, cache_dir=cache)
    _, ref = load_pretrained(fp32, device="cpu", dtype=torch.float32)
    _assert_bit_equal(_state(model), _state(ref))
    assert proc.beatmap_tokenizer.vocab_size == CM3PProcessor.from_pretrained(str(fp32)).beatmap_tokenizer.vocab_size

    # a checkpoint vocabulary below the tokenizer's warns here (and raises on CUDA) by every route
    small_proc, small = _model(vocab=100)
    small_dir = save_pretrained(small, tmp_path / "small", processor=small_proc)
    _cache_tree(tmp_path / "hub2", "org/small", small_dir)
    bin_dir = _bin(small_dir, _copy_config(small_dir, tmp_path / "small_bin"), torch.float32)
    for source, kw in (("org/small", dict(cache_dir=tmp_path / "hub2")), (bin_dir, {})):
        with pytest.warns(UserWarning, match="out-of-range ids"):
            load_pretrained(source, device="cpu", dtype=torch.float32, **kw)
