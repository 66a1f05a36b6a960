"""The port's extraction pipeline on the CPU: processor parity, embed_beatmap
parity with the JAX package, the port's independence from JAX, and source
scans of its scripts (every CUDA kernel has its own profiler category).

The beatmap comes from the repo's ``resources/`` through this file's own
fixture; waveforms are synthetic, from a numpy seed.
"""
import ast
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.inference import embed_beatmap as jax_embed_beatmap
from cm3p_tpu.models import CM3PModule
from cm3p_tpu.processing import CM3PProcessor as JaxProcessor
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.inference import embed_beatmap, load_model
from cm3p_torch.interop import state_dict_from_jax
from cm3p_torch.processing import CM3PProcessor

REPO = Path(__file__).resolve().parent.parent
BEATMAP = REPO / "resources" / "Denkishiki Karen Ongaku Shuudan - Aoki Kotou no Anguis (OliBomby) [Ardens Spes].osu"


@pytest.fixture(scope="module")
def bundled_beatmap() -> str:
    assert BEATMAP.exists()
    return str(BEATMAP)


def _waveform(seconds: float, seed: int = 0) -> np.ndarray:
    return (0.1 * np.random.default_rng(seed).standard_normal(int(seconds * 16000))).astype(np.float32)


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"window_length_sec": 16.0, "window_stride_sec": 16.0, "max_length": 4096}],
    ids=["defaults", "16s-windows"],
)
def test_processor_matches_the_jax_package(bundled_beatmap, kwargs):
    wav = _waveform(70.0)
    ours = CM3PProcessor()(beatmap=bundled_beatmap, audio=wav, **kwargs)
    ref = JaxProcessor()(beatmap=bundled_beatmap, audio=wav, **kwargs)
    np.testing.assert_array_equal(ours["input_ids"], ref["input_ids"])
    np.testing.assert_array_equal(ours["attention_mask"], ref["attention_mask"])
    np.testing.assert_allclose(ours["input_features"], ref["input_features"], atol=1e-5)


def test_processor_without_audio_matches(bundled_beatmap):
    ours = CM3PProcessor()(beatmap=bundled_beatmap, window_length_sec=16.0, window_stride_sec=16.0)
    ref = JaxProcessor()(beatmap=bundled_beatmap, window_length_sec=16.0, window_stride_sec=16.0)
    np.testing.assert_array_equal(ours["input_ids"], ref["input_ids"])
    assert "input_features" not in ours


def _tiny_pair():
    proc = CM3PProcessor()
    tok = proc.beatmap_tokenizer
    cfgs = []
    for make in (jax_tiny_config, tiny_cm3p_config):
        cfg = make()
        cfg.beatmap_config.vocab_size = tok.vocab_size
        cfg.beatmap_config.audio_token_id = tok.audio_token_id
        cfgs.append(cfg)
    return proc, cfgs


def test_embed_beatmap_matches_the_jax_package(bundled_beatmap):
    proc, (jcfg, tcfg) = _tiny_pair()
    wav = _waveform(40.0, seed=1)
    kwargs = dict(window_length_sec=16.0, window_stride_sec=16.0, max_length=512)
    inputs = proc(beatmap=bundled_beatmap, audio=wav, **kwargs)
    jmodel = CM3PModule(jcfg, dtype=jnp.float32, attn_impl="xla")
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(inputs["input_ids"][:1]),
        input_features=jnp.asarray(inputs["input_features"][:1]),
        attention_mask=jnp.asarray(inputs["attention_mask"][:1]), method=CM3PModule.get_beatmap_features,
    )
    expected = jax_embed_beatmap(jmodel, params, JaxProcessor(), bundled_beatmap, audio=wav, mean_pool=False, **kwargs)
    model = load_model(tcfg, state_dict_from_jax(jax.tree.map(np.asarray, params)), device="cpu", dtype=torch.float32)
    got = embed_beatmap(model, proc, bundled_beatmap, audio=wav, mean_pool=False, device="cpu", **kwargs)
    assert got.shape == expected.shape and got.shape[0] >= 2
    cos = (got * expected).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(expected, axis=-1)
    assert cos.min() >= 0.99999
    pooled = embed_beatmap(model, proc, bundled_beatmap, audio=wav, device="cpu", **kwargs)
    np.testing.assert_allclose(np.linalg.norm(pooled), 1.0, atol=1e-5)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(tiny_cm3p_config())
    proc, (_, tcfg) = _tiny_pair()
    model = load_model(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        embed_beatmap(model, proc, str(BEATMAP))


def test_embed_beatmap_leaves_jax_out_of_the_process(bundled_beatmap):
    """A subprocess: this one has jax imported by the test harness."""
    script = textwrap.dedent(
        f"""
        import sys
        import numpy as np
        import torch
        from cm3p_torch.configs import tiny_cm3p_config
        from cm3p_torch.inference import embed_beatmap, load_model
        from cm3p_torch.interop import init_weights
        from cm3p_torch.processing import CM3PProcessor

        proc = CM3PProcessor()
        cfg = tiny_cm3p_config()
        cfg.beatmap_config.vocab_size = proc.beatmap_tokenizer.vocab_size
        cfg.beatmap_config.audio_token_id = proc.beatmap_tokenizer.audio_token_id
        model = load_model(cfg, init_weights(cfg, torch.Generator().manual_seed(0)), device="cpu")
        wav = (0.1 * np.random.default_rng(0).standard_normal(20 * 16000)).astype(np.float32)
        emb = embed_beatmap(model, proc, {str(bundled_beatmap)!r}, audio=wav, device="cpu", max_length=512)
        assert emb.shape == (cfg.projection_dim,) and np.isfinite(emb).all()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cm3p_tpu"))
        print("LOADED", bad)
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def test_training_cli_leaves_jax_out_of_the_process(tmp_path):
    """``python -m cm3p_torch.train`` (smoke config, two steps) loads no JAX module."""
    script = textwrap.dedent(
        f"""
        import sys
        from cm3p_torch.train.__main__ import main

        main(["--config-name", "smoke", "--device", "cpu", "training.output_dir={tmp_path}",
              "training.max_steps=2", "training.gradient_accumulation_steps=1", "training.eval_steps=2"])
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cm3p_tpu"))
        print("LOADED", bad)
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
    assert (tmp_path / "train_log.jsonl").exists()


_FORBIDDEN_ROOTS = {"jax", "jaxlib", "flax", "optax", "cm3p_tpu"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


_PORT_FILES = sorted(
    p for p in (REPO / "cm3p_torch").rglob("*")
    if p.suffix in (".py", ".cu", ".cuh", ".cpp") and "_build" not in p.parts
)
_PORT_SCRIPTS = [REPO / "chip_smoke.py", REPO / "compare_kernels.py"]


@pytest.mark.parametrize("path", _PORT_FILES + _PORT_SCRIPTS, ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax(path):
    """No module of the port (nor its scripts chip_smoke.py and compare_kernels.py) imports JAX or the JAX package."""
    if path.suffix == ".py":
        assert not _imported_roots(path) & _FORBIDDEN_ROOTS
    if path.parent != REPO:  # the scripts may name the TPU kernels they report on
        assert "cm3p_tpu" not in path.read_text()


@pytest.mark.parametrize(
    "path", [p for p in _PORT_FILES if p.suffix == ".py"], ids=lambda p: str(p.relative_to(REPO))
)
def test_port_reads_no_environment_option(path):
    """The JAX package takes its options from ``CM3P_*`` environment variables;
    the port takes them as arguments (``EncoderOptions``) and reads none."""
    text = path.read_text()
    tree = ast.parse(text, filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and node.value.startswith("CM3P_"):
            # naming a variable in prose is fine; using it as a key is not
            assert "\n" in node.value or " " in node.value, f"{path}: reads {node.value!r}"
    env_reads = [
        node for node in ast.walk(tree)
        if isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv")
        and isinstance(node.value, ast.Name) and node.value.id == "os"
    ]
    assert not env_reads, f"{path}: reads the environment"


_LAZY_ONLY = {"pandas", "pyarrow", "safetensors", "huggingface_hub"}


@pytest.mark.parametrize(
    "path", [p for p in _PORT_FILES if p.suffix == ".py"] + _PORT_SCRIPTS,
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_port_imports_dataframe_packages_only_inside_functions(path):
    """pandas, pyarrow, safetensors and huggingface_hub may be missing where the port runs: no module imports
    them at import time."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            assert not {a.name.split(".")[0] for a in node.names} & _LAZY_ONLY, path
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            assert node.module.split(".")[0] not in _LAZY_ONLY, path
    assert "safetensors" not in _imported_roots(path)  # the port has its own reader and writer


def test_port_covers_the_new_modules():
    names = {str(p.relative_to(REPO)) for p in _PORT_FILES}
    for rel in ("cm3p_torch/extract.py", "cm3p_torch/ops/quant.py", "cm3p_torch/ops/fused_ln_matmul.py",
                "cm3p_torch/csrc/fused_ln_matmul.cu", "cm3p_torch/interop/safetensors_io.py",
                "cm3p_torch/interop/hf_config.py", "cm3p_torch/data/loader.py",
                "cm3p_torch/data/beatmap_files_dataset.py", "cm3p_torch/data/data_utils.py",
                "cm3p_torch/native/__init__.py", "cm3p_torch/native/beatmap.py", "cm3p_torch/native/audio.py",
                "cm3p_torch/native/beatmap_fast.cpp", "cm3p_torch/native/audio_fast.cpp",
                "cm3p_torch/native/analytics.cpp", "cm3p_torch/audio/device_mel.py",
                "cm3p_torch/data/mmrs_dataset.py", "cm3p_torch/validate_dataset.py", "cm3p_torch/ops/xla_int8.py",
                "cm3p_torch/utils/profiling.py", "cm3p_torch/interop/hub.py", "cm3p_torch/explore.py",
                "cm3p_torch/interop/hf_export.py", "cm3p_torch/publish.py"):
        assert rel in names, rel


_KERNEL_DECL = re.compile(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(")


def _cuda_kernels():
    """(source, qualified name) of every ``__global__`` function in the port's CUDA sources; the
    qualified name leaves out the anonymous namespace, as the names in a profile print it."""
    kernels = []
    for path in (p for p in _PORT_FILES if p.suffix in (".cu", ".cuh")):
        namespaces, text, start = [], path.read_text(), 0
        for line in text.splitlines(keepends=True):
            opened = re.match(r"\s*namespace\s*(\w*)\s*\{", line)
            if opened:
                namespaces.append(opened.group(1))
            elif re.match(r"\s*\}\s*//\s*namespace", line):
                namespaces.pop()
            elif "__global__" in line:
                m = _KERNEL_DECL.match(text, start + line.index("__global__"))
                assert m, f"{path}: cannot read the kernel's name from {line!r}"
                kernels.append((path.name, "::".join([n for n in namespaces if n] + [m.group(1)])))
            start += len(line)
    return kernels


_KERNELS = _cuda_kernels()


def _profiler_categories():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "_CATEGORIES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no _CATEGORIES")


def test_the_scan_finds_every_kernel_source():
    assert {src for src, _ in _KERNELS} == {p.name for p in _PORT_FILES if p.suffix == ".cu"}
    assert len(_KERNELS) == len(set(_KERNELS)) >= 10


@pytest.mark.parametrize("kernel", [k for _, k in _KERNELS], ids=lambda k: k)
def test_every_cuda_kernel_has_its_own_profiler_category(kernel):
    """chip_smoke.py books the device time of a profile by the first ``_CATEGORIES`` fragment found in
    a kernel's name (``void (anonymous namespace)::<qualified name><template arguments>(...)``). The first
    fragment whose name part occurs in this kernel's name must name this kernel (its qualified name ends
    with the fragment's name part at a ``::`` boundary) and book it as one of ours, so that a new kernel
    is never booked under another kernel's category or under "other PyTorch"."""
    probe = f"void (anonymous namespace)::{kernel}<"
    for fragment, category in _profiler_categories():
        name = re.match(r"[\w:]+", fragment).group()
        if name in probe:
            assert f"::{kernel}".endswith(f"::{name}"), f"{kernel} would be booked under {fragment!r} ({category})"
            assert category.endswith("(ours)"), category
            return
    raise AssertionError(f"{kernel} has no category in chip_smoke._CATEGORIES: it would be booked as other work")
