"""The bounds-checked build of the attention kernels, on the CPU.

* ``ops._build``: the checked form of a source has its own target (``-checked-``
  in the file name), its own flags (``-lineinfo`` and a define outside the
  ``CM3P_`` names of the JAX package's options), enters the hash, exists for
  the two attention sources only, and is never the default of ``build`` or
  ``library``.
* ``csrc/bounds.cuh``: the enums the fault record names are the names
  ``ops.attention`` prints; the define is the one the build passes.
* ``checked_kernels`` is a context that restores the default build, the
  wrappers on CPU tensors run the same plain versions inside it, and no module
  of the port but the wrappers' launch helper asks for the checked build.
* The stress layouts of ``chip_smoke.py`` phase 6b: the plain
  ``segment_tile_ranges`` (the oracle of the ranges kernel) against the JAX
  package's ``_block_ranges`` on every layout and length, exactly (the
  square layouts give the forward's and the dK/dV kernel's ranges alike).
"""
import ast
import importlib
import inspect
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cm3p_tpu.ops.flash_attention as fa
from cm3p_torch.ops import _build

REPO = Path(__file__).resolve().parents[1]
attn = importlib.import_module("cm3p_torch.ops.attention")


def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module("chip_smoke")


def test_the_checked_build_has_its_own_target_and_flags():
    for name in _build.CHECKED_SOURCES:
        default, checked = _build._target(name), _build._target(name, checked=True)
        assert default != checked and default.parent == checked.parent == _build.BUILD_DIR
        assert checked.name.startswith(f"lib{name}-checked-") and "-checked-" not in default.name
    assert _build.flags() == _build.NVCC_FLAGS
    assert _build.flags(checked=True) == _build.NVCC_FLAGS + _build.CHECKED_FLAGS
    assert "-lineinfo" in _build.CHECKED_FLAGS
    defines = [f[2:] for f in _build.CHECKED_FLAGS if f.startswith("-D")]
    assert defines == ["ATTN_BOUNDS_CHECK"] and not defines[0].startswith("CM3P_")
    with pytest.raises(ValueError, match="no bounds-checked build"):
        _build._target("fused_ffn", checked=True)


def test_the_default_build_is_unchecked():
    for fn in (_build.build, _build.library):
        assert inspect.signature(fn).parameters["checked"].default is False
    assert set(_build.CHECKED_SOURCES) == {"attention", "attention_bwd"}


def test_the_checked_flags_enter_the_hash(monkeypatch):
    before = _build._target("attention", checked=True)
    monkeypatch.setattr(_build, "CHECKED_FLAGS", _build.CHECKED_FLAGS + ("-DSOMETHING_ELSE",))
    assert _build._target("attention", checked=True) != before
    assert _build._target("attention") == _build._target("attention", checked=False)


def _enum(text: str, name: str) -> list[str]:
    body = re.search(r"enum " + name + r" : int \{([^}]*)\}", text).group(1)
    return [item.split("=")[0].strip() for item in body.split(",") if item.strip()]


def test_the_fault_record_names_match_the_header():
    text = (REPO / "cm3p_torch" / "csrc" / "bounds.cuh").read_text()
    tensors = _enum(text, "Tensor")
    assert tensors[-1] == "NTENSORS"
    assert [t.lower() for t in tensors[:-1]] == list(attn.BOUNDS_TENSORS)
    assert [r.lower() for r in _enum(text, "Range")] == list(attn.BOUNDS_RANGES)
    assert len(_enum(text, "Kernel")) == len(attn.BOUNDS_KERNELS)
    assert "#ifdef ATTN_BOUNDS_CHECK" in text
    fields = re.sub(r"//[^\n]*", "", re.search(r"struct Fault \{(.*?)\};", text, re.S).group(1))
    assert [n for n, _ in attn.BoundsFault._fields_] == re.findall(r"(\w+)(?:\[\d\])?[,;]", fields)


def test_checked_kernels_is_a_context_and_the_cpu_route_is_unchanged():
    gen = torch.Generator().manual_seed(0)
    q, k, v = torch.randn(3, 1, 130, 2, 64, generator=gen)
    seg = torch.tensor([[1] * 60 + [2] * 50 + [0] * 20], dtype=torch.int32)
    want = attn.segment_attention(q, k, v, seg, seg, 160000.0, return_lse=True)
    assert attn._checked is False
    with attn.checked_kernels():
        assert attn._checked is True
        got = attn.segment_attention(q, k, v, seg, seg, 160000.0, return_lse=True)
        ranges = attn.key_tile_ranges(seg, seg)
    assert attn._checked is False
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(ranges, attn.segment_tile_ranges(seg, seg)))


def test_only_the_launch_helper_asks_for_the_checked_build():
    """No default path, entry point or option of the port selects the checked build: the one call that passes
    ``checked=True`` is the wrappers' launch helper, under ``checked_kernels``."""
    calls = []
    for path in (REPO / "cm3p_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and any(kw.arg == "checked" for kw in node.keywords):
                calls.append((path.relative_to(REPO).as_posix(), ast.unparse(node)))
    assert calls == [("cm3p_torch/ops/attention.py",
                      "_build.library(source, {**signatures, **_BOUNDS_SIGNATURES}, checked=True)")]
    src = inspect.getsource(attn._launch)
    assert src.index("if not _checked:") < src.index("checked=True")


@pytest.mark.parametrize("case", range(5), ids=["L4096", "L4032", "L4000", "L2048", "metadata-pack"])
def test_stress_layouts_tile_ranges_match_block_ranges(case):
    cs = _chip_smoke()
    if case < 4:
        seg = cs.stress_segments(torch, cs.STRESS_CASES[case][0], "cpu")
    else:  # the metadata pack's layout: 16 sequences of 128 a row, ragged key masks, a padded last row
        mask = np.zeros((40, 128), np.int64)
        for i, n in enumerate(np.random.default_rng(0).integers(1, 129, 40)):
            mask[i, :n] = 1
        seg = cs.meta_pack_segments(torch, {"metadata_attention_mask": mask}, 16, "cpu")
    b, length = seg.shape
    tile = attn.TILE
    n = -(-length // tile)
    padded = jnp.pad(jnp.asarray(seg.numpy()), ((0, 0), (0, n * tile - length)))
    start, count = attn.segment_tile_ranges(seg, seg)
    js, jc = fa._block_ranges(b, n, n, n, tile, tile, None, padded, padded)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(start.numpy(), np.asarray(js))
    assert int((count == 0).sum()) > 0  # the layouts reach query tiles that meet no key tile
