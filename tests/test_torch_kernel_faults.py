"""The bounds-checked build of the attention kernels, on the card.

Imports torch only (no JAX), so it runs where JAX is absent:
``python -m pytest tests/test_torch_kernel_faults.py --noconftest -q``. Every
test is marked ``gpu`` and skips without CUDA.

* The checked build records what it is there to find: a key-tile range read
  from a tensor that points before the first tile, and an output that a launch
  leaves unwritten (still holding the poison), each raised naming the kernel.
* The stress layouts of ``chip_smoke.py`` phase 6b (padding-only rows, a first
  tile of padding, segments ending on 64- and 128-token tile edges,
  one-token segments, query tiles that meet no key tile, L 4096 / 4032 / 4000
  / 2048, H 12 / 4 / 3 / 1, with and without rope) and the training step's
  attention shapes (10 rows of 4096, H 12 with rope; the metadata pack's
  rows, H 4): the forward with lse, the rope pass and both backward kernels
  in the checked build on poisoned outputs, with no record, against the plain
  versions at ``chip_smoke.py`` phase 5's tolerances (out 2e-2 abs, lse 1e-3
  on live rows and exactly log2(1e-30) on dead ones, dq / dk / dv 1e-2 of the
  largest entry and exactly 0 on dead rows).
"""
import importlib
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
attn = importlib.import_module("cm3p_torch.ops.attention")

pytestmark = pytest.mark.gpu

TOL, LSE_TOL, BWD_REL_TOL = 2e-2, 1e-3, 1e-2
THETA = {64: 10000.0, None: 160000.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    return importlib.import_module("chip_smoke")


def _qkv(b, length, heads, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = torch.randn(b, length, 3, heads, 64, generator=gen, device=device).to(torch.bfloat16).unbind(2)
    dout = torch.randn(b, length, heads, 64, generator=gen, device=device).to(torch.bfloat16)
    return q, k, v, dout


def test_checked_build_records_a_tile_range_outside_the_tiles(cuda):
    q, k, v, _ = _qkv(1, 256, 2, cuda)
    seg = torch.ones(1, 256, dtype=torch.int32, device=cuda)
    start = torch.tensor([[0, -5, 0, 0]], dtype=torch.int32, device=cuda)
    count = torch.ones(1, 4, dtype=torch.int32, device=cuda)
    out = torch.empty(q.shape, dtype=q.dtype, device=cuda)
    args = (*attn._common_args(q, k, v, seg, seg, None), start.data_ptr(), count.data_ptr(), None, out.data_ptr(),
            None, 1, 256, 256, 2, attn._stream(q))
    with attn.checked_kernels(), pytest.raises(RuntimeError, match=r"attention_kernel<false>.*tile index -5"):
        attn._launch("attention", attn._SIGNATURES, "cm3p_segment_attention", args,
                     dict(q=q, k=k, v=v, qseg=seg, kseg=seg, start=start, count=count), dict(out=out))


def test_checked_build_reports_an_unwritten_output(cuda):
    seg = torch.ones(2, 300, dtype=torch.int32, device=cuda)
    out = torch.empty(2 * 2 * 5 + 2 * 2 * 10, dtype=torch.int32, device=cuda)
    start, count, scratch = out[:10].view(2, 5), out[10:20].view(2, 5), out[20:]
    never = torch.empty(7, dtype=torch.float32, device=cuda)  # named as an output, but no kernel writes it
    args = (seg.data_ptr(), seg.data_ptr(), start.data_ptr(), count.data_ptr(), scratch.data_ptr(), 2, 300, 300,
            attn._stream(seg))
    with attn.checked_kernels(), pytest.raises(RuntimeError, match=r"7 of 7 elements of lse .* left unwritten"):
        attn._launch("attention", attn._SIGNATURES, "cm3p_key_tile_ranges", args, dict(qseg=seg, kseg=seg),
                     dict(start=start, count=count, range_scratch=scratch, lse=never))


def _run_checked(seg, heads, rope, window):
    """The forward with lse, the rope pass and both backward kernels in the checked build, and the plain
    versions; raises on a record or an unwritten output."""
    b, length = seg.shape
    q, k, v, dout = _qkv(b, length, heads, seg.device, seed=length + heads)
    theta = THETA[window] if rope else None
    args = (window,) if window else ()
    with attn.checked_kernels():
        fwd = attn.window_attention if window else attn.segment_attention
        out, lse = fwd(q, k, v, seg, seg, *args, theta, return_lse=True)
    plain = attn.window_attention_plain if window else attn.segment_attention_plain
    want, want_lse = plain(q, k, v, seg, seg, *args, theta, return_lse=True)
    delta = attn.attention_delta(want, dout)
    with attn.checked_kernels():
        rot = attn.backward_rope_pass(q, k, theta) if rope else None
        dq_fn = attn.window_attention_dq if window else attn.segment_attention_dq
        dkv_fn = attn.window_attention_dkv if window else attn.segment_attention_dkv
        dq = dq_fn(q, k, v, dout, want_lse, delta, seg, seg, *args, theta, rot)
        dk, dv = dkv_fn(q, k, v, dout, want_lse, delta, seg, seg, *args, theta, rot)
    if rope:
        ref = attn.attention_bwd_rope_plain(q, k, v, dout, want_lse, delta, seg, seg, window, theta)
    else:
        ref = attn._attention_bwd_plain(q, k, v, dout, want_lse, delta, seg, seg, window)
    torch.cuda.synchronize()
    dead = seg == 0
    live = (~dead)[:, None, :].expand(b, heads, length)
    assert (out.float() - want.float()).abs().max().item() <= TOL
    if bool(live.any()):
        assert (lse - want_lse)[live].abs().max().item() <= LSE_TOL
    assert torch.equal(lse[~live], want_lse[~live])
    for got, r in zip((dq, dk, dv), ref):
        assert (got.float() - r.float()).abs().max().item() <= BWD_REL_TOL * r.float().abs().max().item()
    if bool(dead.any()):
        for t in (out, dq, dk, dv):
            assert t[dead].abs().max().item() == 0.0


@pytest.mark.parametrize("window", [64, None], ids=["window", "segment"])
@pytest.mark.parametrize("case", range(4), ids=["case0", "case1", "case2", "case3"])
def test_stress_layouts_in_the_checked_build(cuda, case, window):
    cs = _chip_smoke()
    length, heads, rope = cs.STRESS_CASES[case]
    _run_checked(cs.stress_segments(torch, length, cuda), heads, rope, window)


def _training_segments(cuda):
    """The v8_packed training batch's packed rows and the metadata pack's rows, as chip_smoke.py phase 6 makes
    them from the 17 maps."""
    cs = _chip_smoke()
    from cm3p_torch.train.__main__ import CONFIG_DIR, beatmap_file_batches, beatmap_paths, build_processor
    from cm3p_torch.utils.config import load_config

    args = load_config(CONFIG_DIR, "v8_packed", [])
    paths = beatmap_paths([str(REPO / "resources"), str(REPO / "resources" / "perf_corpus")])
    batch = next(iter(beatmap_file_batches(args, build_processor(args), paths, test=False)()))
    seg10 = torch.as_tensor(batch["segment_ids"], device=cuda).to(torch.int32).contiguous()
    return seg10, cs.meta_pack_segments(torch, batch, int(args["meta_pack"]), cuda)


@pytest.mark.parametrize("layout, window", [("beatmap", 64), ("beatmap", None), ("metadata", None)],
                         ids=["beatmap-rows-H12-rope-window", "beatmap-rows-H12-rope-segment", "metadata-pack-H4"])
def test_training_shapes_in_the_checked_build(cuda, layout, window):
    """The training step's attention launches (the metadata tower's layers are all global, rope outside)."""
    seg10, meta = _training_segments(cuda)
    if layout == "beatmap":
        _run_checked(seg10, 12, True, window)
    else:
        _run_checked(meta, 4, False, window)
