"""The port's CUDA kernels against their plain versions, on the card.

Imports torch only (no JAX), so it also runs where JAX is absent:
``python -m pytest tests/test_torch_kernels.py --noconftest -q``. Tests marked
``gpu`` skip without CUDA. Tolerances: 2e-2 abs on bf16 outputs of magnitude
~1 (a bf16 ulp at 2-4 is 1.6e-2; the kernels sum in another order than the
plain versions), and exactly 0 on queries that see no key. The backward
kernels: 1e-2 of the largest gradient entry (bf16 outputs, p and ds rounded
to bf16 before their products in both), lse 1e-3 abs (fp32 statistics).
The int8 forms: 2e-2 abs on the outputs; the activation codes a kernel
exports may differ from the plain quantiser's by one at most (LN's reduction
order can move a value across a .5 boundary), on a share of 1e-3 at most.
The rope forms of the backward kernels (raw q/k, dq/dk counter-rotated) are
held to the plain rope backward at the same 1e-2, after the forward with rope
and lse (2e-2, 1e-3); the window kernels also at w = 192, the TPU's streaming
route. The rectangular form of the segment kernel (Lq != Lk) at the same
2e-2, and bit-equal to the square form where Lq == Lk. The attention kernels
with the Wo epilogue: 2e-2 abs on outputs and on the
attention output they export; the residual exactly on rows that see no key;
the int8 codes of the exported attention output as for the LN forms. The bf16
epilogue kernel at its tile edges (lengths 1-1500, one segment over 4096
tokens, segment edges on and off a tile boundary, padding-only rows, windows 0,
64 and 128, H * D 768 / 512 / 256, more query tiles than SMs): the same
2e-2 with a residual, and with a zero residual the product and the exported
attention output each within 2 % of their largest entry. The FFN kernel's
wgmma forms (bf16, w8a8, w8a8 + w8a8_wo) at their tile edges: 2e-2, with the
FFN's own part asserted above 2 x 2e-2 so that the residual cannot hide an
error, and the codes they export as for the LN forms. The forward kernel at
its edges (lengths 1-4037, single-token segments, padding-only rows and empty
key ranges, windows 64 / 192 / 256 and the segment form, H 3 / 4 / 8 / 12,
with rope and lse and without): the same 2e-2 and 1e-3, and exactly log2(1e-30)
as the lse of a query that sees no key; the rectangular form at lengths off the
tiles; the int8 epilogue kernel at the bf16 one's edges, with its codes as for
the LN forms. The LN-matmul forms also at the persistent kernels' row counts
(an odd number of 128-row tiles, several tiles per cluster, zero rows in the
first and the last tile), and the int8 form at its tile edges as the bf16 one,
with its codes as above. The fp32 LN-matmul forms at the fp32-weight kernel's
128-row tile edges (1, 127, 128, 129 rows, a ragged count, three waves of the
card's SMs), N 128 to 2304 and D 256 to 768: 1e-5 of the largest entry; the
int8 form also at every N that is a multiple of 128 up to 2304, and the share
of its rows that equal the plain version bit for bit (where the codes agree)
reported. The fp32 FFN at the same row edges (and past a wave of its
persistent grid) in every form, and at every F that is a multiple of 64 up to
past the first version's shared-memory limit (1792 / 2048 / 2304 at D 768 /
512 / 256), with and without an LN bias. The
dQ kernel at the dK/dV kernel's lengths, windows and rope settings (1e-2 of the
largest entry, dq exactly 0 on queries that see no key), and one rope pass
per backward call feeding both kernels, bit-equal to the kernels called alone.
"""
import importlib
import math

import pytest
import torch

from cm3p_torch.ops import (
    KERNELS,
    fused_ln_ffn,
    fused_ln_ffn_plain,
    fused_ln_ffn_q,
    fused_ln_matmul,
    fused_ln_matmul_plain,
    fused_ln_matmul_q,
    fused_ln_matmul_q_plain,
    int8_matmul,
    launch_counts,
    layer_norm_f32,
    quant_rows_int8,
    quantize_weight_int8,
    reset_launch_counts,
)
from cm3p_torch.ops.attention import (
    _attention_bwd_plain,
    apply_rope,
    key_tile_ranges,
    attention_bwd_rope_plain,
    attention_delta,
    segment_attention,
    segment_attention_dkv,
    segment_attention_dq,
    segment_attention_plain,
    segment_attention_rect,
    segment_attention_rect_plain,
    segment_attention_wo,
    segment_tile_ranges,
    segment_attention_wo_plain,
    segment_attention_wo_q,
    segment_attention_wo_q_plain,
    rope_k_f32,
    window_attention,
    window_attention_dkv,
    window_attention_dq,
    window_attention_plain,
    window_attention_wo,
    window_attention_wo_plain,
    window_attention_wo_q,
    window_attention_wo_q_plain,
)

ATOL = 2e-2
CODE_SHARE_MAX = 1e-3
_NONE = {name: 0 for name in KERNELS}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _qkv(b, length, heads, gen, device):
    qkv = torch.randn(b, length, 3, heads, 64, generator=gen, device=device).to(torch.bfloat16)
    return qkv.unbind(2)  # strided views, as the model passes them


def _packed_segments(b, length, device):
    seg = torch.zeros(b, length, dtype=torch.int32, device=device)
    seg[0, :700], seg[0, 700:1900], seg[0, 1900:length - 150] = 1, 2, 3
    seg[-1, : length // 3] = 1
    return seg


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["packed", "key_mask"])
@pytest.mark.parametrize("window", [64, None])
def test_attention_kernels_match_plain(cuda, kind, window):
    gen = torch.Generator(device=cuda).manual_seed(0)
    length = 2048 if kind == "packed" else 1500  # 1500: the audio shape, not a multiple of 64
    q, k, v = _qkv(2, length, 8, gen, cuda)
    if kind == "packed":
        qseg = kseg = _packed_segments(2, length, cuda)
    else:
        qseg = torch.ones(2, length, dtype=torch.int32, device=cuda)
        kseg = torch.ones_like(qseg)
        kseg[1, 1100:] = 0
    theta = 10000.0 if window else 160000.0
    if window is None:
        got = segment_attention(q, k, v, qseg, kseg, theta)
        want = segment_attention_plain(q, k, v, qseg, kseg, theta)
    else:
        got = window_attention(q, k, v, qseg, kseg, window, theta)
        want = window_attention_plain(q, k, v, qseg, kseg, window, theta)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    dead = qseg == 0
    if dead.any():
        assert got[dead].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("lq, lk", [(1088, 2048), (1500, 1500), (2048, 1000)])
def test_rect_segment_kernel_matches_plain(cuda, lq, lk):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(2, lq, 8, 64, generator=gen, device=cuda).to(torch.bfloat16)
    kv = torch.randn(2, lk, 2, 8, 64, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = kv.unbind(2)  # strided views
    qseg = torch.ones(2, lq, dtype=torch.int32, device=cuda)
    kseg = torch.ones(2, lk, dtype=torch.int32, device=cuda)
    kseg[0, lk - 300:] = 0
    kseg[1, 128:448] = 0  # a fully masked range of key tiles
    qseg[1, -5:] = 0  # queries that see no key
    reset_launch_counts()
    got = segment_attention_rect(q, k, v, qseg, kseg)
    want = segment_attention_rect_plain(q, k, v, qseg, kseg)
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, "segment_attention_rect": 1}
    assert got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert got[qseg == 0].abs().max().item() == 0.0


@pytest.mark.gpu
def test_rect_form_equals_the_square_form_on_square_shapes(cuda):
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = _qkv(2, 2048, 8, gen, cuda)
    seg = _packed_segments(2, 2048, cuda)
    square = segment_attention(q, k, v, seg, seg)
    assert torch.equal(segment_attention_rect(q, k, v, seg, seg), square)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("d, f", [(768, 1152), (512, 1024), (256, 512)])
def test_fused_ffn_kernel_matches_plain(cuda, d, f):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(1000 + 7, d, generator=gen, device=cuda).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=cuda)
    wi = (0.02 * torch.randn(2 * f, d, generator=gen, device=cuda)).to(torch.bfloat16)
    wo = (0.02 * torch.randn(d, f, generator=gen, device=cuda)).to(torch.bfloat16)
    got = fused_ln_ffn(x, scale, None, wi, wo, 1e-5)
    want = fused_ln_ffn_plain(x, scale, None, wi, wo, 1e-5)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATOL


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = _qkv(1, 128, 2, gen, cuda)
    seg = torch.ones(1, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):  # fp32 has its own kernel since the fp32 forms
        window_attention(q.half(), k.half(), v.half(), seg, seg, 64)
    with pytest.raises(ValueError, match="head dim"):
        segment_attention(q[..., :32], k[..., :32], v[..., :32], seg, seg)
    with pytest.raises(ValueError, match="int32"):
        segment_attention(q, k, v, seg.long(), seg)
    k2, v2 = _qkv(1, 192, 2, gen, cuda)[1:]
    with pytest.raises(ValueError, match="one \\(B, L, H, D\\) shape"):
        segment_attention(q, k2, v2, seg, torch.ones(1, 192, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="Lk"):
        segment_attention_rect(q, k2, v2, seg, seg)
    x = torch.zeros(4, 384, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(128, 384, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="D in"):
        fused_ln_ffn(x, torch.ones(384, device=cuda), None, w, w.t().contiguous(), 1e-5)


@pytest.mark.gpu
def test_launch_counts_count_kernel_launches(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = _qkv(1, 256, 2, gen, cuda)
    seg = torch.ones(1, 256, dtype=torch.int32, device=cuda)
    reset_launch_counts()
    window_attention(q, k, v, seg, seg, 64)
    segment_attention(q, k, v, seg, seg)
    segment_attention_plain(q, k, v, seg, seg)
    assert launch_counts() == {**_NONE, "window_attention": 1, "segment_attention": 1}


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    gen = torch.Generator().manual_seed(4)
    q, k, v = _qkv(1, 100, 2, gen, "cpu")
    seg = torch.ones(1, 100, dtype=torch.int32)
    reset_launch_counts()
    assert torch.equal(window_attention(q, k, v, seg, seg, 16), window_attention_plain(q, k, v, seg, seg, 16))
    assert torch.equal(segment_attention(q, k, v, seg, seg), segment_attention_plain(q, k, v, seg, seg))
    assert launch_counts() == _NONE


def _metadata_segments(rows, g, length, device):
    """meta_pack rows: g sequences of ``length`` per row, ragged key masks."""
    gen = torch.Generator().manual_seed(5)
    seg = torch.arange(1, g + 1, dtype=torch.int32).repeat_interleave(length).repeat(rows, 1)
    keep = torch.arange(length)[None, None, :] < torch.randint(5, length + 1, (rows, g, 1), generator=gen)
    return torch.where(keep.reshape(rows, g * length), seg, torch.zeros_like(seg)).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["packed", "metadata"])
@pytest.mark.parametrize("window", [64, 192, None])
def test_lse_and_backward_kernels_match_plain(cuda, kind, window):
    gen = torch.Generator(device=cuda).manual_seed(6)
    if kind == "packed":
        seg = _packed_segments(2, 2048, cuda)
    else:
        seg = _metadata_segments(3, 16, 32, cuda)
    b, length = seg.shape
    q, k, v = _qkv(b, length, 4, gen, cuda)
    dout = torch.randn(b, length, 4, 64, generator=gen, device=cuda).to(torch.bfloat16)
    if window is None:
        out, lse = segment_attention(q, k, v, seg, seg, return_lse=True)
        want_out, want_lse = segment_attention_plain(q, k, v, seg, seg, return_lse=True)
    else:
        out, lse = window_attention(q, k, v, seg, seg, window, return_lse=True)
        want_out, want_lse = window_attention_plain(q, k, v, seg, seg, window, return_lse=True)
    live = (seg > 0)[:, None, :].expand_as(lse)
    assert (out.float() - want_out.float()).abs().max().item() <= ATOL
    assert (lse - want_lse)[live].abs().max().item() <= 1e-3
    delta = attention_delta(want_out, dout)
    if window is None:
        dq = segment_attention_dq(q, k, v, dout, want_lse, delta, seg, seg)
        dk, dv = segment_attention_dkv(q, k, v, dout, want_lse, delta, seg, seg)
    else:
        dq = window_attention_dq(q, k, v, dout, want_lse, delta, seg, seg, window)
        dk, dv = window_attention_dkv(q, k, v, dout, want_lse, delta, seg, seg, window)
    want = _attention_bwd_plain(q, k, v, dout, want_lse, delta, seg, seg, window)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    dead = seg == 0
    assert dq[dead].abs().max().item() == 0.0
    assert dk[dead].abs().max().item() == 0.0 and dv[dead].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [1, 3], ids=["1-head", "3-heads"])
@pytest.mark.parametrize("kind, window", [("packed", 64), ("packed", None), ("metadata", None)],
                         ids=["window", "segment", "metadata"])
def test_lse_and_backward_kernels_match_plain_at_a_tensor_parallel_ranks_head_count(cuda, heads, kind, window):
    """The head counts of a rank at ``model_axis=4`` (3 beatmap heads, 1 metadata head; rope outside the
    kernels, so the forward without rope and the backward kernels' plain forms), at the packed rows'
    length (4096) and at meta_pack rows."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    if kind == "packed":
        seg = _packed_segments(2, 4096, cuda)
    else:
        seg = _metadata_segments(4, 16, 128, cuda)
    b, length = seg.shape
    q, k, v = _qkv(b, length, heads, gen, cuda)
    dout = torch.randn(b, length, heads, 64, generator=gen, device=cuda).to(torch.bfloat16)
    if window is None:
        out, lse = segment_attention(q, k, v, seg, seg, return_lse=True)
        want_out, want_lse = segment_attention_plain(q, k, v, seg, seg, return_lse=True)
    else:
        out, lse = window_attention(q, k, v, seg, seg, window, return_lse=True)
        want_out, want_lse = window_attention_plain(q, k, v, seg, seg, window, return_lse=True)
    live = (seg > 0)[:, None, :].expand_as(lse)
    assert (out.float() - want_out.float()).abs().max().item() <= ATOL
    assert (lse - want_lse)[live].abs().max().item() <= 1e-3
    delta = attention_delta(want_out, dout)
    if window is None:
        dq = segment_attention_dq(q, k, v, dout, want_lse, delta, seg, seg)
        dk, dv = segment_attention_dkv(q, k, v, dout, want_lse, delta, seg, seg)
    else:
        dq = window_attention_dq(q, k, v, dout, want_lse, delta, seg, seg, window)
        dk, dv = window_attention_dkv(q, k, v, dout, want_lse, delta, seg, seg, window)
    want = _attention_bwd_plain(q, k, v, dout, want_lse, delta, seg, seg, window)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    dead = seg == 0
    assert dq[dead].abs().max().item() == 0.0
    assert dk[dead].abs().max().item() == 0.0 and dv[dead].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("window", [64, 192, None], ids=["window", "wide_window", "segment"])
def test_rope_forms_of_the_backward_kernels_match_the_plain_rope_backward(cuda, window):
    gen = torch.Generator(device=cuda).manual_seed(10)
    seg = _packed_segments(2, 2048, cuda)
    q, k, v = _qkv(2, 2048, 4, gen, cuda)
    dout = torch.randn(2, 2048, 4, 64, generator=gen, device=cuda).to(torch.bfloat16)
    theta = 10000.0 if window else 160000.0
    wargs = (window,) if window else ()
    fwd, fwd_plain = (window_attention, window_attention_plain) if window else (segment_attention,
                                                                              segment_attention_plain)
    out, lse = fwd(q, k, v, seg, seg, *wargs, theta, return_lse=True)
    want_out, want_lse = fwd_plain(q, k, v, seg, seg, *wargs, theta, return_lse=True)
    live = (seg > 0)[:, None, :].expand_as(lse)
    assert (out.float() - want_out.float()).abs().max().item() <= ATOL
    assert (lse - want_lse)[live].abs().max().item() <= 1e-3
    delta = attention_delta(want_out, dout)
    args = (q, k, v, dout, want_lse, delta, seg, seg, *wargs)
    reset_launch_counts()
    if window is None:
        dq = segment_attention_dq(*args, rope_theta=theta)
        dk, dv = segment_attention_dkv(*args, rope_theta=theta)
    else:
        dq = window_attention_dq(*args, rope_theta=theta)
        dk, dv = window_attention_dkv(*args, rope_theta=theta)
    pre = "window_attention" if window else "segment_attention"
    assert launch_counts() == {**_NONE, f"{pre}_dq_rope": 1, f"{pre}_dkv_rope": 1}
    want = attention_bwd_rope_plain(q, k, v, dout, want_lse, delta, seg, seg, window, theta)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    dead = seg == 0
    assert dq[dead].abs().max().item() == 0.0
    assert dk[dead].abs().max().item() == 0.0 and dv[dead].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("window", [64, None], ids=["window", "segment"])
def test_one_rope_pass_feeds_both_backward_kernels(cuda, window, monkeypatch):
    """attention_bwd with rope runs the rope pass once per call and hands its output to the dq and the dkv
    kernel; the gradients equal bit for bit those of the two kernels called alone, each with its own pass."""
    attention_mod = importlib.import_module("cm3p_torch.ops.attention")
    gen = torch.Generator(device=cuda).manual_seed(12)
    seg = _packed_segments(2, 1000, cuda)
    q, k, v = _qkv(2, 1000, 4, gen, cuda)
    dout = torch.randn(2, 1000, 4, 64, generator=gen, device=cuda).to(torch.bfloat16)
    theta = 10000.0 if window else 160000.0
    wargs = (window,) if window else ()
    fwd = window_attention if window else segment_attention
    out, lse = fwd(q, k, v, seg, seg, *wargs, theta, return_lse=True)
    passes = []
    orig = attention_mod.backward_rope_pass
    monkeypatch.setattr(attention_mod, "backward_rope_pass", lambda *a: passes.append(1) or orig(*a))
    reset_launch_counts()
    got = attention_mod.attention_bwd(q, k, v, out, dout, lse, seg, seg, window, rope_theta=theta)
    pre = "window_attention" if window else "segment_attention"
    assert len(passes) == 1 and launch_counts() == {**_NONE, f"{pre}_dq_rope": 1, f"{pre}_dkv_rope": 1}
    args = (q, k, v, dout.contiguous(), lse, attention_delta(out, dout), seg, seg, *wargs)
    if window:
        alone = (window_attention_dq(*args, rope_theta=theta), *window_attention_dkv(*args, rope_theta=theta))
    else:
        alone = (segment_attention_dq(*args, rope_theta=theta), *segment_attention_dkv(*args, rope_theta=theta))
    torch.cuda.synchronize()
    assert len(passes) == 3
    assert all(torch.equal(a, b) for a, b in zip(got, alone))


def test_rope_forms_on_cpu_take_the_plain_rope_backward_and_launch_nothing():
    gen = torch.Generator().manual_seed(11)
    q, k, v = _qkv(1, 100, 2, gen, "cpu")
    seg = torch.ones(1, 100, dtype=torch.int32)
    dout = torch.randn(1, 100, 2, 64, generator=gen).to(torch.bfloat16)
    out, lse = window_attention(q, k, v, seg, seg, 16, 10000.0, return_lse=True)
    delta = attention_delta(out, dout)
    reset_launch_counts()
    want = attention_bwd_rope_plain(q, k, v, dout, lse, delta, seg, seg, 16, 10000.0)
    assert torch.equal(window_attention_dq(q, k, v, dout, lse, delta, seg, seg, 16, rope_theta=10000.0), want[0])
    dk, dv = segment_attention_dkv(q, k, v, dout, lse, delta, seg, seg, rope_theta=10000.0)
    want_seg = attention_bwd_rope_plain(q, k, v, dout, lse, delta, seg, seg, None, 10000.0)
    assert torch.equal(dk, want_seg[1]) and torch.equal(dv, want_seg[2])
    assert launch_counts() == _NONE


@pytest.mark.gpu
def test_backward_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = _qkv(1, 128, 2, gen, cuda)
    seg = torch.ones(1, 128, dtype=torch.int32, device=cuda)
    dout = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(1, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="dout"):
        window_attention_dq(q, k, v, dout.float(), lse, lse, seg, seg, 64)
    with pytest.raises(ValueError, match="lse"):
        segment_attention_dkv(q, k, v, dout, lse[:, :1], lse, seg, seg)
    with pytest.raises(ValueError, match="window"):
        window_attention_dkv(q, k, v, dout, lse, lse, seg, seg, -1)


def test_backward_wrappers_on_cpu_take_the_plain_version_and_launch_nothing():
    gen = torch.Generator().manual_seed(8)
    q, k, v = _qkv(1, 100, 2, gen, "cpu")
    seg = torch.ones(1, 100, dtype=torch.int32)
    dout = torch.randn(1, 100, 2, 64, generator=gen).to(torch.bfloat16)
    out, lse = window_attention(q, k, v, seg, seg, 16, return_lse=True)
    delta = attention_delta(out, dout)
    reset_launch_counts()
    want = _attention_bwd_plain(q, k, v, dout, lse, delta, seg, seg, 16)
    assert torch.equal(window_attention_dq(q, k, v, dout, lse, delta, seg, seg, 16), want[0])
    dk, dv = window_attention_dkv(q, k, v, dout, lse, delta, seg, seg, 16)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    assert launch_counts() == _NONE


ROWS = 4037  # not a multiple of the 64- and 32-row tiles
ZERO_ROWS = slice(1000, 1100)


def _rows_and_weight(d, n_out, gen, device):
    x = (0.5 * torch.randn(ROWS, d, generator=gen, device=device)).to(torch.bfloat16)
    x[ZERO_ROWS] = 0
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=device)
    w = (0.02 * torch.randn(n_out, d, generator=gen, device=device)).to(torch.bfloat16)
    return x, scale, w


def _assert_codes_agree(got, want):
    diff = (got.short() - want.short()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= CODE_SHARE_MAX


def _lnmm_rows(rows):
    """Row counts of the LN-matmul kernels' persistent paths: "odd" gives an odd number of 128-row tiles
    (the last cluster's second tile has no row) with R not a multiple of 128; "waves" several tiles for
    every cluster of the persistent grid and a ragged third for some (resolved on the card)."""
    return 4 * 128 + 77 if rows == "odd" else _edge_rows(rows, 2 * 128, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("d, n_out, with_ln, with_bias", [
    (768, 2304, True, False), (512, 1536, True, False), (768, 768, False, False), (512, 512, False, False),
    (768, 2304, True, True), (256, 768, True, True), (256, 256, False, False),
])
@pytest.mark.parametrize("rows", [ROWS, "odd", "waves"])
def test_fused_ln_matmul_kernels_match_plain(cuda, rows, d, n_out, with_ln, with_bias):
    """Both forms, bf16 and W8A8, against their plain versions, with zero rows in the first and the last
    row tile; the W8A8 form's activation codes against the plain quantiser's, code by code."""
    rows = _lnmm_rows(rows)
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = (0.5 * torch.randn(rows, d, generator=gen, device=cuda)).to(torch.bfloat16)
    zero = torch.cat([torch.arange(5, 20), torch.arange(rows - 10, rows - 3)]).to(cuda)
    x[zero] = 0
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=cuda)
    w = (0.02 * torch.randn(n_out, d, generator=gen, device=cuda)).to(torch.bfloat16)
    res = None if with_ln else (0.5 * torch.randn(rows, n_out, generator=gen, device=cuda)).to(torch.bfloat16)
    bias = 0.1 * torch.randn(d, generator=gen, device=cuda) if with_bias else None
    kw = dict(scale=scale if with_ln else None, bias=bias, residual=res)
    w_q = quantize_weight_int8(w)
    codes = torch.full_like(x, -128, dtype=torch.int8)  # a value the quantiser never gives
    reset_launch_counts()
    got = fused_ln_matmul(x, w, **kw)
    got_q = fused_ln_matmul_q(x, w, w_q=w_q, codes_out=codes, **kw)
    torch.cuda.synchronize()
    form = "" if with_ln else "_wo"  # launches are counted by form: with LN, or the out-projection form
    assert launch_counts() == {**_NONE, "fused_ln_matmul" + form: 1, "fused_ln_matmul_q" + form: 1}
    assert (got.float() - fused_ln_matmul_plain(x, w, **kw).float()).abs().max().item() <= ATOL
    assert (got_q.float() - fused_ln_matmul_q_plain(x, w, w_q=w_q, **kw).float()).abs().max().item() <= ATOL
    assert torch.isfinite(got).all() and torch.isfinite(got_q).all()
    if not with_bias:  # a zero row gives a zero product: the residual, or 0
        want_zero = 0 if res is None else res[zero].float()
        assert (got[zero].float() - want_zero).abs().max().item() == 0.0
        assert (got_q[zero].float() - want_zero).abs().max().item() == 0.0
    y = layer_norm_f32(x, scale, bias, 1e-5) if with_ln else x.float()
    _assert_codes_agree(codes, quant_rows_int8(y)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("w8a8, w8a8_wo", [(True, False), (True, True), (False, True)])
@pytest.mark.parametrize("d, f", [(768, 1152), (512, 1024), (256, 512)])
def test_fused_ffn_int8_forms_match_plain(cuda, d, f, w8a8, w8a8_wo):
    gen = torch.Generator(device=cuda).manual_seed(10)
    x, scale, wi = _rows_and_weight(d, 2 * f, gen, cuda)
    wo = (0.02 * torch.randn(d, f, generator=gen, device=cuda)).to(torch.bfloat16)
    kw = dict(w8a8=w8a8, w8a8_wo=w8a8_wo, wi_q=quantize_weight_int8(wi) if w8a8 else None,
              wo_q=quantize_weight_int8(wo) if w8a8_wo else None)
    codes_y = torch.empty(ROWS, d, dtype=torch.int8, device=cuda) if w8a8 else None
    reset_launch_counts()
    got = fused_ln_ffn_q(x, scale, None, wi, wo, 1e-5, **kw, codes_y=codes_y)
    again = fused_ln_ffn(x, scale, None, wi, wo, 1e-5, **kw)  # the public wrapper routes to the same kernel
    want = fused_ln_ffn_plain(x, scale, None, wi, wo, 1e-5, **kw)
    torch.cuda.synchronize()
    name = "fused_ln_ffn_q" if not w8a8_wo else "fused_ln_ffn_q_wo" if w8a8 else "fused_ln_ffn_wo"
    assert launch_counts() == {**_NONE, name: 2}
    assert torch.equal(got, again)
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert torch.isfinite(got).all()
    assert torch.equal(got[ZERO_ROWS], x[ZERO_ROWS])
    if w8a8:
        _assert_codes_agree(codes_y, quant_rows_int8(layer_norm_f32(x, scale, None, 1e-5))[0])


# Row counts at the edges of the redesigned kernels' tiles (64 rows per consumer warpgroup, 128 rows
# per LN-matmul tile), "wave": one row past a work item for every cluster of the persistent grid, and
# "waves": two items for every cluster and a ragged third for some (resolved on the card).
EDGE_ROWS = [1, 63, 64, 65, 127, 129, 4037, "wave", "waves"]


def _edge_rows(rows, group_rows, items_per_group):
    """``group_rows``: the rows of a cluster's work item (its two CTAs' row tiles); ``items_per_group``:
    the items that share those rows (output column tiles that the kernel gives separate items)."""
    if rows not in ("wave", "waves"):
        return rows
    clusters = -(-torch.cuda.get_device_properties(0).multi_processor_count // 2)  # at most one CTA an SM
    groups = -(-clusters // items_per_group)  # groups that give every cluster one item
    return groups * group_rows + 1 if rows == "wave" else 2 * groups * group_rows + group_rows // 2 + 1


def _edge_inputs(rows, d, gen, device):
    """x with a block of zero rows in the middle (from 3 rows up), LN scale and bias."""
    x = (0.5 * torch.randn(rows, d, generator=gen, device=device)).to(torch.bfloat16)
    zero = slice(rows // 2, rows // 2 + max(1, rows // 10)) if rows >= 3 else slice(0, 0)
    x[zero] = 0
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=device)
    bias = 0.1 * torch.randn(d, generator=gen, device=device)
    return x, scale, bias, zero


@pytest.mark.gpu
@pytest.mark.parametrize("rows", EDGE_ROWS)
@pytest.mark.parametrize("d", [768, 512, 256])
@pytest.mark.parametrize("form", ["ln", "ln_bias", "wo_residual"])
def test_ln_matmul_bf16_kernel_at_tile_edges(cuda, rows, d, form):
    """The wgmma form of cm3p_ln_matmul (rows 5 and 5r) against its plain version."""
    n_out = 3 * d if form != "wo_residual" else d
    rows = _edge_rows(rows, 2 * 128, 1)  # a cluster walks every column tile of its two 128-row tiles
    gen = torch.Generator(device=cuda).manual_seed(12)
    x, scale, bias, zero = _edge_inputs(rows, d, gen, cuda)
    w = (0.02 * torch.randn(n_out, d, generator=gen, device=cuda)).to(torch.bfloat16)
    res = (0.5 * torch.randn(rows, n_out, generator=gen, device=cuda)).to(torch.bfloat16) if form == "wo_residual" else None
    kw = dict(scale=None if form == "wo_residual" else scale, bias=bias if form == "ln_bias" else None, residual=res)
    got = fused_ln_matmul(x, w, **kw)
    want = fused_ln_matmul_plain(x, w, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    if form != "ln_bias":  # a zero row gives a zero product: the residual, or 0
        assert torch.equal(got[zero], torch.zeros_like(got[zero]) if res is None else res[zero])


@pytest.mark.gpu
@pytest.mark.parametrize("n_out", [128, 384, 640])
def test_ln_matmul_bf16_kernel_with_a_half_column_tile(cuda, n_out):
    """N a multiple of 128 but not of the 256-column tile: the last tile is half full."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x, scale, bias, _ = _edge_inputs(300, 256, gen, cuda)
    w = (0.02 * torch.randn(n_out, 256, generator=gen, device=cuda)).to(torch.bfloat16)
    got = fused_ln_matmul(x, w, scale=scale, bias=bias)
    torch.cuda.synchronize()
    assert (got.float() - fused_ln_matmul_plain(x, w, scale=scale, bias=bias).float()).abs().max().item() <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("rows", EDGE_ROWS)
@pytest.mark.parametrize("d", [768, 512, 256])
@pytest.mark.parametrize("form", ["ln", "ln_bias", "wo_residual"])
def test_ln_matmul_q_kernel_at_tile_edges(cuda, rows, d, form):
    """The wgmma form of cm3p_ln_matmul_q (rows 6 and 6r) against its plain version, and its activation
    codes against the plain quantiser's."""
    n_out = 3 * d if form != "wo_residual" else d
    rows = _edge_rows(rows, 2 * 128, 1)  # a cluster walks every column tile of its two 128-row tiles
    gen = torch.Generator(device=cuda).manual_seed(15)
    x, scale, bias, zero = _edge_inputs(rows, d, gen, cuda)
    w = (0.02 * torch.randn(n_out, d, generator=gen, device=cuda)).to(torch.bfloat16)
    w_q = quantize_weight_int8(w)
    res = (0.5 * torch.randn(rows, n_out, generator=gen, device=cuda)).to(torch.bfloat16) if form == "wo_residual" else None
    kw = dict(scale=None if form == "wo_residual" else scale, bias=bias if form == "ln_bias" else None, residual=res)
    codes = torch.full((rows, d), -128, dtype=torch.int8, device=cuda)  # a value the quantiser never gives
    got = fused_ln_matmul_q(x, w, w_q=w_q, codes_out=codes, **kw)
    want = fused_ln_matmul_q_plain(x, w, w_q=w_q, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    if form != "ln_bias":  # a zero row gives a zero product: the residual, or 0
        assert torch.equal(got[zero], torch.zeros_like(got[zero]) if res is None else res[zero])
    y = x.float() if form == "wo_residual" else layer_norm_f32(x, scale, kw["bias"], 1e-5)
    _assert_codes_agree(codes, quant_rows_int8(y)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("n_out", [128, 384, 640])
def test_ln_matmul_q_kernel_with_a_half_column_tile(cuda, n_out):
    """N a multiple of 128 but not of the 256-column tile: the last W slice is half zeros."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    x, scale, bias, _ = _edge_inputs(300, 256, gen, cuda)
    w = (0.02 * torch.randn(n_out, 256, generator=gen, device=cuda)).to(torch.bfloat16)
    w_q = quantize_weight_int8(w)
    got = fused_ln_matmul_q(x, w, scale=scale, bias=bias, w_q=w_q)
    torch.cuda.synchronize()
    want = fused_ln_matmul_q_plain(x, w, scale=scale, bias=bias, w_q=w_q)
    assert (got.float() - want.float()).abs().max().item() <= ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("rows", EDGE_ROWS)
@pytest.mark.parametrize("d, f", [(768, 64), (768, 1152), (512, 64), (512, 1024), (256, 64), (256, 512)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_ffn_w8a8_kernel_at_tile_edges(cuda, rows, d, f, with_bias):
    """The wgmma w8a8 form of cm3p_fused_ln_ffn_q (row 3q) against its plain version: one F chunk
    (F = 64) and many, every width, ragged rows, and its LN codes against the plain quantiser's.
    Weights of std 1/sqrt(D) and 0.25/sqrt(F) give a and b of about unit size and an FFN output
    of 0.09-0.19 rms at every (D, F), so a wrong column half or K slice shows well above ATOL; the
    sum x + o stays under 4, where a bf16 ulp is within ATOL."""
    rows = _edge_rows(rows, 2 * 64, 2 if d == 768 else 1)  # two 384-column items per rows at D 768
    gen = torch.Generator(device=cuda).manual_seed(14)
    x, scale, bias, zero = _edge_inputs(rows, d, gen, cuda)
    bias = bias if with_bias else None
    wi = (d ** -0.5 * torch.randn(2 * f, d, generator=gen, device=cuda)).to(torch.bfloat16)
    wo = (0.25 * f ** -0.5 * torch.randn(d, f, generator=gen, device=cuda)).to(torch.bfloat16)
    wi_q = quantize_weight_int8(wi)
    codes_y = torch.full((rows, d), -128, dtype=torch.int8, device=cuda)  # a value the quantiser never gives
    got = fused_ln_ffn_q(x, scale, bias, wi, wo, 1e-5, w8a8=True, wi_q=wi_q, codes_y=codes_y)
    want = fused_ln_ffn_plain(x, scale, bias, wi, wo, 1e-5, w8a8=True, wi_q=wi_q)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (want.float() - x.float()).pow(2).mean().sqrt().item() > 2 * ATOL  # the FFN's own part, rms
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    if not with_bias:
        assert torch.equal(got[zero], x[zero])
    _assert_codes_agree(codes_y, quant_rows_int8(layer_norm_f32(x, scale, bias, 1e-5))[0])


@pytest.mark.gpu
@pytest.mark.parametrize("rows", EDGE_ROWS)
@pytest.mark.parametrize("d, f", [(768, 64), (768, 1152), (512, 64), (512, 1024), (256, 64), (256, 512)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_ffn_bf16_kernel_at_tile_edges(cuda, rows, d, f, with_bias):
    """The wgmma bf16 form of cm3p_fused_ln_ffn (row 3) against its plain version: one F chunk (F = 64)
    and many, every width, ragged rows. Weights as in the w8a8 test above, so the FFN's own part is
    asserted above 2 x ATOL."""
    rows = _edge_rows(rows, 2 * 64, 2 if d == 768 else 1)  # two 384-column items per rows at D 768
    gen = torch.Generator(device=cuda).manual_seed(15)
    x, scale, bias, zero = _edge_inputs(rows, d, gen, cuda)
    bias = bias if with_bias else None
    wi = (d ** -0.5 * torch.randn(2 * f, d, generator=gen, device=cuda)).to(torch.bfloat16)
    wo = (0.25 * f ** -0.5 * torch.randn(d, f, generator=gen, device=cuda)).to(torch.bfloat16)
    reset_launch_counts()
    got = fused_ln_ffn(x, scale, bias, wi, wo, 1e-5)
    want = fused_ln_ffn_plain(x, scale, bias, wi, wo, 1e-5)
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, "fused_ln_ffn": 1}
    assert torch.isfinite(got).all()
    assert (want.float() - x.float()).pow(2).mean().sqrt().item() > 2 * ATOL  # the FFN's own part, rms
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    if not with_bias:
        assert torch.equal(got[zero], x[zero])


@pytest.mark.gpu
@pytest.mark.parametrize("rows", EDGE_ROWS)
@pytest.mark.parametrize("d, f", [(768, 64), (768, 1152), (512, 64), (512, 1024), (256, 64), (256, 512)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_ffn_w8a8_wo_kernel_at_tile_edges(cuda, rows, d, f, with_bias):
    """The wgmma w8a8 + w8a8_wo form of cm3p_fused_ln_ffn_q (row 3qq: an int8 Wi and an int8 Wo) against
    its plain version, as the two tests above, and both activation codes it exports: its LN codes
    against the plain quantiser's, and its gelu(a) * b codes against the plain quantiser of the plain
    h on the rows whose LN codes agree (elsewhere h, and so the row's scale, may differ)."""
    rows = _edge_rows(rows, 2 * 64, 2 if d == 768 else 1)
    gen = torch.Generator(device=cuda).manual_seed(16)
    x, scale, bias, zero = _edge_inputs(rows, d, gen, cuda)
    bias = bias if with_bias else None
    wi = (d ** -0.5 * torch.randn(2 * f, d, generator=gen, device=cuda)).to(torch.bfloat16)
    wo = (0.25 * f ** -0.5 * torch.randn(d, f, generator=gen, device=cuda)).to(torch.bfloat16)
    wi_q, wo_q = quantize_weight_int8(wi), quantize_weight_int8(wo)
    kw = dict(w8a8=True, w8a8_wo=True, wi_q=wi_q, wo_q=wo_q)
    codes_y = torch.full((rows, d), -128, dtype=torch.int8, device=cuda)  # a value the quantiser never gives
    codes_g = torch.full((rows, f), -128, dtype=torch.int8, device=cuda)
    reset_launch_counts()
    got = fused_ln_ffn_q(x, scale, bias, wi, wo, 1e-5, **kw, codes_y=codes_y, codes_g=codes_g)
    want = fused_ln_ffn_plain(x, scale, bias, wi, wo, 1e-5, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, "fused_ln_ffn_q_wo": 1}
    assert torch.isfinite(got).all()
    assert (want.float() - x.float()).pow(2).mean().sqrt().item() > 2 * ATOL  # the FFN's own part, rms
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    if not with_bias:
        assert torch.equal(got[zero], x[zero])
    qy, sa = quant_rows_int8(layer_norm_f32(x, scale, bias, 1e-5))
    _assert_codes_agree(codes_y, qy)
    h = (int8_matmul(qy, wi_q[0]) * sa * wi_q[1]).to(torch.bfloat16)
    gf = torch.nn.functional.gelu(h[:, :f].float()) * h[:, f:].float()
    rows_ok = (codes_y == qy).all(dim=1)
    _assert_codes_agree(codes_g[rows_ok], quant_rows_int8(gf)[0][rows_ok])


_SHARED_CARD_RUN = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from cm3p_torch.ops import fused_ln_ffn, fused_ln_ffn_plain, quantize_weight_int8
g = torch.Generator(device="cuda").manual_seed(int(sys.argv[2]))
x = (0.5 * torch.randn(16384, 768, generator=g, device="cuda")).to(torch.bfloat16)
scale = 1 + 0.1 * torch.randn(768, generator=g, device="cuda")
wi = (0.02 * torch.randn(2304, 768, generator=g, device="cuda")).to(torch.bfloat16)
wo = (0.02 * torch.randn(768, 1152, generator=g, device="cuda")).to(torch.bfloat16)
w8a8, w8a8_wo = {"w8a8": (True, False), "bf16": (False, False), "w8a8_wo": (True, True),
                 "w8a8_wo_alone": (False, True)}[sys.argv[3]]
kw = dict(w8a8=w8a8, w8a8_wo=w8a8_wo, wi_q=quantize_weight_int8(wi) if w8a8 else None,
          wo_q=quantize_weight_int8(wo) if w8a8_wo else None)
want = fused_ln_ffn_plain(x, scale, None, wi, wo, 1e-5, **kw)
for _ in range(30):
    got = fused_ln_ffn(x, scale, None, wi, wo, 1e-5, **kw)
torch.cuda.synchronize()
assert (got.float() - want.float()).abs().max().item() <= 2e-2
"""


def _run_on_a_shared_card(form):
    """Three processes launch the FFN kernel's ``form`` 30 times each at once; (exit code, output) of each."""
    import subprocess
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parent.parent)
    procs = [subprocess.Popen([sys.executable, "-c", _SHARED_CARD_RUN, repo, str(k), form], cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for k in range(3)]
    outs = []
    for proc in procs:
        try:
            outs.append((proc.wait(timeout=180), proc.stdout.read()))
        except subprocess.TimeoutExpired:
            proc.kill()
            outs.append((None, "timed out"))
    return outs


@pytest.mark.gpu
def test_ffn_w8a8_kernel_on_a_card_shared_by_three_processes(cuda):
    """Processes that share the card are time-sliced; the kernel's rings must not lose their order then
    (sequence parallelism runs two ranks beside the main process)."""
    outs = _run_on_a_shared_card("w8a8")
    assert all(rc == 0 for rc, _ in outs), outs


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["bf16", "w8a8_wo", "w8a8_wo_alone"])
def test_ffn_kernels_on_a_card_shared_by_three_processes(cuda, form):
    """The same for the bf16 form (row 3), the w8a8 + w8a8_wo form (row 3qq) and the w8a8_wo form alone (row
    3o), which share that design and add their own rings' order (one Wo slot in bf16, two passes over F with
    an int8 Wo)."""
    outs = _run_on_a_shared_card(form)
    assert all(rc == 0 for rc, _ in outs), outs


@pytest.mark.gpu
def test_quant_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(8, 768, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(768, 768, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16 or float32"):  # fp32 has its own kernel since the fp32 forms
        fused_ln_matmul(x.half(), w.half())
    with pytest.raises(ValueError, match="multiple of"):
        fused_ln_matmul(x, w[:100].contiguous())
    with pytest.raises(ValueError, match="D in"):
        fused_ln_matmul_q(x[:, :384].contiguous(), w[:, :384].contiguous())
    with pytest.raises(ValueError, match="residual"):
        fused_ln_matmul(x, w, residual=x[:4])
    with pytest.raises(ValueError, match="w8a8"):
        fused_ln_ffn_q(x, torch.ones(768, device=cuda), None, w, w, 1e-5, w8a8=False, w8a8_wo=False)
    wide = torch.zeros(768, 1216, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="F <= 1152"):
        fused_ln_ffn_q(x, torch.ones(768, device=cuda), None, torch.zeros(2432, 768, dtype=torch.bfloat16, device=cuda),
                       wide, 1e-5, w8a8=True, w8a8_wo=True)


def test_quant_wrappers_on_cpu_take_the_plain_version_and_launch_nothing():
    gen = torch.Generator().manual_seed(11)
    x, scale, w = _rows_and_weight(128, 256, gen, "cpu")
    wo = (0.02 * torch.randn(128, 128, generator=gen)).to(torch.bfloat16)
    reset_launch_counts()
    assert torch.equal(fused_ln_matmul(x, w, scale=scale), fused_ln_matmul_plain(x, w, scale=scale))
    assert torch.equal(fused_ln_matmul_q(x, w, scale=scale), fused_ln_matmul_q_plain(x, w, scale=scale))
    assert torch.equal(
        fused_ln_ffn(x, scale, None, w, wo, 1e-5, w8a8=True, w8a8_wo=True),
        fused_ln_ffn_plain(x, scale, None, w, wo, 1e-5, w8a8=True, w8a8_wo=True),
    )
    assert launch_counts() == _NONE


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [12, 8, 4])
@pytest.mark.parametrize("window", [64, None])
def test_attention_wo_kernels_match_plain(cuda, window, heads):
    """The four epilogue forms at 2 x 1000 tokens (not a multiple of 64), packed
    segments with padding rows, H * D 768 / 512 / 256."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    b, length, hd = 2, 1000, heads * 64
    q, k, v = _qkv(b, length, heads, gen, cuda)
    seg = torch.zeros(b, length, dtype=torch.int32, device=cuda)
    seg[0, :300], seg[0, 300:820], seg[1, :450] = 1, 2, 1
    res = (0.5 * torch.randn(b, length, hd, generator=gen, device=cuda)).to(torch.bfloat16)
    wo = (0.02 * torch.randn(hd, hd, generator=gen, device=cuda)).to(torch.bfloat16)
    w_q = quantize_weight_int8(wo)
    theta = 10000.0 if window else 160000.0
    o_out = torch.empty(b, length, hd, dtype=torch.bfloat16, device=cuda)
    codes = torch.empty(b, length, hd, dtype=torch.int8, device=cuda)
    reset_launch_counts()
    if window:
        got = window_attention_wo(q, k, v, seg, seg, window, wo, res, theta)
        got_q = window_attention_wo_q(q, k, v, seg, seg, window, w_q, res, theta, o_out=o_out, codes_out=codes)
        want = window_attention_wo_plain(q, k, v, seg, seg, window, wo, res, theta)
        want_q = window_attention_wo_q_plain(q, k, v, seg, seg, window, w_q, res, theta)
        want_o = window_attention_plain(q, k, v, seg, seg, window, theta)
        name = "window_attention_wo"
    else:
        got = segment_attention_wo(q, k, v, seg, seg, wo, res, theta)
        got_q = segment_attention_wo_q(q, k, v, seg, seg, w_q, res, theta, o_out=o_out, codes_out=codes)
        want = segment_attention_wo_plain(q, k, v, seg, seg, wo, res, theta)
        want_q = segment_attention_wo_q_plain(q, k, v, seg, seg, w_q, res, theta)
        want_o = segment_attention_plain(q, k, v, seg, seg, theta)
        name = "segment_attention_wo"
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, name: 1, name + "_q": 1}
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert (got_q.float() - want_q.float()).abs().max().item() <= ATOL
    assert (o_out.float() - want_o.flatten(2).float()).abs().max().item() <= ATOL
    dead = seg == 0
    assert torch.equal(got[dead], res[dead]) and torch.equal(got_q[dead], res[dead])
    _assert_codes_agree(codes, quant_rows_int8(o_out.float())[0])


WO_EDGE_LENGTHS = [1, 63, 64, 65, 129, 1000, 1500]


def _wo_edge_segments(layout, device):
    """Segments at the edges of the bf16 epilogue kernel's tiles: a length (rows of one segment, of two
    segments and padding, and of padding only), one segment over a whole 4096 row (a query tile visits 64 key
    tiles), segment edges on a tile boundary and off it, and more query tiles than the card has SMs with a
    ragged last tile."""
    if isinstance(layout, int):
        seg = torch.zeros(3, layout, dtype=torch.int32, device=device)
        seg[0] = 1
        seg[1, : layout // 2], seg[1, layout // 2: 3 * layout // 4] = 1, 2
        return seg
    if layout == "one_segment_4096":
        return torch.ones(1, 4096, dtype=torch.int32, device=device)
    if layout == "tile_edges":
        seg = torch.zeros(2, 1024, dtype=torch.int32, device=device)
        seg[0, :128], seg[0, 128:200], seg[0, 200:900] = 1, 2, 3
        seg[1, :320], seg[1, 320:] = 1, 2
        return seg
    assert layout == "many_tiles"
    seg = torch.zeros(4, 4033, dtype=torch.int32, device=device)
    for row, lengths in enumerate(([1265, 900, 1500], [368, 2100, 1265], [4033], [700, 700, 700, 700])):
        start = 0
        for i, n in enumerate(lengths):
            seg[row, start:start + n] = i + 1
            start += n
    return seg


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [12, 8, 4])
@pytest.mark.parametrize("window", [0, 64, 128, None])
@pytest.mark.parametrize("layout", [*WO_EDGE_LENGTHS, "one_segment_4096", "tile_edges", "many_tiles"])
def test_attention_wo_bf16_kernel_at_edges(cuda, layout, window, heads):
    """The bf16 epilogue forms against their plain versions at ATOL, once with a residual (rows that see no
    key give it bit for bit) and once with a zero residual, where the product alone is held to 2 % of its
    largest entry; the attention output the kernel used (o_out) to 2 % of the plain attention's largest."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    seg = _wo_edge_segments(layout, cuda)
    b, length = seg.shape
    hd = heads * 64
    q, k, v = _qkv(b, length, heads, gen, cuda)
    res = (0.5 * torch.randn(b, length, hd, generator=gen, device=cuda)).to(torch.bfloat16)
    zero = torch.zeros_like(res)
    wo = (0.02 * torch.randn(hd, hd, generator=gen, device=cuda)).to(torch.bfloat16)
    o_out = torch.empty(b, length, hd, dtype=torch.bfloat16, device=cuda)
    if window is None:
        name, fn, fn_plain, attn_plain = ("segment_attention_wo", segment_attention_wo, segment_attention_wo_plain,
                                          segment_attention_plain)
        theta, wargs = 160000.0, ()
    else:
        name, fn, fn_plain, attn_plain = ("window_attention_wo", window_attention_wo, window_attention_wo_plain,
                                          window_attention_plain)
        theta, wargs = 10000.0, (window,)
    reset_launch_counts()
    got = fn(q, k, v, seg, seg, *wargs, wo, res, theta, o_out=o_out)
    got0 = fn(q, k, v, seg, seg, *wargs, wo, zero, theta)
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, name: 2}
    want = fn_plain(q, k, v, seg, seg, *wargs, wo, res, theta)
    want0 = fn_plain(q, k, v, seg, seg, *wargs, wo, zero, theta)
    want_o = attn_plain(q, k, v, seg, seg, *wargs, theta).flatten(2)
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert (got0.float() - want0.float()).abs().max().item() <= 2e-2 * want0.float().abs().max().item()
    assert (o_out.float() - want_o.float()).abs().max().item() <= 2e-2 * want_o.float().abs().max().item()
    dead = seg == 0
    assert torch.equal(got[dead], res[dead])


@pytest.mark.gpu
def test_attention_wo_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(13)
    q, k, v = _qkv(1, 128, 2, gen, cuda)
    seg = torch.ones(1, 128, dtype=torch.int32, device=cuda)
    res = torch.zeros(1, 128, 128, dtype=torch.bfloat16, device=cuda)
    wo = torch.zeros(128, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="H \\* D in"):
        window_attention_wo(q, k, v, seg, seg, 64, wo, res)
    q, k, v = _qkv(1, 128, 4, gen, cuda)
    res = torch.zeros(1, 128, 256, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="Wo must be"):
        segment_attention_wo(q, k, v, seg, seg, torch.zeros(256, 256, device=cuda), res)
    with pytest.raises(ValueError, match="residual"):
        segment_attention_wo(q, k, v, seg, seg, torch.zeros(256, 256, dtype=torch.bfloat16, device=cuda), res[:, :64])
    with pytest.raises(ValueError, match="Wo must be"):
        window_attention_wo_q(q, k, v, seg, seg, 64, quantize_weight_int8(wo), res)


EMPTY_LSE = math.log2(1e-30)
FWD_EDGE_LAYOUTS = [1, 63, 65, 1500, 4037, "single_tokens", "tile_edges", "many_tiles"]


def _fwd_edge_segments(layout, device):
    """Segments at the edges of the forward kernel: the epilogue kernel's layouts (a length with rows of one
    segment, of two segments and padding, and of padding only; segment edges on and off a tile boundary;
    more query tiles than SMs), lengths 1500 (the audio tower's) and 4037, and single-token segments beside a
    long one and a padding tail (key ranges of one tile, and empty ones)."""
    if layout == "single_tokens":
        seg = torch.zeros(2, 1000, dtype=torch.int32, device=device)
        seg[0, :300] = torch.arange(1, 301, dtype=torch.int32, device=device)
        seg[0, 300:900] = 301
        seg[1, 70:200] = torch.arange(1, 131, dtype=torch.int32, device=device)
        return seg
    return _wo_edge_segments(layout, device)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [3, 4, 8, 12])
@pytest.mark.parametrize("window", [64, 192, 256, None])
@pytest.mark.parametrize("layout", FWD_EDGE_LAYOUTS)
def test_attention_kernel_at_edges(cuda, layout, window, heads):
    """The forward kernel (q/k/v strided Wqkv views) against its plain version at ATOL, with rope and lse
    and without either: lse within 1e-3 on live rows and exactly log2(1e-30) on rows that see no key, whose
    outputs are exactly 0. Three heads: the last head pair has one head."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    seg = _fwd_edge_segments(layout, cuda)
    b, length = seg.shape
    q, k, v = _qkv(b, length, heads, gen, cuda)
    if window is None:
        name, fn, fn_plain, theta, wargs = "segment_attention", segment_attention, segment_attention_plain, 160000.0, ()
    else:
        name, fn, fn_plain, theta, wargs = "window_attention", window_attention, window_attention_plain, 10000.0, (
            window,)
    dead = seg == 0
    live = (~dead)[:, None, :].expand(b, heads, length)
    reset_launch_counts()
    for rope in (theta, None):
        out, lse = fn(q, k, v, seg, seg, *wargs, rope, return_lse=True)
        want, want_lse = fn_plain(q, k, v, seg, seg, *wargs, rope, return_lse=True)
        torch.cuda.synchronize()
        assert (out.float() - want.float()).abs().max().item() <= ATOL
        if live.any():
            assert (lse - want_lse)[live].abs().max().item() <= 1e-3
        if dead.any():
            assert out[dead].abs().max().item() == 0.0
            assert bool((lse.transpose(1, 2)[dead] == EMPTY_LSE).all())
        assert torch.equal(fn(q, k, v, seg, seg, *wargs, rope), out)  # the no-grad call: no lse, same output
    assert launch_counts() == {**_NONE, name: 4}


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [4, 12])
@pytest.mark.parametrize("lq, lk", [(1, 65), (63, 4037), (4037, 1500), (1500, 1)])
def test_rect_segment_kernel_at_edges(cuda, lq, lk, heads):
    """The rectangular form at lengths off the tiles, with a row whose keys are all masked (its queries give
    exactly 0) and a masked key tail; q, k and v apart (not views of one tensor)."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    q = torch.randn(2, lq, heads, 64, generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn(2, lk, heads, 64, generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn(2, lk, heads, 64, generator=gen, device=cuda).to(torch.bfloat16)
    qseg = torch.ones(2, lq, dtype=torch.int32, device=cuda)
    kseg = torch.ones(2, lk, dtype=torch.int32, device=cuda)
    kseg[0, lk - lk // 3:] = 0
    kseg[1] = 0
    got = segment_attention_rect(q, k, v, qseg, kseg)
    want = segment_attention_rect_plain(q, k, v, qseg, kseg)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert got[1].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [12, 8, 4])
@pytest.mark.parametrize("window", [0, 64, 128, None])
@pytest.mark.parametrize("layout", [*WO_EDGE_LENGTHS, "one_segment_4096", "tile_edges", "many_tiles"])
def test_attention_wo_int8_kernel_at_edges(cuda, layout, window, heads):
    """The int8 epilogue forms against their plain versions at ATOL with a residual (rows that see no key
    give it bit for bit), and with a zero residual the product within 2 % of its largest entry; the
    attention output the kernel used (o_out) within 2 % of the plain attention's largest entry, and its int8
    codes equal to ``quant_rows_int8`` of it but for a share of 1e-3 off by one."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    seg = _wo_edge_segments(layout, cuda)
    b, length = seg.shape
    hd = heads * 64
    q, k, v = _qkv(b, length, heads, gen, cuda)
    res = (0.5 * torch.randn(b, length, hd, generator=gen, device=cuda)).to(torch.bfloat16)
    zero = torch.zeros_like(res)
    w_q = quantize_weight_int8((0.02 * torch.randn(hd, hd, generator=gen, device=cuda)).to(torch.bfloat16))
    o_out = torch.empty(b, length, hd, dtype=torch.bfloat16, device=cuda)
    codes = torch.full((b, length, hd), 99, dtype=torch.int8, device=cuda)
    if window is None:
        name, fn, fn_plain, attn_plain = ("segment_attention_wo_q", segment_attention_wo_q,
                                          segment_attention_wo_q_plain, segment_attention_plain)
        theta, wargs = 160000.0, ()
    else:
        name, fn, fn_plain, attn_plain = ("window_attention_wo_q", window_attention_wo_q,
                                          window_attention_wo_q_plain, window_attention_plain)
        theta, wargs = 10000.0, (window,)
    reset_launch_counts()
    got = fn(q, k, v, seg, seg, *wargs, w_q, res, theta, o_out=o_out, codes_out=codes)
    got0 = fn(q, k, v, seg, seg, *wargs, w_q, zero, theta)
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, name: 2}
    want = fn_plain(q, k, v, seg, seg, *wargs, w_q, res, theta)
    want0 = fn_plain(q, k, v, seg, seg, *wargs, w_q, zero, theta)
    want_o = attn_plain(q, k, v, seg, seg, *wargs, theta).flatten(2)
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    assert (got0.float() - want0.float()).abs().max().item() <= 2e-2 * max(want0.float().abs().max().item(), 1e-6)
    assert (o_out.float() - want_o.float()).abs().max().item() <= 2e-2 * max(want_o.float().abs().max().item(), 1e-6)
    _assert_codes_agree(codes, quant_rows_int8(o_out.float())[0])
    dead = seg == 0
    assert torch.equal(got[dead], res[dead])
    if dead.any():
        assert torch.equal(got0[dead], zero[dead]) and int(codes[dead].abs().max()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["packed", "metadata", "single_tokens", "padding", "rect", "rect_swapped", "long"])
def test_key_tile_ranges_kernel_equals_the_plain_ranges(cuda, layout):
    """The ranges kernel (the segment forms' key tiles, forward, backward and epilogue) against
    ``segment_tile_ranges``, exactly: packed rows, the metadata tower's rows, single-token segments, rows of
    padding only, Lq != Lk both ways, and a 200,000-token row of 1,265-token segments (more tiles than one
    block's shared memory could hold the bounds of)."""
    if layout == "packed":
        qseg = kseg = _packed_segments(3, 4037, cuda)
    elif layout == "long":
        pos = torch.arange(200_000, dtype=torch.int32, device=cuda)
        qseg = kseg = torch.where(pos < 200_000 - 300, pos // 1265 + 1, 0)[None].contiguous()
    elif layout == "metadata":
        qseg = kseg = _metadata_segments(5, 16, 128, cuda)
    elif layout == "single_tokens":
        qseg = kseg = _fwd_edge_segments("single_tokens", cuda)
    elif layout == "padding":
        qseg = kseg = torch.zeros(2, 200, dtype=torch.int32, device=cuda)
    else:
        qseg = torch.ones(2, 1088, dtype=torch.int32, device=cuda)
        kseg = torch.ones(2, 8704, dtype=torch.int32, device=cuda)
        kseg[0, -1000:], kseg[1] = 0, 0
        if layout == "rect_swapped":
            qseg, kseg = kseg, qseg
    got, want = key_tile_ranges(qseg, kseg), segment_tile_ranges(qseg, kseg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------------------------------------ the fp32 forms (csrc/*_f32.cu)
# Each fp32 kernel against its plain version at fp32 with cuBLAS at "highest" precision (TF32 off):
# max |kernel - plain| <= F32_REL_TOL * max |plain| (the same fp32 arithmetic, summed in another order); the
# int8 forms' activation codes as the plain quantiser's but a share <= 1e-3 off by one (the LN's or the GeGLU's
# summation order moves a value across a rounding boundary), and F32_REL_TOL on the rows whose codes agree.
F32_REL_TOL = 1e-5


@pytest.fixture
def fp32_cuda(cuda):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _rel_err(got, want, rows=None):
    if rows is not None:
        got, want = got[rows], want[rows]
    return (got.float() - want.float()).abs().max().item() / max(want.float().abs().max().item(), 1e-30)


def _fp32_segments(b, length, device):
    """A segment across a 64-tile boundary, a padding tail (queries that see no key), a row of one segment."""
    seg = torch.zeros(b, length, dtype=torch.int32, device=device)
    seg[0, :90], seg[0, 90:700], seg[0, 700:length - 77] = 1, 2, 3
    seg[-1, : length // 3] = 1
    return seg


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1000, 1500, 4096])
@pytest.mark.parametrize("form", ["window", "wide_window", "segment", "key_mask"])
def test_fp32_attention_kernel_matches_plain(fp32_cuda, form, length):
    gen = torch.Generator(device=fp32_cuda).manual_seed(21)
    heads = 12 if length == 4096 else 8
    qkv = torch.randn(2, length, 3, heads, 64, generator=gen, device=fp32_cuda)
    q, k, v = qkv.unbind(2)  # strided views, as the model passes them
    if form == "key_mask":
        qseg = torch.ones(2, length, dtype=torch.int32, device=fp32_cuda)
        kseg = torch.ones_like(qseg)
        kseg[1, length - 300:] = 0
        kseg[1, 128:448] = 0
    else:
        qseg = kseg = _fp32_segments(2, length, fp32_cuda)
    window = {"window": 64, "wide_window": 192}.get(form)
    theta = 10000.0 if window else 160000.0
    reset_launch_counts()
    if window is None:
        got = segment_attention(q, k, v, qseg, kseg, theta)
        want = segment_attention_plain(q, k, v, qseg, kseg, theta)
        name = "segment_attention_f32"
    else:
        got = window_attention(q, k, v, qseg, kseg, window, theta)
        want = window_attention_plain(q, k, v, qseg, kseg, window, theta)
        name = "window_attention_f32"
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, name: 1}
    assert got.dtype == torch.float32 and _rel_err(got, want) <= F32_REL_TOL
    dead = qseg == 0
    if dead.any():
        assert got[dead].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("lq, lk", [(1088, 2048), (1500, 1500), (63, 4037)])
def test_fp32_rect_attention_kernel_matches_plain(fp32_cuda, lq, lk):
    gen = torch.Generator(device=fp32_cuda).manual_seed(22)
    q = torch.randn(2, lq, 8, 64, generator=gen, device=fp32_cuda)
    k, v = torch.randn(2, lk, 2, 8, 64, generator=gen, device=fp32_cuda).unbind(2)
    qseg = torch.ones(2, lq, dtype=torch.int32, device=fp32_cuda)
    kseg = torch.ones(2, lk, dtype=torch.int32, device=fp32_cuda)
    kseg[0, lk - 30:] = 0
    kseg[1] = 0  # no key visible: every query of the row gives exactly 0
    reset_launch_counts()
    got = segment_attention_rect(q, k, v, qseg, kseg)
    want = segment_attention_rect_plain(q, k, v, qseg, kseg)
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, "segment_attention_rect_f32": 1}
    assert _rel_err(got, want) <= F32_REL_TOL and got[1].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("window", [64, None])
@pytest.mark.parametrize("int8", [False, True])
def test_fp32_attention_wo_forms_are_the_fp32_pair(fp32_cuda, window, int8):
    """At fp32 the epilogue forms run the fp32 attention kernel and the fp32 LN-matmul residual form."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(23)
    seg = _fp32_segments(2, 1000, fp32_cuda)
    qkv = torch.randn(2, 1000, 3, 8, 64, generator=gen, device=fp32_cuda)
    q, k, v = qkv.unbind(2)
    res = torch.randn(2, 1000, 512, generator=gen, device=fp32_cuda)
    wo = 0.02 * torch.randn(512, 512, generator=gen, device=fp32_cuda)
    wargs = (window,) if window else ()
    reset_launch_counts()
    if int8:
        w_q = quantize_weight_int8(wo)
        fn, fn_plain = (window_attention_wo_q, window_attention_wo_q_plain) if window else (
            segment_attention_wo_q, segment_attention_wo_q_plain)
        got, want = fn(q, k, v, seg, seg, *wargs, w_q, res), fn_plain(q, k, v, seg, seg, *wargs, w_q, res)
    else:
        fn, fn_plain = (window_attention_wo, window_attention_wo_plain) if window else (
            segment_attention_wo, segment_attention_wo_plain)
        got, want = fn(q, k, v, seg, seg, *wargs, wo, res), fn_plain(q, k, v, seg, seg, *wargs, wo, res)
    torch.cuda.synchronize()
    attn = "window_attention_f32" if window else "segment_attention_f32"
    assert launch_counts() == {**_NONE, attn: 1, "fused_ln_matmul_q_wo_f32" if int8 else "fused_ln_matmul_wo_f32": 1}
    assert _rel_err(got, want) <= (2e-3 if int8 else F32_REL_TOL)  # int8: a code off by one on a few rows
    dead = seg == 0
    assert torch.equal(got[dead], res[dead])


# the fp32 kernel's tiles: 64 queries a block (16 a warp), 64 keys a tile
F32_EDGE_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 1000, 4096]


def _fp32_segments_across_tiles(b, length, device):
    """Segments that cross 128-position boundaries (two 64-query tiles, two key tiles), a padding tail whose queries see no key, and
    a row of one segment over all but its last position."""
    seg = torch.zeros(b, length, dtype=torch.int32, device=device)
    tail = length // 10
    seg[0, :100], seg[0, 100:300], seg[0, 300:length - tail] = 1, 2, 3
    seg[-1, : max(1, length - 1)] = 1
    return seg


@pytest.mark.gpu
@pytest.mark.parametrize("length", F32_EDGE_LENGTHS)
@pytest.mark.parametrize("form", ["window", "segment"])
def test_fp32_attention_kernel_at_tile_edges(fp32_cuda, form, length):
    """The register-tiled fp32 kernel at its tile edges, with rope, strided qkv views and H 4 / 8 / 12."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(31)
    heads = (4, 8, 12)[F32_EDGE_LENGTHS.index(length) % 3]
    q, k, v = torch.randn(2, length, 3, heads, 64, generator=gen, device=fp32_cuda).unbind(2)
    seg = _fp32_segments_across_tiles(2, length, fp32_cuda)
    reset_launch_counts()
    if form == "window":
        got = window_attention(q, k, v, seg, seg, 64, 10000.0)
        want = window_attention_plain(q, k, v, seg, seg, 64, 10000.0)
    else:
        got = segment_attention(q, k, v, seg, seg, 160000.0)
        want = segment_attention_plain(q, k, v, seg, seg, 160000.0)
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, f"{form}_attention_f32": 1}
    assert _rel_err(got, want) <= F32_REL_TOL
    dead = seg == 0
    if dead.any():
        assert got[dead].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("length", [1000, 4096])
@pytest.mark.parametrize("window", [64, 192, 256])
@pytest.mark.parametrize("rope", [False, True])
def test_fp32_window_kernel_at_every_window(fp32_cuda, window, length, rope):
    gen = torch.Generator(device=fp32_cuda).manual_seed(32)
    q, k, v = torch.randn(1, length, 3, 8, 64, generator=gen, device=fp32_cuda).unbind(2)
    seg = _fp32_segments_across_tiles(1, length, fp32_cuda)
    theta = 10000.0 if rope else None
    got = window_attention(q, k, v, seg, seg, window, theta)
    want = window_attention_plain(q, k, v, seg, seg, window, theta)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= F32_REL_TOL
    assert got[seg == 0].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("lq, lk", [(1, 64), (63, 65), (127, 129), (129, 1000), (1000, 129), (4096, 200)])
def test_fp32_rect_attention_kernel_at_tile_edges(fp32_cuda, lq, lk):
    gen = torch.Generator(device=fp32_cuda).manual_seed(33)
    q = torch.randn(2, lq, 12, 64, generator=gen, device=fp32_cuda)
    k, v = torch.randn(2, lk, 2, 12, 64, generator=gen, device=fp32_cuda).unbind(2)
    qseg = torch.ones(2, lq, dtype=torch.int32, device=fp32_cuda)
    kseg = torch.ones(2, lk, dtype=torch.int32, device=fp32_cuda)
    kseg[0, lk // 2:] = 0
    qseg[1, lq // 2:] = 0  # queries that see no key write exactly 0
    got = segment_attention_rect(q, k, v, qseg, kseg)
    want = segment_attention_rect_plain(q, k, v, qseg, kseg)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= F32_REL_TOL
    if lq > 1:
        assert got[1, lq // 2:].abs().max().item() == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["window", "segment"])
def test_fp32_rope_pass_is_bit_equal_to_the_kernels_rotation(fp32_cuda, form):
    """The segment forms' rope pass gives the plain rotation's bits, and the kernels with rope tables (Q
    rotated as it is staged, K in shared memory in the window form, K from the pass in the segment form) give
    the bits of the kernels without tables on q and k rotated by the pass."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(34)
    q, k, v = torch.randn(2, 1000, 3, 8, 64, generator=gen, device=fp32_cuda).unbind(2)
    seg = _fp32_segments_across_tiles(2, 1000, fp32_cuda)
    theta = 10000.0 if form == "window" else 160000.0
    rq, rk = rope_k_f32(q, theta), rope_k_f32(k, theta)
    assert torch.equal(rk, apply_rope(k, theta)) and torch.equal(rq, apply_rope(q, theta))
    if form == "window":
        got, again = window_attention(q, k, v, seg, seg, 64, theta), window_attention(rq, rk, v, seg, seg, 64)
    else:
        got, again = segment_attention(q, k, v, seg, seg, theta), segment_attention(rq, rk, v, seg, seg)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


G_CODE_SHARE_MAX = 5e-2  # gelu(a) * b codes behind a bf16 Wi product: h rounded to bf16 after sums in another order


@pytest.mark.gpu
@pytest.mark.parametrize("rows", EDGE_ROWS)
@pytest.mark.parametrize("d, f", [(768, 64), (768, 1088), (768, 1152), (768, 2048), (512, 64), (512, 1024),
                                  (512, 1152), (256, 64), (256, 512), (256, 1152)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_ffn_w8a8_wo_alone_kernel_at_tile_edges(cuda, rows, d, f, with_bias):
    """The w8a8_wo form alone of cm3p_fused_ln_ffn_q (row 3o: a bf16 Wi, an int8 Wo; two passes over F)
    against its plain version, with no F limit (one 64-column chunk of F, an odd count of chunks: the last
    one alone), and the gelu(a) * b codes it exports against the plain quantiser of the plain h. h is
    rounded to bf16 after fp32 sums in another order, so a value of a or b may round to the other bf16
    neighbour (a step of up to 2^-7 of it): where that happens at an element and at its row's absmax
    (which sets the row's scale), the element's code moves by up to 2. So a share of the codes (at most
    G_CODE_SHARE_MAX) may differ, by 2 at most."""
    rows = _edge_rows(rows, 2 * 64, 2 if d == 768 else 1)
    gen = torch.Generator(device=cuda).manual_seed(17)
    x, scale, bias, zero = _edge_inputs(rows, d, gen, cuda)
    bias = bias if with_bias else None
    wi = (d ** -0.5 * torch.randn(2 * f, d, generator=gen, device=cuda)).to(torch.bfloat16)
    wo = (0.25 * f ** -0.5 * torch.randn(d, f, generator=gen, device=cuda)).to(torch.bfloat16)
    wo_q = quantize_weight_int8(wo)
    kw = dict(w8a8=False, w8a8_wo=True, wo_q=wo_q)
    codes_g = torch.full((rows, f), -128, dtype=torch.int8, device=cuda)  # a value the quantiser never gives
    reset_launch_counts()
    got = fused_ln_ffn_q(x, scale, bias, wi, wo, 1e-5, **kw, codes_g=codes_g)
    want = fused_ln_ffn_plain(x, scale, bias, wi, wo, 1e-5, **kw)
    torch.cuda.synchronize()
    assert launch_counts() == {**_NONE, "fused_ln_ffn_wo": 1}
    assert torch.isfinite(got).all()
    assert (want.float() - x.float()).pow(2).mean().sqrt().item() > 2 * ATOL  # the FFN's own part, rms
    assert (got.float() - want.float()).abs().max().item() <= ATOL
    h = torch.nn.functional.linear(layer_norm_f32(x, scale, bias, 1e-5).to(torch.bfloat16), wi)
    gf = torch.nn.functional.gelu(h[:, :f].float()) * h[:, f:].float()
    diff = (codes_g.short() - quant_rows_int8(gf)[0].short()).abs()
    assert int(diff.max()) <= 2 and float((diff > 0).float().mean()) <= G_CODE_SHARE_MAX


def _fp32_rows(rows, d, gen, device):
    x = torch.randn(rows, d, generator=gen, device=device)
    x[rows // 3: rows // 3 + 5] = 0  # zero rows: LN gives the bias, the codes 0
    return x


# the fp32-weight form's 128-row tiles: one row, one short of a tile, a tile, one past it, a ragged count, and
# three waves of the card's 132 SMs at two blocks an SM plus a ragged tile
FP32_LNMM_ROWS = [1, 37, 127, 128, 129, 4037, 3 * 2 * 132 * 128 + 77]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", FP32_LNMM_ROWS)
@pytest.mark.parametrize("d, n_out", [(768, 2304), (768, 768), (512, 1536), (256, 768), (768, 128), (256, 128)])
@pytest.mark.parametrize("form", ["ln", "ln_bias", "wo_residual"])
@pytest.mark.parametrize("int8", [False, True])
def test_fp32_ln_matmul_kernel_matches_plain(fp32_cuda, rows, d, n_out, form, int8):
    gen = torch.Generator(device=fp32_cuda).manual_seed(24)
    x = _fp32_rows(rows, d, gen, fp32_cuda)
    w = 0.05 * torch.randn(n_out, d, generator=gen, device=fp32_cuda)
    kw = dict(eps=1e-5)
    if form != "wo_residual":
        kw["scale"] = 1 + 0.1 * torch.randn(d, generator=gen, device=fp32_cuda)
    if form == "ln_bias":
        kw["bias"] = 0.1 * torch.randn(d, generator=gen, device=fp32_cuda)
    if form == "wo_residual":
        kw["residual"] = torch.randn(rows, n_out, generator=gen, device=fp32_cuda)
    reset_launch_counts()
    if int8:
        w_q = quantize_weight_int8(w)
        codes = torch.empty(rows, d, dtype=torch.int8, device=fp32_cuda)
        got = fused_ln_matmul_q(x, None, w_q=w_q, codes_out=codes, **kw)
        want = fused_ln_matmul_q_plain(x, None, w_q=w_q, **kw)
        y = layer_norm_f32(x, kw["scale"], kw.get("bias"), 1e-5) if "scale" in kw else x
        want_codes = quant_rows_int8(y)[0]
        torch.cuda.synchronize()
        _assert_codes_agree(codes, want_codes)
        same = (codes == want_codes).all(-1)
        assert _rel_err(got, want, same) <= F32_REL_TOL
        name = "fused_ln_matmul_q_wo_f32" if form == "wo_residual" else "fused_ln_matmul_q_f32"
    else:
        got = fused_ln_matmul(x, w, **kw)
        want = fused_ln_matmul_plain(x, w, **kw)
        torch.cuda.synchronize()
        assert _rel_err(got, want) <= F32_REL_TOL
        name = "fused_ln_matmul_wo_f32" if form == "wo_residual" else "fused_ln_matmul_f32"
    assert got.dtype == torch.float32 and launch_counts() == {**_NONE, name: 1}


@pytest.mark.gpu
@pytest.mark.parametrize("n_out", [768, 2304])
@pytest.mark.parametrize("d", [768, 512, 256])
@pytest.mark.parametrize("form", ["ln_bias", "wo_residual"])
def test_fp32_ln_matmul_q_kernel_at_every_column_tile_count(fp32_cuda, form, d, n_out):
    """The int8 form at every N that is a multiple of 128 up to n_out (1 to 18 column tiles of its product), on a
    row count one past a 128-row tile, with both exported codes."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(27)
    rows = 129
    x = _fp32_rows(rows, d, gen, fp32_cuda)
    kw = dict(eps=1e-5)
    if form == "ln_bias":
        kw["scale"] = 1 + 0.1 * torch.randn(d, generator=gen, device=fp32_cuda)
        kw["bias"] = 0.1 * torch.randn(d, generator=gen, device=fp32_cuda)
    y = layer_norm_f32(x, kw["scale"], kw["bias"], 1e-5) if form == "ln_bias" else x
    want_codes = quant_rows_int8(y)[0]
    for n in range(128, n_out + 1, 128):
        w_q = quantize_weight_int8(0.05 * torch.randn(n, d, generator=gen, device=fp32_cuda))
        if form == "wo_residual":
            kw["residual"] = torch.randn(rows, n, generator=gen, device=fp32_cuda)
        codes = torch.empty(rows, d, dtype=torch.int8, device=fp32_cuda)
        got = fused_ln_matmul_q(x, None, w_q=w_q, codes_out=codes, **kw)
        want = fused_ln_matmul_q_plain(x, None, w_q=w_q, **kw)
        torch.cuda.synchronize()
        _assert_codes_agree(codes, want_codes)
        assert _rel_err(got, want, (codes == want_codes).all(-1)) <= F32_REL_TOL, n


@pytest.mark.gpu
@pytest.mark.parametrize("d, n_out", [(768, 2304), (768, 768), (512, 1536), (512, 512)])
@pytest.mark.parametrize("form", ["ln", "ln_bias", "wo_residual"])
def test_fp32_ln_matmul_q_kernel_bit_equal_rows_are_reported(fp32_cuda, form, d, n_out):
    """The int8 form against its plain version on the rows whose codes agree: the share of those rows that equal
    it bit for bit is printed (the same codes, exact int32 sums and the same rounding points give the plain
    version's numbers, but for an LN whose sums run in another order than PyTorch's, which moves a row's scale);
    F32_REL_TOL is the gate."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(28)
    rows = 4037
    x = _fp32_rows(rows, d, gen, fp32_cuda)
    w_q = quantize_weight_int8(0.05 * torch.randn(n_out, d, generator=gen, device=fp32_cuda))
    kw = dict(eps=1e-5)
    if form != "wo_residual":
        kw["scale"] = 1 + 0.1 * torch.randn(d, generator=gen, device=fp32_cuda)
    if form == "ln_bias":
        kw["bias"] = 0.1 * torch.randn(d, generator=gen, device=fp32_cuda)
    if form == "wo_residual":
        kw["residual"] = torch.randn(rows, n_out, generator=gen, device=fp32_cuda)
    codes = torch.empty(rows, d, dtype=torch.int8, device=fp32_cuda)
    got = fused_ln_matmul_q(x, None, w_q=w_q, codes_out=codes, **kw)
    want = fused_ln_matmul_q_plain(x, None, w_q=w_q, **kw)
    y = layer_norm_f32(x, kw["scale"], kw.get("bias"), 1e-5) if "scale" in kw else x
    same = (codes == quant_rows_int8(y)[0]).all(-1)
    torch.cuda.synchronize()
    bit_equal = (got[same] == want[same]).all(-1).float().mean().item()
    print(f"int8 LN-matmul fp32 {form} {d} -> {n_out}: {same.float().mean().item():.4f} of rows with the plain "
          f"codes, {bit_equal:.4f} of those bit-equal to the plain version")
    assert _rel_err(got, want, same) <= F32_REL_TOL


# the fp32 FFN's persistent grid (two 128-row blocks an SM) walks several tiles a block past this many rows
FP32_FFN_ROWS = [1, 37, 127, 128, 129, 4037, 3 * 2 * 132 * 128 + 77]


@pytest.mark.gpu
@pytest.mark.parametrize("rows", FP32_FFN_ROWS)
@pytest.mark.parametrize("d, f", [(768, 1152), (512, 1024), (256, 512), (768, 64)])
@pytest.mark.parametrize("w8a8, w8a8_wo", [(False, False), (True, False), (True, True), (False, True)])
def test_fp32_ffn_kernel_matches_plain(fp32_cuda, rows, d, f, w8a8, w8a8_wo):
    gen = torch.Generator(device=fp32_cuda).manual_seed(25)
    x = _fp32_rows(rows, d, gen, fp32_cuda)
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=fp32_cuda)
    bias = 0.1 * torch.randn(d, generator=gen, device=fp32_cuda)
    wi = 0.05 * torch.randn(2 * f, d, generator=gen, device=fp32_cuda)
    wo = 0.05 * torch.randn(d, f, generator=gen, device=fp32_cuda)
    reset_launch_counts()
    _hold_fp32_ffn(x, scale, bias, wi, wo, w8a8, w8a8_wo)
    name = {(False, False): "fused_ln_ffn_f32", (True, False): "fused_ln_ffn_q_f32", (True, True): "fused_ln_ffn_q_wo_f32",
            (False, True): "fused_ln_ffn_wo_f32"}[w8a8, w8a8_wo]
    assert launch_counts() == {**_NONE, name: 1}


def _hold_fp32_ffn(x, scale, bias, wi, wo, w8a8, w8a8_wo):
    """The fp32 FFN kernel in a form against its plain version: the int8 forms' exported codes as the plain
    quantiser's (but a share off by one), and F32_REL_TOL on the rows whose codes agree (at least 90 %)."""
    rows, d, f = x.shape[0], x.shape[1], wo.shape[1]
    wi_q = quantize_weight_int8(wi) if w8a8 else None
    wo_q = quantize_weight_int8(wo) if w8a8_wo else None
    args = (x, scale, bias, wi, wo, 1e-5)
    if w8a8 or w8a8_wo:
        codes_y = torch.empty(rows, d, dtype=torch.int8, device=x.device)
        codes_g = torch.empty(rows, f, dtype=torch.int8, device=x.device)
        got = fused_ln_ffn_q(*args, w8a8, w8a8_wo, wi_q, wo_q, codes_y=codes_y, codes_g=codes_g)
    else:
        got = fused_ln_ffn(*args)
    want = fused_ln_ffn_plain(*args, w8a8, w8a8_wo, wi_q, wo_q)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    same = torch.ones(rows, dtype=torch.bool, device=x.device)
    y = layer_norm_f32(x, scale, bias, 1e-5)
    if w8a8:
        want_y = quant_rows_int8(y)[0]
        _assert_codes_agree(codes_y, want_y)
        same &= (codes_y == want_y).all(-1)
    if w8a8_wo:
        # the GeGLU of the plain version's h, quantised; rows whose y codes moved are compared on their own codes
        if w8a8:
            h = int8_matmul(codes_y, wi_q[0]) * quant_rows_int8(y)[1] * wi_q[1]
        else:
            h = y @ wi.t()
        gf = torch.nn.functional.gelu(h[:, :f]) * h[:, f:]
        want_g = quant_rows_int8(gf)[0]
        _assert_codes_agree(codes_g, want_g)
        same &= (codes_g == want_g).all(-1)
    assert same.float().mean().item() >= 0.9
    assert _rel_err(got, want, same) <= F32_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("d, first_limit", [(768, 1792), (512, 2048), (256, 2304)])
def test_fp32_ffn_kernel_takes_every_f_past_the_first_versions_limit(fp32_cuda, d, first_limit):
    """Every F that is a multiple of 64 up to the first version's limit (a 16-row tile's y and g in shared
    memory), and two past it, without an LN bias: nothing in shared memory grows with F now. The int8 forms at the
    smallest F, the limit and past it."""
    gen = torch.Generator(device=fp32_cuda).manual_seed(26)
    x = _fp32_rows(37, d, gen, fp32_cuda)
    scale = 1 + 0.1 * torch.randn(d, generator=gen, device=fp32_cuda)
    for f in [*range(64, first_limit + 1, 64), first_limit + 64, 2 * first_limit]:
        wi = 0.05 * torch.randn(2 * f, d, generator=gen, device=fp32_cuda)
        wo = 0.05 * torch.randn(d, f, generator=gen, device=fp32_cuda)
        forms = [(False, False)]
        if f in (64, first_limit, first_limit + 64):
            forms += [(True, False), (True, True), (False, True)]
        for w8a8, w8a8_wo in forms:
            _hold_fp32_ffn(x, scale, None, wi, wo, w8a8, w8a8_wo)


@pytest.mark.gpu
def test_fp32_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(4, 768, device=cuda)
    wi, wo = torch.zeros(2 * 2000, 768, device=cuda), torch.zeros(768, 2000, device=cuda)
    with pytest.raises(ValueError, match="F a multiple of 64"):
        fused_ln_ffn(x, torch.ones(768, device=cuda), None, wi, wo, 1e-5)
    with pytest.raises(ValueError, match="wi must be"):
        fused_ln_ffn(x, torch.ones(768, device=cuda), None, wi[:256, :].to(torch.bfloat16),
                     wo[:, :128].contiguous(), 1e-5)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fused_ln_matmul(x.half(), torch.zeros(128, 768, dtype=torch.half, device=cuda))
    q = torch.zeros(1, 64, 2, 64, device=cuda)
    seg = torch.ones(1, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="no lse"):
        segment_attention(q, q, q, seg, seg, return_lse=True)
    with pytest.raises(ValueError, match="head dim"):
        window_attention(q[..., :32], q[..., :32], q[..., :32], seg, seg, 16)
    with pytest.raises(ValueError, match="backward kernels take bfloat16"):
        window_attention_dkv(q, q, q, q, torch.zeros(1, 2, 64, device=cuda), torch.zeros(1, 2, 64, device=cuda),
                             seg, seg, 16)


# ------------------------------------------------------------ the dQ and dK/dV kernels (sm90_bwd::attention_dq_kernel, attention_dkv_kernel)


def _dkv_segments(length, device):
    """qseg and kseg (2, length): packed segments with a padding tail, and keys no query sees (segment 9 in
    kseg only, and padding): their dk and dv are exactly 0."""
    qseg = _fp32_segments(2, length, device)
    kseg = qseg.clone()
    kseg[0, 300:340] = 9
    kseg[1, 10:20] = 9
    return qseg, kseg


@pytest.mark.gpu
@pytest.mark.parametrize("length", [100, 1000, 1500, 4037])
@pytest.mark.parametrize("window", [64, 192, None], ids=["window", "wide_window", "segment"])
@pytest.mark.parametrize("rope", [False, True], ids=["no_rope", "rope"])
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_dkv_kernel_matches_plain_off_the_key_tile(cuda, length, window, rope, kernel):
    """Lengths not a multiple of the kernels' 128 rows a block; the window and segment forms, with rope (raw q/k,
    dq / dk counter-rotated) and without, for the dq and the dkv kernel; keys no query sees give dk = dv = 0
    exactly, queries that see no key dq = 0 exactly."""
    gen = torch.Generator(device=cuda).manual_seed(26)
    qseg, kseg = _dkv_segments(length, cuda)
    q, k, v = _qkv(2, length, 4, gen, cuda)
    dout = torch.randn(2, length, 4, 64, generator=gen, device=cuda).to(torch.bfloat16)
    theta = (10000.0 if window else 160000.0) if rope else None
    wargs = (window,) if window else ()
    fwd_plain = window_attention_plain if window else segment_attention_plain
    out, lse = fwd_plain(q, k, v, qseg, kseg, *wargs, theta, return_lse=True)
    delta = attention_delta(out, dout)
    args = (q, k, v, dout, lse, delta, qseg, kseg, *wargs)
    reset_launch_counts()
    if kernel == "dq":
        grads = ((window_attention_dq if window else segment_attention_dq)(*args, rope_theta=theta),)
    else:
        grads = (window_attention_dkv if window else segment_attention_dkv)(*args, rope_theta=theta)
    torch.cuda.synchronize()
    name = ("window_attention_" if window else "segment_attention_") + kernel + ("_rope" if rope else "")
    assert launch_counts() == {**_NONE, name: 1}
    if rope:
        want = attention_bwd_rope_plain(q, k, v, dout, lse, delta, qseg, kseg, window, theta)
    else:
        want = _attention_bwd_plain(q, k, v, dout, lse, delta, qseg, kseg, window)
    for got, ref in zip(grads, want[:1] if kernel == "dq" else want[1:]):
        assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()
    if kernel == "dq":
        assert grads[0][qseg == 0].abs().max().item() == 0.0
    else:
        unseen = (kseg == 9) | (kseg == 0)
        assert grads[0][unseen].abs().max().item() == 0.0 and grads[1][unseen].abs().max().item() == 0.0
