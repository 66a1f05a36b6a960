"""The attention kernels' out-projection epilogue: the port's plain versions
and routing against the JAX package on the CPU.

* ``window_attention_wo`` / ``segment_attention_wo`` and their int8 forms
  (plain versions, what the wrappers run on CPU tensors) against the JAX
  ``_flash_attention_fwd_impl(..., wo=, out_res=)`` with its Pallas kernels in
  interpret mode (``FUSED_WO_Q`` patched for the int8 form; running max, as
  the port's kernels keep). Tolerances per test.
* the port's ``wo_fusable`` against the JAX package's over a grid of shapes;
* which form each layer of an encoder runs under each option set;
* the parsers of the scripts that check and time the epilogue kernels on the
  card: ptxas's "Potential Performance Loss" notes (``chip_smoke.py`` phase 1)
  and the timing lines ``compare_kernels.py --phase wo`` collects.
"""
import functools
import importlib
import importlib.util
import itertools
from pathlib import Path

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cm3p_tpu.ops.flash_attention as fa
from cm3p_tpu.ops.fused_ffn import _quant_rows_int8
from cm3p_torch import ops
from cm3p_torch.configs import MetadataConfig
from cm3p_torch.models import EncoderOptions, ModernBertEncoder
from cm3p_torch.models.modernbert import wo_epilogue

attention_mod = importlib.import_module("cm3p_torch.ops.attention")

B, L, H, D, DM = 2, 256, 2, 64, 256


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(fa, "ONLINE_MAX", True)


def _case(seed):
    """q, k, v (B, L, H, D); packed segments with a padding tail; residual (B, L, DM);
    Wo in the flax layout (H * D, DM)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    seg = np.zeros((B, L), np.int32)
    seg[0, :90], seg[0, 90:200], seg[0, 200:230] = 1, 2, 3
    seg[1, :170] = 1
    res = rng.standard_normal((B, L, DM)).astype(np.float32)
    wo = (0.05 * rng.standard_normal((H * D, DM))).astype(np.float32)
    return q, k, v, seg, res, wo


def _jax_epilogue(q, k, v, seg, res, wo, window, theta, dtype):
    jq, jk, jv = (jnp.asarray(x.reshape(B, L, H * D), dtype) for x in (q, k, v))
    out = fa._flash_attention_fwd_impl(
        jq, jk, jv, jnp.asarray(seg), jnp.asarray(seg), window, 128, 128, H,
        rope_theta=theta, wo=jnp.asarray(wo), out_res=jnp.asarray(res, dtype),
    )
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16-epilogue", "int8-epilogue"])
@pytest.mark.parametrize("window", [64, None], ids=["window", "segment"])
def test_epilogue_plain_matches_interpreted_pallas(interpret_mode, monkeypatch, window, int8, dtype):
    """fp32, bf16 epilogue: 1e-5 (two orders of summation; outputs up to ~4.5).
    fp32, int8: an o value on the other side of a rounding boundary moves its
    code by one and the output by (row max / 127) * |Wo| ~ 1e-3 here, so 5e-3
    overall and 1e-4 on the rows whose codes agree, which must be >= 95 % of
    the live rows. bf16: 5e-2, 1.6 bf16 ulps at 4 (o, the product and the sum
    each rounded to bf16, in other orders). Padding rows give the residual
    exactly on both sides."""
    monkeypatch.setattr(fa, "FUSED_WO_Q", int8)
    q, k, v, seg, res, wo = _case(seed=3 if window else 4)
    theta = 10000.0 if window else 160000.0
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = _jax_epilogue(q, k, v, seg, res, wo, window, theta, jdt)

    tq, tk, tv = (torch.as_tensor(np.array(jnp.asarray(x, jdt).astype(jnp.float32))).to(tdt) for x in (q, k, v))
    tres = torch.as_tensor(np.array(jnp.asarray(res, jdt).astype(jnp.float32))).to(tdt)
    tseg = torch.as_tensor(seg)
    w = torch.as_tensor(wo.T.copy())  # nn.Linear layout (N, H * D)
    if int8:
        w_q = ops.quantize_weight_int8(w)
        if window:
            got = ops.window_attention_wo_q(tq, tk, tv, tseg, tseg, window, w_q, tres, theta)
        else:
            got = ops.segment_attention_wo_q(tq, tk, tv, tseg, tseg, w_q, tres, theta)
    else:
        if window:
            got = ops.window_attention_wo(tq, tk, tv, tseg, tseg, window, w.to(tdt), tres, theta)
        else:
            got = ops.segment_attention_wo(tq, tk, tv, tseg, tseg, w.to(tdt), tres, theta)
    assert got.dtype == tdt and got.shape == (B, L, DM)
    got = got.float().numpy()
    live = seg > 0
    assert np.array_equal(got[~live], tres.float().numpy()[~live])
    assert np.array_equal(want[~live], tres.float().numpy()[~live])
    if dtype == "bfloat16":
        np.testing.assert_allclose(got[live], want[live], atol=5e-2)
        return
    if not int8:
        np.testing.assert_allclose(got[live], want[live], atol=1e-5)
        return
    fn = ops.window_attention_plain if window else ops.segment_attention_plain
    args = (window,) if window else ()
    o = fn(tq, tk, tv, tseg, tseg, *args, rope_theta=theta).flatten(2)
    jo = fa._flash_attention_fwd_impl(
        *(jnp.asarray(x.reshape(B, L, H * D)) for x in (q, k, v)), jnp.asarray(seg), jnp.asarray(seg), window,
        128, 128, H, rope_theta=theta,
    )
    same = (ops.quant_rows_int8(o)[0].numpy() == np.asarray(_quant_rows_int8(jo)[0])).all(-1) & live
    assert same.sum() >= 0.95 * live.sum()
    np.testing.assert_allclose(got[same], want[same], atol=1e-4)
    np.testing.assert_allclose(got[live], want[live], atol=5e-3)


def test_epilogue_wrappers_on_cpu_are_the_composition_and_launch_nothing():
    """On CPU tensors each wrapper is its plain version, which is the plain
    attention followed by the plain LN-matmul forms (no LN)."""
    q, k, v, seg, res, wo = _case(seed=5)
    tq, tk, tv, tres = (torch.as_tensor(x).to(torch.bfloat16) for x in (q, k, v, res))
    tseg = torch.as_tensor(seg)
    w = torch.as_tensor(wo.T.copy()).to(torch.bfloat16)
    w_q = ops.quantize_weight_int8(w)
    ops.reset_launch_counts()
    o_win = ops.window_attention(tq, tk, tv, tseg, tseg, 64, 10000.0).flatten(2)
    o_seg = ops.segment_attention(tq, tk, tv, tseg, tseg, 160000.0).flatten(2)
    pairs = [
        (ops.window_attention_wo(tq, tk, tv, tseg, tseg, 64, w, tres, 10000.0),
         ops.fused_ln_matmul_plain(o_win, w, residual=tres)),
        (ops.window_attention_wo_q(tq, tk, tv, tseg, tseg, 64, w_q, tres, 10000.0),
         ops.fused_ln_matmul_q_plain(o_win, None, residual=tres, w_q=w_q)),
        (ops.segment_attention_wo(tq, tk, tv, tseg, tseg, w, tres, 160000.0),
         ops.fused_ln_matmul_plain(o_seg, w, residual=tres)),
        (ops.segment_attention_wo_q(tq, tk, tv, tseg, tseg, w_q, tres, 160000.0),
         ops.fused_ln_matmul_q_plain(o_seg, None, residual=tres, w_q=w_q)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert not any(ops.launch_counts().values())
    with pytest.raises(ValueError, match="codes_out"):
        ops.window_attention_wo_q(tq, tk, tv, tseg, tseg, 64, w_q, tres, codes_out=torch.empty(1, dtype=torch.int8))


_GRID = list(itertools.product(
    [None, 0, 64, 128, 129, 200],  # window (one-sided); None = global
    [(768, 768), (512, 512), (256, 256), (64, 64), (768, 700), (700, 768)],  # (H * D, d_model)
    [(160, 160), (2048, 2048), (2049, 2049), (4096, 4096), (256, 512)],  # (Lq, Lk)
))


@pytest.mark.parametrize("window", [None, 0, 64, 128, 129, 200])
def test_wo_fusable_matches_jax(window):
    """The port's copy of the rule at the dispatcher's automatic blocks, over
    widths and lengths: 4096-token global rows decline, as on the TPU."""
    for w, (hd, dm), (lq, lk) in _GRID:
        if w != window:
            continue
        want = fa.wo_fusable(w, 0, 0, hd, dm, lq, lk)
        assert ops.wo_fusable(w, hd, dm, lq, lk) == want, (w, hd, dm, lq, lk)
        # the shape part alone differs only by the VMEM limit of long global rows
        assert ops.wo_shape_ok(w, hd, dm, lq, lk) == (want or (w is None and lq == lk and lq > 2048
                                                              and hd % 128 == 0 and dm % 128 == 0))


@pytest.mark.parametrize("fields,window,length,form", [
    (dict(fused_wo=True), 64, 4096, "bf16"),
    (dict(fused_wo=True, fused_wo_q=True), 64, 4096, "int8"),
    (dict(fused_wo=True, fused_wo_q=True), None, 1500, "int8"),  # the audio tower's global layers
    (dict(fused_wo=True, fused_wo_q=True), None, 4096, "bf16"),  # the JAX route there is the exact bf16 dot
    (dict(fused_wo=True, fused_wo_q=True, fused_lnmm_wo=True), None, 4096, "bf16"),
    (dict(fused_wo=True, fused_wo_q=True, fused_lnmm_wo=True, w8a8_wo=True), None, 4096, None),  # int8 LN-matmul
    (dict(fused_wo=True, fused_wo_q=True, fused_lnmm_wo=True, w8a8_wo=True), None, 2048, "int8"),
    (dict(fused_wo=True), 200, 1024, None),  # too wide for the single-pass kernel
    (dict(fused_wo_q=True), 64, 1024, None),  # fused_wo_q acts only with fused_wo
    (dict(w8a8=True, fused_lnmm_wo=True), 64, 1024, None),
])
def test_wo_epilogue_form(fields, window, length, form):
    assert wo_epilogue(EncoderOptions(**fields), window, 768, length) == form


def _count_routes(monkeypatch):
    """Count the calls of each route of the out-projection on CPU tensors."""
    calls = {}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for name in ("window_attention_wo", "window_attention_wo_q", "segment_attention_wo", "segment_attention_wo_q"):
        monkeypatch.setattr(attention_mod, name, counted(name, getattr(attention_mod, name)))
    modernbert = importlib.import_module("cm3p_torch.models.modernbert")
    for name in ("fused_ln_matmul", "fused_ln_matmul_q"):
        monkeypatch.setattr(modernbert, name, counted(name, getattr(modernbert, name)))
    return calls


@pytest.mark.parametrize("length", [160, 2100])
def test_encoder_runs_each_layer_through_its_epilogue_form(monkeypatch, length):
    """Layers: global (no pre-norm), local, global. Under the epilogue options
    every layer's out-projection runs in the attention kernel; in int8 except
    on global layers longer than 2048 tokens, which stay bf16."""
    cfg = MetadataConfig(vocab_size=128, hidden_size=128, num_hidden_layers=3, num_attention_heads=2,
                         intermediate_size=128, max_position_embeddings=4096, global_attn_every_n_layers=2,
                         local_attention=128)
    enc = ModernBertEncoder(cfg).eval()
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 128, (1, length)), dtype=torch.int64)
    calls = _count_routes(monkeypatch)
    with torch.no_grad():
        enc.set_options(EncoderOptions(w8a8=True, fused_wo=True))
        bf16 = enc(input_ids=ids)
        assert calls == {"window_attention_wo": 1, "segment_attention_wo": 2}
        calls.clear()
        enc.set_options(EncoderOptions(w8a8=True, fused_wo=True, fused_wo_q=True))
        quant = enc(input_ids=ids)
        want = {"window_attention_wo_q": 1, "segment_attention_wo_q" if length <= 2048 else "segment_attention_wo": 2}
        assert calls == want
        calls.clear()
        enc.set_options(EncoderOptions(w8a8=True))
        exact_wo = enc(input_ids=ids)
        assert calls == {}
    torch.testing.assert_close(bf16, exact_wo, atol=1e-5, rtol=0)  # the bf16 epilogue changes no number
    assert not torch.equal(quant, exact_wo)


def _script(name):
    path = Path(__file__).resolve().parent.parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_MANGLED = ("_ZN48_GLOBAL__N__e1751ac3_15_attention_wo_cu_3c3bcaa57sm90_wo19attention_wo_kernelILb0ELi768EEEv14"
            "CUtensorMap_st")


@pytest.mark.parametrize("code, reason", [
    ("C7514", "non wgmma instructions reading accumulator registers of  a wgmma between start and end of the "
              "pipeline stage"),
    ("C7520", "program dependence on compiler-inserted WG.AR in divergent path"),
])
def test_ptxas_notes_name_the_serialised_kernel(code, reason):
    log = (f"ptxas info    : 0 bytes gmem\n"
           f"ptxas info    : ({code}) Potential Performance Loss: wgmma.mma_async instructions are serialized "
           f"due to {reason} in the function '{_MANGLED}'\n"
           f"ptxas info    : Used 96 registers, used 2 barriers\n")
    notes = _script("chip_smoke").ptxas_notes(log)
    assert notes == [("sm90_wo::attention_wo_kernel<0,768>",
                      f"{code} wgmma.mma_async instructions are serialized due to {' '.join(reason.split())}")]
    assert _script("chip_smoke").ptxas_notes("ptxas info    : Used 96 registers, used 2 barriers\n") == []


def test_compare_wo_reads_each_form_and_shape_and_its_unfused_pair():
    stdout = """  attention with the Wo epilogue (max abs difference; tolerance 0.02)
    window_attention_wo    packed (79, 4096) H12: out 1.562e-02, attention output 7.812e-03; rows that see no key \
give the residual bit for bit: True
    window_attention_wo    packed (79, 4096) H12: 2.153 ms (plain 497.397, bound 0.743 bytes; the unfused pair \
attention + linear + add 4.135 ms)
    window_attention_wo    packed (79, 4096) H12: without rope 1.865 ms
    segment_attention_wo_q audio 237x1500 H8: 17.531 ms (plain 152.417, bound 1.125 operations; the unfused pair \
attention + int8 LN-matmul Wo 15.827 ms)
    segment_attention_wo   one segment 4x4096 H12: out 1.562e-02, attention output 9.766e-04; rows that see no \
key give the residual bit for bit: True
REPORT {"errs": {}}
"""
    times = _script("compare_kernels").wo_times(stdout)
    assert times == {
        "window_attention_wo packed": {"ms": 2.153, "pair_ms": 4.135},
        "segment_attention_wo_q audio": {"ms": 17.531, "pair_ms": 15.827},
    }

