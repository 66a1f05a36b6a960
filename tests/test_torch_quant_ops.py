"""The port's W8A8 quantisers, fused LN-matmul and FFN plain versions (the
int8 forms and the bf16 one) against the JAX package on the CPU, and the FFN
yardsticks ``chip_smoke.py`` prints beside the kernels (the unfused
composition and the bounds).

The same numpy arrays go through the JAX function (its XLA reference and
its Pallas kernel in interpret mode) and the port's plain version (what the
wrappers run on a CPU tensor). Weights are flax (in, out) on the JAX side
and nn.Linear (out, in) on the port's. Tolerances are stated per test.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3p_tpu.ops.fused_ffn import _ln_f32, _pallas_ln_ffn, _quant_rows_int8
from cm3p_tpu.ops.fused_ffn import quantize_weight_int8 as jax_quantize_weight_int8
from cm3p_tpu.ops.fused_ln_matmul import (
    _pallas_ln_matmul,
    _pallas_ln_matmul_q,
    reference_ln_matmul,
    reference_ln_matmul_q,
)
from cm3p_tpu.ops.fused_ln_matmul import lnmm_fusable as jax_lnmm_fusable
from cm3p_torch import ops
from cm3p_torch.ops.fused_ffn import ffn_fusable, layer_norm_f32
from cm3p_torch.ops.fused_ln_matmul import lnmm_fusable

EPS = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _np(t):
    return t.float().numpy()


def _ulp_equal(a, b, ulps=1):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.all(np.abs(a - b) <= ulps * np.spacing(np.maximum(np.abs(a), np.abs(b))))


def _inputs(rows, d, n, seed, zero_rows=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    if zero_rows:
        x[5:9] = 0.0  # padded rows: LN gives 0, the absmax clamps, the codes are 0
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    w = (0.05 * rng.standard_normal((d, n))).astype(np.float32)  # flax (in, out)
    res = rng.standard_normal((rows, n)).astype(np.float32)
    return x, scale, bias, w, res


# ------------------------------------------------------------------ quantisers


@pytest.mark.parametrize("shape", [(128, 256), (768, 96), (64, 1)])
def test_quantize_weight_int8_matches_jax(shape):
    """Codes equal; scales to 1 ulp (amax / 127 in both)."""
    rng = np.random.default_rng(0)
    w = (0.02 * rng.standard_normal(shape)).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero output channel: the scale clamps at 1e-30 / 127
    wq_j, sw_j = jax_quantize_weight_int8(jnp.asarray(w))
    wq, sw = ops.quantize_weight_int8(_t(w.T))
    assert wq.dtype == torch.int8 and sw.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wq_j).T)
    assert _ulp_equal(sw.numpy(), np.asarray(sw_j))


@pytest.mark.parametrize("shape", [(37, 128), (4, 9, 768), (300, 1152)])
def test_quant_rows_int8_matches_jax(shape):
    """Codes equal; row scales to 1 ulp (amax * (1 / 127) in both, true division for the codes)."""
    rng = np.random.default_rng(1)
    y = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    y[0] = 0.0
    q_j, sa_j = _quant_rows_int8(jnp.asarray(y))
    q, sa = ops.quant_rows_int8(_t(y))
    assert q.dtype == torch.int8 and sa.shape == shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    assert _ulp_equal(sa.numpy(), np.asarray(sa_j))
    assert int(q.abs().max()) == 127 and int(q[0].abs().max()) == 0


def test_quant_rows_int8_wants_float32():
    with pytest.raises(ValueError, match="float32"):
        ops.quant_rows_int8(torch.zeros(2, 8, dtype=torch.bfloat16))


def test_int8_matmul_is_exact_beyond_float32():
    """127^2 * 1152 > 2^24: the product must not be formed in float32."""
    q = torch.full((3, 1152), 127, dtype=torch.int8)
    w = torch.full((5, 1152), 127, dtype=torch.int8)
    w[1] = -127
    exact = 127 * 127 * 1152
    got = ops.int8_matmul(q, w)
    assert got.dtype == torch.float32
    assert got[0, 0].item() == float(np.float32(exact)) and got[0, 1].item() == float(np.float32(-exact))
    odd = q.clone()
    odd[0, 0] = 126  # exact sum 18580481, not a float32: the result is its rounding
    assert ops.int8_matmul(odd, w)[0, 0].item() == float(np.float32(exact - 127))


@pytest.mark.parametrize("d_in,d_out", [(768, 2304), (768, 768), (512, 1536), (700, 2304), (256, 100)])
def test_lnmm_fusable_matches_jax(d_in, d_out):
    assert lnmm_fusable(d_in, d_out) == jax_lnmm_fusable(d_in, d_out)


def test_ffn_fusable_is_the_lane_rule():
    assert ffn_fusable(768, 1152) and ffn_fusable(256, 512) and not ffn_fusable(64, 96) and not ffn_fusable(128, 96)


# -------------------------------------------------------------- fused LN-matmul

_FORMS = {
    "ln": dict(with_ln=True, with_bias=False, with_res=False),
    "ln-bias": dict(with_ln=True, with_bias=True, with_res=False),
    "res-no-ln": dict(with_ln=False, with_bias=False, with_res=True),
    "ln-res": dict(with_ln=True, with_bias=False, with_res=True),
}


def _jax_args(x, scale, bias, res, dtype, form):
    return (
        jnp.asarray(x, dtype),
        jnp.asarray(scale),
        jnp.asarray(bias) if form["with_bias"] else None,
        jnp.asarray(res, dtype) if form["with_res"] else None,
    )


def _torch_kwargs(scale, bias, res, dtype, form):
    return dict(
        scale=_t(scale) if form["with_ln"] else None,
        bias=_t(bias) if form["with_bias"] else None,
        residual=_t(res, dtype) if form["with_res"] else None,
        eps=EPS,
    )


@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_matmul_matches_jax(form, dtype):
    """Against ``reference_ln_matmul`` and the interpreted ``_pallas_ln_matmul``.

    fp32: 1e-5 (two orders of summation of the same products). bf16: 2e-2 on
    outputs of magnitude ~1 (one bf16 rounding of the product, one of the
    residual sum; the kernel adds the residual after the cast, the XLA
    reference fuses it)."""
    f = _FORMS[form]
    x, scale, bias, w, res = _inputs(150, 256, 384, seed=2)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jx, jscale, jbias, jres = _jax_args(x, scale, bias, res, jdt, f)
    ref = reference_ln_matmul(jx, jscale, jbias, jnp.asarray(w), jres, eps=EPS, with_ln=f["with_ln"])
    ker = _pallas_ln_matmul(jx, jscale, jbias, jnp.asarray(w), jres, eps=EPS, with_ln=f["with_ln"], block_rows=128)
    got = ops.fused_ln_matmul(_t(x, tdt), _t(w.T), **_torch_kwargs(scale, bias, res, tdt, f))
    assert got.dtype == tdt and got.shape == (150, 384)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), atol=tol)
    np.testing.assert_allclose(_np(got), np.asarray(ker, np.float32), atol=tol)
    if not f["with_res"]:
        assert float(got[5:9].abs().max()) == (0.0 if not f["with_bias"] else float(got[5:9].abs().max()))


@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_matmul_q_matches_jax(form, dtype):
    """Against ``reference_ln_matmul_q`` (+ residual) and the interpreted ``_pallas_ln_matmul_q``.

    The int32 products are exact, so where both sides quantise a row to the
    same codes the outputs agree to 1e-4 relative in fp32; rows where LN's
    summation order moved a value across a rounding boundary may differ by a
    code, and their share is asserted under 2 %. bf16: 2e-2."""
    f = _FORMS[form]
    x, scale, bias, w, res = _inputs(150, 256, 384, seed=3)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jx, jscale, jbias, jres = _jax_args(x, scale, bias, res, jdt, f)
    ref = reference_ln_matmul_q(jx, jscale, jbias, jnp.asarray(w), eps=EPS, with_ln=f["with_ln"])
    if jres is not None:
        ref = jres + ref
    wq_j, sw_j = jax_quantize_weight_int8(jnp.asarray(w))
    ker = _pallas_ln_matmul_q(jx, jscale, jbias, wq_j, sw_j, jres, eps=EPS, with_ln=f["with_ln"], block_rows=128)
    kw = _torch_kwargs(scale, bias, res, tdt, f)
    got = ops.fused_ln_matmul_q(_t(x, tdt), _t(w.T), **kw)
    cached = ops.fused_ln_matmul_q(_t(x, tdt), None, w_q=ops.quantize_weight_int8(_t(w.T)), **kw)
    assert torch.equal(got, cached)  # weights quantised once by the caller give the same result

    xt = _t(x, tdt)
    y = layer_norm_f32(xt, kw["scale"], kw["bias"], EPS) if f["with_ln"] else xt.float()
    jy = jnp.asarray(x, jdt).astype(jnp.float32)
    if f["with_ln"]:
        jy = _ln_f32(jy, jscale, jbias if jbias is not None else jnp.zeros_like(jscale), EPS)
    same = (ops.quant_rows_int8(y)[0].numpy() == np.asarray(_quant_rows_int8(jy)[0])).all(axis=1)
    assert same.mean() >= 0.98
    if dtype == "float32":
        for other in (ref, ker):
            other = np.asarray(other, np.float32)
            np.testing.assert_allclose(_np(got)[same], other[same], rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(_np(got), other, atol=2e-2)
    else:
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), atol=2e-2)
        np.testing.assert_allclose(_np(got), np.asarray(ker, np.float32), atol=2e-2)


def test_fused_ln_matmul_q_is_close_to_the_exact_form():
    """The quantisation band of the JAX package's own test: relative RMSE < 2 %, cosine > 0.9999."""
    x, scale, _, w, _ = _inputs(300, 256, 512, seed=4, zero_rows=False)
    exact = _np(ops.fused_ln_matmul(_t(x, torch.bfloat16), _t(w.T), scale=_t(scale)))
    q = _np(ops.fused_ln_matmul_q(_t(x, torch.bfloat16), _t(w.T), scale=_t(scale)))
    assert np.sqrt(np.mean((q - exact) ** 2)) / np.sqrt(np.mean(exact**2)) < 0.02
    assert np.sum(q * exact) / (np.linalg.norm(q) * np.linalg.norm(exact)) > 0.9999


def test_lnmm_wrappers_keep_leading_dims_and_reject_codes_out_on_cpu():
    x, scale, _, w, res = _inputs(24, 128, 256, seed=5)
    x3, res3 = _t(x).reshape(2, 12, 128), _t(res).reshape(2, 12, 256)
    out = ops.fused_ln_matmul(x3, _t(w.T), scale=_t(scale), residual=res3)
    assert out.shape == (2, 12, 256)
    torch.testing.assert_close(out.reshape(24, 256), ops.fused_ln_matmul(_t(x), _t(w.T), scale=_t(scale), residual=_t(res)))
    with pytest.raises(ValueError, match="codes_out"):
        ops.fused_ln_matmul_q(x3, _t(w.T), codes_out=torch.empty(2, 12, 128, dtype=torch.int8))


# ------------------------------------------------------------------- int8 FFN


@pytest.mark.parametrize("w8a8,w8a8_wo", [(True, False), (True, True), (False, True)],
                         ids=["w8a8", "w8a8+w8a8_wo", "w8a8_wo"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_ffn_int8_matches_interpreted_pallas(w8a8, w8a8_wo, dtype):
    """``fused_ln_ffn_plain`` with the W8A8 options against ``_pallas_ln_ffn(interpret=True)``.

    bf16: 2e-2 on outputs of magnitude ~1. fp32 with ``w8a8`` alone: 2e-3, which
    covers the TPU kernel's rational erf (4e-7 absolute) against the port's
    exact one and a rare LN code moved by the summation order. fp32 with
    ``w8a8_wo``: 1e-2, since a ``gelu(a) * b`` value that lands on the other
    side of a rounding boundary moves its code by one, i.e. the output by
    (row max / 127) * |Wo| ~ 6e-3 here."""
    rng = np.random.default_rng(6)
    rows, d, f = 150, 128, 256
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x[5:9] = 0.0
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    wi = (0.08 * rng.standard_normal((d, 2 * f))).astype(np.float32)
    wo = (0.08 * rng.standard_normal((f, d))).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = _pallas_ln_ffn(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(wi), jnp.asarray(wo),
        eps=EPS, residual=True, block_rows=128, w8a8=w8a8, w8a8_wo=w8a8_wo, interpret=True,
    )
    args = (_t(x, tdt), _t(scale), _t(bias), _t(wi.T), _t(wo.T), EPS)
    got = ops.fused_ln_ffn(*args, w8a8=w8a8, w8a8_wo=w8a8_wo)
    assert got.dtype == tdt
    tol = 2e-2 if dtype == "bfloat16" else (1e-2 if w8a8_wo else 2e-3)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=tol)
    cached = ops.fused_ln_ffn(
        *args, w8a8=w8a8, w8a8_wo=w8a8_wo,
        wi_q=ops.quantize_weight_int8(args[3]) if w8a8 else None,
        wo_q=ops.quantize_weight_int8(args[4]) if w8a8_wo else None,
    )
    assert torch.equal(got, cached)
    exact = ops.fused_ln_ffn(*args)
    assert not torch.equal(got, exact)  # the quantised path really ran
    assert float((got.float() - exact.float()).abs().max()) < 0.2  # and stayed in the quantisation band


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_ffn_w8a8_wo_matches_interpreted_pallas_at_the_beatmap_width(dtype):
    """The ``w8a8_wo`` form alone (row 3o: a bf16 Wi, an int8 Wo) at D 768 and F 1152, the width whose
    layout the CUDA kernel changes (two 384-column items, both passes over F in each), against
    ``_pallas_ln_ffn(interpret=True)``, with the tolerances above."""
    rng = np.random.default_rng(7)
    rows, d, f = 40, 768, 1152
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x[3:5] = 0.0
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    wi = (d ** -0.5 * rng.standard_normal((d, 2 * f))).astype(np.float32)
    wo = (0.25 * f ** -0.5 * rng.standard_normal((f, d))).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = _pallas_ln_ffn(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(wi), jnp.asarray(wo),
        eps=EPS, residual=True, block_rows=128, w8a8=False, w8a8_wo=True, interpret=True,
    )
    args = (_t(x, tdt), _t(scale), _t(bias), _t(wi.T), _t(wo.T), EPS)
    got = ops.fused_ln_ffn(*args, w8a8=False, w8a8_wo=True)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=2e-2 if dtype == "bfloat16" else 1e-2)
    exact = ops.fused_ln_ffn(*args)
    assert not torch.equal(got, exact)  # the quantised path really ran


@pytest.mark.parametrize("rows", [37, 150])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_ffn_bf16_form_matches_interpreted_pallas(rows, with_bias, dtype):
    """The form without the W8A8 options (row 3), ``fused_ln_ffn_plain`` on the CPU, against
    ``_pallas_ln_ffn(w8a8=False, w8a8_wo=False)`` in interpret mode, at rows that are not a
    multiple of its 128-row blocks (the TPU kernel pads them). Without a bias the port passes
    None and the JAX side zeros.

    bf16: 2e-2 on outputs of magnitude ~1 (h, g and o rounded to bf16 at the same points on
    both sides; the products sum in another order, which may move a bf16 rounding by an ulp).
    fp32: 2e-5, which covers the TPU kernel's rational erf (4e-7 absolute on gelu) times the
    Wo product's gain, and the summation order."""
    rng = np.random.default_rng(7)
    d, f = 128, 256
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x[5:9] = 0.0
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32) if with_bias else np.zeros(d, np.float32)
    wi = (0.08 * rng.standard_normal((d, 2 * f))).astype(np.float32)
    wo = (0.08 * rng.standard_normal((f, d))).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = _pallas_ln_ffn(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(wi), jnp.asarray(wo),
        eps=EPS, residual=True, block_rows=128, w8a8=False, w8a8_wo=False, interpret=True,
    )
    got = ops.fused_ln_ffn(_t(x, tdt), _t(scale), _t(bias) if with_bias else None, _t(wi.T), _t(wo.T), EPS)
    assert got.dtype == tdt and got.shape == (rows, d)
    assert float((got.float() - _t(x, tdt).float()).abs().max()) > 0.1  # the FFN's own part is there
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), atol=2e-5 if dtype == "float32" else 2e-2)
    if not with_bias:
        np.testing.assert_array_equal(_np(got)[5:9], x[5:9])  # a zero row gives a zero FFN: the residual


def _script(name):
    path = Path(__file__).resolve().parent.parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_{name}_under_test", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("form", ["bf16", "w8a8+w8a8_wo"])
def test_the_unfused_composition_yardstick_computes_the_ffn(form):
    """``chip_smoke.ffn_composition``, timed on the card beside rows 3 and 3qq as their library
    column, computes the function of the kernels' plain version. The int8 form rounds at the same
    points and its products are exact on both sides (``torch._int_mm`` against ``int8_matmul``), so it
    is bit-equal; the bf16 form's products are bf16 matmuls against the plain version's fp32 ones,
    which may move a rounding of h by an ulp: 2e-2 on outputs of magnitude ~1."""
    rng = np.random.default_rng(8)
    rows, d, f = 37, 128, 256
    x = _t(rng.standard_normal((rows, d)), torch.bfloat16)
    scale, bias = _t(rng.uniform(0.5, 1.5, d)), _t(0.1 * rng.standard_normal(d))
    wi = _t(0.08 * rng.standard_normal((2 * f, d)), torch.bfloat16)
    wo = _t(0.08 * rng.standard_normal((d, f)), torch.bfloat16)
    args = (x, scale, bias, wi, wo, EPS)
    if form == "bf16":
        got = _script("chip_smoke").ffn_composition(*args)
        want = ops.fused_ln_ffn_plain(*args)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)
    else:
        wi_q, wo_q = ops.quantize_weight_int8(wi), ops.quantize_weight_int8(wo)
        got = _script("chip_smoke").ffn_composition(*args, wi_q=wi_q, wo_q=wo_q)
        assert torch.equal(got, ops.fused_ln_ffn_plain(*args, w8a8=True, w8a8_wo=True, wi_q=wi_q, wo_q=wo_q))
    assert float((got.float() - x.float()).abs().max()) > 0.1  # the FFN's own part is there


@pytest.mark.parametrize("rows, d, f", [(323584, 768, 1152), (80896, 512, 1024), (49152, 256, 512)])
def test_ffn_bounds_count_what_the_forms_must_do(rows, d, f):
    """The bounds phase 7 and ``compare_kernels.py --phase ffn`` print for rows 3 and 3qq (ms on an H100
    SXM): 6 R D F operations at the bf16 rate, or at the int8 rate with both weights int8."""
    smoke = _script("chip_smoke")
    ms, by = smoke.ffn_bound_ms(rows, d, f)
    assert by == "operations" and ms == pytest.approx(1e3 * 6 * rows * d * f / 989e12)
    ms_q, by_q = smoke.ffn_q_bound_ms(rows, d, f, True, True)
    assert by_q == "operations" and ms_q == pytest.approx(1e3 * 6 * rows * d * f / 1979e12)


def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take():
    """No fallback: a shape or type the kernels do not take is an error, checked before any launch."""
    from cm3p_torch.ops.fused_ffn import _check_common, fused_ln_ffn_q
    from cm3p_torch.ops.fused_ln_matmul import _check

    x = torch.zeros(4, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        _check(x, torch.zeros(256, 128, dtype=torch.bfloat16), torch.bfloat16, None, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        _check_common(x, torch.ones(128), None, 128, 256)
    with pytest.raises(ValueError, match="w8a8"):
        fused_ln_ffn_q(x, torch.ones(128), None, None, torch.zeros(128, 256), EPS, w8a8=False, w8a8_wo=False)
