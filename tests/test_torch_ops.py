"""The port's plain ops against the JAX package's references on the CPU.

* window/segment attention (plain) vs ``flash_attention._xla_reference`` in
  fp32 with rope from ``modernbert.apply_rope``: atol 1e-5 on every query that
  sees at least one key (the reference spreads a fully masked query
  uniformly; the port writes 0 there, checked exactly);
* one bf16 case vs the Pallas ``flash_attention`` in interpret mode: atol 2e-2;
* ``fused_ln_ffn`` (plain) vs ``fused_ffn.reference_ln_ffn``: fp32 atol 1e-5,
  bf16 atol 2e-2 on outputs of magnitude ~1;
* the segment key-tile ranges vs ``_block_ranges``;
* ``apply_rope`` (the plain version of the forward kernels' rope pass, whose
  rotated tiles equal it bit for bit on the card) vs the JAX package's
  ``_apply_rope_xla``, which the Pallas route applies outside its kernels:
  fp32 atol 2e-5 (the tables' angles, position x inverse frequency up to 100
  rad here, are rounded at other places: one fp32 ulp at 100 is 7.6e-6), bf16
  atol 2e-2 (the JAX function multiplies in bf16, the port in fp32 with one
  rounding at the end).
"""
import functools

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cm3p_tpu.ops.flash_attention as fa
from cm3p_tpu.models.modernbert import apply_rope, rope_cos_sin
from cm3p_tpu.ops.fused_ffn import reference_ln_ffn
from cm3p_torch.ops import attention, fused_ln_ffn, fused_ln_ffn_plain, segment_attention, window_attention
from cm3p_torch.ops.attention import apply_rope as port_apply_rope
from cm3p_torch.ops.attention import segment_tile_ranges


def _inputs(b, length, heads, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, length, heads, d)).astype(np.float32) for _ in range(3)]


def _segs(kind, b, length, seed=0):
    """(qseg, kseg) as the dispatch of flash_attention() builds them."""
    rng = np.random.default_rng(seed + 1)
    if kind == "none":
        ones = np.ones((b, length), np.int32)
        return ones, ones
    if kind == "mask":
        mask = (rng.integers(0, 2, (b, length)) | (np.arange(length) < length // 2)).astype(np.int32)
        return np.ones((b, length), np.int32), mask
    seg = np.zeros((b, length), np.int32)
    for r in range(b):  # packed rows: 3 segments and a padding tail
        cuts = np.sort(rng.choice(np.arange(20, length - 20), 3, replace=False))
        seg[r, : cuts[0]], seg[r, cuts[0] : cuts[1]], seg[r, cuts[1] : cuts[2]] = 1, 2, 3
    return seg, seg


def _jax_reference(q, k, v, qseg, kseg, window, theta):
    b, length, heads, d = q.shape
    qj, kj = jnp.asarray(q), jnp.asarray(k)
    if theta is not None:
        cos, sin = rope_cos_sin(jnp.arange(length), d, theta)
        qj, kj = apply_rope(qj, kj, cos, sin)
    out = fa._xla_reference(
        qj.reshape(b, length, heads * d), kj.reshape(b, length, heads * d),
        jnp.asarray(v).reshape(b, length, heads * d),
        jnp.asarray(qseg), jnp.asarray(kseg), window, heads,
    )
    return np.asarray(out).reshape(b, length, heads, d)


def _visible(qseg, kseg, window):
    """(B, L) True where a query sees at least one key."""
    length = qseg.shape[1]
    idx = np.arange(length)
    ok = (kseg[:, None, :] > 0) & (qseg[:, :, None] == kseg[:, None, :])
    if window is not None:
        ok &= np.abs(idx[:, None] - idx[None, :])[None] <= window
    return ok.any(-1)


class TestAttentionPlain:
    @pytest.mark.parametrize("kind", ["none", "mask", "segments"])
    @pytest.mark.parametrize("window", [None, 64])
    @pytest.mark.parametrize("theta", [None, 10000.0])
    def test_matches_xla_reference(self, kind, window, theta):
        b, length, heads, d = 2, 200, 2, 64
        q, k, v = _inputs(b, length, heads, d)
        qseg, kseg = _segs(kind, b, length)
        expected = _jax_reference(q, k, v, qseg, kseg, window, theta)
        args = [torch.as_tensor(x) for x in (q, k, v, qseg, kseg)]
        if window is None:
            got = segment_attention(*args, rope_theta=theta).numpy()
        else:
            got = window_attention(*args, window, rope_theta=theta).numpy()
        vis = _visible(qseg, kseg, window)
        np.testing.assert_allclose(got[vis], expected[vis], atol=1e-5)
        assert np.all(got[~vis] == 0.0)

    @pytest.mark.parametrize("with_mask", [True, False])
    def test_dispatch_builds_segments_like_flash_attention(self, with_mask):
        """attention(): segment ids masked by the key mask; queries share them."""
        b, length, heads, d = 2, 150, 2, 16
        q, k, v = (torch.as_tensor(x) for x in _inputs(b, length, heads, d, seed=3))
        seg, _ = _segs("segments", b, length, seed=3)
        mask = np.ones((b, length), np.int32)
        mask[0, 10:30] = 0
        key_mask = torch.as_tensor(mask) if with_mask else None
        got = attention(q, k, v, key_mask, torch.as_tensor(seg), None, 160000.0)
        kseg = np.where(mask > 0, seg, 0) if with_mask else seg
        expected = _jax_reference(q.numpy(), k.numpy(), v.numpy(), kseg, kseg, None, 160000.0)
        vis = _visible(kseg, kseg, None)
        np.testing.assert_allclose(got.numpy()[vis], expected[vis], atol=1e-5)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    # the port keeps a running max; the Pallas kernels' fixed shift of 16
    # quantises bf16 scores near -16 to 1/16 in log2 units (~4 % per weight),
    # so they are compared in their running-max form (CM3P_FA_ONLINE_MAX=1)
    monkeypatch.setattr(fa, "ONLINE_MAX", True)


@pytest.mark.parametrize("window", [None, 64])
def test_matches_pallas_interpret_bf16(interpret_mode, window):
    """L = 256, H = 2, packed segments, in-kernel rope on both sides."""
    b, length, heads, d = 1, 256, 2, 64
    q, k, v = _inputs(b, length, heads, d, seed=5)
    seg, _ = _segs("segments", b, length, seed=5)
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    theta = 10000.0 if window else 160000.0
    expected = np.asarray(
        fa.flash_attention(qb, kb, vb, window=window, segment_ids=jnp.asarray(seg), rope_theta=theta),
        np.float32,
    )
    tq, tk, tv = (torch.as_tensor(np.array(x.astype(jnp.float32))).to(torch.bfloat16) for x in (qb, kb, vb))
    got = attention(tq, tk, tv, None, torch.as_tensor(seg), window, theta).float().numpy()
    vis = _visible(seg, seg, window)
    np.testing.assert_allclose(got[vis], expected[vis], atol=2e-2)


class TestFusedFFN:
    def _params(self, d=64, f=96, seed=0):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((3, 37, d)).astype(np.float32) * 2.0
        scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
        bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
        wi = (0.05 * rng.standard_normal((d, 2 * f))).astype(np.float32)  # JAX layout (D, 2F)
        wo = (0.05 * rng.standard_normal((f, d))).astype(np.float32)  # JAX layout (F, D)
        return x, scale, bias, wi, wo

    @pytest.mark.parametrize("with_bias", [True, False])
    def test_fp32_matches_reference(self, with_bias):
        x, scale, bias, wi, wo = self._params()
        bias = bias if with_bias else None
        expected = np.asarray(reference_ln_ffn(
            jnp.asarray(x), jnp.asarray(scale), None if bias is None else jnp.asarray(bias),
            jnp.asarray(wi), jnp.asarray(wo), eps=1e-5,
        ))
        got = fused_ln_ffn(
            torch.as_tensor(x), torch.as_tensor(scale), None if bias is None else torch.as_tensor(bias),
            torch.as_tensor(wi.T.copy()), torch.as_tensor(wo.T.copy()), 1e-5,
        ).numpy()
        np.testing.assert_allclose(got, expected, atol=1e-5)

    def test_bf16_matches_reference(self):
        x, scale, bias, wi, wo = self._params(seed=1)
        xb = jnp.asarray(x * 0.25, jnp.bfloat16)  # outputs of magnitude ~1: a bf16 ulp < 2e-2
        expected = np.asarray(reference_ln_ffn(
            xb, jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(wi), jnp.asarray(wo), eps=1e-5,
        ), np.float32)
        got = fused_ln_ffn(
            torch.as_tensor(np.array(xb.astype(jnp.float32))).to(torch.bfloat16),
            torch.as_tensor(scale), torch.as_tensor(bias),
            torch.as_tensor(wi.T.copy()).to(torch.bfloat16), torch.as_tensor(wo.T.copy()).to(torch.bfloat16), 1e-5,
        )
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), expected, atol=2e-2)

    def test_wrapper_on_cpu_is_the_plain_version(self):
        x, scale, bias, wi, wo = (torch.as_tensor(a) for a in self._params(seed=2))
        a = fused_ln_ffn(x, scale, bias, wi.T.contiguous(), wo.T.contiguous(), 1e-5)
        b = fused_ln_ffn_plain(x, scale, bias, wi.T.contiguous(), wo.T.contiguous(), 1e-5)
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["segments", "mask", "none"])
@pytest.mark.parametrize("length", [256, 300])
def test_segment_tile_ranges_match_block_ranges(kind, length):
    b, tile = 3, 64
    qseg, kseg = _segs(kind, b, length, seed=length)
    if kind == "segments":
        kseg = qseg = qseg.copy()
        qseg[2] = 0  # an all-padding row visits nothing
    start, count = segment_tile_ranges(torch.as_tensor(qseg), torch.as_tensor(kseg), tile)
    n = -(-length // tile)
    pad = n * tile - length
    qp = jnp.pad(jnp.asarray(qseg), ((0, 0), (0, pad)))
    kp = jnp.pad(jnp.asarray(kseg), ((0, 0), (0, pad)))
    js, jc = fa._block_ranges(b, n, n, n, tile, tile, None, qp, kp)
    np.testing.assert_array_equal(count.numpy(), np.asarray(jc))
    live = np.asarray(jc) > 0
    np.testing.assert_array_equal(start.numpy()[live], np.asarray(js)[live])


@pytest.mark.parametrize("theta", [10000.0, 160000.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_pass_matches_the_jax_rope(theta, dtype):
    b, length, heads, d = 2, 100, 3, 64
    x = np.random.default_rng(3).standard_normal((b, length, heads, d)).astype(np.float32)
    want = fa._apply_rope_xla(jnp.asarray(x, dtype).reshape(b, length, heads * d), theta, d)
    want = np.asarray(want.astype(jnp.float32)).reshape(b, length, heads, d)
    got = port_apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)), theta).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 if dtype == "float32" else 2e-2)
