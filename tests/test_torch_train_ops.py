"""The port's training operations against the JAX package on the CPU.

Same numpy inputs through both, fp32:

* attention: the plain forward with lse and the plain backward (what the CUDA
  kernels are held against on the card) against the JAX ``flash_attention``
  forward-with-lse and backward kernels run in Pallas interpret mode, window
  64 and segment, with padding. Tolerance 2e-4 abs on values of magnitude ~1
  (fp32 sums in another order; the TPU kernels shift scores by a fixed power
  of two instead of a running max);
* the attention ``autograd.Function`` against torch autograd through the
  plain forward (1e-5: the same fp32 arithmetic, rearranged);
* the FFN ``autograd.Function`` against ``jax.vjp`` of ``fused_ln_ffn``
  (1e-4 relative to each gradient's scale);
* ``cm3p_loss`` 2-D and 3-D, with and without ``valid`` (1e-5);
* ``get_metadata_features`` with ``meta_pack`` against 0 and against the JAX
  module (cosine >= 0.99999);
* Muon + AdamW: two steps of the port's optimizer against
  ``cm3p_tpu.train.muon.muon`` on the tiny model's mapped parameters
  (routing, flax orientation, momentum, bias correction), with NS5 run in
  fp32 on both sides so that the comparison is tight (1e-4 of each update's
  largest entry). NS5 in bf16 amplifies rounding: the two frameworks' bf16
  results on the same input differ by up to 30 % elementwise, so the bf16
  functions are held to each other by cosine >= 0.99 and to the quintic's
  singular-value band.
"""
import functools
import importlib

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cm3p_tpu.ops.flash_attention as fa
from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.models import CM3PModule
from cm3p_tpu.models.cm3p import cm3p_loss as jax_cm3p_loss
from cm3p_tpu.ops.fused_ffn import fused_ln_ffn as jax_fused_ln_ffn
from cm3p_tpu.train.muon import muon as jax_muon
from cm3p_tpu.train.muon import zeropower_via_newtonschulz5 as jax_ns5
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.interop import state_dict_from_jax
from cm3p_torch.models import CM3PModel, cm3p_loss
from cm3p_torch.ops.attention import (
    AttentionFunction,
    attention,
    attention_bwd,
    segment_attention_plain,
    window_attention_plain,
)
from cm3p_torch.ops.fused_ffn import LnFfnFunction
from cm3p_torch.train.muon import NS_COEFFS, MuonAdamW, flax_layouts, zeropower_via_newtonschulz5

B, L, H, D = 2, 256, 2, 64
# the packages re-export a function named ``muon``, which shadows the module attribute
jax_muon_module = importlib.import_module("cm3p_tpu.train.muon")
muon_module = importlib.import_module("cm3p_torch.train.muon")


def _segments():
    seg = np.zeros((B, L), np.int32)
    seg[0, :100], seg[0, 100:200] = 1, 2  # two segments, padding tail
    seg[1, :180] = 1
    return seg


def _qkvg(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def jax_attention():
    """JAX forward (out, lse) and (dq, dk, dv) per window, interpret mode."""
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        q, k, v, g = _qkvg()
        seg = jnp.asarray(_segments())
        flat = [jnp.asarray(x.reshape(B, L, H * D)) for x in (q, k, v, g)]
        results = {}
        for window in (64, None):
            out, res = fa._fwd(*flat[:3], seg, seg, window, 128, 128, H, None)
            dq, dk, dv, _, _ = fa._bwd(window, 128, 128, H, None, res, flat[3])
            results[window] = [np.asarray(x) for x in (out, res[-1], dq, dk, dv)]
    finally:
        pl.pallas_call = orig
    return results


def _t(x):
    return torch.as_tensor(x)


@pytest.mark.parametrize("window", [64, None], ids=["window", "segment"])
def test_plain_lse_and_backward_match_the_jax_kernels(jax_attention, window):
    out_j, lse_j, dq_j, dk_j, dv_j = jax_attention[window]
    q, k, v, g = (_t(x) for x in _qkvg())
    seg = _t(_segments())
    if window is None:
        out, lse = segment_attention_plain(q, k, v, seg, seg, return_lse=True)
    else:
        out, lse = window_attention_plain(q, k, v, seg, seg, window, return_lse=True)
    dq, dk, dv = attention_bwd(q, k, v, out, g, lse, seg, seg, window)
    live = _segments() > 0
    np.testing.assert_allclose(out.numpy()[live], out_j.reshape(B, L, H, D)[live], atol=2e-5)
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[live], lse_j.transpose(0, 2, 1)[live], atol=2e-5)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        np.testing.assert_allclose(got.numpy()[live], want.reshape(B, L, H, D)[live], atol=2e-4, rtol=1e-4)
    assert float(dq.numpy()[~live].__abs__().max()) == 0.0  # queries that see no key
    assert float(dk.numpy()[~live].__abs__().max()) == 0.0  # keys no query sees


@pytest.mark.parametrize("window", [16, None], ids=["window", "segment"])
def test_attention_function_matches_autograd_of_the_plain_forward(window):
    q, k, v, g = (_t(x).requires_grad_() for x in _qkvg(1))
    seg = _t(_segments())
    plain = window_attention_plain if window else segment_attention_plain
    args = (seg, seg, window) if window else (seg, seg)
    want = torch.autograd.grad(plain(q, k, v, *args), (q, k, v), g.detach())
    got = torch.autograd.grad(AttentionFunction.apply(q, k, v, seg, seg, window, False), (q, k, v), g.detach())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_training_dispatch_rotates_outside_and_counter_rotates():
    """``attention()`` under autograd (rope outside, lse, backward) == autograd
    through the plain forward with in-function rope."""
    q, k, v, g = (_t(x).requires_grad_() for x in _qkvg(2))
    seg = _t(_segments())
    mask = (seg > 0).to(torch.int32)
    out = attention(q, k, v, key_mask=mask, segment_ids=seg, window=16, rope_theta=10000.0)
    got = torch.autograd.grad(out, (q, k, v), g.detach())
    ref = window_attention_plain(q, k, v, seg, seg, 16, rope_theta=10000.0)
    want = torch.autograd.grad(ref, (q, k, v), g.detach())
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_ffn_backward_matches_jax_vjp():
    """fp32: 1e-4 of the largest entry. bf16 activations with fp32 master weights:
    the weight gradients are fp32 products of bf16 operands (not rounded to
    bf16), as ``_ln_ffn_bwd`` asks; 1e-2 of the largest entry, since an
    operand that rounds to the other bf16 neighbour in one framework moves a
    sum by 2^-9 of one summand."""
    for dtype in ("float32", "bfloat16"):
        _check_ffn_backward(dtype)


def _check_ffn_backward(dtype):
    rng = np.random.default_rng(3)
    rows, d, f = 37, 64, 96
    x = rng.standard_normal((rows, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    wi = (0.1 * rng.standard_normal((d, 2 * f))).astype(np.float32)  # flax (in, out)
    wo = (0.1 * rng.standard_normal((f, d))).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    out_j, vjp = jax.vjp(
        lambda x_, s_, wi_, wo_: jax_fused_ln_ffn(x_, s_, None, wi_, wo_, eps=1e-5),
        jnp.asarray(x, jdt), *(jnp.asarray(a) for a in (scale, wi, wo)),
    )
    dx_j, ds_j, dwi_j, dwo_j = (np.asarray(a, np.float32) for a in vjp(jnp.asarray(g, jdt)))
    xt, st = _t(x).to(tdt).requires_grad_(), _t(scale).requires_grad_()
    wit, wot = _t(wi.T.copy()).requires_grad_(), _t(wo.T.copy()).requires_grad_()
    out = LnFfnFunction.apply(xt, st, None, wit, wot, 1e-5)
    dx, ds, dwi, dwo = torch.autograd.grad(out, (xt, st, wit, wot), _t(g).to(tdt))
    assert dwi.dtype == torch.float32 and dwo.dtype == torch.float32 and dx.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(out.detach().float().numpy(), np.asarray(out_j, np.float32),
                               atol=1e-5 if dtype == "float32" else 2e-2)
    for got, want in ((dx, dx_j), (ds, ds_j), (dwi, dwi_j.T), (dwo, dwo_j.T)):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol * np.abs(want).max())
    if dtype == "bfloat16":
        for grad in (dwi, dwo):  # fp32 sums, not bf16 values: almost none is representable in bf16
            assert (grad.bfloat16().float() != grad).float().mean() > 0.9


@pytest.mark.parametrize("shape", ["2d", "3d"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_cm3p_loss_matches(shape, with_valid):
    rng = np.random.default_rng(4)
    sim = (5 * rng.standard_normal((6, 6) if shape == "2d" else (6, 3, 6))).astype(np.float32)
    classes = None
    if shape == "3d":
        classes = np.tile(np.array([[1, 0, 2]], np.int32), (6, 1))
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32) if with_valid else None
    want = float(jax_cm3p_loss(
        jnp.asarray(sim), None if classes is None else jnp.asarray(classes),
        valid=None if valid is None else jnp.asarray(valid),
    ))
    got = float(cm3p_loss(_t(sim), None if classes is None else _t(classes), valid=None if valid is None else _t(valid)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


def _tiny_pair(meta_pack):
    jcfg, tcfg = jax_tiny_config(), tiny_cm3p_config()
    return CM3PModule(jcfg, dtype=jnp.float32, attn_impl="xla", meta_pack=meta_pack), CM3PModel(tcfg, meta_pack)


@pytest.fixture(scope="module")
def tiny_params():
    """JAX params of the whole tiny model (both towers, audio included)."""
    jmodel, _ = _tiny_pair(0)
    rng = np.random.default_rng(5)
    ids = rng.integers(10, 500, (2, 64)).astype(np.int32)
    meta = rng.integers(3, 250, (2, 3, 10)).astype(np.int32)
    feats = rng.standard_normal((2, 80, 64)).astype(np.float32)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(ids), input_features=jnp.asarray(feats),
                                  metadata_ids=jnp.asarray(meta))
    return jax.tree.map(np.asarray, params)


def _metadata(rng, n=5, v=3, length=12):
    ids = rng.integers(3, 250, (n, v, length)).astype(np.int32)
    mask = np.ones((n, v, length), np.int32)
    for i in range(n):
        for j in range(v):
            mask[i, j, rng.integers(4, length + 1):] = 0  # ragged, pad tails
    return ids, mask


def test_meta_pack_matches_unpacked_and_the_jax_module(tiny_params):
    ids, mask = _metadata(np.random.default_rng(6))
    sd = state_dict_from_jax(tiny_params)
    feats = {}
    for g in (0, 4, 16):
        jmodel, tmodel = _tiny_pair(g)
        tmodel.load_state_dict(sd)
        with torch.no_grad():
            feats[g] = tmodel.get_metadata_features(_t(ids).long(), _t(mask), normalize=True).numpy()
        features = jax.jit(functools.partial(jmodel.apply, normalize=True, method=CM3PModule.get_metadata_features))
        want = np.asarray(features(tiny_params, jnp.asarray(ids), jnp.asarray(mask)))
        cos = (feats[g] * want).sum(-1)
        assert cos.min() >= 0.99999, (g, cos.min())
    np.testing.assert_allclose(feats[16], feats[0], atol=2e-5)
    np.testing.assert_allclose(feats[4], feats[0], atol=2e-5)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflat(items):
    out = {}
    for path, v in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _ns5_f32_jax(g, steps=6, eps=1e-7):
    a, b, c = NS_COEFFS
    x = g.astype(jnp.float32)
    x = x / (jnp.linalg.norm(x) + eps)
    transpose = g.shape[0] > g.shape[1]
    x = x.T if transpose else x
    for _ in range(steps):
        xxt = x @ x.T
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return x.T if transpose else x


def _ns5_f32_torch(g, steps=6, eps=1e-7):
    a, b, c = NS_COEFFS
    x = g.float()
    x = x / (torch.linalg.vector_norm(x) + eps)
    transpose = g.shape[0] > g.shape[1]
    x = x.t() if transpose else x
    for _ in range(steps):
        xxt = x @ x.t()
        x = a * x + (b * xxt + c * (xxt @ xxt)) @ x
    return x.t() if transpose else x


@pytest.mark.parametrize("shape", [(3, 2560), (64, 192), (192, 64), (32, 32)])
def test_bf16_newton_schulz_agrees_with_the_jax_package(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_ns5(jnp.asarray(x)).astype(jnp.float32))
    got = zeropower_via_newtonschulz5(torch.as_tensor(x))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    cos = (got * want).sum() / np.linalg.norm(got) / np.linalg.norm(want)
    assert cos >= 0.99, cos
    sv = np.linalg.svd(got, compute_uv=False)
    assert 0.5 <= sv.min() and sv.max() <= 1.3, sv


def test_muon_adamw_steps_match_the_jax_optimizer(tiny_params, monkeypatch):
    monkeypatch.setattr(jax_muon_module, "zeropower_via_newtonschulz5", _ns5_f32_jax)
    monkeypatch.setattr(muon_module, "zeropower_via_newtonschulz5", _ns5_f32_torch)
    rng = np.random.default_rng(7)
    leaves = list(_flat(tiny_params["params"]))
    grads = [_unflat((p, (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)) for p, v in leaves)
             for _ in range(2)]
    lr = 1e-2
    tx = jax_muon(optax.linear_schedule(lr, 0.0, 10), adamw_lr_ratio=0.25, adamw_betas=(0.9, 0.999))
    params = jax.tree.map(jnp.asarray, tiny_params["params"])
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, params)})

    _, model = _tiny_pair(0)
    start = state_dict_from_jax(tiny_params)
    model.load_state_dict(start)
    opt = MuonAdamW(model.named_parameters(), flax_layouts(model),
                    lambda t: lr * (1 - min(t, 10) / 10), adamw_lr_ratio=0.25, adamw_betas=(0.9, 0.999))
    named = dict(model.named_parameters())
    for g in grads:
        for name, gt in state_dict_from_jax({"params": g}).items():
            named[name].grad = gt.clone()
        opt.step()
    labels = opt.labels()
    assert labels["beatmap_model.encoder.layers.1.attn.Wqkv.weight"] == "muon"
    assert labels["beatmap_model.audio_encoder.conv1.weight"] == "muon"
    assert labels["beatmap_model.encoder.embeddings.tok_embeddings.weight"] == "adamw"
    assert labels["logit_scale"] == "adamw"
    assert labels["metadata_projection.weight"] == "muon"
    for name, p in model.named_parameters():
        got = (p.detach() - start[name]).numpy()
        ref = (want[name] - start[name]).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max(), err_msg=name)


def test_params_without_grad_take_no_update():
    _, model = _tiny_pair(0)
    opt = MuonAdamW(model.named_parameters(), flax_layouts(model), lambda t: 1e-2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    w = model.metadata_projection.weight
    w.grad = torch.ones_like(w)
    opt.step()
    for name, p in model.named_parameters():
        changed = not torch.equal(p.detach(), before[name])
        assert changed == (name == "metadata_projection.weight"), name
    assert not any("momentum" in opt.state[p] for p in model.parameters() if p is not w)
