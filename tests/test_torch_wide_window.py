"""Windows wider than 128 on each side: the port against the JAX package's
streaming route on the CPU.

At its 128-row blocks the JAX dispatcher sends a window w with
``cdiv(128 + 2w, 128) + 1 > 4`` (w > 128) to the streaming kernels:
``_fa_kernel`` forward and the ``_dq_kernel`` / ``_dkv_kernel`` backward. The
port has no separate kernel for them: its window kernels visit every key tile
that meets [q0 - w, q0 + 63 + w], whatever w, so the same wrappers run. Here
the port's window attention (the plain versions, what the wrappers run on CPU
tensors) is held at w = 192, L = 1024, H = 2 against those JAX kernels in
interpret mode, with a key mask and with packed segments:

* the forward with lse and the backward of ``attention()`` under autograd
  against ``_flash_attention_fwd_impl(..., return_lse=True)`` and ``jax.grad``
  of ``flash_attention()``. fp32: 2e-5 abs on outputs and lse, 2e-4 of each
  gradient's largest entry. bf16: the streaming kernel runs its softmax chain
  in bf16 (``_acc_t``), so its own outputs lie up to 1e-2 of the largest entry
  from the exact ones; the port is held to float64 autograd at 1e-2 of the
  largest entry (outputs and gradients) and 1e-3 (lse), and to the JAX
  kernels at ``BF16_JAX_TOL``. Queries that see no key give 0 and the lse
  ``log2(1e-30)``;
* a tiny encoder with ``local_attention = 384`` (one global, one local layer,
  head dim 64), fp32: hidden states and every parameter gradient against the
  JAX encoder on its flash route (2e-4 of the largest entry).
"""
import functools
import math

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cm3p_tpu.ops.flash_attention as fa
import cm3p_tpu.ops.flash_attention_bwd as fab
from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.models.modernbert import ModernBertEncoder as JaxEncoder
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.interop import encoder_state_dict_from_jax
from cm3p_torch.models import ModernBertEncoder
from cm3p_torch.ops.attention import EMPTY_LSE, attention, window_attention_plain

B, L, H, D = 2, 1024, 2, 64
WINDOW = 192
BLOCK = 128  # the JAX dispatcher's block for window layers
BWD_TOL = 1e-2
# bf16 against the JAX streaming kernels, whose softmax chain runs in bf16: their own outputs lie up to
# 1.0e-2 of the largest entry from float64, their lse up to 1.9e-2 (abs), their gradients up to 7.7e-3 (the
# port's: 2.7e-3, 1.2e-6, 4.0e-3); so outputs 2e-2 and gradients 1e-2 of the largest entry, lse 3e-2 abs
BF16_JAX_TOL = {"out": 2e-2, "lse": 3e-2, "grad": 1e-2}


@pytest.fixture
def streaming_route(monkeypatch):
    """Interpret mode, and the window-fused route of both directions made to fail."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(fa, "ONLINE_MAX", True)  # the port's running max on the global layers (ROADMAP Queue 3)

    def refuse(*args, **kwargs):
        raise AssertionError("the window-fused route ran")

    monkeypatch.setattr(fa, "_window_fused_fwd", refuse)
    monkeypatch.setattr(fab, "_window_fused_bwd", refuse)


def test_the_jax_dispatcher_streams_this_window():
    assert not -(-(BLOCK + 2 * WINDOW) // BLOCK) + 1 <= 4  # flash_attention.py's fused-route condition
    assert -(-(BLOCK + 2 * 64) // BLOCK) + 1 <= 4  # the shipped w = 64 takes the fused route
    assert not -(-(BLOCK + 2 * 256) // BLOCK) + 1 <= 4


def _case(kind, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4))
    if kind == "key_mask":
        mask = np.ones((B, L), np.int32)
        mask[1, 700:] = 0
        return q, k, v, g, dict(key_mask=mask), np.ones((B, L), np.int32), mask
    seg = np.zeros((B, L), np.int32)
    seg[0, :300], seg[0, 300:750], seg[0, 750:980] = 1, 2, 3  # packed windows and a padding tail
    seg[1, :600] = 1
    return q, k, v, g, dict(segment_ids=seg), seg, seg


def _visible(qseg, kseg):
    """(B, 1, L, L): key j visible to query i."""
    idx = torch.arange(L)
    vis = torch.as_tensor(qseg)[:, None, :, None] == torch.as_tensor(kseg)[:, None, None, :]
    return vis & (torch.as_tensor(kseg)[:, None, None, :] > 0) & ((idx[:, None] - idx[None, :]).abs() <= WINDOW)


def _exact(q, k, v, g, qseg, kseg):
    """float64 output, base-2 lse and gradients (0 for a query that sees no key)."""
    leaves = [torch.as_tensor(x).double().requires_grad_() for x in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) / math.sqrt(D)
    vis = _visible(qseg, kseg)
    s = s.masked_fill(~vis, -1e300)
    lse2 = torch.logsumexp(s, dim=-1) / math.log(2.0)
    p = torch.softmax(s, dim=-1) * vis.any(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, leaves[2])
    grads = torch.autograd.grad(out, leaves, torch.as_tensor(g).double())
    return out.detach().numpy(), lse2.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["key_mask", "segments"])
def test_wide_window_matches_the_jax_streaming_kernels(streaming_route, kind, dtype):
    q, k, v, g, masks, qseg, kseg = _case(kind)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    jmasks = {name: jnp.asarray(x) for name, x in masks.items()}

    flat = [x.reshape(B, L, H * D) for x in (jq, jk, jv)]
    want_out, want_lse = fa._flash_attention_fwd_impl(
        *flat, jnp.asarray(qseg), jnp.asarray(kseg), WINDOW, BLOCK, BLOCK, H, return_lse=True
    )
    want_out = np.asarray(want_out, np.float32).reshape(B, L, H, D)
    want_lse = np.asarray(want_lse, np.float32)[:, :H, :L]

    def loss(q_, k_, v_):
        out = fa.flash_attention(q_, k_, v_, window=WINDOW, **jmasks)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want_grads = [np.asarray(x, np.float32) for x in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]

    tq, tk, tv, tg = (torch.as_tensor(x).to(tdt) for x in (q, k, v, g))
    out, lse = window_attention_plain(tq, tk, tv, torch.as_tensor(qseg), torch.as_tensor(kseg), WINDOW,
                                      return_lse=True)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    routed = attention(*leaves, window=WINDOW, **{n: torch.as_tensor(x) for n, x in masks.items()})
    assert torch.equal(routed, out)
    grads = [x.float().numpy() for x in torch.autograd.grad(routed, leaves, tg)]
    out, lse = out.float().numpy(), lse.numpy()

    live = _visible(qseg, kseg).any(-1)[:, 0].numpy()  # queries that see a key
    live_lse = live[:, None, :].repeat(H, 1)
    assert not live.all()
    if dtype == "float32":
        np.testing.assert_allclose(out[live], want_out[live], atol=2e-5)
        np.testing.assert_allclose(lse[live_lse], want_lse[live_lse], atol=2e-5)
        for name, a, b in zip("qkv", grads, want_grads):
            np.testing.assert_allclose(a, b, atol=2e-4 * np.abs(b).max(), err_msg=name)
    else:
        e_out, e_lse, e_grads = _exact(*(x.float().numpy() for x in (tq, tk, tv, tg)), qseg, kseg)
        assert np.abs(out - e_out).max() <= BWD_TOL * np.abs(e_out).max()
        assert np.abs(out[live] - want_out[live]).max() <= BF16_JAX_TOL["out"] * np.abs(want_out).max()
        assert np.abs(lse[live_lse] - e_lse[live_lse]).max() <= 1e-3
        assert np.abs(lse[live_lse] - want_lse[live_lse]).max() <= BF16_JAX_TOL["lse"]
        for name, a, b, e in zip("qkv", grads, want_grads, e_grads):
            assert np.abs(a - e).max() <= BWD_TOL * np.abs(e).max(), name
            assert np.abs(a - b).max() <= BF16_JAX_TOL["grad"] * np.abs(b).max(), name
    assert np.abs(out[~live]).max() == 0.0 and np.abs(grads[0][~live]).max() == 0.0
    assert (lse[~live_lse] == np.float32(EMPTY_LSE)).all()


def test_encoder_with_a_wide_window_matches_the_jax_encoder(streaming_route):
    """One global and one local layer (``local_attention`` 384: w = 192), head dim 64, fp32."""
    cfgs = []
    for make in (jax_tiny_config, tiny_cm3p_config):
        bc = make().beatmap_config
        bc.hidden_size, bc.num_attention_heads, bc.num_hidden_layers = 128, 2, 2
        bc.global_attn_every_n_layers, bc.local_attention = 2, 2 * WINDOW
        cfgs.append(bc)
    rng = np.random.default_rng(3)
    ids = rng.integers(10, 500, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 800:] = 0
    jenc = JaxEncoder(cfgs[0], dtype=jnp.float32, attn_impl="pallas")  # the flash route from 512 tokens on
    kw = dict(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(2), **kw))
    g = rng.standard_normal((B, L, 128)).astype(np.float32) * mask[:, :, None]

    def loss(p):
        return jnp.sum(jenc.apply(p, **kw) * jnp.asarray(g))

    want_hidden = np.asarray(jenc.apply(params, **kw))
    want_grads = encoder_state_dict_from_jax(jax.tree.map(np.asarray, jax.grad(loss)(params)["params"]))

    enc = ModernBertEncoder(cfgs[1])
    enc.load_state_dict(encoder_state_dict_from_jax(params["params"]))
    hidden = enc(input_ids=torch.as_tensor(ids, dtype=torch.int64), attention_mask=torch.as_tensor(mask))
    names = [n for n, _ in enc.named_parameters()]
    grads = torch.autograd.grad((hidden * torch.as_tensor(g)).sum(), list(enc.parameters()))
    valid = mask > 0
    np.testing.assert_allclose(hidden.detach().numpy()[valid], want_hidden[valid], atol=2e-4 * np.abs(want_hidden).max())
    for name, got in zip(names, grads):
        want = want_grads[name].numpy()
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4 * max(np.abs(want).max(), 1e-12), err_msg=name)
