"""Rope inside the attention kernels under autograd (the JAX package's
``CM3P_TRAIN_FUSED_ROPE``) against the JAX package on the CPU.

* The plain rope backward (``attention_bwd_rope_plain``: what the rope forms of
  the four backward kernels are held against on the card) against
  ``flash_attention_bwd(..., rope_theta=...)`` with its Pallas kernels in
  interpret mode (in-kernel rope on the window-fused and global-unrolled
  routes), window 64 and packed segments, bf16 at theta 10k and 160k (and
  the window in fp32 at 10k), the same raw q/k/v, dout, out
  and lse given to both; in bf16 also against float64 autograd. Tolerances
  (``JAX_TOL``, ``BWD_TOL``) of each gradient's largest entry, and dq exactly 0
  on queries that see no key.
* The arithmetic of the rope forms on the card, where one rope pass per
  backward call feeds both kernels (q and k rotated once with the forward's
  rope, the backward without rope, dq and dk counter-rotated), against the
  same JAX backward in interpret mode, window and segment, fp32
  (``JAX_TOL["float32"]``), and dq exactly 0 on queries that see no key.
* ``attention()`` under autograd, rope inside the kernels (its training route)
  against rope outside (q/k rotated first, and the ``plain`` route): the same
  gradients (fp32: 1e-5; bf16: 1e-2 of the largest entry, the two routes
  round dq/dk once and twice); the rope route runs only where
  ``rope_in_kernels`` admits the layer.
* One ``forward_packed`` step (rope inside the kernels) against the JAX
  ``make_train_step``: in bf16 with ``TRAIN_FUSED_ROPE`` patched on and its
  flash route in interpret mode (rows of 512 tokens: the JAX encoder takes its
  Pallas route from 512 on), at head dim 64 with 2 heads so that both packages
  take the rope route, and the metadata tower on the outside route in both
  (its ``meta_pack`` rows restart positions); in fp32 against the JAX XLA path
  (its gate declines fp32), where the port still takes the rope route.
  Tolerances (``LOSS_REL_TOL``, ``GRAD_COS_MIN``): bf16 loss 5e-3 relative and
  per-tensor gradient cosine >= 0.999 (each side rounds at its own places);
  fp32 as ``tests/test_torch_train.py`` holds it (loss 1e-5 relative, each
  gradient 2e-4 of its largest entry).
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
from cm3p_tpu.data.packing_collator import packed_batches as jax_packed_batches
from cm3p_tpu.models import CM3PModule
from cm3p_tpu.ops.flash_attention_bwd import flash_attention_bwd
from cm3p_tpu.train.train_state import TrainState, make_train_step
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.data import packed_batches
from cm3p_torch.interop import state_dict_from_jax
from cm3p_torch.models import CM3PModel
from cm3p_torch.ops.attention import (
    attention,
    attention_bwd,
    attention_bwd_rope_plain,
    attention_delta,
    apply_rope,
    rope_in_kernels,
    segment_attention_plain,
    window_attention_plain,
)
from cm3p_torch.train import TrainStep, to_device

attention_mod = importlib.import_module("cm3p_torch.ops.attention")

B, L, H, D = 2, 256, 4, 64
BWD_TOL = 1e-2
# the loss: fp32 as tests/test_torch_train.py; bf16 at 5e-3, about 1.5x the largest of the readings of this step at
# seeds 0-4 (3.19e-3, 1.56e-3, 2.38e-3, 2.88e-3, 1.52e-3 relative: the two packages round bf16 at their own places);
# the gradients' per-tensor cosines read >= 0.99984 there
LOSS_REL_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
GRAD_COS_MIN = 0.999


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(fa, "ONLINE_MAX", True)  # the port's running max (ROADMAP Queue 3)


def _segments():
    seg = np.zeros((B, L), np.int32)
    seg[0, :90], seg[0, 90:200], seg[0, 200:230] = 1, 2, 3  # packed windows and a padding tail
    seg[1, :170] = 1
    return seg


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(4)]


class RopeBackwardCalls:
    """Counts the calls of the plain rope backward (what the backward wrappers
    run on CPU tensors when the rope forms are asked for)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        orig = attention_mod.attention_bwd_rope_plain

        def counted(*args, **kwargs):
            self.calls += 1
            return orig(*args, **kwargs)

        monkeypatch.setattr(attention_mod, "attention_bwd_rope_plain", counted)


def _exact_grads(q, k, v, g, seg, window, theta):
    """float64 autograd through rope and masked softmax attention: the exact
    gradients of the rounded inputs (0 for a query that sees no key)."""
    cos, sin = (t.double()[:, None, :] for t in attention_mod.rope_tables(L, D, theta, "cpu"))

    def rotate(x):
        x1, x2 = x[..., : D // 2], x[..., D // 2 :]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    leaves = [x.double().requires_grad_() for x in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", rotate(leaves[0]), rotate(leaves[1])) / D**0.5
    vis = (seg[:, None, :, None] == seg[:, None, None, :]) & (seg[:, None, None, :] > 0)
    if window is not None:
        idx = torch.arange(L)
        vis = vis & ((idx[:, None] - idx[None, :]).abs() <= window)
    p = torch.softmax(s.masked_fill(~vis, -1e300), dim=-1) * vis.any(-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p, leaves[2])
    return [x.numpy() for x in torch.autograd.grad(out, leaves, g.double())]


# bf16: the JAX kernels rotate q with bf16 tables that carry the score scale,
# so their own gradients lie up to 1.8e-2 of the largest entry from the exact
# ones at these inputs (the port's up to 7.7e-3); the port is held to the exact
# gradients at 1e-2 and to the JAX kernels at 2e-2. fp32: the same comparison
# without bf16 rounding, 1e-4 of the largest entry.
JAX_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("window, dtype, theta", [
    (64, "float32", 10000.0),  # in fp32 the JAX package keeps rope in its kernels on the window route only
    (64, "bfloat16", 10000.0), (64, "bfloat16", 160000.0), (None, "bfloat16", 10000.0), (None, "bfloat16", 160000.0),
], ids=["window-fp32-theta10k", "window-bf16-theta10k", "window-bf16-theta160k", "segment-bf16-theta10k",
        "segment-bf16-theta160k"])
def test_plain_rope_backward_matches_the_jax_rope_kernels(interpret_mode, window, theta, dtype):
    q, k, v, g = (torch.as_tensor(x).to(getattr(torch, dtype)) for x in _inputs(0))
    seg = torch.as_tensor(_segments())
    plain = window_attention_plain if window else segment_attention_plain
    out, lse = plain(q, k, v, seg, seg, *((window,) if window else ()), rope_theta=theta, return_lse=True)
    delta = attention_delta(out, g)
    got = attention_bwd_rope_plain(q, k, v, g, lse, delta, seg, seg, window, theta)
    assert all(torch.equal(a, b) for a, b in zip(
        got, attention_bwd(q, k, v, out, g, lse, seg, seg, window, plain=True, rope_theta=theta)))

    jdt = getattr(jnp, dtype)
    flat = [jnp.asarray(x.float().reshape(B, L, H * D).numpy(), jdt) for x in (q, k, v, out, g)]
    jseg = jnp.asarray(_segments())
    block = 128 if window else 256  # the dispatcher's blocks at L = 256
    want = flash_attention_bwd(
        flat[0], flat[1], flat[2], jseg, jseg, flat[3], jnp.asarray(lse.numpy()), flat[4], window, block, block, H,
        rope_theta=theta,
    )
    exact = _exact_grads(q, k, v, g, seg, window, theta)
    for name, a, b, e in zip("qkv", got, want, exact):
        a = a.float().numpy()
        b = np.asarray(b, np.float32).reshape(B, L, H, D)
        assert np.abs(a - b).max() <= JAX_TOL[dtype] * np.abs(b).max(), (name, np.abs(a - b).max(), np.abs(b).max())
        if dtype == "bfloat16":
            assert np.abs(a - e).max() <= BWD_TOL * np.abs(e).max(), (name, np.abs(a - e).max(), np.abs(e).max())
    dead = _segments() == 0
    assert float(got[0].float().numpy()[dead].__abs__().max()) == 0.0  # queries that see no key
    assert float(got[1].float().numpy()[dead].__abs__().max()) == 0.0  # keys no query sees
    assert float(got[2].float().numpy()[dead].__abs__().max()) == 0.0


@pytest.mark.parametrize("window", [64, None], ids=["window", "segment"])
def test_one_rope_pass_backward_matches_the_jax_rope_kernels(interpret_mode, window):
    """The arithmetic of the rope forms on the card, where one rope pass per backward call feeds the dq and the
    dkv kernel: q and k rotated once with the forward's rope (``apply_rope``, the pass's plain version), the
    backward without rope over them, then dq and dk counter-rotated (rope's transpose). Held in fp32 against
    ``flash_attention_bwd(..., rope_theta=...)`` in interpret mode (its window route rotates inside its
    fuse_rope kernels; at fp32 its segment route rotates outside them and counter-rotates at the end), at
    ``JAX_TOL["float32"]`` of each gradient's largest entry, and dq exactly 0 on queries that see no key."""
    theta = 10000.0
    q, k, v, g = (torch.as_tensor(x) for x in _inputs(3))
    seg = torch.as_tensor(_segments())
    wargs = (window,) if window else ()
    plain = window_attention_plain if window else segment_attention_plain
    out, lse = plain(q, k, v, seg, seg, *wargs, rope_theta=theta, return_lse=True)
    delta = attention_delta(out, g)
    cos, sin = attention_mod.rope_tables(L, D, theta, "cpu")
    dq, dk, dv = attention_mod._attention_bwd_plain(apply_rope(q, theta), apply_rope(k, theta), v, g, lse, delta,
                                                    seg, seg, window)
    got = (attention_mod._counter_rope(dq, cos, sin), attention_mod._counter_rope(dk, cos, sin), dv)

    flat = [jnp.asarray(x.reshape(B, L, H * D).numpy(), jnp.float32) for x in (q, k, v, out, g)]
    jseg = jnp.asarray(_segments())
    block = 128 if window else 256  # the dispatcher's blocks at L = 256
    want = flash_attention_bwd(
        flat[0], flat[1], flat[2], jseg, jseg, flat[3], jnp.asarray(lse.numpy()), flat[4], window, block, block, H,
        rope_theta=theta,
    )
    for name, a, b in zip("qkv", got, want):
        a = a.numpy()
        b = np.asarray(b, np.float32).reshape(B, L, H, D)
        assert np.abs(a - b).max() <= JAX_TOL["float32"] * np.abs(b).max(), (name, np.abs(a - b).max())
    assert float(np.abs(got[0].numpy()[_segments() == 0]).max()) == 0.0  # queries that see no key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("window", [64, None], ids=["window", "segment"])
def test_attention_gradients_are_the_same_with_rope_inside(monkeypatch, window, dtype):
    q, k, v, g = (torch.as_tensor(x).to(dtype) for x in _inputs(1))
    seg = torch.as_tensor(_segments())
    masks = dict(key_mask=(seg > 0).to(torch.int32), segment_ids=seg, window=window)
    calls = RopeBackwardCalls(monkeypatch)

    def grads(route):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        if route == "outside":
            out = attention(apply_rope(leaves[0], 10000.0), apply_rope(leaves[1], 10000.0), leaves[2], **masks)
        else:
            out = attention(*leaves, rope_theta=10000.0, plain=route == "plain", **masks)
        return (out, *torch.autograd.grad(out, leaves, g))

    off, plain = grads("outside"), grads("plain")
    assert calls.calls == 0  # the plain route keeps rope outside
    on = grads("inside")
    assert calls.calls == 2  # the dq and the dkv wrapper each ran the rope backward
    for a, b, c in zip(off, plain, on):
        assert torch.equal(a, b)
        if dtype == torch.float32:
            torch.testing.assert_close(c, a, atol=1e-5, rtol=1e-5)
        else:
            assert (c.float() - a.float()).abs().max() <= BWD_TOL * a.float().abs().max()


def test_rope_stays_outside_where_the_jax_package_keeps_it_outside(monkeypatch):
    """Positions other than arange (the metadata tower's meta_pack rows), a head
    dim other than 64 or an odd head count take the outside rope."""
    assert rope_in_kernels(10000.0, None, 64, 2)
    assert not rope_in_kernels(None, None, 64, 2)
    assert not rope_in_kernels(10000.0, torch.arange(L), 64, 2)
    assert not rope_in_kernels(10000.0, None, 16, 2)
    assert not rope_in_kernels(10000.0, None, 64, 3)
    calls = RopeBackwardCalls(monkeypatch)
    q, k, v, g = (torch.as_tensor(x).requires_grad_() for x in _inputs(2))
    seg = torch.as_tensor(_segments())
    positions = torch.arange(L) % 64
    for qq, kk, vv, pos in ((q, k, v, positions), (q[:, :, :3], k[:, :, :3], v[:, :, :3], None)):
        out = attention(qq, kk, vv, segment_ids=seg, rope_theta=10000.0, positions=pos)
        torch.autograd.grad(out, (q, k, v), g[:, :, : qq.shape[2]], allow_unused=True)
    assert calls.calls == 0


# ------------------------------------------------------------ one training step


def _samples(n=6, v=3, meta_len=12, seq_max=400, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        length = int(rng.integers(100, seq_max))
        ids = np.zeros(seq_max, np.int32)
        mask = np.zeros(seq_max, np.int32)
        ids[:length], mask[:length] = rng.integers(5, 500, length), 1
        meta_mask = (np.arange(meta_len)[None, :] < rng.integers(4, meta_len + 1, (v, 1))).astype(np.int32)
        out.append({
            "input_ids": ids, "attention_mask": mask,
            "metadata_ids": (rng.integers(3, 250, (v, meta_len)) * meta_mask).astype(np.int32),
            "metadata_attention_mask": meta_mask,
            "metadata_variation_classes": np.arange(v, dtype=np.int32),
        })
    return out


def _configs():
    """The tiny config with a beatmap tower of head dim 64 and an even head count
    (hidden 128, 2 heads), one global and one local layer, mean pooling."""
    jcfg, tcfg = jax_tiny_config(), tiny_cm3p_config()
    for cfg in (jcfg, tcfg):
        bc = cfg.beatmap_config
        bc.hidden_size, bc.num_attention_heads, bc.num_hidden_layers = 128, 2, 2
        bc.global_attn_every_n_layers, bc.cls_embed = 2, False
        bc.audio_config.projector_dim = 128  # the audio scatter writes beatmap-width embeddings
    return jcfg, tcfg


def _stash_gradients():
    """An optax transformation whose state after one update is the gradient itself."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def _train_step(monkeypatch, dtype, seed=0):
    """One forward_packed step of both packages from the same seeded weights and
    batch: (port loss, JAX loss, [(name, port grad, JAX grad)], rope backward calls)."""
    samples = _samples(seed=seed)
    batch = next(iter(packed_batches(iter(samples), rows=2, seq_len=512, pad_id=0, max_windows=8)))
    jbatch = next(iter(jax_packed_batches(iter(samples), rows=2, seq_len=512, pad_id=0, max_windows=8)))
    for key in jbatch:
        np.testing.assert_array_equal(batch[key], jbatch[key])
    jcfg, tcfg = _configs()
    bf16 = dtype == "bfloat16"
    assert jcfg.beatmap_config.head_dim == 64 and not fa._train_rope_in_kernel(1e4, 128, 2, jnp.bfloat16)
    monkeypatch.setattr(fa, "TRAIN_FUSED_ROPE", True)
    assert fa._train_rope_in_kernel(1e4, 128, 2, jnp.bfloat16)
    # bf16: the JAX package's rope route (Pallas kernels in interpret mode); fp32: its exact XLA
    # reference (its gate declines fp32), against which the port's rope route is held tightly
    jmodel = CM3PModule(jcfg, dtype=getattr(jnp, dtype), attn_impl="pallas" if bf16 else "xla", meta_pack=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = np.random.default_rng(seed + 1)
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.asarray(rng.integers(5, 500, (2, 64)).astype(np.int32)),
        input_features=jnp.asarray(rng.standard_normal((2, 80, 64)).astype(np.float32)),
        metadata_ids=jb["metadata_ids"][:2],
    )
    params = jax.tree.map(np.asarray, params)
    tx = _stash_gradients()
    state = TrainState(step=jnp.zeros((), jnp.int32), params=jax.tree.map(jnp.asarray, params),
                       opt_state=tx.init(jax.tree.map(jnp.asarray, params["params"])))
    new_state, metrics = jax.jit(make_train_step(jmodel, tx, method=CM3PModule.forward_packed))(
        state, jb, jax.random.PRNGKey(1)
    )
    want_grads = state_dict_from_jax({"params": jax.tree.map(np.asarray, new_state.opt_state)})

    model = CM3PModel(tcfg, meta_pack=4)
    model.load_state_dict(state_dict_from_jax(params))
    model.set_compute_dtype(getattr(torch, dtype))
    calls = RopeBackwardCalls(monkeypatch)
    loss, grads, _ = TrainStep(model, torch.optim.SGD(model.parameters(), lr=0.0), packed=True).grads(
        to_device(batch, "cpu", packed=True)
    )
    names = [n for n, _ in model.named_parameters()]
    return float(loss), float(metrics["loss"]), list(zip(names, grads, (want_grads[n].numpy() for n in names))), \
        calls.calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rope_training_step_matches_the_jax_package(interpret_mode, monkeypatch, dtype):
    loss, want_loss, grads, calls = _train_step(monkeypatch, dtype)
    # the 2 beatmap layers ran the rope backward (dq and dkv wrapper each); the metadata layers did not
    assert calls == 2 * 2
    assert abs(loss - want_loss) <= LOSS_REL_TOL[dtype] * abs(want_loss), (loss, want_loss)
    for name, grad, want in grads:
        if grad is None:  # the audio tower: forward_packed without audio never calls it
            assert name.startswith("beatmap_model.audio_encoder.") and not want.any(), name
            continue
        got = grad.float().numpy()
        assert np.isfinite(got).all(), name
        if dtype == "bfloat16":
            cos = float((got * want).sum() / max(np.linalg.norm(got) * np.linalg.norm(want), 1e-30))
            assert cos >= GRAD_COS_MIN, (name, cos)
        else:
            np.testing.assert_allclose(got, want, atol=2e-4 * max(np.abs(want).max(), 1e-12), err_msg=name)
