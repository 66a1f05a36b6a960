"""A full-width model in fp32: its route, and the fp32 forms' plain versions against the JAX package.

The kernels have fp32 forms (``csrc/attention_f32.cu``, ``csrc/fused_ffn_f32.cu``,
``csrc/fused_ln_matmul_f32.cu``), so a full-width-shaped model in fp32 takes the
kernel route like a bf16 one: only the entry points that run models no kernel
takes (``--tiny-model``, ``attn_impl: xla``) ask for the plain versions.

* A full-width-shaped encoder (head dim 64, width 256) in fp32 on the CPU is not
  set to the plain route, runs every op's plain version (the wrappers' CPU
  route) and launches nothing; ``--tiny-model`` stays plain and a full-width
  random model does not (``tests/test_torch_plain_route.py`` holds the same
  for bf16).
* The plain versions the fp32 kernels are held to on the card, against the JAX
  package at fp32 on the same seeded numpy inputs, width 256 = 4 heads x 64,
  Pallas in interpret mode as the JAX tests run it: window (w 64), wide window
  (w 192, the streaming ``_fa_kernel``), segment and rectangular (Lq != Lk)
  attention with rope where the form has it, 1e-5 abs on every query that sees
  a key (fp32 sums in two orders), exactly 0 where none; the FFN's fp32-weight
  form and its int8 forms at D 256: 2e-5 abs for the fp32 weights (the TPU
  kernel's rational erf against the exact one, 4e-7 on gelu, times the Wo
  gain), 2e-3 / 1e-2 with an int8 Wi / Wo (a code moved across a rounding
  boundary by the summation order moves the output by about one code's
  worth), as ``tests/test_torch_quant_ops.py`` holds them at D 128. The
  LN-matmul forms at fp32 (with and without LN, bf16-weight and int8) are
  already cases of ``tests/test_torch_quant_ops.py`` at width 256
  (``test_fused_ln_matmul_matches_jax[float32-*]``,
  ``test_fused_ln_matmul_q_matches_jax[float32-*]``).
* On the card (``gpu``; this file imports JAX only inside the CPU parity
  tests, so ``python -m pytest tests/test_torch_fp32_route.py --noconftest``
  runs there): an fp32 forward under autograd on a CUDA tensor raises, and the
  audio tower's convolutions of an fp32 model run in fp32, not TF32 (1e-5 of
  the largest entry against float64).
"""
import functools

import numpy as np
import pytest
import torch

from cm3p_torch.configs import EncoderConfig, tiny_cm3p_config
from cm3p_torch.extract import _random_model
from cm3p_torch.models import CM3PModel, ModernBertEncoder
from cm3p_torch.ops import (
    KERNELS,
    fused_ln_ffn,
    launch_counts,
    reset_launch_counts,
    segment_attention,
    window_attention,
)
from cm3p_torch.ops.attention import attention, segment_attention_rect
from cm3p_torch.processing import CM3PProcessor

_NONE = {name: 0 for name in KERNELS}
EPS = 1e-5
HEADS, HEAD_DIM = 4, 64  # width 256, the metadata tower's


def _full_width_shaped_encoder(seed=0):
    cfg = EncoderConfig(vocab_size=64, hidden_size=HEADS * HEAD_DIM, intermediate_size=512, num_hidden_layers=2,
                        max_position_embeddings=512,
                        num_attention_heads=HEADS, global_attn_every_n_layers=2, local_attention=128)
    torch.manual_seed(seed)
    return ModernBertEncoder(cfg).float().eval()


def test_full_width_shaped_fp32_encoder_takes_the_kernel_route_and_launches_nothing_on_the_cpu():
    enc = _full_width_shaped_encoder()
    assert enc.config.head_dim == HEAD_DIM and not enc.plain
    ids = torch.randint(1, 64, (2, 300), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 300, dtype=torch.int32)
    mask[1, 250:] = 0
    reset_launch_counts()
    with torch.no_grad():
        got = enc(input_ids=ids, attention_mask=mask)
        enc.plain = True
        want = enc(input_ids=ids, attention_mask=mask)
    assert launch_counts() == _NONE
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny-model", "full-width"])
def test_only_the_tiny_entry_point_asks_for_the_plain_route_in_fp32(tiny, monkeypatch):
    import cm3p_torch.extract as extract

    built = {}

    def load_model(cfg, weights, **kw):  # the full-width model is not built here: only its route is read
        assert kw["dtype"] == torch.float32
        built["model"] = model = CM3PModel(tiny_cm3p_config())
        return model

    monkeypatch.setattr(extract, "load_model", load_model)
    monkeypatch.setattr(extract, "init_weights", lambda *a, **k: None)
    _random_model(CM3PProcessor(), tiny, torch.device("cpu"), torch.float32, None)
    encoders = built["model"].encoders()
    assert [enc.plain for enc in encoders] == [tiny] * len(encoders)


# ------------------------------------------------------------ parity with the JAX package at fp32


@pytest.fixture
def jax_fp32(monkeypatch):
    """The JAX package's attention and FFN modules, Pallas in interpret mode with the running max (as
    ``tests/test_torch_ops.py`` compares them)."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the parity tests run JAX on the CPU (tests/conftest.py sets it), in full fp32 precision")
    pl = pytest.importorskip("jax.experimental.pallas")
    import cm3p_tpu.ops.flash_attention as fa
    import cm3p_tpu.ops.fused_ffn as ffn

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(fa, "ONLINE_MAX", True)
    return fa, ffn


def _qkv(b, lq, lk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, lq, HEADS, HEAD_DIM)).astype(np.float32)
    k, v = (rng.standard_normal((b, lk, HEADS, HEAD_DIM)).astype(np.float32) for _ in range(2))
    return q, k, v


def _packed(b, length):
    seg = np.zeros((b, length), np.int32)
    seg[0, :90], seg[0, 90:200], seg[0, 200:length - 20] = 1, 2, 3  # a segment across a 64-tile boundary
    seg[1, : length // 3] = 1
    return seg


def _visible(qseg, kseg, window):
    idx_q, idx_k = np.arange(qseg.shape[1]), np.arange(kseg.shape[1])
    ok = (kseg[:, None, :] > 0) & (qseg[:, :, None] == kseg[:, None, :])
    if window is not None:
        ok &= np.abs(idx_q[:, None] - idx_k[None, :])[None] <= window
    return ok.any(-1)


def _across_tiles(b, length):
    """Segments that cross 128-position boundaries (at 100-300 and 250): the fp32 kernel's 64-query tiles
    and 64-key tiles, ends off every tile."""
    seg = np.zeros((b, length), np.int32)
    seg[0, :100], seg[0, 100:300], seg[0, 300:length - 14] = 1, 2, 3
    seg[1, :250], seg[1, 250:] = 1, 2
    return seg


_ATTENTION_CASES = [(form, layout) for layout in ("packed", "across_tiles") for form in ("window", "wide_window", "segment")]


@pytest.mark.parametrize("form, layout", _ATTENTION_CASES,
                         ids=[form if layout == "packed" else f"{form}_{layout}" for form, layout in _ATTENTION_CASES])
def test_fp32_attention_plain_matches_the_jax_kernels(jax_fp32, form, layout):
    """Window w 64 (``_window_fused_kernel``), w 192 (the streaming ``_fa_kernel``) and segment
    (``_seg_unrolled_kernel``) attention with rope inside: packed segments at L 256, and segments across
    128-position boundaries at L 384."""
    fa, _ = jax_fp32
    import jax.numpy as jnp

    b, length = 2, 256 if layout == "packed" else 384
    q, k, v = _qkv(b, length, length, seed=11)
    seg = _packed(b, length) if layout == "packed" else _across_tiles(b, length)
    window = {"window": 64, "wide_window": 192, "segment": None}[form]
    theta = 10000.0 if window else 160000.0
    want = np.asarray(fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                                         segment_ids=jnp.asarray(seg), rope_theta=theta))
    tq, tk, tv, ts = (torch.as_tensor(x) for x in (q, k, v, seg))
    got = (window_attention(tq, tk, tv, ts, ts, window, theta) if window
           else segment_attention(tq, tk, tv, ts, ts, theta)).numpy()
    via_dispatch = attention(tq, tk, tv, None, ts, window, theta).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, via_dispatch)
    vis = _visible(seg, seg, window)
    np.testing.assert_allclose(got[vis], want[vis], atol=1e-5)
    assert np.all(got[~vis] == 0.0)


def test_fp32_rect_attention_plain_matches_the_jax_kernel(jax_fp32):
    """The rectangular segment form (a query shard of 128 over 384 gathered keys, a key mask), no rope."""
    fa, _ = jax_fp32
    import jax.numpy as jnp

    q, k, v = _qkv(2, 128, 384, seed=12)
    mask = np.ones((2, 384), np.int32)
    mask[0, 300:] = 0
    mask[1, :] = 0  # every key masked: its queries give exactly 0
    want = np.asarray(fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_mask=jnp.asarray(mask)))
    qseg = torch.ones(2, 128, dtype=torch.int32)
    got = segment_attention_rect(*(torch.as_tensor(x) for x in (q, k, v)), qseg, torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    assert np.all(got[1] == 0.0)


_FFN_FORMS = [(False, False), (True, False), (True, True), (False, True)]
_FFN_FORM_IDS = ["fp32-weights", "w8a8", "w8a8+w8a8_wo", "w8a8_wo"]


# F 512 (the metadata tower's), and F 2368: past every F the first fp32 kernel kept in shared memory (2304 at D 256),
# which the kernel now takes (g goes through a device scratch)
@pytest.mark.parametrize("w8a8,w8a8_wo,f", [(*form, 512) for form in _FFN_FORMS] + [(*form, 2368) for form in _FFN_FORMS],
                         ids=_FFN_FORM_IDS + [f"{name}-F2368" for name in _FFN_FORM_IDS])
def test_fp32_ffn_plain_matches_the_interpreted_pallas_kernel(jax_fp32, w8a8, w8a8_wo, f):
    """``fused_ln_ffn`` at fp32 (its plain version on the CPU) against ``_pallas_ln_ffn`` at D 256, F 512 and F
    2368, rows not a multiple of the TPU kernel's 128-row blocks, with zero rows and an LN bias."""
    _, ffn = jax_fp32
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    rows, d = 150, 256
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x[5:9] = 0.0
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    wi = (0.06 * rng.standard_normal((d, 2 * f))).astype(np.float32)
    wo = (0.06 * rng.standard_normal((f, d))).astype(np.float32)
    want = ffn._pallas_ln_ffn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(wi),
                              jnp.asarray(wo), eps=EPS, residual=True, block_rows=128, w8a8=w8a8, w8a8_wo=w8a8_wo,
                              interpret=True)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = fused_ln_ffn(t(x), t(scale), t(bias), t(wi.T), t(wo.T), EPS, w8a8=w8a8, w8a8_wo=w8a8_wo)
    assert got.dtype == torch.float32
    tol = 1e-2 if w8a8_wo else (2e-3 if w8a8 else 2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=tol)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_an_fp32_forward_under_autograd_on_cuda_raises(cuda):
    enc = _full_width_shaped_encoder().to(cuda)
    ids = torch.randint(1, 64, (1, 128), device=cuda)
    with pytest.raises(ValueError, match="fp32 attention forward under autograd"):
        enc(input_ids=ids)
    q = torch.randn(1, 128, HEADS, HEAD_DIM, device=cuda)
    seg = torch.ones(1, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="no lse"):
        window_attention(q, q, q, seg, seg, 64, return_lse=True)
    with torch.no_grad():
        assert torch.isfinite(enc(input_ids=ids)).all()  # the no-grad forward runs the fp32 kernels


@pytest.mark.gpu
def test_fp32_audio_convolutions_run_in_fp32_not_tf32(cuda):
    """The audio tower's two convolutions of an fp32 model against float64, with cuDNN's TF32 allowed around
    the call: within 1e-5 of the largest entry (TF32 keeps about 1e-3), and the setting is back after it."""
    from cm3p_torch.models.cm3p import AudioEncoder

    cfg = tiny_cm3p_config().beatmap_config.audio_config
    torch.manual_seed(0)
    audio = AudioEncoder(cfg).to(cuda).float().eval()
    mel = torch.randn(2, cfg.n_mels, 64, device=cuda)
    conv = {}
    handles = [audio.encoder.register_forward_pre_hook(lambda m, a, kw: conv.update(x=kw["inputs_embeds"]),
                                                       with_kwargs=True)]
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            audio.encoder.plain = True
            audio(mel)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        for h in handles:
            h.remove()
    w1, b1 = audio.conv1.weight.double(), audio.conv1.bias.double()
    w2, b2 = audio.conv2.weight.double(), audio.conv2.bias.double()
    ref = torch.nn.functional.gelu(torch.nn.functional.conv1d(mel.double(), w1, b1, padding=1))
    ref = torch.nn.functional.gelu(torch.nn.functional.conv1d(ref, w2, b2, stride=2, padding=1)).transpose(1, 2)
    got = conv["x"].double()
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
