"""The port's ``int8_dot`` and its ``xla_int8`` option against the JAX package's ``ops/xla_int8.py`` on the CPU.

Inputs come from numpy seeds and pass between the frameworks as numpy arrays. Tolerances: the int8 codes
equal; the fp32 product within 1e-6 relative (the same exact int32 sums, scaled in the same order); the bf16
product within one bf16 ulp (the last rounding of the scaled product); gradients bit-equal to the exact
``F.linear``. The models compare per window at the cosine stated with each test.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import cm3p_tpu.ops.xla_int8 as jxi
from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.interop.hf_import import convert_cm3p_state_dict
from cm3p_tpu.models import CM3PModule
from cm3p_tpu.models.modernbert import ModernBertEncoder as JaxEncoder
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.inference import load_model
from cm3p_torch.interop import encoder_state_dict_from_jax, init_weights, state_dict_from_jax
from cm3p_torch.models import EncoderOptions, ModernBertEncoder
from cm3p_torch.ops.xla_int8 import int8_dot, int8_dot_plain, quant_rows_int8, quant_weight_int8

VOCAB = 5367
AUDIO_ID = 5366
AUDIO_TABLE = "beatmap_model.audio_encoder.encoder.embeddings.tok_embeddings.weight"
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _cos(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _assert_product_matches(got: torch.Tensor, want: np.ndarray, dtype: torch.dtype):
    got = _to_np(got)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:  # one bf16 ulp of the larger of the two
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(got), np.abs(want)) + 1e-30)) - 7)
        assert (np.abs(got - want) <= ulp).all()


def _jax_array(x: np.ndarray, jdtype):
    return jnp.asarray(x, jnp.float32).astype(jdtype)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_int8_dot_matches_the_jax_int8_dot(name):
    dtype, jdtype = DTYPES[name]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 96, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 768)) * 0.02).astype(np.float32)  # the JAX (D, N) layout
    jx = _jax_array(x, jdtype)
    xt = torch.from_numpy(x).to(dtype)
    weight = torch.from_numpy(w.T.copy())  # the port's (N, D)

    jq, jsa = jxi._quant_rows_int8(jx)
    q, sa = quant_rows_int8(xt)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    jwq, jsw = jxi._quant_weight_int8(jnp.asarray(w))
    wq, sw = quant_weight_int8(weight)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))

    # op by op, as the models apply it here: under jit XLA's CPU compiler rewrites the quantiser's chain and
    # moves codes, which is XLA's rounding and not the function's
    want = np.asarray(jxi.int8_dot(jx, jnp.asarray(w)).astype(jnp.float32))
    got = int8_dot(xt, weight)
    assert got.dtype == dtype and got.shape == (4, 96, 768)
    _assert_product_matches(got, want, dtype)
    assert torch.equal(got, int8_dot_plain(xt, weight))  # _int_mm's int32 sums are the exact ones
    assert torch.equal(got, int8_dot(xt, weight, w_q=(wq, sw)))


def test_outlier_rows_and_few_rows():
    """The JAX test's outlier row (one huge element in row 3) and 8 rows, fewer than ``_int_mm``'s 17 on CUDA."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    x[3, 7] = 100.0
    w = (rng.normal(size=(128, 64)) * 0.05).astype(np.float32)
    want = np.asarray(jxi.int8_dot(jnp.asarray(x), jnp.asarray(w)))
    got = int8_dot(torch.from_numpy(x), torch.from_numpy(w.T.copy()))
    _assert_product_matches(got, want, torch.float32)
    others = [i for i in range(8) if i != 3]
    assert _cos(_to_np(got)[others], (x @ w)[others]).min() > 0.999


def test_under_autograd_the_exact_product_and_its_gradient_run():
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.normal(size=(6, 64)).astype(np.float32)).bfloat16()
    w0 = torch.from_numpy((rng.normal(size=(32, 64)) * 0.1).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32)).bfloat16()
    grads = []
    for fn in (int8_dot, lambda x, w: F.linear(x, w.to(x.dtype))):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        out = fn(x, w)
        (out.float() * g.float()).sum().backward()
        grads.append((out.detach(), x.grad, w.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert not torch.equal(int8_dot(x0, w0), grads[1][0])  # without grad the int8 product runs


# ----------------------------------------------------------------- the model under xla_int8


def _tiny_configs():
    cfgs = []
    for make in (jax_tiny_config, tiny_cm3p_config):
        cfg = make()
        cfg.beatmap_config.vocab_size = VOCAB
        cfg.beatmap_config.audio_token_id = AUDIO_ID
        cfgs.append(cfg)
    return cfgs


def _windows(seed=0):
    rng = np.random.default_rng(seed)
    lengths = (150, 97, 40)
    ids = np.zeros((len(lengths), max(lengths)), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(10, 5000, n)
        ids[i, 1:9] = AUDIO_ID
        mask[i, :n] = 1
    feats = rng.normal(size=(len(lengths), 80, 64)).astype(np.float32)
    return ids, mask, feats


def _bf16_exact(params):
    """Parameters rounded to bf16 values (kept fp32), so the port's bf16 weights are the JAX weights."""
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), params)


@pytest.fixture(scope="module")
def tiny_params():
    """The port's seeded parameters of the tiny model as JAX parameters (the JAX package's HF import), rounded
    to bf16 values."""
    _, tcfg = _tiny_configs()
    state = {k: v.numpy() for k, v in init_weights(tcfg, torch.Generator().manual_seed(0)).items()}
    state[AUDIO_TABLE] = np.zeros((1, tcfg.beatmap_config.audio_config.hidden_size), np.float32)
    params = convert_cm3p_state_dict(state)
    params["params"]["logit_scale"] = np.float32(tcfg.logit_scale_init_value)  # declared, unused by the features
    return _bf16_exact(jax.tree.map(jnp.asarray, params))


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_xla_route_with_xla_int8_matches_the_jax_module(name, tiny_params, monkeypatch):
    """``CM3PModule(attn_impl="xla")`` with ``XLA_INT8_ENABLED`` (read inside the call) against the port's
    ``set_attn_impl("xla")`` with ``xla_int8``: every product of the beatmap and audio towers through
    ``int8_dot``, the MLP unfused. Per window cosine >= 0.99999 in fp32, >= 0.9999 in bf16 (activations
    round at other points, and XLA rewrites the jitted quantiser's chain, which moves an int8 code now and
    then); the option changes the embeddings."""
    dtype, jdtype = DTYPES[name]
    jcfg, tcfg = _tiny_configs()
    ids, mask, feats = _windows()
    jmodel = CM3PModule(jcfg, dtype=jdtype, attn_impl="xla")
    params = tiny_params
    monkeypatch.setattr(jxi, "XLA_INT8_ENABLED", True)
    features = jax.jit(functools.partial(jmodel.apply, method=CM3PModule.get_beatmap_features, normalize=True))
    want = np.asarray(features(params, jnp.asarray(ids), input_features=jnp.asarray(feats),
                               attention_mask=jnp.asarray(mask)).astype(jnp.float32))

    state = state_dict_from_jax(jax.tree.map(np.asarray, params))
    state.pop(AUDIO_TABLE)  # the port's audio tower takes embeddings only
    model = load_model(tcfg, state, device="cpu", dtype=dtype,
                       options=EncoderOptions(w8a8=True, fused_wo=True, xla_int8=True))
    model.set_attn_impl("xla")
    assert all(enc.options == EncoderOptions(xla_int8=True) and enc.plain for enc in model.encoders())
    args = (torch.as_tensor(ids, dtype=torch.int64),)
    tkw = dict(input_features=torch.as_tensor(feats), attention_mask=torch.as_tensor(mask), normalize=True)
    with torch.no_grad():
        got = model.get_beatmap_features(*args, **tkw).float().numpy()
        model.set_options(EncoderOptions())
        exact = model.get_beatmap_features(*args, **tkw).float().numpy()
    assert _cos(got, want).min() >= (0.99999 if name == "fp32" else 0.9999)
    assert not np.array_equal(got, exact)


def _aligned_case(seed=0, layers=2, length=160):
    """A tower whose widths the fused routes take (multiples of 128): layer 0 global, layer 1 local."""
    from cm3p_tpu.configs import MetadataConfig as JaxMetadataConfig
    from cm3p_torch.configs import MetadataConfig

    kw = dict(
        vocab_size=128, hidden_size=128, num_hidden_layers=layers, num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=256, global_attn_every_n_layers=2, local_attention=128,
    )
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 128, (2, length)).astype(np.int32)
    mask = np.ones((2, length), np.int32)
    mask[1, length - 30:] = 0
    return JaxMetadataConfig(**kw), MetadataConfig(**kw), ids, mask


def test_kernel_route_takes_int8_dot_for_qkv_and_wo_and_keeps_the_fused_mlp(monkeypatch):
    """At 128-aligned widths on the kernel route (the JAX package's Pallas kernels in interpret mode) the
    option sends QKV and Wo through ``int8_dot`` and leaves the fused MLP exact, as the JAX package does:
    within 5e-2 absolute and cosine >= 0.9999 per position, as ``TestEncoderOptions`` holds its int8 sets."""
    import jax.experimental.pallas as pl

    from cm3p_tpu.ops import flash_attention as fa
    from cm3p_tpu.ops import fused_ffn as jffn
    from cm3p_tpu.ops import fused_ln_matmul as lnmm

    jcfg, tcfg, ids, mask = _aligned_case()
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    for module, flag in ((lnmm, "FUSED_LNMM_QKV_ENABLED"), (lnmm, "FUSED_LNMM_WO_ENABLED"), (lnmm, "W8A8_ENABLED"),
                         (jffn, "W8A8_WO_ENABLED"), (fa, "FUSED_WO_ENABLED"), (fa, "FUSED_WO_Q")):
        monkeypatch.setattr(module, flag, False)
    monkeypatch.setattr(jxi, "XLA_INT8_ENABLED", True)
    calls = []
    monkeypatch.setattr(jffn, "fused_ln_ffn", functools.partial(_counted, jffn.fused_ln_ffn, calls))
    jenc = JaxEncoder(jcfg, dtype=jnp.float32, attn_impl="pallas")
    kw = dict(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    params = jax.jit(jenc.init)(jax.random.PRNGKey(2), **kw)
    calls.clear()
    want = np.asarray(jax.jit(jenc.apply)(params, **kw))
    assert len(calls) == jcfg.num_hidden_layers  # the JAX MLP stays fused (counted as it is traced)

    enc = ModernBertEncoder(tcfg).eval()
    enc.load_state_dict(encoder_state_dict_from_jax(jax.tree.map(np.asarray, params)["params"]))
    enc.set_options(EncoderOptions(xla_int8=True))
    seen = []
    monkeypatch.setattr("cm3p_torch.models.modernbert.int8_dot", functools.partial(_counted, int8_dot, seen))
    with torch.no_grad():
        got = enc(input_ids=torch.as_tensor(ids, dtype=torch.int64), attention_mask=torch.as_tensor(mask)).numpy()
    assert len(seen) == 2 * tcfg.num_hidden_layers  # QKV and Wo of every layer, no MLP product
    valid = mask > 0
    np.testing.assert_allclose(got[valid], want[valid], atol=5e-2, rtol=1e-4)
    assert _cos(got[valid], want[valid]).min() >= 0.9999


def _counted(fn, calls, *args, **kwargs):
    calls.append(1)
    return fn(*args, **kwargs)


def test_fp32_at_the_beatmap_widths_the_jax_package_declines_w8a8_and_the_port_applies_it(monkeypatch):
    """A deliberate difference (ROADMAP Queue 3): at fp32 the JAX package declines its fused MLP and QKV
    kernels on weights over 7,000,000 bytes (a Mosaic workaround), so under ``W8A8`` + ``FUSED_LNMM_QKV`` its
    beatmap-width layers run the exact products; the port runs its int8 forms there. Two layers at 768 / 1152,
    12 heads, 48 tokens, fp32: the JAX output is its exact output bit for bit (no Pallas runs), the port's
    differs from its own exact output and stays within cosine 0.999 per position of the JAX one."""
    from cm3p_tpu.configs import BeatmapConfig as JaxBeatmapConfig
    from cm3p_tpu.ops import fused_ffn as jffn
    from cm3p_tpu.ops import fused_ln_matmul as lnmm
    from cm3p_torch.configs import BeatmapConfig

    kw = dict(vocab_size=256, num_hidden_layers=2)  # hidden 768, intermediate 1152, 12 heads by default
    jcfg, tcfg = JaxBeatmapConfig(**kw), BeatmapConfig(**kw)
    assert (jcfg.hidden_size, jcfg.intermediate_size, jcfg.num_attention_heads) == (768, 1152, 12)
    assert not jffn.fusable(768, 1152, "gelu", False, False, jnp.float32) and not lnmm.lnmm_fusable(768, 2304, jnp.float32)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, (1, 48)).astype(np.int32)
    jenc = JaxEncoder(jcfg, dtype=jnp.float32, attn_impl="pallas")
    kwj = dict(input_ids=jnp.asarray(ids))
    params = jax.jit(jenc.init)(jax.random.PRNGKey(3), **kwj)
    exact_jax = np.asarray(jax.jit(jenc.apply)(params, **kwj))
    monkeypatch.setattr(lnmm, "W8A8_ENABLED", True)
    monkeypatch.setattr(lnmm, "FUSED_LNMM_QKV_ENABLED", True)
    quant_jax = np.asarray(jax.jit(jenc.apply)(params, **kwj))  # traced anew: the gates are read in the trace
    np.testing.assert_array_equal(quant_jax, exact_jax)

    enc = ModernBertEncoder(tcfg).eval()
    enc.load_state_dict(encoder_state_dict_from_jax(jax.tree.map(np.asarray, params)["params"]))
    with torch.no_grad():
        exact = enc(input_ids=torch.as_tensor(ids, dtype=torch.int64)).numpy()
        enc.set_options(EncoderOptions(w8a8=True, fused_lnmm_qkv=True))
        quant = enc(input_ids=torch.as_tensor(ids, dtype=torch.int64)).numpy()
    np.testing.assert_allclose(exact, exact_jax, atol=2e-4, rtol=1e-4)
    assert not np.array_equal(quant, exact)
    drift = _cos(quant[0], quant_jax[0])
    assert drift.min() >= 0.999, drift.min()


def test_under_d_the_epilogue_keeps_the_long_global_layers_out_projection():
    """A deliberate difference (ROADMAP Queue 3): the JAX package declines its Wo epilogue on global layers
    over 2048 tokens for the TPU's VMEM alone, and there its D + ``XLA_INT8`` route multiplies by Wo through
    ``int8_dot``. The port keeps the bf16 epilogue there (an exact Wo), so D + ``xla_int8`` launches D's
    kernels; ``xla_int8`` reaches the out-projection only where no epilogue and no LN-matmul takes it."""
    from cm3p_tpu.ops.flash_attention import wo_fusable as jax_wo_fusable
    from cm3p_torch.models.modernbert import wo_epilogue

    d_int8 = EncoderOptions(w8a8=True, fused_wo=True, xla_int8=True)
    assert not jax_wo_fusable(None, 0, 0, 768, 768, 4096, 4096) and jax_wo_fusable(None, 0, 0, 768, 768, 2048, 2048)
    assert wo_epilogue(d_int8, None, 768, 4096) == wo_epilogue(d_int8, None, 768, 2048) == "bf16"
    assert wo_epilogue(EncoderOptions(w8a8=True, xla_int8=True), None, 768, 4096) is None  # then int8_dot


@pytest.mark.parametrize("fields,attn_impl,names", [
    # setting C: the attention's and the MLP's Wo are both int8 (they shared one cache entry before)
    (dict(w8a8=True, w8a8_wo=True, fused_lnmm_qkv=True, fused_lnmm_wo=True), "pallas", {"Wqkv", "Wo", "Wi", "mlp_Wo"}),
    (dict(xla_int8=True), "xla", {"xla_Wqkv", "xla_Wo", "xla_Wi", "xla_mlp_Wo"}),
])
def test_every_int8_weight_is_made_once(fields, attn_impl, names):
    _, tcfg, ids, mask = _aligned_case(seed=5)
    enc = ModernBertEncoder(tcfg).eval()
    enc.set_attn_impl(attn_impl)
    enc.set_options(EncoderOptions(**fields))
    args = dict(input_ids=torch.as_tensor(ids, dtype=torch.int64), attention_mask=torch.as_tensor(mask))
    layer = enc.layers[1]
    with torch.no_grad():
        first = enc(**args)
        cached = {k: v[1][0] for k, v in layer._quantised.items()}
        assert torch.equal(enc(**args), first)
    assert set(cached) == names
    assert all(layer._quantised[k][1][0] is v for k, v in cached.items())  # made once, not per forward
