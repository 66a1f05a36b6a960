"""The port's encoder and beatmap model against the JAX package on the CPU.

A tiny config in fp32: the JAX ``CM3PModule(attn_impl="xla")`` and the port's
``CM3PBeatmapModel`` share weights through ``state_dict_from_jax`` and see the
same numpy inputs. Windows must agree at cosine >= 0.99999; hidden states
are compared only at non-padding positions (the XLA reference spreads a
fully masked query uniformly, the port's kernels zero it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.models import CM3PModule
from cm3p_tpu.models.modernbert import ModernBertEncoder as JaxEncoder
from cm3p_tpu.processing.packing import pack_windows as jax_pack_windows
from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.inference import load_model
from cm3p_torch.interop import encoder_state_dict_from_jax, init_weights, state_dict_from_jax
from cm3p_torch.models import CM3PBeatmapModel, ModernBertEncoder
from cm3p_torch.processing.packing import pack_windows

VOCAB = 5367  # the beatmap tokenizer's vocabulary
AUDIO_ID = 5366
N_TOK = 8  # audio tokens per window
COS_MIN = 0.99999


def _configs():
    cfgs = []
    for make in (jax_tiny_config, tiny_cm3p_config):
        cfg = make()
        cfg.beatmap_config.vocab_size = VOCAB
        cfg.beatmap_config.audio_token_id = AUDIO_ID
        cfgs.append(cfg)
    return cfgs


def _windows(lengths, seed=0):
    """Token windows: [CLS-like id, AUDIO x N_TOK, random ids...]."""
    rng = np.random.default_rng(seed)
    seqs = []
    for n in lengths:
        s = rng.integers(10, 5000, n)
        s[1 : 1 + N_TOK] = AUDIO_ID
        seqs.append(s.astype(np.int32))
    return seqs


def _padded(seqs):
    length = max(len(s) for s in seqs)
    ids = np.zeros((len(seqs), length), np.int32)
    mask = np.zeros((len(seqs), length), np.int32)
    for i, s in enumerate(seqs):
        ids[i, : len(s)] = s
        mask[i, : len(s)] = 1
    return ids, mask


def _cos(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs()
    seqs = _windows((150, 97, 40))
    ids, mask = _padded(seqs)
    feats = np.random.default_rng(7).normal(size=(len(seqs), 80, N_TOK * 8)).astype(np.float32)
    jmodel = CM3PModule(jcfg, dtype=jnp.float32, attn_impl="xla")
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(ids), input_features=jnp.asarray(feats),
        attention_mask=jnp.asarray(mask), method=CM3PModule.get_beatmap_features,
    )
    sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
    tmodel = load_model(tcfg, sd, device="cpu", dtype=torch.float32)
    return jmodel, params, tmodel, seqs, ids, mask, feats


class TestStateDict:
    def test_keys_match_the_port_and_init_weights(self, models):
        _, params, tmodel, *_ = models
        sd = state_dict_from_jax(jax.tree.map(np.asarray, params))
        ours = tmodel.state_dict()
        assert set(sd) == set(ours)
        for k, v in sd.items():
            assert tuple(v.shape) == tuple(ours[k].shape), k
        init = init_weights(_configs()[1], torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in init.items()} == {k: tuple(v.shape) for k, v in sd.items()}

    def test_hf_key_names(self, models):
        keys = set(models[2].state_dict())
        assert "beatmap_model.encoder.layers.3.attn.Wqkv.weight" in keys
        assert "beatmap_model.encoder.layers.1.mlp.Wi.weight" in keys
        assert "beatmap_model.encoder.layers.0.attn_norm.weight" not in keys
        assert "beatmap_model.audio_encoder.conv1.weight" in keys
        assert "beatmap_model.audio_encoder.encoder.embeddings.tok_embeddings.weight" not in keys

    def test_init_weights_is_seeded(self):
        cfg = _configs()[1]
        a = init_weights(cfg, torch.Generator().manual_seed(3))
        b = init_weights(cfg, torch.Generator().manual_seed(3))
        assert all(torch.equal(a[k], b[k]) for k in a)
        w = a["beatmap_model.encoder.layers.1.attn.Wqkv.weight"]
        assert float(w.abs().max()) <= 2 * cfg.beatmap_config.initializer_range + 1e-7


class TestEncoder:
    @pytest.mark.parametrize("mode", ["mask", "segments", "none"])
    def test_encoder_matches_xla(self, mode):
        """Layers 0..3 of the tiny tower: global 0 and 3, local 1 and 2 (window 64)."""
        jcfg, tcfg = _configs()
        bc_j, bc_t = jcfg.beatmap_config, tcfg.beatmap_config
        rng = np.random.default_rng(1)
        ids = rng.integers(10, 5000, (2, 200)).astype(np.int32)
        mask = np.ones((2, 200), np.int32)
        seg = None
        if mode == "mask":
            mask[1, 130:] = 0
        if mode == "segments":
            seg = np.zeros((2, 200), np.int32)
            seg[0, :90], seg[0, 90:170] = 1, 2
            seg[1, :200] = 1
            mask = (seg > 0).astype(np.int32)
        jenc = JaxEncoder(bc_j, dtype=jnp.float32, attn_impl="xla")
        kw = dict(input_ids=jnp.asarray(ids))
        if mode != "none":
            kw["attention_mask"] = jnp.asarray(mask)
        if seg is not None:
            kw["segment_ids"] = jnp.asarray(seg)
        params = jenc.init(jax.random.PRNGKey(1), **kw)
        expected = np.asarray(jenc.apply(params, **kw))

        enc = ModernBertEncoder(bc_t)
        enc.load_state_dict(encoder_state_dict_from_jax(jax.tree.map(np.asarray, params)["params"]))
        with torch.no_grad():
            got = enc(
                input_ids=torch.as_tensor(ids, dtype=torch.int64),
                attention_mask=None if mode == "none" else torch.as_tensor(mask),
                segment_ids=None if seg is None else torch.as_tensor(seg),
            ).numpy()
        valid = mask > 0
        np.testing.assert_allclose(got[valid], expected[valid], atol=2e-4, rtol=1e-4)
        assert _cos(got[valid], expected[valid]).min() >= COS_MIN


class TestBeatmapFeatures:
    def test_unpacked_with_audio(self, models):
        jmodel, params, tmodel, _, ids, mask, feats = models
        expected = np.asarray(jmodel.apply(
            params, jnp.asarray(ids), input_features=jnp.asarray(feats), attention_mask=jnp.asarray(mask),
            method=CM3PModule.get_beatmap_features, normalize=True,
        ))
        with torch.no_grad():
            got = tmodel.get_beatmap_features(
                torch.as_tensor(ids, dtype=torch.int64), input_features=torch.as_tensor(feats),
                attention_mask=torch.as_tensor(mask), normalize=True,
            ).numpy()
        assert got.shape == expected.shape
        assert _cos(got, expected).min() >= COS_MIN
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)

    @pytest.mark.parametrize("with_audio", [True, False])
    def test_packed(self, models, with_audio):
        jmodel, params, tmodel, seqs, _, _, feats = models
        packed = pack_windows(seqs, max_length=256, pad_id=0)
        ref_packed = jax_pack_windows(seqs, max_length=256, pad_id=0)
        for key in packed:
            np.testing.assert_array_equal(packed[key], ref_packed[key])
        assert packed["input_ids"].shape[0] < len(seqs)  # windows really share rows
        args = dict(
            input_ids=packed["input_ids"], segment_ids=packed["segment_ids"],
            window_rows=packed["window_to_row"], window_segments=packed["window_segment"],
        )
        expected = np.asarray(jmodel.apply(
            params, **{k: jnp.asarray(v) for k, v in args.items()},
            input_features=jnp.asarray(feats) if with_audio else None,
            method=CM3PModule.get_packed_beatmap_features, normalize=True,
        ))
        with torch.no_grad():
            got = tmodel.get_packed_beatmap_features(
                **{k: torch.as_tensor(v, dtype=torch.int64) for k, v in args.items()},
                input_features=torch.as_tensor(feats) if with_audio else None, normalize=True,
            ).numpy()
        assert _cos(got, expected).min() >= COS_MIN

    def test_packed_equals_unpacked(self, models):
        _, _, tmodel, seqs, ids, mask, feats = models
        packed = pack_windows(seqs, max_length=256, pad_id=0)
        with torch.no_grad():
            dense = tmodel.get_beatmap_features(
                torch.as_tensor(ids, dtype=torch.int64), input_features=torch.as_tensor(feats),
                attention_mask=torch.as_tensor(mask), normalize=True,
            ).numpy()
            pf = tmodel.get_packed_beatmap_features(
                torch.as_tensor(packed["input_ids"], dtype=torch.int64),
                torch.as_tensor(packed["segment_ids"]),
                torch.as_tensor(packed["window_to_row"], dtype=torch.int64),
                torch.as_tensor(packed["window_segment"]),
                input_features=torch.as_tensor(feats), normalize=True,
            ).numpy()
        np.testing.assert_allclose(pf, dense, atol=1e-5)

    def test_audio_divisibility_check(self, models):
        tmodel = models[2]
        with pytest.raises(ValueError, match="projector group"):
            tmodel.beatmap_model.audio_encoder(torch.zeros(1, 80, 36))

    def test_plain_switch_gives_same_result_on_cpu(self, models):
        _, _, tmodel, _, ids, mask, feats = models
        args = (torch.as_tensor(ids, dtype=torch.int64),)
        kw = dict(input_features=torch.as_tensor(feats), attention_mask=torch.as_tensor(mask), normalize=True)
        with torch.no_grad():
            a = tmodel.get_beatmap_features(*args, **kw)
            tmodel.set_plain(True)
            try:
                b = tmodel.get_beatmap_features(*args, **kw)
            finally:
                tmodel.set_plain(False)
        assert torch.equal(a, b)


def test_model_class_is_the_port():
    assert isinstance(load_model(tiny_cm3p_config(), device="cpu"), CM3PBeatmapModel)


# ----------------------------------------------------------- config fields


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "relu", "silu"])
def test_projector_activation_matches_jax(act):
    from cm3p_tpu.configs import AudioConfig as JaxAudioConfig
    from cm3p_tpu.models.cm3p import MultiModalProjector as JaxProjector
    from cm3p_torch.configs import AudioConfig
    from cm3p_torch.models import MultiModalProjector

    kw = dict(hidden_size=32, projector_intermediate_size=128, projector_dim=64, projector_hidden_act=act)
    x = np.random.default_rng(0).normal(size=(2, 5, 128)).astype(np.float32)
    jproj = JaxProjector(JaxAudioConfig(**kw))
    params = jproj.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jproj.apply(params, jnp.asarray(x)))
    proj = MultiModalProjector(AudioConfig(**kw))
    proj.load_state_dict({
        f"{name}.weight": torch.from_numpy(np.array(params["params"][name]["kernel"])).T.contiguous()
        for name in ("linear_1", "linear_2")
    })
    with torch.no_grad():
        got = proj(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_unknown_projector_activation_raises():
    from cm3p_torch.configs import AudioConfig
    from cm3p_torch.models import MultiModalProjector

    with pytest.raises(ValueError, match="projector_hidden_act"):
        MultiModalProjector(AudioConfig(projector_hidden_act="tanh"))


@pytest.mark.parametrize("field", ["attention_dropout", "embedding_dropout", "mlp_dropout"])
def test_dropout_refuses_training_and_loads_for_inference(field, tmp_path):
    from cm3p_torch.inference import load_pretrained, save_pretrained

    cfg = _configs()[1]
    setattr(cfg.beatmap_config, field, 0.1)
    model = load_model(cfg, init_weights(cfg, torch.Generator().manual_seed(0)), device="cpu", dtype=torch.float32)
    ids = torch.as_tensor(_padded(_windows((40, 33)))[0], dtype=torch.int64)
    want = model.get_beatmap_features(ids)  # eval mode: no dropout, as the JAX package when deterministic
    model.train()
    with pytest.raises(NotImplementedError, match="dropout is not ported"):
        model.get_beatmap_features(ids)
    with torch.no_grad():
        torch.testing.assert_close(model.get_beatmap_features(ids), want)
    save_pretrained(model, tmp_path)
    _, loaded = load_pretrained(tmp_path, device="cpu", dtype=torch.float32)
    assert getattr(loaded.config.beatmap_config, field) == 0.1
    torch.testing.assert_close(loaded.get_beatmap_features(ids), want)


# ----------------------------------------------------------- extraction options


def _options_case(seed=0, layers=3, length=160):
    """A tower the fused routes accept (widths multiples of 128): layer 0 global
    without pre-norm, then local and global layers with one."""
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


_OPTION_SETS = {
    "exact": {},
    "w8a8": dict(w8a8=True),
    "lnmm": dict(fused_lnmm_qkv=True, fused_lnmm_wo=True),
    "w8a8+lnmm": dict(w8a8=True, fused_lnmm_qkv=True, fused_lnmm_wo=True),
    "w8a8+w8a8_wo+lnmm": dict(w8a8=True, w8a8_wo=True, fused_lnmm_qkv=True, fused_lnmm_wo=True),
    "w8a8_wo+lnmm_wo": dict(w8a8_wo=True, fused_lnmm_wo=True),
    "fused_wo": dict(fused_wo=True),
    "w8a8+fused_wo": dict(w8a8=True, fused_wo=True),  # the extraction tools' default
    "w8a8+fused_wo+fused_wo_q": dict(w8a8=True, fused_wo=True, fused_wo_q=True),
    # the epilogue takes precedence over the LN-matmul Wo route, and w8a8_wo does not reach it
    "fused_wo+fused_wo_q+lnmm+w8a8_wo": dict(fused_wo=True, fused_wo_q=True, fused_lnmm_qkv=True,
                                             fused_lnmm_wo=True, w8a8_wo=True),
}


def _set_jax_gates(monkeypatch, fields):
    """The JAX package reads its options from module constants (set from the environment at import)."""
    import functools

    import jax.experimental.pallas as pl

    from cm3p_tpu.ops import flash_attention as fa
    from cm3p_tpu.ops import fused_ffn as jffn
    from cm3p_tpu.ops import fused_ln_matmul as lnmm

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(lnmm, "FUSED_LNMM_QKV_ENABLED", fields.get("fused_lnmm_qkv", False))
    monkeypatch.setattr(lnmm, "FUSED_LNMM_WO_ENABLED", fields.get("fused_lnmm_wo", False))
    monkeypatch.setattr(lnmm, "W8A8_ENABLED", fields.get("w8a8", False))
    monkeypatch.setattr(jffn, "W8A8_WO_ENABLED", fields.get("w8a8_wo", False))
    monkeypatch.setattr(fa, "FUSED_WO_ENABLED", fields.get("fused_wo", False))
    monkeypatch.setattr(fa, "FUSED_WO_Q", fields.get("fused_wo_q", False))


class TestEncoderOptions:
    @pytest.mark.parametrize("name", sorted(_OPTION_SETS))
    def test_encoder_with_options_matches_jax_gates(self, name, monkeypatch):
        """The port's encoder with each option set against the JAX encoder (Pallas
        kernels in interpret mode) with the matching gates, fp32, non-padding
        positions. Exact routes: 2e-4. Quantised routes: an int8 code may land
        on the other side of a rounding boundary (summation order), which moves
        a hidden value by about a hundredth of the row's largest: 5e-2 absolute
        and cosine >= 0.9999 per position."""
        from cm3p_torch.models import EncoderOptions

        fields = _OPTION_SETS[name]
        jcfg, tcfg, ids, mask = _options_case()
        _set_jax_gates(monkeypatch, fields)
        jenc = JaxEncoder(jcfg, dtype=jnp.float32, attn_impl="pallas")
        kw = dict(input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask))
        params = jenc.init(jax.random.PRNGKey(2), **kw)
        expected = np.asarray(jenc.apply(params, **kw))

        enc = ModernBertEncoder(tcfg).eval()
        enc.load_state_dict(encoder_state_dict_from_jax(jax.tree.map(np.asarray, params)["params"]))
        enc.set_options(EncoderOptions(**fields))
        with torch.no_grad():
            got = enc(input_ids=torch.as_tensor(ids, dtype=torch.int64), attention_mask=torch.as_tensor(mask)).numpy()
        valid = mask > 0
        quantised = fields.get("w8a8") or fields.get("w8a8_wo") or fields.get("fused_wo_q")
        np.testing.assert_allclose(got[valid], expected[valid], atol=5e-2 if quantised else 2e-4, rtol=1e-4)
        assert _cos(got[valid], expected[valid]).min() >= (0.9999 if quantised else COS_MIN)

    def test_bf16_route_combinations_agree(self):
        """Every (fused_lnmm_qkv, fused_lnmm_wo, fused_wo) combination gives the
        same encoder output: the routes differ in where the work is done, not in
        the math (the JAX package's ``TestGateCombos`` property, for the port)."""
        import itertools

        from cm3p_torch.models import EncoderOptions

        _, tcfg, ids, mask = _options_case(seed=1)
        enc = ModernBertEncoder(tcfg).eval()
        args = dict(input_ids=torch.as_tensor(ids, dtype=torch.int64), attention_mask=torch.as_tensor(mask))
        outs = []
        with torch.no_grad():
            for qkv_on, wo_on, epilogue_on in itertools.product([False, True], repeat=3):
                enc.set_options(EncoderOptions(fused_lnmm_qkv=qkv_on, fused_lnmm_wo=wo_on, fused_wo=epilogue_on))
                outs.append(enc(**args))
        for out in outs[1:]:
            torch.testing.assert_close(out, outs[0], atol=1e-5, rtol=0)

    def test_quantised_options_change_the_output_and_grad_mode_ignores_them(self):
        from cm3p_torch.models import EncoderOptions

        _, tcfg, ids, mask = _options_case(seed=2)
        enc = ModernBertEncoder(tcfg).eval()
        args = dict(input_ids=torch.as_tensor(ids, dtype=torch.int64), attention_mask=torch.as_tensor(mask))
        with torch.no_grad():
            exact = enc(**args)
            enc.set_options(EncoderOptions(w8a8=True, w8a8_wo=True, fused_lnmm_qkv=True, fused_lnmm_wo=True))
            quant = enc(**args)
        assert not torch.equal(exact, quant)
        assert _cos(quant.numpy()[mask > 0], exact.numpy()[mask > 0]).min() > 0.999
        trained = enc(**args)  # autograd on: the exact unfused modules, whatever the options
        torch.testing.assert_close(trained.detach(), exact, atol=1e-5, rtol=0)

    def test_int8_weights_are_cached_and_follow_the_parameters(self):
        from cm3p_torch.models import EncoderOptions

        _, tcfg, ids, mask = _options_case(seed=3, layers=2, length=64)
        enc = ModernBertEncoder(tcfg).eval()
        enc.set_options(EncoderOptions(w8a8=True))
        args = dict(input_ids=torch.as_tensor(ids, dtype=torch.int64), attention_mask=torch.as_tensor(mask))
        layer = enc.layers[1]
        with torch.no_grad():
            first = enc(**args)
            cached = layer._quantised["Wi"][1][0]
            enc(**args)
            assert layer._quantised["Wi"][1][0] is cached  # made once, not per forward
            state = {k: v.clone() for k, v in enc.state_dict().items()}
            state["layers.1.mlp.Wi.weight"] *= 0.5
            enc.load_state_dict(state)
            second = enc(**args)
        assert layer._quantised["Wi"][1][0] is not cached  # remade after the parameters were loaded again
        assert not torch.equal(first, second)

    def test_model_options_reach_both_towers(self):
        from cm3p_torch.models import EncoderOptions

        model = load_model(tiny_cm3p_config(), device="cpu", options=EncoderOptions(w8a8=True, fused_lnmm_wo=True))
        for enc in model.encoders():
            assert enc.options.w8a8 and enc.options.fused_lnmm_wo
            assert all(layer.options is enc.options for layer in enc.layers)
        model.set_options(EncoderOptions())
        assert not any(layer.options.w8a8 for enc in model.encoders() for layer in enc.layers)
