"""The port's extraction entry point on the CPU: HF-layout bundles in both
directions, ``load_pretrained``, and ``python -m cm3p_torch.extract``.

A small seeded model whose widths the fused routes accept (multiples of 128),
fp32; maps from the repo's ``resources/`` copied into temporary folders beside
synthetic WAV files, so the file loader reads real audio files.
"""
import os
import shutil
import subprocess
import sys
import textwrap
import types
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3p_tpu.configs import tiny_cm3p_config as jax_tiny_config
from cm3p_tpu.inference import embed_beatmap as jax_embed_beatmap
from cm3p_tpu.interop import load_hf_checkpoint
from cm3p_tpu.interop.hf_export import export_hf_checkpoint
from cm3p_tpu.models import CM3PModule
from cm3p_tpu.processing import CM3PProcessor as JaxProcessor
from cm3p_torch.audio.loading import load_audio_file
from cm3p_torch.configs import AudioConfig, BeatmapConfig, CM3PConfig, MetadataConfig
from cm3p_torch.data import BeatmapFilesDataset, SampleLoader
from cm3p_torch.extract import (
    DEFAULT_OPTIONS,
    BeatmapFilesDatasetFactory,
    build_parser,
    extract_embeddings,
    main,
    options_from_args,
)
from cm3p_torch.inference import embed_beatmap, load_model, load_pretrained, save_pretrained
from cm3p_torch.interop import init_weights
from cm3p_torch.interop.safetensors_io import load_file, save_file
from cm3p_torch.models import CM3PBeatmapModel, CM3PModel, EncoderOptions
from cm3p_torch.processing import CM3PProcessor

REPO = Path(__file__).resolve().parent.parent
BUNDLED = REPO / "resources" / "Denkishiki Karen Ongaku Shuudan - Aoki Kotou no Anguis (OliBomby) [Ardens Spes].osu"
CORPUS = REPO / "resources" / "perf_corpus"
WINDOW_ARGS = ["--max-length", "1024", "--window-length", "16"]
WINDOW_KW = dict(window_length_sec=16.0, window_stride_sec=16.0, max_length=1024)


def _small_config() -> CM3PConfig:
    tok = CM3PProcessor().beatmap_tokenizer
    beatmap = BeatmapConfig(
        vocab_size=tok.vocab_size, audio_token_id=tok.audio_token_id, hidden_size=128, intermediate_size=128,
        num_hidden_layers=3, num_attention_heads=2, max_position_embeddings=1024,
        audio_config=AudioConfig(hidden_size=128, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
                                 projector_intermediate_size=512, projector_dim=128),
    )
    metadata = MetadataConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                              num_attention_heads=2)
    return CM3PConfig(metadata_config=metadata, beatmap_config=beatmap, projection_dim=32)


def _write_wav(path: Path, seconds: float, seed: int) -> None:
    pcm = (3000 * np.random.default_rng(seed).standard_normal(int(seconds * 16000))).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())


@pytest.fixture(scope="module")
def bundle(tmp_path_factory) -> Path:
    """A seeded small bundle written by the port's ``save_pretrained``."""
    cfg = _small_config()
    model = load_model(cfg, init_weights(cfg, torch.Generator().manual_seed(0)), device="cpu", dtype=torch.float32)
    return save_pretrained(model, tmp_path_factory.mktemp("bundle"))


@pytest.fixture(scope="module")
def map_folders(tmp_path_factory) -> Path:
    """Two beatmap folders, each with the ``audio.wav`` its map names."""
    root = tmp_path_factory.mktemp("maps")
    for i, name in enumerate(("std_sparse_short.osu", "taiko_sparse_short.osu")):
        folder = root / f"set{i}"
        folder.mkdir()
        shutil.copy(CORPUS / name, folder / name)
        _write_wav(folder / "audio.wav", 40.0, seed=i)
    return root


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


# ---------------------------------------------------------------- bundles


def test_safetensors_io_agrees_with_the_safetensors_package(tmp_path):
    from safetensors.numpy import load_file as ref_load
    from safetensors.numpy import save_file as ref_save
    from safetensors.torch import load_file as ref_load_torch

    rng = np.random.default_rng(0)
    tensors = {"w": rng.standard_normal((5, 7)).astype(np.float32), "ids": np.arange(9, dtype=np.int64),
               "scalar": np.asarray(2.5, np.float32)}
    save_file(tensors, tmp_path / "ours.safetensors", metadata={"format": "pt"})
    back = ref_load(str(tmp_path / "ours.safetensors"))
    ref_save(tensors, str(tmp_path / "theirs.safetensors"))
    ours = load_file(tmp_path / "theirs.safetensors")
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v)
        assert ours[k].shape == v.shape and np.array_equal(ours[k], v)
    save_file({"w": tensors["w"]}, tmp_path / "bf16.safetensors", bf16=True)
    want = torch.from_numpy(tensors["w"]).bfloat16()
    assert torch.equal(ref_load_torch(str(tmp_path / "bf16.safetensors"))["w"], want)  # round to nearest even
    assert np.array_equal(load_file(tmp_path / "bf16.safetensors")["w"], want.float().numpy())


def test_safetensors_io_round_trips_f16_with_the_safetensors_package(tmp_path):
    """F16, the type of many sharded Hub checkpoints, in both directions."""
    from safetensors.numpy import load_file as ref_load
    from safetensors.numpy import save_file as ref_save

    half = {"h": np.random.default_rng(1).standard_normal((3, 4)).astype(np.float16)}
    save_file(half, tmp_path / "ours.safetensors")
    ref_save(half, str(tmp_path / "theirs.safetensors"))
    for got in (ref_load(str(tmp_path / "ours.safetensors")), load_file(tmp_path / "theirs.safetensors")):
        assert got["h"].dtype == np.float16 and np.array_equal(got["h"], half["h"])


def test_load_pretrained_reads_a_jax_export_and_embeds_like_the_jax_package(tmp_path):
    """(a) ``export_hf_checkpoint`` (real safetensors) -> ``load_pretrained`` -> ``embed_beatmap``."""
    proc = CM3PProcessor()
    tok = proc.beatmap_tokenizer
    jcfg = jax_tiny_config()
    jcfg.beatmap_config.vocab_size = tok.vocab_size
    jcfg.beatmap_config.audio_token_id = tok.audio_token_id
    wav = (0.1 * np.random.default_rng(1).standard_normal(40 * 16000)).astype(np.float32)
    inputs = proc(beatmap=str(BUNDLED), audio=wav, **WINDOW_KW)
    jmodel = CM3PModule(jcfg, dtype=jnp.float32, attn_impl="xla")
    params = jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(inputs["input_ids"][:1]),
        input_features=jnp.asarray(inputs["input_features"][:1]),
        attention_mask=jnp.asarray(inputs["attention_mask"][:1]),
        metadata_ids=jnp.zeros((1, 8), jnp.int32), return_loss=False,
    )
    export_hf_checkpoint(params, jcfg, tmp_path / "jax_bundle")
    expected = jax_embed_beatmap(jmodel, params, JaxProcessor(), str(BUNDLED), audio=wav, mean_pool=False, **WINDOW_KW)

    loaded_proc, model = load_pretrained(tmp_path / "jax_bundle", device="cpu", dtype=torch.float32)
    assert isinstance(model, CM3PModel)  # the export carries the metadata tower
    assert model.config.beatmap_config.hidden_size == jcfg.beatmap_config.hidden_size
    got = embed_beatmap(model, loaded_proc, str(BUNDLED), audio=wav, mean_pool=False, device="cpu", **WINDOW_KW)
    assert got.shape == expected.shape and got.shape[0] >= 2
    assert _cos(got, expected).min() >= 0.99999


def test_save_pretrained_is_read_by_safetensors_and_the_jax_package(bundle):
    """(b) the port's bundle through ``safetensors.numpy.load_file`` and ``load_hf_checkpoint``."""
    from safetensors.numpy import load_file as ref_load

    _, model = load_pretrained(bundle, device="cpu", dtype=torch.float32)
    assert type(model) is CM3PBeatmapModel  # a beatmap-only bundle
    state = model.state_dict()
    raw = ref_load(str(bundle / "model.safetensors"))
    audio_table = "beatmap_model.audio_encoder.encoder.embeddings.tok_embeddings.weight"
    assert set(raw) == set(state) | {audio_table} and not raw[audio_table].any()
    for k, v in state.items():
        assert np.array_equal(raw[k], v.numpy()), k
    cfg, params = load_hf_checkpoint(bundle)
    assert cfg.beatmap_config.hidden_size == 128 and cfg.projection_dim == 32
    tree = params["params"]
    layer = tree["beatmap_model"]["encoder"]["layers_1"]
    np.testing.assert_array_equal(np.asarray(layer["attn"]["Wqkv"]["kernel"]),
                                  state["beatmap_model.encoder.layers.1.attn.Wqkv.weight"].numpy().T)
    np.testing.assert_array_equal(np.asarray(layer["attn_norm"]["LayerNorm_0"]["scale"]),
                                  state["beatmap_model.encoder.layers.1.attn_norm.weight"].numpy())
    np.testing.assert_array_equal(np.asarray(tree["beatmap_model"]["audio_encoder"]["conv2"]["kernel"]),
                                  state["beatmap_model.audio_encoder.conv2.weight"].numpy().transpose(2, 1, 0))
    np.testing.assert_array_equal(np.asarray(tree["beatmap_projection"]["kernel"]),
                                  state["beatmap_projection.weight"].numpy().T)


def test_save_then_load_is_bit_equal_and_takes_options(bundle, tmp_path):
    opts = EncoderOptions(w8a8=True, fused_lnmm_qkv=True)
    proc, model = load_pretrained(bundle, device="cpu", dtype=torch.float32, options=opts)
    assert all(enc.options == opts for enc in model.encoders()) and not model.training
    again = save_pretrained(model, tmp_path / "again", processor=proc)
    assert (again / "processor_config.json").exists()
    proc2, model2 = load_pretrained(again, device="cpu", dtype=torch.float32)
    assert proc2.beatmap_tokenizer.vocab_size == proc.beatmap_tokenizer.vocab_size
    a, b = model.state_dict(), model2.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    _, bf16 = load_pretrained(bundle, device="cpu")  # default dtype: bf16 weights, fp32 LayerNorms
    assert bf16.beatmap_projection.weight.dtype == torch.bfloat16
    assert bf16.beatmap_model.encoder.final_norm.weight.dtype == torch.float32


def test_load_pretrained_refuses_what_is_not_ported(bundle, tmp_path):
    # a Hub id resolves from a local cache only: one the cache lacks is refused, and nothing is downloaded
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        load_pretrained("OliBomby/CM3P", device="cpu", cache_dir=tmp_path / "hub")
    (tmp_path / "orbax" / "params").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="Orbax"):
        load_pretrained(tmp_path / "orbax", device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        load_pretrained(tmp_path / "empty", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_pretrained(bundle)


def test_load_pretrained_warns_on_a_vocabulary_smaller_than_the_tokenizer(tmp_path):
    cfg = _small_config()
    cfg.beatmap_config.vocab_size = 100
    cfg.beatmap_config.audio_token_id = 99
    model = load_model(cfg, init_weights(cfg, torch.Generator().manual_seed(1)), device="cpu", dtype=torch.float32)
    save_pretrained(model, tmp_path / "small_vocab")
    with pytest.warns(UserWarning, match="out-of-range ids"):
        load_pretrained(tmp_path / "small_vocab", device="cpu")


# ---------------------------------------------------------------- loader


def test_file_loader_matches_the_jax_package(map_folders):
    """Same rows, same windows, same audio features as ``cm3p_tpu.data.BeatmapFilesDataset``."""
    from cm3p_tpu.data import BeatmapFilesDataset as JaxDataset

    proc, jproc = CM3PProcessor(), JaxProcessor()
    for p in (proc, jproc):
        p.default_kwargs["beatmap_kwargs"].update(WINDOW_KW)
    ours = list(BeatmapFilesDataset([str(map_folders)], proc, include_metadata=False))
    ref = list(JaxDataset([str(map_folders)], jproc, include_metadata=False))
    assert len(ours) == len(ref) >= 4
    for a, b in zip(ours, ref):
        assert tuple(a["beatmap_id"]) == tuple(b["beatmap_id"])
        np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
        np.testing.assert_allclose(a["input_features"], b["input_features"], atol=1e-5)


def test_sample_loader_with_worker_processes_gives_every_window(map_folders):
    proc = CM3PProcessor()
    proc.default_kwargs["beatmap_kwargs"].update(WINDOW_KW)
    factory = BeatmapFilesDatasetFactory([str(map_folders)], proc, include_audio=False)
    inline = list(SampleLoader(factory, num_workers=0))
    spread = list(SampleLoader(factory, num_workers=2, log_dir=None))
    key = lambda s: (tuple(s["beatmap_id"]), s["input_ids"].tobytes())  # noqa: E731
    assert sorted(map(key, inline)) == sorted(map(key, spread)) and len(inline) >= 4


# ---------------------------------------------------------------- the CLI


def _run_cli(bundle, maps, out, *extra):
    return main(["--device", "cpu", "--dtype", "float32", "--model-dir", str(bundle), "--beatmap-files", str(maps),
                 "--output", str(out), *WINDOW_ARGS, *extra])


def test_cli_writes_the_jax_tools_parquet_and_mean_pools_embed_beatmap(bundle, map_folders, tmp_path):
    """(c) one row per beatmap, the JAX tool's columns, equal to mean-pooling ``embed_beatmap``."""
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    import extract_beatmap_embeddings as jax_tool
    from cm3p_tpu.data import BeatmapFilesDataset as JaxDataset

    embeddings = _run_cli(bundle, map_folders, tmp_path / "precise.parquet", "--precise")
    df = pd.read_parquet(tmp_path / "precise.parquet")
    assert sorted(df["beatmap_id"]) == [9500, 9504] == sorted(embeddings)

    # the JAX tool's writer on the same embeddings gives the same table
    accumulator = {(-1, bid): {"sum": vec.copy(), "count": 1} for bid, vec in embeddings.items()}
    metadata = JaxDataset([str(map_folders)], JaxProcessor(), include_audio=False).metadata
    ns = types.SimpleNamespace(output=str(tmp_path / "jax_writer.parquet"), merge_with=None)
    jax_tool._write_output(accumulator, metadata, ns)
    want = pd.read_parquet(tmp_path / "jax_writer.parquet")
    assert list(df.columns) == list(want.columns)
    pd.testing.assert_frame_equal(df.drop(columns="embedding"), want.drop(columns="embedding"))
    for got_vec, want_vec in zip(df["embedding"], want["embedding"]):
        np.testing.assert_allclose(np.asarray(got_vec), np.asarray(want_vec), atol=1e-6)

    # each row is the mean of the beatmap's window embeddings, re-normalised
    proc, model = load_pretrained(bundle, device="cpu", dtype=torch.float32)
    for folder in sorted(map_folders.iterdir()):
        osu = next(folder.glob("*.osu"))
        wav = load_audio_file(folder / "audio.wav", 16000)
        pooled = embed_beatmap(model, proc, str(osu), audio=wav, device="cpu", **WINDOW_KW)
        bid = 9500 if "std" in osu.name else 9504
        np.testing.assert_allclose(embeddings[bid], pooled, atol=2e-5)
        np.testing.assert_allclose(np.linalg.norm(embeddings[bid]), 1.0, atol=1e-5)

    # the dense path gives the same embeddings as the packed one
    dense = _run_cli(bundle, map_folders, tmp_path / "dense.parquet", "--precise", "--no-pack", "--batch-size", "3")
    for bid in embeddings:
        np.testing.assert_allclose(dense[bid], embeddings[bid], atol=2e-5)


def test_cli_default_is_the_tools_quantised_setting(bundle, map_folders, tmp_path):
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    precise = _run_cli(bundle, map_folders, tmp_path / "p.parquet", "--precise", "--no-audio")
    default = _run_cli(bundle, map_folders, tmp_path / "d.parquet", "--no-audio")
    unfused = _run_cli(bundle, map_folders, tmp_path / "u.parquet", "--no-audio", "--no-fused-wo")
    lnmm = _run_cli(bundle, map_folders, tmp_path / "l.parquet", "--no-audio", "--fused-lnmm", "--w8a8-wo",
                    "--flush-rows", "1", "--num-workers", "2")
    assert sorted(default) == [9500, 9504]
    for bid in precise:
        assert not np.array_equal(default[bid], precise[bid])  # w8a8 is on unless --precise
        assert _cos(default[bid], precise[bid]) > 0.999
        np.testing.assert_allclose(np.linalg.norm(default[bid]), 1.0, atol=1e-5)
        np.testing.assert_allclose(default[bid], unfused[bid], atol=1e-6)  # the bf16 epilogue changes no number
        assert not np.array_equal(lnmm[bid], default[bid])
        assert _cos(lnmm[bid], precise[bid]) > 0.999


@pytest.mark.parametrize("argv,want", [
    ([], EncoderOptions(w8a8=True, fused_wo=True)),  # the JAX tool's default: CM3P_W8A8=1, CM3P_FUSED_WO=1
    (["--precise"], EncoderOptions()),
    (["--fused-lnmm"], EncoderOptions(w8a8=True, fused_lnmm_qkv=True, fused_lnmm_wo=True, fused_wo=True)),
    (["--precise", "--fused-lnmm", "--w8a8-wo"],
     EncoderOptions(w8a8_wo=True, fused_lnmm_qkv=True, fused_lnmm_wo=True)),
    (["--fused-wo-q"], EncoderOptions(w8a8=True, fused_wo=True, fused_wo_q=True)),
    (["--no-fused-wo"], EncoderOptions(w8a8=True)),
    (["--no-fused-wo", "--fused-wo-q"], EncoderOptions(w8a8=True)),  # fused_wo_q acts only with fused_wo
    (["--precise", "--fused-wo-q"], EncoderOptions()),
    (["--xla-int8"], EncoderOptions(w8a8=True, fused_wo=True, xla_int8=True)),  # D + CM3P_XLA_INT8=1
])
def test_cli_flags_map_to_encoder_options(argv, want):
    ns = build_parser().parse_args(["--beatmap-files", "x", "--output", "y", *argv])
    assert options_from_args(ns) == want
    if not argv:
        assert want == DEFAULT_OPTIONS


def test_cli_merge_with_prefers_new_rows(bundle, map_folders, tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    first = tmp_path / "first.parquet"
    _run_cli(bundle, map_folders, first, "--no-audio")
    old = pd.read_parquet(first)
    stale = old.copy()
    stale["embedding"] = [np.zeros(32).tolist()] * len(stale)  # rows this run will replace
    extra = old.iloc[:1].copy()
    extra["Id"] = extra["beatmap_id"] = 123456  # a row only the existing file has
    extra["embedding"] = [np.ones(32).tolist()]
    pd.concat([stale, extra]).to_parquet(tmp_path / "existing.parquet", index=False)
    merged_path = tmp_path / "merged.parquet"
    _run_cli(bundle, map_folders, merged_path, "--no-audio", "--merge-with", str(tmp_path / "existing.parquet"))
    merged = pd.read_parquet(merged_path).set_index("Id")
    assert sorted(merged.index) == [9500, 9504, 123456]
    fresh = old.set_index("Id")
    for bid in (9500, 9504):
        np.testing.assert_allclose(np.asarray(merged.loc[bid, "embedding"]), np.asarray(fresh.loc[bid, "embedding"]))
    np.testing.assert_array_equal(np.asarray(merged.loc[123456, "embedding"]), np.ones(32))


def test_extract_embeddings_needs_no_dataframe(bundle, map_folders):
    """The core takes any iterable of window samples and returns plain numpy."""
    proc, model = load_pretrained(bundle, device="cpu", dtype=torch.float32, options=EncoderOptions(w8a8=True))
    proc.default_kwargs["beatmap_kwargs"].update(WINDOW_KW)
    samples = list(BeatmapFilesDataset([str(map_folders)], proc, include_metadata=False))
    stats, windows = {}, {}
    out = extract_embeddings(model, proc, samples, device="cpu", flush_rows=1, stats=stats, windows_out=windows)
    assert sorted(out) == [9500, 9504] and all(v.dtype == np.float32 and v.shape == (32,) for v in out.values())
    assert stats["windows"] == len(samples) == sum(len(w) for w in windows.values()) and stats["flushes"] >= 2
    for bid, w in windows.items():
        mean = w.mean(axis=0)
        np.testing.assert_allclose(out[bid], mean / np.linalg.norm(mean), atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            extract_embeddings(model, proc, samples)


def test_cli_without_a_gpu_raises_unless_asked_for_the_cpu(bundle, map_folders, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model-dir", str(bundle), "--beatmap-files", str(map_folders), "--output", str(tmp_path / "x.parquet")])


def test_cli_leaves_jax_out_of_the_process(bundle, map_folders, tmp_path):
    """(d) ``python -m cm3p_torch.extract`` in a subprocess loads no JAX module."""
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    script = textwrap.dedent(
        f"""
        import sys
        from cm3p_torch.extract import main

        main(["--device", "cpu", "--dtype", "float32", "--model-dir", {str(bundle)!r}, "--beatmap-files",
              {str(map_folders)!r}, "--output", {str(tmp_path / "sub.parquet")!r}, "--no-audio",
              "--max-length", "1024", "--window-length", "16"])
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cm3p_tpu"))
        print("LOADED", bad)
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
    assert (tmp_path / "sub.parquet").exists()
