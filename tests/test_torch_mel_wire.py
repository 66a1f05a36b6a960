"""The extraction tool's mel wires on the CPU: ``DeviceLogMel`` against the JAX
package's and the host mel, the compact wire bit-equal to the full wire, the int8
and PCM wires close to the compact one through ``python -m cm3p_torch.extract``,
the int8 queue hop of ``SampleLoader`` (round trip, re-quantisation, passthrough),
and a spawned worker's imports.

Maps from ``tests/resources`` beside seeded WAVE files; a tiny seeded model
(plain PyTorch ops on the CPU).
"""
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cm3p_tpu.audio.device_mel import DeviceLogMel as JaxDeviceLogMel
from cm3p_torch.audio.device_mel import DeviceLogMel
from cm3p_torch.audio.mel import LogMelExtractor
from cm3p_torch.data import BeatmapFilesDatasetFactory, SampleLoader
from cm3p_torch.data.loader import _dequantize_features_from_ipc, _quantize_features_for_ipc
from cm3p_torch.extract import _random_model, configure_mel_wire, extract_embeddings, main
from cm3p_torch.models import EncoderOptions
from cm3p_torch.processing import CM3PProcessor

REPO = Path(__file__).resolve().parent.parent
SR = 16000
TOTAL = 480000  # one 30 s chunk
WINDOW = dict(max_length=512, window_length_sec=16.0, window_stride_sec=16.0)


def _waveform(n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    return (0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def _write_wav(path, samples):
    import struct

    data = samples.astype("<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, SR, SR * 4, 4, 32)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE"
                     + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data)


@pytest.fixture(scope="module")
def map_folders(tmp_path_factory) -> Path:
    """Two map folders, each .osu beside the ``audio.wav`` it names (50 s and 40 s of seeded audio)."""
    root = tmp_path_factory.mktemp("maps")
    for i, (name, seconds) in enumerate((("std_sliders_fixture.osu", 50), ("taiko_fixture.osu", 40))):
        folder = root / f"set{i}"
        folder.mkdir()
        text = (REPO / "tests" / "resources" / name).read_text(encoding="utf-8")
        text = "".join("AudioFilename: audio.wav\n" if line.startswith("AudioFilename:") else line
                       for line in text.splitlines(keepends=True))
        (folder / name).write_text(text, encoding="utf-8")
        _write_wav(folder / "audio.wav", _waveform(SR * seconds, seed=i))
    return root


def _processor(wire: str = "full") -> CM3PProcessor:
    proc = CM3PProcessor()
    proc.default_kwargs["beatmap_kwargs"].update(WINDOW)
    if wire != "full":
        assert configure_mel_wire(proc, True, True, True, wire) == wire
    return proc


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


# ------------------------------------------------------------ DeviceLogMel


@pytest.fixture(scope="module")
def mels():
    fe = LogMelExtractor()
    jax_mel = jax.jit(JaxDeviceLogMel(fe.feature_size, fe.sampling_rate, fe.hop_length, fe.n_fft).__call__)
    return fe, jax_mel, DeviceLogMel(fe.feature_size, fe.sampling_rate, fe.hop_length, fe.n_fft, device="cpu")


def _device_pair(mels, pcm):
    _, jax_mel, ours = mels
    dense, tail = ours(torch.as_tensor(pcm))
    jd, jt = jax_mel(jnp.asarray(pcm))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tail.numpy(), np.asarray(jt), rtol=0, atol=1e-5)
    return dense.numpy(), tail.numpy()


@pytest.mark.parametrize("seconds", [16.0, 2.0], ids=["production_window", "short_window"])
def test_device_mel_matches_jax_and_the_host(mels, seconds):
    fe = mels[0]
    real = _waveform(int(SR * seconds), seed=int(seconds))
    f_cap = -(-fe.max_real_frames(len(real) + 1) // 8) * 8
    pcm = np.zeros((1, f_cap * fe.hop_length), np.float32)
    pcm[0, : len(real)] = real
    dense, tail = _device_pair(mels, pcm)
    host = fe(real, total_samples=TOTAL)
    np.testing.assert_allclose(dense[0], host[:, :f_cap], rtol=0, atol=1e-4)
    np.testing.assert_allclose(host[:, f_cap:], tail[0], rtol=0, atol=1e-4)


def test_device_mel_all_zero_window(mels):
    fe = mels[0]
    dense, tail = _device_pair(mels, np.zeros((1, 64 * fe.hop_length), np.float32))
    host = fe(np.zeros(16, np.float32), total_samples=TOTAL)
    np.testing.assert_allclose(dense, host[0, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tail[0], host[0, -1], rtol=0, atol=1e-5)


def test_device_mel_windows_are_independent(mels):
    fe, _, ours = mels
    s_cap = 128 * fe.hop_length
    pcm = np.zeros((2, s_cap), np.float32)
    t = np.arange(s_cap // 2) / SR
    pcm[0, : s_cap // 2] = 0.001 * np.sin(2 * np.pi * 220 * t)
    pcm[1, : s_cap // 2] = 0.9 * np.sin(2 * np.pi * 220 * t)
    dense, tail = _device_pair(mels, pcm)
    solo_dense, solo_tail = ours(torch.as_tensor(pcm[:1]))
    np.testing.assert_allclose(dense[0], solo_dense[0].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tail[0], solo_tail[0].numpy(), rtol=0, atol=1e-6)


def test_device_mel_leaves_the_tf32_setting_as_it_was(mels):
    pcm = torch.as_tensor(_waveform(SR * 2)[None, : 100 * 160])
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        dense, _ = mels[2](pcm)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        torch.backends.cuda.matmul.allow_tf32 = False
        again, _ = mels[2](pcm)
        assert torch.equal(dense, again)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# ------------------------------------------------------------ the wires


def test_configure_mel_wire_follows_the_jax_tools_conditions():
    proc = CM3PProcessor()  # 30 s windows: the zero tail does not fit the chunk
    assert configure_mel_wire(proc, True, True, True, "int8") == "full"
    proc = _processor()
    assert configure_mel_wire(proc, False, True, True, "bf16") == "full"  # dense path
    assert configure_mel_wire(proc, True, False, True, "bf16") == "full"  # no audio
    assert configure_mel_wire(proc, True, True, False, "bf16") == "full"  # --no-compact-mel
    assert "compact_tail" not in proc.default_kwargs["audio_kwargs"]
    assert configure_mel_wire(proc, True, True, True, "pcm") == "pcm"
    assert proc.default_kwargs["audio_kwargs"].get("pcm_wire") and "compact_tail" not in proc.default_kwargs[
        "audio_kwargs"]
    assert configure_mel_wire(proc, True, True, True, "bf16") == "bf16"
    assert proc.default_kwargs["audio_kwargs"].get("compact_tail") and "pcm_wire" not in proc.default_kwargs[
        "audio_kwargs"]
    with pytest.raises(ValueError):
        configure_mel_wire(proc, True, True, True, "fp8")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_compact_wire_is_bit_equal_to_the_full_wire(map_folders, dtype):
    out, wire_bytes = {}, {}
    for wire in ("full", "bf16"):
        proc = _processor(wire)
        samples = SampleLoader(BeatmapFilesDatasetFactory([str(map_folders)], proc, include_audio=True))
        model = _random_model(proc, True, torch.device("cpu"), dtype, EncoderOptions())
        stats, windows = {}, {}
        emb = extract_embeddings(model, proc, samples, device="cpu", batch_size=8, stats=stats, windows_out=windows)
        out[wire] = (emb, windows)
        wire_bytes[wire] = stats["wire_bytes"] / stats["windows"]
        assert stats["host"] == {"parse_native": 2, "parse_python": 0, "decode_native": 2, "decode_python": 0}
    (emb_full, win_full), (emb_compact, win_compact) = out["full"], out["bf16"]
    assert emb_full.keys() == emb_compact.keys() and len(emb_full) == 2
    for k in emb_full:
        np.testing.assert_array_equal(win_compact[k], win_full[k])
        np.testing.assert_array_equal(emb_compact[k], emb_full[k])
    f_cap = CM3PProcessor()._compact_frames(16.0, SR)
    assert wire_bytes == {"full": 80 * 3000 * 4, "bf16": 80 * f_cap * (4 if dtype == torch.float32 else 2) + 4}


def _cli(map_folders, tmp_path, tag, *extra):
    import pandas as pd

    out = tmp_path / f"{tag}.parquet"
    main(["--beatmap-files", str(map_folders), "--output", str(out), "--tiny-model", "--device", "cpu",
          "--max-length", "512", "--window-length", "16", "--batch-size", "8", *extra])
    table = pd.read_parquet(out)
    return {int(i): np.asarray(e, np.float32) for i, e in zip(table["beatmap_id"], table["embedding"])}


def test_int8_and_pcm_wires_track_the_compact_wire(map_folders, tmp_path):
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    base = _cli(map_folders, tmp_path, "bf16")
    for wire in ("int8", "pcm"):
        got = _cli(map_folders, tmp_path, wire, "--mel-wire", wire)
        assert got.keys() == base.keys() and len(got) == 2
        cos = np.array([_cos(got[k], base[k]) for k in base])
        assert np.isfinite(np.stack(list(got.values()))).all()
        assert cos.min() > 0.999, (wire, cos)
    full = _cli(map_folders, tmp_path, "full_python", "--no-compact-mel", "--no-native")
    for k in base:
        np.testing.assert_array_equal(full[k], base[k])


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_the_cli_with_int8_ipc_tracks_the_compact_wire(wire, map_folders, tmp_path):
    """``--int8-ipc`` through one loader worker: the int8 wire takes the workers' codes, the bf16 wire
    dequantises them; both stay at cosine > 0.999 to the inline bf16 wire."""
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    base = _cli(map_folders, tmp_path, "bf16")
    got = _cli(map_folders, tmp_path, f"{wire}_ipc", "--mel-wire", wire, "--int8-ipc", "--num-workers", "1")
    assert got.keys() == base.keys() and len(got) == 2
    cos = np.array([_cos(got[k], base[k]) for k in base])
    assert np.isfinite(np.stack(list(got.values()))).all() and cos.min() > 0.999, cos


def test_dense_path_refuses_the_compact_wire(map_folders):
    proc = _processor("bf16")
    samples = list(SampleLoader(BeatmapFilesDatasetFactory([str(map_folders)], proc, include_audio=True)))
    model = _random_model(proc, True, torch.device("cpu"), torch.float32, EncoderOptions())
    with pytest.raises(ValueError, match="packed path"):
        extract_embeddings(model, proc, samples, device="cpu", pack=False)


# ------------------------------------------------------------ int8 over the worker queue


def _mels(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((80, 1608)) * rng.uniform(0.01, 3.0)).astype(np.float32) for _ in range(n)]


def test_ipc_round_trip_and_requantisation():
    """Dequantised values are within half a scale; quantising them again with the int8 device wire's
    quantizer (which divides by the scale where the queue hop multiplies by its inverse) gives the same
    scale and the same codes, so the passthrough changes no number."""
    for f in _mels():
        q = _quantize_features_for_ipc({"input_features": f, "input_ids": np.arange(3)})
        assert q["input_features"].dtype == np.int8 and q["input_ids"] is not None
        s = q["_input_features_ipc_scale"]
        d = _dequantize_features_from_ipc(dict(q))
        assert "_input_features_ipc_scale" not in d
        # half a scale, plus the float32 rounding of x * (1 / s) and of code * s
        assert np.abs(d["input_features"] - f).max() <= 0.5 * s + 4 * np.finfo(np.float32).eps * np.abs(f).max()
        s2 = float(np.max(np.abs(d["input_features"]))) / 127.0 or 1.0
        assert np.float32(s2) == s
        np.testing.assert_array_equal(np.rint(d["input_features"] / s2).astype(np.int8), q["input_features"])
    pcm = {"input_features_pcm": np.ones(4, np.float32)}
    assert _quantize_features_for_ipc(pcm) is pcm


def test_the_two_quantizers_differ_by_at_most_one_code():
    """The queue hop's ``rint(x * (1 / s))`` and the device wire's ``rint(x / s)`` on the same mel."""
    differ, total = 0, 0
    for f in _mels():
        s = float(np.max(np.abs(f))) / 127.0
        a = np.rint(f * np.float32(1.0 / s)).astype(np.int16)
        b = np.rint(f / s).astype(np.int16)
        assert np.abs(a - b).max() <= 1
        differ += int((a != b).sum())
        total += a.size
    assert differ / total < 1e-3


def test_int8_ipc_passthrough_equals_dequantising(map_folders, tmp_path):
    """Workers' int8 codes reach the consumer as they are; the int8 wire takes them (the same embeddings
    as on dequantised samples, which it quantises again) and the bf16 wire dequantises them on the host."""
    proc = _processor("int8")
    factory = BeatmapFilesDatasetFactory([str(map_folders)], proc, include_audio=True)
    model = _random_model(proc, True, torch.device("cpu"), torch.float32, EncoderOptions())
    loader = SampleLoader(factory, num_workers=1, log_dir=str(tmp_path), int8_ipc=True, startup_timeout=120)
    samples = list(loader)
    assert samples and all(s["input_features"].dtype == np.int8 and "_input_features_ipc_scale" in s
                           for s in samples)
    assert loader.host_counts["parse_native"] == 2 and loader.host_counts["decode_native"] == 2
    dequantised = [_dequantize_features_from_ipc(dict(s)) for s in samples]
    for wire in ("int8", "bf16"):
        out = []
        for given in (samples, dequantised):
            windows = {}
            extract_embeddings(model, proc, given, device="cpu", batch_size=8, mel_wire=wire, windows_out=windows)
            out.append(windows)
        assert out[0].keys() == out[1].keys()
        for k in out[0]:
            np.testing.assert_array_equal(out[0][k], out[1][k])


@pytest.mark.parametrize("pack", [True, False], ids=["packed", "unpacked"])
def test_int8_ipc_codes_of_the_full_mel_are_dequantised(map_folders, pack):
    """The full fp32 mel quantised for the queue hop, on the packed and the unpacked path: the same
    embeddings as the dequantised samples."""
    proc = _processor("full")
    samples = list(BeatmapFilesDatasetFactory([str(map_folders)], proc, include_audio=True)(0, 1))
    codes = [_quantize_features_for_ipc(s) for s in samples]
    assert all(c["input_features"].dtype == np.int8 for c in codes)
    model = _random_model(proc, True, torch.device("cpu"), torch.float32, EncoderOptions())
    out = []
    for given in (codes, [_dequantize_features_from_ipc(dict(c)) for c in codes]):
        windows = {}
        extract_embeddings(model, proc, given, device="cpu", pack=pack, batch_size=8, mel_wire="full",
                           windows_out=windows)
        out.append(windows)
    for k in out[1]:
        np.testing.assert_array_equal(out[0][k], out[1][k])


# ------------------------------------------------------------ a spawned worker's imports


def test_a_spawned_worker_imports_no_torch(map_folders):
    """A loader worker unpickles the factory (with a processor that has parsed natively), builds the
    dataset and processes a map without importing torch."""
    proc = _processor("bf16")
    proc(beatmap=str(next((map_folders / "set0").glob("*.osu"))))
    factory = BeatmapFilesDatasetFactory([str(map_folders)], proc, include_audio=True)
    script = ("import pickle, sys; factory = pickle.loads(sys.stdin.buffer.read()); "
              "sample = next(iter(factory(0, 1))); "
              "print(sorted(sample), 'torch' in sys.modules, factory.processor.host_counts)")
    run = subprocess.run([sys.executable, "-c", script], input=pickle.dumps(factory), cwd=REPO,
                         capture_output=True, timeout=300)
    assert run.returncode == 0, run.stderr.decode()[-3000:]
    line = run.stdout.decode().strip().splitlines()[-1]
    assert "'input_features_tail'" in line and " False " in line, line
    assert "'parse_native': 2" in line or "'parse_native': 1" in line, line
