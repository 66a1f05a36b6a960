"""The port's host C++ library against the JAX package, on the CPU.

The native parse -> lower -> window-tokenize gives window ids bit-equal to the
JAX package's Python path and to its native path over the five fixtures x the
eight parser variants of ``tests/test_native_beatmap.py`` x speeds 1.0 and 1.5,
and the port's processor gives the same outputs with ``native=True`` and
``native=False``; the native WAVE decode gives samples bit-equal to the JAX
package's ``_load_wav_bytes`` + ``to_mono`` + ``resample`` over the formats,
channel counts and rates of ``tests/test_native_audio.py``; the analytics core
and its numpy versions equal ``cm3p_tpu.native``'s; the native event groups equal
the port's Python parser's field by field. Also: the host build (a
hash-named library published by rename, several builders at once, a failed
build raising with the compiler's output through the processor, the WAVE
decode, the dataset and the loader's factory), the processor's counters, and a
natively parsing processor inside a spawned ``SampleLoader`` worker.
"""
import io
import math
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX side of every comparison runs on the CPU)
import numpy as np
import pytest

import cm3p_tpu.native as jax_native
from cm3p_tpu.audio import loading as jax_loading
from cm3p_tpu.beatmap import BeatmapEventParser as JaxParser
from cm3p_tpu.native import beatmap as jax_native_beatmap
from cm3p_tpu.processing import CM3PProcessor as JaxProcessor
from cm3p_torch import native
from cm3p_torch.audio import loading
from cm3p_torch.beatmap import BeatmapEventParser, load_beatmap
from cm3p_torch.beatmap.parser import get_song_length
from cm3p_torch.data import BeatmapFilesDataset, BeatmapFilesDatasetFactory, SampleLoader
from cm3p_torch.native.beatmap import NativeBeatmap
from cm3p_torch.processing import CM3PProcessor
from cm3p_torch.processing.processor import _metadata_from_summary, get_metadata

REPO = Path(__file__).resolve().parent.parent
FIXTURES = [
    REPO / "tests" / "resources" / "taiko_fixture.osu",
    REPO / "tests" / "resources" / "mania_fixture.osu",
    REPO / "tests" / "resources" / "std_sliders_fixture.osu",
    REPO / "tests" / "resources" / "catch_fixture.osu",
    REPO / "resources" / "Denkishiki Karen Ongaku Shuudan - Aoki Kotou no Anguis (OliBomby) [Ardens Spes].osu",
]
FIXTURE_IDS = ["taiko", "mania", "std_sliders", "catch", "bundled"]
PARSER_VARIANTS = [  # tests/test_native_beatmap.py's
    dict(),
    dict(slider_version=1),
    dict(add_hitsounds=False, add_distances=False),
    dict(add_snapping=False, add_kiai=False, add_sv=False),
    dict(mania_bpm_normalized_scroll_speed=False),
    dict(emit_mania_column=True),
    dict(add_timing_points=False),
    dict(add_positions=False),
]


@pytest.fixture(scope="module", autouse=True)
def jax_native_library():
    if not jax_native_beatmap.available():
        pytest.fail("the JAX package's native library did not build: no native side to compare with")


def _jax_call(monkeypatch, native_on: bool, **kwargs):
    monkeypatch.setenv("CM3P_NATIVE_PARSE", "1" if native_on else "0")
    variant = kwargs.pop("variant", {})
    proc = JaxProcessor(beatmap_parser=JaxParser(**variant))
    proc.rng = np.random.default_rng(1234)
    return proc(**kwargs)


def _port_call(native_on: bool, **kwargs):
    variant = kwargs.pop("variant", {})
    proc = CM3PProcessor(beatmap_parser=BeatmapEventParser(**variant), native=native_on)
    proc.rng = np.random.default_rng(1234)
    return proc(**kwargs), proc.host_counts


def _assert_same(a, b, what):
    assert set(a.keys()) == set(b.keys()), what
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{what}: {k}")


# ------------------------------------------------------------ parse + lower + tokenize


@pytest.mark.parametrize("speed", [1.0, 1.5])
@pytest.mark.parametrize("variant", range(len(PARSER_VARIANTS)))
@pytest.mark.parametrize("fixture", FIXTURES, ids=FIXTURE_IDS)
def test_window_ids_bit_equal_to_the_jax_python_and_native_paths(fixture, variant, speed, monkeypatch):
    kwargs = dict(beatmap=str(fixture), speed=speed, variant=PARSER_VARIANTS[variant])
    ours, counts = _port_call(True, **kwargs)
    assert counts["parse_native"] == 1 and counts["parse_python"] == 0
    python, counts = _port_call(False, **kwargs)
    assert counts["parse_python"] == 1 and counts["parse_native"] == 0
    _assert_same(ours, python, "port native vs port python")
    _assert_same(ours, _jax_call(monkeypatch, False, **kwargs), "port native vs JAX python")
    _assert_same(ours, _jax_call(monkeypatch, True, **kwargs), "port native vs JAX native")


GROUP_FIELDS = ("event_type", "time", "has_time", "snapping", "distance", "x", "y", "mania_column", "new_combo",
                "hitsounds", "samplesets", "additions", "volumes", "scroll_speed")


@pytest.mark.parametrize("variant", range(len(PARSER_VARIANTS)))
@pytest.mark.parametrize("fixture", FIXTURES, ids=FIXTURE_IDS)
def test_event_groups_equal_the_python_parser(fixture, variant):
    parser = BeatmapEventParser(**PARSER_VARIANTS[variant])
    bm = load_beatmap(fixture)
    song_length = get_song_length(None, None, bm)
    python = parser.parse_beatmap(bm, song_length=song_length)
    ours = NativeBeatmap.from_path(fixture).parse_events(parser, 1.0, song_length).to_groups()
    assert len(ours) == len(python)
    for i, (a, b) in enumerate(zip(python, ours)):
        for f in GROUP_FIELDS:
            assert getattr(a, f) == getattr(b, f), f"group {i} field {f}"


def test_audio_metadata_variations_match_the_python_path(monkeypatch):
    rng = np.random.default_rng(0)
    audio = (rng.standard_normal(16000 * 120) * 0.05).astype(np.float32)
    kwargs = dict(beatmap=str(FIXTURES[-1]), audio=audio, audio_sampling_rate=16000, metadata={"year": 2023},
                  multiply_metadata=True, populate_metadata=True, metadata_variations=3)
    ours, counts = _port_call(True, **kwargs)
    assert counts["parse_native"] == 1
    _assert_same(ours, _port_call(False, **kwargs)[0], "port native vs port python")
    _assert_same(ours, _jax_call(monkeypatch, True, **kwargs), "port native vs JAX native")


@pytest.mark.parametrize("kwargs", [dict(padding="max_length"), dict(max_length=512), dict(pad_to_multiple_of=64)],
                         ids=["max_length_padding", "max_length_512", "multiple_of_64"])
def test_padding_variants_match_the_python_path(kwargs):
    ours, counts = _port_call(True, beatmap=str(FIXTURES[2]), **kwargs)
    assert counts["parse_native"] == 1
    _assert_same(ours, _port_call(False, beatmap=str(FIXTURES[2]), **kwargs)[0], str(kwargs))


def test_a_parsed_beatmap_object_takes_the_python_path():
    proc = CM3PProcessor()
    out = proc(beatmap=load_beatmap(FIXTURES[0]))
    assert proc.host_counts["parse_python"] == 1 and proc.host_counts["parse_native"] == 0
    np.testing.assert_array_equal(out["input_ids"], proc(beatmap=str(FIXTURES[0]))["input_ids"])
    assert proc.host_counts["parse_native"] == 1


@pytest.mark.parametrize("fixture", FIXTURES, ids=FIXTURE_IDS)
def test_metadata_from_the_native_summary_matches(fixture):
    bm = load_beatmap(fixture)
    song_length = get_song_length(None, None, bm)
    assert _metadata_from_summary(NativeBeatmap.from_path(fixture).summary(), song_length, None) == get_metadata(
        beatmap=bm
    )


def test_malformed_beatmap_flags_a_parse_error(tmp_path):
    bad = tmp_path / "bad.osu"
    bad.write_text(
        "osu file format v14\n[General]\nMode: 0\n[TimingPoints]\n"
        "0,300,junk,0,0,100,1,0\n[HitObjects]\n256,192,1000,1,0,0:0:0:0:\n"
    )
    assert NativeBeatmap.from_path(bad).summary().parse_error == 1


# ------------------------------------------------------------ the processor across a spawn boundary


def test_natively_parsing_processor_runs_in_a_spawned_worker(tmp_path):
    """A processor that has parsed natively holds a ctypes table handle; pickling drops it, so the
    loader's spawned worker starts, parses natively and reports its counts back."""
    for i, fixture in enumerate(FIXTURES[:3]):
        folder = tmp_path / "maps" / f"set{i}"
        folder.mkdir(parents=True)
        (folder / fixture.name).write_bytes(fixture.read_bytes())
    proc = CM3PProcessor()
    proc(beatmap=str(FIXTURES[0]))
    assert proc._native_tables_cache is not None
    assert "_native_tables_cache" not in pickle.loads(pickle.dumps(proc)).__dict__
    factory = BeatmapFilesDatasetFactory([str(tmp_path / "maps")], proc, include_audio=False)
    inline = SampleLoader(factory, num_workers=0)
    want = list(inline)
    spawned = SampleLoader(factory, num_workers=1, log_dir=str(tmp_path / "logs"), startup_timeout=120)
    got = list(spawned)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _assert_same(a, b, "spawned worker vs inline")
    assert spawned.host_counts["parse_native"] == inline.host_counts["parse_native"] == 3
    assert spawned.host_counts["parse_python"] == 0


# ------------------------------------------------------------ WAVE decode


def make_wav(data: np.ndarray, rate: int, fmt: str, extra_chunk: bool = False) -> bytes:
    """A RIFF/WAVE buffer (``tests/test_native_audio.py``'s). ``data``: floats in [-1, 1), (N,) or (N, C)."""
    if data.ndim == 1:
        data = data[:, None]
    n, ch = data.shape
    if fmt == "pcm16":
        payload = (np.clip(data, -1, 1 - 1e-9) * 32768).astype("<i2").tobytes()
        code, width = 1, 2
    elif fmt == "pcm8":
        payload = ((np.clip(data, -1, 1 - 1e-9) + 1.0) * 128).astype(np.uint8).tobytes()
        code, width = 1, 1
    elif fmt == "pcm24":
        i32 = (np.clip(data, -1, 1 - 1e-9) * 2147483648).astype("<i4")
        payload = i32.view(np.uint8).reshape(-1, 4)[:, 1:].tobytes()
        code, width = 1, 3
    elif fmt == "pcm32":
        payload = (np.clip(data, -1, 1 - 1e-9) * 2147483648).astype("<i4").tobytes()
        code, width = 1, 4
    elif fmt == "f32":
        payload = data.astype("<f4").tobytes()
        code, width = 3, 4
    elif fmt == "f64":
        payload = data.astype("<f8").tobytes()
        code, width = 3, 8
    else:
        raise ValueError(fmt)
    block = width * ch
    fmt_chunk = struct.pack("<HHIIHH", code, ch, rate, rate * block, block, width * 8)
    chunks = [(b"LIST", b"INFOdata!")] if extra_chunk else []
    chunks += [(b"fmt ", fmt_chunk), (b"data", payload)]
    body = b"WAVE" + b"".join(
        cid + struct.pack("<I", len(c)) + c + (b"\x00" if len(c) % 2 else b"") for cid, c in chunks
    )
    out = io.BytesIO()
    out.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return out.getvalue()


def signal(n, ch, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    base = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * rng.standard_normal(n)
    if ch == 1:
        return np.clip(base, -0.99, 0.99)
    cols = [np.roll(base, 17 * c) * (1.0 - 0.1 * c) for c in range(ch)]
    return np.clip(np.stack(cols, axis=1), -0.99, 0.99)


def _jax_python_path(buf: bytes, target: int) -> np.ndarray:
    data, rate = jax_loading._load_wav_bytes(buf)
    return jax_loading.resample(jax_loading.to_mono(data), rate, target)


def _assert_decodes_bit_equal(buf: bytes, target: int):
    ours = loading._native_wav(buf, target)
    assert ours is not None and ours.dtype == np.float32
    want = _jax_python_path(buf, target)
    np.testing.assert_array_equal(ours, want)
    data, rate = loading._load_wav_bytes(buf)
    np.testing.assert_array_equal(loading.resample(loading.to_mono(data), rate, target), want)


@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("fmt", ["pcm16", "pcm8", "pcm24", "pcm32", "f32", "f64"])
def test_decode_bit_equal(fmt, ch):
    _assert_decodes_bit_equal(make_wav(signal(44100, ch), 16000, fmt), 16000)


@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("rate", [44100, 48000, 22050, 8000])
def test_decode_resample_bit_equal(rate, ch):
    _assert_decodes_bit_equal(make_wav(signal(rate // 2, ch, seed=rate + ch), rate, "pcm16"), 16000)


@pytest.mark.parametrize("case", ["capped_fraction", "upsample", "3_channels", "6_channels", "extra_chunks",
                                  "extensible"])
def test_decode_edge_cases_bit_equal(case):
    target = 16000
    if case == "capped_fraction":  # a 1.05x speed draw: the fraction caps at limit_denominator(128)
        buf, target = make_wav(signal(44100, 2, seed=3), 44100, "pcm16"), int(16000 // 1.05)
    elif case == "upsample":
        buf = make_wav(signal(8000, 1, seed=5), 8000, "pcm16")
    elif case.endswith("channels"):
        buf = make_wav(signal(20000, int(case[0]), seed=9), 16000, "pcm16")
    elif case == "extra_chunks":  # a LIST chunk, an odd-sized chunk, a trailing partial frame
        buf = make_wav(signal(10001, 2, seed=11), 44100, "pcm16", extra_chunk=True)[:-1]
    else:  # WAVE_FORMAT_EXTENSIBLE wrapping PCM16
        payload = (np.clip(signal(30000, 2, seed=13), -1, 1 - 1e-9) * 32768).astype("<i2").tobytes()
        fmt_chunk = (struct.pack("<HHIIHH", 0xFFFE, 2, 44100, 44100 * 4, 4, 16) + struct.pack("<HHI", 22, 16, 3)
                     + struct.pack("<H", 1) + b"\x00" * 14)
        body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt_chunk)) + fmt_chunk
                + b"data" + struct.pack("<I", len(payload)) + payload)
        buf = b"RIFF" + struct.pack("<I", len(body)) + body
    _assert_decodes_bit_equal(buf, target)


def test_load_audio_file_routes_and_counts(tmp_path):
    path = tmp_path / "t.wav"
    path.write_bytes(make_wav(signal(44100, 2, seed=21), 44100, "pcm16"))
    counts = {}
    fast = loading.load_audio_file(path, 16000, 1.5, counts=counts)
    slow = loading.load_audio_file(path, 16000, 1.5, native=False, counts=counts)
    np.testing.assert_array_equal(fast, slow)
    assert len(fast) == math.ceil(44100 * int(16000 // 1.5) / 44100)
    assert counts == {"decode_native": 1, "decode_python": 1}


def test_a_buffer_the_decoder_declines_takes_the_python_path(tmp_path):
    from cm3p_torch.native.audio import probe

    assert probe(b"OggS" + b"\x00" * 64) is None
    assert loading._native_wav(b"RIFF\x10\x00\x00\x00JUNK" + b"\x00" * 16, 16000) is None
    path = tmp_path / "junk.wav"
    path.write_bytes(b"RIFF\x10\x00\x00\x00JUNK" + b"\x00" * 16)
    counts = {}
    with pytest.raises(ValueError):  # the Python path raises the real error
        loading.load_audio_file(path, 16000, counts=counts)


# ------------------------------------------------------------ analytics core


def _embeddings(n=300, d=24, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("fn", ["pca", "kmeans", "kmeans_threads", "normalize", "normalize_threads", "knn"])
def test_analytics_equal_the_jax_package(fn, use_native, monkeypatch):
    x = _embeddings()
    if not use_native:  # the JAX package's numpy versions run where its library is missing
        monkeypatch.setattr(jax_native, "_load_lib", lambda: None)
    if fn == "pca":
        got, want = native.calculate_pca(x, native=use_native), jax_native.calculate_pca(x)
    elif fn.startswith("kmeans"):
        threads = 4 if fn.endswith("threads") else 1
        got = native.calculate_kmeans(x, 5, n_threads=threads, native=use_native)
        want = jax_native.calculate_kmeans(x, 5, n_threads=threads)
    elif fn.startswith("normalize"):
        threads = 3 if fn.endswith("threads") else 1
        got = native.normalize_vectors(x, n_threads=threads, native=use_native)
        want = jax_native.normalize_vectors(x, n_threads=threads)
    else:
        x = jax_native.normalize_vectors(x)
        got = native.find_nearest_neighbors(x, 3, 10, native=use_native)
        want = jax_native.find_nearest_neighbors(x, 3, 10)
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_analytics_edge_inputs():
    empty = np.zeros((0, 4), np.float32)
    assert native.calculate_pca(empty).shape == (0, 2)
    assert native.calculate_kmeans(empty, 3).shape == (0,)
    one = _embeddings(1, 4)
    assert native.find_nearest_neighbors(one, 0, 5)[0].shape == (0,)
    zero = np.zeros((2, 4), np.float32)
    np.testing.assert_array_equal(native.normalize_vectors(zero), zero)


# ------------------------------------------------------------ the host build


def test_concurrent_builders_publish_one_library(tmp_path):
    """Several processes build into an empty directory at once; each gets the one hash-named library."""
    script = ("import sys; from pathlib import Path; import cm3p_torch.native as n; "
              "n.BUILD_DIR = Path(sys.argv[1]); print(n.build())")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.iterdir()] == [Path(paths.pop()).name]


def _break_the_sources(tmp_path, monkeypatch):
    """Point the build at sources of which one does not compile, with no library loaded yet."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        (src / name).write_text("int ok_%s() { return 0; }\n" % Path(name).stem)
    (src / "analytics.cpp").write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)


FAILED_BUILD = r"host library build failed[\s\S]*analytics\.cpp[\s\S]*error"


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    _break_the_sources(tmp_path, monkeypatch)
    with pytest.raises(RuntimeError, match=FAILED_BUILD):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def _map_folder(root: Path) -> Path:
    """A map folder: the std fixture beside the ``audio.wav`` it names (20 s, 16 kHz)."""
    folder = root / "set0"
    folder.mkdir(parents=True)
    text = FIXTURES[2].read_text(encoding="utf-8")
    text = "".join("AudioFilename: audio.wav\n" if line.startswith("AudioFilename:") else line
                   for line in text.splitlines(keepends=True))
    (folder / FIXTURES[2].name).write_text(text, encoding="utf-8")
    (folder / "audio.wav").write_bytes(make_wav(signal(16000 * 20, 1, seed=3), 16000, "f32"))
    return folder


@pytest.mark.parametrize("route", ["processor", "load_audio_file", "dataset", "factory"])
def test_a_failed_build_raises_through_every_route(route, tmp_path, monkeypatch):
    """With ``native`` on, a build that fails raises with the compiler's output wherever the library is
    first needed: the processor's call, the WAVE decode, a dataset's iteration (not its per-file warnings)
    and the loader's factory (before any worker starts). With ``native`` off nothing is built."""
    folder = _map_folder(tmp_path / "maps")
    osu = str(next(folder.glob("*.osu")))
    _break_the_sources(tmp_path, monkeypatch)

    def run(on: bool):
        if route == "processor":
            return CM3PProcessor(native=on)(beatmap=osu)["input_ids"]
        if route == "load_audio_file":
            return loading.load_audio_file(folder / "audio.wav", 16000, native=on)
        if route == "dataset":
            return list(BeatmapFilesDataset([str(folder)], CM3PProcessor(native=on), include_audio=True))
        return BeatmapFilesDatasetFactory([str(folder)], CM3PProcessor(native=on), include_audio=True)(0, 1)

    with pytest.raises(RuntimeError, match=FAILED_BUILD):
        run(True)
    got = run(False)
    assert got is not None and (route == "factory" or len(got) > 0)
    assert native._LIB is None and not list((tmp_path / "build").glob("*.so"))


def test_the_library_name_follows_the_sources(tmp_path, monkeypatch):
    before = native.target()
    for name in native.SOURCES:
        (tmp_path / name).write_bytes((native.SOURCE_DIR / name).read_bytes())
    monkeypatch.setattr(native, "SOURCE_DIR", tmp_path)
    assert native.target().name == before.name
    (tmp_path / "audio_fast.cpp").write_text((tmp_path / "audio_fast.cpp").read_text() + "\n// edited\n")
    assert native.target().name != before.name
