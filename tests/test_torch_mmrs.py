"""The port's MMRS dataset against the JAX package's, on the CPU.

Builds its own MMRS root (:func:`build_mmrs_root`): three beatmapsets of two
generated maps each beside a 16 kHz mono WAVE (two ranked, one graveyard), and
a fourth set whose audio is a 44.1 kHz stereo 16-bit WAVE, so that a DT speed
resamples. The port's ``MmrsDataset`` (with the port's processor) and the JAX
``MmrsDataset`` (with the JAX processor) see the same root and seed and must
yield the same samples key for key: ids, masks, labels, variation classes and
``beatmap_id`` exactly; ``input_features`` within 1e-5 absolute, the bound the
port's mel holds to the JAX mel (``tests/test_torch_pipeline.py``). Then the
shards of an unseeded iteration, the factories across pickling and spawned
loader workers, a torch-free import of the dataset module, and
``build_processor``'s vocabularies against JAX ``train.build_processor``.
"""
import pickle
import subprocess
import sys
import wave
from datetime import datetime
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import train as jax_train
from cm3p_tpu.data import DatasetConfig as JaxDatasetConfig
from cm3p_tpu.data import MmrsDataset as JaxMmrsDataset
from cm3p_tpu.data import filter_mmrs_metadata as jax_filter
from cm3p_tpu.data import load_mmrs_metadata as jax_load
from cm3p_tpu.processing import CM3PProcessor as JaxProcessor
from cm3p_tpu.tokenize import MetadataTokenizer as JaxMetadataTokenizer
from cm3p_torch.data import (
    DatasetConfig,
    MmrsDataset,
    MmrsDatasetFactory,
    SampleLoader,
    filter_mmrs_metadata,
    load_mmrs_metadata,
)
from cm3p_torch.processing import CM3PProcessor
from cm3p_torch.tokenize import MetadataTokenizer
from cm3p_torch.train.__main__ import CONFIG_DIR, build_processor, model_config
from cm3p_torch.utils.config import load_config

REPO = Path(__file__).resolve().parent.parent
FEATURE_TOL = 1e-5

MINI_MAP = """osu file format v14

[General]
AudioFilename: {audio}
Mode: 0

[Metadata]
Title:Test
Creator:tester
BeatmapID:{bid}
BeatmapSetID:{sid}

[Difficulty]
CircleSize:4
SliderMultiplier:1.0
HPDrainRate:5

[TimingPoints]
0,500,4,2,1,70,1,0

[HitObjects]
{objects}
"""
# (set id, status, ranked, mapper id, mapper, tags, audio rate, channels)
SETS = (
    (100, "ranked", 1, 42, "tester", [1, 2], 16000, 1),
    (200, "ranked", 1, 43, "other", [3], 16000, 1),
    (300, "graveyard", -2, 42, "tester", [2, 5], 16000, 1),
    (400, "ranked", 1, 44, "third", [7], 44100, 2),
)


def write_wav(path: Path, seconds: float, rate: int, channels: int, seed: int) -> None:
    """A seeded 16-bit PCM WAVE: a sine plus noise, ``channels`` channels at ``rate``."""
    n = int(seconds * rate)
    t = np.arange(n) / rate
    rng = np.random.default_rng(seed)
    mono = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(n)
    data = np.stack([mono * (0.8 + 0.2 * c) for c in range(channels)], axis=1)
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes((np.clip(data, -1, 1) * 32767).astype("<i2").tobytes())


def make_osu(bid: int, sid: int, audio: str, n_objects: int = 40, spacing_ms: int = 450) -> str:
    objects = "\n".join(
        f"{(i * 37 + bid) % 512},{(i * 53) % 384},{i * spacing_ms + (bid % 7) * 10},1,0,0:0:0:0:"
        for i in range(n_objects)
    )
    return MINI_MAP.format(bid=bid, sid=sid, audio=audio, objects=objects)


def build_mmrs_root(root: Path, seconds: float = 20.0) -> Path:
    """An MMRS root of ``SETS``: ``metadata.parquet`` beside ``data/set_<id>/`` with two maps and their
    audio file each; returns ``root``."""
    rows = []
    for sid, status, ranked, uid, creator, tags, rate, channels in SETS:
        folder = f"set_{sid}"
        set_dir = root / "data" / folder
        set_dir.mkdir(parents=True)
        audio = "audio.wav"
        write_wav(set_dir / audio, seconds, rate, channels, seed=sid)
        for k in range(2):
            bid = sid + k
            fname = f"map_{bid}.osu"
            (set_dir / fname).write_text(make_osu(bid, sid, audio))
            rows.append({
                "BeatmapSetId": sid, "Id": bid, "BeatmapSetFolder": folder, "BeatmapFile": fname,
                "AudioFile": audio, "ModeInt": 0, "Mode": "osu", "Cs": 4.0, "Status": status, "Ranked": ranked,
                "UserId": uid, "Creator": creator, "SubmittedDate": datetime(2015 + k, 3, 1),
                "DifficultyRating": 4.0 + k,
                "StarRating": np.array([3.0, 3.5, 4.0 + k, 4.5 + k, 5.0, 5.5, 6.0]),
                "TopTagIds": np.array(tags),
            })
    pd.DataFrame(rows).to_parquet(root / "metadata.parquet")
    return root


@pytest.fixture(scope="module")
def mmrs_root(tmp_path_factory) -> Path:
    return build_mmrs_root(tmp_path_factory.mktemp("mmrs"))


VOCAB = dict(modes={0: "osu"}, statuses={1: "ranked", -2: "graveyard"},
             mappers={42: "tester", 43: "other", 44: "third"},
             tags={1: {"name": "a"}, 2: {"name": "b"}, 3: {"name": "c"}, 5: {"name": "d"}, 7: {"name": "e"}})


def _small(proc):
    proc.default_kwargs["beatmap_kwargs"].update({"max_length": 512, "window_length_sec": 10.0,
                                                  "window_stride_sec": 10.0})
    proc.default_kwargs["audio_kwargs"].update({"pad_to_multiple_of": 160000, "max_source_positions": 1000})
    return proc


def processors():
    return (_small(CM3PProcessor(metadata_tokenizer=MetadataTokenizer(**VOCAB))),
            _small(JaxProcessor(metadata_tokenizer=JaxMetadataTokenizer(**VOCAB))))


def configs(root: Path, **kw):
    base = dict(train_dataset_paths=[str(root)], test_dataset_paths=[str(root)], cycle_length=2,
                gamemodes=[0, 1, 2, 3], dt_augment_prob=0.0, metadata_dropout_prob=0.0,
                train_metadata_variations=1, test_metadata_variations=4)
    base.update(kw)
    return DatasetConfig(**base), JaxDatasetConfig(**base)


def assert_same_samples(ours: list, ref: list) -> None:
    assert len(ours) == len(ref) and ours, (len(ours), len(ref))
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.keys() == b.keys(), (i, sorted(a), sorted(b))
        for key in a:
            if key == "input_features":
                np.testing.assert_allclose(a[key], b[key], atol=FEATURE_TOL, err_msg=f"sample {i}")
            elif key == "beatmap_id":
                assert a[key] == b[key], (i, a[key], b[key])
            else:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=f"sample {i} {key}")


def test_load_and_filter_give_equal_dataframes(mmrs_root):
    ours, ref = load_mmrs_metadata(str(mmrs_root)), jax_load(str(mmrs_root))
    pd.testing.assert_frame_equal(ours, ref)
    for kw in (dict(start=0, end=2), dict(min_year=2016), dict(min_difficulty=4.5), dict(subset_ids=[200, 400]),
               dict(gamemodes=[0])):
        pd.testing.assert_frame_equal(filter_mmrs_metadata(ours, **kw), jax_filter(ref, **kw))


CASES = {
    "train": dict(test=False, kw={}),
    "test": dict(test=True, kw={}),
    "cycle1": dict(test=False, kw=dict(cycle_length=1)),
    "dt-augment": dict(test=False, kw=dict(dt_augment_prob=0.5)),
    "dropout-mismatch": dict(test=False, kw=dict(metadata_dropout_prob=0.2, beatmap_mismatch_prob=0.5,
                                                 train_metadata_variations=3)),
    "masked-lm": dict(test=False, kw=dict(labels="masked_lm", include_metadata=False, dt_augment_prob=0.5)),
    "ranked": dict(test=False, kw=dict(labels="ranked_classification", include_metadata=False,
                                       beatmap_mismatch_prob=0.5, cycle_length=1)),
    "source-metadata": dict(test=False, kw=dict(include_source_metadata=True, include_metadata=False)),
    "no-drop-last": dict(test=False, kw=dict(drop_last=False, cycle_length=3)),
}


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_samples_equal_the_jax_samples(mmrs_root, case, epoch):
    spec = CASES[case]
    cfg, jcfg = configs(mmrs_root, **spec["kw"])
    proc, jproc = processors()
    ours = list(MmrsDataset(cfg, proc, test=spec["test"], seed=7, epoch=epoch))
    ref = list(JaxMmrsDataset(jcfg, jproc, test=spec["test"], seed=7, epoch=epoch))
    assert_same_samples(ours, ref)
    if "labels" in spec["kw"] or case == "source-metadata":
        key = "labels" if "labels" in spec["kw"] else "beatmap_id"
        assert all(key in s for s in ours)
    if case == "ranked":
        assert {int(s["labels"]) for s in ours} == {0, 1}


@pytest.mark.parametrize("process_id", [0, 1])
@pytest.mark.parametrize("worker_id", [0, 1])
def test_shards_equal_the_jax_shards(mmrs_root, process_id, worker_id):
    """2 processes x 2 workers: each (process, worker) shard yields the JAX shard's samples."""
    cfg, jcfg = configs(mmrs_root, dt_augment_prob=0.5, labels="masked_lm", cycle_length=1)
    proc, jproc = processors()
    shard = dict(worker_id=worker_id, num_workers=2, process_id=process_id, process_count=2, seed=3)
    ours = list(MmrsDataset(cfg, proc, **shard))
    ref = list(JaxMmrsDataset(jcfg, jproc, **shard))
    assert_same_samples(ours, ref)


def test_a_dataset_continues_its_epochs_like_the_jax_dataset(mmrs_root):
    cfg, jcfg = configs(mmrs_root, dt_augment_prob=0.5)
    proc, jproc = processors()
    ours, ref = MmrsDataset(cfg, proc, seed=11), JaxMmrsDataset(jcfg, jproc, seed=11)
    first, second = list(ours), list(ours)
    assert_same_samples(first, list(ref))
    assert_same_samples(second, list(ref))
    assert [s["input_ids"].tolist() for s in first] != [s["input_ids"].tolist() for s in second]


def test_unseeded_shards_are_disjoint_and_cover_the_set(mmrs_root):
    cfg, _ = configs(mmrs_root, include_audio=False, include_metadata=False, include_source_metadata=True,
                     cycle_length=1)
    proc, _ = processors()
    seen = []
    for process_id in range(2):
        for worker_id in range(2):
            ds = MmrsDataset(cfg, proc, worker_id=worker_id, num_workers=2, process_id=process_id, process_count=2)
            seen.append({int(s["beatmap_id"]) for s in ds})
    everything = set().union(*seen)
    assert sum(len(s) for s in seen) == len(everything) == 8


def test_factories_survive_pickling_and_spawned_workers(mmrs_root, tmp_path):
    cfg, _ = configs(mmrs_root, include_source_metadata=True, dt_augment_prob=0.5)
    proc, _ = processors()
    train = MmrsDatasetFactory(cfg, proc, test=False, seed=5)
    extract = MmrsDatasetFactory(configs(mmrs_root, include_source_metadata=True, include_metadata=False,
                                         dt_augment_prob=0.0, cycle_length=1)[0], proc, test=False)
    for factory in (train, extract):
        clone = pickle.loads(pickle.dumps(factory))
        inline = sorted((int(s["beatmap_id"]), s["input_ids"].tobytes()) for s in SampleLoader(clone, 0))
        spawned = sorted((int(s["beatmap_id"]), s["input_ids"].tobytes())
                         for s in SampleLoader(factory, num_workers=2, log_dir=str(tmp_path)))
        assert {b for b, _ in spawned} == {b for b, _ in inline} and len({b for b, _ in inline}) == 8
        if factory is extract:  # no draw depends on the shard: the same windows
            assert spawned == inline


def test_the_dataset_module_imports_no_torch():
    code = ("import sys; import cm3p_torch.data.mmrs_dataset; "
            "print(sorted(m for m in ('torch', 'pandas', 'jax') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


@pytest.mark.parametrize("name, extra, n_tags", [("smoke_mmrs", [], 5), ("v7_classifier", ["dataset.min_year=2016"], 5),
                                                 ("v6", ["dataset.train_dataset_start=1", "dataset.train_dataset_end=3"], 3)])
def test_build_processor_vocabularies_equal_the_jax_ones(mmrs_root, name, extra, n_tags):
    overrides = [f"dataset.train_dataset_paths=[{mmrs_root}]", f"dataset.test_dataset_paths=[{mmrs_root}]", *extra]
    args = load_config(CONFIG_DIR, name, overrides)
    ours = build_processor(args)
    jargs = load_config(CONFIG_DIR, name, overrides)
    ref = jax_train.build_processor(jargs, JaxDatasetConfig(
        **{k: v for k, v in jargs["dataset"].items() if k != "synthetic"}))
    mt, jmt = ours.metadata_tokenizer, ref.metadata_tokenizer
    for attr in ("modes", "statuses", "mappers", "tags"):
        assert getattr(mt, attr) == getattr(jmt, attr), attr
    assert mt.vocab_size == jmt.vocab_size and mt.get_vocab() == jmt.get_vocab()
    assert len(mt.tags) == n_tags and mt.mappers
    cfg = model_config(args, ours)
    assert cfg.metadata_config.vocab_size == jmt.vocab_size
    assert cfg.beatmap_config.vocab_size == ref.beatmap_tokenizer.vocab_size


def test_a_missing_parquet_keeps_the_minimal_vocabularies(tmp_path, caplog):
    overrides = [f"dataset.train_dataset_paths=[{tmp_path}]"]
    ours = build_processor(load_config(CONFIG_DIR, "smoke_mmrs", overrides))
    assert "metadata vocabularies stay minimal" in caplog.text
    jargs = load_config(CONFIG_DIR, "smoke_mmrs", overrides)
    ref = jax_train.build_processor(jargs, JaxDatasetConfig(
        **{k: v for k, v in jargs["dataset"].items() if k != "synthetic"}))
    assert ours.metadata_tokenizer.get_vocab() == ref.metadata_tokenizer.get_vocab()
    assert not ours.metadata_tokenizer.mappers and not ours.metadata_tokenizer.tags
