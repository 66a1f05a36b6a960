"""The port's explore entry point (``examples/extract_and_explore.py``'s counterpart) and the extraction
tool's ``--attn-impl``, ``--xla-int8`` and ``--cpu`` flags, on the CPU.

Four short maps of ``resources/perf_corpus`` go through ``python -m cm3p_torch.explore`` with the seeded tiny
model; the tool's flags are checked by their parsing and by the route the tool logs.
"""
import json
import logging
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from cm3p_torch.configs import tiny_cm3p_config
from cm3p_torch.extract import build_parser, main, options_from_args
from cm3p_torch.inference import load_model, save_pretrained
from cm3p_torch.interop import init_weights
from cm3p_torch.models import EncoderOptions
from cm3p_torch.processing import CM3PProcessor

CORPUS = Path(__file__).resolve().parent.parent / "resources" / "perf_corpus"
SHORT_MAPS = ("std_sparse_short.osu", "taiko_sparse_short.osu", "catch_sparse_short.osu", "mania_sparse_short.osu")


@pytest.fixture(scope="module")
def maps(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("maps")
    for name in SHORT_MAPS:
        shutil.copy(CORPUS / name, root / name)
    return root


def test_explore_writes_the_three_files_and_the_closing_json(maps, tmp_path, capsys):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    from cm3p_torch.explore import main as explore

    out = tmp_path / "explore"
    summary = explore(["--beatmaps", str(maps), "--output", str(out), "--clusters", "3", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.rindex("{\n"):]) == summary  # the closing JSON is the last output
    assert "Nearest neighbors of" in printed
    assert summary["beatmaps"] == len(SHORT_MAPS) and 1 <= summary["clusters"] <= 3
    table = pd.read_parquet(out / "embeddings_projected.parquet")
    assert {"beatmap_id", "embedding", "x", "y", "cluster"} <= set(table.columns) and len(table) == len(SHORT_MAPS)
    assert np.isfinite(table[["x", "y"]].to_numpy()).all()
    assert len(pd.read_parquet(out / "embeddings.parquet")) == len(SHORT_MAPS)
    viz = json.loads((out / "embeddings_viz.json").read_text())
    assert len(viz) == len(SHORT_MAPS) and all(len(v["embedding"]) == 32 for v in viz)


@pytest.mark.parametrize("argv,impl,device,want", [
    ([], "pallas", None, EncoderOptions(w8a8=True, fused_wo=True)),
    (["--attn-impl", "xla"], "xla", None, EncoderOptions(w8a8=True, fused_wo=True)),
    (["--xla-int8", "--precise"], "pallas", None, EncoderOptions(xla_int8=True)),
    (["--attn-impl", "xla", "--xla-int8", "--cpu"], "xla", "cpu", EncoderOptions(w8a8=True, fused_wo=True,
                                                                                 xla_int8=True)),
])
def test_the_route_flags_parse(argv, impl, device, want):
    ns = build_parser().parse_args(["--beatmap-files", "x", "--output", "y", *argv])
    assert ns.attn_impl == impl and ("cpu" if ns.cpu else None) == device
    assert options_from_args(ns) == want
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--beatmap-files", "x", "--output", "y", "--attn-impl", "triton"])


def test_attn_impl_xla_logs_its_route_and_runs_without_kernels(maps, tmp_path, caplog):
    pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    proc = CM3PProcessor()
    cfg = tiny_cm3p_config()
    cfg.beatmap_config.vocab_size = proc.beatmap_tokenizer.vocab_size
    cfg.beatmap_config.audio_token_id = proc.beatmap_tokenizer.audio_token_id
    model = load_model(cfg, init_weights(cfg, torch.Generator().manual_seed(0)), device="cpu", dtype=torch.float32)
    bundle = save_pretrained(model, tmp_path / "bundle", processor=proc)
    argv = ["--cpu", "--dtype", "float32", "--model-dir", str(bundle), "--beatmap-files", str(maps / SHORT_MAPS[0]),
            "--output", str(tmp_path / "x.parquet"), "--no-audio", "--max-length", "1024", "--attn-impl", "xla",
            "--xla-int8"]
    with caplog.at_level(logging.INFO):
        embeddings = main(argv)
    assert "--attn-impl xla: every op runs its plain PyTorch version on cpu" in caplog.text
    assert "xla_int8=True" in caplog.text and "reduce to" in caplog.text  # D's options dropped, logged once
    assert caplog.text.count("reduce to") == 1
    (vec,) = embeddings.values()
    assert np.isfinite(vec).all() and abs(float(np.linalg.norm(vec)) - 1.0) < 1e-5
