"""Extract embeddings for a folder of beatmaps and explore them: the port's ``examples/extract_and_explore.py``.

    python -m cm3p_torch.explore --beatmaps my_maps/ --output explore/
    python -m cm3p_torch.explore --beatmaps my_maps/ --output explore/ --model-dir out/model --device cpu

Runs the port's extraction tool (:mod:`cm3p_torch.extract`, without audio; a seeded tiny model at
``--max-length 1024`` when no ``--model-dir`` is given) into ``embeddings.parquet``, optionally merged
with a precomputed parquet, then the host library's analytics core (:mod:`cm3p_torch.native`: PCA to 2-D,
k-means, L2 normalisation, k nearest neighbours), and writes ``embeddings_projected.parquet`` (the table
with ``x``, ``y`` and ``cluster``) and ``embeddings_viz.json`` (records the browser visualizer loads),
prints the nearest neighbours of the first beatmap and, last, one JSON summary. Runs on ``cuda`` unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from . import extract, native

_VIZ_COLUMNS = ("beatmap_id", "Title", "Artist", "Creator", "Version", "Status", "Cs")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m cm3p_torch.explore", description=__doc__.split("\n\n")[0])
    parser.add_argument("--beatmaps", required=True, help=".osu/.osz files or directories")
    parser.add_argument("--output", required=True, help="output directory")
    parser.add_argument("--model-dir", default=None, help="trained model dir (a seeded tiny model if absent)")
    parser.add_argument("--processor-dir", default=None)
    parser.add_argument("--merge-with", default=None, help="precomputed embeddings parquet")
    parser.add_argument("--clusters", type=int, default=8)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    ns = build_parser().parse_args(argv)
    out_dir = Path(ns.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    emb_path = out_dir / "embeddings.parquet"

    # 1. extract embeddings through the tool's own entry point
    args = ["--beatmap-files", ns.beatmaps, "--output", str(emb_path), "--no-audio"]
    args += ["--model-dir", ns.model_dir] if ns.model_dir else ["--tiny-model", "--max-length", "1024"]
    for flag, value in (("--processor-dir", ns.processor_dir), ("--merge-with", ns.merge_with),
                        ("--device", ns.device)):
        if value:
            args += [flag, value]
    extract.main(args)

    # 2. analytics: PCA projection, clusters, neighbours
    import pandas as pd

    df = pd.read_parquet(emb_path)
    emb = np.stack(df["embedding"].to_numpy()).astype(np.float32)
    points = native.calculate_pca(emb)
    labels = native.calculate_kmeans(emb, k=min(ns.clusters, len(emb)))
    normalized = native.normalize_vectors(emb)

    df["x"], df["y"], df["cluster"] = points[:, 0], points[:, 1], labels
    df.to_parquet(out_dir / "embeddings_projected.parquet", index=False)

    # visualizer-ready JSON (read offline, no parquet parser needed)
    viz = df[[c for c in _VIZ_COLUMNS if c in df.columns]].copy()
    viz["embedding"] = [list(map(float, e)) for e in emb]
    viz.to_json(out_dir / "embeddings_viz.json", orient="records")

    # 3. the neighbour report of the first beatmap
    if len(emb) > 1:
        idx, dist = native.find_nearest_neighbors(normalized, 0, min(5, len(emb) - 1))
        names = df["Title"].fillna("").tolist() if "Title" in df else [str(i) for i in range(len(df))]
        print(f"\nNearest neighbors of '{names[0]}':")
        for i, (j, d) in enumerate(zip(idx, dist), 1):
            print(f"  {i}. {names[j]} (cosine distance {d:.4f})")

    summary = {
        "beatmaps": len(df),
        "clusters": int(labels.max()) + 1 if len(labels) else 0,
        "outputs": [str(emb_path), str(out_dir / "embeddings_viz.json")],
        "next": "serve visualizer/ and load embeddings_viz.json",
    }
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
