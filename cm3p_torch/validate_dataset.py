"""Dataset QA: a full-epoch scan with token statistics and drift checks (the port's ``validate_dataset.py``).

    python -m cm3p_torch.validate_dataset --config-name v7 'dataset.train_dataset_paths=[ROOT]' dataset.train_dataset_end=100

Iterates the configured training dataset through the processor (parsing,
tokenization and windowing, no model), accumulating the token-length
distribution, throughput, and the YEAR-token distribution across six slices
of the epoch. Writes ``<output-dir>/stats.json`` and, where matplotlib
imports, ``validation.png``; prints the token-length statistics as one JSON
line.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def main(argv=None) -> dict:
    from .data import MmrsDataset
    from .train.__main__ import CONFIG_DIR, build_processor, dataset_config
    from .utils.config import load_config

    parser = argparse.ArgumentParser(prog="python -m cm3p_torch.validate_dataset", description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-name", default="v1")
    parser.add_argument("--config-dir", default=str(CONFIG_DIR))
    parser.add_argument("--output-dir", default="dataset_validation")
    parser.add_argument("--max-samples", type=int, default=0, help="0 = full epoch")
    parser.add_argument("overrides", nargs="*")
    ns = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)

    args = load_config(ns.config_dir, ns.config_name, ns.overrides)
    ds_cfg = dataset_config(args)
    processor = build_processor(args)
    dataset = MmrsDataset(ds_cfg, processor, test=False, seed=0)

    mt = processor.metadata_tokenizer
    year_ids = {mt.convert_tokens_to_ids(f"[YEAR_{y}]"): y for y in range(mt.min_year, mt.max_year + 1)}

    token_lengths = []
    year_counts_per_slice: dict[int, Counter] = defaultdict(Counter)
    n_samples = 0
    n_tokens = 0
    t0 = time.perf_counter()

    # an estimate of the epoch's size, to cut it into 6 drift slices
    est_total = max(len(dataset.get_filtered_metadata()) * 12, 1)

    for sample in dataset:
        length = int(np.asarray(sample["attention_mask"]).sum())
        token_lengths.append(length)
        n_tokens += length
        slice_idx = min(n_samples * 6 // est_total, 5)
        meta_ids = np.asarray(sample.get("metadata_ids", np.zeros(0, np.int32))).reshape(-1)
        for tid in meta_ids:
            if int(tid) in year_ids:
                year_counts_per_slice[slice_idx][year_ids[int(tid)]] += 1
        n_samples += 1
        if ns.max_samples and n_samples >= ns.max_samples:
            break
        if n_samples % 500 == 0:
            dt = time.perf_counter() - t0
            logger.info("%d samples, %.1f samples/s, %.0f tokens/s", n_samples, n_samples / dt, n_tokens / dt)

    dt = time.perf_counter() - t0
    lengths = np.asarray(token_lengths)
    stats = {
        "num_samples": n_samples,
        "samples_per_sec": n_samples / max(dt, 1e-9),
        "tokens_per_sec": n_tokens / max(dt, 1e-9),
        "token_length": {
            "mean": float(lengths.mean()) if n_samples else None,
            "p50": float(np.percentile(lengths, 50)) if n_samples else None,
            "p95": float(np.percentile(lengths, 95)) if n_samples else None,
            "max": int(lengths.max()) if n_samples else None,
        },
        "year_distribution_per_slice": {
            str(s): dict(sorted(c.items())) for s, c in sorted(year_counts_per_slice.items())
        },
    }

    out_dir = Path(ns.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "stats.json", "w") as f:
        json.dump(stats, f, indent=2)
    logger.info("Stats written to %s", out_dir / "stats.json")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 2, figsize=(12, 4))
        axes[0].hist(lengths, bins=50)
        axes[0].set_title("Token length histogram")
        for s, counter in sorted(year_counts_per_slice.items()):
            years = sorted(counter)
            total = sum(counter.values())
            axes[1].plot(years, [counter[y] / total for y in years], label=f"slice {s}")
        axes[1].set_title("YEAR token distribution drift")
        axes[1].legend()
        fig.tight_layout()
        fig.savefig(out_dir / "validation.png", dpi=120)
        plt.close(fig)
        logger.info("Plots written to %s", out_dir / "validation.png")
    except ImportError:
        logger.info("matplotlib not available; skipping plots")

    print(json.dumps(stats["token_length"]))
    return stats


if __name__ == "__main__":
    main()
