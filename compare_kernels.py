#!/usr/bin/env python3
"""Time the LN-matmul and int8 FFN kernels of two checkouts on one card, in turns.

    python3 compare_kernels.py --parent DIR [--out DIR]

``DIR`` is another checkout of this repository (for example ``git archive
<commit> | tar -x -C _scratch/parent``). Each turn runs one tree's
``chip_smoke.check_quant_kernels`` (phase 7: the kernels against their plain
versions, then their times, plain times, bounds and ``torch.addmm`` at the
packed beatmap shape, 323,584 rows) in its own process, with that tree's
kernels built from its own sources, in the order parent, change, change,
parent, so that both are measured on the same card within one run. Prints the
card's name and power limit, each turn's timing lines and, per kernel form, the
four times; writes each turn's log and ``compare.json`` to ``--out``. Exits
non-zero if a turn fails. Needs one GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ORDER = ("parent", "change", "change", "parent")
TURN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from cm3p_torch import ops
from cm3p_torch.ops import _build
_build.build(("fused_ln_matmul", "fused_ffn"))
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
errs, report = chip_smoke.check_quant_kernels(torch, ops, gen, torch.device("cuda"), 79 * 4096)
fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")  # a report row, as check_quant_kernels documents
report = {name: dict(zip(fields, row, strict=True)) for name, row in report.items()}
print("REPORT " + json.dumps({"errs": errs, "report": report}), flush=True)
"""


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", required=True, type=Path, help="root of the other checkout")
    parser.add_argument("--out", type=Path, default=ROOT / "chiprun_out", help="directory for the logs")
    args = parser.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    results = []
    for turn, label in enumerate(ORDER):
        tree = (args.parent if label == "parent" else ROOT).resolve()
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", TURN, str(tree)], cwd=tree, capture_output=True, text=True,
                             timeout=900)
        (args.out / f"compare_{turn}_{label}.log").write_text(run.stdout + run.stderr)
        print(f"== {label} (turn {turn}) rc={run.returncode} {time.perf_counter() - t0:.1f} s", flush=True)
        for line in run.stdout.splitlines():
            if " ms (" in line:
                print("   ", line.strip(), flush=True)
        report = [line[7:] for line in run.stdout.splitlines() if line.startswith("REPORT ")]
        if run.returncode != 0 or not report:
            print((run.stdout + run.stderr)[-3000:], file=sys.stderr)
            return 1
        results.append({"tree": label, **json.loads(report[0])})
    (args.out / "compare.json").write_text(json.dumps({"card": card, "turns": results}, indent=1))
    for name, row in results[0]["report"].items():
        print(f"{name}: ms " + ", ".join(f"{r['tree']} {r['report'][name]['ms']:.3f}" for r in results), flush=True)
        if row["library_ms"] is not None:
            print(f"{name}, one PyTorch call: ms " + ", ".join(
                f"{r['tree']} {r['report'][name]['library_ms']:.3f}" for r in results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
