"""Readings that the limits of ``correct`` are set from, on the card.

    python3 benchmark/limits.py --workload <cell> --seeds 1 2 3 [--seconds 4] [--control 1]

For each seed: the cell's set-up, a short window at the cell's own load,
then the comparison numbers of the program's output and (with
``--control 1``) of the float8 control's against the float32 reference; a
training cell also reads the planted faults (half the batch, no exchange,
an altered label) in the reference put in the program's place. One JSON
line a seed. The benchmark's own runs never run this."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("limits.py: needs a CUDA card", file=sys.stderr)
        return 2
    driver = cell.driver()
    if cell.settings["driver"] == "train_ddp":
        for seed in args.seeds:
            got = driver.launch(cell, seed, args.seconds, False, time.time(),
                                controls=bool(args.control))
            ref = got["reference"]
            line = {"seed": seed, "reference_s": ref["reference_s"],
                    "program": driver.numbers(got[0]["first"], ref["reference"]),
                    "window": got[0]["window"], "setup_s": got[0]["setup_s"]}
            for side in ("control", "half_the_batch", "no_exchange", "answer_altered"):
                if side in ref:
                    line[side] = driver.numbers(ref[side], ref["reference"])
            print(json.dumps(line), flush=True)
        return 0
    for seed in args.seeds:
        t0 = time.time()
        r = driver.Run(cell, seed)
        with torch.no_grad():
            r.setup(driver.max_steps(args.seconds, cell.settings))
            r.warm()
        t_setup = time.time() - t0
        w = r.window(args.seconds)
        r.release()
        picks = r.sample(w["first"])
        t1 = time.time()
        line = {"seed": seed, "setup_s": t_setup, "window": w, "videos": picks,
                **r.compare(picks, bool(args.control))}
        line["reference_s"] = time.time() - t1
        print(json.dumps(line), flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
