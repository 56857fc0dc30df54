"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell (set-up), measures for ``--seconds``, checks the
window's output against the plain reference and prints one JSON object as
the last line of standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics from a profiled stretch.
Needs as many CUDA cards as the cell names; never falls back to the CPU.
"""

from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every kernel and build cache at a fixed path inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".bench_cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".bench_cache" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import result
    from benchmark.harness.spec import load_cell

    t_process = min(result.process_start_time(), T_IMPORT)
    cell = load_cell(args.workload)
    if not (ROOT / "mega_pytorch_tpu_torch").is_dir():
        print("run.py: the program (mega_pytorch_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out, checks = cell.driver().run(cell, args.seed, args.seconds, bool(args.trace),
                                    t_process)
    found = result.loaded_forbidden()
    if found:
        print(f"run.py: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    summary = out.pop("trace", None)
    out["device"] = result.device_record(cell.chips, out.pop("memory_peak_bytes"), summary)
    result.emit(out, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
