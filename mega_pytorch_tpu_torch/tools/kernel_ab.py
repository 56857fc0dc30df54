"""This tree's relation-attention and position-bias kernels against another
tree's, on one CUDA card, in one process.

    python -m mega_pytorch_tpu_torch.tools.kernel_ab --parent DIR [--out FILE]

DIR is an unpacked checkout of the other commit (``git archive``). Both
trees' ``csrc`` are built into their own libraries and called through the
wrappers' launch functions on the same inputs (``tools/kernel_bench``, as
``chip_smoke.py`` makes them):

- modes "none" and "input" and ``fused_position_bias`` at the flagship's
  shapes, one lane and 12: the two libraries' outputs must be bit-identical
  (the run fails otherwise);
- mode "compute" at stages 0-2 (N, M = 675, 3750 / 675, 750 / 300, 750),
  one lane and 12: the time of each library's kernel (CUDA events around 10
  back-to-back launches, median of turns that alternate them), and this
  tree's error against the tiled and the flat plain versions (largest and
  mean);
- the two-kernel route that computes the same function, ``fused_position_bias``
  per lane and then mode "input", timed with this tree's library.

Prints one JSON line (also written to FILE) with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from ..ops.kernels import position_bias as pb
from ..ops.kernels import relation_attention as ra
from ..ops.kernels.build import build_library, load_library
from ..ops.kernels.position_bias import kernel_params
from .kernel_bench import attention_inputs, per_lane, time_alternating

STAGES = (("stage 0", 675, 3750), ("stage 1", 675, 750), ("stage 2", 300, 750))


def _attend(lib, x, mode, bias=None):
    """One launch of mode ``mode`` from ``lib`` (f32 out)."""
    pos = mode == ra.MODE_COMPUTE
    return ra._launch(x["q"], x["k"], x["v"], x["uk"], x["valid"], mode,
                      x["rois"] if pos else None, x["refs"] if pos else None,
                      kernel_params(x["wk"], x["wb"]) if pos else None, bias, lib=lib)


def _lane_bias(lib, x, params, out=None):
    """(B, 16, N, M) log bias by one ``fused_position_bias`` launch per lane."""
    b, _, n, _ = x["q"].shape
    if out is None:
        out = torch.empty((b, 16, n, x["k"].shape[2]), device=x["q"].device)
    for i in range(b):
        pb._launch(x["rois"][i], x["refs"][i], params, out[i], lib=lib)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--turns", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    new = load_library()
    old = build_library(args.parent / "mega_pytorch_tpu_torch" / "csrc",
                        args.parent / "mega_pytorch_tpu_torch" / "csrc" / "build")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    record = {"device": smi, "identical": {}, "compute": [], "route": []}

    def same(label, a, b):
        equal = torch.equal(a, b)
        record["identical"][label] = equal
        print(f"[ab] {label}: bit for bit the same: {equal}", flush=True)
        if not equal:
            raise SystemExit(f"kernel_ab: {label} differs")

    for b in (1, 12):
        for n, m in ((2175, 750), (300, 750)):
            x = attention_inputs(gen, b, n, m, dev)
            same(f"none B={b} N={n} M={m}", _attend(old.lib, x, ra.MODE_NONE),
                 _attend(new.lib, x, ra.MODE_NONE))
        x = attention_inputs(gen, b, 675, 3750, dev)
        params = kernel_params(x["wk"], x["wb"])
        bias_old = _lane_bias(old.lib, x, params)
        bias_new = _lane_bias(new.lib, x, params)
        same(f"fused_position_bias x{b} (675, 3750)", bias_old, bias_new)
        same(f"input B={b} N=675 M=3750", _attend(old.lib, x, ra.MODE_INPUT, bias_new),
             _attend(new.lib, x, ra.MODE_INPUT, bias_new))
        del bias_old, bias_new

        for label, n, m in STAGES:
            x = attention_inputs(gen, b, n, m, dev)
            got = _attend(new.lib, x, ra.MODE_COMPUTE)
            args_ = (x["q"], x["k"], x["v"], x["uk"], x["rois"], x["refs"], x["wk"],
                     x["wb"], x["valid"])
            tiled = per_lane(ra.reference_relation_attention_pos_tiled, args_, b)
            flat = per_lane(ra.reference_relation_attention_pos, args_, b)
            ms_old, ms_new = time_alternating(
                [lambda lib=lib: _attend(lib, x, ra.MODE_COMPUTE) for lib in (old.lib, new.lib)],
                args.turns)
            row = dict(stage=label, B=b, N=n, M=m, ms_parent=ms_old, ms=ms_new,
                       err_tiled=(got - tiled).abs().max().item(),
                       mean_err_tiled=(got - tiled).abs().mean().item(),
                       err_flat=(got - flat).abs().max().item(),
                       mean_err_flat=(got - flat).abs().mean().item())
            record["compute"].append(row)
            print(f"[ab] compute {label} B={b}: parent {ms_old:.4f} ms, this tree "
                  f"{ms_new:.4f} ms; err tiled "
                  f"{row['err_tiled']:.3e} (mean {row['mean_err_tiled']:.2e}), flat "
                  f"{row['err_flat']:.3e} (mean {row['mean_err_flat']:.2e})", flush=True)
            if label == "stage 0":
                params = kernel_params(x["wk"], x["wb"])
                bias = _lane_bias(new.lib, x, params)
                ms_bias, ms_input = time_alternating(
                    [lambda: _lane_bias(new.lib, x, params, bias),
                     lambda: _attend(new.lib, x, ra.MODE_INPUT, bias)], args.turns)
                route = dict(B=b, bias_ms=ms_bias, input_ms=ms_input,
                             route_ms=ms_bias + ms_input, compute_ms=ms_new)
                record["route"].append(route)
                print(f"[ab] route fused_position_bias x{b} + input, stage 0: "
                      f"{ms_bias:.4f} + {ms_input:.4f} ms against compute "
                      f"{ms_new:.4f} ms", flush=True)
                del bias
            del x, got, tiled, flat
            torch.cuda.empty_cache()
    print(f"[ab] {smi}")
    line = json.dumps(record)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
