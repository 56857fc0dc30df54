"""R-101 MEGA training from random weights under identity FrozenBN
statistics, in the JAX package and in the port from the same weights.

The ``mega_R_101`` preset at its full widths (fc0 100352 wide, R-101's 33
residual blocks), f32 on both sides, on a cut canvas (224x352, frames of
360x640 preprocessed as training preprocesses them). flax initialises the
weights, which leaves every FrozenBN at identity statistics; the port loads
them through ``state_dict_from_flax``. Take-all sampling (the protocol of
``tests/test_torch_train_models.py``) makes the losses independent of the
samplers' draws, so the two packages' losses are comparable step by step.
Each side then takes STEPS SGD steps with its own solver on one seeded
sample; the script prints the four losses of every step, side by
side, as one JSON line at the end, with how far a 1e-6 relative jitter of
the parameters moves each of JAX's first losses (the conditioning protocol
of the gradient test: under identity statistics the ROI features are huge,
so the attention stages' softmaxes are near one-hot and f32 noise moves the
ROI-head losses by far more than the flat tolerance). The first losses agree
when each differs by less than max(5e-4 + 1e-3 |loss|, 5x that movement).

This is the witness for the card runs' FrozenBN calibration
(``mega_pytorch_tpu_torch/tools/train_bench.py:calibrate_frozen_bn``): if the
JAX package diverges from these weights as the port does, the divergence
belongs to the model under identity statistics, not to the port.

Run from the repo root, on the CPU (a few GiB, several minutes):

    JAX_PLATFORMS=cpu python tests/r101_identity_bn_witness.py [--calibrate]

``--calibrate`` is the control: the statistics the card runs use, set by
the port and bridged into the JAX tree, in both packages.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mega_pytorch_tpu.config import get_preset as jax_preset  # noqa: E402
from mega_pytorch_tpu.engine.trainer import assemble_inputs as jax_assemble  # noqa: E402
from mega_pytorch_tpu.engine.trainer import make_train_step  # noqa: E402
from mega_pytorch_tpu.models.detectors import build_detection_model  # noqa: E402
from mega_pytorch_tpu.solver.build import make_optimizer as jax_optimizer  # noqa: E402
from mega_pytorch_tpu.utils.misc import jit_init  # noqa: E402
from mega_pytorch_tpu_torch.config import get_preset  # noqa: E402
from mega_pytorch_tpu_torch.engine.trainer import train_step  # noqa: E402
from mega_pytorch_tpu_torch.models.detectors import build_training_model  # noqa: E402
from mega_pytorch_tpu_torch.solver import make_lr_scheduler, make_optimizer  # noqa: E402
from mega_pytorch_tpu_torch.tools.train_bench import (  # noqa: E402
    calibrate_frozen_bn,
    calibration_frames,
    synthetic_samples,
)
from mega_pytorch_tpu_torch.utils.bridge import bridge_entries, state_dict_from_flax  # noqa: E402

CANVAS = (224, 352)
FRAME = (360, 640)
STEPS = 3


def _opts(cfg) -> list:
    """f32, the cut canvas, take-all sampling."""
    return ["TPU.COMPUTE_DTYPE", "float32",
            "TPU.CANVAS_HEIGHT", CANVAS[0], "TPU.CANVAS_WIDTH", CANVAS[1],
            "INPUT.MIN_SIZE_TRAIN", (CANVAS[0],), "INPUT.MAX_SIZE_TRAIN", CANVAS[1],
            "MODEL.RPN.BATCH_SIZE_PER_IMAGE", 100000,
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE",
            cfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN + cfg.TPU.MAX_GT_BOXES,
            "MODEL.ROI_HEADS.POSITIVE_FRACTION", 1.0]


def _configs():
    jcfg, pcfg = jax_preset("mega_R_101"), get_preset("mega_R_101")
    jcfg.merge_from_list(_opts(jcfg))
    pcfg.merge_from_list(_opts(pcfg))
    return jcfg.freeze(), pcfg.freeze()


def _finite(losses: dict) -> dict:
    return {k: float(v) for k, v in losses.items()}


def initial_params(cfg, sample) -> dict:
    """flax's initial parameters (identity FrozenBN statistics) as numpy."""
    inputs, gt = jax_assemble("mega", sample)
    params = jit_init(build_detection_model(cfg), jax.random.PRNGKey(1), inputs, gt,
                      jax.random.PRNGKey(0), train=True)["params"]
    return jax.tree_util.tree_map(np.array, params)


def calibrated(cfg, params, rs) -> dict:
    """``params`` with every FrozenBN's statistics set by the port's
    ``calibrate_frozen_bn`` on two seeded preprocessed frames, as the card
    runs set them."""
    model = build_training_model(cfg, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    calibrate_frozen_bn(model, calibration_frames(cfg, FRAME, rs, "cpu"))
    state = model.state_dict()
    for name, _, _ in bridge_entries(params):
        if name.endswith(("running_mean", "running_var")):
            *path, leaf = name.split(".")
            node = params
            for key in path:
                node = node[key]
            node[leaf] = state[name].numpy().copy()
    return params


def jax_side(cfg, sample, params, steps: int):
    """(the losses of each step, how far a 1e-6 relative jitter of the
    initial params moves each first loss)."""
    model = build_detection_model(cfg)
    inputs, gt = jax_assemble("mega", sample)
    stack = jax.tree_util.tree_map(lambda x: np.asarray(x)[None], (inputs, gt))
    rng = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    loss_fn = jax.jit(lambda p: model.apply({"params": p}, inputs, gt, rng, train=True))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(7), len(leaves))
    jittered = jax.tree_util.tree_unflatten(treedef, [
        leaf * (1.0 + 1e-6 * jax.random.rademacher(k, leaf.shape, jax.numpy.float32))
        for leaf, k in zip(leaves, keys)])
    base, moved = _finite(loss_fn(params)), _finite(loss_fn(jittered))
    movement = {k: abs(moved[k] - v) for k, v in base.items()}
    del jittered
    optimizer = jax_optimizer(cfg, params)
    opt_state = optimizer.init(params)
    step = make_train_step(model, optimizer)
    out = []
    for i in range(steps):
        t0 = time.perf_counter()
        params, opt_state, losses = step(params, opt_state, *stack, rng)
        out.append(_finite(losses))
        print(f"[jax] step {i + 1}: {out[-1]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out, movement


def port_side(cfg, sample, params, steps: int):
    model = build_training_model(cfg, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    optimizer = make_optimizer(cfg, model)
    scheduler = make_lr_scheduler(cfg, optimizer)
    out = []
    for i in range(steps):
        t0 = time.perf_counter()
        losses = train_step(model, optimizer, scheduler, "mega", [sample], "cpu",
                            torch.Generator().manual_seed(0))
        out.append(_finite(losses))
        print(f"[port] step {i + 1}: {out[-1]} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calibrate", action="store_true",
                    help="FrozenBN statistics from calibrate_frozen_bn, not identity")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    jcfg, pcfg = _configs()
    rs = np.random.RandomState(0)
    sample = synthetic_samples(pcfg, FRAME, rs, count=1)[0]
    params = initial_params(jcfg, sample)
    if args.calibrate:
        params = calibrated(pcfg, params, rs)
    jax_losses, movement = jax_side(jcfg, sample, params, STEPS)
    port_losses = port_side(pcfg, sample, params, STEPS)
    first = {k: abs(port_losses[0][k] - v) for k, v in jax_losses[0].items()}
    tol = {k: max(5e-4 + 1e-3 * abs(v), 5.0 * movement[k]) for k, v in jax_losses[0].items()}
    print(json.dumps({"canvas": CANVAS, "steps": STEPS, "calibrated": args.calibrate,
                      "jax": jax_losses, "port": port_losses,
                      "first_step_abs_diff": first, "jax_jitter_movement": movement,
                      "first_step_tolerance": tol,
                      "first_step_agrees": all(first[k] < tol[k] for k in first)}))


if __name__ == "__main__":
    main()
