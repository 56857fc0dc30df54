"""Data parallelism over processes (``parallel/ddp.py``, DDP in the place of
the JAX package's ``data`` mesh) on the CPU: two gloo ranks, spawned with a
``file://`` store (``tests/torch_ddp_worker.py``, no JAX in the workers).

* one DDP step over two ranks, a sample each, against the port's serial
  two-sample step and the JAX ``make_train_step(num_samples=2,
  mesh=make_mesh(2))`` on the conftest's CPU devices, for the tiny base
  detector and the tiny RDN (the weights after one SGD step);
* ``no_sync`` accumulation: two samples a rank against the serial
  four-sample step;
* ``train_net`` under a world of two: only rank 0 saves checkpoints, whose
  state (no ``module.`` prefix) equals both ranks' parameters;
* ``tools/ddp_check.py``, the card's check of DDP against the plain step;
* ``comm``'s world, rank, barrier, ``all_gather`` and ``reduce_dict``;
* a world that does not divide ``IMS_PER_BATCH`` is refused.

Tolerances. DDP against the serial step: the same per-sample gradients,
averaged over the ranks by the all-reduce instead of summed over the
samples, a few f32 roundings apart, so each leaf's update within DDP_RTOL
of its largest (after 4 f32 steps of the parameter itself, since an update
is read as the difference of two rounded parameters). Against JAX: each leaf's update within max(2e-3, 5x how far
a 1e-6 relative jitter of the parameters moves JAX's update) of its
largest, the median leaf within 2e-2 (``test_torch_train_models.py``'s
protocol; take-all sampling, so no random draw changes the losses).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.engine.trainer import make_train_step as jax_make_train_step
from mega_pytorch_tpu.models.detectors.rcnn import GeneralizedRCNN as JaxRCNN
from mega_pytorch_tpu.models.detectors.rcnn import pad_gt
from mega_pytorch_tpu.models.detectors.rdn import GeneralizedRCNNRDN as JaxRDN
from mega_pytorch_tpu.parallel import make_mesh
from mega_pytorch_tpu.solver import make_optimizer as jax_make_optimizer
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu.utils.misc import jit_init
from mega_pytorch_tpu_torch.parallel import ddp
from mega_pytorch_tpu_torch.utils import comm
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_rdn import TINY_C as RDN_C
from test_rdn import TINY_V as RDN_V
from test_torch_train_loop import TRAIN_OPTS, _train_tree
from test_torch_train_methods import _take_all
from test_torch_train_models import GT_BOXES, GT_LABELS, _flat_grads, _frames, _sizes
from torch_ddp_worker import one_step, solver_cfg, spawn_world
from torch_port_harness import (  # noqa: F401 (remove_tmp_outputs: autouse fixture)
    off_relu_corner,
    port_configs,
    remove_tmp_outputs,
    to_np,
)

torch.set_num_threads(2)

SOLVER_OPTS = ["SOLVER.BASE_LR", "0.02", "SOLVER.WEIGHT_DECAY", "0.0001"]
DDP_RTOL = 1e-5


def _samples(method, n):
    """n preprocessed samples (as ``train_batches`` yields them) of seeded
    frames: cur, and RDN's two refs; the same ground truth, the second
    sample's boxes shifted."""
    rs = np.random.RandomState(11)
    refs = 0 if method == "base" else RDN_V.ref_num
    out = []
    for i in range(n):
        frames = _frames(rs, 1 + refs)
        gt = pad_gt(GT_BOXES + 3.0 * i, GT_LABELS, RDN_C.max_gt_boxes)
        sample = {"cur": frames[:1], "cur_size": _sizes(1),
                  "gt": {k: np.asarray(v)[None] for k, v in gt.items()}}
        if refs:
            sample.update(ref=frames[1:], ref_size=_sizes(refs))
        out.append(sample)
    return out


def _jax_inputs(method, samples):
    """The samples stacked on a leading sample axis, as the JAX do_train
    stacks them."""
    if method == "base":
        frames = np.stack([s["cur"] for s in samples])
        sizes = np.stack([s["cur_size"] for s in samples])
    else:
        frames = np.stack([np.concatenate([s["cur"], s["ref"]]) for s in samples])
        sizes = np.stack([np.concatenate([s["cur_size"], s["ref_size"]]) for s in samples])
    gt = {k: np.stack([s["gt"][k] for s in samples]) for k in samples[0]["gt"]}
    return ImageBatch(jnp.asarray(frames), jnp.asarray(sizes)), jax.tree_util.tree_map(
        jnp.asarray, gt)


def _payload(method, n):
    """Tiny weights from flax (Wg's bias off the relu floor for RDN), the
    port's configs, the samples and the solver's options."""
    c = _take_all(RDN_C)
    model = JaxRCNN(c=c) if method == "base" else JaxRDN(c=c, v=RDN_V)
    samples = _samples(method, n)
    inputs, gt = _jax_inputs(method, samples[:1])
    one = jax.tree_util.tree_map(lambda x: x[0], (inputs, gt))
    params = to_np(jit_init(model, jax.random.PRNGKey(1), one[0], one[1],
                            jax.random.PRNGKey(0), train=True)["params"])
    if method == "rdn":
        params = off_relu_corner(params)
    return model, params, dict(method=method, configs=port_configs(c, RDN_V),
                               state=state_dict_from_flax(params), samples=samples,
                               opts=SOLVER_OPTS)


def _jax_updates(model, params, method, samples):
    """JAX's updates of one mesh step over ``samples`` (2 devices), and how
    far a 1e-6 jitter of the parameters moves them."""
    cfg = solver_cfg(SOLVER_OPTS)
    tx = jax_make_optimizer(cfg, params)
    step = jax_make_train_step(model, tx, num_samples=len(samples), mesh=make_mesh(2))
    inputs, gt = _jax_inputs(method, samples)

    def updates(p):
        p = jax.tree_util.tree_map(jnp.asarray, p)
        new, _, _ = step(jax.tree_util.tree_map(jnp.copy, p), tx.init(p), inputs, gt,
                         jax.random.PRNGKey(0))
        return jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b), new, p)

    leaves, treedef = jax.tree_util.tree_flatten(params)
    rs = np.random.RandomState(7)
    jittered = jax.tree_util.tree_unflatten(treedef, [
        (x * (1.0 + 1e-6 * rs.choice([-1.0, 1.0], x.shape))).astype(np.float32)
        for x in leaves])
    u, uj = updates(params), updates(jittered)
    return _flat_grads(u), _flat_grads(jax.tree_util.tree_map(lambda a, b: a - b, u, uj))


def _updates(state, initial):
    return {k: (state[k] - initial[k]).numpy() for k in initial
            if initial[k].is_floating_point()}


def _update_err(got, want, initial, floor=1e-12):
    """How far an update is from another, relative to the larger's largest
    value (at least ``floor``), after 4 f32 steps of the parameter's own
    (an update is read as the difference of two rounded parameters)."""
    ulps = 4.0 * np.spacing(np.float32(np.abs(initial.numpy()).max()))
    return max(np.abs(got - want).max() - ulps, 0.0) / max(np.abs(want).max(), floor)


def _assert_close_updates(got, want, initial, rtol):
    """Each leaf within ``rtol`` of its largest update, or of a thousandth of
    the largest update of any leaf where its own is smaller: a key bias's
    gradient is zero in exact arithmetic (it shifts a query's logits alike),
    rounding noise of ~1e-11 here."""
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        assert _update_err(got[name], w, initial[name], floor) <= rtol, name


@pytest.mark.parametrize("method", ["base", "rdn"])
def test_ddp_step_equals_serial_and_jax(method, tmp_path):
    """Two ranks, a sample each: both ranks end with the same weights, equal
    within DDP_RTOL to the serial two-sample step's and within the jitter
    bound to the JAX mesh step's."""
    model, params, payload = _payload(method, 2)
    ranks = spawn_world("step", payload, tmp_path)
    initial = payload["state"]
    for name, value in ranks[0]["state"].items():
        assert torch.equal(value, ranks[1]["state"][name]), name
    assert [r["share"] for r in ranks] == [1, 1]
    serial, serial_losses = one_step(payload, payload["samples"])
    got, want = _updates(ranks[0]["state"], initial), _updates(serial, initial)
    _assert_close_updates(got, want, initial, DDP_RTOL)
    for k, v in serial_losses.items():  # the mean over both ranks' samples
        assert abs(ranks[0]["losses"][k] - v) <= 1e-6 * max(abs(v), 1.0), k

    jax_u, movement = _jax_updates(model, params, method, payload["samples"])
    errs = []
    for name, w in jax_u.items():
        if name not in got:
            continue
        scale = np.abs(w).max()
        if scale == 0.0:  # frozen: no update on either side
            assert np.abs(got[name]).max() == 0.0, name
            continue
        err = _update_err(got[name], w, initial[name])
        tol = max(2e-3, 5.0 * np.abs(movement[name]).max() / scale)
        assert err < tol, (name, err, tol)
        errs.append(err)
    assert len(errs) >= 20 and float(np.median(errs)) < 2e-2


def test_ddp_no_sync_accumulates(tmp_path):
    """Two ranks, two samples each (the first backward under ``no_sync``):
    the weights of the serial four-sample step on both ranks."""
    _, _, payload = _payload("base", 4)
    ranks = spawn_world("step", payload, tmp_path)
    assert [r["share"] for r in ranks] == [2, 2]
    serial, _ = one_step(payload, payload["samples"])
    initial = payload["state"]
    for r in ranks:
        _assert_close_updates(_updates(r["state"], initial), _updates(serial, initial),
                              initial, DDP_RTOL)


def test_train_net_ddp_checkpoints_on_rank_zero(tiny_root, tmp_path):
    """``train_net`` for tiny RDN over two ranks (IMS_PER_BATCH 2, one sample
    a rank, 2 iterations, a checkpoint each): both ranks wrapped in DDP and
    ending with the same weights and losses; only rank 0 saved, and the
    saved state, with no ``module.`` prefix, equals theirs."""
    data_dir = _train_tree(tiny_root, tmp_path)
    out = tmp_path / "out"
    argv = ["--preset", "rdn_base_R_50", "--data-dir", str(data_dir), "--output-dir",
            str(out), "--device", "cpu", "opts", *TRAIN_OPTS, "SOLVER.IMS_PER_BATCH", "2"]
    ranks = spawn_world("train_net", dict(argv=argv), tmp_path / "world")
    assert all(r["ddp"] for r in ranks)
    assert ranks[0]["saves"] == ["model_0000001", "model_0000002", "model_final"]
    assert ranks[1]["saves"] == []
    assert ranks[0]["record"]["losses"] == ranks[1]["record"]["losses"]
    assert all(np.isfinite(v) for it in ranks[0]["record"]["losses"] for v in it.values())
    saved = torch.load(out / "model_final.pth", weights_only=True)["model"]
    assert saved.keys() == ranks[0]["state"].keys()
    assert not any(k.startswith("module.") for k in saved)
    for name, value in saved.items():
        assert torch.equal(value, ranks[0]["state"][name]), name
        assert torch.equal(value, ranks[1]["state"][name]), name


def test_ddp_check_over_two_ranks(tmp_path):
    """``tools/ddp_check.py`` (the card's DDP check) on two gloo ranks: tiny
    RDN with the advanced stage, 4 samples an iteration (2 a rank, the
    first under ``no_sync``), the preset's random sampling, 2 iterations;
    both ranks end equal, rank 0's updates in both DDP runs stay within the
    bound the tool states (here the spread is that of the gradients'
    summation order, as the CPU is deterministic), and the planted fault
    (rank 1's last sample left out) reads above it."""
    opts = TRAIN_OPTS + ["SOLVER.IMS_PER_BATCH", "4", "MODEL.VID.ROI_BOX_HEAD.REDUCE_CHANNEL",
                         "True", "TPU.CANVAS_HEIGHT", "48", "TPU.CANVAS_WIDTH", "64"]
    ranks = spawn_world("ddp_check", dict(preset="rdn_R_101", opts=opts, iters=2,
                                          frame=(96, 128)), tmp_path)
    rec = ranks[0]
    assert rec["world"] == 2 and rec["backend"] == "gloo" and rec["ok"], rec
    assert rec["err"] <= rec["bound"] < rec["fault"] and rec["ranks_apart"] == 0.0
    assert len(rec["ddp_ms"]) == 2
    assert ranks[1] == {"rank": 1, "apart": 0.0}
    assert all(np.isfinite(v) for v in rec["ddp_losses"].values())


def test_comm_over_two_ranks(tmp_path):
    """``comm`` over two ranks, and its one-process case here."""
    ranks = spawn_world("comm", {}, tmp_path)
    for r, res in enumerate(ranks):
        assert (res["world"], res["rank"], res["main"]) == (2, r, r == 0)
        assert res["gathered"] == [{"rank": 0, "items": [0, 1]},
                                   {"rank": 1, "items": [0, 1, 2]}]
        assert res["mean"] == {"a": 1.5, "b": 1.0}
        assert res["total"] == {"a": 3.0}
    assert (comm.get_world_size(), comm.get_rank(), comm.is_main_process()) == (1, 0, True)
    comm.synchronize()
    assert comm.all_gather({"x": 1}) == [{"x": 1}]
    assert comm.reduce_dict({"a": torch.tensor(2.5)}) == {"a": 2.5}


def test_world_must_divide_ims_per_batch():
    """Each rank takes a contiguous share of an iteration's batch; a world
    that does not divide it is refused."""
    batch = [10, 11, 12, 13]
    assert [ddp.rank_share(batch, r, 2) for r in range(2)] == [[10, 11], [12, 13]]
    assert ddp.rank_share(batch, 0, 1) == batch
    with pytest.raises(ValueError, match="IMS_PER_BATCH 3"):
        ddp.samples_per_rank(3, 2)
    with pytest.raises(ValueError, match="not a multiple"):
        ddp.rank_share([1, 2, 3], 1, 2)
    assert ddp.rank_seed(5, 0) == 5 and ddp.rank_seed(5, 1) != 5
    assert ddp.rank_rng(5, 0).rand() == np.random.RandomState(5).rand()
    assert ddp.rank_rng(5, 1).rand() != np.random.RandomState(5).rand()
