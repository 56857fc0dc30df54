"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py).

The JAX package is the reference: a tiny MEGA (R-14, the TINY_C / TINY_V
configuration of test_mega.py), or a tiny model of another method, is
initialised by flax, its parameter tree is bridged into the port with
``state_dict_from_flax`` and loaded strictly, and both stacks are fed the
same numpy inputs. Compute is float32 on both sides. Also here: the
comparison of lockstep carries and detections that the per-method tests
share.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from mega_pytorch_tpu.models.detectors.mega import GeneralizedRCNNMEGA
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu_torch.models.detectors import mega as port_mega
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_mega import TINY_C, TINY_V

CANVAS = (64, 96)  # tiny canvas; s2d(4)-packed frames are (16, 24, 48)


def port_configs(c=TINY_C, v=TINY_V):
    """The JAX configs' values for the fields the port's configs have."""
    pc = port_mega.RCNNConfig(**{
        f.name: getattr(c, f.name) for f in dataclasses.fields(port_mega.RCNNConfig)
    })
    pv = port_mega.VidConfig(**{
        f.name: getattr(v, f.name) for f in dataclasses.fields(port_mega.VidConfig)
    })
    return pc, pv


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb(params, rs):
    """Random frozen-BN statistics (init leaves them at identity); wider
    objectness and class-score weights, so scores spread far beyond float
    noise; a narrower fc0, so ROI features are O(1-10) rather than O(50)
    (the uint8 frames enter at +-128 and the network is near homogeneous)."""
    def walk(tree, path=()):
        out = {}
        for key, val in tree.items():
            p = path + (key,)
            if isinstance(val, dict):
                out[key] = walk(val, p)
                continue
            val = np.array(val)
            if key in ("running_mean", "bias") and "bn" in p[-2]:
                val = (rs.randn(*val.shape) * 0.1).astype(np.float32)
            elif key == "weight" and "bn" in p[-2]:
                val = (1.0 + rs.randn(*val.shape) * 0.1).astype(np.float32)
            elif key == "running_var":
                val = (1.0 + rs.rand(*val.shape) * 0.5).astype(np.float32)
            elif key == "kernel" and p[-2] in ("cls_logits", "cls_score"):
                val = val * 30.0
            elif key == "kernel" and p[-2] in ("l_fcs_0", "fcs_0", "fc6"):
                val = val * 0.1
            out[key] = val
        return out

    return walk(params)


@functools.lru_cache(maxsize=None)
def tiny_mega():
    """(jax model, numpy params) for the tiny MEGA, all streaming params."""
    model = GeneralizedRCNNMEGA(c=TINY_C, v=TINY_V)
    rs = np.random.RandomState(0)
    ph, pw = CANVAS[0] // 4, CANVAS[1] // 4
    one = ImageBatch(
        tensors=jnp.asarray(rs.randn(1, ph, pw, 48) * 50, jnp.float32),
        sizes=jnp.array([[float(CANVAS[0]), float(CANVAS[1])]], jnp.float32),
    )
    pair = ImageBatch(tensors=jnp.concatenate([one.tensors, one.tensors * 0.5]),
                      sizes=jnp.tile(one.sizes, (2, 1)))

    def boot(key, one):
        tmp = model.init(key, one, method=GeneralizedRCNNMEGA.precompute)["params"]
        entry = model.apply({"params": tmp}, one, method=GeneralizedRCNNMEGA.precompute)
        return model.apply({"params": tmp}, entry, one.sizes[0],
                           method=GeneralizedRCNNMEGA.init_carry)

    carry = jax.jit(boot)(jax.random.PRNGKey(0), one)
    params = jax.jit(
        lambda key, carry, pair: model.init(
            key, carry, pair, method=GeneralizedRCNNMEGA.test_step)
    )(jax.random.PRNGKey(0), carry, pair)["params"]
    params = _perturb(to_np(params), np.random.RandomState(1))
    return model, params


def port_model_from(cls, params, *args):
    """The port's ``cls(*args)`` with the bridged weights loaded strictly,
    f32, on the CPU, in eval mode."""
    model = cls(*args)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.eval().requires_grad_(False)


def off_relu_corner(tree):
    """The position weights' Wg bias at 0.5: pw = relu(Wg . sinusoids + b)
    then stays far above its relu corner, where one bf16 step of a sinusoid
    (torch's and XLA's log/sin differ by an ulp, which can flip one) would
    move log pw by far more than float noise (test_torch_modules.py)."""
    out = {}
    for key, val in tree.items():
        if key == "Wg":
            val = dict(val, bias=np.full_like(val["bias"], 0.5))
        elif isinstance(val, dict):
            val = off_relu_corner(val)
        out[key] = val
    return out


def leaves(carry):
    """A carry's tensors in field order, per-stage tuples flattened."""
    out = []
    for x in carry:
        out.extend(x if isinstance(x, tuple) else (x,))
    return out


def assert_field_close(want, got, atol, msg):
    """One carry field (or a tuple of per-stage fields): booleans exact,
    floats within ``atol``."""
    pairs = zip(want, got) if isinstance(want, tuple) else [(want, got)]
    for w, g in pairs:
        w, g = np.asarray(w), np.asarray(g)
        assert w.shape == g.shape, msg
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=msg)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=msg)


def match_detections(want, got, lanes):
    """Per lane, the port's detections ``got`` (L, D) against the JAX
    package's ``want`` ((L, D) or vmapped (L, 1, D)), matched by label,
    score and box as in the live reference parity suite; asserts finite
    boxes and scores and no unexplained (drift) mismatch. Returns (matched,
    reference detections), summed over the lanes."""
    from test_parity_reference import _match_detail, classify_unmatched

    def lane(dets, i):  # boxes (D, 4), scores (D,), labels (D,), valid (D,)
        return [np.asarray(x)[i].reshape(-1, 4) if j == 0 else np.asarray(x)[i].reshape(-1)
                for j, x in enumerate(dets)]

    total = matched_all = 0
    for i in range(lanes):
        w, g = lane(want, i), lane(got, i)
        assert np.isfinite(g[0]).all() and np.isfinite(g[1]).all()
        vw, vg = w[3], g[3]
        ref = w[0][vw], w[1][vw], w[2][vw]
        ours = g[0][vg], g[1][vg], g[2][vg]
        matched, _, unmatched, used = _match_detail(ref, ours)
        counts = classify_unmatched(ref, ours, unmatched, used)
        assert counts["DRIFT"] == [], (i, counts)
        total += len(ref[0])
        matched_all += matched
    return matched_all, total


def port_mega_from(params, c=TINY_C, v=TINY_V):
    """The port's MEGA with the bridged weights, f32, on the CPU."""
    return port_model_from(port_mega.GeneralizedRCNNMEGA, params, *port_configs(c, v))


def dataset_args(root):
    """Constructor paths of the synthetic ``tiny_root`` video set (the
    arguments of test_engine.py's ``_dataset``), for either package."""
    return dict(image_set="VID_val", data_dir=str(root),
                img_dir=str(root / "Data" / "VID"),
                anno_path=str(root / "Annotations" / "VID"),
                img_index=str(root / "ImageSets" / "val.txt"))


def port_dataset(root, cls_name, **kw):
    """The port's test-side dataset ``cls_name`` over ``tiny_root``."""
    from mega_pytorch_tpu_torch.data.datasets import vid

    return getattr(vid, cls_name)(**dataset_args(root), **kw)


def ilsvrc_data_dir(root, tmp_path):
    """A ``--data-dir`` whose ``ILSVRC2015`` tree is ``tiny_root`` (frames and
    annotations linked, its index as ``VID_val_videos.txt`` and
    ``VID_val_frames.txt``)."""
    ilsvrc = tmp_path / "datasets" / "ILSVRC2015"
    (ilsvrc / "ImageSets").mkdir(parents=True)
    for sub in ("Data", "Annotations"):
        (ilsvrc / sub).symlink_to(root / sub, target_is_directory=True)
    for name in ("VID_val_videos.txt", "VID_val_frames.txt"):
        (ilsvrc / "ImageSets" / name).write_text((root / "ImageSets" / "val.txt").read_text())
    return tmp_path / "datasets"
