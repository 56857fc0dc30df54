"""Shared set-up for the PyTorch port's parity tests (tests/test_torch_*.py).

The JAX package is the reference: a tiny MEGA (R-14, the TINY_C / TINY_V
configuration of test_mega.py) is initialised by flax, its parameter tree is
bridged into the port with ``state_dict_from_flax`` and loaded strictly, and
both stacks are fed the same numpy inputs. Compute is float32 on both sides.
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
            elif key == "kernel" and p[-2] == "l_fcs_0":
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


def port_mega_from(params, c=TINY_C, v=TINY_V):
    """The port's MEGA with the bridged weights, f32, on the CPU."""
    pc, pv = port_configs(c, v)
    model = port_mega.GeneralizedRCNNMEGA(pc, pv)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.eval().requires_grad_(False)
