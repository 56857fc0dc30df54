"""Weight bridge: the JAX package's flax parameter tree → the port's state_dict.

Module names in the port equal the flax scopes, so the bridge is a walk over
the tree that renames leaves and inverts layouts:

- conv ``kernel`` HWIO → ``weight`` OIHW (the stem's canonical (7, 7, 3, 64)
  kernel included); ``nn.Dense`` ``kernel`` (in, out) → ``weight`` (out, in);
  ``bias`` as it is;
- FrozenBN ``weight``/``bias``/``running_mean``/``running_var`` as they are;
- RelationAttention ``u`` (g, E), ``Wg.kernel`` (E, g), ``Wg.bias``,
  ``Wv_kernel`` (g, feat, d) and ``Wv_bias`` as they are.
Pooled ROI features keep the JAX (h, w, c) flatten order, so ``l_fcs_0``
converts like any dense layer.
"""

from __future__ import annotations

import numpy as np
import torch

_KEEP_KERNEL = ("Wg",)  # modules whose "kernel" keeps the flax layout


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax ``params``) → {dotted name: tensor}."""
    out: dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        *mods, leaf = path
        if leaf == "kernel" and (not mods or mods[-1] not in _KEEP_KERNEL):
            leaf = "weight"
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        name = ".".join([*mods, leaf])
        out[name] = torch.tensor(arr, dtype=torch.float32)
    return out
