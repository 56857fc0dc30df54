"""Weight bridge: the JAX package's flax parameter tree → the port's state_dict.

Module names in the port equal the flax scopes, so the bridge is a walk over
the tree that renames leaves and inverts layouts:

- conv ``kernel`` HWIO → ``weight`` OIHW (the stem's canonical (7, 7, 3, 64)
  kernel included); ``nn.Dense`` ``kernel`` (in, out) → ``weight`` (out, in);
  ``bias`` as it is;
- ``nn.ConvTranspose(transpose_kernel=True)`` ``kernel`` (kh, kw, out, in)
  (FlowNetS's upsamplers) → ``conv_transpose2d``'s (in, out, kh, kw)
  ``weight`` by the same 4-D transpose, with no spatial flip: flax's
  transposed kernel is the gradient-of-convolution form PyTorch applies;
- FrozenBN ``weight``/``bias``/``running_mean``/``running_var`` as they are;
- RelationAttention ``u`` (g, E; MEGA only), ``Wg.kernel`` (E, g),
  ``Wg.bias``, ``Wv_kernel`` (g, feat, d) and ``Wv_bias`` as they are.
Pooled ROI features keep the JAX (h, w, c) flatten order, so ``l_fcs_0``
converts like any dense layer.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

_KEEP_KERNEL = ("Wg",)  # modules whose "kernel" keeps the flax layout


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def bridge_entries(params) -> Iterator[tuple[str, object, tuple | None]]:
    """(port name, flax leaf, axes the leaf is transposed by or None) for
    every leaf of a flax ``params`` tree; leaves are only read for their
    rank, so shape structs serve too."""
    for path, val in _flatten(params):
        *mods, leaf = path
        axes = None
        if leaf == "kernel" and (not mods or mods[-1] not in _KEEP_KERNEL):
            leaf = "weight"
            ndim = len(np.shape(val))
            if ndim == 4:
                axes = (3, 2, 0, 1)
            elif ndim == 2:
                axes = (1, 0)
            else:
                raise ValueError(f"unexpected kernel rank at {'/'.join(path)}")
        yield ".".join([*mods, leaf]), val, axes


def state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax ``params``) → {dotted name: tensor}."""
    out: dict[str, torch.Tensor] = {}
    for name, val, axes in bridge_entries(params):
        arr = np.asarray(val)
        if axes is not None:
            arr = arr.transpose(axes)
        out[name] = torch.tensor(arr, dtype=torch.float32)
    return out
