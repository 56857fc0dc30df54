"""Reference (mega.pytorch) checkpoints → the port's modules (counterpart of
``mega_pytorch_tpu/utils/model_ingest.py`` with the parts of
``utils/torch_ingest.py`` it needs).

A reference state dict goes through the JAX package's own name table and
layout fixes (copied here, so the port imports nothing of it) into the
flax-shaped numpy tree, and ``utils/bridge.state_dict_from_flax`` turns that
tree into the port's ``state_dict``: the port's mapping is the JAX mapping
followed by the bridge, so the two cannot drift apart.

  backbone.body.*                     → backbone/*
  rpn.head.{conv,cls_logits,bbox_pred}→ rpn/*
  roi_heads.box.feature_extractor.*   → extractor/*
  roi_heads.box.predictor.*           → predictor/*
  flownet.* / embednet.*              → flownet/* / embednet/*
  fcs.N / l_fcs.N                     → fcs_N / l_fcs_N
  {l_,g_,}W{q,k}s.N                   → {l_,g_,}attn_N/W{q,k} (transposed)
  {l_,}Wgs.N                          → ..attn_N/Wg  (1x1 conv → dense)
  {l_,g_,}Wvs.N                       → ..attn_N/Wv_kernel/bias (grouped 1x1 →
                                        per-group (feat, feat/groups) matmuls)
  {l_,g_,}us.N (g, 1, 64)             → ..attn_N/u (g, 64)

The fc layers that consume POOLED features (fc6, fcs.0, l_fcs.0) flatten
(C, 7, 7) channel-major in the reference and (7, 7, C) spatial-major here,
so their kernels are permuted.

Detectron (Caffe2) pickles, the ``catalog://ImageNetPretrained/MSRA/R-*``
backbones, take the same route: ``convert_c2_blobs`` names each blob as the
JAX package does (stem and res2-res4 under ``backbone``, res5 under
``extractor.head``), the bridge turns the tree into port names, and
``merge_state_dict`` loads it, so the stem's packed kernels and the frozen
BN affines are derived anew from the loaded values.
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import torch

from .bridge import state_dict_from_flax

_PREFIX_MAP = [
    ("module.", ""),
    ("backbone.body.", "backbone."),
    ("rpn.head.", "rpn."),
    ("roi_heads.box.feature_extractor.", "extractor."),
    ("roi_heads.box.predictor.", "predictor."),
]

_POOLED_FC = {"extractor.fc6", "extractor.fcs_0", "extractor.l_fcs_0"}
_BN_LEAVES = {"weight", "bias", "running_mean", "running_var"}
_ATTN_RE = re.compile(r"^(l_|g_)?(Wqs|Wks|Wgs|Wvs|us)\.(\d+)$")


def conv_kernel(w: np.ndarray) -> np.ndarray:
    """torch Conv2d (O, I, kH, kW) → flax (kH, kW, I, O)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def deconv_kernel(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose2d (I, O, kH, kW) → flax transpose_kernel (kH, kW, O, I)."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def linear_kernel(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def set_in_tree(tree: dict, path: tuple, value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy() if t.is_floating_point() \
            else t.detach().cpu().numpy()
    return np.asarray(t)


def _pooled_fc_kernel(w: np.ndarray, resolution: int = 7) -> np.ndarray:
    """(out, C*res*res) channel-major → (res*res*C, out) spatial-major."""
    out, total = w.shape
    c = total // (resolution * resolution)
    w = w.reshape(out, c, resolution, resolution)
    w = np.transpose(w, (2, 3, 1, 0))  # (res, res, C, out)
    return np.ascontiguousarray(w.reshape(resolution * resolution * c, out))


def _grouped_wv(w: np.ndarray, groups: int = 16) -> np.ndarray:
    """torch grouped conv (feat, feat, 1, 1) → (groups, feat, feat/groups)."""
    feat = w.shape[0]
    d = feat // groups
    w = w[:, :, 0, 0]  # (out=feat, in_per_group=feat)
    return np.stack([np.ascontiguousarray(w[g * d:(g + 1) * d].T) for g in range(groups)])


def translate_name(name: str) -> list[str]:
    """Reference dotted name → the flax dotted module path (with the leaf)."""
    for pre, rep in _PREFIX_MAP:
        if name.startswith(pre):
            name = rep + name[len(pre):]
    parts = name.split(".")
    out: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        nxt = parts[i + 1] if i + 1 < len(parts) else None
        # ModuleList containers: fcs.0 → fcs_0 ; Wqs.0 → attn_0/Wq etc.
        if nxt is not None and nxt.isdigit():
            m = _ATTN_RE.match(f"{p}.{nxt}")
            if m:
                side, kind, idx = m.group(1) or "", m.group(2), m.group(3)
                leaf = {"Wqs": "Wq", "Wks": "Wk", "Wgs": "Wg", "Wvs": "Wv", "us": "u"}[kind]
                out.extend([f"{side}attn_{idx}", leaf])
                i += 2
                continue
            if p.endswith("fcs"):
                out.append(f"{p}_{nxt}")
                i += 2
                continue
        if p == "downsample" and nxt in ("0", "1"):
            out.append("downsample_conv" if nxt == "0" else "downsample_bn")
            i += 2
            continue
        out.append(p)
        i += 1
    return out


def convert_entry(path: list[str], tensor, groups: int = 16):
    """(module path incl. leaf, tensor) → list of (flax path, array)."""
    leaf = path[-1]
    mod = path[-2] if len(path) >= 2 else ""
    w = to_numpy(tensor)

    if leaf == "num_batches_tracked":
        return []
    if leaf == "u" or mod == "u":  # ParameterList us.N: (groups, 1, embed)
        return [(tuple(path[:-1]) + ("u",), w.reshape(w.shape[0], -1))]
    if mod == "Wv":
        if leaf == "weight":
            return [(tuple(path[:-2]) + ("Wv_kernel",), _grouped_wv(w, groups))]
        return [(tuple(path[:-2]) + ("Wv_bias",), w)]
    if mod in ("Wq", "Wk"):
        if leaf == "weight":
            return [(tuple(path[:-1]) + ("kernel",), linear_kernel(w))]
        return [(tuple(path[:-1]) + ("bias",), w)]
    if mod == "Wg":
        if leaf == "weight":  # (groups, emb, 1, 1) conv → dense (emb, groups)
            return [(tuple(path[:-1]) + ("kernel",), np.ascontiguousarray(w[:, :, 0, 0].T))]
        return [(tuple(path[:-1]) + ("bias",), w)]

    if mod.startswith("bn") or mod.endswith("_bn"):
        if leaf not in _BN_LEAVES:
            raise KeyError(f"unexpected frozen-BN entry {'.'.join(path)}")
        return [(tuple(path), w)]

    dotted = ".".join(path[:-1])
    is_linear = (mod.startswith("fc") or "fcs_" in mod
                 or mod in ("cls_score", "bbox_pred")) and w.ndim == 2
    if leaf == "weight":
        if is_linear:
            if dotted in _POOLED_FC:
                return [(tuple(path[:-1]) + ("kernel",), _pooled_fc_kernel(w))]
            return [(tuple(path[:-1]) + ("kernel",), linear_kernel(w))]
        if mod.startswith("deconv") or mod.startswith("upsample"):
            return [(tuple(path[:-1]) + ("kernel",), deconv_kernel(w))]
        if w.ndim == 4:
            return [(tuple(path[:-1]) + ("kernel",), conv_kernel(w))]
        return [(tuple(path), w)]
    if leaf == "bias":
        return [(tuple(path[:-1]) + ("bias",), w)]
    return [(tuple(path), w)]


def convert_reference_state_dict(state_dict: dict, groups: int = 16) -> dict:
    """Full reference state dict → nested flax-shaped numpy tree."""
    tree: dict = {}
    for name, tensor in state_dict.items():
        for p, arr in convert_entry(translate_name(name), tensor, groups):
            set_in_tree(tree, p, arr)
    return tree


def merge_state_dict(model: torch.nn.Module, loaded: dict, logger=None) -> None:
    """Copy ``loaded`` ({port name: tensor}) into ``model``, shape-checked;
    parameters it lacks keep their values (the reference's partial
    suffix-matching behavior) and its names the model lacks are reported.
    Values are cast to each parameter's dtype; frozen BN and the stem
    re-derive their cached forms through their load hooks."""
    own = model.state_dict()
    for name, t in loaded.items():
        if name in own and tuple(t.shape) != tuple(own[name].shape):
            raise ValueError(f"shape mismatch at {name}: checkpoint {tuple(t.shape)} "
                             f"vs model {tuple(own[name].shape)}")
    if logger:
        for name in own:
            if name not in loaded:
                logger.info(f"[ingest] no checkpoint value for {name}; keeping init")
        for name in loaded:
            if name not in own:
                logger.info(f"[ingest] unused checkpoint key {name}")
    model.load_state_dict({k: v for k, v in loaded.items() if k in own}, strict=False)


def _read_state_dict(path: str, *keys: str) -> dict:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for key in keys:
        if isinstance(payload, dict) and key in payload:
            return payload[key]
    return payload


def load_reference_weights(path: str, model: torch.nn.Module, logger=None,
                           groups: int = 16) -> torch.nn.Module:
    """Load a reference ``.pth`` (a state dict, or a checkpoint holding one
    under "model") into ``model``; returns the model."""
    tree = convert_reference_state_dict(_read_state_dict(path, "model"), groups)
    merge_state_dict(model, state_dict_from_flax(tree), logger)
    return model


def load_flownet_weights(path: str, model: torch.nn.Module, logger=None) -> torch.nn.Module:
    """Load a FlowNet checkpoint into ``model.flownet`` only (the
    reference's ``MODEL.VID.FLOWNET_WEIGHT`` warm start); returns the model."""
    tree: dict = {}
    for name, tensor in _read_state_dict(path, "state_dict", "model").items():
        for pre in ("module.", "flownet."):
            if name.startswith(pre):
                name = name[len(pre):]
        for p, arr in convert_entry(translate_name("flownet." + name), tensor):
            set_in_tree(tree, p, arr)
    loaded = state_dict_from_flax({"flownet": tree.get("flownet", {})})
    merge_state_dict(model, loaded, logger)
    return model


# -- Detectron (Caffe2) pickles: ImageNet-pretrained backbones ---------------------
# The reference maps Detectron blob names to its own in
# utils/c2_model_loading.py and loads them by suffix matching. The MSRA R-50 /
# R-101 pickles hold the backbone's blobs with BN folded into AffineChannel
# (a scale and a bias): that is FrozenBN with running mean 0 and variance 1,
# a fresh model's statistics, so the scale and bias alone load it exactly.

_C2_BLOCK = re.compile(r"^res(\d)_(\d+)_branch(1|2a|2b|2c)(_bn)?_(w|b|s)$")
_C2_STEM = re.compile(r"^(?:res_)?conv1(_bn)?_(w|b|s)$")
_BRANCH_CONV = {"2a": "conv1", "2b": "conv2", "2c": "conv3", "1": "downsample_conv"}
_BRANCH_BN = {"2a": "bn1", "2b": "bn2", "2c": "bn3", "1": "downsample_bn"}
_C2_LEAF = {"w": "kernel", "s": "weight", "b": "bias"}


def c2_blob_to_path(name: str):
    """One Detectron blob name → (flax path under the backbone, is res5), or
    None for a blob that is not loaded (``*_momentum``, ``fc1000*``, the
    rest)."""
    if name.endswith("_momentum") or name.startswith("fc1000"):
        return None
    m = _C2_STEM.match(name)
    if m:
        is_bn, leaf = m.groups()
        return ("stem", "bn1" if is_bn else "conv1", _C2_LEAF[leaf]), False
    m = _C2_BLOCK.match(name)
    if m:
        stage, block, branch, is_bn, leaf = m.groups()
        layer = f"layer{int(stage) - 1}"
        mod = (_BRANCH_BN if is_bn else _BRANCH_CONV)[branch]
        return (layer, str(int(block)), mod, _C2_LEAF[leaf]), layer == "layer4"
    return None


def convert_c2_blobs(blobs: dict) -> dict:
    """Detectron blob dict → flax-shaped tree {"backbone": ..., "extractor":
    {"head": ...}}: res5 (``layer4``) lands under the box head's extractor,
    where the reference's suffix matching puts ImageNet's res5."""
    tree: dict = {}
    for name, arr in blobs.items():
        hit = c2_blob_to_path(name)
        if hit is None:
            continue
        path, is_res5 = hit
        arr = np.asarray(arr)
        if path[-1] == "kernel":
            arr = conv_kernel(arr)
        root = ("extractor", "head") if is_res5 else ("backbone",)
        set_in_tree(tree, root + path, arr)
    return tree


class _BlobUnpickler(pickle.Unpickler):
    """Unpickles numpy arrays in dicts and nothing else: a pickle names the
    functions it calls, so one from elsewhere could run any code."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"), ("_codecs", "encode"),
                *((mod, fn) for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
                  for fn in ("_reconstruct", "scalar"))}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(f"a Detectron pickle holds arrays only, not "
                                         f"{module}.{name}")
        return super().find_class(module, name)


def load_c2_weights(path: str, model: torch.nn.Module, logger=None) -> torch.nn.Module:
    """Load a Detectron ``.pkl`` (``{"blobs": {name: array}}`` or the blob
    dict itself, Python 2 pickles included) into ``model``; returns the
    model."""
    with open(path, "rb") as f:
        payload = _BlobUnpickler(f, encoding="latin1").load()
    blobs = payload.get("blobs", payload) if isinstance(payload, dict) else payload
    merge_state_dict(model, state_dict_from_flax(convert_c2_blobs(blobs)), logger)
    return model
