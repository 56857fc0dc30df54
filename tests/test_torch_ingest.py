"""Reference-checkpoint loading: a synthetic mega.pytorch state dict saved as
a ``.pth`` and loaded through the port's ``load_reference_weights`` equals
JAX ``convert_reference_state_dict`` followed by ``state_dict_from_flax``,
tensor by tensor (exact), and covers every parameter and frozen-BN buffer of
the port's model; a shape mismatch raises. The state dicts are test_ingest.py's
synthetic R-50 one, and ones written from the tiny MEGA's and DFF's flax
trees under the reference's names (the inverse of the name table)."""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from mega_pytorch_tpu.utils.model_ingest import (
    convert_reference_state_dict as jax_convert,
)
from mega_pytorch_tpu_torch.config import get_preset
from mega_pytorch_tpu_torch.models.detectors import build_detection_model
from mega_pytorch_tpu_torch.models.detectors.mega import GeneralizedRCNNMEGA
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from mega_pytorch_tpu_torch.utils.model_ingest import (
    load_flownet_weights,
    load_reference_weights,
)
from test_ingest import _res5_sd, _torch_like_resnet_sd
from torch_port_harness import (  # noqa: F401 (remove_tmp_outputs: autouse fixture)
    port_configs,
    port_mega_from,
    port_model_from,
    remove_tmp_outputs,
    tiny_mega,
)

_ROOTS = {"backbone": "backbone.body", "rpn": "rpn.head",
          "extractor": "roi_heads.box.feature_extractor",
          "predictor": "roi_heads.box.predictor"}
_POOLED = {("extractor", "fc6"), ("extractor", "fcs_0"), ("extractor", "l_fcs_0")}


def _reference_state_dict(tree):
    """A flax-shaped tree → the reference's state dict (names and torch
    layouts): the inverse of the port's and the JAX package's name table."""
    sd = {}

    def put(mods, leaf, arr):
        parts = [_ROOTS.get(mods[0], mods[0])]
        for m in mods[1:]:
            if m in ("downsample_conv", "downsample_bn"):
                parts.append("downsample." + ("0" if m == "downsample_conv" else "1"))
            elif "fcs_" in m:
                parts.append(m.replace("fcs_", "fcs."))
            else:
                parts.append(m)
        sd[".".join(parts + ([leaf] if leaf else []))] = torch.from_numpy(
            np.ascontiguousarray(arr, np.float32))

    def walk(node, mods):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(val, mods + [key])
                continue
            attn = next((m for m in mods if "attn_" in m), None)
            if attn:  # relation modules: ModuleLists of the reference
                at = mods.index(attn)
                base, side, idx = mods[:at], *attn.split("attn_")
                if key == "u":
                    put(base + [f"{side}us.{idx}"], None, val[:, None, :])  # (g, 1, E)
                elif key == "Wv_kernel":  # (g, feat, d) → grouped 1x1 conv
                    w = np.concatenate([val[g].T for g in range(val.shape[0])])
                    put(base + [f"{side}Wvs.{idx}"], "weight", w[:, :, None, None])
                elif key == "Wv_bias":
                    put(base + [f"{side}Wvs.{idx}"], "bias", val)
                else:
                    mod = mods[at + 1]
                    name = base + [f"{side}{mod}s.{idx}"]
                    if key == "bias":
                        put(name, "bias", val)
                    elif mod == "Wg":  # dense (E, g) → 1x1 conv (g, E, 1, 1)
                        put(name, "weight", val.T[:, :, None, None])
                    else:
                        put(name, "weight", val.T)
                continue
            if key != "kernel":
                put(mods, key, val)
            elif val.ndim == 4:  # conv HWIO / transposed conv (kh, kw, out, in)
                put(mods, "weight", val.transpose(3, 2, 0, 1))
            elif tuple(mods[-2:]) in _POOLED:  # spatial-major → channel-major
                res = 7
                c = val.shape[0] // (res * res)
                w = val.reshape(res, res, c, -1).transpose(3, 2, 0, 1)
                put(mods, "weight", w.reshape(w.shape[0], -1))
            else:
                put(mods, "weight", val.T)

    walk(tree, [])
    return sd


def _load(model, sd, tmp_path, name="ref.pth", nested=True):
    path = tmp_path / name
    torch.save({"model": sd, "iteration": 7} if nested else sd, path)
    records = []
    logger = logging.getLogger(f"ingest-{name}")
    logger.addHandler(type("H", (logging.Handler,), {
        "emit": lambda self, r: records.append(r.getMessage())})())
    logger.setLevel(logging.INFO)
    load_reference_weights(str(path), model, logger)
    return records


def _assert_loaded(model, sd, records):
    want = state_dict_from_flax(jax_convert(sd))
    got = model.state_dict()
    assert [r for r in records if "no checkpoint value" in r] == []
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert torch.equal(got[name].float(), w), name


def test_reference_r50_state_dict_loads_every_parameter(tmp_path):
    """test_ingest.py's synthetic R-50 C4 checkpoint (reduce channel) into
    the port's base R-50 detector, f32."""
    torch.manual_seed(0)
    sd = _torch_like_resnet_sd()
    sd.update(_res5_sd("roi_heads.box.feature_extractor.head"))
    t = lambda *s: torch.randn(*s) * 0.02  # noqa: E731
    for name, shape in [("rpn.head.conv", (1024, 1024, 3, 3)), ("rpn.head.cls_logits", (12, 1024, 1, 1)),
                        ("rpn.head.bbox_pred", (48, 1024, 1, 1)),
                        ("roi_heads.box.feature_extractor.conv", (256, 2048, 1, 1)),
                        ("roi_heads.box.feature_extractor.fc6", (1024, 256 * 49)),
                        ("roi_heads.box.feature_extractor.fc7", (1024, 1024)),
                        ("roi_heads.box.predictor.cls_score", (31, 1024)),
                        ("roi_heads.box.predictor.bbox_pred", (124, 1024))]:
        sd[name + ".weight"] = t(*shape)
        sd[name + ".bias"] = t(shape[0])
    cfg = get_preset("base_R_50")
    cfg.merge_from_list(["TPU.COMPUTE_DTYPE", "float32"])
    model = build_detection_model(cfg, "cpu")
    _assert_loaded(model, sd, _load(model, sd, tmp_path))

    bad = dict(sd, **{"roi_heads.box.predictor.cls_score.weight": t(30, 1024)})
    with pytest.raises(ValueError, match="shape mismatch"):
        _load(build_detection_model(cfg, "cpu"), bad, tmp_path, "bad.pth")


def test_reference_mega_state_dict_roundtrip(tmp_path):
    """The tiny MEGA's flax tree written under the reference's names (the
    relation modules' grouped Wv, u and Wg included) loads into the port's
    MEGA as JAX's conversion reads it, which is the tree itself: the model
    then equals the one the weight bridge builds, in f32, and in bf16 cast."""
    _, params = tiny_mega()
    sd = _reference_state_dict(params)
    pc, pv = port_configs()
    want = port_mega_from(params).state_dict()
    model = GeneralizedRCNNMEGA(pc, pv)
    _assert_loaded(model, sd, _load(model, sd, tmp_path))
    for name, t in model.state_dict().items():
        assert torch.equal(t, want[name]), name
    low = GeneralizedRCNNMEGA(dataclasses.replace(pc, compute_dtype="bfloat16"), pv)
    low.cast_weights_()
    _load(low, sd, tmp_path, "low.pth", nested=False)
    for name, t in low.state_dict().items():
        assert torch.equal(t, want[name].to(t.dtype)), name


def test_flownet_checkpoint_loads_flownet_only(tiny_root, tmp_path):
    """A FlowNet checkpoint (``module.``-prefixed names) written from the
    tiny DFF's flownet tree fills the port's flownet and nothing else."""
    from mega_pytorch_tpu_torch.models import detectors
    from test_torch_lockstep import ENGINE_C, _method_setup

    jax_model, _, params = _method_setup("dff", tiny_root)
    sd = {"module." + k: v for k, v in _reference_state_dict(
        {"flownet": params["flownet"]}).items()}
    path = tmp_path / "flownet.ckpt"
    torch.save({"state_dict": {k.replace("module.flownet.", "module."): v
                               for k, v in sd.items()}}, path)
    want = port_model_from(detectors.GeneralizedRCNNDFF, params,
                           *port_configs(ENGINE_C, jax_model.v))
    model = detectors.GeneralizedRCNNDFF(*port_configs(ENGINE_C, jax_model.v))
    model.init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    load_flownet_weights(str(path), model)
    flow = [k for k in before if k.startswith("flownet.")]
    assert flow
    for name, t in model.state_dict().items():
        if name.startswith("flownet."):
            assert torch.equal(t, want.state_dict()[name]), name
        else:
            assert torch.equal(t, before[name]), name
