"""The parameters of a configuration: name, shape and the flax initialiser
each is drawn with, under the port's names (the flax scopes')."""

from __future__ import annotations

from .vid import STAGES

# an initialiser: ("lecun", fan_in) truncated normal of variance 1/fan_in,
# ("normal", std), ("const", value)
LECUN, NORMAL, CONST = "lecun", "normal", "const"


def _conv(spec, name, o, i, k, bias=True, std=None):
    spec.append((name + ".weight", (o, i, k, k),
                 (LECUN, i * k * k) if std is None else (NORMAL, std)))
    if bias:
        spec.append((name + ".bias", (o,), (CONST, 0.0)))


def _dense(spec, name, o, i, std=None):
    spec.append((name + ".weight", (o, i), (LECUN, i) if std is None else (NORMAL, std)))
    spec.append((name + ".bias", (o,), (CONST, 0.0)))


def _bn(spec, name, ch, scale=1.0):
    for field, value in (("weight", scale), ("bias", 0.0), ("running_mean", 0.0),
                         ("running_var", 1.0)):
        spec.append((f"{name}.{field}", (ch,), (CONST, value)))


def _stage(spec, pre, blocks, cin, mid, cout, residual_scale=1.0):
    for b in range(blocks):
        p = f"{pre}.{b}."
        if b == 0 and cin != cout:
            _conv(spec, p + "downsample_conv", cout, cin, 1, bias=False)
            _bn(spec, p + "downsample_bn", cout)
        _conv(spec, p + "conv1", mid, cin if b == 0 else cout, 1, bias=False)
        _bn(spec, p + "bn1", mid)
        _conv(spec, p + "conv2", mid, mid, 3, bias=False)
        _bn(spec, p + "bn2", mid)
        _conv(spec, p + "conv3", cout, mid, 1, bias=False)
        _bn(spec, p + "bn3", cout, residual_scale)


def _attention(spec, name, dim, embed, groups, position):
    d = dim // groups
    spec.append((name + ".u", (groups, embed), (NORMAL, 0.01)))
    spec.append((name + ".Wv_kernel", (groups, dim, d), (NORMAL, 0.01)))
    spec.append((name + ".Wv_bias", (dim,), (CONST, 0.0)))
    _dense(spec, name + ".Wq", dim, dim)
    _dense(spec, name + ".Wk", dim, dim)
    if position:
        spec.append((name + ".Wg.kernel", (embed, groups), (NORMAL, 0.01)))
        spec.append((name + ".Wg.bias", (groups,), (CONST, 0.0)))


_FLOW_CONVS = (("flow_conv1", 6, 64, 7), ("conv2", 64, 128, 5), ("conv3", 128, 256, 5),
               ("conv3_1", 256, 256, 3), ("conv4", 256, 512, 3), ("conv4_1", 512, 512, 3),
               ("conv5", 512, 512, 3), ("conv5_1", 512, 512, 3), ("conv6", 512, 1024, 3),
               ("conv6_1", 1024, 1024, 3))
_FLOW_DECODER = (("Convolution1", 1024, "upsample_flow6to5", "deconv5", 512),
                 ("Convolution2", 1026, "upsample_flow5to4", "deconv4", 256),
                 ("Convolution3", 770, "upsample_flow4to3", "deconv3", 128),
                 ("Convolution4", 386, "upsample_flow3to2", "deconv2", 64))


def param_spec(c: dict) -> list:
    """[(name, shape, initialiser)] of configuration ``c`` (method "mega" or
    "fgfa", R-50 or R-101 C4, no channel reduce). Each residual branch's
    last FrozenBN scale is ``c["residual_bn_scale"]`` (1 if absent)."""
    if c.get("reduce_channel"):
        raise ValueError("the reference pools the 2048-channel res5 map (no reduce)")
    spec: list = []
    blocks = STAGES[c["depth"]]
    gamma = c.get("residual_bn_scale", 1.0)
    _conv(spec, "backbone.stem.conv1", 64, 3, 7, bias=False)
    _bn(spec, "backbone.stem.bn1", 64)
    cin = 64
    for i in range(3):
        cout = 256 * 2 ** i
        _stage(spec, f"backbone.layer{i + 1}", blocks[i], cin, 64 * 2 ** i, cout, gamma)
        cin = cout
    a = len(c["anchor_sizes"]) * len(c["aspect_ratios"])
    _conv(spec, "rpn.conv", 1024, 1024, 3, std=0.01)
    _conv(spec, "rpn.cls_logits", a, 1024, 1, std=0.01)
    _conv(spec, "rpn.bbox_pred", 4 * a, 1024, 1, std=0.01)
    _stage(spec, "extractor.head.layer4", blocks[3], 1024, 512, 2048, gamma)
    flat = 2048 * c["pooler_resolution"] ** 2
    dim = c["mlp_dim"]
    if c["method"] == "mega":
        att = c["attention"]
        for i in range(att["stages"]):
            _dense(spec, f"extractor.l_fcs_{i}", dim, flat if i == 0 else dim)
            _attention(spec, f"extractor.l_attn_{i}", dim, att["embed_dim"], att["groups"],
                       True)
        for i in range(c["global_res_stage"] + 1):
            _attention(spec, f"extractor.g_attn_{i}", dim, att["embed_dim"], att["groups"],
                       False)
    else:
        _dense(spec, "extractor.fc6", dim, flat)
        _dense(spec, "extractor.fc7", dim, dim)
    _dense(spec, "predictor.cls_score", c["num_classes"], dim, std=0.01)
    _dense(spec, "predictor.bbox_pred", 4 * c["num_classes"], dim, std=0.001)
    if c["method"] == "fgfa":
        for name, i, o, k in _FLOW_CONVS:
            _conv(spec, f"flownet.{name}", o, i, k)
        for fconv, cin, up, deconv, dout in _FLOW_DECODER:
            _conv(spec, f"flownet.{fconv}", 2, cin, 3)
            # transposed convolutions: (in, out, k, k), flax's fan-in out * k * k
            spec.append((f"flownet.{up}.weight", (2, 2, 4, 4), (LECUN, 32)))
            spec.append((f"flownet.{up}.bias", (2,), (CONST, 0.0)))
            spec.append((f"flownet.{deconv}.weight", (cin, dout, 4, 4), (LECUN, dout * 16)))
            spec.append((f"flownet.{deconv}.bias", (dout,), (CONST, 0.0)))
        _conv(spec, "flownet.Convolution5", 2, 194, 3)
        _conv(spec, "embednet.embed_conv1", 512, 1024, 1)
        _conv(spec, "embednet.embed_conv2", 512, 512, 3)
        _conv(spec, "embednet.embed_conv3", 2048, 512, 1)
    return spec
