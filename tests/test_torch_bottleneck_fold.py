"""Frozen BN folded into the bottleneck convolutions (eval mode, bf16)
against the unfolded block (train mode, f32 blocks, group norm), and the
plain bottleneck epilogue against its formula; on the CPU, where the
epilogue is the plain version. No JAX: the port's own two paths are
compared."""

import numpy as np
import pytest
import torch
from torch import nn

from mega_pytorch_tpu_torch.models.backbone.resnet import (
    Bottleneck,
    ResNetC4,
    ResNetRes5Head,
)
from mega_pytorch_tpu_torch.models.layers import FrozenBatchNorm2d, init_module_
from mega_pytorch_tpu_torch.ops.kernels import bottleneck_epilogue as be
from mega_pytorch_tpu_torch.tools.train_bench import calibrate_frozen_bn

torch.set_num_threads(2)

# f32: the folded block computes conv(x, W * scale) where the unfolded one
# computes conv(x, W) * scale, and adds the downsample's shift in another
# order: a few f32 roundings of each output (2.8e-7 of the largest magnitude
# at most on these blocks, weight and input seeds 0-50)
RTOL_F32 = 1e-6
# bf16: folding rounds each W * scale to bf16 once, where the unfolded block
# rounds the convolution's output, the product and each sum. On these
# blocks (weight and input seeds 0-50) the folded path sat 2.8e-3 to 6.3e-3
# of the largest magnitude from the f32 block, the unfolded one 4.6e-3 to
# 8.4e-3, the folded error 0.39 to 1.22 times the unfolded one's, so each
# is held to 2e-2, and the folded one to 1.5 times the unfolded one's error
RTOL_BF16, BF16_RATIO = 2e-2, 1.5
# an R-14 body and res5 head (five blocks deep): folded 5.0e-3 to 8.1e-3,
# unfolded 6.4e-3 to 1.18e-2, ratio 0.62 to 0.84 over seeds 0-5
RTOL_BF16_BODY = 3e-2

BLOCKS = {
    # in, bottleneck, out channels and the keywords of Bottleneck
    "downsample_stride2": (16, 8, 32, dict(stride=2)),
    "identity": (32, 8, 32, {}),
    "stride_in_3x3": (16, 8, 32, dict(stride=2, stride_in_1x1=False)),
    "res5_dilated": (32, 16, 64, dict(stride=1, dilation=2)),
    "grouped": (32, 32, 64, dict(stride=2, num_groups=8)),
}


def _norms(block):
    return [m for m in block.modules() if isinstance(m, FrozenBatchNorm2d)]


def _randomise_norms_(module, seed):
    g = torch.Generator().manual_seed(seed)
    for bn in _norms(module):
        n = bn.weight.numel()
        bn.weight.copy_(torch.rand(n, generator=g) + 0.5)
        bn.bias.copy_(torch.randn(n, generator=g))
        bn.running_mean.copy_(torch.randn(n, generator=g) * 0.5)
        bn.running_var.copy_(torch.rand(n, generator=g) * 1.5 + 0.5)
        bn.refresh()
    return module


def _block(name, dtype=torch.float32, seed=0, norm="frozen_bn"):
    cin, mid, cout, kw = BLOCKS[name]
    block = Bottleneck(cin, mid, cout, dtype=dtype, norm=norm, **kw)
    with torch.no_grad():
        for m in block.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(torch.Generator().manual_seed(seed))
        if norm != "gn":
            _randomise_norms_(block, seed + 1)
    return block


def _cast(block):
    """``init_module_``'s cast without its draw: ``modules()`` order, the
    block before its convolutions."""
    for m in block.modules():
        if hasattr(m, "cast_weights_"):
            m.cast_weights_()
    return block


def _bf16_twin(block, name):
    """A bf16 block holding ``block``'s weights, cast (and folded) as
    ``init_module_(cast=True)`` leaves a model."""
    twin = _block(name, torch.bfloat16)
    twin.load_state_dict(block.state_dict())
    return _cast(twin)


def _input(block, seed=2, dtype=torch.float32, hw=(9, 13)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, block.conv1.weight.shape[1], *hw, generator=g).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


def _unfolded(block, x):
    """The block's train-mode (unfolded) forward, without grad."""
    block.train()
    with torch.no_grad():
        return block(x)


def _folded(block, x):
    block.eval()
    with torch.no_grad():
        return block(x)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.fixture
def epilogue_calls(monkeypatch):
    """Counts the block's epilogue calls (the CPU has no launches to count)."""
    calls = []
    from mega_pytorch_tpu_torch.models.backbone import resnet

    def counted(*args):
        calls.append(args[0].shape)
        return be.bottleneck_epilogue(*args)

    monkeypatch.setattr(resnet, "bottleneck_epilogue", counted)
    return calls


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_folded_formula_matches_unfolded_f32(name, epilogue_calls):
    """The fold's algebra in f32 arithmetic (strides, dilation, groups, the
    downsample's shift moved into the last pass): the folded forward of an
    f32 block, folded by hand, equals its unfolded forward within f32
    rounding."""
    block = _block(name)
    x = _input(block)
    want = _unfolded(block, x)
    assert not epilogue_calls
    block.eval()
    with torch.no_grad():
        block._fold()
        got = block._forward_folded(x)
    assert len(epilogue_calls) == 3
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert _rel(got, want) < RTOL_F32


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_f32_blocks_run_unfolded(name, epilogue_calls):
    """f32 blocks keep the unfolded forward in eval mode too: bit for bit
    the train-mode output, no folded buffers, no epilogue."""
    block = _block(name)
    x = _input(block)
    want = _unfolded(block, x)
    got = _folded(block, x)
    assert not epilogue_calls
    assert not any(hasattr(block, n) for n in Bottleneck.FOLDED)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_folded_block_bf16_bound(name, epilogue_calls):
    """bf16 blocks, each path against the f32 unfolded block with the same
    weights: the folded one within RTOL_BF16 and within BF16_RATIO of the
    unfolded one's error."""
    exact = _block(name)
    x = _input(exact)
    want = _unfolded(exact, x)
    low = _bf16_twin(exact, name)
    low_x = x.to(torch.bfloat16)
    folded = _folded(low, low_x)
    assert len(epilogue_calls) == 3
    unfolded = _unfolded(low, low_x)
    assert folded.dtype == torch.bfloat16
    err_folded, err_unfolded = _rel(folded, want), _rel(unfolded, want)
    assert err_folded < RTOL_BF16 and err_unfolded < RTOL_BF16
    assert err_folded <= BF16_RATIO * err_unfolded


def test_cast_weights_folds_the_weights_before_they_are_cast():
    """``cast_weights_`` folds before the convolutions store bf16: each
    folded weight is the f32 product rounded once, each shift f32."""
    block = _block("downsample_stride2", torch.bfloat16)
    f32 = {k: v.clone() for k, v in block.state_dict().items()}
    _cast(block)
    assert block.conv1.weight.dtype == torch.bfloat16
    for wname, conv, bn in (("w1", "conv1", "bn1"), ("w2", "conv2", "bn2"),
                            ("w3", "conv3", "bn3"), ("w_down", "downsample_conv",
                                                     "downsample_bn")):
        scale = f32[f"{bn}.weight"] / torch.sqrt(f32[f"{bn}.running_var"])
        want = (f32[f"{conv}.weight"] * scale.view(-1, 1, 1, 1)).to(torch.bfloat16)
        assert torch.equal(getattr(block, wname), want), wname
        assert getattr(block, wname).is_contiguous(memory_format=torch.channels_last)
    shift = {bn: f32[f"{bn}.bias"] - f32[f"{bn}.running_mean"] * f32[f"{bn}.weight"]
             / torch.sqrt(f32[f"{bn}.running_var"]) for bn in ("bn1", "bn3", "downsample_bn")}
    assert block.shift1.dtype == block.shift3.dtype == torch.float32
    torch.testing.assert_close(block.shift1, shift["bn1"], rtol=0, atol=1e-6)
    torch.testing.assert_close(block.shift3, shift["bn3"] + shift["downsample_bn"],
                               rtol=0, atol=1e-6)


def test_load_state_dict_after_a_forward_refolds():
    block = _cast(_block("downsample_stride2", torch.bfloat16)).eval()
    x = _input(block, dtype=torch.bfloat16)
    first = _folded(block, x)
    other = _cast(_block("downsample_stride2", torch.bfloat16, seed=7))
    block.load_state_dict(other.state_dict())
    assert block.training is False
    got = _folded(block, x)
    twin = _block("downsample_stride2", torch.bfloat16)
    twin.load_state_dict(other.state_dict())  # the cast weights, folded afresh
    assert torch.equal(got, _folded(_cast(twin), x))
    assert _rel(first, got) > 1e-1  # the new weights moved the output


def test_state_dict_keys_unchanged():
    """The folded buffers stay out of the state dict in either mode, so every
    checkpoint and ``load_state_dict(strict=True)`` still fits."""
    block = _block("downsample_stride2", torch.bfloat16)
    keys = sorted(block.state_dict())
    assert keys == sorted(
        [f"{m}.weight" for m in ("conv1", "conv2", "conv3", "downsample_conv")]
        + [f"{m}.{b}" for m in ("bn1", "bn2", "bn3", "downsample_bn")
           for b in ("bias", "running_mean", "running_var", "weight")])
    block.eval()
    assert block.w1.numel() > 0
    assert sorted(block.state_dict()) == keys
    body = ResNetC4("R-14", dtype=torch.bfloat16)
    train_keys = list(body.state_dict())
    init_module_(body, torch.Generator().manual_seed(0), cast=True)
    assert list(body.state_dict()) == train_keys
    body.load_state_dict(body.state_dict(), strict=True)


def test_training_takes_the_unfolded_path_and_its_gradients(epilogue_calls):
    """Train mode runs the convolutions and norms as written (the parent's
    forward, spelled out here), with the same gradients into each
    convolution's weight, and holds no folded buffers."""
    block = _block("downsample_stride2", torch.bfloat16)
    block.eval()
    block.train()
    assert all(getattr(block, n).numel() == 0 for n in Bottleneck.FOLDED)
    x = _input(block, dtype=torch.bfloat16)

    def parent_forward(b, x):
        identity = b.downsample_bn(b.downsample_conv(x))
        out = torch.relu(b.bn1(b.conv1(x)))
        out = torch.relu(b.bn2(b.conv2(out)))
        return torch.relu(b.bn3(b.conv3(out)) + identity)

    convs = [block.conv1, block.conv2, block.conv3, block.downsample_conv]
    grads = []
    for forward in (block, lambda x: parent_forward(block, x)):
        for c in convs:
            c.weight.grad = None
        (forward(x).float() ** 2).sum().backward()
        grads.append([c.weight.grad.clone() for c in convs])
    assert not epilogue_calls
    for got, want in zip(*grads):
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_gn_blocks_stay_unfolded(epilogue_calls):
    block = _block("grouped", torch.bfloat16, norm="gn")  # widths of GN's 32 groups
    x = _input(block, dtype=torch.bfloat16)
    block.eval()
    assert not any(hasattr(block, n) for n in Bottleneck.FOLDED)
    got = _folded(block, x)
    assert not epilogue_calls
    assert got.shape == (2, 64, 5, 7) and torch.equal(got, _unfolded(block, x))


def test_back_in_eval_after_training_folds_the_new_weights():
    block = _cast(_block("identity", torch.bfloat16)).eval()
    x = _input(block, dtype=torch.bfloat16)
    before = _folded(block, x)
    block.train()
    with torch.no_grad():
        block.conv2.weight.mul_(-1.5)  # what an optimizer step does in place
    got = _folded(block, x)
    twin = _cast(_block("identity", torch.bfloat16))
    twin.load_state_dict(block.state_dict())
    assert torch.equal(got, _folded(twin, x))
    assert not torch.equal(got, before)


def test_c4_body_and_res5_head_fold():
    """An R-14 body and dilated res5 head in bf16, eval (folded) and train
    mode (unfolded), each against the same modules in f32."""
    g = torch.Generator().manual_seed(3)
    exact = [_randomise_norms_(init_module_(m, g), 4)
             for m in (ResNetC4("R-14"), ResNetRes5Head("R-14"))]
    low = [_cast(m) for m in (ResNetC4("R-14", dtype=torch.bfloat16),
                              ResNetRes5Head("R-14", dtype=torch.bfloat16))]
    for m, e in zip(low, exact):
        m.load_state_dict(e.state_dict())
    frames = torch.randn(2, 64, 96, 3, generator=g)
    want = _unfolded(exact[1], _unfolded(exact[0], frames))
    folded = _folded(low[1], _folded(low[0], frames))
    unfolded = _unfolded(low[1], _unfolded(low[0], frames))
    err_folded, err_unfolded = _rel(folded, want), _rel(unfolded, want)
    assert err_folded < RTOL_BF16_BODY and err_unfolded < RTOL_BF16_BODY
    assert err_folded <= BF16_RATIO * err_unfolded


class _Detector(nn.Module):
    """What ``calibrate_frozen_bn`` reads of a detector: a backbone and an
    extractor with ``enhance_features``."""

    def __init__(self, g):
        super().__init__()
        self.backbone = init_module_(ResNetC4("R-14", dtype=torch.bfloat16), g, cast=True)
        self.extractor = init_module_(ResNetRes5Head("R-14", dtype=torch.bfloat16), g,
                                      cast=True)
        self.extractor.enhance_features = self.extractor.forward


def test_calibration_of_an_eval_model_reaches_every_norm_and_refolds(epilogue_calls):
    g = torch.Generator().manual_seed(5)
    model = _Detector(g).eval()
    frames = torch.randn(2, 64, 96, 3, generator=g)
    calibrate_frozen_bn(model, frames)
    assert not model.training and not epilogue_calls  # calibrated unfolded
    norms = [m for m in model.modules() if isinstance(m, FrozenBatchNorm2d)]
    assert all(not torch.equal(bn.running_var, torch.ones_like(bn.running_var))
               for bn in norms)
    got = _folded(model.extractor, _folded(model.backbone, frames))
    assert len(epilogue_calls) == 3 * 4  # one block a stage, four stages
    twin = _Detector(torch.Generator().manual_seed(6))
    twin.load_state_dict(model.state_dict())  # folds the calibrated statistics afresh
    assert torch.equal(got, _folded(twin.extractor, _folded(twin.backbone, frames)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_epilogue_matches_its_formula(dtype, residual):
    """relu(a + shift (+ r)), the sums in f32 in that order, rounded once."""
    rs = np.random.RandomState(9)
    a = torch.from_numpy(rs.randn(2, 16, 5, 7).astype(np.float32) * 3).to(dtype)
    a = a.contiguous(memory_format=torch.channels_last)
    r = (torch.from_numpy(rs.randn(2, 16, 5, 7).astype(np.float32)).to(dtype)
         .contiguous(memory_format=torch.channels_last) if residual else None)
    shift = torch.from_numpy(rs.randn(16).astype(np.float32))
    got = be.bottleneck_epilogue(a, shift, r)
    want = a.float().numpy() + shift.numpy()[None, :, None, None]
    if residual:
        want = want + r.float().numpy()
    want = torch.from_numpy(np.maximum(want, 0).astype(np.float32)).to(dtype)
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    assert (got >= 0).all() and (got == 0).any() and (got > 0).any()
