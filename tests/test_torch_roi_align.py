"""The port's ROIAlign entry (``mega_pytorch_tpu_torch/ops/roi_align.py``)
on the CPU: CPU tensors take the plain version and launch nothing;
``out_dtype`` rounds the f32 result once; the wrapper's shape checks and the
kernel's operand checks raise; the entry counts no FLOPs and no aten product
of its plain version; ``ROIAlignFunction``'s gradients are autograd's
through the plain version; ``Res5Pooler.pool_flat`` hands the map over as
stored and takes its output in the compute dtype. The JAX parity of the
plain version is ``tests/test_roi_align.py`` (JAX package) and
``test_torch_modules.py::test_roi_align_matches``; the kernel's own checks
are card-only, in ``test_torch_kernels_cuda.py``."""

import types

import numpy as np
import pytest
import torch

from mega_pytorch_tpu_torch.models.roi_heads.mega_extractor import Res5Pooler
from mega_pytorch_tpu_torch.ops import roi_align as ra
from mega_pytorch_tpu_torch.tools.profile_mfu import count_flops
from mega_pytorch_tpu_torch.utils import profiler

torch.set_num_threads(2)


def _inputs(seed, lanes=2, count=9, h=12, w=18, c=8, dtype=torch.float32):
    rs = np.random.RandomState(seed)
    feat = torch.from_numpy(rs.randn(lanes, h, w, c).astype(np.float32)).to(dtype)
    xy = rs.uniform(-40, 16 * max(h, w), (lanes, count, 2))
    wh = rs.uniform(0, 200, (lanes, count, 2))
    rois = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32))
    return feat, rois


@pytest.mark.parametrize("pooled,ratio", [(7, 0), (7, 2), (14, 0), (3, 1)])
def test_cpu_tensors_take_the_plain_version(pooled, ratio):
    feat, rois = _inputs(pooled + ratio)
    before = ra.roi_align.launches
    with profiler.recording():
        got = ra.roi_align(feat, rois, 1 / 16, pooled, pooled, ratio)
    rec = profiler.recorded()
    assert ra.roi_align.launches == before
    assert rec["spans"]["roi_align"]["calls"] == 1 and "roi_align.launches" not in rec["counters"]
    assert torch.equal(got, ra.roi_align_reference(feat, rois, 1 / 16, pooled, pooled, ratio))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("map_dtype", [torch.bfloat16, torch.float32])
def test_out_dtype_rounds_the_f32_result_once(map_dtype, out_dtype):
    feat, rois = _inputs(3, dtype=map_dtype)
    got = ra.roi_align(feat, rois, 1 / 16, out_dtype=out_dtype)
    want = ra.roi_align(feat.float(), rois, 1 / 16)
    assert want.dtype == torch.float32 and got.dtype == out_dtype
    assert torch.equal(got, want.to(out_dtype))


@pytest.mark.parametrize("feat_shape,rois_shape,match", [
    ((2, 12, 18), (2, 5, 4), r"\(L, H, W, C\)"),
    ((2, 12, 18, 8, 1), (2, 5, 4), r"\(L, H, W, C\)"),
    ((2, 12, 18, 8), (5, 4), r"\(L, R, 4\)"),
    ((2, 12, 18, 8), (2, 5, 5), r"\(L, R, 4\)"),
    ((2, 12, 18, 8), (3, 5, 4), r"\(L, R, 4\) with L = 2"),
])
def test_wrapper_checks_shapes(feat_shape, rois_shape, match):
    with pytest.raises(ValueError, match=match):
        ra.roi_align(torch.zeros(feat_shape), torch.zeros(rois_shape), 1 / 16)


def test_kernel_operand_checks():
    """What a CUDA call is checked for before its launch, on CPU tensors:
    the channel-last stride first, then the dtypes, then the device."""
    feat, rois = _inputs(4)
    nchw = feat.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="channel-last"):
        ra.check_kernel_operands(nchw, rois, torch.float32)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ra.check_kernel_operands(feat.half(), rois, torch.float32)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ra.check_kernel_operands(feat, rois, torch.float16)
    with pytest.raises(ValueError, match="one device"):
        ra.check_kernel_operands(feat, rois, torch.bfloat16)
    # one channel: any channel stride; a lane-strided view (MEGA's global
    # maps) passes the stride check
    with pytest.raises(ValueError, match="one device"):
        ra.check_kernel_operands(nchw[..., :1], rois, torch.float32)
    pair = torch.stack([feat, feat], 1)[:, 1]
    with pytest.raises(ValueError, match="one device"):
        ra.check_kernel_operands(pair, rois, torch.float32)


def test_entry_counts_no_flops():
    """A weighted gather is no work of the model's FLOP count: the entry
    counts 0, and not the einsums of the plain version beneath it."""
    feat, rois = _inputs(5)
    with torch.inference_mode():
        got = count_flops(lambda: ra.roi_align(feat, rois, 1 / 16))
    assert got["flops"] == 0
    assert got["kernel_flops"] == {"roi_align": 0}
    assert list(got["by_op"]) == ["mega_pytorch_tpu_torch.roi_align"]


@pytest.mark.parametrize("roi_grad", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_function_gradients_are_autograd_through_the_plain_version(out_dtype, roi_grad):
    """ROIAlignFunction on CPU tensors (its forward then the plain version
    too): output and gradients of the map and, where asked, of the ROIs
    equal autograd's through the plain version."""
    feat, rois = _inputs(6, dtype=torch.bfloat16)
    args = (1 / 16, 7, 7, 0, 10, out_dtype)
    ops = [feat.clone().requires_grad_(), rois.clone().requires_grad_(roi_grad)]
    out = ra.ROIAlignFunction.apply(*ops, *args)
    want_out = ra.roi_align_reference(*ops, *args)
    assert torch.equal(out, want_out)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(out_dtype)
    leaves = ops if roi_grad else ops[:1]
    got = torch.autograd.grad(out, leaves, cot)
    want = torch.autograd.grad(want_out, leaves, cot)
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype and torch.equal(g, w)


def test_pool_flat_hands_over_the_map_as_stored():
    """``Res5Pooler.pool_flat``: the bf16 map as stored, the pooled columns
    in the compute dtype, equal to the f32 result of the f32 map rounded
    once (what fc0's cast made of it before)."""
    feat, rois = _inputs(7, c=16, dtype=torch.bfloat16)
    pooler = types.SimpleNamespace(spatial_scale=1 / 16, resolution=7, sampling_ratio=0,
                                   dtype=torch.bfloat16)
    got = Res5Pooler.pool_flat(pooler, feat, rois)
    want = ra.roi_align(feat.float(), rois, 1 / 16).flatten(2).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
