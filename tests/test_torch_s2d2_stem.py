"""The s2d(2) stem: canvases that are even but not multiples of 4.

* The port's ``Stem`` on s2d(2)-packed frames (the exact 4x4/1
  reformulation) against JAX's ``Stem`` on the same packed frames and
  bridged weights, and against the port's own canonical 7x7/2 branch, at a
  canvas that is 2 mod 4 with one padded frame; ``s2d_stem_kernel`` against
  JAX's.
* ``pack_factor`` against the pack the JAX engine hands its lane feeds.
* One lockstep MEGA step pair with s2d(2)-packed frames against JAX's
  ``make_lockstep_step`` on the tiny model.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.data.transforms import normalize_u8_frames as jax_normalize
from mega_pytorch_tpu.engine import batched_inference as jax_engine
from mega_pytorch_tpu.models.backbone.resnet import Stem as JaxStem
from mega_pytorch_tpu.models.backbone.resnet import s2d_stem_kernel as jax_s2d_stem_kernel
from mega_pytorch_tpu.models.detectors import mega as jax_mega
from mega_pytorch_tpu.models.detectors.rdn import VidConfig
from mega_pytorch_tpu_torch.data.transforms import normalize_u8_frames, s2d_pack_frames
from mega_pytorch_tpu_torch.engine import batched_inference as engine
from mega_pytorch_tpu_torch.models.backbone.resnet import Stem, s2d_stem_kernel
from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from torch_port_harness import (
    _perturb,
    assert_field_close,
    match_detections,
    off_relu_corner,
    port_mega_from,
    tiny_mega,
    to_np,
)

torch.set_num_threads(2)

CANVAS2 = (50, 66)  # both sides 2 mod 4: the engine packs s2d(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_s2d_stem_kernel_matches_jax():
    rs = np.random.RandomState(4)
    w7 = rs.randn(7, 7, 3, 8).astype(np.float32)  # JAX's HWIO
    want = np.asarray(jax_s2d_stem_kernel(jnp.asarray(w7)))  # (4, 4, 12, 8)
    got = s2d_stem_kernel(_t(w7.transpose(3, 2, 0, 1))).numpy()  # (8, 12, 4, 4)
    np.testing.assert_array_equal(got, want.transpose(3, 2, 0, 1))


def test_stem_s2d2_matches_jax_and_canonical():
    """Same tolerance as test_stem_canonical_and_packed_paths_match."""
    rs = np.random.RandomState(13)
    h, w = CANVAS2
    frames = rs.randint(0, 256, (2, h, w, 3), dtype=np.uint8)
    sizes = np.array([[h, w], [37, 51]], np.float32)  # one padded canvas
    x3 = normalize_u8_frames(_t(frames), _t(sizes)).numpy()
    x12 = normalize_u8_frames(_t(s2d_pack_frames(frames, 2)), _t(sizes)).numpy()
    np.testing.assert_array_equal(x12, s2d_pack_frames(x3, 2))
    np.testing.assert_array_equal(
        x12, np.asarray(jax_normalize(jnp.asarray(s2d_pack_frames(frames, 2)),
                                      jnp.asarray(sizes))))
    stem = JaxStem()
    params = _perturb(to_np(jax.jit(stem.init)(jax.random.PRNGKey(3), jnp.asarray(x3))
                            ["params"]), rs)
    want = np.asarray(stem.apply({"params": params}, jnp.asarray(x12)))
    port = Stem()
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    port.eval().requires_grad_(False)
    before = sp.stem_pool_packed.launches
    with torch.inference_mode():
        got12 = port(_t(x12)).permute(0, 2, 3, 1).numpy()
        got3 = port(_t(x3)).permute(0, 2, 3, 1).numpy()
    assert sp.stem_pool_packed.launches == before  # no stem pool on this branch
    assert got12.shape == got3.shape == want.shape == (2, 13, 17, 64)
    np.testing.assert_allclose(got12, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got12, got3, rtol=1e-4, atol=1e-4)


class _Prep:
    class Out:
        def __init__(self, image):
            self.image = image
            self.size = np.array(image.shape[:2], np.float32)

    def _prep_u8(self, img, flip):
        return self.Out(img)


class _OneVideo:
    """One 2-frame video of a constant canvas of ``shape``."""

    def __init__(self, shape):
        self.shape = shape
        self.image_set_index = ["v0/000000", "v0/000001"]
        self.pattern = ["v0/%06d"] * 2
        self.frame_seg_len = [2, 2]

    def load_frame(self, pattern, fid):
        return np.zeros((*self.shape, 3), np.uint8)


class _Recorded(Exception):
    pass


@pytest.mark.parametrize("method", ["mega", "rdn", "fgfa", "dff"])
def test_pack_factor_matches_jax_engine(method, monkeypatch):
    """The pack JAX's ``compute_on_dataset_lockstep`` hands its lane feeds,
    for (48, 64) → 4, (50, 66) → 2, (52, 66) → 2, (49, 64) → 0 at mega and
    rdn, and 0 at fgfa; JAX's DFF feed reads plain frames (0)."""
    seen = []

    def recording_feed(*args, pack=0, **kwargs):
        seen.append(pack)
        raise _Recorded

    monkeypatch.setattr(jax_engine, "_LaneFeed", recording_feed)
    v = VidConfig(method=method, all_frame_interval=3, key_frame_location=1)
    model = SimpleNamespace(v=v)
    expect = {"mega": (4, 2, 2, 0), "rdn": (4, 2, 2, 0)}.get(method, (0,) * 4)
    for shape, want in zip(((48, 64), (50, 66), (52, 66), (49, 64)), expect):
        got = engine.pack_factor(method, (*shape, 3))
        assert got == want, (shape, got)
        if method == "dff":
            continue
        seen.clear()
        with pytest.raises(_Recorded):
            jax_engine.compute_on_dataset_lockstep(model, None, _OneVideo(shape), [0, 1],
                                                   _Prep(), lanes=1)
        assert seen == [got], shape


LANES, STEPS = 2, 2
RESETS = np.array([[True, True], [False, True]])
GMASKS = np.array([[True, False], [True, True]])
EMITS = np.array([[False, False], [True, False]])
ATOL_CARRY, ATOL_BOX = 1e-3, 5e-3  # as test_torch_lockstep.py


def _s2d2_inputs():
    rs = np.random.RandomState(9)
    shape = (STEPS, LANES, *CANVAS2, 3)
    frames = s2d_pack_frames(rs.randint(0, 256, shape, dtype=np.uint8), 2)
    gframes = s2d_pack_frames(rs.randint(0, 256, shape, dtype=np.uint8), 2)
    sizes = np.tile(np.array(CANVAS2, np.float32), (STEPS, LANES, 1))
    sizes[1, 0] = (45.0, 60.0)  # one padded canvas
    return frames, sizes, gframes, sizes.copy()


def test_lockstep_s2d2_frames_match_jax():
    """Two steps of 2 lanes of 12-channel frames through the port's
    ``make_lockstep_step`` and JAX's: every carry field and the emitted
    lane's detections, with no stem pool launch."""
    model, params = tiny_mega()
    params = off_relu_corner(params)
    port = port_mega_from(params)
    frames, sizes, gframes, gsizes = _s2d2_inputs()
    assert frames.shape[-1] == 12
    jstep = jax_engine.make_lockstep_step(model)
    pstep = engine.make_lockstep_step(port)
    pc = port.zero_carry(LANES, "cpu")
    jc = jax_mega.MEGACarry(*(
        tuple(jnp.asarray(y.numpy()) for y in x) if isinstance(x, tuple)
        else jnp.asarray(x.numpy()) for x in pc))
    before = sp.stem_pool_packed.launches
    for s in range(STEPS):
        jc, jd = jstep(params, jc, jnp.asarray(frames[s][:, None]),
                       jnp.asarray(sizes[s][:, None]), jnp.asarray(gframes[s][:, None]),
                       jnp.asarray(gsizes[s][:, None]), jnp.asarray(RESETS[s]),
                       jnp.asarray(GMASKS[s]), jnp.asarray(EMITS[s]))
        pc, pd = pstep(pc, _t(frames[s]), _t(sizes[s]), _t(gframes[s]), _t(gsizes[s]),
                       _t(RESETS[s]), _t(GMASKS[s]), _t(EMITS[s]))
        for name in pc._fields:
            atol = ATOL_BOX if name in ("rois", "key_rois", "mem_rois") else ATOL_CARRY
            got = getattr(pc, name)
            got = tuple(y.numpy() for y in got) if isinstance(got, tuple) else got.numpy()
            assert_field_close(to_np(getattr(jc, name)), got, atol, f"{name} step {s}")
    assert sp.stem_pool_packed.launches == before
    matched, total = match_detections(to_np(jd), [x.numpy() for x in pd], LANES)
    assert total > 0 and matched >= 0.95 * total, (matched, total)
