"""The streaming MEGA slice as a whole: the PyTorch port's serving step
(engine/inference.py run_video) against the JAX package's per-lane protocol
(precompute_pair, init_carry / push_carry, apply_global, detect_key) on the
same tiny model, weights and s2d(4)-packed uint8 video. Carries are compared
every step; detections of every emitted frame are matched as in the live
reference parity suite."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.data.transforms import normalize_u8_frames, s2d_pack_frames
from mega_pytorch_tpu.models.detectors.mega import GeneralizedRCNNMEGA
from mega_pytorch_tpu.structures.image_list import ImageBatch
from mega_pytorch_tpu_torch.engine.inference import run_video
from mega_pytorch_tpu_torch.models.detectors import mega as port_mega
from test_mega import TINY_V
from test_parity_reference import _match_detail, classify_unmatched
from torch_port_harness import CANVAS, port_mega_from, tiny_mega

torch.set_num_threads(2)

NUM_FRAMES = 6
ATOL_CARRY = 1e-3


def _video():
    rs = np.random.RandomState(0)
    frames = rs.randint(0, 256, (NUM_FRAMES, *CANVAS, 3), dtype=np.uint8)
    packed = s2d_pack_frames(frames, 4)
    n_glob = TINY_V.global_size + NUM_FRAMES - 1
    gframes = packed[rs.randint(0, NUM_FRAMES, n_glob)]
    sizes = np.tile(np.array(CANVAS, np.float32), (NUM_FRAMES, 1))
    sizes[1] = (57.0, 90.0)  # one frame with a padded canvas
    return packed, gframes, sizes


def _jax_stream(model, params, frames, gframes, sizes):
    """The lockstep engine's lane protocol, serially, with jitted pieces."""
    M = GeneralizedRCNNMEGA

    def apply(method):
        return jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))

    @jax.jit
    def pair(p, u8, sz):
        both = ImageBatch(tensors=normalize_u8_frames(u8, sz), sizes=sz)
        return model.apply({"params": p}, both, method=M.precompute_pair)

    init, push = apply(M.init_carry), apply(M.push_carry)
    glob, detect = apply(M.apply_global), apply(M.detect_key)
    warmup = TINY_V.all_frame_interval - TINY_V.key_frame_location - 1
    full = np.array(CANVAS, np.float32)
    carry, g, out = None, 0, []
    for s in range(warmup + NUM_FRAMES):
        j = s - warmup
        fid = min(s, NUM_FRAMES - 1)
        gid = None
        if s < TINY_V.global_size or j >= 1:
            gid, g = g, g + 1
        gframe = gframes[gid] if gid is not None else frames[fid]
        gsize = full if gid is not None else sizes[fid]
        sz = jnp.asarray(np.stack([sizes[fid], gsize]))
        entry, gp, gv = pair(params, jnp.asarray(np.stack([frames[fid], gframe])), sz)
        carry = init(params, entry, sz[0]) if s == 0 else push(params, carry, entry, sz[0])
        if gid is not None:
            carry = glob(params, carry, gp, gv)
        new_carry, dets = detect(params, carry)
        if j >= 0:
            carry = new_carry
        out.append((jax.tree_util.tree_map(np.asarray, carry),
                    jax.tree_util.tree_map(np.asarray, dets), j >= 0))
    return out


@pytest.fixture(scope="module")
def streams():
    model, params = tiny_mega()
    frames, gframes, sizes = _video()
    jax_out = _jax_stream(model, params, frames, gframes, sizes)
    port = port_mega_from(params)
    port_out = [
        (jax.tree_util.tree_map(lambda t: t.numpy(), o.carry),
         jax.tree_util.tree_map(lambda t: t.numpy(), o.dets), o.emitted)
        for o in run_video(port, frames, gframes, sizes=sizes)
    ]
    return jax_out, port_out


def test_slice_runs_every_step(streams):
    jax_out, port_out = streams
    assert len(port_out) == len(jax_out) == NUM_FRAMES + 1
    assert [e for *_, e in port_out] == [e for *_, e in jax_out]


@pytest.mark.parametrize("field", [
    "rois", "roi_valid", "feats", "key_rois", "key_valid", "key_feats", "sizes",
    "mem_rois", "mem_feats", "mem_valid", "g_feats", "g_valid",
])
def test_slice_carry_matches_every_step(streams, field):
    jax_out, port_out = streams
    for step, ((jc, _, _), (pc, _, _)) in enumerate(zip(jax_out, port_out)):
        want, got = getattr(jc, field), getattr(pc, field)
        for w, g_ in zip(*(((want,), (got,)) if not isinstance(want, tuple)
                           else (want, got))):
            assert w.shape == g_.shape, (field, step)
            if w.dtype == bool:
                np.testing.assert_array_equal(g_, w, err_msg=f"{field} step {step}")
            else:
                np.testing.assert_allclose(g_, w, rtol=0, atol=ATOL_CARRY,
                                           err_msg=f"{field} step {step}")


def test_slice_detections_match(streams):
    jax_out, port_out = streams
    total, matched_all = 0, 0
    for step, ((_, jd, emit), (_, pd, _)) in enumerate(zip(jax_out, port_out)):
        if not emit:
            continue
        assert pd.boxes.shape == jd.boxes.shape
        assert np.isfinite(pd.boxes).all() and np.isfinite(pd.scores).all()

        def valid(d):
            v = d.valid[0]
            return d.boxes[0][v], d.scores[0][v], d.labels[0][v]

        ref, ours = valid(jd), valid(pd)
        matched, _, unmatched, used = _match_detail(ref, ours)
        counts = classify_unmatched(ref, ours, unmatched, used)
        assert counts["DRIFT"] == [], (step, counts)
        total += len(ref[0])
        matched_all += matched
    assert total > 0
    assert matched_all >= 0.95 * total, (matched_all, total)


def _to_port_carry(carry):
    """A JAX one-lane carry as the port's carry of one lane."""
    def t(x):
        return torch.from_numpy(np.array(x))[None]
    return port_mega.MEGACarry(*[
        tuple(t(a) for a in f) if isinstance(f, tuple) else t(f) for f in carry
    ])


def _assert_carry_close(got, want):
    """got: the port's carry of one lane; want: the JAX one-lane carry."""
    for name, w in want._asdict().items():
        g = getattr(got, name)
        for wi, gi in zip(w if isinstance(w, tuple) else (w,),
                          g if isinstance(g, tuple) else (g,)):
            np.testing.assert_allclose(gi[0].numpy().astype(np.float32),
                                       np.asarray(wi).astype(np.float32),
                                       rtol=0, atol=ATOL_CARRY, err_msg=name)


def test_test_step_precompute_and_update_global_match(streams):
    """The model-level entry points off the serving step's path, from a
    carry both sides share: test_step (stacked pair), update_global
    (precompute_global) and precompute."""
    jax_out, _ = streams
    model, params = tiny_mega()
    M = GeneralizedRCNNMEGA
    frames, gframes, sizes = _video()
    sz = np.stack([sizes[4], np.array(CANVAS, np.float32)])
    both = np.asarray(normalize_u8_frames(jnp.asarray(np.stack([frames[4], gframes[5]])),
                                          jnp.asarray(sz)))
    jc = jax_out[3][0]
    port = port_mega_from(params)
    pc = _to_port_carry(jc)
    tb, ts = torch.from_numpy(both), torch.from_numpy(sz)

    def apply(method, *args):
        return jax.jit(lambda p, *a: model.apply({"params": p}, *a, method=method))(
            params, *args)

    want_c, want_d = apply(M.test_step, jc, ImageBatch(tensors=both, sizes=sz))
    with torch.inference_mode():
        got_c, got_d = port.test_step(pc, tb[None], ts[None])
        got_g = port.update_global(pc, tb[1:], ts[1:])
        got_e = port.precompute(tb[:1], ts[:1])
    _assert_carry_close(got_c, want_c)
    np.testing.assert_array_equal(got_d.valid.numpy(), np.asarray(want_d.valid))
    np.testing.assert_array_equal(got_d.labels.numpy(), np.asarray(want_d.labels))
    np.testing.assert_allclose(got_d.scores.numpy(), np.asarray(want_d.scores),
                               rtol=0, atol=ATOL_CARRY)

    want_g = apply(M.update_global, jc, ImageBatch(tensors=both[1:], sizes=sz[1:]))
    _assert_carry_close(got_g, want_g)
    want_e = apply(M.precompute, ImageBatch(tensors=both[:1], sizes=sz[:1]))
    for key, w in want_e.items():
        np.testing.assert_allclose(got_e[key][0].numpy().astype(np.float32),
                                   np.asarray(w).astype(np.float32), rtol=0,
                                   atol=ATOL_CARRY, err_msg=key)
