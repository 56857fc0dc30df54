"""Lockstep multi-lane MEGA streaming: the port's
``engine/batched_inference.py`` against the JAX package's.

* The port's step against JAX ``make_lockstep_step`` on the same tiny model,
  weights and s2d(4)-packed uint8 frames: 3 lanes, staggered resets, mixed
  global updates and emissions, one padded canvas. Carries are compared
  every step; detections of every emitted frame are matched as in the live
  reference parity suite.
* Lane l of the 3-lane step equals the one-lane step on lane l's inputs.
* ``compute_on_dataset_lockstep`` against JAX ``compute_on_dataset(lanes=2)``
  on the synthetic two-video dataset, each engine reading its own package's
  dataset and ``EvalPreprocessor``.
* The same for RDN (with its advanced stage), FGFA and DFF (key interval
  2), each against JAX ``compute_on_dataset(lanes=2)``.
* The engine's host scheduling (partition, video split, lane feed; DFF's
  aligned partition and lane feed; the lane feed without globals) against
  the JAX engine's.
* A lane with no valid ref gives zeros while the other lanes attend.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.data.datasets.vid import VIDMEGADataset
from mega_pytorch_tpu.data.loader import EvalPreprocessor
from mega_pytorch_tpu.data.transforms import s2d_pack_frames
from mega_pytorch_tpu.engine import batched_inference as jax_engine
from mega_pytorch_tpu.engine.inference import compute_on_dataset as jax_compute_on_dataset
from mega_pytorch_tpu.models.detectors import mega as jax_mega
from mega_pytorch_tpu.models.detectors.rdn import VidConfig
from mega_pytorch_tpu.models.roi_heads.attention import (
    RelationAttention as JaxRelationAttention,
)
from mega_pytorch_tpu.utils.misc import jit_init
from mega_pytorch_tpu_torch.data.loader import EvalPreprocessor as PortEvalPreprocessor
from mega_pytorch_tpu_torch.engine import batched_inference as engine
from mega_pytorch_tpu_torch.engine.inference import compute_on_dataset
from mega_pytorch_tpu_torch.models.roi_heads.attention import RelationAttention
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_engine import TINY_C as ENGINE_C
from test_engine import _dataset, _prep_kwargs
from test_parity_reference import _match_detail, classify_unmatched
from torch_port_harness import (
    CANVAS,
    _perturb,
    leaves,
    off_relu_corner,
    port_configs,
    port_dataset,
    port_mega_from,
    port_model_from,
    tiny_mega,
    to_np,
)

torch.set_num_threads(2)

LANES, STEPS = 3, 8
ATOL_CARRY = 1e-3
# proposal coordinates (pixels, up to ~100) decode the RPN's deltas, which
# come out of f32 convolutions of +-128 pixel values; XLA's and PyTorch's CPU
# convolutions round differently, ~2e-5 relative (1.6e-3 px seen)
ATOL_BOX = 5e-3
BOX_FIELDS = ("rois", "key_rois", "mem_rois")
# lane against one-lane step, on the CPU: GEMMs of another batch size round
# differently (~3e-6 seen); proposals, masks and labels stay exact. On the
# card the attention kernels are lane-independent bit for bit
# (test_torch_kernels_cuda.py)
ATOL_LANE = 1e-5
CARRY_FIELDS = ("rois", "roi_valid", "feats", "key_rois", "key_valid", "key_feats",
                "sizes", "mem_rois", "mem_feats", "mem_valid", "g_feats", "g_valid")
# per step and lane: reset, global update, emit. Every lane resets on its
# first step; lanes 1 and 2 start a second video at steps 3 and 5.
RESETS = [[s == 0 or (lane == 1 and s == 3) or (lane == 2 and s == 5)
           for lane in range(LANES)] for s in range(STEPS)]
GMASKS = [[(s + lane) % 3 != 2 for lane in range(LANES)] for s in range(STEPS)]
EMITS = [[s >= 1 + lane and not RESETS[s][lane] for lane in range(LANES)]
         for s in range(STEPS)]
RESETS, GMASKS, EMITS = np.array(RESETS), np.array(GMASKS), np.array(EMITS)


def _inputs():
    """Per step: frames, sizes, gframes, gsizes of every lane (numpy)."""
    rs = np.random.RandomState(0)
    shape = (STEPS, LANES, *CANVAS, 3)
    frames = s2d_pack_frames(rs.randint(0, 256, shape, dtype=np.uint8), 4)
    gframes = s2d_pack_frames(rs.randint(0, 256, shape, dtype=np.uint8), 4)
    sizes = np.tile(np.array(CANVAS, np.float32), (STEPS, LANES, 1))
    sizes[2, 1] = (57.0, 90.0)  # one frame with a padded canvas
    return frames, sizes, gframes, sizes.copy()


def _port_stream(port, lanes=tuple(range(LANES))):
    """The port's lockstep steps over ``lanes`` → per step (carry, dets) numpy."""
    frames, sizes, gframes, gsizes = _inputs()
    step = engine.make_lockstep_step(port)
    carries = port.zero_carry(len(lanes), "cpu")
    sel = list(lanes)
    out = []
    for s in range(STEPS):
        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a[s][sel]), dtype=dtype)
        carries, dets = step(carries, t(frames), t(sizes), t(gframes), t(gsizes),
                             t(RESETS, torch.bool), t(GMASKS, torch.bool),
                             t(EMITS, torch.bool))
        out.append((carries._make(
            tuple(y.numpy() for y in x) if isinstance(x, tuple) else x.numpy()
            for x in carries), dets._make(x.numpy() for x in dets)))
    return out


@pytest.fixture(scope="module")
def streams():
    model, params = tiny_mega()
    params = off_relu_corner(params)
    port = port_mega_from(params)
    frames, sizes, gframes, gsizes = _inputs()
    step = jax_engine.make_lockstep_step(model)
    zero = port.zero_carry(LANES, "cpu")
    carries = jax_mega.MEGACarry(*(
        tuple(jnp.asarray(y.numpy()) for y in x) if isinstance(x, tuple)
        else jnp.asarray(x.numpy()) for x in zero))
    jax_out = []
    for s in range(STEPS):
        carries, dets = step(
            params, carries, jnp.asarray(frames[s][:, None]), jnp.asarray(sizes[s][:, None]),
            jnp.asarray(gframes[s][:, None]), jnp.asarray(gsizes[s][:, None]),
            jnp.asarray(RESETS[s]), jnp.asarray(GMASKS[s]), jnp.asarray(EMITS[s]))
        jax_out.append((to_np(carries), to_np(dets)))
    return jax_out, _port_stream(port), port


@pytest.mark.parametrize("field", CARRY_FIELDS)
def test_lockstep_carry_matches_jax_every_step(streams, field):
    jax_out, port_out, _ = streams
    for s, ((jc, _), (pc, _)) in enumerate(zip(jax_out, port_out)):
        want, got = getattr(jc, field), getattr(pc, field)
        for w, g in zip(*(((want,), (got,)) if not isinstance(want, tuple)
                          else (want, got))):
            assert w.shape == g.shape, (field, s)
            if w.dtype == bool:
                np.testing.assert_array_equal(g, w, err_msg=f"{field} step {s}")
            else:
                atol = ATOL_BOX if field in BOX_FIELDS else ATOL_CARRY
                np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                           err_msg=f"{field} step {s}")


def test_lockstep_detections_match_jax(streams):
    jax_out, port_out, _ = streams
    total, matched_all = 0, 0
    for s, ((_, jd), (_, pd)) in enumerate(zip(jax_out, port_out)):
        for lane in range(LANES):
            if not EMITS[s][lane]:
                continue
            assert np.isfinite(pd.boxes[lane]).all() and np.isfinite(pd.scores[lane]).all()
            v_j, v_p = jd.valid[lane, 0], pd.valid[lane]
            ref = jd.boxes[lane, 0][v_j], jd.scores[lane, 0][v_j], jd.labels[lane, 0][v_j]
            ours = pd.boxes[lane][v_p], pd.scores[lane][v_p], pd.labels[lane][v_p]
            matched, _, unmatched, used = _match_detail(ref, ours)
            counts = classify_unmatched(ref, ours, unmatched, used)
            assert counts["DRIFT"] == [], (s, lane, counts)
            total += len(ref[0])
            matched_all += matched
    assert total > 0
    assert matched_all >= 0.95 * total, (matched_all, total)


def test_lane_equals_one_lane_step(streams):
    """Lane l of the 3-lane step equals the one-lane step on lane l's inputs."""
    _, port_out, port = streams
    for lane in range(LANES):
        solo = _port_stream(port, lanes=(lane,))
        for s, ((pc, pd), (sc, sd)) in enumerate(zip(port_out, solo)):
            for got, want in zip(leaves(pc) + list(pd), leaves(sc) + list(sd)):
                msg = f"lane {lane} step {s}"
                if want.dtype == np.float32:
                    np.testing.assert_allclose(got[lane], want[0], rtol=0,
                                               atol=ATOL_LANE, err_msg=msg)
                else:  # masks, labels
                    np.testing.assert_array_equal(got[lane], want[0], err_msg=msg)


def _engine_setup():
    v = VidConfig(method="mega", base_stage=2, all_frame_interval=3,
                  key_frame_location=1, memory_size=3, global_size=2,
                  global_res_stage=0)
    model = jax_mega.GeneralizedRCNNMEGA(c=ENGINE_C, v=v)
    return model, v


def _assert_predictions_match(got, want, indices):
    """Every frame predicted once on both sides; per frame the same number
    of boxes, and in score order the same labels, scores within 1e-3 and
    boxes within 0.2 px (original image coordinates)."""
    assert sorted(got) == sorted(want) == indices
    n_boxes = 0
    for i in indices:
        w, g = want[i], got[i]
        assert len(g["boxes"]) == len(w["boxes"]), i
        n_boxes += len(w["boxes"])
        wo, go = np.argsort(-w["scores"], kind="stable"), np.argsort(-g["scores"],
                                                                     kind="stable")
        np.testing.assert_array_equal(g["labels"][go], w["labels"][wo], err_msg=str(i))
        np.testing.assert_allclose(g["scores"][go], w["scores"][wo], rtol=0, atol=1e-3,
                                   err_msg=str(i))
        np.testing.assert_allclose(g["boxes"][go], w["boxes"][wo], rtol=0, atol=0.2,
                                   err_msg=str(i))
    assert n_boxes > 0


def test_compute_on_dataset_lockstep_matches_jax(tiny_root):
    model, v = _engine_setup()
    ds = _dataset(tiny_root, VIDMEGADataset, is_train=False, max_offset=1,
                  all_frame_interval=3, global_size=2, global_seed=0)
    prep = EvalPreprocessor(**_prep_kwargs())
    from mega_pytorch_tpu.structures.image_list import ImageBatch

    s0 = prep(ds[0])
    one = ImageBatch(tensors=s0["cur"], sizes=s0["cur_size"])
    M = jax_mega.GeneralizedRCNNMEGA
    tmp = jit_init(model, jax.random.PRNGKey(0), one, method=M.precompute)["params"]
    entry = model.apply({"params": tmp}, one, method=M.precompute)
    carry = model.apply({"params": tmp}, entry, one.sizes[0], method=M.init_carry)
    params = jit_init(model, jax.random.PRNGKey(0), carry, one, method=M.test_step)["params"]
    # spread the class scores far beyond float noise (torch_port_harness)
    params = off_relu_corner(_perturb(to_np(params), np.random.RandomState(1)))

    indices = list(range(len(ds)))
    want = jax_compute_on_dataset(model, params, ds, indices, prep, "mega", lanes=2)
    port = port_mega_from(params, c=ENGINE_C, v=v)
    port_ds = port_dataset(tiny_root, "VIDMEGADataset", max_offset=1, all_frame_interval=3,
                           global_size=2, global_seed=0)
    got = compute_on_dataset(port, port_ds, indices, PortEvalPreprocessor(**_prep_kwargs()),
                             "mega", lanes=2)
    _assert_predictions_match(got, want, indices)


def _method_setup(method, tiny_root):
    """(JAX model, dataset, params) of the tiny engine configuration for
    rdn, fgfa or dff, weights initialised on a zero frame and perturbed as
    the MEGA test's."""
    from mega_pytorch_tpu.data.datasets.vid import (
        VIDDFFDataset,
        VIDFGFADataset,
        VIDRDNDataset,
    )
    from mega_pytorch_tpu.models.detectors.dff import GeneralizedRCNNDFF
    from mega_pytorch_tpu.models.detectors.fgfa import GeneralizedRCNNFGFA
    from mega_pytorch_tpu.models.detectors.rdn import GeneralizedRCNNRDN
    from mega_pytorch_tpu.structures.image_list import ImageBatch

    one = ImageBatch(tensors=np.zeros((1, 48, 64, 3), np.float32),
                     sizes=np.array([[48.0, 64.0]], np.float32))
    key = jax.random.PRNGKey(0)
    if method == "dff":
        model = GeneralizedRCNNDFF(c=ENGINE_C, v=VidConfig(method="dff"))
        ds = _dataset(tiny_root, VIDDFFDataset, is_train=False, key_interval=2)
        tmp = jit_init(model, key, one, method=model.make_key)["params"]
        carry = model.apply({"params": tmp}, one, method=model.make_key)
        params = dict(tmp, **{k: v for k, v in jit_init(
            model, key, carry, one, method=model.detect_non_key)["params"].items()
            if k not in tmp})
    else:
        if method == "rdn":
            v = VidConfig(method="rdn", base_stage=2, advanced_stage=1,
                          all_frame_interval=3, key_frame_location=1)
            model, cls = GeneralizedRCNNRDN(c=ENGINE_C, v=v), VIDRDNDataset
        else:
            v = VidConfig(method="fgfa", all_frame_interval=3, key_frame_location=1)
            model, cls = GeneralizedRCNNFGFA(c=ENGINE_C, v=v), VIDFGFADataset
        ds = _dataset(tiny_root, cls, is_train=False, max_offset=1)
        tmp = jit_init(model, key, one, method=model.precompute)["params"]
        entry = model.apply({"params": tmp}, one, method=model.precompute)
        carry = model.apply({"params": tmp}, entry, one.sizes[0], method=model.init_carry)
        params = jit_init(model, key, carry, one, method=model.test_step)["params"]
    params = off_relu_corner(_perturb(to_np(params), np.random.RandomState(1)))
    return model, ds, params


@pytest.mark.parametrize("method", ["rdn", "fgfa", "dff"])
def test_compute_on_dataset_methods_match_jax(tiny_root, method):
    """RDN (packed frames, the advanced stage), FGFA and DFF (key interval 2,
    so both steps and the alignment padding run) through the lockstep
    engine with 2 lanes, against the JAX package's on the same videos."""
    from mega_pytorch_tpu_torch.models import detectors

    model, ds, params = _method_setup(method, tiny_root)
    prep = EvalPreprocessor(**_prep_kwargs())
    indices = list(range(len(ds)))
    want = jax_compute_on_dataset(model, params, ds, indices, prep, method, lanes=2)
    cls = {"rdn": detectors.GeneralizedRCNNRDN, "fgfa": detectors.GeneralizedRCNNFGFA,
           "dff": detectors.GeneralizedRCNNDFF}[method]
    port = port_model_from(cls, params, *port_configs(ENGINE_C, model.v))
    port_ds = port_dataset(tiny_root, type(ds).__name__,
                           **(dict(key_interval=2) if method == "dff" else dict(max_offset=1)))
    got = compute_on_dataset(port, port_ds, indices, PortEvalPreprocessor(**_prep_kwargs()),
                             method, lanes=2)
    _assert_predictions_match(got, want, indices)


class _Prep:
    """Preprocessor stand-in: the frame is already its canvas."""

    class Out:
        def __init__(self, image):
            self.image = image
            self.size = np.array(image.shape[:2], np.float32)

    def _prep_u8(self, img, flip):
        assert not flip
        return self.Out(img)


class _Videos:
    """In-memory dataset stand-in with the duck-typed API the engines read:
    video v has ``lengths[v]`` frames; frame f of it is a constant image of
    value 10 * v + f; global refs follow a fixed per-video permutation."""

    def __init__(self, lengths, global_size=2, shape=(8, 12), bad_frame=None):
        self.image_set_index, self.pattern, self.frame_seg_len = [], [], []
        self.start = []
        for v, n in enumerate(lengths):
            for f in range(n):
                self.image_set_index.append(f"v{v}/{f:06d}")
                self.pattern.append(f"v{v}/%06d")
                self.frame_seg_len.append(n)
                self.start.append(len(self.image_set_index) - 1 - f)
        self.global_size = global_size
        self.perm = {v: np.random.RandomState(v).permutation(n)
                     for v, n in enumerate(lengths)}
        self.shape, self.bad_frame = shape, bad_frame

    def load_frame(self, pattern, fid):
        if fid == self.bad_frame:
            raise OSError(f"corrupt frame {fid}")
        v = int(pattern[1:pattern.index("/")])
        return np.full((*self.shape, 3), 10 * v + fid, np.uint8)

    def global_ref_ids(self, idx):
        v = int(self.pattern[idx][1:self.pattern[idx].index("/")])
        f = idx - self.start[idx]
        count = self.global_size if f == 0 else 1
        return [int(self.perm[v][(f + j) % self.frame_seg_len[idx]])
                for j in range(count)]

    def get_img_info(self, idx):
        return {"height": self.shape[0] + idx, "width": self.shape[1]}


@pytest.mark.parametrize("part", ["partition", "split_videos", "lane_feed"])
def test_host_schedule_matches_jax(part):
    lengths = [5, 1, 9, 3, 3, 7, 2]
    ds = _Videos(lengths)
    videos = engine.split_videos(ds, range(len(ds.image_set_index)))
    if part == "split_videos":
        assert videos == jax_engine.split_videos(ds, range(len(ds.image_set_index)))
        assert [len(v) for v in videos] == lengths
    elif part == "partition":
        for lanes in (1, 3, 4, 12):
            assert engine._partition(videos, lanes, 2) == jax_engine._partition(
                videos, lanes, 2)
    else:
        bins, steps = engine._partition(videos, 3, 2)
        for pack in (0, 4):
            for b in bins:
                got = iter(engine._LaneFeed(ds, _Prep(), b, 2, pack=pack))
                want = iter(jax_engine._LaneFeed(ds, _Prep(), b, 2, True, pack=pack))
                for s in range(steps + 3):  # into the idle tail
                    g, w = next(got), next(want)
                    assert g.keys() == w.keys()
                    for key in g:
                        np.testing.assert_array_equal(g[key], w[key],
                                                      err_msg=f"{key} step {s}")


@pytest.mark.parametrize("part", ["partition_dff", "dff_lane_feed", "lane_feed_no_global"])
def test_method_host_schedule_matches_jax(part):
    """DFF's aligned partition and lane feed (key interval 3, so videos
    start on steps 0, 3, 6, ...), and the lane feed of RDN and FGFA, which
    reads no global refs."""
    lengths = [5, 1, 9, 3, 3, 7, 2]
    ds = _Videos(lengths)
    videos = engine.split_videos(ds, range(len(ds.image_set_index)))
    if part == "partition_dff":
        for lanes in (1, 3, 4, 12):
            assert engine._partition_dff(videos, lanes, 3) == jax_engine._partition_dff(
                videos, lanes, 3)
        return
    if part == "dff_lane_feed":
        bins, steps = engine._partition_dff(videos, 3, 3)
        feeds = [(iter(engine._DFFLaneFeed(ds, _Prep(), b, 3)),
                  iter(jax_engine._DFFLaneFeed(ds, _Prep(), b, 3))) for b in bins]
    else:
        ds.global_ref_ids = None  # never read
        bins, steps = engine._partition(videos, 3, 2)
        feeds = [(iter(engine._LaneFeed(ds, _Prep(), b, 2, False, 4)),
                  iter(jax_engine._LaneFeed(ds, _Prep(), b, 2, False, pack=4)))
                 for b in bins]
    for got, want in feeds:
        for s in range(steps + 3):  # into the idle tail
            g, w = next(got), next(want)
            assert g.keys() == w.keys()
            for key in g:
                np.testing.assert_array_equal(g[key], w[key], err_msg=f"{key} step {s}")


def test_empty_refs_give_zeros_per_lane():
    """One lane has no valid ref: it gives zeros (plus the value bias) while
    the other lane attends, as the JAX module does per lane under vmap. A
    test of ``any`` over the whole call would give lane 1 a uniform softmax."""
    rs = np.random.RandomState(8)
    lanes, n, m = 2, 6, 11
    x = rs.randn(lanes, n, 1024).astype(np.float32)
    refs = rs.randn(lanes, m, 1024).astype(np.float32)
    valid = rs.rand(lanes, m) > 0.3
    valid[1] = False
    jmod = JaxRelationAttention(use_position=False, use_u_bias=True)
    params = to_np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x[0]),
                             jnp.asarray(refs[0]), jnp.asarray(valid[0]))["params"])
    params["Wv_kernel"] = params["Wv_kernel"] * 3
    params["Wv_bias"] = rs.randn(1024).astype(np.float32)
    port = RelationAttention(use_position=False)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x), torch.from_numpy(refs),
                          torch.from_numpy(valid)).numpy()
    want = np.asarray(jax.vmap(lambda a, b, c: jmod.apply({"params": params}, a, b, c))(
        jnp.asarray(x), jnp.asarray(refs), jnp.asarray(valid)))
    np.testing.assert_array_equal(got[1], np.broadcast_to(params["Wv_bias"], (n, 1024)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got[0] - params["Wv_bias"]).max() > 1e-2  # lane 0 attends


@pytest.mark.parametrize("where", ["feed", "step"])
def test_lockstep_raises_and_stops_its_threads(where, monkeypatch):
    """A frame that fails to load in the producer thread, or a step that
    fails on the device side, raises in the caller and leaves no thread
    behind (the queue holds one batch, so a producer that runs ahead is
    blocked on it when the consumer stops)."""
    _, params = tiny_mega()
    port = port_mega_from(params)
    ds = _Videos([4, 6, 5], shape=CANVAS, bad_frame=4 if where == "feed" else None)
    if where == "step":
        calls = []

        def failing_detect(carry):
            calls.append(1)
            if len(calls) == 3:
                raise OSError("corrupt frame 4")  # stands in for a device fault
            return type(port).detect_key(port, carry)

        monkeypatch.setattr(port, "detect_key", failing_detect)
    before = set(threading.enumerate())
    with pytest.raises(OSError, match="corrupt frame 4"):
        engine.compute_on_dataset_lockstep(port, ds, range(len(ds.image_set_index)),
                                           _Prep(), lanes=2, prefetch_depth=1)
    assert set(threading.enumerate()) <= before
