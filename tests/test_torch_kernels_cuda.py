"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case needs a CUDA card and skips without one. The file imports no JAX,
so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from mega_pytorch_tpu_torch.ops.kernels import position_bias as pb
from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp

torch.set_num_threads(2)

ATOL_NONE, ATOL_POS = 6e-3, 2e-2  # bf16 operands; f32-sinusoid plain version
# mode "none" against its flat plain version at MEGA's 12-lane step: 417,600
# rows of (2175, 750) reach further into the tail of the flat version's
# rounding of p / l (the kernel rounds p) than one lane's rows do; on an
# H100 ten draws read 4.6e-3 to 6.1e-3 there (one lane 3.1e-3 to 5.3e-3),
# against the tiled version 1.1e-3 at most
ATOL_NONE_12_LANES = 1e-2
# mode "compute" against its tiled plain version: the mean error, beside
# the largest (_pos_tiled_atol)
MEAN_POS_TILED = 5e-5
# the standalone bias in weight space (exp of the log), as tests/test_attention.py
RTOL_BIAS, ATOL_BIAS = 5e-3, 6e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _attention(dev, seed, b=2, n=37, m=300, canvas=False):
    """Attention operands; the boxes near the origin, or with ``canvas``
    of 16-316 pixels anywhere on the flagship's canvas, as the path's
    proposals are (the range of the kernel's sinusoid and log arguments)."""
    rs = np.random.RandomState(seed)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    def boxes(count):
        if canvas:
            return t(_flagship_boxes(rs, b * count).reshape(b, count, 4))
        return t(np.abs(rs.randn(b, count, 4)) * 50 + np.array([0, 0, 60, 60]))

    bf = torch.bfloat16
    q = t(rs.randn(b, 16, n, 64), bf)
    k = t(rs.randn(b, 16, m, 64), bf)
    v = t(rs.randn(b, 16, m, 64), bf)
    uk = t(rs.randn(b, 16, m) * 8)  # the scale of q.k
    rois, refs = boxes(n), boxes(m)
    wk = t(rs.randn(64, 16) * 0.05)
    wb = t(rs.rand(16) * 0.1)
    valid = t(rs.rand(b, m) > 0.2, torch.bool)
    return q, k, v, uk, rois, refs, wk, wb, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
# a small map, then the path's launches on packed 608x1024 frames: one MEGA
# lane's key and global frame, RDN's 4 lanes, MEGA's 12 lanes
@pytest.mark.parametrize("n,t,u", [(2, 19, 33), (2, 152, 256), (4, 152, 256), (24, 152, 256)])
def test_stem_pool_kernel_exact(cuda, n, t, u, dtype):
    rs = np.random.RandomState(5)
    o = 64
    y = torch.from_numpy(rs.randn(n, t, u, 4 * o).astype(np.float32) * 2)
    y = y.to(cuda, getattr(torch, dtype))
    scale = torch.from_numpy((rs.rand(4 * o) + 0.5).astype(np.float32)).to(cuda)
    shift = torch.from_numpy(rs.randn(4 * o).astype(np.float32)).to(cuda)
    before = sp.stem_pool_packed.launches
    got = sp.stem_pool_packed(y, scale, shift, o)
    assert sp.stem_pool_packed.launches == before + 1
    assert torch.equal(got, sp.stem_pool_packed_reference(y, scale, shift, o))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
# (strips, frames a strip, rows, columns): small maps, then MEGA's 12-lane
# step's 24 packed 608x1024 frames in one strip
@pytest.mark.parametrize("n,frames,rows,cols", [(2, 3, 8, 33), (2, 5, 37, 33), (2, 2, 1, 33),
                                                (1, 24, 152, 256)])
def test_stem_pool_kernel_folded_exact(cuda, dtype, n, frames, rows, cols):
    """The folded layout (frames stacked along T at stride rows + 1, random
    junk in the seam rows) against its plain version and, frame by frame,
    against the unfolded kernel, bit for bit; frame_rows = T is the
    unfolded layout."""
    rs = np.random.RandomState(6)
    o, s = 64, rows + 1
    y = torch.from_numpy(rs.randn(n, frames * s, cols, 4 * o).astype(np.float32) * 2)
    y = y.to(cuda, getattr(torch, dtype))
    scale = torch.from_numpy((rs.rand(4 * o) + 0.5).astype(np.float32)).to(cuda)
    shift = torch.from_numpy(rs.randn(4 * o).astype(np.float32)).to(cuda)
    got = sp.stem_pool_packed(y, scale, shift, o, frame_rows=s)
    assert torch.equal(got, sp.stem_pool_packed_reference(y, scale, shift, o, frame_rows=s))
    for i in range(frames):
        alone = sp.stem_pool_packed(y[:, i * s:i * s + rows].contiguous(), scale, shift, o)
        assert torch.equal(got[:, i * s:i * s + rows], alone)
    assert torch.equal(sp.stem_pool_packed(y, scale, shift, o, frame_rows=frames * s),
                       sp.stem_pool_packed(y, scale, shift, o))


@pytest.mark.cuda
def test_stem_pool_kernel_rejects_a_strided_input(cuda):
    y = torch.zeros(1, 4, 4, 256, device=cuda).permute(0, 2, 1, 3)
    s = torch.ones(256, device=cuda)
    with pytest.raises(ValueError):
        sp.stem_pool_packed(y, s, s, 64)


# every (N, M) of MEGA's step: the global enhancement (2175, 750) and
# residual (300, 750), "none"; the local stages 0-2 (675, 3750), (675, 750),
# (300, 750), "compute"
MEGA_STEP = [("none", 2175, 750), ("none", 300, 750), ("compute", 675, 3750),
             ("compute", 675, 750), ("compute", 300, 750)]


@pytest.mark.cuda
# (lanes, N, M): small shapes, then MEGA's step's shapes at one lane
@pytest.mark.parametrize("b,n,m", [(2, 37, 300), (2, 16, 64), (2, 675, 750)]
                         + [(1, n, m) for _, n, m in MEGA_STEP[:4]])
@pytest.mark.parametrize("pos", [False, True])
def test_attention_kernel_matches_plain(cuda, pos, b, n, m):
    # MEGA's step's shapes (the one-lane cases) with the path's boxes
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 4, b=b, n=n, m=m, canvas=b == 1)
    if pos:
        before = ra.flash_relation_attention_pos.launches
        got = ra.flash_relation_attention_pos(q, k, v, uk, rois, refs, wk, wb, valid)
        want = ra.reference_relation_attention_pos(q, k, v, uk, rois, refs, wk, wb,
                                                   valid)
        assert ra.flash_relation_attention_pos.launches == before + 1
        tiled = ra.reference_relation_attention_pos_tiled(q, k, v, uk, rois, refs, wk, wb,
                                                          valid)
        _assert_pos_tiled(got, tiled, v)
        tol = ATOL_POS
    else:
        before = ra.flash_relation_attention.launches
        got = ra.flash_relation_attention(q, k, v, uk, valid)
        want = ra.reference_relation_attention(q, k, v, uk, None, valid)
        assert ra.flash_relation_attention.launches == before + 1
        tol = ATOL_NONE
    assert got.shape == (b, 16, n, 64) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_attention_kernel_lanes_and_empty_refs(cuda):
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 6)
    two = ra.flash_relation_attention_pos(q, k, v, uk, rois, refs, wk, wb, valid)
    one = ra.flash_relation_attention_pos(q[1:], k[1:], v[1:], uk[1:], rois[1:],
                                          refs[1:], wk, wb, valid[1:])
    assert torch.equal(two[1:], one)
    none = torch.zeros_like(valid)
    assert float(ra.flash_relation_attention(q, k, v, uk, none).abs().max()) == 0.0
    assert float(ra.flash_relation_attention_pos(
        q, k, v, uk, rois, refs, wk, wb, none).abs().max()) == 0.0
    with pytest.raises(ValueError):  # operands must already be bf16
        ra.flash_relation_attention(q.float(), k, v, uk, valid)


def _log_bias(dev, seed, b, n, m):
    """A (B, 16, N, M) log bias in the range relu(.) + 1e-6 gives."""
    rs = np.random.RandomState(seed)
    pw = np.maximum(rs.randn(b, 16, n, m) * 0.5 + 0.3, 0.0) + 1e-6
    return torch.from_numpy(np.log(pw).astype(np.float32)).to(dev)


@pytest.mark.cuda
# small shapes, then MEGA's local stage 0 at one lane and 12 (a 162 MB and a
# 1.94 GB bias), where RelationAttention(pos_emb=...) would run it
@pytest.mark.parametrize("b,n,m", [(2, 37, 300), (2, 16, 64), (2, 675, 750), (1, 675, 3750),
                                   (12, 675, 3750)])
def test_attention_input_bias_kernel_matches_plain(cuda, b, n, m):
    q, k, v, uk, _, _, _, _, valid = _attention(cuda, 7, b=b, n=n, m=m)
    bias = _log_bias(cuda, 8, b, n, m)
    before = ra.flash_relation_attention_bias.launches
    got = ra.flash_relation_attention_bias(q, k, v, uk, bias, valid)
    assert ra.flash_relation_attention_bias.launches == before + 1
    want = ra.reference_relation_attention(q, k, v, uk, bias, valid)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= ATOL_NONE
    none = torch.zeros_like(valid)
    assert float(ra.flash_relation_attention_bias(q, k, v, uk, bias, none)
                 .abs().max()) == 0.0
    with pytest.raises(ValueError):  # the bias must be (B, g, N, M)
        ra.flash_relation_attention_bias(q, k, v, uk, bias[:, :, :, :-1], valid)


def _tensor_core_mode(mode, q, k, v, uk, bias, valid, pos=None):
    """Mode "none", "input" or "compute" (pos: rois, refs, wk, wb) of the
    kernel, counted as one launch."""
    if mode == "none":
        wrapper, args = ra.flash_relation_attention, (q, k, v, uk, valid)
    elif mode == "compute":
        wrapper, args = ra.flash_relation_attention_pos, (q, k, v, uk, *pos, valid)
    else:
        wrapper, args = ra.flash_relation_attention_bias, (q, k, v, uk, bias, valid)
    before = wrapper.launches
    got = wrapper(*args)
    assert wrapper.launches == before + 1
    return got


def _rounding_bound(v):
    """How far two roundings of p to bf16 (unit roundoff 2^-8 each) can move
    a row of p.v / l: 2^-7 max|v|. The flat plain version rounds p / l where
    the kernel rounds p (the Pallas kernel and the flat version differ by up
    to 8.8e-3 where a few refs carry a row, on the CPU)."""
    return 2.0 ** -7 * float(v.float().abs().max())


def _pos_tiled_atol(v):
    """Mode "compute" against its tiled plain version: pw differs in its last
    f32 bits (the hardware sine and log, sums in another order), which can
    move a p * pw across a bf16 rounding boundary, one step of up to 2^-7
    relative; for a ref that carries a row that is the rounding bound
    (0.0174 seen on the card at M=1)."""
    return max(ATOL_NONE, _rounding_bound(v))


def _assert_pos_tiled(got, tiled, v):
    """Mode "compute" against its tiled plain version: the largest error
    within _pos_tiled_atol, the mean within MEAN_POS_TILED (the rounding
    steps that the largest allows are rare)."""
    diff = (got - tiled).abs()
    assert float(diff.max()) <= _pos_tiled_atol(v)
    assert float(diff.mean()) <= MEAN_POS_TILED


def _assert_matches_plain(got, q, k, v, uk, bias, valid, atol_tiled=ATOL_NONE, pos=None,
                          atol_flat=None):
    """Within atol_tiled of the tiled plain version, which rounds p (p * pw
    in mode "compute", held by _assert_pos_tiled) where the kernel (and the
    Pallas kernel) does, and within atol_flat, or else the rounding bound,
    of the flat one (ATOL_POS at least in mode "compute")."""
    if pos is None:
        tiled = ra.reference_relation_attention_tiled(q, k, v, uk, bias, valid)
        flat = ra.reference_relation_attention(q, k, v, uk, bias, valid)
        assert float((got - tiled).abs().max()) <= atol_tiled
    else:
        tiled = ra.reference_relation_attention_pos_tiled(q, k, v, uk, *pos, valid)
        flat = ra.reference_relation_attention_pos(q, k, v, uk, *pos, valid)
        _assert_pos_tiled(got, tiled, v)
    floor = ATOL_NONE if pos is None else ATOL_POS
    bound = max(floor, _rounding_bound(v)) if atol_flat is None else atol_flat
    assert float((got - flat).abs().max()) <= bound


def _pos(rois, refs, wk, wb):
    """The position operands with Wg's bias raised by 2, so that pw stays
    well above its relu floor (the Wg sums here are ~0.3 wide), for the
    cases where a handful of refs carry a row: M of 1-63, invalid leading
    tiles, logits x 4. The kernel takes dw/dh as fp16 S . T, up to 4e-4
    from the flat version's f32 sinusoids of log(w / w') and a few f32 bits
    from the tiled version's fp16 rounding of S and T; where pw sits near
    its floor of 1e-6, such a difference scales a ref's weight many times.
    With the raw bias the two plain versions differ by up to 2.2 at M=5
    (0.48 with logits x 4), and the kernel differs from its tiled plain
    version by up to 0.64 (seen on the CPU and the card): the function, not
    the kernel, is ill-conditioned there. test_attention_kernel_matches_plain,
    at the flagship's shapes among others, keeps the raw bias, relu floor
    included."""
    return rois, refs, wk, wb + 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 63, 750, 3750])
@pytest.mark.parametrize("n", [1, 63, 65, 675, 2175])
@pytest.mark.parametrize("mode", ["none", "input", "compute"])
def test_attention_tensor_core_modes_ragged(cuda, mode, n, m):
    """Row tiles of 64 and ref tiles of 64 cut ragged on both axes; odd M
    puts every other bias row off an 8-byte boundary."""
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 12, n=n, m=m)
    valid[:, 0] = True  # a valid ref in every lane, even at M=1
    bias = _log_bias(cuda, 13, 2, n, m) if mode == "input" else None
    pos = _pos(rois, refs, wk, wb) if mode == "compute" else None
    got = _tensor_core_mode(mode, q, k, v, uk, bias, valid, pos)
    assert got.shape == (2, 16, n, 64) and torch.isfinite(got).all()
    _assert_matches_plain(got, q, k, v, uk, bias, valid, pos=pos)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n,m", MEGA_STEP)
def test_attention_at_mega_step_12_lanes(cuda, mode, n, m):
    """Each attention call of MEGA's 12-lane step, Wg's raw bias and the
    path's boxes: one launch, finite, within ATOL_NONE of the tiled plain
    version ("compute": its bounds) and within ATOL_POS ("compute") or
    ATOL_NONE_12_LANES ("none") of the flat one."""
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 4, b=12, n=n, m=m, canvas=True)
    pos = (rois, refs, wk, wb) if mode == "compute" else None
    got = _tensor_core_mode(mode, q, k, v, uk, None, valid, pos)
    assert got.shape == (12, 16, n, 64) and torch.isfinite(got).all()
    _assert_matches_plain(got, q, k, v, uk, None, valid, pos=pos,
                          atol_flat=ATOL_POS if pos else ATOL_NONE_12_LANES)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "input", "compute"])
def test_attention_recovers_from_invalid_leading_tiles(cuda, mode):
    """The first two 64-ref tiles all invalid: the running max starts at
    -1e30 and must give way to the first valid tile's."""
    n, m = 100, 300
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 14, n=n, m=m)
    valid[:, :128] = False
    valid[1, :290] = False  # lane 1: only the ragged last tile has valid refs
    bias = _log_bias(cuda, 15, 2, n, m) if mode == "input" else None
    pos = _pos(rois, refs, wk, wb) if mode == "compute" else None
    got = _tensor_core_mode(mode, q, k, v, uk, bias, valid, pos)
    _assert_matches_plain(got, q, k, v, uk, bias, valid, pos=pos)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "input", "compute"])
def test_attention_large_logits_rescale(cuda, mode):
    """q and k scaled by 4: logits spread over tens of units, so the running
    max moves between tiles and a missing alpha rescale shows. A few refs
    carry each row, and q.k summed in another order can round a dominant p
    to the other neighbouring bf16 value than the tiled plain version does
    (6.5e-3 seen on the card), so both comparisons take the rounding bound."""
    n, m = 100, 750
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 16, n=n, m=m)
    q = (q.float() * 4).to(torch.bfloat16)
    k = (k.float() * 4).to(torch.bfloat16)
    bias = _log_bias(cuda, 17, 2, n, m) if mode == "input" else None
    pos = _pos(rois, refs, wk, wb) if mode == "compute" else None
    got = _tensor_core_mode(mode, q, k, v, uk, bias, valid, pos)
    _assert_matches_plain(got, q, k, v, uk, bias, valid,
                          atol_tiled=max(ATOL_NONE, _rounding_bound(v)), pos=pos)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "input", "compute"])
def test_attention_kernels_reject_misaligned_operands(cuda, mode):
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 18)
    bias = _log_bias(cuda, 19, 2, q.shape[2], k.shape[2])
    pos = (rois, refs, wk, wb)
    qm = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    qm.copy_(q)
    assert qm.storage_offset() == 1 and qm.is_contiguous()
    with pytest.raises(ValueError, match="16-byte"):
        _tensor_core_mode(mode, qm, k, v, uk, bias, valid, pos)
    if mode == "input":
        bm = torch.empty(bias.numel() + 1, device=cuda)[1:].view(bias.shape)
        bm.copy_(bias)
        with pytest.raises(ValueError, match="8-byte"):
            _tensor_core_mode(mode, q, k, v, uk, bm, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(37, 300), (675, 3750), (1, 5)])
def test_position_bias_kernel_matches_plain(cuda, n, m):
    *_, rois, refs, wk, wb, _ = _attention(cuda, 9, b=1, n=n, m=m)
    rois, refs = rois[0].contiguous(), refs[0].contiguous()
    before = pb.fused_position_bias.launches
    got = pb.fused_position_bias(rois, refs, wk, wb)
    assert pb.fused_position_bias.launches == before + 1
    want = pb.reference_position_bias(rois, refs, wk, wb, 64, sin_dtype=torch.float32)
    assert got.shape == (16, n, m) and got.dtype == torch.float32
    torch.testing.assert_close(got.exp(), want.exp(), rtol=RTOL_BIAS, atol=ATOL_BIAS)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "compute", "input"])
# a small shape, MEGA's residual and stage 2 at 12 lanes, stage 1 at 2
@pytest.mark.parametrize("lanes,n,m", [(12, 40, 200), (12, 300, 750), (2, 675, 750)])
def test_attention_kernel_lanes_are_independent(cuda, mode, lanes, n, m):
    """Every lane of a B-lane call equals the B=1 call on that lane's data,
    and the lane with no valid ref gives zeros."""
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 10, b=lanes, n=n, m=m)
    empty = min(3, lanes - 1)
    valid[empty] = False  # one lane with no valid ref
    bias = _log_bias(cuda, 11, lanes, n, m)

    def call(sl):
        def t(x):
            return x[sl].contiguous()
        if mode == "none":
            return ra.flash_relation_attention(t(q), t(k), t(v), t(uk), t(valid))
        if mode == "compute":
            return ra.flash_relation_attention_pos(t(q), t(k), t(v), t(uk), t(rois),
                                                   t(refs), wk, wb, t(valid))
        return ra.flash_relation_attention_bias(t(q), t(k), t(v), t(uk), t(bias),
                                                t(valid))

    batched = call(slice(None))
    for lane in range(lanes):
        assert torch.equal(batched[lane:lane + 1], call(slice(lane, lane + 1))), lane
    assert float(batched[empty].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("n,m", [(300, 2775), (555, 2775), (300, 555)])
def test_attention_compute_at_rdn_shapes_without_u(cuda, n, m, lanes):
    """Mode "compute" at RDN's shapes (base stages, advanced stage, final
    stage) with uk = 0, RDN's attention having no u bias: the last 64-row
    tile holds 43 rows at N=555 and the last ref tile 23 refs at M=2775, and
    invalid refs mask by ``valid`` alone (a zero uk, not -inf). Wg keeps its
    raw bias, as test_attention_kernel_matches_plain, and the flat plain
    version's tolerance is ATOL_POS, as there. Each lane equals its B=1
    call, and a lane with no valid ref gives zeros."""
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 20, b=lanes, n=n, m=m, canvas=True)
    uk = torch.zeros_like(uk)
    valid[1, -23:] = False  # the ragged last ref tile, all invalid in lane 1
    pos = (rois, refs, wk, wb)
    got = _tensor_core_mode("compute", q, k, v, uk, None, valid, pos)
    assert got.shape == (lanes, 16, n, 64) and torch.isfinite(got).all()
    _assert_matches_plain(got, q, k, v, uk, None, valid, pos=pos, atol_flat=ATOL_POS)
    for lane in range(lanes):
        sl = slice(lane, lane + 1)
        one = ra.flash_relation_attention_pos(
            *(t[sl].contiguous() for t in (q, k, v, uk, rois, refs)), wk, wb,
            valid[sl].contiguous())
        assert torch.equal(got[sl], one), lane
    none = torch.zeros_like(valid)
    assert float(ra.flash_relation_attention_pos(q, k, v, uk, *pos, none).abs().max()) == 0.0


def _stem_inputs(dev, seed, n, t, u, dtype, o=64):
    rs = np.random.RandomState(seed)
    y = torch.from_numpy(rs.randn(n, t, u, 4 * o).astype(np.float32) * 2)
    scale = torch.from_numpy((rs.rand(4 * o) + 0.5).astype(np.float32)).to(dev)
    shift = torch.from_numpy(rs.randn(4 * o).astype(np.float32)).to(dev)
    return y, scale, shift


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 3, 24])
def test_stem_pool_kernel_exact_ragged_tiles(cuda, n, dtype):
    """T = 37 and U = 65 cut the row strips and the 31-column tiles ragged
    (tiles of 31, 31 and 3 columns), at 1, 3 and 24 frames, whose grids cut
    the rows into strips of different lengths."""
    y, scale, shift = _stem_inputs(cuda, 21 + n, n, 37, 65, dtype)
    y = y.to(cuda, getattr(torch, dtype))
    got = sp.stem_pool_packed(y, scale, shift, 64)
    assert torch.equal(got, sp.stem_pool_packed_reference(y, scale, shift, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n", [1, 3, 24])
def test_stem_pool_kernel_maxima_on_the_seams(cuda, n, dtype):
    """Every output's maximum sits at its upper-left corner input, phase
    (a'=1, b'=1) of cell (t - 1, u - 1): at a strip's first row that is the
    row above the strip, at a tile's first column the halo column, so a
    halo that is wrong or stale shows in every strip and tile."""
    t, u = 45, 96
    y, scale, shift = _stem_inputs(cuda, 31 + n, n, t, u, dtype)
    ramp = 300.0 - 2.0 * (torch.arange(t)[:, None] + torch.arange(u)[None, :]).float()
    y = y * 0.01
    y[..., 3 * 64:] += ramp[None, :, :, None]  # phase 3 falls along t and u
    y = y.to(cuda, getattr(torch, dtype))
    got = sp.stem_pool_packed(y, scale, shift, 64)
    want = sp.stem_pool_packed_reference(y, scale, shift, 64)
    assert torch.equal(got, want)
    corner = (y[..., 3 * 64:].float() * scale[3 * 64:] + shift[3 * 64:]).clamp_min(0.0)
    assert torch.equal(want[:, 1:, 1:], corner[:, :-1, :-1].to(y.dtype))


@pytest.mark.cuda
def test_s2d2_stem_launches_no_stem_pool(cuda):
    """12-channel frames take the 4x4/1 reformulation and the plain maxpool,
    as the JAX package does, and match the canonical branch."""
    from mega_pytorch_tpu_torch.models.backbone.resnet import Stem

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(cuda).manual_seed(3)
    stem = Stem(64, torch.float32, cuda)
    stem.init_weights(gen)
    stem.eval().requires_grad_(False)
    rs = np.random.RandomState(22)
    x3 = torch.from_numpy((rs.randn(2, 50, 66, 3) * 50).astype(np.float32))
    x12 = x3.reshape(2, 25, 2, 33, 2, 3).permute(0, 1, 3, 2, 4, 5).reshape(2, 25, 33, 12)
    before = sp.stem_pool_packed.launches
    with torch.inference_mode():
        got = stem(x12.to(cuda))
        want = stem(x3.to(cuda))
    assert sp.stem_pool_packed.launches == before
    assert got.shape == want.shape == (2, 64, 13, 17)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _flagship_boxes(rs, count, canvas=(608, 1024)):
    """Boxes of 16-316 pixels anywhere on the canvas."""
    ctr = rs.rand(count, 2) * np.array([canvas[1], canvas[0]])
    wh = 16 + rs.rand(count, 2) * 300
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("floor", [False, True])
@pytest.mark.parametrize("m", [5, 300, 3750])
@pytest.mark.parametrize("n", [1, 37, 675])
def test_position_bias_kernel_ragged_and_far(cuda, n, m, floor):
    """Row blocks of 16 and ref blocks of 128 cut ragged on both axes; refs
    that repeat rois (dx = dy = log 1e-3, arguments of -690 rad at the
    frequency 100) and boxes across the flagship canvas (dx up to log 60,
    dw up to log 20); with ``floor`` Wg's bias at -0.1, which leaves pw at
    its relu floor for about half the pairs."""
    rs = np.random.RandomState(40 + n + m)
    rois = _flagship_boxes(rs, n)
    refs = _flagship_boxes(rs, m)
    k = min(n, m)
    refs[:k] = rois[:k]
    wk = (rs.randn(64, 16) * 0.05).astype(np.float32)
    wb = np.full(16, -0.1, np.float32) if floor else (rs.rand(16) * 0.1).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda) for a in (rois, refs, wk, wb)]
    before = pb.fused_position_bias.launches
    got = pb.fused_position_bias(*args)
    assert pb.fused_position_bias.launches == before + 1
    want = pb.reference_position_bias(*args, 64, sin_dtype=torch.float32)
    assert got.shape == (16, n, m) and torch.isfinite(got).all()
    torch.testing.assert_close(got.exp(), want.exp(), rtol=RTOL_BIAS, atol=ATOL_BIAS)
    if floor:
        assert float((want.exp() <= 2e-6).float().mean()) > 0.2


# the (N, M) of each attention call of one MEGA R-101 training iteration
# (ROI batch 128; 75 refs a frame, 15 distilled; cur + 2 local, 3 memory
# and 2 global frames): "none" for the global enhancement of the memory
# pool, of the key ROIs with the local refs, and the residual stage;
# "input" for the memory pool's two self-enhancement stages and the three
# local stages; then RDN R-101's (ROI batch 128, cur + 2 refs of 75, 15 of
# each distilled): the base stages (128, 225) and the final stage (128, 45),
# its advanced stage (45, 225) sharing the memory pool's first shape
TRAIN_SHAPES = {"none": [(225, 150), (353, 150), (128, 150)],
                "input": [(45, 225), (45, 45), (173, 450), (173, 90), (128, 90),
                          (128, 225), (128, 45)]}


def _train_operands(dev, mode, n, m, seed):
    """Two lanes: lane 0 with ragged valid refs, lane 1 with none; the
    attention operands require grad (the log bias of mode "input" with
    about a quarter of its pairs at the relu floor)."""
    q, k, v, uk, _, _, _, _, valid = _attention(dev, seed, n=n, m=m)
    valid[1] = False
    ops = [q, k, v, uk] + ([_log_bias(dev, seed + 1, 2, n, m)] if mode == "input" else [])
    return [t.requires_grad_() for t in ops], valid


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n,m", [(mode, n, m) for mode, shapes in TRAIN_SHAPES.items()
                                      for n, m in shapes])
def test_train_functions_at_train_shapes(cuda, mode, n, m):
    """Each Function launches its kernel once (forward within tolerance of
    the plain versions, zeros on the lane with no valid ref) and its
    gradients equal torch.autograd.grad through the plain version on the
    same operands bit for bit, each in its operand's dtype."""
    ops, valid = _train_operands(cuda, mode, n, m, 60 + n + m)
    wrapper = ra.flash_relation_attention if mode == "none" else ra.flash_relation_attention_bias
    before = wrapper.launches
    bias_op = ops[4] if mode == "input" else None
    out = ra.RelationAttentionFunction.apply(*ops[:4], bias_op, valid, wrapper)
    assert wrapper.launches == before + 1
    bias = ops[4].detach() if mode == "input" else None
    _assert_matches_plain(out.detach(), *(t.detach() for t in ops[:4]), bias, valid)
    assert float(out[1].abs().max()) == 0.0
    cot = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(n), device=cuda)
    got = torch.autograd.grad(out, ops, cot)
    assert wrapper.launches == before + 1  # the backward launches nothing
    plain = ra.reference_relation_attention(*ops[:4], ops[4] if mode == "input" else None,
                                            valid)
    want = torch.autograd.grad(plain, ops, cot)
    for name, op, g, w in zip(("q", "k", "v", "uk", "bias"), ops, got, want):
        assert g.dtype == op.dtype and torch.equal(g, w), name
        assert torch.isfinite(g).all(), name


@pytest.mark.cuda
def test_relation_attention_under_grad_takes_the_functions(cuda):
    """RelationAttention on the card under grad: precise_bias launches mode
    "input" and gives Wg a gradient, the global stage launches "none";
    without precise_bias the in-kernel bias launches mode "compute" through
    its Function, which gives Wg a gradient too."""
    from mega_pytorch_tpu_torch.models.roi_heads.attention import RelationAttention

    gen = torch.Generator(cuda).manual_seed(3)
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 11, b=1, n=45, m=90)
    roi = torch.randn(1, 45, 1024, generator=gen, device=cuda)
    ref = torch.randn(1, 90, 1024, generator=gen, device=cuda)
    for use_position, wrapper in ((True, ra.flash_relation_attention_bias),
                                  (False, ra.flash_relation_attention)):
        att = RelationAttention(1024, 64, 16, use_position, torch.bfloat16, cuda)
        for m in att.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
        before = wrapper.launches
        pos = (rois, refs) if use_position else None
        out = att(roi, ref, valid, pos_rois=pos, precise_bias=True)
        assert wrapper.launches == before + 1
        out.square().sum().backward()
        assert wrapper.launches == before + 1
        grads = [p.grad for p in att.parameters()]
        assert all(g is not None and torch.isfinite(g).all() for g in grads)
        if use_position:
            assert float(att.Wg.kernel.grad.abs().max()) > 0.0
            att.zero_grad()
            before = ra.flash_relation_attention_pos.launches
            att(roi, ref, valid, pos_rois=pos).square().sum().backward()
            assert ra.flash_relation_attention_pos.launches == before + 1
            assert float(att.Wg.kernel.grad.abs().max()) > 0.0
            assert all(torch.isfinite(p.grad).all() for p in att.parameters())


@pytest.mark.cuda
def test_relation_attention_pos_emb_matches_pos_rois(cuda):
    """The routes no model path takes, at MEGA's stage-0 shape (675, 3750)
    with boxes across the canvas: ``RelationAttention(pos_emb=...)`` launches
    mode "input" once and gives what ``pos_rois`` (mode "compute") gives
    within ATOL_POS; ``fused_position_bias`` of the module's Wg gives the
    module's pos_emb weight relu(pos_emb . Wg + b) + 1e-6 within ATOL_BIAS."""
    from mega_pytorch_tpu_torch.models.roi_heads.attention import (
        RelationAttention,
        position_embedding,
    )

    gen = torch.Generator(cuda).manual_seed(1)
    att = RelationAttention(1024, 64, 16, True, torch.bfloat16, cuda)
    att.init_weights(gen)
    att.Wg.bias.data.fill_(0.05)
    att.cast_weights_()
    att.eval().requires_grad_(False)
    rs = np.random.RandomState(24)
    n, m = 675, 3750
    rois, refs = (torch.from_numpy(_flagship_boxes(rs, count)[None]).to(cuda)
                  for count in (n, m))
    valid = torch.from_numpy(rs.rand(1, m) > 0.2).to(cuda)
    roi = torch.randn(1, n, 1024, generator=gen, device=cuda)
    ref = torch.randn(1, m, 1024, generator=gen, device=cuda)
    with torch.inference_mode():
        emb = position_embedding(rois, refs)  # (1, N, M, 64) f32
        computed = att(roi, ref, valid, pos_rois=(rois, refs))
        before = ra.flash_relation_attention_bias.launches
        got = att(roi, ref, valid, pos_emb=emb)
        assert ra.flash_relation_attention_bias.launches == before + 1
        bias = pb.fused_position_bias(rois[0], refs[0], att.Wg.kernel.float().contiguous(),
                                      att.Wg.bias.float().contiguous())
        pw = (emb[0] @ att.Wg.kernel.float() + att.Wg.bias.float()).clamp_min(0.0)
    assert torch.isfinite(got).all() and torch.isfinite(bias).all()
    assert float((got - computed).abs().max()) <= ATOL_POS
    assert float((bias.exp() - (pw + 1e-6).permute(2, 0, 1)).abs().max()) <= ATOL_BIAS


# the "compute" Function's gradients against autograd through the plain
# version with bf16 sinusoids: the backward recomputes that version on the
# same operands, so they agree to the last bit unless the library picks
# another algorithm for a product; 1e-6 of each leaf's largest magnitude
RTOL_POS_GRAD = 1e-6


@pytest.mark.cuda
# small shapes, then MEGA's stage 0 and RDN's base stages
@pytest.mark.parametrize("n,m,u_bias", [(37, 300, True), (675, 750, True), (300, 555, False),
                                        (675, 3750, True), (300, 2775, False)])
def test_pos_function_forward_and_gradients(cuda, n, m, u_bias):
    """RelationAttentionPosFunction: one launch, its forward the kernel's
    bit for bit, nothing launched in backward, and its eight gradients
    (q, k, v, uk, rois, refs, Wg's kernel and bias), each in its operand's
    dtype, against autograd through the bf16-sinusoid plain version. Wg's
    bias is raised by 2 (``_pos``): at the relu floor the function is
    ill-conditioned in the sinusoids' last bits."""
    # the flagship's stages (M of 2775 and more) with the path's boxes
    q, k, v, uk, rois, refs, wk, wb, valid = _attention(cuda, 70 + n, b=2, n=n, m=m,
                                                        canvas=m > 1000)
    if not u_bias:
        uk = torch.zeros_like(uk)
    ops = [q, k, v, uk, *_pos(rois, refs, wk, wb)]
    want_out = ra.flash_relation_attention_pos(*ops, valid)
    ops = [t.clone().requires_grad_() for t in ops]
    before = ra.flash_relation_attention_pos.launches
    out = ra.RelationAttentionPosFunction.apply(*ops, valid, ra.flash_relation_attention_pos)
    assert ra.flash_relation_attention_pos.launches == before + 1
    assert torch.equal(out, want_out)
    cot = torch.randn(out.shape, generator=torch.Generator(cuda).manual_seed(n), device=cuda)
    got = torch.autograd.grad(out, ops, cot)
    assert ra.flash_relation_attention_pos.launches == before + 1
    plain = ra.reference_relation_attention_pos(*ops, valid, sin_dtype=torch.bfloat16)
    want = torch.autograd.grad(plain, ops, cot)
    for name, op, g, w in zip(("q", "k", "v", "uk", "rois", "refs", "wk", "wb"), ops, got,
                              want):
        assert g.dtype == op.dtype and torch.isfinite(g).all(), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= RTOL_POS_GRAD * float(w.float().abs().max()), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gn_stem_launches_no_stem_pool(cuda, dtype):
    """A group-norm stem on s2d(4)-packed frames takes the elementwise route
    (GN is no per-channel affine): no stem pool launch, and equal to its
    canonical branch (f32, TF32 off: the same sums in another order)."""
    from mega_pytorch_tpu_torch.models.backbone.resnet import Stem

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(cuda).manual_seed(4)
    stem = Stem(64, getattr(torch, dtype), cuda, norm="gn")
    stem.init_weights(gen)
    stem.eval().requires_grad_(False)
    rs = np.random.RandomState(23)
    x3 = torch.from_numpy((rs.randn(2, 64, 96, 3) * 50).astype(np.float32))
    x48 = x3.reshape(2, 16, 4, 24, 4, 3).permute(0, 1, 3, 2, 4, 5).reshape(2, 16, 24, 48)
    before = sp.stem_pool_packed.launches
    with torch.inference_mode():
        got = stem(x48.to(cuda))
        want = stem(x3.to(cuda))
    assert sp.stem_pool_packed.launches == before
    assert got.shape == want.shape == (2, 64, 16, 24)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.isfinite(got.float()).all()


# -- ROIAlign ----------------------------------------------------------------------
# the kernel against the plain version: the same taps and weights, the sums in
# another order (f32 FMAs against the plain version's f32 products), so within
# f32 summation rounding of the output's largest magnitude; a bf16 output
# within one bf16 step of the plain f32 result rounded to bf16
RTOL_ROI_ALIGN = 1e-5


def _roi_boxes(rs, lanes, count, canvas=(608, 1024)):
    """(lanes, count, 4) boxes of 16-316 pixels, with the cases at the
    edges in front: zero extent, partly outside [-1, size], on the last
    row and column, and past the map far enough to reach max_grid."""
    h, w = canvas
    edge = np.array([[100, 100, 100, 100], [-40, -30, 60, 50], [w - 20, h - 10, w + 80, h + 60],
                     [w - 1, h - 1, w - 1, h - 1], [w - 16, h - 16, w, h],
                     [-400, -400, w + 500, h + 600], [0, 0, w, h], [-5000, 10, -4000, 90]],
                    np.float32)
    boxes = np.stack([_flagship_boxes(rs, count, canvas) for _ in range(lanes)])
    boxes[:, :len(edge)] = edge[:count]
    return boxes


def _roi_inputs(dev, seed, lanes, count, h, w, c, dtype, strided=False):
    rs = np.random.RandomState(seed)
    feat = torch.from_numpy(rs.randn(lanes, 2 if strided else 1, h, w, c).astype(np.float32))
    feat = feat.to(dev, dtype)
    feat = feat[:, 1] if strided else feat[:, 0]  # a lane stride of two maps, as MEGA's
    rois = torch.from_numpy(_roi_boxes(rs, lanes, count, (16 * h, 16 * w))).to(dev)
    return feat, rois


def _bf16_step(x):
    """One bf16 step (unit in the last place) at each |x|."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e - 8)


def _assert_roi_align(got, feat, rois, args, out_dtype):
    """f32: within RTOL_ROI_ALIGN of the largest magnitude from the plain
    version. bf16: the kernel's own f32 sums rounded once, and within one
    bf16 step of the plain f32 result (plus that f32 rounding)."""
    from mega_pytorch_tpu_torch.ops import roi_align as ra_

    want = ra_.roi_align_reference(feat, rois, *args)  # f32
    assert got.dtype == out_dtype and got.shape == want.shape
    slack = RTOL_ROI_ALIGN * float(want.abs().max())
    if out_dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= slack, (err, slack)
    else:
        assert torch.equal(got, ra_.roi_align(feat, rois, *args).to(torch.bfloat16))
        excess = (got.float() - want).abs() - _bf16_step(want) - slack
        assert float(excess.max()) <= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    # name: lanes, ROIs, map (H, W, C), map dtype, pooled, sampling ratio, lane-strided map
    ("mega", 12, 300, 38, 64, 2048, "bfloat16", 7, 0, True),
    ("mega global", 12, 75, 38, 64, 2048, "bfloat16", 7, 0, True),
    ("fgfa", 4, 300, 38, 64, 2048, "bfloat16", 7, 0, False),
    ("fgfa classic head", 4, 300, 38, 64, 1024, "bfloat16", 14, 0, False),
    ("f32 map", 2, 40, 38, 64, 256, "float32", 7, 0, False),
    ("sampling ratio 2", 2, 40, 20, 30, 256, "bfloat16", 7, 2, False),
    ("sampling ratio 3, 28 bins", 3, 17, 25, 21, 64, "float32", 28, 3, False),
    ("C = 36, not a multiple of 8", 2, 30, 19, 23, 36, "bfloat16", 7, 0, False),
    ("C = 3", 2, 30, 19, 23, 3, "float32", 7, 0, False),
    ("C = 1, one ROI a lane", 9, 1, 40, 52, 1, "float32", 28, 2, False),
    ("one ROI", 1, 1, 38, 64, 2048, "bfloat16", 7, 0, False),
], ids=lambda c: c[0])
def test_roi_align_kernel_matches_plain(cuda, case, out):
    from mega_pytorch_tpu_torch.ops import roi_align as ra_

    _, lanes, count, h, w, c, dtype, pooled, ratio, strided = case
    feat, rois = _roi_inputs(cuda, count + c, lanes, count, h, w, c, getattr(torch, dtype),
                             strided)
    out_dtype = getattr(torch, out)
    args = (1 / 16, pooled, pooled, ratio, 10)
    before = ra_.roi_align.launches
    got = ra_.roi_align(feat, rois, *args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert ra_.roi_align.launches == before + 1
    _assert_roi_align(got, feat, rois, args, out_dtype)


@pytest.mark.cuda
def test_roi_align_counts_its_launches(cuda):
    """One launch a call, counted on the wrapper, each call inside the
    ``roi_align`` span; the plain version on CPU tensors launches nothing."""
    from mega_pytorch_tpu_torch.ops import roi_align as ra_
    from mega_pytorch_tpu_torch.utils import profiler

    feat, rois = _roi_inputs(cuda, 3, 2, 20, 19, 23, 64, torch.bfloat16)
    before = ra_.roi_align.launches
    with profiler.recording():
        for _ in range(3):
            ra_.roi_align(feat, rois, 1 / 16)
        ra_.roi_align(feat.cpu(), rois.cpu(), 1 / 16)
    assert ra_.roi_align.launches == before + 3
    assert profiler.recorded()["spans"]["roi_align"]["calls"] == 4


@pytest.mark.cuda
def test_roi_align_kernel_rejects_what_it_does_not_take(cuda):
    from mega_pytorch_tpu_torch.ops import roi_align as ra_

    feat, rois = _roi_inputs(cuda, 4, 2, 5, 19, 23, 64, torch.float32)
    with pytest.raises(ValueError, match="channel-last"):
        ra_.roi_align(feat.permute(0, 3, 1, 2).contiguous().permute(0, 1, 3, 2), rois, 1 / 16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ra_.roi_align(feat.half(), rois, 1 / 16)
    with pytest.raises(ValueError, match="one device"):
        ra_.roi_align(feat, rois.cpu(), 1 / 16)


@pytest.mark.cuda
@pytest.mark.parametrize("roi_grad", [False, True])
@pytest.mark.parametrize("out", ["float32", "bfloat16"])
def test_roi_align_function_gradients(cuda, out, roi_grad):
    """Under grad the call takes ROIAlignFunction: one launch, the forward
    the kernel's bit for bit, nothing launched in backward, and the
    gradients of the map (and of the ROIs) against autograd through the
    plain version, which its backward recomputes on the same operands."""
    from mega_pytorch_tpu_torch.ops import roi_align as ra_

    feat, rois = _roi_inputs(cuda, 5, 3, 40, 19, 23, 256, torch.bfloat16)
    out_dtype = getattr(torch, out)
    args = (1 / 16, 7, 7, 0, 10, out_dtype)
    want_out = ra_.roi_align(feat, rois, *args[:-1], out_dtype=out_dtype)
    ops = [feat.clone().requires_grad_(), rois.clone().requires_grad_(roi_grad)]
    before = ra_.roi_align.launches
    got_out = ra_.roi_align(*ops, *args[:-1], out_dtype=out_dtype)
    assert ra_.roi_align.launches == before + 1 and torch.equal(got_out, want_out)
    cot = torch.randn(got_out.shape, generator=torch.Generator(cuda).manual_seed(1),
                      device=cuda).to(out_dtype)
    leaves = ops if roi_grad else ops[:1]
    got = torch.autograd.grad(got_out, leaves, cot)
    assert ra_.roi_align.launches == before + 1
    want = torch.autograd.grad(ra_.roi_align_reference(*ops, *args), leaves, cot)
    for name, op, g, w in zip(("features", "rois"), leaves, got, want):
        assert g.dtype == op.dtype and torch.isfinite(g).all(), name
        err = float((g.float() - w.float()).abs().max())
        assert err <= 1e-6 * float(w.float().abs().max()), (name, err)


@pytest.mark.cuda
def test_group_norm_keeps_channels_last(cuda):
    """CUDA's group_norm returns NCHW memory; ``GroupNorm`` hands a
    channels_last input back as channels_last, so the NHWC maps of a GN
    body reach the ROIAlign kernel with channel stride 1."""
    from mega_pytorch_tpu_torch.models.layers import GroupNorm

    x = torch.randn(2, 64, 9, 11, device=cuda).contiguous(memory_format=torch.channels_last)
    gn = GroupNorm(64, torch.bfloat16, cuda)
    y = gn(x)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert y.permute(0, 2, 3, 1).stride(-1) == 1


# -- bottleneck epilogue -----------------------------------------------------------
# MEGA's 24 maps a step (12 lanes x key and global frame, 608x1024 canvases):
# each stage's bottleneck width (conv1 and conv2 outputs, no residual) and
# output width (conv3, with the residual), (N, C, H, W)
EPILOGUE_SHAPES = {
    "layer1 mid": (24, 64, 152, 256), "layer1 out": (24, 256, 152, 256),
    "layer2 mid": (24, 128, 76, 128), "layer2 out": (24, 512, 76, 128),
    "layer3 mid": (24, 256, 38, 64), "layer3 out": (24, 1024, 38, 64),
    "res5 mid": (24, 512, 38, 64), "res5 out": (24, 2048, 38, 64),
    "ragged": (3, 24, 5, 7),
}


def _epilogue_inputs(dev, shape, dtype, residual, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)

    def map_():
        x = torch.randn(shape, generator=gen, device=dev) * 2
        return x.to(dtype).contiguous(memory_format=torch.channels_last)

    shift = torch.randn(shape[1], generator=gen, device=dev)
    return map_(), shift, map_() if residual else None


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("stage", list(EPILOGUE_SHAPES))
def test_bottleneck_epilogue_kernel_exact(cuda, stage, residual):
    """The kernel against its plain version bit for bit (the same f32 sums
    in the same order, one rounding) at each stage's bf16 shapes."""
    from mega_pytorch_tpu_torch.ops.kernels import bottleneck_epilogue as be

    a, shift, r = _epilogue_inputs(cuda, EPILOGUE_SHAPES[stage], torch.bfloat16, residual)
    before = be.bottleneck_epilogue.launches
    got = be.bottleneck_epilogue(a, shift, r)
    assert be.bottleneck_epilogue.launches == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last) and got.dtype == a.dtype
    assert torch.equal(got, be.bottleneck_epilogue_reference(a, shift, r))


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 19, 32), (3, 12, 5, 7), (1, 4, 1, 1)])
def test_bottleneck_epilogue_kernel_exact_f32(cuda, shape, residual):
    from mega_pytorch_tpu_torch.ops.kernels import bottleneck_epilogue as be

    a, shift, r = _epilogue_inputs(cuda, shape, torch.float32, residual, seed=1)
    assert torch.equal(be.bottleneck_epilogue(a, shift, r),
                       be.bottleneck_epilogue_reference(a, shift, r))


@pytest.mark.cuda
def test_bottleneck_epilogue_kernel_refuses(cuda):
    """Unaligned channel counts, NCHW memory, a residual unlike ``a``, a
    shift not f32 (C,), a misaligned pointer and operands that require
    grad raise; nothing is launched."""
    from mega_pytorch_tpu_torch.ops.kernels import bottleneck_epilogue as be

    a, shift, r = _epilogue_inputs(cuda, (2, 64, 9, 11), torch.bfloat16, True)
    odd, odd_shift, _ = _epilogue_inputs(cuda, (2, 12, 9, 11), torch.bfloat16, False)
    before = be.bottleneck_epilogue.launches
    with pytest.raises(ValueError, match="16-byte vectors"):
        be.bottleneck_epilogue(odd, odd_shift)
    with pytest.raises(ValueError, match="channels_last"):
        be.bottleneck_epilogue(a.contiguous(), shift)
    with pytest.raises(ValueError, match="residual"):
        be.bottleneck_epilogue(a, shift, r.contiguous())
    with pytest.raises(ValueError, match="residual"):
        be.bottleneck_epilogue(a, shift, r.float())
    with pytest.raises(ValueError, match="shift"):
        be.bottleneck_epilogue(a, shift.to(torch.bfloat16))
    with pytest.raises(ValueError, match="shift"):
        be.bottleneck_epilogue(a, shift[:32])
    flat = torch.zeros(a.numel() + 1, dtype=a.dtype, device=cuda)
    shifted = flat[1:].view(2, 9, 11, 64).permute(0, 3, 1, 2)  # 2 bytes off 16
    with pytest.raises(ValueError, match="aligned"):
        be.bottleneck_epilogue(shifted, shift)
    with pytest.raises(ValueError, match="inference-only"):
        be.bottleneck_epilogue(a.float().requires_grad_(), shift)
    assert be.bottleneck_epilogue.launches == before


def _r101(dev, dtype=torch.bfloat16):
    from mega_pytorch_tpu_torch.models.backbone.resnet import ResNetC4, ResNetRes5Head
    from mega_pytorch_tpu_torch.models.layers import init_module_

    gen = torch.Generator(dev).manual_seed(0)
    body = init_module_(ResNetC4("R-101", dtype=dtype, device=dev), gen, cast=True)
    head = init_module_(ResNetRes5Head("R-101", dtype=dtype, device=dev), gen, cast=True)
    return body, head


@pytest.mark.cuda
def test_bottleneck_epilogue_launches_on_a_c4_and_res5_pass(cuda):
    """An R-101 C4 body and res5 head in bf16 eval mode launch 30 x 3
    epilogues in the body and 3 x 3 in res5; in train mode, in f32 and under
    group norm none."""
    from mega_pytorch_tpu_torch.models.backbone.resnet import ResNetC4
    from mega_pytorch_tpu_torch.ops.kernels.bottleneck_epilogue import bottleneck_epilogue

    body, head = _r101(cuda)
    frames = torch.randn(2, 64, 96, 3, device=cuda)
    before = bottleneck_epilogue.launches
    with torch.inference_mode():
        c4 = body(frames)
        assert bottleneck_epilogue.launches == before + 90
        head(c4)
    assert bottleneck_epilogue.launches == before + 99
    before = bottleneck_epilogue.launches
    body.train()
    head.train()
    with torch.no_grad():
        head(body(frames))
    f32_body, _ = _r101(cuda, torch.float32)
    gn = ResNetC4("R-50", dtype=torch.bfloat16, device=cuda, norm="gn").eval()
    for module in (f32_body, gn):
        with torch.inference_mode():
            module(frames)
    assert bottleneck_epilogue.launches == before


@pytest.mark.cuda
def test_folded_r101_against_f32(cuda):
    """The folded bf16 R-101 C4 body and res5 head (eval) and the unfolded
    one (train mode), each against the same weights in f32 (TF32 off): the
    folded one no further from f32 than 1.5 times the unfolded one (the
    bound of tests/test_torch_bottleneck_fold.py)."""
    torch.backends.cudnn.allow_tf32 = False
    body, head = _r101(cuda)
    exact = _r101(cuda, torch.float32)
    frames = torch.randn(2, 64, 96, 3, device=cuda)
    with torch.inference_mode():
        want = exact[1](exact[0](frames))
        folded = head(body(frames))
        body.train()
        head.train()
        unfolded = head(body(frames))

    def rel(got):
        return float((got.float() - want).abs().max() / want.abs().max())

    assert torch.isfinite(folded.float()).all()
    assert rel(folded) <= 1.5 * rel(unfolded), (rel(folded), rel(unfolded))
