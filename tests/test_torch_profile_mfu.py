"""The MFU tool's FLOP count (``mega_pytorch_tpu_torch/tools/profile_mfu.py``)
on the CPU.

* Each hand-written kernel's registered formula at the flagship shapes
  equals its closed form: twice the multiply-adds of q.k^T and p.v, and for
  mode "compute" and ``fused_position_bias`` of the Wg contraction.
* A kernel entry on CPU tensors counts exactly its formula, and not the
  matrix products of the plain version that computes it there.
* On a tiny MEGA lockstep step, every ``RelationAttention`` call on the CPU
  (its einsum path) counts its projections plus exactly the formula of the
  kernel the card launches for it, so the step counts the same FLOPs on
  the CPU and on the card; two steps count the same. The step's ratio to
  XLA's ``cost_analysis`` of the JAX step is printed, not held: XLA also
  counts elementwise work and NMS's IoU matrices.
* The convolutions of a tiny R-50 C4 body count
  sum 2 * (Cin / groups) * kh * kw * Cout * Hout * Wout (forward hooks).
* The tiny R-50 C4 body plus the dilated res5 head counts between 0.9 and 1
  of XLA's count of the same forward: XLA adds the elementwise work of
  FrozenBN, relu, the pool and the residual adds, and leaves out the taps
  of a padded convolution that fall outside its input; at 512x512 with
  these widths the first outweighs the second.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import flop_registry

from mega_pytorch_tpu.data.transforms import s2d_pack_frames
from mega_pytorch_tpu.engine import batched_inference as jax_engine
from mega_pytorch_tpu.models.backbone import resnet as jax_resnet
from mega_pytorch_tpu.models.detectors import mega as jax_mega
from mega_pytorch_tpu_torch.engine import batched_inference as engine
from mega_pytorch_tpu_torch.models.backbone import resnet
from mega_pytorch_tpu_torch.models.layers import Conv
from mega_pytorch_tpu_torch.models.roi_heads.attention import RelationAttention
from mega_pytorch_tpu_torch.ops.kernels import position_bias as pb
from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
from mega_pytorch_tpu_torch.tools.profile_mfu import count_flops
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from torch_port_harness import CANVAS, port_mega_from, tiny_mega, to_np

torch.set_num_threads(4)

OPS = torch.ops.mega_pytorch_tpu_torch
G, D, E = 16, 64, 64
# operator, argument shapes at a flagship (or training) shape, closed form
FLAGSHIP = {
    # MEGA's global attention at one lane: 2175 = 29 frames x 75 refs of
    # the window's keys, 750 = 10 global frames x 75
    "none (2175, 750)": (OPS.relation_attention_none,
                         [(1, G, 2175, D), (1, G, 750, D), (1, G, 750, D), (1, G, 750),
                          (1, 750)], 2 * 2 * G * 2175 * 750 * D),
    # MEGA's local stage 0: 675 = 9 key-slot ROI sets x 75, 3750 = 25 x 150
    "compute stage 0 (675, 3750)": (
        OPS.relation_attention_pos,
        [(1, G, 675, D), (1, G, 3750, D), (1, G, 3750, D), (1, G, 3750), (1, 675, 4),
         (1, 3750, 4), (E, G), (G,), (1, 3750)],
        2 * 2 * G * 675 * 3750 * D + 2 * 675 * 3750 * E * G),
    # MEGA training, local stage 0: 173 ROIs against 450 refs
    "input, training (173, 450)": (
        OPS.relation_attention_bias,
        [(1, G, 173, D), (1, G, 450, D), (1, G, 450, D), (1, G, 450), (1, G, 173, 450),
         (1, 450)], 2 * 2 * G * 173 * 450 * D),
    "position bias (675, 3750)": (OPS.position_bias, [(675, 4), (3750, 4), (E, G), (G,), E],
                                  2 * 675 * 3750 * E * G),
}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("case", FLAGSHIP)
def test_kernel_formula_equals_closed_form(case):
    op, shapes, want = FLAGSHIP[case]
    assert flop_registry[op](*shapes, out_val=None) == want


def _attention_operands(rs, b, n, m):
    q, k, v = (_t(rs.randn(b, G, r, D).astype(np.float32)) for r in (n, m, m))
    uk = _t(rs.randn(b, G, m).astype(np.float32))
    rois = _t(np.sort(rs.uniform(0, 60, (b, n, 4)), -1).astype(np.float32))
    refs = _t(np.sort(rs.uniform(0, 60, (b, m, 4)), -1).astype(np.float32))
    wg = _t((rs.randn(E, G) * 0.1).astype(np.float32))
    wb = _t(np.full(G, 0.5, np.float32))
    valid = torch.ones(b, m, dtype=torch.bool)
    bias = _t(rs.randn(b, G, n, m).astype(np.float32))
    return q, k, v, uk, rois, refs, wg, wb, valid, bias


# each entry called on CPU tensors at the tiny step's shapes (8 ROIs against
# 24 refs, 2 lanes): (entry, arguments from the operands, formula)
ENTRIES = {
    "flash_relation_attention": (
        ra.flash_relation_attention, lambda q, k, v, uk, r, f, wg, wb, va, bi: (q, k, v, uk, va),
        lambda b, n, m: 4 * b * G * n * m * D,
        lambda b, n, m: {"sin_cos": 0, "exp": b * G * n * m, "log": 0}),
    "flash_relation_attention_pos": (
        ra.flash_relation_attention_pos,
        lambda q, k, v, uk, r, f, wg, wb, va, bi: (q, k, v, uk, r, f, wg, wb, va),
        lambda b, n, m: 4 * b * G * n * m * D + 2 * b * n * m * E * G,
        lambda b, n, m: {"sin_cos": b * n * m * E, "exp": b * G * n * m, "log": 4 * b * n * m}),
    "flash_relation_attention_bias": (
        ra.flash_relation_attention_bias,
        lambda q, k, v, uk, r, f, wg, wb, va, bi: (q, k, v, uk, bi, va),
        lambda b, n, m: 4 * b * G * n * m * D,
        lambda b, n, m: {"sin_cos": 0, "exp": b * G * n * m, "log": 0}),
    "fused_position_bias": (
        pb.fused_position_bias, lambda q, k, v, uk, r, f, wg, wb, va, bi: (r[0], f[0], wg, wb),
        lambda b, n, m: 2 * n * m * E * G,
        lambda b, n, m: {"sin_cos": n * m * E, "exp": 0, "log": n * m * (4 + G)}),
}


@pytest.mark.parametrize("name", ENTRIES)
def test_kernel_entry_counts_formula_not_plain_version(name):
    """On CPU tensors an entry runs its plain version, whose matrix
    products FlopCounterMode would count; it counts its formula alone."""
    entry, pick, flops, special = ENTRIES[name]
    b, n, m = 2, 8, 24
    args = pick(*_attention_operands(np.random.RandomState(0), b, n, m))
    with torch.inference_mode():
        got = count_flops(lambda: entry(*args))
    assert got["flops"] == flops(b, n, m)
    assert list(got["kernel_flops"].values()) == [flops(b, n, m)]
    assert len(got["by_op"]) == 1, got["by_op"]  # no aten product counted
    assert list(got["special"].values()) == [special(b, n, m)]


def _outside_flops(module, b, n, m):
    """The products of a ``RelationAttention`` call outside the kernel: the
    q, k and value projections (Dense and the grouped Wv einsum) and u . k."""
    dim = module.feat_dim
    flops = 2 * b * n * dim * dim + 2 * b * m * dim * dim + 2 * b * m * dim * dim
    if module.u is not None:
        flops += 2 * b * G * m * (dim // G)
    return flops


@pytest.fixture(scope="module")
def tiny_step():
    """The port's tiny MEGA (bridged weights) and one lockstep step's
    inputs: 2 lanes, a global update and an emission on both."""
    model, params = tiny_mega()
    port = port_mega_from(params)
    rs = np.random.RandomState(3)
    lanes = 2
    frames, gframes = (
        s2d_pack_frames(rs.randint(0, 256, (lanes, *CANVAS, 3), dtype=np.uint8), 4)
        for _ in range(2))
    sizes = np.tile(np.array(CANVAS, np.float32), (lanes, 1))
    flags = np.ones(lanes, bool)
    return model, params, port, (frames, sizes, gframes, sizes.copy(), flags, flags, flags)


def _port_step(port, inputs):
    step = engine.make_lockstep_step(port)
    frames, sizes, gframes, gsizes, resets, gmasks, emits = (_t(x) for x in inputs)
    carries = port.zero_carry(frames.shape[0], "cpu")
    return lambda: step(carries, frames, sizes, gframes, gsizes, resets, gmasks, emits)


def test_tiny_mega_step_counts_kernel_formulas(tiny_step):
    """Every RelationAttention call of the step, replayed alone, counts its
    projections plus exactly the formula of the kernel mode the card runs
    for it ("compute" with position ROIs, "none" without); the step counts
    the same twice. Prints the step's count against XLA's."""
    model, params, port, inputs = tiny_step
    calls = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, kwargs: calls.append((mod, args, kwargs)), with_kwargs=True)
        for m in port.modules() if isinstance(m, RelationAttention)]
    step = _port_step(port, inputs)
    try:
        first = count_flops(step)
    finally:
        for h in hooks:
            h.remove()
    assert count_flops(step)["flops"] == first["flops"] > 0
    modes = set()
    for mod, args, kwargs in calls:
        roi_feat, ref_feat = args[0], args[1]
        b, n, m = roi_feat.shape[0], roi_feat.shape[1], ref_feat.shape[1]
        pos = kwargs.get("pos_rois") is not None
        modes.add(pos)
        q, k = (b, G, n, D), (b, G, m, D)
        kernel = ra.attention_pos_flops(q, k, (E, G)) if pos else ra.attention_flops(q, k)
        with torch.inference_mode():
            got = count_flops(lambda: mod(*args, **kwargs))["flops"]
        assert got == _outside_flops(mod, b, n, m) + kernel, (b, n, m, pos)
    assert modes == {True, False}

    frames, sizes, gframes, gsizes, resets, gmasks, emits = inputs
    jax_step = jax_engine.make_lockstep_step(model)
    zero = port.zero_carry(frames.shape[0], "cpu")
    carries = jax_mega.MEGACarry(*(
        tuple(jnp.asarray(y.numpy()) for y in x) if isinstance(x, tuple)
        else jnp.asarray(x.numpy()) for x in zero))
    cost = jax_step.lower(params, carries, jnp.asarray(frames[:, None]),
                          jnp.asarray(sizes[:, None]), jnp.asarray(gframes[:, None]),
                          jnp.asarray(gsizes[:, None]), jnp.asarray(resets),
                          jnp.asarray(gmasks), jnp.asarray(emits)).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    print(f"tiny MEGA step, 2 lanes: port {first['flops']} FLOPs, XLA cost_analysis "
          f"{cost['flops']:.0f}, ratio {first['flops'] / cost['flops']:.4f}")


# the tiny R-50 C4 body: R-50's stage depths at narrow widths
TINY_R50 = dict(width_per_group=8, res2_out_channels=32)
BODY_IN = (1, 512, 512, 3)


@pytest.fixture(scope="module")
def tiny_r50():
    """(JAX body, head, their params, the port's bridged body and head, input)."""
    x = np.random.RandomState(5).randn(*BODY_IN).astype(np.float32) * 50
    body = jax_resnet.ResNetC4(depth="R-50", stem_out_channels=16, **TINY_R50)
    head = jax_resnet.ResNetRes5Head(depth="R-50", stride_init=1, dilation=2, **TINY_R50)
    bp = to_np(jax.jit(body.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    c4 = body.apply({"params": bp}, jnp.asarray(x))
    hp = to_np(jax.jit(head.init)(jax.random.PRNGKey(1), c4)["params"])
    port_body = resnet.ResNetC4("R-50", stem_out_channels=16, **TINY_R50)
    port_head = resnet.ResNetRes5Head("R-50", 1, 2, **TINY_R50)
    port_body.load_state_dict(state_dict_from_flax(bp), strict=True)
    port_head.load_state_dict(state_dict_from_flax(hp), strict=True)
    return body, head, bp, hp, port_body.eval(), port_head.eval(), x


def test_c4_body_convolutions_equal_closed_form(tiny_r50):
    _, _, _, _, port_body, _, x = tiny_r50
    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, args, out: shapes.append((mod.weight.shape, out.shape)))
        for m in port_body.modules() if isinstance(m, Conv)]
    try:
        with torch.inference_mode():
            got = count_flops(lambda: port_body(_t(x)))
    finally:
        for h in hooks:
            h.remove()
    want = sum(2 * w[1] * w[2] * w[3] * o[0] * o[1] * o[2] * o[3] for w, o in shapes)
    # the canonical stem's 7x7/2 conv on the RGB frames (not a Conv module)
    n, h, w, c = x.shape
    want += 2 * c * 7 * 7 * 16 * n * (h // 2) * (w // 2)
    assert len(shapes) == 3 * 13 + 3  # 13 bottlenecks of 3 convs, 3 projections
    assert got["by_op"] == {"aten.convolution": want}
    assert got["flops"] == want


def test_c4_body_and_head_within_xla_count(tiny_r50):
    body, head, bp, hp, port_body, port_head, x = tiny_r50

    def forward(bp, hp, x):
        return head.apply({"params": hp}, body.apply({"params": bp}, x))

    cost = jax.jit(forward).lower(bp, hp, jnp.asarray(x)).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    with torch.inference_mode():
        got = count_flops(lambda: port_head(port_body(_t(x))))["flops"]
    ratio = got / cost["flops"]
    print(f"tiny R-50 C4 body + res5 head at {BODY_IN}: port {got}, XLA {cost['flops']:.0f}, "
          f"ratio {ratio:.4f}")
    assert 0.9 <= ratio <= 1.0
