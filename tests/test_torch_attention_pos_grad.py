"""Gradients through relation attention mode "compute" against the JAX
package.

``RelationAttentionPosFunction``, its forward launcher swapped for the tiled
plain version of mode "compute" (the kernel's arithmetic; the CUDA kernel is
held to it on the card), against ``jax.grad`` of
``fused_relation_attention_pos`` with the Pallas kernel in interpret mode:
both backwards recompute the plain version with the position bias's bf16
sinusoids (the JAX package's ``_pos_vjp_bwd``). Also
``RelationAttention(precise_bias=False)``'s parameter and input gradients
(the einsum path with bf16 sinusoids in both packages) against the JAX
module's.

Wg's bias sits at 1: pw = relu(Wg . sinusoids + b) then stays far above its
relu floor. At the floor a bf16 step of one sinusoid (torch's and XLA's sine
differ by an ulp of a large argument, which can round to the other bf16
neighbour) switches pw between 0 and a small value, moving log(pw + 1e-6)
by several units and relu's gradient between 0 and 1: the two packages
would then differ by O(1) for a reason that is not the port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.models.roi_heads.attention import RelationAttention as JaxAttention
from mega_pytorch_tpu.ops.pallas.relation_attention import fused_relation_attention_pos
from mega_pytorch_tpu_torch.models.roi_heads.attention import RelationAttention
from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from test_torch_train_attention import _assert_grad_close, _bf16_values

torch.set_num_threads(2)

G, N, D, E = 16, 37, 64, 64
# forward: the tiled plain version (64-ref tiles, fp16 dw/dh factors)
# against the Pallas kernel in interpret mode at its own tile width and its
# bf16 factors: mode "compute"'s parity tolerance (test_torch_kernels.py
# ATOL_POS); gradients: _assert_grad_close's 2^-7 of each leaf's scale
ATOL_FWD = 2e-2
NAMES = ["q", "k", "v", "uk", "rois", "refs", "wk", "wb"]


def _boxes(rs, *shape):
    return (np.abs(rs.randn(*shape, 4)) * 30 + np.array([0, 0, 40, 40])).astype(np.float32)


def _lanes(m, seed=0):
    """Three lanes with M refs: lane 0 ragged validity, lane 1 every ref
    valid, lane 2 no valid ref; Wg shared, its bias at 1 (off the floor)."""
    rs = np.random.RandomState(seed)
    valid = rs.rand(3, m) > 0.3
    valid[1] = True
    valid[2] = False
    return dict(
        q=_bf16_values(rs.randn(3, G, N, D).astype(np.float32)),
        k=_bf16_values(rs.randn(3, G, m, D).astype(np.float32)),
        v=_bf16_values(rs.randn(3, G, m, D).astype(np.float32)),
        uk=(rs.randn(3, G, m) * 0.1).astype(np.float32),
        rois=_boxes(rs, 3, N), refs=_boxes(rs, 3, m),
        wk=(rs.randn(E, G) * 0.05).astype(np.float32),
        wb=(1.0 + rs.rand(G) * 0.1).astype(np.float32),
        valid=valid,
        cot=rs.randn(3, G, N, D).astype(np.float32),
    )


def _jax_lane(x, i):
    """Lane i through the JAX custom_vjp: (output, grads of NAMES), the
    shared Wg's grads of this lane alone."""
    def loss(q, k, v, uk, rois, refs, wk, wb):
        out = fused_relation_attention_pos(q, k, v, uk, rois, (refs, wk, wb),
                                           jnp.asarray(x["valid"][i]), E, True)
        return jnp.sum(out * x["cot"][i]), out

    ops = [jnp.asarray(x[n] if n in ("wk", "wb") else x[n][i]) for n in NAMES]
    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(8)), has_aux=True)(*ops)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _tiled_launch(*ops):
    return ra.reference_relation_attention_pos_tiled(*ops, wh_dtype=torch.bfloat16)


@pytest.mark.parametrize("m", [45, 90])
def test_pos_function_matches_jax_custom_vjp(m):
    x = _lanes(m)

    def t(name):
        dtype = torch.bfloat16 if name in ("q", "k", "v") else torch.float32
        return torch.from_numpy(x[name]).to(dtype).requires_grad_()

    ops = [t(n) for n in NAMES]
    out = ra.RelationAttentionPosFunction.apply(*ops, torch.from_numpy(x["valid"]),
                                                _tiled_launch)
    (out * torch.from_numpy(x["cot"])).sum().backward()
    lanes = [_jax_lane(x, i) for i in range(3)]
    for i, (want_out, want_grads) in enumerate(lanes):
        np.testing.assert_allclose(out[i].detach().numpy(), want_out, rtol=0, atol=ATOL_FWD,
                                   err_msg=f"forward lane {i}")
        for name, op, want in zip(NAMES[:6], ops, want_grads):
            assert op.grad.dtype == op.dtype, name  # each gradient in its input's dtype
            _assert_grad_close(op.grad[i].float(), want, f"d{name} lane {i}")
    # Wg is shared by the lanes: its gradient is their sum. Both packages
    # round dWg to bf16 (the gradient of the bf16-cast kernel), JAX once a
    # lane and the port once for the sum, so an element can sit a bf16 step
    # of the lanes' scale away: 2^-7 of the leaf's largest magnitude
    for j in (6, 7):
        want = sum(g[j] for _, g in lanes)
        np.testing.assert_allclose(ops[j].grad.numpy(), want, rtol=0,
                                   atol=2.0 ** -7 * np.abs(want).max(),
                                   err_msg=f"d{NAMES[j]}")
    assert out[2].abs().max() == 0.0  # the lane with no valid ref
    assert all(op.grad[2].abs().max() == 0.0 for op in ops[:6])


def test_pos_function_launches_once_and_wrapper_refuses_grad():
    """The wrapper keeps raising on operands that require grad; the
    Function launches its forward once a call and nothing in backward, and
    its backward is autograd through the bf16-sinusoid plain version."""
    x = _lanes(45, seed=1)
    ops = [torch.from_numpy(x[n]).to(torch.bfloat16 if n in "qkv" else torch.float32)
           for n in NAMES]
    valid = torch.from_numpy(x["valid"])
    ops[0].requires_grad_()
    with pytest.raises(ValueError, match="inference-only"):
        ra.flash_relation_attention_pos(*ops, valid)
    calls = []

    def launch(*args):
        calls.append(1)
        return ra.reference_relation_attention_pos(*args)

    diff = [t.detach().clone().requires_grad_() for t in ops]
    ra.RelationAttentionPosFunction.apply(*diff, valid, launch).sum().backward()
    plain = ra.reference_relation_attention_pos(*ops, valid, sin_dtype=torch.bfloat16)
    (want,) = torch.autograd.grad(plain.sum(), ops[0])
    assert len(calls) == 1
    assert torch.equal(diff[0].grad, want)


@pytest.mark.parametrize("use_u", [True, False])
def test_relation_attention_compute_grads_equal_jax(use_u):
    """RelationAttention(precise_bias=False) with pos_rois under grad, f32 on
    the CPU (the einsum path with the bf16-sinusoid bias in both packages):
    the gradients of every parameter and of both feature inputs."""
    feat, m = G * D, 50
    rs = np.random.RandomState(5)
    roi = rs.randn(N, feat).astype(np.float32)
    ref = rs.randn(m, feat).astype(np.float32)
    valid = rs.rand(m) > 0.2
    rois, refs = _boxes(rs, N), _boxes(rs, m)
    cot = rs.randn(N, feat).astype(np.float32)
    jax_mod = JaxAttention(feat_dim=feat, embed_dim=E, groups=G, use_position=True,
                           use_u_bias=use_u)
    pos = (jnp.asarray(rois), jnp.asarray(refs))
    params = jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(roi), jnp.asarray(ref),
                          jnp.asarray(valid), pos_rois=pos)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["Wg"] = {"kernel": params["Wg"]["kernel"] * 5,
                    "bias": np.ones_like(params["Wg"]["bias"])}  # off the relu floor

    def loss(p, a, b):
        return jnp.sum(jax_mod.apply({"params": p}, a, b, jnp.asarray(valid),
                                     pos_rois=pos) * cot)

    want_p, want_roi, want_ref = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(roi), jnp.asarray(ref))

    mod = RelationAttention(feat, E, G, True, use_u_bias=use_u)
    mod.load_state_dict(state_dict_from_flax(params))
    a = torch.from_numpy(roi)[None].requires_grad_()
    b = torch.from_numpy(ref)[None].requires_grad_()
    out = mod(a, b, torch.from_numpy(valid)[None],
              pos_rois=(torch.from_numpy(rois)[None], torch.from_numpy(refs)[None]))
    (out[0] * torch.from_numpy(cot)).sum().backward()

    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want_p))
    got = dict(mod.named_parameters())
    assert set(want) == set(got)
    # as test_torch_train_attention.py: Wk's bias has a true gradient of 0
    # (cancellation noise in both), so leaves are held relative to their own
    # scale floored at 1e-3 of the largest leaf's; a bf16 sinusoid rounded
    # to the other neighbour in one package moves one pair's weight by 2^-8
    # relative, hence 1e-3 rather than the f32 test's 1e-4
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        scale = max(w.abs().max().item(), floor)
        err = (got[name].grad - w).abs().max().item() / scale
        assert err < 1e-3, (name, err)
    for g, w in ((a.grad[0], want_roi), (b.grad[0], want_ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3,
                                   atol=1e-3 * np.abs(np.asarray(w)).max())
