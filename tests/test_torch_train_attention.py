"""Gradients through relation attention against the JAX package.

The port's autograd Function for modes "none" and "input", its forward
launcher swapped for the tiled plain version (the kernel's order of
rounding; the CUDA kernels themselves are held to it on the card), against
``jax.grad`` of ``fused_relation_attention`` with the Pallas kernel in
interpret mode (its ``custom_vjp`` recomputes the plain version, as the
Function's backward does); and ``RelationAttention(precise_bias=True)``'s
parameter and input gradients against the JAX module's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.models.roi_heads.attention import RelationAttention as JaxAttention
from mega_pytorch_tpu.ops.pallas.relation_attention import fused_relation_attention
from mega_pytorch_tpu_torch.models.roi_heads.attention import RelationAttention
from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax

torch.set_num_threads(2)

G, N, D = 16, 37, 64
# forward: the tiled plain version (64-ref tiles) against the Pallas kernel
# in interpret mode at its own tile width, so p is rounded against another
# running max: the kernels' parity tolerance (KERNEL_PARITY.md); gradients:
# bf16 operands take their gradient rounded to bf16 on both sides, so a few
# elements sit one bf16 step apart (2^-8 relative) where f32 sums of
# another order straddle a rounding boundary
ATOL_FWD = 6e-3
RTOL_GRAD = 2.0 ** -7


def _bf16_values(x):
    return np.asarray(torch.from_numpy(x).to(torch.bfloat16).float())


def _lanes(m, seed=0):
    """Three lanes of (g, N, d) operands with M refs: lane 0 ragged validity,
    lane 1 every ref valid, lane 2 no valid ref."""
    rs = np.random.RandomState(seed)
    valid = rs.rand(3, m) > 0.3
    valid[1] = True
    valid[2] = False
    return dict(
        q=_bf16_values(rs.randn(3, G, N, D).astype(np.float32)),
        k=_bf16_values(rs.randn(3, G, m, D).astype(np.float32)),
        v=_bf16_values(rs.randn(3, G, m, D).astype(np.float32)),
        uk=(rs.randn(3, G, m) * 0.1).astype(np.float32),
        # a log bias with rows at the relu floor (log 1e-6), as at init
        bias=np.where(rs.rand(3, G, N, m) > 0.5, np.log(1e-6),
                      rs.randn(3, G, N, m)).astype(np.float32),
        valid=valid,
        cot=rs.randn(3, G, N, D).astype(np.float32),
    )


def _assert_grad_close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-6)
    np.testing.assert_allclose(got, want, rtol=RTOL_GRAD, atol=RTOL_GRAD * scale * 0.05,
                               err_msg=name)


@pytest.mark.parametrize("m", [45, 90])
@pytest.mark.parametrize("with_bias", [False, True])
def test_functions_match_jax_custom_vjp(m, with_bias):
    x = _lanes(m)
    names = ["q", "k", "v", "uk"] + (["bias"] if with_bias else [])

    def jax_lane(i):
        def loss(*ops):
            bias = ops[4] if with_bias else None
            out = fused_relation_attention(*ops[:4], bias, jnp.asarray(x["valid"][i]), True)
            return jnp.sum(out * x["cot"][i]), out

        ops = [jnp.asarray(x[n][i]) for n in names]
        (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(len(ops))),
                                             has_aux=True)(*ops)
        return out, grads

    def t(name, dtype=torch.float32):
        return torch.from_numpy(x[name]).to(dtype).requires_grad_(name != "valid")

    ops = [t("q", torch.bfloat16), t("k", torch.bfloat16), t("v", torch.bfloat16), t("uk")]
    valid = torch.from_numpy(x["valid"])
    if with_bias:
        ops.append(t("bias"))
        out = ra.RelationAttentionFunction.apply(
            *ops, valid, lambda q, k, v, uk, bias, vl: ra.reference_relation_attention_tiled(
                q, k, v, uk, bias, vl))
    else:
        out = ra.RelationAttentionFunction.apply(
            *ops, None, valid, lambda q, k, v, uk, vl: ra.reference_relation_attention_tiled(
                q, k, v, uk, None, vl))
    (out * torch.from_numpy(x["cot"])).sum().backward()
    for i in range(3):
        want_out, want_grads = jax_lane(i)
        np.testing.assert_allclose(out[i].detach().numpy(), np.asarray(want_out), rtol=0,
                                   atol=ATOL_FWD, err_msg=f"forward lane {i}")
        for name, op, want in zip(names, ops, want_grads):
            assert op.grad.dtype == op.dtype, name  # each gradient in its input's dtype
            _assert_grad_close(op.grad[i].float(), want, f"d{name} lane {i}")
    assert out[2].abs().max() == 0.0  # the lane with no valid ref
    assert all(op.grad[2].abs().max() == 0.0 for op in ops)


def test_functions_refuse_direct_grad_and_count_launches():
    """The forward wrappers keep raising on operands that require grad; the
    Functions launch their forward once a call and nothing in backward."""
    x = _lanes(45)
    q = torch.from_numpy(x["q"]).to(torch.bfloat16).requires_grad_()
    k, v = (torch.from_numpy(x[n]).to(torch.bfloat16) for n in ("k", "v"))
    uk, valid = torch.from_numpy(x["uk"]), torch.from_numpy(x["valid"])
    with pytest.raises(ValueError, match="inference-only"):
        ra.flash_relation_attention(q, k, v, uk, valid)
    calls = []

    def launch(*args):
        calls.append(1)
        return ra.reference_relation_attention(*args[:4], None, args[4])

    ra.RelationAttentionFunction.apply(q, k, v, uk, None, valid, launch).sum().backward()
    assert len(calls) == 1 and q.grad is not None


@pytest.mark.parametrize("use_position,use_u", [(True, True), (False, True), (True, False)])
def test_relation_attention_module_grads_equal_jax(use_position, use_u):
    """RelationAttention(precise_bias=True) on the CPU (the einsum path with
    the f32-sinusoid bias, in both packages), f32: the gradients of every
    parameter and of both feature inputs."""
    feat, m = G * D, 50  # u (g, E) meets k per group: d = embed_dim
    rs = np.random.RandomState(3)
    roi = rs.randn(N, feat).astype(np.float32)
    ref = rs.randn(m, feat).astype(np.float32)
    valid = rs.rand(m) > 0.2
    rois = (np.abs(rs.randn(N, 4)) * 30 + np.array([0, 0, 40, 40])).astype(np.float32)
    refs = (np.abs(rs.randn(m, 4)) * 30 + np.array([0, 0, 40, 40])).astype(np.float32)
    cot = rs.randn(N, feat).astype(np.float32)
    jax_mod = JaxAttention(feat_dim=feat, embed_dim=64, groups=G, use_position=use_position,
                           use_u_bias=use_u)
    pos = (jnp.asarray(rois), jnp.asarray(refs)) if use_position else None
    params = jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(roi), jnp.asarray(ref),
                          jnp.asarray(valid), pos_rois=pos, precise_bias=True)["params"]

    def loss(p, a, b):
        out = jax_mod.apply({"params": p}, a, b, jnp.asarray(valid), pos_rois=pos,
                            precise_bias=True)
        return jnp.sum(out * cot)

    want_p, want_roi, want_ref = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(roi), jnp.asarray(ref))

    mod = RelationAttention(feat, 64, G, use_position, use_u_bias=use_u)
    mod.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    a = torch.from_numpy(roi)[None].requires_grad_()
    b = torch.from_numpy(ref)[None].requires_grad_()
    out = mod(a, b, torch.from_numpy(valid)[None],
              pos_rois=(torch.from_numpy(rois)[None], torch.from_numpy(refs)[None])
              if use_position else None, precise_bias=True)
    (out[0] * torch.from_numpy(cot)).sum().backward()

    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want_p))
    got = dict(mod.named_parameters())
    assert set(want) == set(got)
    # Wk's bias moves every ref's logit alike, so its true gradient is 0 and
    # both packages give cancellation noise: leaves are held relative to
    # their own scale, floored at 1e-3 of the largest leaf's
    floor = 1e-3 * max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        scale = max(w.abs().max().item(), floor)
        err = (got[name].grad - w).abs().max().item() / scale
        assert err < 1e-4, (name, err)
    for g, w in ((a.grad[0], want_roi), (b.grad[0], want_ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4 * np.abs(np.asarray(w)).max())
