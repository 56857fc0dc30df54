"""The port's two newest kernel modules against the JAX Pallas kernels, and
``RelationAttention(pos_emb=...)`` against the JAX module.

On the CPU the Pallas kernels run in interpret mode and the port's wrappers
take their plain PyTorch versions: ``fused_position_bias`` (the standalone
log position bias) and ``flash_relation_attention_bias`` (the flash
attention's mode "input", a precomputed additive log bias). The CUDA kernels
against those plain versions: test_torch_kernels_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.models.roi_heads.attention import (
    RelationAttention as JaxRelationAttention,
)
from mega_pytorch_tpu.models.roi_heads.attention import position_embedding
from mega_pytorch_tpu.ops.pallas.position_bias import (
    fused_position_bias as jax_fused_position_bias,
)
from mega_pytorch_tpu.ops.pallas.relation_attention import _fused_fwd_batched
from mega_pytorch_tpu_torch.models.roi_heads.attention import (
    RelationAttention,
    position_embedding as port_position_embedding,
)
from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
from mega_pytorch_tpu_torch.ops.kernels.position_bias import fused_position_bias
from mega_pytorch_tpu_torch.utils.bridge import state_dict_from_flax
from torch_port_harness import to_np

torch.set_num_threads(2)

G, D = 16, 64
ATOL_INPUT = 6e-3  # bf16 QK/PV operands, as mode "none"
# the standalone bias in weight space (exp of the log): the log is
# ill-conditioned where relu leaves the weight at its 1e-6 floor, as in
# tests/test_attention.py
RTOL_BIAS, ATOL_BIAS = 5e-3, 6e-3
ATOL_MODULE = 2e-3  # tests/test_attention.py's pos_emb parity tolerance


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _boxes(rs, *lead):
    xy = rs.rand(*lead, 2) * 200
    return np.concatenate([xy, xy + 4 + rs.rand(*lead, 2) * 120], -1).astype(np.float32)


@pytest.mark.parametrize("n,m", [(40, 300), (7, 13)])
def test_fused_position_bias_plain_matches_pallas(n, m):
    rs = np.random.RandomState(5)
    rois, refs = _boxes(rs, n), _boxes(rs, m)
    wk = (rs.randn(64, G) * 0.05).astype(np.float32)
    wb = (rs.randn(G) * 0.01).astype(np.float32)
    want = np.asarray(jax_fused_position_bias(
        jnp.asarray(rois), jnp.asarray(refs), jnp.asarray(wk), jnp.asarray(wb),
        tile_n=16, tile_m=128, interpret=True))
    got = fused_position_bias(_t(rois), _t(refs), _t(wk), _t(wb)).numpy()
    assert got.shape == want.shape == (G, n, m) and got.dtype == np.float32
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=RTOL_BIAS, atol=ATOL_BIAS)


def test_attention_input_bias_plain_matches_pallas():
    rs = np.random.RandomState(6)
    b, n, m = 2, 37, 300
    x = dict(
        q=rs.randn(b, G, n, D), k=rs.randn(b, G, m, D), v=rs.randn(b, G, m, D),
        uk=rs.randn(b, G, m) * 0.1,
        # a log bias in the range log(relu(.) + 1e-6) gives
        bias=np.log(np.maximum(rs.randn(b, G, n, m) * 0.5 + 0.3, 0.0) + 1e-6),
    )
    x = {k: v.astype(np.float32) for k, v in x.items()}
    valid = rs.rand(b, m) > 0.2
    valid[1, : m // 2] = False
    want = np.asarray(_fused_fwd_batched(
        *(jnp.asarray(x[k]) for k in ("q", "k", "v", "uk", "bias")),
        jnp.asarray(valid), interpret=True))
    got = ra.flash_relation_attention_bias(
        *(_t(x[k]) for k in ("q", "k", "v", "uk", "bias")), _t(valid)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_INPUT)
    none = ra.flash_relation_attention_bias(
        *(_t(x[k]) for k in ("q", "k", "v", "uk", "bias")), _t(np.zeros_like(valid)))
    assert float(none.abs().max()) == 0.0


def test_relation_attention_pos_emb_matches_jax():
    """Two lanes of the shapes of tests/test_attention.py (N=9, M=21), each
    against the JAX module on that lane."""
    rs = np.random.RandomState(1)
    lanes, n, m = 2, 9, 21
    roi = rs.randn(lanes, n, 1024).astype(np.float32)
    ref = rs.randn(lanes, m, 1024).astype(np.float32)
    valid = rs.rand(lanes, m) > 0.3
    emb = np.stack([np.asarray(position_embedding(jnp.asarray(_boxes(rs, n)),
                                                  jnp.asarray(_boxes(rs, m))))
                    for _ in range(lanes)])  # (L, N, M, 64)
    jmod = JaxRelationAttention(use_position=True, use_u_bias=True)
    params = to_np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(roi[0]),
                             jnp.asarray(ref[0]), jnp.asarray(valid[0]),
                             pos_emb=jnp.asarray(emb[0]))["params"])
    params["Wv_kernel"] = params["Wv_kernel"] * 3  # values of order 1
    params["Wg"]["kernel"] = params["Wg"]["kernel"] * 20  # weights off the relu floor
    params["Wg"]["bias"] = np.full_like(params["Wg"]["bias"], 0.1)
    port = RelationAttention(use_position=True)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    port.eval().requires_grad_(False)
    with torch.inference_mode():
        got = port(_t(roi), _t(ref), _t(valid), pos_emb=_t(emb)).numpy()
    assert got.shape == (lanes, n, 1024)
    for lane in range(lanes):
        want = np.asarray(jmod.apply(
            {"params": params}, jnp.asarray(roi[lane]), jnp.asarray(ref[lane]),
            jnp.asarray(valid[lane]), pos_emb=jnp.asarray(emb[lane])))
        np.testing.assert_allclose(got[lane], want, rtol=0, atol=ATOL_MODULE,
                                   err_msg=f"lane {lane}")


def test_position_embedding_matches_jax():
    rs = np.random.RandomState(3)
    rois, refs = _boxes(rs, 2, 9), _boxes(rs, 2, 21)
    got = port_position_embedding(_t(rois), _t(refs)).numpy()
    assert got.shape == (2, 9, 21, 64)
    for lane in range(2):
        want = np.asarray(position_embedding(jnp.asarray(rois[lane]),
                                             jnp.asarray(refs[lane])))
        # sinusoids of arguments up to ~800 rad: one ulp of the argument
        # (XLA and PyTorch scale the frequencies in another order) is ~6e-5
        np.testing.assert_allclose(got[lane], want, rtol=0, atol=1e-3)
