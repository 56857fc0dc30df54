"""The port's kernel modules against the JAX Pallas kernels.

On the CPU the Pallas kernels run in interpret mode and the port's wrappers
take their plain PyTorch versions (the only path a CPU tensor has). The CUDA
kernels against those plain versions: test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_pytorch_tpu.ops.pallas.position_bias import (
    reference_position_bias as jax_position_bias,
)
from mega_pytorch_tpu.ops.pallas.relation_attention import (
    _fused_fwd_batched,
    _wh_factors,
    reference_relation_attention as jax_reference_attention,
)
from mega_pytorch_tpu.ops.pallas.stem_pool import stem_pool_packed as jax_stem_pool
from mega_pytorch_tpu_torch.ops.kernels import relation_attention as ra
from mega_pytorch_tpu_torch.ops.kernels import stem_pool as sp
from mega_pytorch_tpu_torch.ops.kernels.position_bias import reference_position_bias

torch.set_num_threads(2)

B, G, N, M, D, E = 2, 16, 37, 300, 64, 64
ATOL_NONE, ATOL_POS, ATOL_TWIN = 6e-3, 2e-2, 1e-3
ATOL_TILED = 1e-3  # same rounding of p; f32 sums in another order


def _attention_data(seed=0, b=B, n=N, m=M):
    rs = np.random.RandomState(seed)

    def boxes(count):
        return (np.abs(rs.randn(b, count, 4)) * 50
                + np.array([0, 0, 60, 60])).astype(np.float32)

    valid = rs.rand(b, m) > 0.2
    valid[1, : m // 2] = False  # lanes with different valid sets
    return dict(
        q=rs.randn(b, G, n, D).astype(np.float32),
        k=rs.randn(b, G, m, D).astype(np.float32),
        v=rs.randn(b, G, m, D).astype(np.float32),
        uk=(rs.randn(b, G, m) * 0.1).astype(np.float32),
        rois=boxes(n), refs=boxes(m),
        wk=(rs.randn(E, G) * 0.05).astype(np.float32),
        wb=(rs.rand(G) * 0.1).astype(np.float32),
        valid=valid,
    )


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pos_args(x):
    return (_t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["uk"]), _t(x["rois"]),
            _t(x["refs"]), _t(x["wk"]), _t(x["wb"]), _t(x["valid"]))


def _jax_flash(x, pos: bool):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    bias = (j["rois"], j["refs"], j["wk"], j["wb"]) if pos else None
    return np.asarray(_fused_fwd_batched(
        j["q"], j["k"], j["v"], j["uk"], bias, j["valid"], embed_dim=E,
        interpret=True))


@pytest.mark.parametrize("t_rows", [10, 7])
def test_stem_pool_plain_matches_pallas_exactly(t_rows):
    """f32, with a T that the Pallas tile (5 rows) does not divide."""
    o, u = 16, 12
    rs = np.random.RandomState(7)
    y = rs.randn(2, t_rows, u, 4 * o).astype(np.float32) * 2
    scale = np.tile(rs.rand(o) + 0.5, 4).astype(np.float32)
    shift = np.tile(rs.randn(o), 4).astype(np.float32)
    want = np.asarray(jax_stem_pool(jnp.asarray(y), jnp.asarray(scale),
                                    jnp.asarray(shift), o, tile_h=5,
                                    interpret=True))
    with torch.inference_mode():
        got = sp.stem_pool_packed(_t(y), _t(scale), _t(shift), o).numpy()
    assert got.shape == (2, t_rows, u, o)
    np.testing.assert_array_equal(got, want)


def test_stem_pool_rejects_grad_and_bad_shapes():
    y = torch.zeros(1, 4, 4, 32, requires_grad=True)
    s = torch.ones(32)
    with pytest.raises(ValueError):
        sp.stem_pool_packed(y, s, s, 8)
    with pytest.raises(ValueError):
        sp.stem_pool_packed(torch.zeros(1, 4, 4, 30), s, s, 8)


def test_attention_none_plain_matches_pallas():
    x = _attention_data()
    want = _jax_flash(x, pos=False)
    got = ra.flash_relation_attention(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                                      _t(x["uk"]), _t(x["valid"])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_NONE)


def test_attention_compute_plain_matches_pallas():
    x = _attention_data(1)
    want = _jax_flash(x, pos=True)
    got = ra.flash_relation_attention_pos(*_pos_args(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_POS)


@pytest.mark.parametrize("sin_dtype", ["float32", "bfloat16"])
def test_plain_twins_match_jax_references(sin_dtype):
    """The port's plain bias + attention against the JAX package's plain
    twins (per lane, same sinusoid dtype)."""
    x = _attention_data(2)
    jdt, tdt = getattr(jnp, sin_dtype), getattr(torch, sin_dtype)
    bias_t = reference_position_bias(_t(x["rois"]), _t(x["refs"]), _t(x["wk"]),
                                     _t(x["wb"]), E, sin_dtype=tdt)
    got = ra.reference_relation_attention(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                                          _t(x["uk"]), bias_t, _t(x["valid"]))
    for lane in range(B):
        j = {k: jnp.asarray(v[lane]) for k, v in x.items() if k not in ("wk", "wb")}
        bias_j = jax_position_bias(j["rois"], j["refs"], jnp.asarray(x["wk"]),
                                   jnp.asarray(x["wb"]), E, sin_dtype=jdt)
        # the position weight pw = exp(log bias); the log itself is
        # ill-conditioned where relu leaves pw near its 1e-6 floor
        np.testing.assert_allclose(np.exp(bias_t[lane].numpy()),
                                   np.exp(np.asarray(bias_j)), rtol=0,
                                   atol=ATOL_TWIN)
        want = jax_reference_attention(j["q"], j["k"], j["v"], j["uk"], bias_j,
                                       j["valid"])
        np.testing.assert_allclose(got[lane].numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_TWIN, err_msg=f"lane {lane}")


@pytest.mark.parametrize("n,m,qk_scale", [(37, 5, 1.0), (65, 130, 1.0), (20, 300, 4.0)])
@pytest.mark.parametrize("mode", ["none", "input"])
def test_tiled_plain_version_matches_pallas_rounding(mode, n, m, qk_scale):
    """The tiled plain version against the Pallas kernel run with 64-ref
    tiles: the same rounding of p. The flat plain version rounds the
    normalised softmax, and stays within 2^-7 max|v| of the kernel (two
    roundings to bf16, unit roundoff 2^-8 each)."""
    x = _attention_data(20, n=n, m=m)
    x["q"] *= qk_scale
    x["k"] *= qk_scale
    x["uk"] *= 80  # at the scale of q.k
    rs = np.random.RandomState(21)
    bias = (np.log(np.maximum(rs.randn(B, G, n, m) * 0.5 + 0.3, 0.0) + 1e-6)
            .astype(np.float32) if mode == "input" else None)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = np.asarray(_fused_fwd_batched(
        j["q"], j["k"], j["v"], j["uk"], None if bias is None else jnp.asarray(bias),
        j["valid"], embed_dim=E, tile_m=64, interpret=True))
    args = (_t(x["q"]), _t(x["k"]), _t(x["v"]), _t(x["uk"]),
            None if bias is None else _t(bias), _t(x["valid"]))
    tiled = ra.reference_relation_attention_tiled(*args).numpy()
    np.testing.assert_allclose(tiled, want, rtol=0, atol=ATOL_TILED)
    flat = ra.reference_relation_attention(*args).numpy()
    bound = 2.0 ** -7 * float(ra._bf16(_t(x["v"])).abs().max())
    assert np.abs(flat - want).max() <= bound


@pytest.mark.parametrize("name", ["q", "k", "v", "bias"])
def test_kernel_checks_reject_misaligned_operands(name):
    """The checks the CUDA wrappers run before a launch: q, k and v start on
    16 bytes, the bias on 8; a contiguous view one element in is refused."""
    b, n, m = 2, 5, 7
    ops = dict(q=torch.zeros(b, G, n, D, dtype=torch.bfloat16),
               k=torch.zeros(b, G, m, D, dtype=torch.bfloat16),
               v=torch.zeros(b, G, m, D, dtype=torch.bfloat16),
               bias=torch.zeros(b, G, n, m))
    uk, valid = torch.zeros(b, G, m), torch.ones(b, m, dtype=torch.bool)
    ra._check(ops["q"], ops["k"], ops["v"], uk, valid, (ops["bias"],))
    ra._check_bias(ops["q"], ops["k"], ops["bias"])
    t = ops[name]
    ops[name] = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    assert ops[name].is_contiguous() and ops[name].storage_offset() == 1
    with pytest.raises(ValueError, match="byte boundary"):
        ra._check(ops["q"], ops["k"], ops["v"], uk, valid, (ops["bias"],))
        ra._check_bias(ops["q"], ops["k"], ops["bias"])


def test_all_invalid_refs_give_exact_zeros():
    x = _attention_data(3)
    x["valid"][:] = False
    none = ra.flash_relation_attention(_t(x["q"]), _t(x["k"]), _t(x["v"]),
                                       _t(x["uk"]), _t(x["valid"]))
    pos = ra.flash_relation_attention_pos(*_pos_args(x))
    assert float(none.abs().max()) == 0.0
    assert float(pos.abs().max()) == 0.0
    assert float(np.abs(_jax_flash(x, pos=False)).max()) == 0.0


@pytest.mark.parametrize("n,m,seed", [(37, 300, 22), (65, 130, 23)])
def test_tiled_pos_plain_version_matches_pallas(n, m, seed):
    """Mode "compute" in the kernel's arithmetic against the Pallas kernel
    run with 64-ref tiles, ragged on both axes: the multiplicative form
    p = exp(s - max of the qk logits) * pw with p * pw rounded to bf16 before
    PV, the separable dw/dh term, relu and + 1e-6."""
    x = _attention_data(seed, n=n, m=m)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    want = np.asarray(_fused_fwd_batched(
        j["q"], j["k"], j["v"], j["uk"], (j["rois"], j["refs"], j["wk"], j["wb"]),
        j["valid"], embed_dim=E, tile_m=64, interpret=True))
    got = ra.reference_relation_attention_pos_tiled(*_pos_args(x),
                                                    wh_dtype=torch.bfloat16).numpy()
    # Both round p * pw, S and T to bf16, with f32 dx/dy features.
    # pw differs in its last f32 bits (the Pallas polynomial sine, |error| <
    # 2e-4, against torch.sin; w / w' against the reciprocal), which can move
    # a p * pw across a bf16 rounding boundary: one step, 2^-8, of a ref
    # that carries a row moves the row by up to 2^-8 max|v| (5.1e-3 seen,
    # where one ref carries 36 % of a row).
    atol = 2.0 ** -8 * float(np.abs(ra._bf16(_t(x["v"])).numpy()).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_wh_factors_match_jax():
    """S and T of the port against the JAX package's ``_wh_factors``, T
    rounded to bf16 as there (the kernel keeps fp16). S is f32: the two
    sines differ by the Pallas polynomial's error (< 2e-4). T is rounded to
    bf16 in both, so that error can move a value across one rounding
    boundary: 2^-9 at |T| < 0.5."""
    x = _attention_data(24)
    s_j, t_j = _wh_factors(jnp.asarray(x["rois"]), jnp.asarray(x["refs"]),
                           jnp.asarray(x["wk"]), E // 8)
    s, t = ra.wh_factors(_t(x["rois"]), _t(x["refs"]), _t(x["wk"]), torch.bfloat16)
    assert s.shape == (B, N, 32) and s.dtype == torch.float32
    assert t.shape == (B, G, 32, M) and t.dtype == torch.bfloat16
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=0, atol=2e-4)
    t_want = np.asarray(t_j.astype(jnp.float32))
    assert np.abs(t_want).max() < 0.5
    np.testing.assert_allclose(t.float().numpy(), t_want, rtol=0, atol=2.0 ** -9 + 2e-4)


@pytest.mark.parametrize("n,m,seed", [(37, 300, 25), (65, 3750, 26)])
def test_tiled_pos_plain_version_within_flat(n, m, seed):
    """The tiled plain version of mode "compute" within ATOL_POS of the flat
    f32 one (additive log bias, softmax rounded after normalising), the
    tolerance the card holds the kernel to against the flat version."""
    x = _attention_data(seed, n=n, m=m)
    args = _pos_args(x)
    tiled = ra.reference_relation_attention_pos_tiled(*args).numpy()
    flat = ra.reference_relation_attention_pos(*args).numpy()
    np.testing.assert_allclose(tiled, flat, rtol=0, atol=ATOL_POS)
