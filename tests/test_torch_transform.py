"""The torch port's transforms (losslessh264_tpu_torch/ops/transform.py)
are element-exact vs the JAX package's (losslessh264_tpu/ops/transform.py)
on the same numpy inputs, scaling lists and 8x8 included. Inputs follow
the recipes of tests/test_jax_ops.py; neither in-repo stream carries 8x8
transforms or scaling lists, so these are their only coverage."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from losslessh264_tpu import decoder_np as dn
from losslessh264_tpu.ops import transform as jt
from losslessh264_tpu_torch.ops import transform as tt

# one torch thread per test worker (see tests/test_torch_decoder.py)
torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.asarray(a))


def eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _weights(rng, kind):
    if kind == "flat4":
        return np.full((4, 4), 16, np.int32)
    if kind == "flat8":
        return np.full((8, 8), 16, np.int32)
    if kind == "list4":
        return dn._weights4(rng.integers(4, 60, (16,)).astype(np.int32))
    return dn._weights8(rng.integers(4, 60, (64,)).astype(np.int32))


@pytest.mark.parametrize("kind", ["flat4", "list4"])
def test_dequant4_idct4(kind):
    rng = np.random.default_rng(7)
    coeff = rng.integers(-256, 256, (64, 4, 4)).astype(np.int16)
    qps = rng.integers(0, 52, (64,))
    w = _weights(rng, kind)
    want = jt.idct4x4(jt.dequant4(coeff, qps, w))
    eq(tt.idct4x4(tt.dequant4(T(coeff), T(qps), T(w))), want)
    eq(tt.dequant4(T(coeff), T(qps), T(w)), jt.dequant4(coeff, qps, w))


def test_recon_residual_frame():
    """Dequant + IDCT with flat weights over a frame's 4x4 blocks, qp per
    block and broadcast from one value, every qp 0-51."""
    rng = np.random.default_rng(9)
    coeff = rng.integers(-2048, 2048, (52, 6, 4, 4)).astype(np.int16)
    qps = np.broadcast_to(np.arange(52)[:, None], (52, 6)).copy()
    eq(tt.recon_residual_frame(T(coeff), T(qps)),
       jt.recon_residual_frame(coeff, qps))
    eq(tt.recon_residual_frame(T(coeff[7]), T(np.int32(30))),
       jt.recon_residual_frame(coeff[7], np.int32(30)))


@pytest.mark.parametrize("kind", ["flat8", "list8"])
def test_dequant8_idct8(kind):
    rng = np.random.default_rng(8)
    coeff = rng.integers(-256, 256, (32, 8, 8)).astype(np.int16)
    qps = rng.integers(0, 52, (32,))
    w = _weights(rng, kind)
    eq(tt.dequant8(T(coeff), T(qps), T(w)), jt.dequant8(coeff, qps, w))
    eq(tt.idct8x8(tt.dequant8(T(coeff), T(qps), T(w))),
       jt.idct8x8(jt.dequant8(coeff, qps, w)))


def test_luma_dc():
    rng = np.random.default_rng(9)
    dc = rng.integers(-256, 256, (32, 4, 4)).astype(np.int16)
    qps = rng.integers(0, 52, (32,))
    eq(tt.hadamard4x4(T(dc)), jt.hadamard4x4(dc))
    for w00 in (16, 37):
        eq(tt.luma_dc_dequant(tt.hadamard4x4(T(dc)), T(qps), w00),
           jt.luma_dc_dequant(jt.hadamard4x4(dc), qps, np.int32(w00)))


def test_chroma_dc():
    rng = np.random.default_rng(10)
    dc = rng.integers(-128, 128, (32, 2, 2)).astype(np.int16)
    qps = rng.integers(0, 40, (32,))
    for w00 in (16, 23):
        eq(tt.chroma_dc_transform_dequant(T(dc), T(qps), w00),
           jt.chroma_dc_transform_dequant(dc, qps, np.int32(w00)))


def _mb_planes(seed, n):
    rng = np.random.default_rng(seed)
    return dict(
        cls=rng.integers(0, 9, (n,)).astype(np.uint8),
        qp=rng.integers(0, 52, (n,)).astype(np.uint8),
        cbp_luma=rng.integers(0, 16, (n,)).astype(np.uint8),
        cbp_chroma=rng.integers(0, 3, (n,)).astype(np.uint8),
        transform8=rng.integers(0, 2, (n,)).astype(np.uint8),
        luma_ac=rng.integers(-40, 40, (n, 16, 4, 4)).astype(np.int16),
        luma_dc=rng.integers(-200, 200, (n, 4, 4)).astype(np.int16),
        luma8=rng.integers(-40, 40, (n, 4, 8, 8)).astype(np.int16),
        chroma_ac=rng.integers(-40, 40, (n, 8, 4, 4)).astype(np.int16),
        chroma_dc=rng.integers(-200, 200, (n, 2, 2, 2)).astype(np.int16),
        w4=[_weights(rng, "list4") for _ in range(6)],
        w8=[_weights(rng, "list8") for _ in range(2)],
        offs=(int(rng.integers(-12, 13)), int(rng.integers(-12, 13))))


@pytest.mark.parametrize("seed,scaling", [(0, False), (1, True), (2, True)])
def test_luma_residuals(seed, scaling):
    p = _mb_planes(seed, 24)
    w4 = p["w4"] if scaling else [_weights(None, "flat4")] * 6
    w8 = p["w8"] if scaling else [_weights(None, "flat8")] * 2
    want = jt.luma_residuals(
        jnp.asarray(p["cls"]).astype(jnp.int32), jnp.asarray(p["qp"]),
        jnp.asarray(p["cbp_luma"]).astype(jnp.int32),
        jnp.asarray(p["transform8"]).astype(jnp.int32),
        jnp.asarray(p["luma_ac"]), jnp.asarray(p["luma_dc"]),
        jnp.asarray(p["luma8"]), w4[0], w4[3], w8[0], w8[1])
    got = tt.luma_residuals(
        T(p["cls"]), T(p["qp"]), T(p["cbp_luma"]), T(p["transform8"]),
        T(p["luma_ac"]), T(p["luma_dc"]), T(p["luma8"]), T(w4[0]),
        T(w4[3]), T(w8[0]), T(w8[1]))
    eq(got, want)


@pytest.mark.parametrize("seed,scaling", [(3, False), (4, True)])
def test_chroma_residuals(seed, scaling):
    p = _mb_planes(seed, 24)
    w4 = p["w4"] if scaling else [_weights(None, "flat4")] * 6
    o1, o2 = p["offs"]
    want = jt.chroma_residuals(
        jnp.asarray(p["cls"]).astype(jnp.int32), jnp.asarray(p["qp"]),
        jnp.asarray(p["cbp_chroma"]).astype(jnp.int32),
        jnp.asarray(p["chroma_ac"]), jnp.asarray(p["chroma_dc"]), o1, o2,
        w4[1], w4[2], w4[4], w4[5])
    got = tt.chroma_residuals(
        T(p["cls"]), T(p["qp"]), T(p["cbp_chroma"]), T(p["chroma_ac"]),
        T(p["chroma_dc"]), o1, o2, T(w4[1]), T(w4[2]), T(w4[4]), T(w4[5]))
    for g, w in zip(got, want):
        eq(g, w)


# ---------------------------------------------------------------------------
# forward half (the encoder's): every qp 0-51, realistic and extreme
# coefficients. JAX runs with 64-bit types off, so its int64 casts compute
# in int32 and wrap; the extremes pin the port to the same wrap.
# ---------------------------------------------------------------------------
def _coeffs(rng, shape, lim=9180):
    """Transform-range values, with a few extreme ones mixed in."""
    W = rng.integers(-lim, lim + 1, shape).astype(np.int32)
    flat = W.reshape(-1)
    ext = np.array([0, 1, -1, lim, -lim, 1 << 17, -(1 << 17), (1 << 24) + 3,
                    -(1 << 26), (1 << 31) - 1, -(1 << 31)], np.int32)
    pos = rng.choice(flat.size, ext.size, replace=False)
    flat[pos] = ext
    return W


def test_fdct4x4_and_zigzag():
    rng = np.random.default_rng(20)
    res = rng.integers(-255, 256, (64, 4, 4)).astype(np.int32)
    eq(tt.fdct4x4(T(res)), jt.fdct4x4(res))
    eq(tt.zigzag4(T(res)), jt.zigzag4(res))


@pytest.mark.parametrize("intra,skip_dc", [(True, False), (False, False),
                                           (True, True), ("mixed", True)])
def test_quant4_every_qp(intra, skip_dc):
    rng = np.random.default_rng(21)
    W = _coeffs(rng, (52, 8, 4, 4))
    qp = np.repeat(np.arange(52), 8).reshape(52, 8)
    if intra == "mixed":
        intra = rng.integers(0, 2, (52, 8)).astype(bool)
        j_intra, t_intra = intra, T(intra)
    else:
        j_intra = t_intra = intra
    eq(tt.quant4(T(W), T(qp), t_intra, skip_dc=skip_dc),
       jt.quant4(W, qp, j_intra, skip_dc=skip_dc))


def test_luma_dc_forward_every_qp():
    rng = np.random.default_rng(22)
    X = _coeffs(rng, (52, 4, 4), lim=4080)     # the 16 DCs of an MB
    qp = np.arange(52)
    eq(tt.fhadamard4x4(T(X)), jt.fhadamard4x4(X))
    eq(tt.quant_dc4(tt.fhadamard4x4(T(X)), T(qp)),
       jt.quant_dc4(jt.fhadamard4x4(X), qp))


def test_chroma_dc_forward_every_qp():
    rng = np.random.default_rng(23)
    X = _coeffs(rng, (2, 52, 2, 2), lim=4080)
    qp = np.stack([np.arange(52)] * 2)
    eq(tt.fhadamard2x2(T(X)), jt.fhadamard2x2(X))
    eq(tt.quant_dc2(tt.fhadamard2x2(T(X)), T(qp)),
       jt.quant_dc2(jt.fhadamard2x2(X), qp))


@pytest.mark.parametrize("rd_lam,qps", [(None, (0, 52)), (144, (0, 52)),
                                        (144, (45, 52)), (300, (45, 52))])
@pytest.mark.parametrize("skip_dc", [False, True])
def test_quant4_pm(rd_lam, qps, skip_dc):
    """The inter path's position-major quantizer; with rd_lam at qp 45-51
    `u << 8` overflows int32 and wraps (qbits 22-23)."""
    rng = np.random.default_rng(24 + qps[0])
    B = 416
    W = _coeffs(rng, (16, B))
    qp = rng.integers(qps[0], qps[1], (B,))
    want = jt.quant4_pm(W, qp, False, skip_dc=skip_dc, rd_lam=rd_lam)
    eq(tt.quant4_pm(T(W), T(qp), False, skip_dc=skip_dc, rd_lam=rd_lam),
       want)


def test_pm_transforms_roundtrip():
    rng = np.random.default_rng(25)
    B = 300
    r = rng.integers(-255, 256, (16, B)).astype(np.int32)
    qp = rng.integers(0, 52, (B,))
    eq(tt.fdct4x4_pm(T(r)), jt.fdct4x4_pm(r))
    q = np.asarray(jt.quant4_pm(jt.fdct4x4_pm(r), qp, False))
    eq(tt.dequant4_pm(T(q), T(qp), 16), jt.dequant4_pm(q, qp, np.int32(16)))
    deq = np.asarray(jt.dequant4_pm(q, qp, np.int32(16)))
    eq(tt.idct4x4_pm(T(deq)), jt.idct4x4_pm(deq))
    # the position-major inverse equals the block one
    blocks = deq.T.reshape(B, 4, 4)
    eq(tt.idct4x4_pm(T(deq)).T.reshape(B, 4, 4), jt.idct4x4(blocks))
