"""The torch port's deblocking (losslessh264_tpu_torch/ops/deblock.py) is
element-exact vs the JAX package's (losslessh264_tpu/ops/deblock.py):
edge parameters, the edge filters, and whole frames through the plain
wavefront (K2's plain version) against JAX deblock_frame under both its
default (the scan formulation) and PIP_DEBLOCK=legacy. Random frames
follow tests/test_deblock_impls.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from losslessh264_tpu.ops import deblock as jdb
from losslessh264_tpu_torch.ops import deblock as tdb

# one torch thread per test worker (see tests/test_torch_decoder.py)
torch.set_num_threads(1)

KEYS = ("cls", "qp", "nnz", "mv", "ref_idx", "slice_id", "deblock_idc",
        "alpha_off", "beta_off", "transform8")


def _random_frame(mb_w, mb_h, seed=0):
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    P = jdb.WPAD
    Yw = rng.randint(0, 256, (H + 2 * P, W + 2 * P)).astype(np.int32)
    Uw = rng.randint(0, 256, (H // 2 + 2 * P, W // 2 + 2 * P)) \
        .astype(np.int32)
    Vw = rng.randint(0, 256, (H // 2 + 2 * P, W // 2 + 2 * P)) \
        .astype(np.int32)
    args = dict(
        cls=rng.randint(0, 9, (n,)).astype(np.int32),
        qp=rng.randint(10, 52, (n,)).astype(np.int32),
        nnz=rng.randint(0, 3, (n, 16)).astype(np.int32),
        mv=rng.randint(-16, 17, (n, 16, 2)).astype(np.int32),
        ref_idx=rng.randint(0, 2, (n, 16)).astype(np.int32),
        slice_id=(np.arange(n) // (mb_w * 2)).astype(np.int32),
        deblock_idc=rng.choice([0, 0, 0, 1, 2], (n,)).astype(np.int32),
        alpha_off=rng.randint(-6, 7, (n,)).astype(np.int32) * 2,
        beta_off=rng.randint(-6, 7, (n,)).astype(np.int32) * 2,
        transform8=rng.randint(0, 2, (n,)).astype(np.int32),
    )
    return Yw, Uw, Vw, args


def _jax(mb_w, mb_h, Yw, Uw, Vw, args, coff=0):
    out = jdb.deblock_frame(mb_w, mb_h, jnp.asarray(Yw), jnp.asarray(Uw),
                            jnp.asarray(Vw),
                            *[jnp.asarray(args[k]) for k in KEYS], coff)
    return [np.asarray(a) for a in out]


def _torch(mb_w, mb_h, Yw, Uw, Vw, args, coff=0):
    out = tdb.deblock_frame(mb_w, mb_h, torch.as_tensor(Yw),
                            torch.as_tensor(Uw), torch.as_tensor(Vw),
                            *[torch.as_tensor(args[k]) for k in KEYS], coff)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("mb_w,mb_h,seed,coff",
                         [(4, 3, 0, 0), (9, 4, 1, -3), (1, 5, 2, 4)])
def test_edge_params(mb_w, mb_h, seed, coff):
    _, _, _, a = _random_frame(mb_w, mb_h, seed)
    want = jdb._edge_params(mb_w, mb_h, *[jnp.asarray(a[k]) for k in KEYS],
                            coff)
    got = tdb._edge_params(mb_w, mb_h, *[torch.as_tensor(a[k])
                                         for k in KEYS], coff)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_edge_filters():
    rng = np.random.default_rng(5)
    E = 512
    base = rng.integers(20, 230, (1, E))
    p = (base + rng.integers(-12, 13, (4, E))).astype(np.int32)
    q = (base + rng.integers(-12, 13, (4, E))).astype(np.int32)
    bs = rng.integers(0, 5, (E,)).astype(np.int32)
    alpha = rng.integers(0, 60, (E,)).astype(np.int32)
    beta = rng.integers(0, 20, (E,)).astype(np.int32)
    tc0 = rng.integers(0, 14, (E,)).astype(np.int32)
    T = torch.as_tensor
    want = jdb.filter_luma(p, q, bs, alpha, beta, tc0)
    got = tdb.filter_luma(T(p), T(q), T(bs), T(alpha), T(beta), T(tc0))
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jdb.filter_chroma(p[:2], q[:2], bs, alpha, beta, tc0)
    got = tdb.filter_chroma(T(p[:2]), T(q[:2]), T(bs), T(alpha), T(beta),
                            T(tc0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("impl", ["default", "legacy"])
@pytest.mark.parametrize("mb_w,mb_h,seed", [(9, 4, 0), (9, 4, 1),
                                            (12, 7, 0), (12, 7, 1),
                                            (22, 18, 0), (22, 18, 1)])
def test_deblock_frame_matches_jax(monkeypatch, impl, mb_w, mb_h, seed):
    if impl == "legacy":
        monkeypatch.setenv("PIP_DEBLOCK", "legacy")
    else:
        monkeypatch.delenv("PIP_DEBLOCK", raising=False)
    Yw, Uw, Vw, args = _random_frame(mb_w, mb_h, seed)
    want = _jax(mb_w, mb_h, Yw, Uw, Vw, args, coff=seed - 1)
    got = _torch(mb_w, mb_h, Yw, Uw, Vw, args, coff=seed - 1)
    for g, w, pl in zip(got, want, "YUV"):
        np.testing.assert_array_equal(g, w, err_msg=f"plane {pl}")


@pytest.mark.slow
@pytest.mark.parametrize("mb_w,mb_h", [(45, 30), (80, 45)])
def test_deblock_frame_large(mb_w, mb_h):
    Yw, Uw, Vw, args = _random_frame(mb_w, mb_h, 3)
    want = _jax(mb_w, mb_h, Yw, Uw, Vw, args)
    got = _torch(mb_w, mb_h, Yw, Uw, Vw, args)
    for g, w, pl in zip(got, want, "YUV"):
        np.testing.assert_array_equal(g, w, err_msg=f"plane {pl}")


def test_mb_corner_strong_filter(monkeypatch):
    """tests/test_deblock_impls.py::test_scan_mb_corner_strong_filter on
    the port: all-intra MBs (bS 4 at MB edges) on smooth content at high
    QP make the strong filter fire at every MB corner, where the 3x3
    pixels above-left of an MB are last written by its LEFT
    neighbour's top-edge filter."""
    mb_w, mb_h = 3, 3
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    P = jdb.WPAD
    yy, xx = np.mgrid[:H + 2 * P, :W + 2 * P]
    Yw = ((yy * 5 + xx * 3) // 4 % 180 + 30).astype(np.int32)
    cyy, cxx = np.mgrid[:H // 2 + 2 * P, :W // 2 + 2 * P]
    Uw = ((cyy * 7 + cxx * 2) // 3 % 150 + 40).astype(np.int32)
    Vw = ((cyy * 3 + cxx * 5) // 3 % 150 + 50).astype(np.int32)
    rng = np.random.RandomState(0)
    args = dict(
        cls=np.zeros((n,), np.int32),
        qp=rng.randint(38, 52, (n,)).astype(np.int32),
        nnz=np.ones((n, 16), np.int32),
        mv=np.zeros((n, 16, 2), np.int32),
        ref_idx=np.zeros((n, 16), np.int32),
        slice_id=np.zeros((n,), np.int32),
        deblock_idc=np.zeros((n,), np.int32),
        alpha_off=np.zeros((n,), np.int32),
        beta_off=np.zeros((n,), np.int32),
        transform8=np.zeros((n,), np.int32),
    )
    got = _torch(mb_w, mb_h, Yw, Uw, Vw, args)
    for impl in ("legacy", "scan"):
        monkeypatch.setenv("PIP_DEBLOCK", impl)
        want = _jax(mb_w, mb_h, Yw, Uw, Vw, args)
        for g, w, pl in zip(got, want, "YUV"):
            np.testing.assert_array_equal(g, w, err_msg=f"{impl} {pl}")
    assert not np.array_equal(got[0], Yw)   # the filter did fire

