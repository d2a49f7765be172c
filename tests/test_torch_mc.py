"""The torch port's motion compensation (losslessh264_tpu_torch/ops/mc.py)
is element-exact vs the JAX package's (losslessh264_tpu/ops/mc.py): the
half-pel planes (K1's plain version), the per-cell luma/chroma paths
with clipped MVs, the bucketed fast path, and the host plan copied
from the JAX module. Where JAX reaches the Pallas kernel, the module
attribute halfpel_planes_pallas is swapped for its plain twin
halfpel_planes, as the JAX package's own CPU runs would need."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from losslessh264_tpu.ops import mc as jmc
from losslessh264_tpu_torch.cases import (K11_CASES, k11_plain,
                                          random_cells_case)
from losslessh264_tpu_torch.ops import mc as tmc

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import gen_k11_jax_crc  # noqa: E402

# one torch thread per test worker (see tests/test_torch_decoder.py)
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def T(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture
def plain_pallas(monkeypatch):
    monkeypatch.setattr(jmc, "halfpel_planes_pallas", jmc.halfpel_planes)


@pytest.mark.parametrize("shape", [(6, 6), (42, 58), (101, 77), (84, 133)])
def test_halfpel_planes(shape):
    rng = np.random.default_rng(sum(shape))
    ref = rng.integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(jmc.halfpel_planes(ref))
    got = tmc.halfpel_planes_plain(T(ref))
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(tmc.halfpel_planes(T(ref)).numpy(), want)
    np.testing.assert_array_equal(tmc._halfpel_planes_u8(T(ref)).numpy(),
                                  want.astype(np.uint8))


@pytest.mark.parametrize("shape", [(6, 6), (101, 77), (84, 133),
                                   (112, 144)])
def test_halfpel_u8_is_pitched(shape):
    """The uint8 entry mc_bucketed reads hands back, on the CPU as on the
    card, the [4, Hp-5, Wp-5] view of planes whose rows are padded to a
    multiple of 16 bytes, with the JAX planes' values."""
    ref = np.random.default_rng(shape[0]).integers(0, 256, shape,
                                                   dtype=np.uint8)
    got = tmc._halfpel_planes_u8(T(ref))
    Ho, Wo = shape[0] - 5, shape[1] - 5
    assert got.shape == (4, Ho, Wo) and got.dtype == torch.uint8
    pitch = (Wo + 15) // 16 * 16
    assert got.stride() == (Ho * pitch, pitch, 1)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmc.halfpel_planes(ref)).astype(np.uint8))


def _cells(seed, H, W, pad, B, mv_span):
    rng = np.random.default_rng(seed)
    R = 3
    stack = np.stack([np.pad(rng.integers(0, 256, (H, W), dtype=np.uint8),
                             pad, mode="edge") for _ in range(R)])
    ys = rng.integers(0, H // 4, B) * 4 // (2 if H < 48 else 1)
    xs = rng.integers(0, W // 4, B) * 4 // (2 if H < 48 else 1)
    ref = rng.integers(0, R, B)
    mvx = rng.integers(-mv_span, mv_span, B)
    mvy = rng.integers(-mv_span, mv_span, B)
    return stack, ref, ys, xs, mvx, mvy


@pytest.mark.parametrize("mv_span", [40, 400])
def test_mc_luma_cells(mv_span):
    stack, ref, ys, xs, mvx, mvy = _cells(11, 64, 80, 32, 300, mv_span)
    want = jmc.mc_luma_cells(stack, 32, ref, ys, xs, mvx, mvy)
    got = tmc.mc_luma_cells(T(stack), 32, T(ref), T(ys), T(xs), T(mvx),
                            T(mvy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mv_span", [40, 400])
def test_mc_chroma_cells(mv_span):
    stack, ref, ys, xs, mvx, mvy = _cells(12, 32, 40, 16, 300, mv_span)
    want = jmc.mc_chroma_cells(stack, 16, ref, ys, xs, mvx, mvy)
    got = tmc.mc_chroma_cells(T(stack), 16, T(ref), T(ys), T(xs), T(mvx),
                              T(mvy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,mv_span", [(8, 60), (4, 60), (4, 300)])
def test_mc_chroma_mbs(size, mv_span):
    """The encoder's whole-block chroma MC; with mv_span 300 the window
    starts leave the plane and are clamped into it, as JAX clamps them."""
    rng = np.random.default_rng(13 + size + mv_span)
    H, W, pad = 32, 48, 16
    ref_pad = np.pad(rng.integers(0, 256, (H, W), dtype=np.uint8), pad,
                     mode="edge")
    n = 120
    cy0 = rng.integers(0, H // size, n) * size
    cx0 = rng.integers(0, W // size, n) * size
    mvx = rng.integers(-mv_span, mv_span + 1, n)
    mvy = rng.integers(-mv_span, mv_span + 1, n)
    want = jmc.mc_chroma_mbs(ref_pad, pad, cy0, cx0, mvx, mvy, size=size)
    got = tmc.mc_chroma_mbs(T(ref_pad), pad, T(cy0), T(cx0), T(mvx), T(mvy),
                            size=size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,mv_span", [(16, 60), (8, 60), (16, 400),
                                          (8, 400)])
def test_mc_luma_mbs(size, mv_span):
    """Whole-block luma MC from the half-pel planes; with mv_span 400 the
    window starts leave the planes and are clamped into them, as JAX
    clamps them."""
    rng = np.random.default_rng(17 + size + mv_span)
    H, W, pad = 48, 64, 32
    planes = np.asarray(jmc.halfpel_planes(np.pad(
        rng.integers(0, 256, (H, W), dtype=np.uint8), pad, mode="edge")))
    n = 150
    y0 = rng.integers(0, H // size, n) * size
    x0 = rng.integers(0, W // size, n) * size
    mvx = rng.integers(-mv_span, mv_span + 1, n)
    mvy = rng.integers(-mv_span, mv_span + 1, n)
    want = jmc.mc_luma_mbs(planes, pad, y0, x0, mvx, mvy, size=size)
    got = tmc.mc_luma_mbs(T(planes), pad, T(y0), T(x0), T(mvx), T(mvy),
                          size=size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _bucket_case(trial, n_mvs):
    """The recipe of tests/test_jax_ops.py::test_mc_bucketed_parity."""
    rng = np.random.RandomState(7 + trial)
    mb_w, mb_h, pad, R = 6, 5, 32, 4
    n = mb_w * mb_h
    ref_y = rng.randint(0, 255, (R, mb_h * 16 + 2 * pad,
                                 mb_w * 16 + 2 * pad), np.uint8)
    ref_u = rng.randint(0, 255, (R, mb_h * 8 + pad, mb_w * 8 + pad),
                        np.uint8)
    ref_v = rng.randint(0, 255, ref_u.shape, np.uint8)
    mvset = rng.randint(-100, 100, (n_mvs, 2))
    mv = mvset[rng.randint(0, n_mvs, (n, 16))].astype(np.int16)
    ref_slot = rng.randint(0, 2, (n, 16)).astype(np.int8)
    wild = rng.rand(n, 16) < 0.02
    mv[wild] = rng.randint(-400, 400, (wild.sum(), 2))
    ref_slot[rng.rand(n, 16) < 0.05] = -1
    plan = tmc.mc_fast_plan(mb_w, mb_h, ref_slot, mv.astype(np.int32), pad)
    return mb_w, mb_h, pad, ref_y, ref_u, ref_v, mv, ref_slot, plan


def _torch_plan(plan, mv, ref_slot):
    from losslessh264_tpu_torch.decoder_torch import planes_to_torch
    p = dict(plan, mv=mv, ref_slot=ref_slot)
    return planes_to_torch(p, "cpu")


def _far_case():
    """The 9x4-MB far case of cases.K6_CASES (clipped and long MVs, fix-up
    cells on every ring slot and at the frame's corners) in
    _bucket_case's form."""
    from losslessh264_tpu_torch.cases import K6_CASES, random_mc_case
    name, mb_w, mb_h, *rest = K6_CASES[-1]
    assert name.startswith("9x4") and rest[-1] == "far"
    ref_y, ref_u, ref_v, pad, p = random_mc_case(mb_w, mb_h, *rest)
    mv, ref_slot = p["mv"].numpy(), p["ref_slot"].numpy()
    plan = tmc.mc_fast_plan(mb_w, mb_h, ref_slot, mv.astype(np.int32), pad)
    return (mb_w, mb_h, pad, ref_y.numpy(), ref_u.numpy(), ref_v.numpy(), mv,
            ref_slot, plan)


@pytest.mark.parametrize("trial,n_mvs", [(0, 5), (1, 60), ("far", None)])
def test_mc_bucketed_matches_jax(plain_pallas, trial, n_mvs):
    mb_w, mb_h, pad, ref_y, ref_u, ref_v, mv, ref_slot, plan = \
        _far_case() if trial == "far" else _bucket_case(trial, n_mvs)
    assert plan["mc_fast"]
    jplan = jmc.mc_fast_plan(mb_w, mb_h, ref_slot, mv.astype(np.int32), pad)
    for k in plan:
        np.testing.assert_array_equal(plan[k], jplan[k], err_msg=k)
    p = {k: jnp.asarray(v) for k, v in plan.items()}
    p["ref_slot"] = jnp.asarray(ref_slot)
    p["mv"] = jnp.asarray(mv)
    fn = jax.jit(jmc.mc_bucketed, static_argnames=("pad", "mb_w", "mb_h"))
    want = fn(jnp.asarray(ref_y), jnp.asarray(ref_u), jnp.asarray(ref_v),
              pad, p, mb_w=mb_w, mb_h=mb_h)
    p = _torch_plan(plan, mv, ref_slot)
    got = tmc.mc_bucketed_plain(T(ref_y), T(ref_u), T(ref_v), pad, p, mb_w,
                                mb_h)
    # the K6 wrapper takes the plain version for CPU tensors
    wrapped = tmc.mc_bucketed(T(ref_y), T(ref_u), T(ref_v), pad, p, mb_w,
                              mb_h)
    for g, v, w in zip(got, wrapped, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(v.numpy(), np.asarray(w))


@pytest.mark.parametrize("trial,n_mvs", [(2, 5), (3, 60)])
def test_mc_bucketed_matches_cells(trial, n_mvs):
    """Bucketed path == the general per-cell path on every inter cell
    (tests/test_jax_ops.py::test_mc_bucketed_parity, on the port)."""
    mb_w, mb_h, pad, ref_y, ref_u, ref_v, mv, ref_slot, plan = \
        _bucket_case(trial, n_mvs)
    assert plan["mc_fast"]
    py, pu, pv = tmc.mc_bucketed(T(ref_y), T(ref_u), T(ref_v), pad,
                                 _torch_plan(plan, mv, ref_slot), mb_w, mb_h)
    n = mb_w * mb_h
    mbi = np.arange(n)
    cell = np.arange(16)
    cy0 = ((mbi // mb_w)[:, None] * 16 + (cell // 4)[None, :] * 4) \
        .reshape(-1)
    cx0 = ((mbi % mb_w)[:, None] * 16 + (cell % 4)[None, :] * 4).reshape(-1)
    rs = ref_slot.reshape(-1).astype(np.int64)
    rc = T(np.clip(rs, 0, ref_y.shape[0] - 1))
    vx = T(mv[:, :, 0].reshape(-1))
    vy = T(mv[:, :, 1].reshape(-1))
    cells = tmc.mc_luma_cells(T(ref_y), pad, rc, T(cy0), T(cx0), vx, vy)
    cu = tmc.mc_chroma_cells(T(ref_u), pad // 2, rc, T(cy0 // 2),
                             T(cx0 // 2), vx, vy)
    cv = tmc.mc_chroma_cells(T(ref_v), pad // 2, rc, T(cy0 // 2),
                             T(cx0 // 2), vx, vy)
    for i in np.flatnonzero(rs >= 0):
        y, x = cy0[i], cx0[i]
        assert torch.equal(py[y:y + 4, x:x + 4], cells[i]), f"luma {i}"
        assert torch.equal(pu[y // 2:y // 2 + 2, x // 2:x // 2 + 2],
                           cu[i]), f"cb {i}"
        assert torch.equal(pv[y // 2:y // 2 + 2, x // 2:x // 2 + 2],
                           cv[i]), f"cr {i}"


def test_mc_fast_plan_copy_matches_original():
    """The numpy plan copied into the port (the JAX module imports jax)
    is pinned equal to the original: constants, and plans on frames
    1-11 of synth720p (bucketed frames with fix-ups and two-reference
    frames that fall back to the per-cell path)."""
    from losslessh264_tpu_torch.decoder_torch import PAD, TorchDecoder
    np.testing.assert_array_equal(tmc.QTAB, jmc.QTAB)
    assert (tmc.MC_CAP, tmc.MC_SLOT_CAP, tmc.MC_FIX_CAP, tmc.MC_MV_MAX) == \
        (jmc.MC_CAP, jmc.MC_SLOT_CAP, jmc.MC_FIX_CAP, jmc.MC_MV_MAX)
    data = open(os.path.join(DATA, "synth720p.264"), "rb").read()
    dec = TorchDecoder(data, device="cpu")
    kinds = set()
    for i, f in enumerate(dec.sym):
        planes = dec._prep_planes(f)[0]
        dec._assign_slot(f)
        if i == 0:
            continue
        want = jmc.mc_fast_plan(f["mb_w"], f["mb_h"], planes["ref_slot"],
                                f["mv"].astype(np.int32), PAD)
        got = tmc.mc_fast_plan(f["mb_w"], f["mb_h"], planes["ref_slot"],
                               f["mv"].astype(np.int32), PAD)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"frame {i} {k}")
        kinds.add((bool(got["mc_fast"]), bool((got["mc_fix"] >= 0).any())))
        if i == 11:
            break
    assert {(True, False), (True, True), (False, False)} <= kinds


@pytest.mark.parametrize("name,mb_w,mb_h,seed,kw", K11_CASES)
def test_cells_route_matches_jax(name, mb_w, mb_h, seed, kw):
    """The per-cell route against the JAX package's _mc_legacy_cells on
    K11's cases (every MV phase, MVs far past the padded border, every
    ring slot, WP luma per cell and chroma in a partial wp_cmask with
    denominators -1..7): K11's plain version (cases.k11_plain) equals
    JAX's planes on the inter cells (max_abs_err 0; both 0 elsewhere), and
    their CRC is the one tests/data/k11_jax_crc.json holds, which K11 is
    held to on the card (tests/test_torch_kernels.py)."""
    want = gen_k11_jax_crc.jax_planes(mb_w, mb_h, seed, kw)
    *rings, pad, p = random_cells_case(mb_w, mb_h, seed, **kw)
    got = [a.numpy() for a in k11_plain(*rings, pad, p, mb_w, mb_h)]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert max(int(np.abs(g.astype(np.int64) - w).max())
               for g, w in zip(got, want)) == 0
    with open(os.path.join(DATA, "k11_jax_crc.json")) as fh:
        assert gen_k11_jax_crc.crc(want) == json.load(fh)["crc32"][name]
