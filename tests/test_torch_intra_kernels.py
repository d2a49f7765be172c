"""The intra kernels' plain versions against the JAX package, on the CPU.

K3 (csrc/intra_dec.cu, ops/intra.intra_recon) replaces the decoder's
three compiled intra scans, K4 (csrc/intra_enc.cu,
encoder_torch.intra_wavefront) the encoder's. A kernel may run an MB as
soon as its left, above-left, above and above-right neighbours are done;
the wavefront (the plain versions) and one MB at a time in raster order
(K2's order, and the raster twins here) are two such orders. On the same
numpy inputs (cases.random_intra_case / random_intra_encode_case: every
class and mode, I8x8 on purpose, slices that start mid-row), the raster
twins and the wrappers' CPU routes equal the JAX functions exactly.

JAX compiles each function for ~25 s per size on the CPU, whatever the
size, so the cases are spread over four files of one or two sizes each
(one xdist worker runs a file, --dist loadfile; jax.jit caches within
it): this one, K3 on one MB column and one MB row; _batch, K3 at 5x4 MBs
(one frame, the sparse pass, three frames); _enc, K4 at 5x4 MBs at qp 0,
26, 51 and on per-MB qp planes; _enc_edges, K4 on one MB column and one
MB row. The card twins are in tests/test_torch_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from losslessh264_tpu import decoder_jax, encoder_jax
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import encoder_torch as et
from losslessh264_tpu_torch.cases import (random_intra_case,
                                          random_intra_encode_case)
from losslessh264_tpu_torch.ops import intra as tintra

torch.set_num_threads(1)


def _np(case):
    """A random_intra_case as numpy (planes, residuals, plane dict)."""
    return ([a.numpy() for a in case[:6]],
            {k: v.numpy() for k, v in case[6].items()})


def _frame(case, b):
    return [a[b] for a in case[:6]] + [{k: v[b] for k, v in case[6].items()}]


def _intra_raster(mb_w, mb_h, Yw, Uw, Vw, res_y, res_u, res_v, p):
    """Plain raster-order twin of K3 for one frame: one MB per step, in
    raster order, each step the plane-reading pass over that MB alone."""
    planes = (Yw, Uw, Vw)
    for mb in range(mb_w * mb_h):
        planes = dt._intra_scan_sparse_plain(
            mb_w, mb_h, *planes, res_y, res_u, res_v, p,
            np.array([[mb]], np.int32))
    return planes


def _encode_raster(mb_w, mb_h, srcY, srcU, srcV, inter_y, inter_u, inter_v,
                   is_intra, qp, qpc, row_slice):
    """Plain raster-order twin of K4: each intra MB encoded alone, in
    raster order (encoder_torch._encode_intra_mbs over one MB)."""
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    i32 = torch.int32
    srcs = (dt._plane_to_tiles(srcY.to(i32), mb_w, mb_h, 16),
            dt._plane_to_tiles(srcU.to(i32), mb_w, mb_h, 8),
            dt._plane_to_tiles(srcV.to(i32), mb_w, mb_h, 8))
    planes = et._working_planes(mb_w, mb_h, inter_y, inter_u, inter_v)
    outs = (torch.zeros(n, dtype=i32), torch.ones(n, dtype=i32),
            torch.full((n, 16), 2, dtype=i32), torch.zeros(n, dtype=i32),
            torch.zeros((n, 16), dtype=i32),
            torch.zeros((n, 16, 4, 4), dtype=i32),
            torch.zeros((n, 2, 4), dtype=i32),
            torch.zeros((n, 2, 4, 16), dtype=i32))
    avail = torch.as_tensor(et._mb_avail(mb_w, mb_h, row_slice))
    for mb in np.flatnonzero(is_intra):
        planes = et._encode_intra_mbs(
            mb_w, planes, srcs, qp, qpc, outs, torch.tensor([mb]),
            *(avail[mb:mb + 1, k] for k in range(3)))
    Yw, Uw, Vw = planes
    u8 = torch.uint8
    return (*outs[:5], et.tt.zigzag4(outs[5]), *outs[6:],
            Yw[dt.WPAD:dt.WPAD + H, dt.WPAD:dt.WPAD + W].to(u8),
            Uw[dt.WPAD:dt.WPAD + H // 2, dt.WPAD:dt.WPAD + W // 2].to(u8),
            Vw[dt.WPAD:dt.WPAD + H // 2, dt.WPAD:dt.WPAD + W // 2].to(u8))


def _same(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f"{what} output {i}")


def _covers(p):
    """The classes, transform8 and modes a case holds."""
    cls = p["mb_class"]
    return {"i4": ((cls == 0) & (p["transform8"] == 0)).any(),
            "i8": ((cls == 2) | ((cls == 0) & (p["transform8"] != 0))).any(),
            "i16": (cls == 1).any(), "inter": (cls == 3).any(),
            "pcm": (cls == 8).any()}


def check_k3_frame(mb_w, mb_h, seed):
    """One frame: the raster twin, intra_recon's CPU route and the full
    and sparse passes (over the full diagonal table) equal JAX's
    _intra_scan (decoder_jax.intra_pass). Returns the case's classes."""
    case = random_intra_case(mb_w, mb_h, 1, seed)
    one = _frame(case, 0)
    args = [a.numpy() for a in one[:6]]
    pj = {k: jnp.asarray(v.numpy()) for k, v in one[6].items()}
    diags = dt.diagonals(mb_w, mb_h)
    want = decoder_jax.intra_pass(mb_w, mb_h, *args, pj, jnp.asarray(diags))
    _same(_intra_raster(mb_w, mb_h, *one), want, "raster twin")
    _same(tintra.intra_recon(mb_w, mb_h, *one), want, "intra_recon")
    _same(dt._intra_scan(mb_w, mb_h, *one, diags), want, "_intra_scan")
    _same(dt._intra_scan_sparse(mb_w, mb_h, *one, diags), want,
          "_intra_scan_sparse")
    assert not np.array_equal(np.asarray(want[0]), args[0])
    return _covers({k: v.numpy() for k, v in one[6].items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k3_one_mb_column_matches_jax(seed):
    check_k3_frame(1, 4, seed)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_k3_one_mb_row_matches_jax(seed):
    check_k3_frame(5, 1, seed)


def check_k4(mb_w, mb_h, seed, qp):
    """The raster twin, intra_wavefront's CPU route and the plain
    wavefront equal encoder_jax.intra_wavefront's 11 outputs. Returns
    the intra MBs' luma classes."""
    c = random_intra_encode_case(mb_w, mb_h, seed, qp)
    want = encoder_jax.intra_wavefront(
        mb_w, mb_h, c["srcY"], c["srcU"], c["srcV"], c["inter_y"],
        c["inter_u"], c["inter_v"], jnp.asarray(c["is_intra"]), c["qp"],
        c["qpc"], jnp.asarray(encoder_jax._diagonals(mb_w, mb_h)),
        jnp.asarray(c["row_slice"]))
    args = (torch.as_tensor(c["srcY"]), torch.as_tensor(c["srcU"]),
            torch.as_tensor(c["srcV"]), torch.as_tensor(c["inter_y"]),
            torch.as_tensor(c["inter_u"]), torch.as_tensor(c["inter_v"]),
            c["is_intra"], torch.as_tensor(c["qp"]),
            torch.as_tensor(c["qpc"]), c["row_slice"])
    _same(_encode_raster(mb_w, mb_h, *args), want, "raster twin")
    _same(et.intra_wavefront(mb_w, mb_h, *args), want, "intra_wavefront")
    _same(et.intra_wavefront_plain(mb_w, mb_h, *args), want, "plain")
    return np.asarray(want[1])[c["is_intra"]]
