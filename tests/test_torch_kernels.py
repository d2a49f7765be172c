"""The port's CUDA kernels against their plain torch versions.

K1 (csrc/halfpel.cu, ops/mc.halfpel_planes), K2 (csrc/deblock.cu,
ops/deblock.deblock_wavefront), K9 (csrc/deblock_params.cu,
ops/deblock.edge_params_packed), K3 (csrc/intra_dec.cu,
ops/intra.intra_recon), K4 (csrc/intra_enc.cu,
encoder_torch.intra_wavefront), K5 (csrc/me_dense.cu,
ops/me.dense_full_search), K6 (csrc/mc_bucket.cu,
ops/mc.mc_bucketed), K7 (csrc/residual_dec.cu,
decoder_torch._residual_recon), K8 (csrc/residual_enc.cu,
encoder_torch.inter_residual) and K11 (csrc/mc_cells.cu,
ops/mc.mc_cells) have no CPU mode. The tests marked
`cuda` build them with nvcc and compare them on the card with
torch.equal, and run the decoder and the encoder, which launch them, on
the card against the committed goldens and the port's CPU run; they
skip without CUDA. This file imports no JAX, so it
runs on a GPU machine that has only torch:

    python -m pytest tests/test_torch_kernels.py -q

The unmarked tests check the wrappers' device contract on any machine:
a CPU tensor takes the plain version, and the kernel entry refuses
anything but a CUDA tensor (no silent fallback)."""
import json
import os
import zlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import encoder_torch as et
from losslessh264_tpu_torch import native
from losslessh264_tpu_torch.cases import (INTRA_CLASSES, K5_CASES, K6_CASES,
                                          K7_CASES, K8_CASES, K9_CASES,
                                          K11_CASES, HeldToPlain,
                                          bucketed_mc_frames,
                                          dense_search_case,
                                          inter_residual_args, k11_plain,
                                          moving_frames,
                                          random_deblock_case,
                                          random_edge_case,
                                          random_inter_residual_case,
                                          random_intra_case,
                                          random_intra_encode_case,
                                          random_cells_case,
                                          random_mc_case,
                                          random_residual_case)
from losslessh264_tpu_torch.ops import deblock as tdb
from losslessh264_tpu_torch.ops import intra as tintra
from losslessh264_tpu_torch.ops import mc as tmc
from losslessh264_tpu_torch.ops import me as tme

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_wrappers_take_plain_version_on_cpu():
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (40, 52), dtype=np.uint8))
    assert torch.equal(tmc.halfpel_planes(x), tmc.halfpel_planes_plain(x))
    planes, sym, params = random_deblock_case(5, 4, 2, "cpu")
    got = tdb.deblock_frame(5, 4, *planes, *sym, 2)
    want = tdb.deblock_wavefront_plain(5, 4, *planes, params)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[0], planes[0])   # the filter fired
    edge = random_edge_case(5, 4, 2)
    before = tdb.edge_params_packed.launches
    assert torch.equal(tdb.edge_params_packed(5, 4, *edge),
                       tdb.edge_params_packed_plain(5, 4, *edge))
    assert tdb.edge_params_packed.launches == before
    case = random_intra_case(5, 4, 2, 3, "cpu")
    got = tintra.intra_recon(5, 4, *case)
    want = dt._intra_scan_plain(5, 4, *case, dt.diagonals(5, 4))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[0], case[0])   # intra MBs reconstructed
    args = _encode_args(random_intra_encode_case(5, 4, 1, "aq"), "cpu")
    for g, w in zip(et.intra_wavefront(5, 4, *args),
                    et.intra_wavefront_plain(5, 4, *args)):
        assert torch.equal(g, w)
    assert tintra.intra_recon.launches == 0
    assert et.intra_wavefront.launches == 0


def test_intra_case_options():
    """The generator options behind the kernels' new cases do what the
    docstrings say: classes=(0,), t8_share=0 gives only I4x4 MBs with
    every 4x4 mode and every availability flag both set and clear; the
    default mix holds every class; mask="stripes" makes every MB intra
    but those with (x + y) % 3 == 2, with inter tiles only there."""
    *_, p = random_intra_case(80, 45, 1, 7, classes=(0,), t8_share=0)
    assert set(p["mb_class"].unique().tolist()) == {0}
    assert not p["transform8"].any()
    assert set(p["i4_modes"].unique().tolist()) == set(range(9))
    for k in range(4):
        assert set(p["avail"][..., k].unique().tolist()) == {False, True}
    *_, p = random_intra_case(9, 4, 1, 0)
    assert set(p["mb_class"].unique().tolist()) == set(INTRA_CLASSES)
    assert 0 < p["transform8"].float().mean() < 1
    case = random_intra_encode_case(7, 5, 12, 28, "stripes")
    y, x = np.divmod(np.arange(35), 7)
    assert (case["is_intra"] == ((x + y) % 3 != 2)).all()
    inter = case["inter_y"].reshape(35, -1).any(1)
    assert (inter == ~case["is_intra"]).all()
    assert random_intra_encode_case(7, 5, 12, 28)["is_intra"].all()
    with pytest.raises(ValueError, match="mask"):
        random_intra_encode_case(7, 5, 12, 28, "rows")


def test_kernel_entries_refuse_cpu_tensors():
    x = torch.zeros((40, 52), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        tmc._halfpel_launch(x, torch.int32)
    planes, _, params = random_deblock_case(3, 2, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tdb.deblock_wavefront(3, 2, *planes, params)
    with pytest.raises(ValueError, match="CUDA"):
        tdb.k9_operands(3, 2, *random_edge_case(3, 2, 0))
    with pytest.raises(ValueError, match="CUDA"):
        tintra._intra_recon_launch(3, 2, *random_intra_case(3, 2, 1, 0))
    with pytest.raises(ValueError, match="CUDA"):
        et._intra_wavefront_launch(3, 2, *_encode_args(
            random_intra_encode_case(3, 2, 0, 26), "cpu"))


def test_search_and_mc_wrappers_take_plain_version_on_cpu():
    """K5's and K6's wrappers on CPU tensors return their plain versions'
    results and launch nothing."""
    before = (tme.dense_full_search.launches, tmc.mc_bucketed.launches,
              tmc.halfpel_planes.launches)
    cur, ref = dense_search_case(48, 64, 5, "periodic", 3)
    got = tme.dense_full_search(cur, ref, 5)
    want = tme.dense_full_search_plain(cur, ref, 5)
    assert all(torch.equal(g, w) for g3, w3 in zip(got, want)
               for g, w in zip(g3, w3))
    case = random_mc_case(9, 4, 5, 5, 2, 3, False)
    got = tmc.mc_bucketed(*case, 9, 4)
    want = tmc.mc_bucketed_plain(*case, 9, 4)
    assert all(g.dtype == torch.int32 and torch.equal(g, w)
               for g, w in zip(got, want))
    assert (tme.dense_full_search.launches, tmc.mc_bucketed.launches,
            tmc.halfpel_planes.launches) == before == (0, 0, 0)


def test_search_and_mc_entries_refuse_cpu_tensors():
    """K5's and K6's launch paths raise on CPU tensors, and K5's on a
    radius whose displacement index its key cannot hold."""
    cur, ref = dense_search_case(48, 64, 5, "random", 0)
    with pytest.raises(ValueError, match="CUDA"):
        tme._dense_launch(cur, ref, 5)
    cur, ref = dense_search_case(16, 32, 23, "random", 0, strided=False)
    with pytest.raises(ValueError, match="radius 23"):
        tme._dense_launch(cur, ref, 23)
    with pytest.raises(ValueError, match="CUDA"):
        tmc._mc_bucketed_launch(*random_mc_case(9, 4, 5, 5, 2, 3, False),
                                9, 4)


@pytest.mark.parametrize("col,plane", [(3, 4), (6, -1)])
def test_mc_refuses_tap_plane_outside_k1(col, plane):
    """An entry whose tap names no K1 plane (0..3) raises before anything
    reads the planes, in the plain version as before the kernel."""
    *rings, pad, p = random_mc_case(9, 4, 5, 5, 2, 3, False)
    p["mc_uniq"] = p["mc_uniq"].copy()
    p["mc_uniq"][1, col] = plane
    with pytest.raises(ValueError, match="tap planes"):
        tmc.mc_bucketed(*rings, pad, p, 9, 4)


def _check_mc_case(p, n_main, n_slots, n_extra, edge):
    """The plan of random_mc_case has the triples, slots and fix-up cells
    its case names: every main and extra triple in the table (the 32 most
    populated when there are more), 512 fix-up cells when 32 MBs spill,
    some when MVs at +-MC_MV_MAX clip at the frame's edge, and every cell
    of the far MBs, on slots outside the active ones too."""
    fix = int((p["mc_fix"] >= 0).sum())
    assert p["mc_nslots"] == n_slots
    if edge == "far":
        assert p["mc_nuniq"] == n_main and fix == 16 * n_extra
        cells = p["mc_fix"][:fix].long()
        slots = p["ref_slot"].reshape(-1)[cells].long()
        assert set(slots.tolist()) == {0, 1, 2, 3}
    elif edge:
        assert 0 < fix < tmc.MC_FIX_CAP and p["mc_nuniq"] <= n_main
    else:
        assert p["mc_nuniq"] == min(tmc.MC_CAP, n_main + n_extra)
        assert fix == (16 * n_extra if n_main + n_extra > tmc.MC_CAP else 0)


@pytest.mark.parametrize("name,mb_w,mb_h,seed,n_main,n_slots,n_extra,edge",
                         K6_CASES)
def test_mc_cases(name, mb_w, mb_h, seed, n_main, n_slots, n_extra, edge):
    """random_mc_case's plans are the ones K6's card cases name."""
    *_, p = random_mc_case(mb_w, mb_h, seed, n_main, n_slots, n_extra, edge)
    _check_mc_case(p, n_main, n_slots, n_extra, edge)


def _encode_args(case, device):
    """intra_wavefront's arguments after (mb_w, mb_h) from a
    random_intra_encode_case: tensors on `device`, the intra mask and
    row_slice on the host."""
    def T(k):
        return torch.as_tensor(case[k], device=device)
    return (T("srcY"), T("srcU"), T("srcV"), T("inter_y"), T("inter_u"),
            T("inter_v"), case["is_intra"], T("qp"), T("qpc"),
            case["row_slice"])


# K3 on random cases: (mb_w, mb_h, B, seed, options of random_intra_case),
# 720p single and batched, a row of one MB and a frame of one MB row, a
# 720p frame of I4x4 MBs only (every 4x4 mode and availability on the
# blocks' dependency levels), and 720p's MB row and MB column
K3_CASES = [(9, 4, 1, 0, {}), (9, 4, 4, 1, {}), (22, 18, 1, 2, {}),
            (80, 45, 1, 3, {}), (80, 45, 4, 4, {}), (1, 9, 2, 5, {}),
            (7, 1, 3, 6, {}), (80, 45, 1, 7, {"classes": (0,), "t8_share": 0}),
            (80, 1, 1, 8, {}), (1, 45, 1, 9, {})]


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h,B,seed,opts", K3_CASES)
def test_intra_dec_kernel_on_card(cuda_device, mb_w, mb_h, B, seed, opts):
    """K3 equals the plain compact-carry pass on the card, 5 launches over
    the B frames and one on the first frame alone: a race on the row
    progress flags would show as a launch that differs."""
    case = random_intra_case(mb_w, mb_h, B, seed, cuda_device, **opts)
    want = dt._intra_scan_plain(mb_w, mb_h, *case, dt.diagonals(mb_w, mb_h))
    before = tintra.intra_recon.launches
    for _ in range(5):
        got = tintra.intra_recon(mb_w, mb_h, *case)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    one = [a[0] for a in case[:6]] + [{k: v[0] for k, v in case[6].items()}]
    got = tintra.intra_recon(mb_w, mb_h, *one)
    assert all(torch.equal(g, w[0]) for g, w in zip(got, want))
    assert tintra.intra_recon.launches == before + 6


# K4 on random cases: (mb_w, mb_h, seed, qp, intra mask of
# random_intra_encode_case); odd seeds mask half the MBs. 720p all intra
# at qp 0 and 51, 720p striped (intra MBs with intra and inter left
# neighbours: the left column carried in shared memory and the one read
# from the plane), and 720p's MB row and MB column
K4_CASES = [(9, 4, 0, 26, None), (9, 4, 1, "aq", None), (22, 18, 2, 0, None),
            (80, 45, 4, 28, None), (80, 45, 5, "aq", None),
            (1, 9, 6, 51, None), (7, 1, 7, 26, None), (80, 45, 8, 0, None),
            (80, 45, 10, 51, None), (80, 45, 12, 28, "stripes"),
            (80, 1, 14, 26, None), (1, 45, 16, 26, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h,seed,qp,mask", K4_CASES)
def test_intra_enc_kernel_on_card(cuda_device, mb_w, mb_h, seed, qp, mask):
    """K4's 11 outputs equal the plain wavefront's on the card, 3
    launches."""
    args = _encode_args(random_intra_encode_case(mb_w, mb_h, seed, qp,
                                                 mask), cuda_device)
    want = et.intra_wavefront_plain(mb_w, mb_h, *args)
    before = et.intra_wavefront.launches
    for _ in range(3):
        got = et.intra_wavefront(mb_w, mb_h, *args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert et.intra_wavefront.launches == before + 3


# The decode path's edge-padded luma references (720p, 1080p, 2160p),
# widths around one 128-column strip of the kernel (Wp 132-134, not
# multiples of 16: byte loads), a ragged aligned width and odd sizes.
K1_SHAPES = [(784, 1344), (1152, 1984), (2224, 3904), (133, 133), (70, 134),
             (300, 132), (262, 400), (781, 1351), (42, 58), (6, 6), (101, 77)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_halfpel_kernel_on_card(cuda_device, shape):
    """Both entries, 10 launches each, equal the plain version; the
    uint8 entry hands back rows padded to the 16-byte pitch."""
    x = torch.as_tensor(np.random.default_rng(sum(shape)).integers(
        0, 256, shape, dtype=np.uint8), device=cuda_device)
    want = tmc.halfpel_planes_plain(x)
    before = tmc.halfpel_planes.launches
    for _ in range(10):
        assert torch.equal(tmc.halfpel_planes(x), want)
        got8 = tmc._halfpel_planes_u8(x)
        assert torch.equal(got8, want.to(torch.uint8))
        assert got8.stride(1) == tmc._pitch(shape[1] - 5)
    assert tmc.halfpel_planes.launches == before + 20


@pytest.mark.cuda
def test_halfpel_kernel_misaligned_plane(cuda_device):
    """A plane whose pointer is not 16-byte aligned takes the kernel's
    byte loads."""
    buf = torch.empty(784 * 1344 + 1, dtype=torch.uint8, device=cuda_device)
    x = buf[1:].view(784, 1344)
    x.copy_(torch.as_tensor(np.random.default_rng(9).integers(
        0, 256, (784, 1344), dtype=np.uint8)))
    want = tmc.halfpel_planes_plain(x)
    assert torch.equal(tmc.halfpel_planes(x), want)
    assert torch.equal(tmc._halfpel_planes_u8(x), want.to(torch.uint8))


def _deblock_raster(mb_w, mb_h, planes, params):
    """Deblock in the reference decoder's serial order (WelsDeblockingMb):
    one MB per step, in raster order."""
    planes = tuple(planes)
    for mb in range(mb_w * mb_h):
        planes = tdb.deblock_mbs_plain(mb_w, *planes, params,
                                       torch.tensor([mb]))
    return planes


@pytest.mark.parametrize("mb_w,mb_h,seed", [(1, 6, 0), (2, 7, 1), (5, 4, 2)])
def test_raster_order_matches_wavefront(mb_w, mb_h, seed):
    """K2 may run an MB as soon as its left, above-left, above and
    above-right neighbours are done; the plain wavefront and the serial
    raster order are the two extremes of such orders, and agree."""
    planes, _, params = random_deblock_case(mb_w, mb_h, seed, "cpu")
    want = tdb.deblock_wavefront_plain(mb_w, mb_h, *planes, params)
    got = _deblock_raster(mb_w, mb_h, planes, params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(got[0], planes[0])   # the filter fired


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h,seed", [
    (9, 4, 0), (22, 18, 1), (80, 45, 2),
    (120, 68, 3),    # 1080p
    (4, 150, 4),     # more MB rows than the card has SMs
    (1, 9, 5), (2, 7, 6)])   # "x+1" runs off a row of 1 or 2 MBs
def test_deblock_kernel_on_card(cuda_device, mb_w, mb_h, seed):
    """20 launches per case, each equal to the plain version: a race on
    the row progress flags would show as a launch that differs."""
    planes, _, params = random_deblock_case(mb_w, mb_h, seed, cuda_device)
    want = tdb.deblock_wavefront_plain(mb_w, mb_h, *planes, params)
    for _ in range(20):
        got = tdb.deblock_wavefront(mb_w, mb_h, *planes, params)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_deblock_frame_is_one_launch(cuda_device):
    """One launch of K2, just after one of K9."""
    planes, sym, _ = random_deblock_case(80, 45, 7, cuda_device)
    before = (tdb.deblock_wavefront.launches,
              tdb.edge_params_packed.launches)
    tdb.deblock_frame(80, 45, *planes, *sym, 7)
    torch.cuda.synchronize()
    assert (tdb.deblock_wavefront.launches,
            tdb.edge_params_packed.launches) == (before[0] + 1,
                                                 before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mb_w,mb_h,seed,kw", K9_CASES)
def test_deblock_params_kernel_on_card(cuda_device, name, mb_w, mb_h, seed, kw):
    """K9 equals its plain version on the card in all 384 lanes of every
    row, 3 launches, whatever dtypes, views and absent planes the case
    hands it."""
    case = random_edge_case(mb_w, mb_h, seed, cuda_device, **kw)
    want = tdb.edge_params_packed_plain(mb_w, mb_h, *case)
    before = tdb.edge_params_packed.launches
    for _ in range(3):
        got = tdb.edge_params_packed(mb_w, mb_h, *case)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert tdb.edge_params_packed.launches == before + 3


class _Ops(TorchDispatchMode):
    """The non-view aten ops dispatched while the mode is on."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += not func.is_view
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", ["decoder", "encoder"])
def test_deblock_frame_is_k9_and_k2(cuda_device, monkeypatch, dtypes):
    """On CUDA tensors deblock_frame is one K9 and one K2 launch and a
    handful of host ops: it calls neither _edge_params nor _pack_params
    (sentinels in their place raise), and its planes equal those of the
    plain edge parameters under K2."""
    planes, _, _ = random_deblock_case(80, 45, 7, cuda_device)
    edge = random_edge_case(80, 45, 7, cuda_device, dtypes=dtypes,
                            **({"idc": 2} if dtypes == "encoder" else {}))
    want = tdb.deblock_wavefront(80, 45, *planes,
                                 tdb.edge_params_packed_plain(80, 45, *edge))

    def sentinel(*args, **kw):
        raise AssertionError("the plain edge parameters ran on CUDA")
    monkeypatch.setattr(tdb, "_edge_params", sentinel)
    monkeypatch.setattr(tdb, "_pack_params", sentinel)
    tdb.deblock_frame(80, 45, *planes, *edge)    # the tables reach the card
    before = (tdb.deblock_wavefront.launches,
              tdb.edge_params_packed.launches)
    with _Ops() as mode:
        got = tdb.deblock_frame(80, 45, *planes, *edge)
    assert (tdb.deblock_wavefront.launches,
            tdb.edge_params_packed.launches) == (before[0] + 1,
                                                 before[1] + 1)
    assert mode.ops <= 10, mode.ops
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("key,bad", [("mv", "float"), ("nnz", "shape"),
                                     ("qp", None), ("alpha_off", 3)])
def test_deblock_params_kernel_refuses_planes(cuda_device, key, bad):
    """K9 reads integer planes of their shapes; a float plane, a wrong
    shape, a missing plane that must be there or an int for a plane other
    than deblock_idc raise before the launch."""
    keys = [k for k, _ in tdb._K9_PLANES]
    case = list(random_edge_case(3, 2, 0, cuda_device))
    i = keys.index(key)
    case[i] = {"float": lambda a: a.float(), "shape": lambda a: a[:, :8]}[
        bad](case[i]) if isinstance(bad, str) else bad
    before = tdb.edge_params_packed.launches
    with pytest.raises(ValueError, match=key):
        tdb.edge_params_packed(3, 2, *case)
    assert tdb.edge_params_packed.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["synth720p.264", "runs720p.264"])
def test_deblock_params_kernel_on_streams(cuda_device, stream):
    """K9 equals the plain version on every deblocked frame of the
    stream's decode, once per K2 launch, and the decode's CRCs hold."""
    with open(os.path.join(DATA, stream), "rb") as fh:
        data = fh.read()
    gold = json.load(open(os.path.join(
        DATA, stream.replace(".264", "_np_crc.json"))))
    k2 = tdb.deblock_wavefront.launches
    with HeldToPlain(tdb, "edge_params_packed",
                     tdb.edge_params_packed_plain) as held:
        crcs = [zlib.crc32(b"".join(a.cpu().numpy().tobytes() for a in yuv))
                for yuv in dt.TorchDecoder(data, device=cuda_device).frames()]
    assert crcs == gold[stream[:-4]]["crc32"]
    assert held.calls == tdb.deblock_wavefront.launches - k2 > 0
    assert held.bad == []


@pytest.mark.cuda
def test_encoder_deblock_is_k9_and_k2(cuda_device, monkeypatch):
    """The encoder's in-loop filter on the card, on its fused and its
    per-MB QP paths, never runs the plain edge parameters on CUDA tensors
    (a sentinel in their place raises there), K9 equals its plain version
    (run on CPU copies) on every call, and the encodes equal those of the
    CPU."""
    real = tdb._edge_params

    def sentinel(mb_w, mb_h, cls, *args):
        if cls.is_cuda:
            raise AssertionError("the plain edge parameters ran on CUDA")
        return real(mb_w, mb_h, cls, *args)

    def plain_on_cpu(*args):
        cpu = [a.cpu() if torch.is_tensor(a) else a for a in args]
        return tdb.edge_params_packed_plain(*cpu).to(cuda_device)
    frames = moving_frames(3, 96, 64)
    want = {}
    for kw in (dict(qp=30), dict(qp=30, aq=True)):
        enc = et.TorchEncoder(96, 64, device="cpu", **kw)
        want[str(kw)] = [enc.encode_frame(*f) for f in frames]
    monkeypatch.setattr(tdb, "_edge_params", sentinel)
    for kw in (dict(qp=30), dict(qp=30, aq=True)):
        enc = et.TorchEncoder(96, 64, device=cuda_device, **kw)
        with HeldToPlain(tdb, "edge_params_packed", plain_on_cpu) as held:
            got = [enc.encode_frame(*f) for f in frames]
        assert got == want[str(kw)]
        assert held.calls >= 2 and held.bad == []


@pytest.mark.cuda
def test_synth720p_on_card(cuda_device):
    """All 25 frames equal the NpDecoder CRCs; K2 launches once for each
    frame that is deblocked."""
    gold = json.load(open(os.path.join(DATA, "synth720p_np_crc.json")))
    with open(os.path.join(DATA, "synth720p.264"), "rb") as fh:
        data = fh.read()
    deblocked = sum(
        bool(dt.TorchDecoder._needs_deblock(f, dt.TorchDecoder._nnz_plane(f)))
        for f in native.SymbolDecoder(data))
    k1, k2 = tmc.halfpel_planes.launches, tdb.deblock_wavefront.launches
    dec = dt.TorchDecoder(data, device=cuda_device)
    crcs = [zlib.crc32(b"".join(a.cpu().numpy().tobytes() for a in yuv))
            for yuv in dec.frames()]
    assert crcs == gold["synth720p"]["crc32"]
    assert tmc.halfpel_planes.launches > k1
    assert tdb.deblock_wavefront.launches - k2 == deblocked > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(qp=26), dict(qp=30, refs=2, cabac=True)])
def test_encoder_on_card(cuda_device, kw):
    """4 frames at 64x48, the second with two flat MBs that no reference
    predicts (so that P frame falls back to intra on them): TorchEncoder
    on the card writes the bytes and recon of TorchEncoder on the CPU,
    with K1 once per P frame and K2 once per frame."""
    frames = moving_frames(4)
    Y1 = frames[1][0].copy()
    Y1[16:32, 16:48] = 60
    frames[1] = (Y1, *frames[1][1:])
    cpu = et.TorchEncoder(64, 48, device="cpu", **kw)
    card = et.TorchEncoder(64, 48, device=cuda_device, **kw)
    k1, k2 = tmc.halfpel_planes.launches, tdb.deblock_wavefront.launches
    for f in frames:
        assert card.encode_frame(*f) == cpu.encode_frame(*f)
        for a, b in zip(card.recon, cpu.recon):
            np.testing.assert_array_equal(a, b)
    assert tmc.halfpel_planes.launches - k1 == 3
    assert tdb.deblock_wavefront.launches - k2 == 4


def _k2_implied(encs):
    """K2 launches JaxEncoder's control flow implies for the encodes of
    TorchEncoder.encodes (see chip_smoke.expected_launches)."""
    return sum(bool(path == "aq" or kind == "I" or is_ref or n_intra)
               for kind, path, is_ref, n_intra in encs)


@pytest.mark.cuda
@pytest.mark.parametrize("recipe", ["C", "D"])
def test_encoder_modes_on_card(cuda_device, recipe):
    """The C-like recipe (RC, AQ, GOM RC, bgd, scroll ME, denoise, LTR at
    64x96, the scroll detector's least height) and the D-like one (4
    temporal layers with a slice cap that forces re-encodes, 64x48) of
    chip_smoke.py: TorchEncoder on the card writes the bytes and recon of
    TorchEncoder on the CPU, with K1 once per P encode and K2 as the
    encodes imply."""
    from losslessh264_tpu_torch import ratectl
    if recipe == "C":
        W, H, frames = 64, 96, moving_frames(5, H=96, seed=3)
        calls = {2: "mark_ltr", 3: "recover_from_ltr"}

        def kw():
            return dict(qp=28, aq=True, gom_rc=True, bgd=True,
                        scroll_me=True, denoise=True, ltr=True,
                        rc=ratectl.RateControl(400_000, 25.0, qp_init=28))
    else:
        W, H, frames = 64, 48, moving_frames(6, seed=8)
        calls = {}

        def kw():
            return dict(qp=28, temporal_layers=4, slice_max_bytes=160)
    cpu = et.TorchEncoder(W, H, device="cpu", **kw())
    card = et.TorchEncoder(W, H, device=cuda_device, **kw())
    k1, k2 = tmc.halfpel_planes.launches, tdb.deblock_wavefront.launches
    encs = []
    for i, f in enumerate(frames):
        if i in calls:
            getattr(cpu, calls[i])()
            getattr(card, calls[i])()
        assert card.encode_frame(*f) == cpu.encode_frame(*f)
        for a, b in zip(card.recon, cpu.recon):
            np.testing.assert_array_equal(a, b)
        encs += card.encodes
    assert tmc.halfpel_planes.launches - k1 == sum(e[0] == "P" for e in encs)
    assert tdb.deblock_wavefront.launches - k2 == _k2_implied(encs)
    if recipe == "D":
        assert len(encs) > len(frames)         # a re-encode happened
        assert _k2_implied(encs) < len(encs)   # a T3 frame deblocks nothing


@pytest.mark.cuda
def test_simulcast_on_card(cuda_device):
    """Two spatial layers with inter-layer prediction at 96x64: the card
    writes the CPU's bytes per layer, and the port's SimulcastDecoder on
    the card gives the CPU's pictures."""
    from losslessh264_tpu_torch import simulcast
    yy, xx = np.mgrid[0:64, 0:96]
    frames = [(((xx * 2 + yy) // 2 + i * 3).astype(np.uint8),
               (xx // 2 + 64)[:32, :48].astype(np.uint8),
               (yy + 128)[:32, :48].astype(np.uint8)) for i in range(3)]
    kw = dict(spatial_layers=2, qp=30, inter_layer=True)
    cpu = simulcast.SimulcastEncoder(96, 64, device="cpu", **kw)
    card = simulcast.SimulcastEncoder(96, 64, device=cuda_device, **kw)
    streams = [b"", b""]
    for f in frames:
        got, want = card.encode_frame_layers(*f), cpu.encode_frame_layers(*f)
        assert got == want
        streams = [s + p for s, p in zip(streams, got)]
    pics = [simulcast.SimulcastDecoder(streams, error_concealment=False,
                                       device=d).frames()
            for d in (cuda_device, "cpu")]
    n = 0
    for a, b in zip(*pics):
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)
        n += 1
    assert n == len(frames)


@pytest.mark.cuda
def test_encoder_frame_host_copies(cuda_device):
    """A P frame's only host copies are the source upload and the symbol
    fetch; an IDR adds the intra wavefront's MB schedule. The ops'
    constant tables stay on the card (ops/consts.on). The profiler may
    drop records, so the counts are upper bounds."""
    from torch.profiler import ProfilerActivity, profile

    def copies(f):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            enc.encode_frame(*f)
            torch.cuda.synchronize()
        n = {"HtoD": 0, "DtoH": 0}
        for e in prof.key_averages():
            for kind in n:
                if e.key.startswith(f"Memcpy {kind}"):
                    n[kind] += e.count
        return n

    frames = moving_frames(4)
    enc = et.TorchEncoder(64, 48, device=cuda_device)
    for f in frames[:2]:        # an IDR and a P frame fill the caches
        enc.encode_frame(*f)
    p = copies(frames[2])
    enc.force_intra_frame()
    idr = copies(frames[3])
    assert p["HtoD"] <= 1 and p["DtoH"] <= 1, p
    assert idr["HtoD"] <= 2 and idr["DtoH"] <= 1, idr


def test_deblock_ignores_the_padding():
    """Edges on the picture's border are never filtered, so the WPAD
    padding neither changes the picture nor is changed: K2 needs only
    the picture's pixels (the byte count of its bound)."""
    planes, _, params = random_deblock_case(4, 3, 1, "cpu")
    want = tdb.deblock_wavefront_plain(4, 3, *planes, params)
    P = tdb.WPAD
    noisy = []
    for a in planes:
        b = torch.randint(0, 256, a.shape, dtype=torch.int32,
                          generator=torch.Generator().manual_seed(5))
        b[P:-P, P:-P] = a[P:-P, P:-P]
        noisy.append(b)
    got = tdb.deblock_wavefront_plain(4, 3, *noisy, params)
    for g, w, b in zip(got, want, noisy):
        assert torch.equal(g[P:-P, P:-P], w[P:-P, P:-P])
        pad = torch.ones_like(g, dtype=torch.bool)
        pad[P:-P, P:-P] = False
        assert torch.equal(g[pad], b[pad])
    assert not torch.equal(want[0], planes[0])   # the filter fired


def _me_case(device, seed=0, mb_w=6, mb_h=4, pad=32):
    """Half-pel planes (K1 on the card, the plain version on the CPU) of
    a padded random reference, block origins, source blocks, and MVs in
    quarter units (integer, some far enough out to be clamped)."""
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    ref = np.pad(rng.integers(0, 256, (H, W), dtype=np.uint8), pad,
                 mode="edge")
    n = 60
    ys = (rng.integers(0, mb_h, n) * 16).astype(np.int32)
    xs = (rng.integers(0, mb_w, n) * 16).astype(np.int32)
    mvx = (rng.integers(-16, 17, n) * 4).astype(np.int32)
    mvy = (rng.integers(-16, 17, n) * 4).astype(np.int32)
    mvx[:2] = (4 * (pad + 12), -4 * (pad + 20))
    src = rng.integers(0, 256, (n, 16, 16)).astype(np.int32)
    out = {}
    for dev in ("cpu", device):
        t = {k: torch.as_tensor(v, device=dev) for k, v in
             dict(ref=ref, ys=ys, xs=xs, mvx=mvx, mvy=mvy, src=src).items()}
        t["planes"] = tmc.halfpel_planes(t["ref"])
        out[torch.device(dev).type] = t
    return out["cpu"], out["cuda"], pad


@pytest.mark.cuda
def test_me_ops_on_card(cuda_device):
    """full_search_sad (every block shape), subpel_refine (steps 2 and 1),
    subpel_full and mc_luma_mbs on the card equal the CPU port on K1's
    planes."""
    from losslessh264_tpu_torch.ops import me as tme
    c, g, pad = _me_case(cuda_device)

    def same(fn):
        for a, b in zip(fn(c), fn(g)):
            assert torch.equal(a, b.cpu())

    for block in (16, 8, (8, 16), (16, 8)):
        bh, bw = (block, block) if isinstance(block, int) else block
        same(lambda t: tme.full_search_sad(
            t["src"][:, :bh, :bw], t["ref"], t["ys"] + pad - 16,
            t["xs"] + pad - 16, 16, block))
    for step in (2, 1):
        same(lambda t: tme.subpel_refine(
            t["planes"], pad, t["ys"], t["xs"], t["mvx"] + 2 * (step == 1),
            t["mvy"], t["src"], step, return_pred=True))
    same(lambda t: tme.subpel_full(t["planes"], pad, t["ys"], t["xs"],
                                   t["mvx"], t["mvy"], t["src"]))
    same(lambda t: (tmc.mc_luma_mbs(t["planes"], pad, t["ys"], t["xs"],
                                    t["mvx"] + 3, t["mvy"] - 1),))


@pytest.mark.cuda
def test_older_encoder_on_card(cuda_device):
    """The older Encoder on the card writes the CPU run's bytes and
    reference, and launches neither K1 nor K2 (integer-pel, unfiltered)."""
    from losslessh264_tpu_torch import encoder as tenc
    frames = moving_frames(3)
    cpu = tenc.Encoder(64, 48, qp=26, device="cpu")
    want = [cpu.encode_frame(*f) for f in frames]
    k1, k2 = tmc.halfpel_planes.launches, tdb.deblock_wavefront.launches
    card = tenc.Encoder(64, 48, qp=26, device=cuda_device)
    for f, w in zip(frames, want):
        assert card.encode_frame(*f) == w
    assert all(np.array_equal(a, b) for a, b in zip(card.ref, cpu.ref))
    assert (tmc.halfpel_planes.launches - k1,
            tdb.deblock_wavefront.launches - k2) == (0, 0)


@pytest.mark.cuda
def test_two_decoders_on_two_streams(cuda_device):
    """Two TorchDecoders decoding at once from two host threads, each on
    its own CUDA stream, each equal to a sequential decode; the launch
    counters count every launch of both."""
    from concurrent.futures import ThreadPoolExecutor
    # two GOPs of translating noise: bucketed MC (K1) on the P frames
    data = et.encode_yuv(moving_frames(6), 64, 48, qp=28, gop=3,
                         device="cpu")
    start, end, ctx = native.shard_plan(data, 2)[1]
    streams = [data[:start], ctx + data[start:end]]

    def decode(blob):
        with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
            dec = dt.TorchDecoder(blob, device=cuda_device)
            return [tuple(p.cpu().numpy() for p in f)
                    for f in dec.frames()]

    k1, k2 = tmc.halfpel_planes.launches, tdb.deblock_wavefront.launches
    want = [decode(b) for b in streams]
    seq = (tmc.halfpel_planes.launches - k1,
           tdb.deblock_wavefront.launches - k2)
    k1, k2 = tmc.halfpel_planes.launches, tdb.deblock_wavefront.launches
    with ThreadPoolExecutor(max_workers=2) as ex:
        got = list(ex.map(decode, streams))
    assert (tmc.halfpel_planes.launches - k1,
            tdb.deblock_wavefront.launches - k2) == seq
    assert seq[0] > 0 and seq[1] > 0
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert all(np.array_equal(a, b) for fg, fw in zip(g, w)
                   for a, b in zip(fg, fw))


@pytest.mark.cuda
@pytest.mark.parametrize("name,H,W,radius,kind,seed,scroll_dy,dtype,strided",
                         K5_CASES)
def test_dense_search_kernel_on_card(cuda_device, name, H, W, radius, kind,
                                     seed, scroll_dy, dtype, strided):
    """K5 equals the plain search on the card, every output, 3 launches:
    720p at radius 16 on noise, flat and periodic planes (the tie rule),
    64x48 at radius 4-6, widths that are not a multiple of the kernel's
    8-MB tile, scrolled and strided reference windows."""
    cur, ref = dense_search_case(H, W, radius, kind, seed, scroll_dy, dtype,
                                 strided, cuda_device)
    want = tme.dense_full_search_plain(cur, ref, radius)
    before = tme.dense_full_search.launches
    for _ in range(3):
        got = tme.dense_full_search(cur, ref, radius)
        for g3, w3 in zip(got, want):
            for g, w in zip(g3, w3):
                assert g.dtype == w.dtype and torch.equal(g, w)
    assert tme.dense_full_search.launches == before + 3
    if kind == "flat":     # every displacement ties: the first one wins
        assert (got[0][0] == -radius).all() and (got[0][1] == -radius).all()


@pytest.mark.cuda
def test_dense_search_kernel_synth720p(cuda_device):
    """K5 on synth720p's frame 1 against decoded frame 0, edge-padded as
    the encoder pads its reference, equals the plain search."""
    with open(os.path.join(DATA, "synth720p.264"), "rb") as fh:
        frames = dt.TorchDecoder(fh.read(), device=cuda_device).frames()
        f0, f1 = next(frames)[0], next(frames)[0]
    plane = dt._edge_pad(f0, 32)
    ref = plane[16:16 + 752, 16:16 + 1312]
    cur = f1.to(torch.int32)
    want = tme.dense_full_search_plain(cur, ref, 16)
    got = tme.dense_full_search(cur, ref, 16)
    assert all(torch.equal(g, w) for g3, w3 in zip(got, want)
               for g, w in zip(g3, w3))
    assert (want[0][2] > 0).any() and (want[0][0] != want[0][0][0]).any()


@pytest.mark.cuda
def test_dense_search_kernel_refuses_radius(cuda_device):
    """A radius past the key's 11 index bits raises on the card too."""
    cur, ref = dense_search_case(16, 32, 23, "random", 0, strided=False,
                                 device=cuda_device)
    with pytest.raises(ValueError, match="radius 23"):
        tme.dense_full_search(cur, ref, 23)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mb_w,mb_h,seed,n_main,n_slots,n_extra,edge",
                         K6_CASES)
def test_mc_bucket_kernel_on_card(cuda_device, name, mb_w, mb_h, seed,
                                  n_main, n_slots, n_extra, edge):
    """K6 (with K1 before it) equals the plain bucketed MC on the card, 3
    launches: 1, 2 and 32 table triples, 1 and 2 slots, 0 and 512 fix-up
    cells, MVs at +-MC_MV_MAX, far MBs (clipped and long MVs, fix-up cells
    on every ring slot, at the frame's corners)."""
    case = random_mc_case(mb_w, mb_h, seed, n_main, n_slots, n_extra, edge,
                          cuda_device)
    _check_mc_case(case[-1], n_main, n_slots, n_extra, edge)
    want = tmc.mc_bucketed_plain(*case, mb_w, mb_h)
    before = tmc.mc_bucketed.launches
    for _ in range(3):
        got = tmc.mc_bucketed(*case, mb_w, mb_h)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
    assert tmc.mc_bucketed.launches == before + 3


@pytest.mark.cuda
def test_mc_bucket_is_k1_and_one_k6_launch(cuda_device, monkeypatch):
    """On CUDA tensors mc_bucketed is K1 for the active slots and one K6
    launch, fix-up cells included: the fix-ups' torch path is never
    called (a sentinel in its place raises)."""
    def sentinel(*args, **kw):
        raise AssertionError("_mc_fixups ran on the CUDA path")
    for name, mb_w, mb_h, *rest in K6_CASES:
        case = random_mc_case(mb_w, mb_h, *rest, device=cuda_device)
        want = tmc.mc_bucketed_plain(*case, mb_w, mb_h)
        with monkeypatch.context() as m:
            m.setattr(tmc, "_mc_fixups", sentinel)
            before = (tmc.halfpel_planes.launches, tmc.mc_bucketed.launches)
            got = tmc.mc_bucketed(*case, mb_w, mb_h)
            after = (tmc.halfpel_planes.launches, tmc.mc_bucketed.launches)
        k1 = max(1, case[-1]["mc_nslots"])     # slot 0's planes always
        assert after == (before[0] + k1, before[1] + 1)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


@pytest.mark.cuda
def test_mc_bucket_kernel_refuses_window(cuda_device):
    """An entry whose taps leave the half-pel planes raises before the
    launch, as the plain version raises."""
    *rings, pad, p = random_mc_case(9, 4, 5, 5, 2, 3, False, cuda_device)
    p["mc_uniq"] = p["mc_uniq"].copy()
    p["mc_uniq"][1, 1] = 40          # the integer mvy of triple 1, in px
    before = tmc.mc_bucketed.launches
    for fn in (tmc.mc_bucketed, tmc.mc_bucketed_plain):
        with pytest.raises(ValueError, match="half-pel slice"):
            fn(*rings, pad, p, 9, 4)
    assert tmc.mc_bucketed.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("key,dtype", [("ref_slot", torch.int8),
                                       ("mv", torch.int32)])
def test_mc_bucket_kernel_refuses_plan_dtypes(cuda_device, key, dtype):
    """The kernel reads ref_slot as int32 and mv as int16, the decoder's
    dtypes; a plan of other widths raises before the launch."""
    *rings, pad, p = random_mc_case(9, 4, 5, 5, 2, 3, False, cuda_device)
    p[key] = p[key].to(dtype)
    before = tmc.mc_bucketed.launches
    with pytest.raises(ValueError, match=key):
        tmc.mc_bucketed(*rings, pad, p, 9, 4)
    assert tmc.mc_bucketed.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["synth720p.264", "runs720p.264"])
def test_mc_bucket_kernel_on_stream_plans(cuda_device, stream):
    """K6 equals the plain bucketed MC on every bucketed P frame of the
    stream, on the rings its decode gives that frame."""
    with open(os.path.join(DATA, stream), "rb") as fh:
        data = fh.read()
    frames = 0
    for i, *args in bucketed_mc_frames(data, cuda_device):
        want = tmc.mc_bucketed_plain(*args)
        got = tmc.mc_bucketed(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), i
        frames += 1
    assert frames > 0


# ---------------------------------------------------------------------------
# K7 (csrc/residual_dec.cu) and K8 (csrc/residual_enc.cu)
# ---------------------------------------------------------------------------
def _residual_case(mb_w, mb_h, seed, kw, device):
    """(p, pred_y, pred_u, pred_v) of a random_residual_case on `device`:
    the plane dict as the decoder uploads it and the frame's prediction
    (None on a frame without inter cells)."""
    planes, *rings = random_residual_case(mb_w, mb_h, seed, **kw)
    p = dt.planes_to_torch(planes, device)
    pred = dt._inter_pred(mb_w, mb_h, p, *(torch.as_tensor(r, device=device)
                                           for r in rings))
    return (p, *(pred or (None,) * 3))


def test_residual_wrappers_take_plain_version_on_cpu():
    """K7's and K8's wrappers on CPU tensors return their plain versions'
    results and launch nothing (the counts do not move, whatever card
    tests ran before in the process)."""
    before = (dt._residual_recon.launches, et.inter_residual.launches)
    case = _residual_case(9, 4, 0, {}, "cpu")
    got = dt._residual_recon(9, 4, *case)
    want = dt._residual_recon_plain(9, 4, *case)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    args = inter_residual_args(random_inter_residual_case(4, 3, 1, 2, "mb",
                                                          144))
    got = et.inter_residual(4, 3, *args)
    want = et.inter_residual_plain(4, 3, *args)
    assert all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))
    assert (dt._residual_recon.launches,
            et.inter_residual.launches) == before


def test_residual_entries_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        dt.k7_operands(9, 4, *_residual_case(9, 4, 0, {}, "cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        et.k8_operands(4, 3, *inter_residual_args(
            random_inter_residual_case(4, 3, 0, 1, 28, None)))


@pytest.mark.parametrize("name,mb_w,mb_h,seed,kw", K7_CASES)
def test_residual_cases(name, mb_w, mb_h, seed, kw):
    """random_residual_case's frames hold what K7's cases name: every
    class (PCM unless dropped) with its planes, the cbp_luma patterns and
    every cbp_chroma 0-2, MBs with a mix of valid and invalid ref_slot cells,
    levels at the int16 extremes, the MC route of the case, and with
    t8_all transform8 on every MB that is not I16."""
    p, *_ = random_residual_case(mb_w, mb_h, seed, **kw)
    pcm = kw.get("pcm", True)
    assert set(p["mb_class"].tolist()) == set(range(9 if pcm else 8))
    assert ("pcm" in p) == pcm and ("luma8" in p) == kw.get("t8", True)
    # every pattern where the frame has 16 MBs (the 4x3 and 5x3 frames
    # hold the first 12 and 15)
    assert set(p["cbp_luma"].tolist()) >= set(range(min(16, mb_w * mb_h)))
    assert set(p["cbp_chroma"].tolist()) == {0, 1, 2}
    assert (np.abs(p["luma_ac"].astype(np.int32)) >= 32767).any()
    valid = (p["ref_slot"] >= 0).sum(1)
    if kw.get("t8_all"):
        # transform8 on every MB but the I16 ones, off on those
        np.testing.assert_array_equal(p["transform8"] != 0,
                                      p["mb_class"] != 1)
    mc = kw.get("mc", "bucketed")
    assert bool(p["mc_any"]) == (mc != "none")
    assert bool(p["mc_fast"]) == (mc == "bucketed")
    if mc != "none":
        assert ((valid > 0) & (valid < 16)).any() and (valid == 16).any()


@pytest.mark.parametrize("name,mb_w,mb_h,seed,R,qp,rd_lam", K8_CASES)
def test_inter_residual_cases(name, mb_w, mb_h, seed, R, qp, rd_lam):
    """random_inter_residual_case's corner MBs take their chroma windows
    off the concatenated planes on every side (clamped), and its SADs put
    MBs on both sides of the intra fallback."""
    c = random_inter_residual_case(mb_w, mb_h, seed, R, qp, rd_lam)
    n, Wc = mb_w * mb_h, c["refcatU"].shape[1]
    my, mx = np.divmod(np.arange(n), mb_w)
    qx = (mx[:, None] * 8 + np.array([0, 4, 0, 4]) + 16
          + c["xoffC"].numpy()[:, None]).reshape(-1)
    qy = (my[:, None] * 8 + np.array([0, 0, 4, 4]) + 16).reshape(-1)
    ix = qx + (c["mvqx"].numpy() >> 3)
    iy = qy + (c["mvqy"].numpy() >> 3)
    H2 = c["refcatU"].shape[0]
    assert (ix < 0).any() and (ix > Wc - 5).any()
    assert (iy < 0).any() and (iy > H2 - 5).any()
    if qp == "mb":
        assert {0, 51} <= set(c["qp"].tolist())


def test_inter_residual_dc_shift_case():
    """random_inter_residual_case(dc_shift=True) holds MBs whose only
    levels are chroma DC levels (no_res false by them alone), beside MBs
    without any level."""
    args = inter_residual_args(random_inter_residual_case(
        9, 4, 9, 2, "mb", 144, dc_shift=True))
    out = et.inter_residual_plain(9, 4, *args)
    qac, cdc, cac, no_res = out[3], out[4], out[5], out[9]
    dc_only = ((qac == 0).all(2).all(1) & (cac == 0).all(3).all(2).all(1)
               & (cdc != 0).any(2).any(1))
    assert dc_only.sum() >= 2 and no_res.any()


@pytest.mark.cuda
@pytest.mark.parametrize("name,mb_w,mb_h,seed,kw", K7_CASES)
def test_residual_dec_kernel_on_card(cuda_device, name, mb_w, mb_h, seed, kw):
    """K7 equals the plain residual reconstruction on the card, 3
    launches, every output of the right dtype (the padded planes' border
    included)."""
    case = _residual_case(mb_w, mb_h, seed, kw, cuda_device)
    want = dt._residual_recon_plain(mb_w, mb_h, *case)
    before = dt._residual_recon.launches
    for _ in range(3):
        got = dt._residual_recon(mb_w, mb_h, *case)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
    assert dt._residual_recon.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("name,mb_w,mb_h,seed,R,qp,rd_lam", K8_CASES)
def test_residual_enc_kernel_on_card(cuda_device, name, mb_w, mb_h, seed, R,
                                     qp, rd_lam):
    """K8 equals the plain residual half of encode_inter_mbs on the card,
    3 launches."""
    args = inter_residual_args(random_inter_residual_case(
        mb_w, mb_h, seed, R, qp, rd_lam, cuda_device))
    want = et.inter_residual_plain(mb_w, mb_h, *args)
    before = et.inter_residual.launches
    for _ in range(3):
        got = et.inter_residual(mb_w, mb_h, *args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert et.inter_residual.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h,seed,R", [(9, 4, 9, 2), (80, 45, 10, 1)])
def test_residual_enc_kernel_dc_levels_alone(cuda_device, mb_w, mb_h, seed,
                                             R):
    """K8 equals its plain version where an MB's only levels are chroma DC
    levels, so that its no_res hinges on them (dc_shift)."""
    args = inter_residual_args(random_inter_residual_case(
        mb_w, mb_h, seed, R, "mb", 144, cuda_device, dc_shift=True))
    want = et.inter_residual_plain(mb_w, mb_h, *args)
    got = et.inter_residual(mb_w, mb_h, *args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_residual_wrappers_are_one_launch(cuda_device, monkeypatch):
    """On CUDA tensors each wrapper launches its kernel once and never
    calls its plain version (a sentinel in its place raises)."""
    def sentinel(*args, **kw):
        raise AssertionError("a plain version ran on the CUDA path")
    case = _residual_case(9, 4, 0, {}, cuda_device)
    args = inter_residual_args(random_inter_residual_case(
        4, 3, 1, 2, "mb", 144, cuda_device))
    want = (dt._residual_recon_plain(9, 4, *case),
            et.inter_residual_plain(4, 3, *args))
    monkeypatch.setattr(dt, "_residual_recon_plain", sentinel)
    monkeypatch.setattr(et, "inter_residual_plain", sentinel)
    before = (dt._residual_recon.launches, et.inter_residual.launches)
    got = (dt._residual_recon(9, 4, *case), et.inter_residual(4, 3, *args))
    assert (dt._residual_recon.launches,
            et.inter_residual.launches) == (before[0] + 1, before[1] + 1)
    for g2, w2 in zip(got, want):
        assert all(torch.equal(g, w) for g, w in zip(g2, w2))


@pytest.mark.cuda
@pytest.mark.parametrize("key,dtype", [("luma_ac", torch.int32),
                                       ("mb_class", torch.int32),
                                       ("ref_slot", torch.int16)])
def test_residual_dec_kernel_refuses_dtypes(cuda_device, key, dtype):
    """K7 reads the symbol layer's dtypes; other widths raise before the
    launch."""
    p, *pred = _residual_case(9, 4, 0, {}, cuda_device)
    p[key] = p[key].to(dtype)
    before = dt._residual_recon.launches
    with pytest.raises(ValueError, match=key):
        dt._residual_recon(9, 4, p, *pred)
    assert dt._residual_recon.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["synth720p.264", "runs720p.264"])
def test_residual_dec_kernel_on_streams(cuda_device, stream):
    """K7 equals the plain version on every frame of the stream's decode
    (the all-intra batch of runs720p included), and the decode's CRCs
    hold."""
    with open(os.path.join(DATA, stream), "rb") as fh:
        data = fh.read()
    gold = json.load(open(os.path.join(
        DATA, stream.replace(".264", "_np_crc.json"))))
    with HeldToPlain(dt, "_residual_recon", dt._residual_recon_plain) as held:
        crcs = [zlib.crc32(b"".join(a.cpu().numpy().tobytes() for a in yuv))
                for yuv in dt.TorchDecoder(data, device=cuda_device).frames()]
    assert crcs == gold[stream[:-4]]["crc32"]
    assert held.calls == len(crcs) and held.bad == []


@pytest.mark.cuda
def test_residual_enc_kernel_on_encode(cuda_device):
    """K8 equals the plain version on every P frame of a 2-reference
    CABAC encode with trellis rounding, once per P frame."""
    frames = moving_frames(5, 96, 64)
    enc = et.TorchEncoder(96, 64, qp=30, refs=2, cabac=True, trellis=True,
                          device=cuda_device)
    with HeldToPlain(et, "inter_residual", et.inter_residual_plain) as held:
        for f in frames:
            enc.encode_frame(*f)
    assert held.calls == 4 and held.bad == []


def _legacy_planes(mb_w, mb_h, p, *rings):
    """_mc_legacy_cells' tiles as planes, and the [H/4, W/4] bool plane of
    the inter cells (ref_slot >= 0)."""
    tiles = dt._mc_legacy_cells(mb_w, mb_h, p, *rings)
    planes = [dt._tiles_to_plane(t, mb_w, mb_h, s)
              for t, s in zip(tiles, (16, 8, 8))]
    inter = dt._tiles_to_plane((p["ref_slot"] >= 0).reshape(-1, 4, 4),
                               mb_w, mb_h, 4)
    return planes, inter


def _assert_cells_equal_legacy(got, mb_w, mb_h, p, *rings):
    """The per-cell route's planes `got` equal _mc_legacy_cells' on every
    inter cell (max_abs_err 0) and are 0 on every other cell."""
    want, inter = _legacy_planes(mb_w, mb_h, p, *rings)
    for g, w, s in zip(got, want, (4, 2, 2)):
        keep = inter.repeat_interleave(s, 0).repeat_interleave(s, 1)
        assert g.dtype == torch.int32
        assert int((g.long() - torch.where(keep, w, 0).long()).abs()
                   .max()) == 0


@pytest.mark.parametrize("name,mb_w,mb_h,seed,kw", K11_CASES[:5])
def test_cells_cases(name, mb_w, mb_h, seed, kw):
    """random_cells_case's frames are the ones K11's card cases name: the
    64 chroma (so the 16 luma) MV phases among inter cells the clip leaves
    alone, clipped cells with `far`, every ring slot, intra MBs with
    `intra`, and with WP every denominator -1..7 and a partial chroma
    mask; the plain route equals _mc_legacy_cells on the inter cells."""
    *rings, pad, p = random_cells_case(mb_w, mb_h, seed, **kw)
    n, H, W = mb_w * mb_h, 16 * mb_h, 16 * mb_w
    rs = p["ref_slot"].reshape(-1)
    mv = p["mv"].reshape(-1, 2).long()
    k = torch.arange(16 * n)
    cy = (k // 16 // mb_w) * 16 + (k % 16 // 4) * 4
    cx = (k // 16 % mb_w) * 16 + (k % 4) * 4
    fx, fy = 4 * cx + mv[:, 0], 4 * cy + mv[:, 1]
    clipped = ((fx < (2 - pad) * 4) | (fx > (W + pad - 19) * 4)
               | (fy < (2 - pad) * 4) | (fy > (H + pad - 19) * 4))
    free = (rs >= 0) & ~clipped
    phases = set(((mv[free, 0] & 7) * 8 + (mv[free, 1] & 7)).tolist())
    assert phases == set(range(64))
    assert bool(clipped[rs >= 0].any()) == bool(kw.get("far"))
    assert set(rs[rs >= 0].tolist()) == set(range(kw.get("slots", 4)))
    assert bool((rs < 0).any()) == (kw.get("intra", 0.1) > 0)
    if kw.get("wp"):
        assert set(p["wp_luma"][..., 2].reshape(-1).tolist()) == set(
            range(-1, 8))
        assert 0 < int(p["wp_cmask"].sum()) < p["wp_cmask"].numel()
    got = dt._mc_cells(mb_w, mb_h, p, *rings)
    want, _ = _legacy_planes(mb_w, mb_h, p, *rings)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    _assert_cells_equal_legacy(k11_plain(*rings, pad, p, mb_w, mb_h), mb_w,
                               mb_h, p, *rings)


def test_cells_route_takes_plain_version_on_cpu():
    """On CPU tensors the per-cell route (_inter_pred with mc_fast False,
    a WP frame) is _mc_legacy_cells' tiles as planes and launches nothing;
    K11's own wrapper refuses CPU tensors."""
    *rings, pad, p = random_cells_case(9, 4, 2, wp=True)
    before = tmc.mc_cells.launches
    got = dt._inter_pred(9, 4, p, *rings)
    want, _ = _legacy_planes(9, 4, p, *rings)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tmc.mc_cells.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tmc.mc_cells(*rings, pad, p, 9, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("name,mb_w,mb_h,seed,kw", K11_CASES)
def test_mc_cells_kernel_on_card(cuda_device, name, mb_w, mb_h, seed, kw):
    """K11 equals _mc_legacy_cells on every inter cell and is 0 elsewhere
    (max_abs_err 0), 3 launches: every luma and chroma MV phase, MVs far
    past the padded border, every ring slot (19 in one case), WP on luma
    and a partial chroma mask, 640x352 and 720p; and its planes' CRC is
    the JAX package's (tests/data/k11_jax_crc.json, which
    tests/test_torch_mc.py holds to decoder_jax._mc_legacy_cells)."""
    *rings, pad, p = random_cells_case(mb_w, mb_h, seed, device=cuda_device,
                                       **kw)
    want = k11_plain(*rings, pad, p, mb_w, mb_h)
    before = tmc.mc_cells.launches
    for _ in range(3):
        got = tmc.mc_cells(*rings, pad, p, mb_w, mb_h)
        assert all(g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
                   for g, w in zip(got, want)), name
        _assert_cells_equal_legacy(got, mb_w, mb_h, p, *rings)
    assert tmc.mc_cells.launches == before + 3
    with open(os.path.join(DATA, "k11_jax_crc.json")) as fh:
        jax_crc = json.load(fh)["crc32"][name]
    assert zlib.crc32(b"".join(g.cpu().numpy().tobytes()
                               for g in got)) == jax_crc


@pytest.mark.cuda
def test_mc_cells_route_is_one_k11_launch(cuda_device, monkeypatch):
    """On CUDA tensors the per-cell route of _inter_pred is one K11 launch
    and no torch chain: _mc_legacy_cells is never called (a sentinel in
    its place raises), nor K1 or K6."""
    def sentinel(*args, **kw):
        raise AssertionError("_mc_legacy_cells ran on the CUDA path")
    for name, mb_w, mb_h, seed, kw in K11_CASES:
        *rings, pad, p = random_cells_case(mb_w, mb_h, seed,
                                           device=cuda_device, **kw)
        want = k11_plain(*rings, pad, p, mb_w, mb_h)
        with monkeypatch.context() as m:
            m.setattr(dt, "_mc_legacy_cells", sentinel)
            before = (tmc.mc_cells.launches, tmc.mc_bucketed.launches,
                      tmc.halfpel_planes.launches)
            got = dt._inter_pred(mb_w, mb_h, p, *rings)
            after = (tmc.mc_cells.launches, tmc.mc_bucketed.launches,
                     tmc.halfpel_planes.launches)
        assert after == (before[0] + 1,) + before[1:], name
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


@pytest.mark.cuda
@pytest.mark.parametrize("key,dtype", [("ref_slot", torch.int64),
                                       ("mv", torch.int32),
                                       ("wp_luma", torch.int32),
                                       ("wp_cmask", torch.bool),
                                       ("wp_cr", None)])
def test_mc_cells_kernel_refuses_planes(cuda_device, key, dtype):
    """K11 reads the decoder's dtypes (ref_slot int32, mv and the WP
    weights int16, wp_cmask uint8) and the four WP planes together; a
    plane of another width, or a WP frame missing one, raises before the
    launch."""
    *rings, pad, p = random_cells_case(9, 4, 2, wp=True, device=cuda_device)
    if dtype is None:
        del p[key]
    else:
        p[key] = p[key].to(dtype)
    before = tmc.mc_cells.launches
    with pytest.raises(ValueError, match="per-cell MC"):
        tmc.mc_cells(*rings, pad, p, 9, 4)
    assert tmc.mc_cells.launches == before


@pytest.mark.cuda
def test_mc_bucket_fixups_every_phase(cuda_device):
    """K6's fix-up cells (the code it shares with K11, csrc/mc_cell.cuh)
    equal the plain bucketed MC on all 64 chroma (and 16 luma) MV phases
    and clipped MVs, on every ring slot: a far case whose fix-up cells'
    MVs take each phase in turn."""
    *rings, pad, p = random_mc_case(80, 45, 6, 2, 1, 32, "far", cuda_device)
    fix = p["mc_fix"][p["mc_fix"] >= 0].long()
    mv = p["mv"].reshape(-1, 2)
    k = torch.arange(len(fix), device=cuda_device)
    mv[fix, 0] = (mv[fix, 0] & ~7) | (k % 8).to(torch.int16)
    mv[fix, 1] = (mv[fix, 1] & ~7) | (k // 8 % 8).to(torch.int16)
    assert len(fix) == 512
    want = tmc.mc_bucketed_plain(*rings, pad, p, 80, 45)
    got = tmc.mc_bucketed(*rings, pad, p, 80, 45)
    assert all(g.dtype == w.dtype == torch.int32 and torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.cuda
def test_mc_cells_kernel_on_walk(cuda_device):
    """K11 equals the plain route on every per-cell frame of the walk
    stand-in's (bench_port/data/walk_analog_1331.264) first 24 frames and
    of its third GOP (frames 200-299, the scene cut at 280 among them),
    each decoded alone from its IDR, and the decodes' CRCs equal
    NpDecoder's (bench_port/reference/crc/walk_analog_1331.json)."""
    import sys
    bench = os.path.join(os.path.dirname(DATA), "..", "bench_port")
    sys.path.insert(0, bench)
    from harness import gops, streams
    with open(os.path.join(bench, "data", "walk_analog_1331.264"),
              "rb") as fh:
        data = fh.read()
    with open(os.path.join(bench, "reference", "crc",
                           "walk_analog_1331.json")) as fh:
        gold = json.load(fh)["crc32"]
    offsets = streams.access_unit_offsets(data)
    for first, end in ((0, 24), (200, 300)):
        clip = gops.gop_clip(data, first, end, offsets)
        with HeldToPlain(tmc, "mc_cells", k11_plain) as held:
            crcs = [zlib.crc32(b"".join(a.cpu().numpy().tobytes()
                                        for a in yuv))
                    for yuv in dt.TorchDecoder(clip,
                                               device=cuda_device).frames()]
        assert crcs == gold[first:end]
        assert held.calls > 0 and held.bad == [], (first, held.bad)
