"""The port's two CUDA kernels against their plain torch versions.

K1 (csrc/halfpel.cu, ops/mc.halfpel_planes) and K2 (csrc/deblock.cu,
ops/deblock.deblock_wavefront) have no CPU mode. The tests marked
`cuda` build them with nvcc and compare them on the card with
torch.equal; they skip without CUDA. This file imports no JAX, so it
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

from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import native
from losslessh264_tpu_torch.cases import random_deblock_case
from losslessh264_tpu_torch.ops import deblock as tdb
from losslessh264_tpu_torch.ops import mc as tmc

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


def test_kernel_entries_refuse_cpu_tensors():
    x = torch.zeros((40, 52), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        tmc._halfpel_launch(x, torch.int32)
    planes, _, params = random_deblock_case(3, 2, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tdb.deblock_wavefront(3, 2, *planes, params)


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
    planes, sym, _ = random_deblock_case(80, 45, 7, cuda_device)
    before = tdb.deblock_wavefront.launches
    tdb.deblock_frame(80, 45, *planes, *sym, 7)
    torch.cuda.synchronize()
    assert tdb.deblock_wavefront.launches == before + 1


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
