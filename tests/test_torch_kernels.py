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
from losslessh264_tpu_torch.ops import deblock as tdb
from losslessh264_tpu_torch.ops import mc as tmc

DATA = os.path.join(os.path.dirname(__file__), "data")
KEYS = ("cls", "qp", "nnz", "mv", "ref_idx", "slice_id", "deblock_idc",
        "alpha_off", "beta_off", "transform8")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _random_case(mb_w, mb_h, seed, device):
    """Random WPAD-padded planes and _edge_params of random symbols
    (the recipe of tests/test_deblock_impls.py)."""
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    P = tdb.WPAD
    planes = [torch.as_tensor(rng.randint(0, 256, s).astype(np.int32),
                              device=device)
              for s in ((H + 2 * P, W + 2 * P),
                        (H // 2 + 2 * P, W // 2 + 2 * P),
                        (H // 2 + 2 * P, W // 2 + 2 * P))]
    sym = dict(
        cls=rng.randint(0, 9, (n,)), qp=rng.randint(10, 52, (n,)),
        nnz=rng.randint(0, 3, (n, 16)), mv=rng.randint(-16, 17, (n, 16, 2)),
        ref_idx=rng.randint(0, 2, (n, 16)),
        slice_id=np.arange(n) // (mb_w * 2),
        deblock_idc=rng.choice([0, 0, 0, 1, 2], (n,)),
        alpha_off=rng.randint(-6, 7, (n,)) * 2,
        beta_off=rng.randint(-6, 7, (n,)) * 2,
        transform8=rng.randint(0, 2, (n,)))
    sym = [torch.as_tensor(np.asarray(sym[k], np.int32), device=device)
           for k in KEYS]
    return planes, sym, tdb._edge_params(mb_w, mb_h, *sym, seed)


def test_wrappers_take_plain_version_on_cpu():
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (40, 52), dtype=np.uint8))
    assert torch.equal(tmc.halfpel_planes(x), tmc.halfpel_planes_plain(x))
    planes, sym, params = _random_case(5, 4, 2, "cpu")
    got = tdb.deblock_frame(5, 4, *planes, *sym, 2)
    want = tdb.deblock_wavefront_plain(5, 4, *planes, params)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[0], planes[0])   # the filter fired


def test_kernel_entries_refuse_cpu_tensors():
    x = torch.zeros((40, 52), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        tmc._halfpel_launch(x, torch.int32)
    planes, _, params = _random_case(3, 2, 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tdb.deblock_wavefront(3, 2, *planes, params)


@pytest.mark.cuda
def test_halfpel_kernel_on_card(cuda_device):
    rng = np.random.default_rng(3)
    for shape in ((784, 1344), (42, 58), (6, 6), (101, 77)):
        x = torch.as_tensor(rng.integers(0, 256, shape, dtype=np.uint8),
                            device=cuda_device)
        want = tmc.halfpel_planes_plain(x)
        assert torch.equal(tmc.halfpel_planes(x), want)
        assert torch.equal(tmc._halfpel_planes_u8(x), want.to(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("mb_w,mb_h,seed", [(9, 4, 0), (22, 18, 1),
                                            (80, 45, 2)])
def test_deblock_kernel_on_card(cuda_device, mb_w, mb_h, seed):
    planes, _, params = _random_case(mb_w, mb_h, seed, cuda_device)
    want = tdb.deblock_wavefront_plain(mb_w, mb_h, *planes, params)
    got = tdb.deblock_wavefront(mb_w, mb_h, *planes, params)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_synth720p_on_card(cuda_device):
    gold = json.load(open(os.path.join(DATA, "synth720p_np_crc.json")))
    k1, k2 = tmc.halfpel_planes.launches, tdb.deblock_wavefront.launches
    with open(os.path.join(DATA, "synth720p.264"), "rb") as fh:
        dec = dt.TorchDecoder(fh.read(), device=cuda_device)
    crcs = [zlib.crc32(b"".join(a.cpu().numpy().tobytes() for a in yuv))
            for yuv in dec.frames()]
    assert crcs == gold["synth720p"]["crc32"]
    assert tmc.halfpel_planes.launches > k1
    assert tdb.deblock_wavefront.launches > k2
