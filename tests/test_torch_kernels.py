"""The port's two CUDA kernels against their plain torch versions.

K1 (csrc/halfpel.cu, ops/mc.halfpel_planes) and K2 (csrc/deblock.cu,
ops/deblock.deblock_wavefront) have no CPU mode. The tests marked
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

from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import encoder_torch as et
from losslessh264_tpu_torch import native
from losslessh264_tpu_torch.cases import moving_frames, random_deblock_case
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
    return sum(path == "aq" or kind == "I" or is_ref or n_intra
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
