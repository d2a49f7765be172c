"""The port's sparse intra pass (decoder_torch._intra_scan_sparse,
TorchDecoder._intra_sel / _intra_diags and the routing of _decode_one)
against the JAX package's (JaxDecoder), NpDecoder and its own full-table
pass, on a stream that the port's TorchEncoder writes in the test:
192x128 (26 diagonals), an IDR, then P frames whose intra MBs populate
0, 1, 8 and all 26 diagonals (cases.patch_frames). Its P frames are
coefficient-dense (fresh noise at qp 16), so JaxDecoder decodes each
one by one (_decode_one over _intra_diags), as the port does.

The JAX package is imported inside the CPU tests, not at the top: the
card's machine has no JAX, and the `cuda` twin at the end runs there
(`python -m pytest tests/test_torch_decoder_runs.py -m cuda`)."""
import functools

import numpy as np
import pytest
import torch

from losslessh264_tpu_torch import cases
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.encoder_torch import TorchEncoder

# the native library built under the port's lock while the workers
# collect (tests/test_torch_decoder.py says why); one intra-op thread
tnative.load()
torch.set_num_threads(1)

W, H = 192, 128
MB_W, MB_H = W // 16, H // 16
# patched diagonals per frame; the frame after a patched one codes the
# MBs that the patches cover in its reference as intra too
PLAN = [[], [], [3], [], list(range(2, 24, 3)), [], list(range(26)), [], []]
# the intra route each frame takes in the port's decoder
ROUTES = [("full", 26), ("none", 0), ("sparse", 1), ("none", 0),
          ("sparse", 8), ("none", 0), ("full", 26), ("sparse", 10),
          ("none", 0)]


@functools.lru_cache(maxsize=None)
def sparse_stream():
    enc = TorchEncoder(W, H, qp=16, device="cpu")
    return b"".join(enc.encode_frame(*f)
                    for f in cases.patch_frames(W, H, PLAN, noise=8))


def decode(data, device):
    dec = dt.TorchDecoder(data, device=device)
    return [tuple(p.cpu().numpy() for p in f) for f in dec.frames()], dec


def same(a, b):
    return len(a) == len(b) and all(
        all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in
            zip(fa, fb)) for fa, fb in zip(a, b))


@pytest.mark.parametrize("mb_w,mb_h", [(12, 8), (4, 3), (80, 45), (1, 20)])
def test_intra_sel_matches_jax(mb_w, mb_h):
    """_intra_sel's kind and 16-row table equal JaxDecoder's, and
    _intra_diags gives JAX's rows without its -1 padding rows, on
    random masks of every density (one MB, a few, a tenth, all)."""
    from losslessh264_tpu.decoder_jax import JaxDecoder
    jd = JaxDecoder(b"")
    n = mb_w * mb_h
    rng = np.random.default_rng(mb_w * 100 + mb_h)
    kinds = set()
    for count in (0, 1, 2, 3, 5, 9, n // 10, n // 3, n):
        for _ in range(3):
            mask = np.zeros(n, bool)
            mask[rng.choice(n, min(count, n), replace=False)] = True
            kind, sel = dt.TorchDecoder._intra_sel(mb_w, mb_h, mask)
            jkind, jsel = jd._intra_sel(mb_w, mb_h, mask)
            assert kind == jkind and np.array_equal(sel, jsel)
            kinds.add(kind)
            diags, full = dt.TorchDecoder._intra_diags(mb_w, mb_h, mask)
            jdiags, jfull = jd._intra_diags(mb_w, mb_h, mask)
            assert (diags is None) == (jdiags is None)
            if diags is not None:
                jdiags = np.asarray(jdiags)
                assert full == jfull
                if not full:
                    jdiags = jdiags[jdiags[:, 0] >= 0]
                assert np.array_equal(diags, jdiags)
    assert kinds == ({0, 3} if 2 * (mb_h - 1) + mb_w <= 16
                     else {0, 1, 2, 3})


def test_sparse_stream_matches_jax_and_np(monkeypatch):
    """Every frame equals JaxDecoder's and NpDecoder's, and both
    decoders planned the same intra pass for each: JAX's _intra_diags
    (recorded by a wrapper) chose the sparse table with the port's rows,
    the full table, or none, as the port's routes show."""
    from losslessh264_tpu import decoder_jax, decoder_np
    from losslessh264_tpu.ops import mc as jmc
    monkeypatch.setattr(jmc, "halfpel_planes_pallas", jmc.halfpel_planes)
    planned = []
    orig = decoder_jax.JaxDecoder._intra_diags

    def record(self, mb_w, mb_h, intra_mask):
        diags, full = orig(self, mb_w, mb_h, intra_mask)
        rows = 0 if diags is None else int(
            (np.asarray(diags)[:, 0] >= 0).sum())
        planned.append(("none" if diags is None else
                        "full" if full else "sparse", rows))
        return diags, full

    monkeypatch.setattr(decoder_jax.JaxDecoder, "_intra_diags", record)
    data = sparse_stream()
    got, dec = decode(data, "cpu")
    assert dec.routes == ROUTES
    assert same(got, list(decoder_np.NpDecoder(data).frames()))
    assert same(got, list(decoder_jax.JaxDecoder(data).frames()))
    assert planned == ROUTES


def test_sparse_pass_equals_full_pass():
    """On every frame with a sparse plan, the plane-carrying pass over
    the populated diagonals equals the compact-carry pass over all 26,
    from the same residual and inter planes."""
    dec = dt.TorchDecoder(sparse_stream(), device="cpu")
    checked = 0
    for f in dec.sym:
        dec._prep_refs(MB_W, MB_H)
        planes_np, diags, has_intra, full = dec._prep_planes(f)
        p = dt.planes_to_torch(planes_np, dec.device)
        work = dt._residual_and_inter(MB_W, MB_H, p, dec.ref_y, dec.ref_u,
                                      dec.ref_v)
        planes = work[:3]
        if has_intra:
            planes = dt._intra_scan(MB_W, MB_H, *work, p,
                                    dt.diagonals(MB_W, MB_H))
        if has_intra and not full:
            sparse = dt._intra_scan_sparse(MB_W, MB_H, *work, p, diags)
            assert all(torch.equal(a, b) for a, b in zip(sparse, planes))
            checked += 1
        dec._finish_frame(f, *dt._deblock_crop(MB_W, MB_H, *planes, p),
                          False)
    assert checked == 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sparse_stream_on_card(cuda_device):
    """The card's decode of the stream equals the CPU path's, frame for
    frame and route for route."""
    data = sparse_stream()
    want, dec_cpu = decode(data, "cpu")
    got, dec = decode(data, cuda_device)
    assert dec.routes == dec_cpu.routes == ROUTES
    assert same(got, want)
