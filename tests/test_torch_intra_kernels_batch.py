"""K3's plain versions against the JAX package at 5x4 MBs, on the CPU:
one frame, the sparse pass over a subset of the diagonals, and three
frames in one batched pass (see tests/test_torch_intra_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import torch

from losslessh264_tpu import decoder_jax
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch.cases import random_intra_case
from losslessh264_tpu_torch.ops import intra as tintra

from test_torch_intra_kernels import (_covers, _frame, _intra_raster, _same,
                                      check_k3_frame)

torch.set_num_threads(1)

MB_W, MB_H = 5, 4


def test_k3_frame_matches_jax():
    cov = check_k3_frame(MB_W, MB_H, 6)
    assert cov["i4"] and cov["i8"] and cov["i16"]


def test_k3_sparse_rows_match_jax():
    """A P-like frame whose intra MBs populate 4 of the 11 diagonals (an
    I4x4, an I8x8, an I16x16 and an I4x4 with transform8, between inter
    and PCM MBs): the sparse pass over those rows, the wrapper and the
    raster twin equal JAX's _intra_scan_sparse over the same rows."""
    case = list(random_intra_case(MB_W, MB_H, 1, 7))
    p = case[6]
    cls = p["mb_class"][0]
    cls[np.isin(cls.numpy(), [0, 1, 2])] = 3
    # MBs 2, 3, 8 and 16: diagonals 2, 3, 5 and 7
    cls[[2, 3, 8, 16]] = torch.tensor([0, 2, 1, 0], dtype=cls.dtype)
    p["transform8"][0, 2] = 0
    p["transform8"][0, 16] = 1
    one = _frame(case, 0)
    diags = dt.diagonals(MB_W, MB_H)
    rows = diags[[2, 3, 5, 7]]
    args = [a.numpy() for a in one[:6]]
    pj = {k: jnp.asarray(v.numpy()) for k, v in one[6].items()}
    want = decoder_jax.intra_pass_sparse(MB_W, MB_H, *args, pj,
                                         jnp.asarray(rows))
    _same(dt._intra_scan_sparse(MB_W, MB_H, *one, rows), want, "sparse")
    _same(dt._intra_scan(MB_W, MB_H, *one, diags), want, "full")
    _same(tintra.intra_recon(MB_W, MB_H, *one), want, "intra_recon")
    _same(_intra_raster(MB_W, MB_H, *one), want, "raster twin")
    assert not np.array_equal(np.asarray(want[0]), args[0])


def test_k3_batch_matches_jax():
    """B = 3 frames: the batched pass that recon_intra_batch runs (one K3
    launch on the card), intra_recon's CPU route and the raster twin per
    frame equal JAX's _intra_scan on each frame, which is what
    decoder_jax.recon_intra_batch vmaps over its frames (:737). (The
    port's recon_intra_batch is held to JAX's end to end in
    tests/test_torch_decoder_intra_batch.py.)"""
    B = 3
    case = random_intra_case(MB_W, MB_H, B, 8)
    diags = dt.diagonals(MB_W, MB_H)
    got = dt._intra_scan(MB_W, MB_H, *case, diags)
    wrapped = tintra.intra_recon(MB_W, MB_H, *case)
    cov = []
    for b in range(B):
        one = _frame(case, b)
        args = [a.numpy() for a in one[:6]]
        pj = {k: jnp.asarray(v.numpy()) for k, v in one[6].items()}
        want = decoder_jax.intra_pass(MB_W, MB_H, *args, pj,
                                      jnp.asarray(diags))
        _same([g[b] for g in got], want, f"batched pass frame {b}")
        _same([g[b] for g in wrapped], want, f"intra_recon frame {b}")
        _same(_intra_raster(MB_W, MB_H, *one), want, f"raster frame {b}")
        cov.append(_covers({k: v.numpy() for k, v in one[6].items()}))
    assert all(any(c[k] for c in cov) for k in cov[0])
