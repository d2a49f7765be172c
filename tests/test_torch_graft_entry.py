"""The port's encoder-step entry points (losslessh264_tpu_torch/
graft_entry.py) equal __graft_entry__.py's on the CPU: the seeded
arguments, entry()'s step, one rank's per-frame step (analysis, in-loop
recon and deblock, coded-bits proxy) against the same JAX calls, and the
dryrun in two gloo processes against the step run in this process."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jg
from losslessh264_tpu import encoder_jax as ej
from losslessh264_tpu_torch import graft_entry as tg

torch.set_num_threads(1)


@pytest.mark.parametrize("mb_w,mb_h,batch,seed", [(4, 3, 1, 0),
                                                  (4, 3, 2, 0),
                                                  (5, 2, 3, 7)])
def test_tiny_frame_args_pinned(mb_w, mb_h, batch, seed):
    for g, w in zip(tg._tiny_frame_args(mb_w, mb_h, batch, seed),
                    jg._tiny_frame_args(mb_w, mb_h, batch, seed)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_entry_matches_jax():
    jfn, jargs = jg.entry()
    want = jax.jit(jfn)(*jargs)
    fn, args = tg.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    assert len(got) == len(want) == 14
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"output {i}")


def _jax_per_frame(mb_w, mb_h, Yf, Uf, Vf, rY, rU, rV, qpf):
    """__graft_entry__.dryrun_multichip's per_frame (a closure there),
    the same calls in the same order."""
    (mvx, mvy, use_intra, part, ref_sel, mv8, mvq, qac, cdc, cac,
     ty, tu, tv, no_res) = ej.encode_inter_mbs(mb_w, mb_h, 8, Yf, Uf, Vf,
                                               rY[None], rU[None], rV[None],
                                               qpf, qpf)
    recY, recU, recV = ej._p_finish(
        mb_w, mb_h, 0, ty, tu, tv,
        jnp.where(use_intra, 1, 3 + part).astype(jnp.int32),
        (qac != 0).any(-1), mvq[:, jnp.asarray(ej._CELL_PART8), :],
        jnp.broadcast_to(ref_sel[:, None], (mb_w * mb_h, 16)),
        qpf, jnp.zeros((mb_w * mb_h,), jnp.int32))
    bits = jnp.abs(qac).sum() + jnp.abs(cdc).sum() + jnp.abs(cac).sum()
    return recY, mvx, bits


def test_per_frame_and_dryrun_match_jax():
    """Each rank's step of a 2-frame batch equals JAX's per_frame; the
    2-process dryrun returns those steps, their all-reduced total, and
    no kernel launch on the CPU."""
    mb_w, mb_h = 4, 3
    Y, U, V, refY, refU, refV = jg._tiny_frame_args(mb_w, mb_h, batch=2)
    qp = np.full((mb_w * mb_h,), 28, np.int32)
    steps = []
    for r in range(2):
        want = _jax_per_frame(mb_w, mb_h, *(jnp.asarray(a[r]) for a in
                                            (Y, U, V, refY, refU, refV)),
                              jnp.asarray(qp))
        got = tg.per_frame(mb_w, mb_h, *tg.frame_args(mb_w, mb_h, 2, r,
                                                      "cpu"))
        for name, g, w in zip(("recY", "mvx", "bits"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"rank {r} {name}")
        steps.append(got)
    ranks = tg.dryrun_multichip(2, device="cpu")
    total = sum(int(s[2]) for s in steps)
    for (rank, recY, mvx, bits, tot, k1, k2, k5, k8, k9, ms), s in zip(
            ranks, steps):
        np.testing.assert_array_equal(recY, s[0].numpy())
        np.testing.assert_array_equal(mvx, s[1].numpy())
        assert bits == int(s[2]) and tot == total
        assert (k1, k2, k5, k8, k9) == (0, 0, 0, 0, 0) and ms > 0
    assert [r[0] for r in ranks] == [0, 1]


def test_cuda_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the card test covers cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tg.dryrun_multichip(2, device="cuda")
