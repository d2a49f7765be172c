"""The plain versions of K7 (csrc/residual_dec.cu) and K8
(csrc/residual_enc.cu) against the JAX package on the CPU, exact.

K7's plain version sits behind decoder_torch._residual_and_inter: its
results equal decoder_jax.recon_pre (the JAX program K7 replaces, with
its motion compensation) on cases.random_residual_case frames: every
class, cbp and MC route, PCM, 8x8 transforms, scaling matrices, qp 0 and
51, chroma QP offsets of +-12 and levels at the int16 extremes. JAX
reaches the Pallas half-pel kernel on the bucketed route, so it is
swapped for its plain twin (the plain_pallas fixture).

K8's plain version is the residual half of encoder_torch.encode_inter_mbs:
the whole function equals encoder_jax.encode_inter_mbs on
cases.random_inter_residual_case frames, per-MB qp with 0 and 51, rd_lam
None and 144, R = 1 and 2. The subpel refinement in both is replaced by
the case's result (ops.me.subpel_quad in either package returns the
same MVs, SADs and predictions), so that MVs the search cannot reach
(chroma windows clamped on every side) and SADs on both sides of the
intra fallback reach both residual halves; JAX's function is traced
afresh for that. The kernels themselves run only on the card
(tests/test_torch_kernels.py, chip_smoke.py)."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from losslessh264_tpu import decoder_jax, encoder_jax
from losslessh264_tpu.ops import me as jme
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import encoder_torch as et
from losslessh264_tpu_torch import ref_np
from losslessh264_tpu_torch.cases import (K7_CASES, K8_CASES,
                                          random_inter_residual_case,
                                          random_residual_case)
from losslessh264_tpu_torch.ops import me as tme
from losslessh264_tpu_torch.ops import transform as tt

from test_torch_decoder import plain_pallas  # noqa: F401

torch.set_num_threads(1)

CUH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "losslessh264_tpu_torch", "csrc", "transform.cuh")
RADIUS = 4


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=what)


def _cuh_table(name):
    text = open(CUH).read()
    if name == "ZZ4":       # packed into zz4's nibbles
        v = int(re.search(r"\((0x[0-9a-f]+)ull >> \(4 \* i\)\)", text)
                .group(1), 16)
        return np.array([(v >> (4 * i)) & 15 for i in range(16)])
    m = re.search(r"__constant__ int32_t " + name + r"(\[\d+\])+ = \{(.*?)\};",
                  text, re.S)
    return np.array([int(v) for v in re.findall(r"-?\d+", m.group(2))])


@pytest.mark.parametrize("name,table", [
    ("V4", ref_np.V4), ("POS4", ref_np.POS4), ("V8", ref_np.V8),
    ("POS8", ref_np.POS8), ("MF4", tt.MF4_V[:, [0, 1, 0], [0, 1, 1]]),
    ("CHROMA_QP", ref_np.CHROMA_QP), ("ZZ4", ref_np.ZZ4)])
def test_kernel_tables(name, table):
    """The constant tables of csrc/transform.cuh are the Python ones (MF4
    by position class: (0, 0), (1, 1) and (0, 1) of MF4_V)."""
    _eq(_cuh_table(name), np.asarray(table).reshape(-1), name)


SMALL_K7 = [c for c in K7_CASES if c[1] * c[2] < 100]


@pytest.mark.parametrize("name,mb_w,mb_h,seed,kw", SMALL_K7)
def test_residual_and_inter_matches_jax(plain_pallas, name, mb_w, mb_h, seed,
                                        kw):
    planes, *rings = random_residual_case(mb_w, mb_h, seed, **kw)
    want = decoder_jax.recon_pre(mb_w, mb_h, jax.device_put(planes),
                                 *(jnp.asarray(r) for r in rings))
    p = dt.planes_to_torch(planes, "cpu")
    got = dt._residual_and_inter(mb_w, mb_h, p,
                                 *(torch.as_tensor(r) for r in rings))
    for g, w, what in zip(got, want, ("Yw", "Uw", "Vw", "res_y", "res_u",
                                      "res_v")):
        _eq(g.numpy(), w, f"{name}: {what}")
    assert dt._residual_recon.launches == 0
    # the frame reconstructs inter MBs unless it has no prediction
    assert bool(got[0].any()) == (kw.get("mc") != "none" or
                                  "pcm" in planes)


SMALL_K8 = [c for c in K8_CASES if c[1] * c[2] < 100]


@pytest.mark.parametrize("name,mb_w,mb_h,seed,R,qp,rd_lam", SMALL_K8)
def test_encode_inter_mbs_matches_jax(monkeypatch, name, mb_w, mb_h, seed, R,
                                      qp, rd_lam):
    case = random_inter_residual_case(mb_w, mb_h, seed, R, qp, rd_lam)
    sub = [case[k].numpy() for k in ("mvqx", "mvqy", "best_sad", "pred_q")]
    monkeypatch.setattr(jme, "subpel_quad", lambda *a: tuple(
        jnp.asarray(s) for s in sub))
    monkeypatch.setattr(tme, "subpel_quad", lambda *a: tuple(
        torch.as_tensor(s) for s in sub))
    keys = ("Y", "U", "V", "refY_s", "refU_s", "refV_s", "qp", "qpc")
    fresh = jax.jit(encoder_jax.encode_inter_mbs.__wrapped__,
                    static_argnames=("mb_w", "mb_h", "radius"))
    want = fresh(mb_w, mb_h, RADIUS, *(case[k].numpy() for k in keys),
                 rd_lam=rd_lam)
    got = et.encode_inter_mbs(mb_w, mb_h, RADIUS, *(case[k] for k in keys),
                              rd_lam=rd_lam)
    names = ("mvx", "mvy", "use_intra", "part", "ref_sel", "mv8", "mvq",
             "luma_ac", "chroma_dc", "chroma_ac", "tile_y", "tile_u",
             "tile_v", "no_res")
    for what, g, w in zip(names, got, want):
        _eq(g.numpy(), w, f"{name}: {what}")
    assert et.inter_residual.launches == 0
    use_intra, no_res = got[2].numpy(), got[13].numpy()
    assert use_intra.any() and not use_intra.all()
    assert no_res.any() and not no_res.all()
