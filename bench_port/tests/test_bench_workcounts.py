"""The frozen work counts equal chip_smoke.py's on a few shapes, and the
frozen reference decoder is the repo's NpDecoder but for its import."""
import os

import pytest
import torch

from conftest import BENCH, ROOT
from harness import workcounts as wc


@pytest.fixture(scope="module")
def smoke():
    import chip_smoke
    return chip_smoke


def test_constants(smoke):
    from losslessh264_tpu_torch.ops import deblock as tdb, intra as tintra
    assert wc.DEBLOCK_PACK_LANES == sum(w for _, w in tdb._PACK_FIELDS)
    assert wc.DEBLOCK_PACK_WIDTH == tdb.PACK_WIDTH
    assert wc.K9_TABLE_BYTES == tdb._K9_TABLES.nbytes
    assert wc.K3_INFO_W == tintra.K3_INFO_W
    for name in ("HBM_BYTES_PER_S", "INT32_OPS_PER_S", "INT8_OPS_PER_S",
                 "K1_OPS_PER_POSITION", "K3_OPS_PER_MB", "K4_OPS_PER_MB",
                 "K7_OPS_PER_SAMPLE", "K8_OPS_PER_SAMPLE", "K9_OPS_PER_MB"):
        assert getattr(wc, name) == getattr(smoke, name), name


def test_size_counts(smoke):
    for Hp, Wp in ((784, 1344), (1152, 1984), (80, 112)):
        for entry in ("u8", "i32"):
            assert wc.k1_bytes(Hp, Wp, entry) == smoke.k1_bytes(Hp, Wp,
                                                                entry)
    for mb_w, mb_h in ((80, 45), (9, 4), (1, 1)):
        assert wc.k2_bytes(mb_w, mb_h) == smoke.k2_bytes(mb_w, mb_h)
        for B, k in ((1, 0), (4, mb_w * mb_h), (1, 3)):
            assert wc.k3_bytes(mb_w, mb_h, B, k) == \
                smoke.k3_bytes(mb_w, mb_h, B, k)
            assert wc.k4_bytes(mb_w, mb_h, k) == smoke.k4_bytes(mb_w, mb_h,
                                                                k)
    for H, W, R, cb in ((720, 1280, 16, 1), (48, 64, 3, 4)):
        assert wc.k5_bytes_ops(H, W, R, cb) == smoke.k5_bytes_ops(H, W, R,
                                                                  cb)


@pytest.mark.parametrize("case", [0, 5, 8])
def test_k6(smoke, case):
    from losslessh264_tpu_torch import cases
    _, mb_w, mb_h, seed, n_main, n_slots, n_extra, edge = \
        cases.K6_CASES[case]
    if mb_w > 20:
        mb_w, mb_h = 20, 12
    ry, ru, rv, pad, p = cases.random_mc_case(mb_w, mb_h, seed, n_main,
                                              n_slots, n_extra, edge)
    assert wc.k6_bytes_ops(tuple(ry.shape), tuple(ru.shape), pad, p, mb_w,
                           mb_h) == smoke.k6_bytes_ops(ry, ru, rv, pad, p,
                                                       mb_w, mb_h)


@pytest.mark.parametrize("case", [0, 1, 2, 3])
def test_k7(smoke, case):
    from losslessh264_tpu_torch import cases
    from losslessh264_tpu_torch.decoder_torch import planes_to_torch
    _, mb_w, mb_h, seed, kw = cases.K7_CASES[case]
    planes, *_ = cases.random_residual_case(mb_w, mb_h, seed, **kw)
    p = planes_to_torch(planes, "cpu")
    for pred in (None, torch.zeros(1)):
        assert wc.k7_bytes_ops(mb_w, mb_h, p, pred is not None) == \
            smoke.k7_bytes_ops(mb_w, mb_h, p, pred)


@pytest.mark.parametrize("case", [0, 3, 7])
def test_k8(smoke, case):
    from losslessh264_tpu_torch import cases
    _, mb_w, mb_h, seed, R, qp, rd_lam = cases.K8_CASES[case]
    c = cases.random_inter_residual_case(mb_w, mb_h, seed, R, qp, rd_lam)
    args = cases.inter_residual_args(c)
    assert wc.k8_bytes_ops(mb_w, mb_h, args) == smoke.k8_bytes_ops(
        mb_w, mb_h, args)


@pytest.mark.parametrize("case", [3, 4, 5])
def test_k9(smoke, case):
    from losslessh264_tpu_torch import cases
    _, mb_w, mb_h, seed, kw = cases.K9_CASES[case]
    args = cases.random_edge_case(mb_w, mb_h, seed, **kw)
    assert wc.k9_bytes_ops(mb_w, mb_h, args) == smoke.k9_bytes_ops(
        mb_w, mb_h, args)


def test_reference_decoder_is_the_repos():
    """decoder_np.py is losslessh264_tpu/decoder_np.py with its symbol
    layer imported from the reference's own binding (read as text: the
    JAX package is not imported)."""
    with open(os.path.join(ROOT, "losslessh264_tpu", "decoder_np.py")) as a:
        theirs = a.read()
    with open(os.path.join(BENCH, "reference", "decoder_np.py")) as b:
        ours = b.read()
    assert ours == theirs.replace("from . import native\n",
                                  "from . import symbols as native\n")
