"""K9's plain version (losslessh264_tpu_torch/ops/deblock.py
edge_params_packed_plain, the packed _edge_params the CUDA kernel
csrc/deblock_params.cu computes) equals the JAX package's edge parameters
packed as its Pallas kernel reads them
(deblock_pallas._pack_params(deblock._edge_params(...), arange(n))), in
all 384 lanes of every row, over cases.K9_CASES: the decoder's dtypes,
int32, the encoder's planes (bool nnz, an expanded ref_idx, absent
offsets and transform8, one deblock_idc), PCM, qp 0 and 51 with offsets
of +-12, chroma QP offsets of +-12, deblock_idc 1 and 2 with slices that
start mid-row, transform8 on intra and inter MBs, MV differences of 3, 4
and -4, and frames of 1x1, 1x5, 5x1, 9x4 and 80x45 MBs. JAX gets the
planes as int32 (its decoder casts them so before deblock_pass)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from losslessh264_tpu.ops import deblock as jdb
from losslessh264_tpu.ops import deblock_pallas as jdp
from losslessh264_tpu_torch.cases import K9_CASES, random_edge_case
from losslessh264_tpu_torch.ops import deblock as tdb

# one torch thread per test worker (see tests/test_torch_decoder.py)
torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnums=(0, 1, 12))
def _jax_packed(mb_w, mb_h, *args):
    planes, coff = args[:10], args[10]
    return jdp._pack_params(jdb._edge_params(mb_w, mb_h, *planes, coff),
                            jnp.arange(mb_w * mb_h))


def _int32(n, case):
    """The case's planes as JAX's decoder hands them over: int32 numpy,
    an absent plane as zeros, an int deblock_idc as a plane of it."""
    return [np.asarray(a.to(torch.int32)) if torch.is_tensor(a)
            else np.full((n,) + shape, a or 0, np.int32)
            for (_, shape), a in zip(tdb._K9_PLANES, case[:10])]


@pytest.mark.parametrize("name,mb_w,mb_h,seed,kw", K9_CASES)
def test_packed_edge_params_match_jax(name, mb_w, mb_h, seed, kw):
    case = random_edge_case(mb_w, mb_h, seed, **kw)
    got = tdb.edge_params_packed_plain(mb_w, mb_h, *case)
    want = np.asarray(_jax_packed(mb_w, mb_h, *_int32(mb_w * mb_h, case),
                                  case[10]))
    assert got.dtype == torch.int32
    assert got.shape == (mb_w * mb_h, tdb.PACK_WIDTH) == want.shape
    assert torch.equal(got, torch.from_numpy(np.array(want)))
    assert not got[:, 344:].any()
    # the wrapper takes the plain version on CPU tensors, and launches none
    before = tdb.edge_params_packed.launches
    assert torch.equal(tdb.edge_params_packed(mb_w, mb_h, *case), got)
    assert tdb.edge_params_packed.launches == before


@pytest.mark.parametrize("name,mb_w,mb_h,seed,kw", K9_CASES)
def test_edge_cases_hold_what_they_name(name, mb_w, mb_h, seed, kw):
    """random_edge_case's frames hold what K9_CASES names: its dtypes (the
    encoder's with their absent planes and views), and on frames of 9 MBs
    or more every class, transform8 on intra and inter MBs, a slice that
    starts mid-row, MV differences of 3, 4 and -4 between neighbouring
    cells, offsets of -12 and +12, and the deblock_idc asked for."""
    case = random_edge_case(mb_w, mb_h, seed, **kw)
    cls, qp, nnz, mv, ref, sid, idc, aoff, boff, t8, coff = case
    n = mb_w * mb_h
    dtypes = kw.get("dtypes", "decoder")
    if dtypes == "encoder":
        assert nnz.dtype == torch.bool and ref.stride() == (1, 0)
        assert (aoff, boff, t8) == (None, None, None)
        assert idc == kw["idc"]
    else:
        want = ([torch.int32] * 10 if dtypes == "int32" else
                [torch.uint8, torch.uint8, torch.int64, torch.int16,
                 torch.int8, torch.uint8, torch.uint8, torch.int8,
                 torch.int8, torch.uint8])
        assert [a.dtype for a in case[:10]] == want
        if "idc" in kw:
            assert (idc == kw["idc"]).all()
    if "qp" in kw:
        assert (qp == kw["qp"]).all()
    if "coff" in kw:
        assert coff == kw["coff"]
    if n < 9:
        return
    assert set(cls.tolist()) == set(range(9))
    intra = torch.isin(cls.to(torch.int32), torch.tensor([0, 1, 2, 8]))
    if t8 is not None:
        assert t8[intra].any() and t8[~intra].any()
        assert {-12, 12} <= set(aoff.tolist()) & set(boff.tolist())
    starts = torch.nonzero(sid[1:] != sid[:-1]).reshape(-1) + 1
    assert (starts % mb_w != 0).any()
    d = (mv.to(torch.int32).reshape(n, 4, 4, 2).diff(dim=2)).reshape(-1)
    assert {3, 4, -4} <= set(d.tolist())
