"""K4's plain versions against encoder_jax.intra_wavefront at 5x4 MBs,
on the CPU: qp 0, 26 and 51 everywhere and per-MB qp planes, every MB
intra (even seeds) or a random half (odd seeds), slices on some rows
(see tests/test_torch_intra_kernels.py)."""
import numpy as np
import pytest
import torch

from test_torch_intra_kernels import check_k4

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,qp", [(0, 0), (2, 26), (4, 51), (6, "aq"),
                                     (1, 26), (3, "aq"), (5, 0)])
def test_k4_matches_jax(seed, qp):
    cls = check_k4(5, 4, seed, qp)
    if seed % 2 == 0 and qp != 51:    # both luma classes occur
        assert (cls == 0).any() and (cls == 1).any()
