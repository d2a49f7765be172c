"""K4's plain versions against encoder_jax.intra_wavefront on one MB
column and one MB row, on the CPU (see tests/test_torch_intra_kernels.py)."""
import pytest
import torch

from test_torch_intra_kernels import check_k4

torch.set_num_threads(1)


@pytest.mark.parametrize("seed,qp", [(0, 26), (1, "aq"), (2, 51)])
def test_k4_one_mb_column_matches_jax(seed, qp):
    check_k4(1, 3, seed, qp)


@pytest.mark.parametrize("seed,qp", [(3, 0), (4, "aq"), (6, 26)])
def test_k4_one_mb_row_matches_jax(seed, qp):
    check_k4(5, 1, seed, qp)
