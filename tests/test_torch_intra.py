"""The torch port's intra predictors (losslessh264_tpu_torch/ops/intra.py,
table-driven and batched over lanes) are element-exact vs the JAX
predictors (losslessh264_tpu/ops/intra.py, vmapped) on random edges and
every combination of neighbour availability."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from losslessh264_tpu.ops import intra as jintra
from losslessh264_tpu_torch.ops import intra as tintra

# one torch thread per test worker (see tests/test_torch_decoder.py)
torch.set_num_threads(1)

K = 96


def T(a):
    return torch.as_tensor(np.asarray(a))


def _edges(seed, n_left, n_top, flat=False):
    rng = np.random.default_rng(seed)
    if flat:   # smooth content, so DC/plane sums stay mid-range
        base = rng.integers(40, 200, (K, 1))
        left = base + rng.integers(-3, 4, (K, n_left))
        top = base + rng.integers(-3, 4, (K, n_top))
    else:
        left = rng.integers(0, 256, (K, n_left))
        top = rng.integers(0, 256, (K, n_top))
    tl = rng.integers(0, 256, (K,))
    av = rng.integers(0, 2, (K, 3)).astype(bool)
    return (left.astype(np.uint8), top.astype(np.uint8),
            tl.astype(np.uint8), av)


@pytest.mark.parametrize("seed,flat", [(0, False), (1, True)])
def test_pred4_all(seed, flat):
    left, top, tl, av = _edges(seed, 4, 8, flat)
    want = jax.vmap(jintra.pred4_all)(left, top, tl, jnp.asarray(av[:, 0]),
                                      jnp.asarray(av[:, 1]))
    got = tintra.pred4_all(T(left), T(top), T(tl), T(av[:, 0]), T(av[:, 1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,flat", [(2, False), (3, True)])
def test_pred8_all(seed, flat):
    left, top, tl, av = _edges(seed, 8, 16, flat)
    want = jax.vmap(jintra.pred8_all)(left, top, tl, jnp.asarray(av[:, 0]),
                                      jnp.asarray(av[:, 1]),
                                      jnp.asarray(av[:, 2]))
    got = tintra.pred8_all(T(left), T(top), T(tl), T(av[:, 0]),
                           T(av[:, 1]), T(av[:, 2]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,flat", [(4, False), (5, True)])
def test_pred16_all(seed, flat):
    left, top, tl, av = _edges(seed, 16, 16, flat)
    want = jax.vmap(jintra.pred16_all)(left, top, tl, jnp.asarray(av[:, 0]),
                                       jnp.asarray(av[:, 1]))
    got = tintra.pred16_all(T(left), T(top), T(tl), T(av[:, 0]),
                            T(av[:, 1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,flat", [(6, False), (7, True)])
def test_pred_chroma_all(seed, flat):
    left, top, tl, av = _edges(seed, 8, 8, flat)
    want = jax.vmap(jintra.pred_chroma_all)(
        left, top, tl, jnp.asarray(av[:, 0]), jnp.asarray(av[:, 1]))
    got = tintra.pred_chroma_all(T(left), T(top), T(tl), T(av[:, 0]),
                                 T(av[:, 1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_order():
    np.testing.assert_array_equal(tintra.BLK_ORDER, jintra.BLK_ORDER)
