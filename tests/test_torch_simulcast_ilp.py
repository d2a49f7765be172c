"""The port's spatial simulcast against the JAX package's on the CPU:
inter-layer prediction at 96x64 (48x32 below it) on a gradient, on a
saturating checkerboard and on tiles, the recipes of
tests/test_simulcast.py (tests/test_torch_simulcast.py holds the checks
and the other recipes)."""
import pytest

from losslessh264_tpu_torch import native as tnative

from test_torch_simulcast import assert_simulcast_exact

tnative.load()


@pytest.mark.parametrize("name", ["ilp_gradient", "ilp_saturated",
                                  "ilp_tiles"])
def test_simulcast_matches_jax(name):
    assert_simulcast_exact(name)
