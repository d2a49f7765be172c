"""The port's spatial simulcast against the JAX package's on the CPU:
inter-layer prediction at 200x120 (100x60 below it), sizes that are
not whole MBs, the recipe of tests/test_simulcast.py
(tests/test_torch_simulcast.py holds the checks and the other recipes;
each size's JaxEncoder compilations take their own file)."""
from losslessh264_tpu_torch import native as tnative

from test_torch_simulcast import assert_simulcast_exact

tnative.load()


def test_simulcast_matches_jax():
    assert_simulcast_exact("ilp_not_mb_aligned")
