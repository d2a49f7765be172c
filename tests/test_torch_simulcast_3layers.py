"""The port's spatial simulcast against the JAX package's on the CPU:
three dyadic layers of 128x64 (32x16, 64x32, 128x64), the recipe of tests/test_simulcast.py
(tests/test_torch_simulcast.py holds the checks and the other recipes;
each size's JaxEncoder compilations take their own file)."""
from losslessh264_tpu_torch import native as tnative

from test_torch_simulcast import assert_simulcast_exact

tnative.load()


def test_simulcast_matches_jax():
    assert_simulcast_exact("three_layers")
