"""TorchEncoder (losslessh264_tpu_torch/encoder_torch.py) against
JaxEncoder on the CPU: P8x8 and P16x8/P8x16 partitions, and a size that
is not a whole number of MBs (SPS cropping), the recipes of
tests/test_encoder_jax.py. Every frame's bytes and recon must equal
JaxEncoder's, and the port's CPU TorchDecoder must decode the port's
bytes to the port's recon (tests/test_torch_encoder_modes.py holds the
recipes and the other options)."""
import pytest

from losslessh264_tpu_torch import native as tnative

from test_torch_encoder_modes import check_recipe

tnative.load()


@pytest.mark.parametrize("name", ["p8x8", "p16x8_p8x16", "crop_50x38"])
def test_stream_matches_jax(name):
    check_recipe(name)
