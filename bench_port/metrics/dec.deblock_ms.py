"""dec.deblock_ms: deblock and crop: decoder_torch._deblock_crop (K9 and
K2), _crop, in ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('deblock',))
