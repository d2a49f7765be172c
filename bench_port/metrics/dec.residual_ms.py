"""dec.residual_ms: residual reconstruction: decoder_torch._residual_recon
(K7), in ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('residual',))
