"""dec.inter_ms: inter prediction: decoder_torch._inter_pred (K1 and K6, or
the per-cell route), in ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('inter',))
