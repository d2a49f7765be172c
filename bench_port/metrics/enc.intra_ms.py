"""enc.intra_ms: intra wavefront: the encoder's intra stage (K4), in ms per
frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('intra',))
