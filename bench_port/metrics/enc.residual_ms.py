"""enc.residual_ms: residual and chroma: the encoder's residual stage (K8),
in ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('residual',))
