"""enc.transfer_ms: upload and fetch: the encoder's upload and fetch
stages, in ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('upload', 'fetch'))
