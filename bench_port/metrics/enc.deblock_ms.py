"""enc.deblock_ms: deblock: the encoder's deblock stages (K9, K2), in ms
per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('deblock_host_planes', 'deblock_upload', 'deblock_edge_params', 'deblock_k2'))
