"""enc.search_ms: motion search: the encoder's dense_search (K5) and
subpel_k1 stages, in ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('dense_search', 'subpel_k1'))
