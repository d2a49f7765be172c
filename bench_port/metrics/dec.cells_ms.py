"""dec.cells_ms: the per-cell MC route: decoder_torch._mc_legacy_cells (the
torch chain) or _mc_cells (K11 on the card), in ms per frame of the spanned
window; the route's time is taken out of dec.inter_ms's in the cells that
label it."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('cells',))
