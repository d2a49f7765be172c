"""dec.intra_ms: intra pass: _intra_scan, _intra_scan_sparse, and the whole
call of recon_intra_batch (K3), in ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('intra',))
