"""dec.store_ms: ring store: TorchDecoder._finish_frame, _store_ref,
_store_refs_k, in ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('store',))
