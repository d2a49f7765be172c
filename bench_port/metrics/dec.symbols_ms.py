"""dec.symbols_ms: host symbol decode: native.SymbolDecoder's iteration, in
ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('symbols',))
