"""enc.writer_ms: the native writer (encoder_native.write_frame), in ms per
frame of the spanned window: the main thread's write stage (IDRs and the
frames outside full runs) plus the ms it waited for the writer thread
that writes the runs (TorchEncoder.prof["writer_wait_ms"])."""
from harness.readers import counter_ms, stage_ms


def read(t):
    parts = [v for v in (stage_ms(t, ("write",)),
                         counter_ms(t, "writer_wait_ms")) if v is not None]
    return sum(parts) if parts else None
