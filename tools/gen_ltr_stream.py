"""Regenerate tests/data/ltr_gap_64x48.264: the long-term-reference
long-gap stream of tests/test_decode_parity.py::test_jax_ltr_long_gap_eviction,
written once so that tests can decode it without encoding it.

Usage: python tools/gen_ltr_stream.py

24 frames of 64x48 noise translating by (2, 3) px per frame
(RandomState(5)), encoded by encoder_jax.JaxEncoder(64, 48, qp=28,
ltr=True): frame 1 is marked long-term and frame 23 recovers from it,
a gap longer than the decoder's 18-slot reference ring. Takes about a
minute on one CPU core (JAX on the CPU).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                   "ltr_gap_64x48.264")
N_FRAMES = 24


def encode():
    from losslessh264_tpu import encoder_jax
    rng = np.random.RandomState(5)
    bg = rng.randint(0, 255, (160, 200)).astype(np.uint8)
    enc = encoder_jax.JaxEncoder(64, 48, qp=28, ltr=True)
    data = b""
    for i in range(N_FRAMES):
        if i == 1:
            enc.mark_ltr()
        if i == N_FRAMES - 1:
            enc.recover_from_ltr()
        data += enc.encode_frame(
            np.ascontiguousarray(bg[i * 2:i * 2 + 48, i * 3:i * 3 + 64]),
            np.full((24, 32), 100, np.uint8),
            np.full((24, 32), 200, np.uint8))
    return data


def main():
    data = encode()
    with open(OUT, "wb") as fh:
        fh.write(data)
    print(f"{os.path.basename(OUT)}: {N_FRAMES} frames, {len(data)} bytes")


if __name__ == "__main__":
    main()
