#!/usr/bin/env python3
"""Write tests/data/runs720p.264 and its NpDecoder CRC32s
(tests/data/runs720p_np_crc.json): a 1280x720 stream whose frames take
every intra route of the port's decoder (decoder_torch.TorchDecoder):

    JAX_PLATFORMS=cpu python tools/gen_run_streams.py

The frames are losslessh264_tpu_torch.cases.patch_frames(1280, 720, PLAN):
a smooth pattern translating by (2, 3) px per frame, with 16x16 noise
patches on the MB diagonals (d = 2 * mby + mbx) that PLAN lists per
frame. JaxEncoder(1280, 720, qp=QP, scene_cut=False) encodes them on the
CPU, with force_intra_frame() before frames 0-3: four IDRs, which form
one all-intra run of 4 (recon_intra_batch). The P frames code the
patches, and the MBs that the previous frame's patches cover in their
reference, as intra MBs; this tool's own copy of the intra-pass rule
(JaxDecoder._intra_sel) finds each frame's kind, 0 (no intra MB), 1
(1-4 populated diagonals), 2 (5-16) or 3 (more than 16: the full table
of 168), and asserts that the P frames hold every kind. The JSON holds
per frame the CRC32 of NpDecoder's Y|U|V (uncropped, the formula of
tools/gen_np_crc.py), whether the frame is all-intra, the kind and the
populated diagonals. Takes a few minutes on the CPU.
"""
import json
import os
import sys
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "tests", "data")
STREAM = os.path.join(DATA, "runs720p.264")
CRCS = os.path.join(DATA, "runs720p_np_crc.json")
WIDTH, HEIGHT, QP = 1280, 720, 30
N_IDR = 4
# patched diagonals per frame (168 diagonals at 80x45 MBs); an empty
# entry after a patched frame still holds the intra MBs that the
# previous frame's patches leave unpredictable
PLAN = ([[]] * N_IDR
        + [[], [40], [], list(range(10, 170, 20)), [],
           list(range(0, 168, 4)), [], []])


def intra_kind(mb_w, mb_h, mb_class):
    """(kind, populated diagonals) of a frame: JaxDecoder._intra_sel's
    rule over the slope-2 diagonals."""
    mby, mbx = np.divmod(np.flatnonzero(np.isin(mb_class, [0, 1, 2])), mb_w)
    rows = np.unique(2 * mby + mbx)
    n_diags = 2 * (mb_h - 1) + mb_w
    if len(rows) == 0:
        return 0, 0
    if len(rows) > 16 or n_diags <= 16:
        return 3, len(rows)
    return (1 if len(rows) <= 4 else 2), len(rows)


def encode():
    from losslessh264_tpu import encoder_jax
    from losslessh264_tpu_torch.cases import patch_frames
    enc = encoder_jax.JaxEncoder(WIDTH, HEIGHT, qp=QP, scene_cut=False)
    data = b""
    for i, f in enumerate(patch_frames(WIDTH, HEIGHT, PLAN)):
        if i < N_IDR:
            enc.force_intra_frame()
        data += enc.encode_frame(*f)
    return data


def main():
    from losslessh264_tpu import decoder_np, native
    data = encode()
    rows = []
    for f in native.SymbolDecoder(data):
        kind, n_rows = intra_kind(f["mb_w"], f["mb_h"], f["mb_class"])
        rows.append({"all_intra": bool(np.isin(f["mb_class"],
                                               [0, 1, 2, 8]).all()),
                     "kind": kind, "rows": n_rows})
    if not all(r["all_intra"] for r in rows[:N_IDR]):
        raise SystemExit("frames 0-3 are not all-intra")
    p_kinds = {r["kind"] for r in rows[N_IDR:]}
    if p_kinds != {0, 1, 2, 3} or any(r["all_intra"] for r in rows[N_IDR:]):
        raise SystemExit(f"P-frame kinds {[r['kind'] for r in rows]}: "
                         "not every kind 0-3")
    crcs = [zlib.crc32(Y.tobytes() + U.tobytes() + V.tobytes())
            for Y, U, V in decoder_np.NpDecoder(data).frames()]
    if len(crcs) != len(PLAN):
        raise SystemExit(f"NpDecoder gave {len(crcs)} frames")
    with open(STREAM, "wb") as fh:
        fh.write(data)
    out = {"runs720p": {"stream": os.path.basename(STREAM),
                        "frames": len(crcs), "luma_shape": [HEIGHT, WIDTH],
                        "qp": QP, "plan": PLAN, "crc32": crcs,
                        "intra": rows}}
    with open(CRCS, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print(f"{os.path.basename(STREAM)}: {len(crcs)} frames, {len(data)} "
          f"bytes, kinds {[r['kind'] for r in rows]}, rows "
          f"{[r['rows'] for r in rows]}")


if __name__ == "__main__":
    main()
