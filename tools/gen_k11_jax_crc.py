"""Write tests/data/k11_jax_crc.json: for each of cases.K11_CASES, the
CRC32 of the JAX package's per-cell MC planes
(losslessh264_tpu.decoder_jax._mc_legacy_cells' tiles as [H, W] and
[H/2, W/2] int32 planes, 0 on every cell whose ref_slot is below 0, the
form K11 writes), so that a machine without JAX holds K11 to the JAX
package directly (tests/test_torch_kernels.py on the card;
tests/test_torch_mc.py keeps the file true on the CPU).

Usage: JAX_PLATFORMS=cpu python tools/gen_k11_jax_crc.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "k11_jax_crc.json")


def jax_planes(mb_w, mb_h, seed, kw):
    """The JAX package's per-cell planes for one K11 case (numpy int32,
    0 on the cells of intra MBs)."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from losslessh264_tpu import decoder_jax
    from losslessh264_tpu_torch import decoder_torch as dt
    from losslessh264_tpu_torch.cases import random_cells_case
    *rings, _, p = random_cells_case(mb_w, mb_h, seed, **kw)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()
          if k in ("ref_slot", "mv", "wp_luma", "wp_cb", "wp_cr",
                   "wp_cmask")}
    tiles = decoder_jax._mc_legacy_cells(
        mb_w, mb_h, jp, *(jnp.asarray(r.numpy()) for r in rings))
    inter = dt._tiles_to_plane((p["ref_slot"] >= 0).reshape(-1, 4, 4),
                               mb_w, mb_h, 4)
    out = []
    for t, s in zip(tiles, (16, 8, 8)):
        plane = dt._tiles_to_plane(torch.as_tensor(np.array(t)), mb_w,
                                   mb_h, s)
        keep = inter.repeat_interleave(s // 4, 0).repeat_interleave(s // 4,
                                                                      1)
        out.append(torch.where(keep, plane, 0).to(torch.int32).numpy())
    return out


def crc(planes):
    import zlib
    return zlib.crc32(b"".join(a.tobytes() for a in planes))


def main():
    sys.path.insert(0, ROOT)
    from losslessh264_tpu_torch.cases import K11_CASES
    cases = {name: crc(jax_planes(mb_w, mb_h, seed, kw))
             for name, mb_w, mb_h, seed, kw in K11_CASES}
    with open(OUT, "w") as fh:
        json.dump({"made_by": "tools/gen_k11_jax_crc.py: zlib.crc32 of "
                   "the int32 Y|U|V planes of decoder_jax._mc_legacy_cells "
                   "on cases.random_cells_case, 0 on intra cells",
                   "crc32": cases}, fh, indent=1)
        fh.write("\n")
    print(f"{len(cases)} cases -> {OUT}")


if __name__ == "__main__":
    main()
