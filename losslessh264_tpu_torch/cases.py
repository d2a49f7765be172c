"""Seeded random inputs for holding K2 (csrc/deblock.cu) against its
plain version: used by tests/test_torch_kernels.py, chip_smoke.py and
tools/kernel_ab.py, so that all three check and time the same cases."""
import numpy as np
import torch

from .ops import deblock as tdb

SYMBOL_KEYS = ("cls", "qp", "nnz", "mv", "ref_idx", "slice_id",
               "deblock_idc", "alpha_off", "beta_off", "transform8")


def block_noise(rng, h, w):
    """An [h, w] int32 plane of 8x8 blocks of noise around 128 with
    amplitude 4, 16, 64 or 256: the low-contrast blocks make every
    filter branch fire, the full-range ones leave edges unfiltered."""
    amp = rng.choice([4, 16, 64, 256], ((h + 7) // 8, (w + 7) // 8))
    amp = np.kron(amp, np.ones((8, 8), np.int64))[:h, :w]
    return (rng.randint(0, 256, (h, w)) * amp // 256
            + 128 - amp // 2).astype(np.int32)


def random_deblock_case(mb_w, mb_h, seed, device):
    """(planes, sym, params): WPAD-padded Y/U/V planes of block noise,
    random symbol planes in SYMBOL_KEYS order (the symbol recipe of
    tests/test_deblock_impls.py, with deblocking switched off or offset
    on some MBs) and their _edge_params, chroma_qp_offset = seed."""
    rng = np.random.RandomState(seed)
    n = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    P = tdb.WPAD
    planes = [torch.as_tensor(block_noise(rng, *s), device=device)
              for s in ((H + 2 * P, W + 2 * P),
                        (H // 2 + 2 * P, W // 2 + 2 * P),
                        (H // 2 + 2 * P, W // 2 + 2 * P))]
    sym = dict(
        cls=rng.randint(0, 9, (n,)), qp=rng.randint(10, 52, (n,)),
        nnz=rng.randint(0, 3, (n, 16)), mv=rng.randint(-16, 17, (n, 16, 2)),
        ref_idx=rng.randint(0, 2, (n, 16)),
        slice_id=np.arange(n) // (mb_w * 2),
        deblock_idc=rng.choice([0, 0, 0, 1, 2], (n,)),
        alpha_off=rng.randint(-6, 7, (n,)) * 2,
        beta_off=rng.randint(-6, 7, (n,)) * 2,
        transform8=rng.randint(0, 2, (n,)))
    sym = [torch.as_tensor(np.asarray(sym[k], np.int32), device=device)
           for k in SYMBOL_KEYS]
    return planes, sym, tdb._edge_params(mb_w, mb_h, *sym, seed)
