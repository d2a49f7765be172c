"""Seeded inputs shared by the tests, chip_smoke.py and tools/kernel_ab.py:
random cases for holding K2 (csrc/deblock.cu) against its plain version,
so that all three check and time the same cases, the translating noise
frames the encoder's tests encode, and the encoders of the encode
goldens' configurations (tests/data/synth720p_enc_golden*.json)."""
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


def moving_frames(n=4, W=64, H=48, seed=7):
    """n I420 frames (uint8 numpy Y, U, V) of noise moving by (2, 3) px
    per frame under flat chroma: the recipe of the JAX encoder's tests
    (tests/test_encoder_jax.py::_moving_frames)."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 255, (H + 32, W + 32)).astype(np.uint8)
    frames = []
    for i in range(n):
        Y = np.ascontiguousarray(bg[i * 2:i * 2 + H, i * 3:i * 3 + W])
        U = np.full((H // 2, W // 2), 100 + i, np.uint8)
        V = np.full((H // 2, W // 2), 200, np.uint8)
        frames.append((Y, U, V))
    return frames


def golden_encoder(cfg, width, height, device):
    """The port's encoder of one configuration of an encode golden (its
    JSON entry: `kwargs` with an optional `rc` spec, `simulcast`, or
    `older`, the older fixed-QP Encoder), built as
    tools/gen_enc_golden.make_encoder builds the JAX package's."""
    from . import ratectl
    from .encoder import Encoder
    from .encoder_torch import TorchEncoder
    from .simulcast import SimulcastEncoder
    if "older" in cfg:
        return Encoder(width, height, device=device, **cfg["older"])
    if "simulcast" in cfg:
        return SimulcastEncoder(width, height, device=device,
                                **cfg["simulcast"])
    kw = dict(cfg["kwargs"])
    if "rc" in cfg:
        spec = dict(cfg["rc"])
        kw["rc"] = getattr(ratectl, spec.pop("kind"))(
            spec.pop("bitrate_bps"), spec.pop("fps"), **spec)
    return TorchEncoder(width, height, device=device, **kw)

