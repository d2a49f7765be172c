"""The ops' constant tables as tensors on a device, copied there once.

`torch.as_tensor(table, device="cuda")` copies the numpy table from
pageable host memory on every call, and that copy waits for the work
already queued on the stream: inside the per-diagonal loops of the intra
wavefronts it would make the host wait for the card once per op. `on`
keeps one copy per (table, device) for the life of the process. Tables
are module-level numpy constants; the cache holds a reference to each,
and nothing writes to the tensors it returns. A new CUDA copy is waited
for before it enters the cache: host threads that decode on their own
streams (parallel/decode.py) share the cache, and a copy queued on one
stream is not ordered before another stream's reads.
"""
from __future__ import annotations

import torch

_CACHE = {}


def on(table, device):
    """The numpy constant `table` as a tensor on `device`."""
    device = torch.device(device)
    key = (id(table), device)
    hit = _CACHE.get(key)
    if hit is None:
        t = torch.as_tensor(table, device=device)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        hit = _CACHE[key] = (table, t)
    return hit[1]
