"""Multi-process GOP-sharded compression (port of
losslessh264_tpu/parallel/gop.py, over torch.distributed).

Every process computes the same shard plan from the input bytes (the
native engine's whole-GOP grouping, `native.shard_plan`), compresses only
the shards of its strided assignment, and all-gathers the payloads; every
process then assembles the same sharded container, byte-identical to
`native.compress_sharded` on one host, because a shard's payload depends
only on its bytes and its SPS/PPS context. The exchange runs on
torch.distributed (gloo, CPU tensors) where the JAX package uses
jax.experimental.multihost_utils.
"""
from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from .. import native


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def shard_assignment(n_shards: int, process_index: int,
                     process_count: int) -> list[int]:
    """Strided shard-index subset for one process. Strided (not blocked)
    so the byte-balanced plan stays balanced across processes even when
    n_shards is not a multiple of process_count."""
    if not 0 <= process_index < process_count:
        raise ValueError("process_index out of range")
    return list(range(process_index, n_shards, process_count))


def compress_multihost(data: bytes, n_shards: int, process_index: int,
                       process_count: int, verify: bool = False,
                       max_workers: int | None = None) -> dict[int, bytes]:
    """Compress this process's strided subset of the shard plan.

    Returns {shard_index: payload} for the local shards only; payloads
    are self-contained .pip (PIPT) segments. Local shards run on a thread
    pool (the native engine releases the GIL)."""
    plan = native.shard_plan(data, n_shards)
    mine = shard_assignment(len(plan), process_index, process_count)

    def one(i: int) -> tuple[int, bytes]:
        start, end, ctx = plan[i]
        pip, _ = native.compress(data[start:end], verify=verify, context=ctx)
        return i, pip

    with ThreadPoolExecutor(max_workers=max_workers or len(mine) or 1) as ex:
        return dict(ex.map(one, mine))


def assemble(data: bytes, payloads: dict[int, bytes],
             n_shards: int) -> bytes:
    """Assemble the complete shard payload set into the sharded (PIPS)
    container, byte-identical to native.compress_sharded(data, n_shards).
    A single-shard plan assembles to the plain PIPT payload (as the native
    engine writes it)."""
    plan = native.shard_plan(data, n_shards)
    missing = [i for i in range(len(plan)) if i not in payloads]
    if missing:
        raise RuntimeError(f"missing shard payloads: {missing[:8]}")
    ordered = [payloads[i] for i in range(len(plan))]
    if len(ordered) == 1:
        return ordered[0]
    out = bytearray(b"PIPS") + bytes([native.container_version()])
    out += _varint(len(data))
    out += _varint(zlib.crc32(data) & 0xFFFFFFFF)
    out += _varint(len(ordered))
    for p in ordered:
        out += _varint(len(p))
    for p in ordered:
        out += p
    return bytes(out)


def _rank_world() -> tuple[int, int]:
    """(rank, world size) of torch.distributed, or (0, 1) when it is not
    initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_payloads(payloads: dict[int, bytes],
                        n_shards: int) -> dict[int, bytes]:
    """Exchange shard payloads across the torch.distributed processes.

    Variable-length bytes ride a fixed-shape uint8 all-gather: each
    process contributes a [n_shards, 1 + max_len] plane (presence flag +
    padded payload), with the per-shard lengths gathered first so the pad
    is the global maximum. With torch.distributed not initialized, or one
    process, the input is returned unchanged."""
    _, world = _rank_world()
    if world == 1:
        return payloads
    lens = torch.zeros((n_shards,), dtype=torch.int64)
    for i, p in payloads.items():
        lens[i] = len(p)
    all_lens = [torch.empty_like(lens) for _ in range(world)]
    dist.all_gather(all_lens, lens)
    all_lens = torch.stack(all_lens).numpy()           # [P, n_shards]
    max_len = int(all_lens.max())
    plane = np.zeros((n_shards, max_len + 1), np.uint8)
    for i, p in payloads.items():
        plane[i, 0] = 1
        plane[i, 1:1 + len(p)] = np.frombuffer(p, np.uint8)
    plane = torch.from_numpy(plane)
    planes = [torch.empty_like(plane) for _ in range(world)]
    dist.all_gather(planes, plane)
    out: dict[int, bytes] = {}
    for pi, pl in enumerate(planes):
        pl = pl.numpy()
        for i in range(n_shards):
            if pl[i, 0]:
                out[i] = pl[i, 1:1 + int(all_lens[pi, i])].tobytes()
    return out


def compress_distributed(data: bytes, n_shards: int,
                         verify: bool = False) -> bytes:
    """One-call multi-process compression: shard plan -> local strided
    compress -> all-gather -> the same container on every process. Rank
    and world size come from torch.distributed (0 and 1 when it is not
    initialized, where this equals native.compress_sharded)."""
    pi, pc = _rank_world()
    local = compress_multihost(data, n_shards, pi, pc, verify=verify)
    plan_size = len(native.shard_plan(data, n_shards))
    full = _allgather_payloads(local, plan_size)
    return assemble(data, full, n_shards)
