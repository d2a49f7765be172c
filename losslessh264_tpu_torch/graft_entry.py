"""Entry points of the torch port's encoder step, one process or several
(port of __graft_entry__.py).

entry(): the whole-frame P-MB analysis of the encoder (exhaustive ME,
half-pel planes (K1) and quarter-pel refinement, the forward and inverse
transform chain) as a function and its arguments, torch tensors on the
device.

dryrun_multichip(n): the same step in n processes joined by
torch.distributed (gloo), one frame per process as the GOP/frame axis is
sharded, each followed by the in-loop recon and deblock (`_p_finish`, K9
and K2 on CUDA) and a coded-bits proxy that is all-reduced across the processes
(the rate-control aggregation collective). JAX runs this as a shard_map
over a device mesh and pins the lax deblock there; the port needs no such
switch, and on CUDA every rank launches K1, K2, K5 (the dense search),
K8 and K9 once.
"""
from __future__ import annotations

import functools
import os
import queue as queue_mod
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import _build
from . import encoder_torch as et
from .ops import deblock as tdb
from .ops import mc as tmc
from .ops import me as tme
from .ops.consts import on


def _tiny_frame_args(mb_w, mb_h, batch=1, seed=0):
    """Seeded source frames and edge-padded references (luma 32, chroma
    16): a pinned copy of __graft_entry__._tiny_frame_args."""
    rng = np.random.RandomState(seed)
    H, W = mb_h * 16, mb_w * 16
    Y = rng.randint(0, 256, (batch, H, W)).astype(np.uint8)
    U = rng.randint(0, 256, (batch, H // 2, W // 2)).astype(np.uint8)
    V = rng.randint(0, 256, (batch, H // 2, W // 2)).astype(np.uint8)
    refY = np.stack([np.pad(rng.randint(0, 256, (H, W)).astype(np.uint8),
                            32, mode="edge") for _ in range(batch)])
    refU = np.stack([np.pad(U[i], 16, mode="edge") for i in range(batch)])
    refV = np.stack([np.pad(V[i], 16, mode="edge") for i in range(batch)])
    return Y, U, V, refY, refU, refV


def entry(device="cuda"):
    """(fn, args): encode_inter_mbs at radius 8 over a seeded 4x3-MB
    frame, with its arguments as tensors on `device`; fn(*args) runs the
    step."""
    mb_w, mb_h = 4, 3
    Y, U, V, refY, refU, refV = _tiny_frame_args(mb_w, mb_h)
    n = mb_w * mb_h

    def t(a):
        return torch.as_tensor(a, device=device)

    fn = functools.partial(et.encode_inter_mbs, mb_w, mb_h, 8)
    args = (t(Y[0]), t(U[0]), t(V[0]), t(refY[0])[None], t(refU[0])[None],
            t(refV[0])[None], torch.full((n,), 28, dtype=torch.int32,
                                         device=device),
            torch.full((n,), 28, dtype=torch.int32, device=device))
    return fn, args


def per_frame(mb_w, mb_h, Yf, Uf, Vf, rY, rU, rV, qpf):
    """One frame's step, as __graft_entry__.dryrun_multichip's per_frame:
    the P-MB analysis (radius 8), the in-loop recon and deblock
    (`_p_finish`, filter on) and the coded-bits proxy. Returns (recY,
    mvx, bits)."""
    n = mb_w * mb_h
    (mvx, mvy, use_intra, part, ref_sel, mv8, mvq, qac, cdc, cac, ty, tu,
     tv, no_res) = et.encode_inter_mbs(mb_w, mb_h, 8, Yf, Uf, Vf, rY[None],
                                       rU[None], rV[None], qpf, qpf)
    recY, recU, recV = et._p_finish(
        mb_w, mb_h, 0, ty, tu, tv,
        torch.where(use_intra, 1, 3 + part).to(torch.int32),
        (qac != 0).any(-1), mvq[:, on(et._CELL_PART8, Yf.device), :],
        ref_sel[:, None].expand(n, 16), qpf,
        torch.zeros((n,), dtype=torch.int32, device=Yf.device))
    bits = (qac.abs().sum() + cdc.abs().sum() + cac.abs().sum())
    return recY, mvx, bits


def frame_args(mb_w, mb_h, batch, index, device):
    """The arguments of per_frame for frame `index` of the seeded batch,
    as tensors on `device`."""
    Y, U, V, refY, refU, refV = _tiny_frame_args(mb_w, mb_h, batch=batch)
    qp = np.full((mb_w * mb_h,), 28, np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in
                 (Y[index], U[index], V[index], refY[index], refU[index],
                  refV[index], qp))


def _rank_main(rank, world, init, mb_w, mb_h, device, queue):
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            _build.lib()
        args = frame_args(mb_w, mb_h, world, rank, dev)
        kernels = (tmc.halfpel_planes, tdb.deblock_wavefront,
                   tme.dense_full_search, et.inter_residual,
                   tdb.edge_params_packed)
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        recY, mvx, bits = per_frame(mb_w, mb_h, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        k1, k2, k5, k8, k9 = (k.launches for k in kernels)
        # the global coded-bits aggregate (gloo reduces host tensors)
        total = bits.detach().to("cpu", torch.int64).reshape(1).clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM)
        assert tuple(recY.shape) == (mb_h * 16, mb_w * 16)
        assert tuple(mvx.shape) == (mb_w * mb_h,)
        assert int(total) >= 0
        queue.put((rank, recY.cpu().numpy(), mvx.cpu().numpy(), int(bits),
                   int(total), k1, k2, k5, k8, k9, step_ms))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda", mb_w=4, mb_h=3):
    """Run per_frame in n_devices processes (torch.multiprocessing, spawn),
    rank r on frame r of a seeded batch, all on `device` (one card serves
    every rank), and all-reduce the coded bits over gloo. The processes
    meet through a file in a fresh temporary directory, not a TCP port,
    so several dryruns can run side by side. Returns, per rank in order,
    (rank, recY, mvx, bits, total_bits, K1 launches, K2 launches, K5
    launches, K8 launches, K9 launches, step_ms) with the arrays on the
    host; step_ms
    is the wall time of the rank's step, its first call, synchronized."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_devices, init, mb_w, mb_h, device,
                                   queue))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        out = []
        try:
            while len(out) < n_devices:
                try:
                    out.append(queue.get(timeout=1))
                except queue_mod.Empty:
                    failed = [p.exitcode for p in procs
                              if p.exitcode not in (None, 0)]
                    if failed:
                        raise RuntimeError("dryrun ranks exited with "
                                           f"{failed}") from None
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return sorted(out, key=lambda r: r[0])
