"""The port's binding of the shared native layer
(losslessh264_tpu_torch/native.py) and its GOP-level parallelism
(losslessh264_tpu_torch/parallel/) equal the JAX package's
(losslessh264_tpu/native.py, losslessh264_tpu/parallel/) on the CPU:
the same bytes and Stats on the same streams, the recipes of
tests/test_parallel.py, a GOP-parallel decode against the sequential
decoders, and compress_distributed in two gloo processes against
compress_sharded.

The multi-GOP stream of tests/test_parallel.py (12 frames of 64x48 at
gop 3) is encoded here with the port's TorchEncoder on the CPU, whose
bytes equal JaxEncoder's (tests/test_torch_encoder.py), so no JAX
encoder is compiled."""
import dataclasses
import os
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from losslessh264_tpu import decoder_np
from losslessh264_tpu import native as jnative
from losslessh264_tpu import parallel as jparallel
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch import parallel
from losslessh264_tpu_torch.decoder_torch import TorchDecoder
from losslessh264_tpu_torch.encoder_torch import encode_yuv

tnative.load()
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _gop_frames(n=12, H=48, W=64, seed=21):
    """The frames of tests/test_parallel.py's multi_gop_stream."""
    rng = np.random.RandomState(seed)
    bg = rng.randint(0, 255, (H + 80, W + 80)).astype(np.uint8)
    return [(np.ascontiguousarray(bg[i * 3:i * 3 + H, i * 4:i * 4 + W]),
             np.full((H // 2, W // 2), 90 + i, np.uint8),
             np.full((H // 2, W // 2), 60, np.uint8)) for i in range(n)]


@pytest.fixture(scope="module")
def multi_gop_stream():
    return encode_yuv(_gop_frames(), 64, 48, qp=26, gop=3, device="cpu")


@pytest.fixture(scope="module")
def cropped_gop_stream():
    """56x40 (SPS cropping to 4x3 MBs), 6 frames at gop 2."""
    return encode_yuv(_gop_frames(6, 40, 56, seed=5), 56, 40, qp=30, gop=2,
                      device="cpu")


def test_native_binding_matches_jax(multi_gop_stream):
    """Every entry point of the binding: the same bytes and Stats as the
    JAX package's binding on the multi-GOP stream, and the same cut
    points and shard plans on walk_analog as well."""
    assert tnative.BILL_NAMES == jnative.BILL_NAMES
    assert ([f[0] for f in tnative.PipStats._fields_]
            == [f[0] for f in jnative.PipStats._fields_])
    assert tnative.container_version() == jnative.container_version()
    tnative.selftest_arith()
    for data in (multi_gop_stream, _read("walk_analog.264")):
        assert tnative.gop_starts(data) == jnative.gop_starts(data)
        for n in (1, 3, 4):
            assert tnative.shard_plan(data, n) == jnative.shard_plan(data, n)
    data = multi_gop_stream
    plan = tnative.shard_plan(data, 4)
    start, end, ctx = plan[-1]
    calls = [("compress", (data,), {"verify": False}),
             ("compress", (data[start:end],),
              {"verify": True, "context": ctx}),
             ("compress_sharded", (data, 3), {})]
    for name, a, kw in calls:
        got = getattr(tnative, name)(*a, **kw)
        want = getattr(jnative, name)(*a, **kw)
        assert got[0] == want[0], name
        assert (dataclasses.asdict(got[1])
                == dataclasses.asdict(want[1])), name
        dec_t, dec_j = tnative.decompress(got[0]), jnative.decompress(
            want[0])
        assert dec_t[0] == dec_j[0] == a[0]
        assert dataclasses.asdict(dec_t[1]) == dataclasses.asdict(
            dec_j[1])
    with pytest.raises(RuntimeError, match="pip_decompress"):
        tnative.decompress(b"PIPT\x00garbage")


def test_shard_plan_exceeds_the_count_asked():
    """A fault of the shared native layer, which the port follows: the
    planner returns more shards than asked on walk_analog.264 (10 GOPs),
    so every caller sizes by len(plan)."""
    data = _read("walk_analog.264")
    counts = [len(tnative.shard_plan(data, n)) for n in (2, 3, 4, 8)]
    assert counts == [3, 4, 5, 10]
    assert counts == [len(jnative.shard_plan(data, n)) for n in (2, 3, 4, 8)]
    assert (parallel.compress_distributed(data, 4)
            == tnative.compress_sharded(data, 4)[0])


def test_shard_plan_covers_input(multi_gop_stream):
    data = multi_gop_stream
    plan = tnative.shard_plan(data, 4)
    assert 2 <= len(plan) <= 4
    assert plan[0][0] == 0
    assert plan[-1][1] == len(data)
    for (s0, e0, _), (s1, e1, _) in zip(plan, plan[1:]):
        assert e0 == s1
    assert plan[0][2] == b""
    assert all(ctx for _, _, ctx in plan[1:])


def test_multihost_matches_single_host(multi_gop_stream):
    """tests/test_parallel.py:38: N processes' strided subsets assemble
    the container one host writes, and so do the JAX functions."""
    data = multi_gop_stream
    single, _ = tnative.compress_sharded(data, 4)
    for pc in (1, 2, 3):
        payloads = {}
        for pi in range(pc):
            part = parallel.compress_multihost(data, 4, pi, pc)
            assert part == jparallel.compress_multihost(data, 4, pi, pc)
            assert not set(part) & set(payloads)
            payloads.update(part)
        assert parallel.assemble(data, payloads, 4) == single
        assert jparallel.assemble(data, payloads, 4) == single
    assert tnative.decompress(single)[0] == data
    assert parallel.shard_assignment(7, 1, 3) == \
        jparallel.shard_assignment(7, 1, 3)
    with pytest.raises(ValueError):
        parallel.shard_assignment(4, 2, 2)


def test_assemble_rejects_missing_shard(multi_gop_stream):
    data = multi_gop_stream
    payloads = parallel.compress_multihost(data, 4, 0, 2)
    with pytest.raises(RuntimeError, match="missing shard"):
        parallel.assemble(data, payloads, 4)


def test_compress_distributed_single_process(multi_gop_stream):
    data = multi_gop_stream
    assert not dist.is_initialized()
    assert parallel.compress_distributed(data, 4) == \
        tnative.compress_sharded(data, 4)[0]


def test_single_shard_plan_falls_back_to_plain(multi_gop_stream):
    data = multi_gop_stream
    plain, _ = tnative.compress(data, verify=False)
    payloads = parallel.compress_multihost(data, 1, 0, 1)
    assert parallel.assemble(data, payloads, 1) == plain


def test_corrupt_sharded_container_raises_cleanly(multi_gop_stream):
    data = multi_gop_stream
    pip, _ = tnative.compress_sharded(data, 4)
    assert pip[:4] == b"PIPS"
    with pytest.raises(RuntimeError):
        tnative.decompress(pip[: len(pip) // 2])
    bad = bytearray(pip)
    bad[len(pip) // 2] ^= 0xFF
    with pytest.raises(RuntimeError):
        tnative.decompress(bytes(bad))


def _distributed_rank(rank, world, init, data, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        queue.put((rank, parallel.compress_distributed(data, 4)))
    finally:
        dist.destroy_process_group()


def test_compress_distributed_two_processes(multi_gop_stream):
    """Two gloo processes, each compressing its strided half of the plan,
    both assemble compress_sharded's container."""
    data = multi_gop_stream
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_distributed_rank,
                             args=(r, 2, init, data, queue))
                 for r in range(2)]
        for p in procs:
            p.start()
        got = dict(queue.get(timeout=300) for _ in procs)
        for p in procs:
            p.join(timeout=60)
    assert [p.exitcode for p in procs] == [0, 0]
    single, _ = tnative.compress_sharded(data, 4)
    assert got == {0: single, 1: single}


@pytest.mark.parametrize("which,workers", [("multi_gop_stream", 4),
                                           ("cropped_gop_stream", 2)])
def test_gop_parallel_decode_matches_sequential(which, workers, request):
    """Frames and crop equal NpDecoder's and the sequential
    TorchDecoder's (tests/test_parallel.py:80)."""
    data = request.getfixturevalue(which)
    assert len(tnative.shard_plan(data, workers)) > 1
    dec = decoder_np.NpDecoder(data)
    want = [tuple(np.asarray(p) for p in f) for f in dec.frames()]
    tdec = TorchDecoder(data, device="cpu")
    seq = [tuple(p.numpy() for p in f) for f in tdec.frames()]
    got, crop = parallel.decode_yuv_gop_parallel(data, max_workers=workers,
                                                 device="cpu")
    assert crop == dec.crop_px == tdec.crop_px
    if which == "cropped_gop_stream":
        assert crop != (0, 0, 0, 0)
    assert len(got) == len(want) == len(seq)
    for i, (a, b, c) in enumerate(zip(got, want, seq)):
        for pa, pb, pc, pl in zip(a, b, c, "YUV"):
            np.testing.assert_array_equal(pa, pb, err_msg=f"{i} {pl}")
            np.testing.assert_array_equal(pa, pc, err_msg=f"{i} {pl}")


def test_launch_counter_is_exact_under_threads():
    """The kernel wrappers count launches with _build.count_launch, which
    GOP-parallel workers call from several threads: with more threads
    than cores and a short switch interval, no count is lost."""
    from concurrent.futures import ThreadPoolExecutor

    from losslessh264_tpu_torch import _build

    def counted():
        pass
    counted.launches = 0
    n_threads, per_thread = 4 * (os.cpu_count() or 2), 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            futs = [ex.submit(lambda: [_build.count_launch(counted)
                                       for _ in range(per_thread)])
                    for _ in range(n_threads)]
            for f in futs:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert counted.launches == n_threads * per_thread
