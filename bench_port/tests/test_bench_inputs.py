"""The seeded inputs: every generator is deterministic in the seed, the
frame generator equals its original (cases.patch_frames), and a clip of
a stream holds as many frames as asked."""
import importlib.util
import os

import numpy as np
import pytest

from conftest import BENCH
from harness import frames as gen, streams
from reference import symbols


def test_pan_frames_equal_patch_frames():
    from losslessh264_tpu_torch import cases
    for (w, h), plan, noise, seed in (
            ((64, 48), [[0], [3, 5], [], [7]], 0, 7),
            ((64, 48), [[1], [2]], 3, 11),
            ((96, 80), [[0, 4], [9], [10, 2]], 0, 2 ** 31 + 5)):
        ours = gen.pan_frames(w, h, plan, noise=noise, seed=seed)
        theirs = cases.patch_frames(w, h, plan, noise=noise, seed=seed)
        for a, b in zip(ours, theirs):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)


def test_frames_and_plans_follow_the_seed():
    def make(seed):
        plan = gen.patch_plan(np.random.default_rng(seed), 96, 80, 5, 2)
        return plan, gen.pan_frames(96, 80, plan, seed=seed % 2 ** 32)
    p1, f1 = make(2 ** 31 + 9)
    p2, f2 = make(2 ** 31 + 9)
    p3, f3 = make(2 ** 31 + 10)
    assert p1 == p2 and p1 != p3
    assert all(len(d) == 2 and len(set(d)) == 2 for d in p1 + p3)
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(f1, f2))
    assert not all(np.array_equal(a[0], b[0]) for a, b in zip(f1, f3))


def test_clip_lengths_are_the_same_set_in_another_order():
    def first(seed, k):
        it = streams.clip_lengths(np.random.default_rng(seed), 10, 25)
        return [next(it) for _ in range(k)]
    a, b, c = first(3, 48), first(3, 48), first(4, 48)
    assert a == b and a != c
    for run in (a, c):
        for k in range(0, 48, 16):
            assert sorted(run[k:k + 16]) == list(range(10, 26))


@pytest.mark.parametrize("stream", ["synth720p", "runs720p"])
def test_clips_hold_their_frames(stream):
    with open(os.path.join(BENCH, "data", stream + ".264"), "rb") as fh:
        data = fh.read()
    offsets = streams.access_unit_offsets(data)
    n = len(offsets) - 1
    assert n == {"synth720p": 25, "runs720p": 12}[stream]
    for L in (1, 2, 5, n):
        clip = streams.clip(data, L, offsets)
        assert sum(1 for _ in symbols.SymbolDecoder(clip)) == L
