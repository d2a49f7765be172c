"""The decoder's host plan in compiled code (csrc/plan_host.cpp, built by
g++ into build/host/libpip_plan.so): decoder_torch.nnz_plane against
TorchDecoder._nnz_plane and ops/mc.mc_plan against mc_fast_plan, the
numpy versions, on every frame of the four streams in tests/data and on
seeded synthetic frames that reach each cap and bound; the wrappers
refuse a wrong dtype, shape or layout.

Where numpy's cut at MC_CAP triples has a tie (argsort breaks it in no
stated order), the two MC plans may serve different triples densely: the
counts are then held equal, the compiled plan to its rule (the most
populated triples, ties by the lower key), and mc_bucketed_plain's
prediction from each plan to the other's."""
import functools
import os

import numpy as np
import pytest
import torch

from losslessh264_tpu_torch import _build
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import native as tnative
from losslessh264_tpu_torch.ops import mc as tmc

tnative.load()
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
STREAMS = ["runs720p.264", "synth720p.264", "walk_analog.264",
           "ltr_gap_64x48.264"]
PAD = dt.PAD
CAP = tmc.MC_CAP
# bucketed frames with a tied cut: the predictions are compared on at most
# this many of a stream's (each a whole mc_bucketed_plain)
PREDICTED_PER_STREAM = 6


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _planned_frames(name):
    """(frame index, symbol frame, plane dict) of every frame of a stream
    as TorchDecoder plans it (its ring-slot bookkeeping, no pixels)."""
    data = _read(name)
    dec = dt.TorchDecoder(data, device="cpu")
    for i, f in enumerate(tnative.SymbolDecoder(data)):
        planes = dec._prep_planes(f)[0]
        dec._assign_slot(f)
        yield i, f, planes


# ---------------------------------------------------------------------------
# nnz
# ---------------------------------------------------------------------------
def _same_nnz(f):
    want = dt.TorchDecoder._nnz_plane(f)
    got = dt.nnz_plane(f)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stream", STREAMS)
def test_nnz_plane_matches_numpy_on_streams(stream):
    frames = 0
    for _, f, planes in _planned_frames(stream):
        _same_nnz(f)
        np.testing.assert_array_equal(planes["nnz"], dt.nnz_plane(f))
        frames += 1
    assert frames >= 12


def _nnz_frame(mb_w, mb_h, seed):
    """Symbol planes in the export's dtypes: every MB class (I16 with
    transform8 set, 8x8-transform MBs with partial cbp_luma, PCM among
    them), cbp_luma bytes with bits above the luma four, transform8
    values 0-2, levels at each density (none, sparse, dense) up to the
    int16 extremes, and coded blocks whose levels are all zero."""
    rng = np.random.default_rng(seed)
    n = mb_w * mb_h
    cls = rng.integers(0, 10, n).astype(np.uint8)
    t8 = rng.integers(0, 3, n).astype(np.uint8)
    cbp = rng.integers(0, 256, n).astype(np.uint8)
    special = [(1, 1, 15), (1, 2, 5), (2, 1, 9), (3, 1, 6), (8, 0, 0),
               (8, 1, 15), (4, 0, 15), (0, 0, 0)]
    for mb, (c, t, b) in enumerate(special[:n]):
        cls[mb], t8[mb], cbp[mb] = c, t, b

    def levels(shape):
        dense = rng.choice([0.0, 0.03, 0.4, 1.0], (n,) + (1,) * len(shape))
        vals = rng.integers(-32768, 32768, (n,) + shape, dtype=np.int64)
        vals[rng.random(vals.shape) < 0.05] = 32767
        return np.where(rng.random((n,) + shape) < dense, vals,
                        0).astype(np.int16)
    luma_ac = levels((16, 4, 4))
    luma8 = levels((4, 8, 8))
    if n > 7:
        luma_ac[7] = 0
        luma8[7] = 0
    return {"mb_w": mb_w, "mb_h": mb_h, "mb_class": cls, "transform8": t8,
            "cbp_luma": cbp, "luma_ac": luma_ac, "luma8": luma8}


@pytest.mark.parametrize("mb_w,mb_h,seed", [(1, 1, 0), (3, 2, 1), (9, 4, 2),
                                            (80, 45, 3), (120, 68, 4)])
def test_nnz_plane_matches_numpy_on_synthetic(mb_w, mb_h, seed):
    _same_nnz(_nnz_frame(mb_w, mb_h, seed))


# ---------------------------------------------------------------------------
# the bucketed-MC plan
# ---------------------------------------------------------------------------
def _fast_counts(mb_w, mb_h, ref_slot, mv, pad):
    """{key: cells} over the cells mc_fast_plan can serve densely (a
    reference slot, no iFullMV clip, |mv| <= MC_MV_MAX), keyed as it keys
    them, derived here independently of both plans."""
    n = mb_w * mb_h
    rs = ref_slot.reshape(-1).astype(np.int64)
    vx = mv[..., 0].reshape(-1).astype(np.int64)
    vy = mv[..., 1].reshape(-1).astype(np.int64)
    c = np.arange(n * 16)
    x = (c // 16 % mb_w) * 16 + (c % 4) * 4
    y = (c // 16 // mb_w) * 16 + (c % 16 // 4) * 4
    fx, fy = 4 * x + vx, 4 * y + vy
    lo = 4 * (2 - pad)
    inside = ((fx >= lo) & (fx <= 4 * (16 * mb_w + pad - 19))
              & (fy >= lo) & (fy <= 4 * (16 * mb_h + pad - 19)))
    m = tmc.MC_MV_MAX
    fast = (rs >= 0) & inside & (np.abs(vx) <= m) & (np.abs(vy) <= m)
    keys = (rs << 28) + ((vy + 8192) << 14) + (vx + 8192)
    u, cnt = np.unique(keys[fast], return_counts=True)
    return dict(zip(u.tolist(), cnt.tolist()))


def numpy_spills(mb_w, mb_h, ref_slot, mv, pad=PAD):
    """Whether mc_fast_plan takes its spill branch on these planes: more
    than MC_CAP distinct fast triples."""
    return len(_fast_counts(mb_w, mb_h, ref_slot, mv, pad)) > CAP


def _tied_cut(counts):
    s = sorted(counts.values(), reverse=True)
    return len(s) > CAP and s[CAP - 1] == s[CAP]


def _kept_keys(plan):
    """The keys of the triples a plan serves densely, from its table."""
    out = []
    for row in plan["mc_uniq"][:int(plan["mc_nuniq"])].astype(np.int64):
        s = int(plan["mc_slots"][row[0]])
        vy, vx = (row[9] << 3) + row[11], (row[10] << 3) + row[12]
        out.append((s << 28) + ((vy + 8192) << 14) + (vx + 8192))
    return out


@functools.lru_cache(maxsize=4)
def _rings(mb_w, mb_h, slots, pad):
    rng = np.random.default_rng(mb_w * 1000 + mb_h)
    H, W = mb_h * 16, mb_w * 16
    y = rng.integers(0, 256, (slots, H + 2 * pad, W + 2 * pad), np.uint8)
    u = rng.integers(0, 256, (slots, H // 2 + pad, W // 2 + pad), np.uint8)
    v = rng.integers(0, 256, u.shape, np.uint8)
    return tuple(torch.from_numpy(a) for a in (y, u, v))


def _predict(plan, mb_w, mb_h, ref_slot, mv, pad):
    p = dt.planes_to_torch(dict(plan, ref_slot=ref_slot, mv=mv), "cpu")
    slots = max(19, int(ref_slot.max()) + 1)
    return tmc.mc_bucketed_plain(*_rings(mb_w, mb_h, slots, pad), pad, p,
                                 mb_w, mb_h)


def check_mc_plan(mb_w, mb_h, ref_slot, mv, pad=PAD, predict=True):
    """The compiled plan against mc_fast_plan on one frame: every key
    equal (values, dtypes, shapes) where the cut has no tie; else the
    counts equal, the compiled plan's kept triples the most populated
    (ties by the lower key) and, with `predict`, both plans' predictions
    equal. Returns (whether the cut is tied, whether a prediction was
    compared, whether the plans differ)."""
    want = tmc.mc_fast_plan(mb_w, mb_h, ref_slot, mv.astype(np.int32), pad)
    got, spilled = tmc.mc_plan(mb_w, mb_h, ref_slot, mv, pad)
    counts = _fast_counts(mb_w, mb_h, ref_slot, mv, pad)
    assert spilled == (len(counts) > CAP)
    assert list(got) == list(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.shape(got[k]) == np.shape(want[k]), k
    tied = _tied_cut(counts)
    same = all(np.array_equal(got[k], want[k]) for k in want)
    if not tied:
        assert same, [k for k in want if not np.array_equal(got[k],
                                                            want[k])]
        return tied, False, False
    for k in ("mc_fast", "mc_nuniq", "mc_nslots"):
        assert got[k] == want[k], k
    assert (got["mc_fix"] >= 0).sum() == (want["mc_fix"] >= 0).sum()
    if got["mc_fast"]:
        kept = _kept_keys(got)
        least = min(counts[k] for k in kept)
        rest = sorted((k for k in counts if k not in set(kept)))
        assert all(counts[k] <= least for k in rest)
        assert all(k > max(kept_k for kept_k in kept if counts[kept_k]
                           == least) for k in rest if counts[k] == least)
        if predict:
            for a, b in zip(_predict(got, mb_w, mb_h, ref_slot, mv, pad),
                            _predict(want, mb_w, mb_h, ref_slot, mv, pad)):
                assert torch.equal(a, b)
    return tied, bool(predict and got["mc_fast"]), not same


@pytest.mark.parametrize("stream", STREAMS)
def test_mc_plan_matches_numpy_on_streams(stream):
    """Every P frame (the spill frames of runs720p, synth720p's two-slot
    frames, walk_analog's ties among them); the decoder's plane dict
    carries the compiled plan."""
    p_frames = spills = predicted = 0
    for i, f, planes in _planned_frames(stream):
        rs, mv = planes["ref_slot"], f["mv"]
        if not (rs >= 0).any():
            continue
        p_frames += 1
        spills += numpy_spills(f["mb_w"], f["mb_h"], rs, mv)
        _, compared, _ = check_mc_plan(
            f["mb_w"], f["mb_h"], rs, mv,
            predict=predicted < PREDICTED_PER_STREAM)
        predicted += compared
        got, _ = tmc.mc_plan(f["mb_w"], f["mb_h"], rs, mv, PAD)
        for k in got:
            if k != "mc_fast" or "wp_luma" not in planes:
                np.testing.assert_array_equal(planes[k], got[k])
    assert p_frames >= 8 and spills >= 1
    if stream == "runs720p.264":
        assert (p_frames, spills) == (8, 8)


def _mc_frame(mb_w, mb_h, triples, seed, slot_of=None):
    """ref_slot [n, 16] int32 and mv [n, 16, 2] int16: MB k takes triple
    triples[k % len] = (slot, mvx, mvy) for all its cells."""
    n = mb_w * mb_h
    t = np.array([triples[k % len(triples)] for k in range(n)], np.int64)
    ref_slot = np.repeat(t[:, :1], 16, 1).astype(np.int32)
    mv = np.repeat(t[:, None, 1:], 16, 1).astype(np.int16)
    return ref_slot, mv


def _distinct_mvs(count, seed, span=60):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < count:
        v = tuple(int(x) for x in rng.integers(-span, span + 1, 2))
        if v not in out:
            out.append(v)
    return out


def _counted(mb_w, mb_h, cells_per_triple, seed, slots=(0,)):
    """A frame whose triple j covers cells_per_triple[j] cells (whole
    MBs), the rest of the frame intra; slots taken in turn."""
    n = mb_w * mb_h
    ref_slot = np.full((n, 16), -1, np.int32)
    mv = np.zeros((n, 16, 2), np.int16)
    cell = 0
    for j, ((vx, vy), cnt) in enumerate(zip(
            _distinct_mvs(len(cells_per_triple), seed), cells_per_triple)):
        ref_slot.reshape(-1)[cell:cell + cnt] = slots[j % len(slots)]
        mv.reshape(-1, 2)[cell:cell + cnt] = (vx, vy)
        cell += cnt
    assert cell <= n * 16
    return ref_slot, mv


def _case(name):
    """(mb_w, mb_h, ref_slot, mv, pad, expected (mc_fast, spilled, tied))
    of a named synthetic case."""
    m = tmc.MC_MV_MAX
    if name == "32 triples":
        return (40, 20, *_counted(40, 20, [16 * (j + 1) for j in range(32)],
                                  0), PAD, (True, False, False))
    if name == "33 triples, distinct counts":
        return (40, 20, *_counted(40, 20, [5 + 7 * j for j in range(33)],
                                  1), PAD, (True, True, False))
    if name == "tie at the cut":
        return (20, 12, *_counted(20, 12, [40] * 30 + [9] * 5, 2), PAD,
                (True, True, True))
    if name == "tie at the cut, two slots":
        return (20, 12, *_counted(20, 12, [40] * 30 + [9] * 5, 3,
                                  slots=(0, 1)), PAD, (True, True, True))
    if name == "3 slots":
        return (9, 4, *_counted(9, 4, [16] * 6, 4, slots=(0, 1, 2)), PAD,
                (False, False, False))
    if name == "2 slots":
        return (9, 4, *_counted(9, 4, [16] * 6, 5, slots=(3, 1)), PAD,
                (True, False, False))
    if name in ("512 fix-ups", "513 fix-ups"):
        rs, mv = _counted(40, 20, [3000], 6)
        k = int(name.split()[0])
        mv.reshape(-1, 2)[:k] = (m + 1, 0)
        return (40, 20, rs, mv, PAD, (k == 512, False, False))
    if name in ("spill to 512 fix-ups", "spill to 513 fix-ups"):
        # 32 kept triples, the least populated (500 cells) spilled, 12 or
        # 13 long MVs
        k = int(name.split()[2])
        rs, mv = _counted(40, 28, [501 + j for j in range(32)] + [500], 7)
        long = np.flatnonzero(rs.reshape(-1) == -1)[:k - 500]
        rs.reshape(-1)[long] = 0
        mv.reshape(-1, 2)[long] = (0, -m - 1)
        return (40, 28, rs, mv, PAD, (k == 512, True, False))
    if name == "MVs at +-MC_MV_MAX and one past":
        ring = [(0, m, m), (0, -m, -m), (1, m, -m), (1, -m, m),
                (0, m + 1, 0), (1, 0, -m - 1), (0, -m - 1, m), (1, 3, 1)]
        return (6, 4, *_mc_frame(6, 4, ring, 8), PAD, (True, False, False))
    if name == "clip bounds on all four sides":
        # right and bottom: the iFullMV bound exactly and one past; left
        # and top: -(pad - 2) * 4 quarter-pels exactly and one past (both
        # longer than MC_MV_MAX, so fix-ups either way)
        mb_w, mb_h = 6, 5
        rs = np.zeros((mb_w * mb_h, 16), np.int32)
        mv = np.zeros((mb_w * mb_h, 16, 2), np.int16)
        right = 4 * (16 * mb_w + PAD - 19) - 4 * (16 * mb_w - 4)
        bottom = 4 * (16 * mb_h + PAD - 19) - 4 * (16 * mb_h - 4)
        lo = 4 * (2 - PAD)
        for row in range(mb_h):
            mv[row * mb_w + mb_w - 1, [3, 7, 11, 15]] = \
                [(right, 0), (right + 1, 0), (right, 1), (right + 1, -1)]
            mv[row * mb_w, [0, 4, 8, 12]] = \
                [(lo, 0), (lo - 1, 0), (lo, 2), (lo - 1, 2)]
        for col in range(mb_w):
            mv[(mb_h - 1) * mb_w + col, [12, 13, 14, 15]] = \
                [(0, bottom), (0, bottom + 1), (1, bottom), (2, bottom + 1)]
            mv[col, [0, 1, 2, 3]] = [(0, lo), (0, lo - 1), (1, lo),
                                     (2, lo - 1)]
        return (mb_w, mb_h, rs, mv, PAD, (True, False, False))
    if name == "all intra":
        n = 80 * 45
        return (80, 45, np.full((n, 16), -1, np.int32),
                np.zeros((n, 16, 2), np.int16), PAD, (False, False, False))
    if name == "every inter cell a fix-up":
        rs, mv = _mc_frame(4, 3, [(0, m + 5, 0), (2, 0, -m - 9)], 9)
        return (4, 3, rs, mv, PAD, (True, False, False))
    if name.startswith("random"):
        mb_w, mb_h, seed, pad = {"random 9x4": (9, 4, 10, PAD),
                                 "random 80x45": (80, 45, 11, PAD),
                                 "random 13x7 pad 16": (13, 7, 12, 16),
                                 "random 1x1": (1, 1, 13, PAD)}[name]
        rng = np.random.RandomState(seed)
        n = mb_w * mb_h
        mvset = rng.randint(-100, 100, (5, 2))
        mv = mvset[rng.randint(0, 5, (n, 16))].astype(np.int16)
        rs = rng.randint(0, 2, (n, 16)).astype(np.int32)
        wild = rng.rand(n, 16) < 0.02
        mv[wild] = rng.randint(-400, 400, (wild.sum(), 2))
        rs[rng.rand(n, 16) < 0.05] = -1
        return mb_w, mb_h, rs, mv, pad, None
    raise KeyError(name)


MC_CASES = ["32 triples", "33 triples, distinct counts", "tie at the cut",
            "tie at the cut, two slots", "3 slots", "2 slots",
            "512 fix-ups", "513 fix-ups", "spill to 512 fix-ups",
            "spill to 513 fix-ups", "MVs at +-MC_MV_MAX and one past",
            "clip bounds on all four sides", "all intra",
            "every inter cell a fix-up", "random 9x4", "random 80x45",
            "random 13x7 pad 16", "random 1x1"]


@pytest.mark.parametrize("name", MC_CASES)
def test_mc_plan_matches_numpy_on_synthetic(name):
    mb_w, mb_h, rs, mv, pad, expect = _case(name)
    tied, compared, _ = check_mc_plan(mb_w, mb_h, rs, mv, pad)
    assert compared == (tied and bool(expect and expect[0]))
    got, spilled = tmc.mc_plan(mb_w, mb_h, rs, mv, pad)
    if expect is not None:
        assert (bool(got["mc_fast"]), spilled, tied) == expect
    if name == "clip bounds on all four sides":
        # each bound cell fast, each cell one past it a fix-up
        fix = set(got["mc_fix"][got["mc_fix"] >= 0].tolist())
        past = {i for i, (vx, vy) in enumerate(mv.reshape(-1, 2))
                if vx in (mv.max(), 4 * (2 - PAD) - 1)
                or vy in (mv[..., 1].max(), 4 * (2 - PAD) - 1)}
        assert past and past <= fix
    if name.startswith("tie at the cut"):
        # the rule: of the five triples of 9 cells the two lower keys stay
        kept = _kept_keys(got)
        nines = sorted(k for k, c in _fast_counts(
            mb_w, mb_h, rs, mv, pad).items() if c == 9)
        assert [k for k in nines if k in kept] == nines[:2]


# ---------------------------------------------------------------------------
# the wrappers' checks, the build
# ---------------------------------------------------------------------------
def _frame_for_checks():
    f = _nnz_frame(5, 3, 20)
    rs, mv = _mc_frame(5, 3, [(0, 4, -8), (1, -12, 0)], 21)
    return f, rs, mv


@pytest.mark.parametrize("bad", [
    "luma_ac int32", "luma8 int8", "mb_class int32", "cbp_luma bool",
    "luma_ac Fortran order", "luma8 strided", "transform8 too short"])
def test_nnz_plane_refuses(bad):
    f, _, _ = _frame_for_checks()
    key, how = bad.split(" ", 1)
    a = f[key]
    f[key] = {"int32": lambda: a.astype(np.int32),
              "int8": lambda: a.astype(np.int8),
              "bool": lambda: a.astype(bool),
              "Fortran order": lambda: np.asfortranarray(a),
              "strided": lambda: np.repeat(a, 2, axis=0)[::2],
              "too short": lambda: a[:-1]}[how]()
    with pytest.raises(ValueError, match=key):
        dt.nnz_plane(f)


@pytest.mark.parametrize("bad", [
    "mv int32", "mv Fortran order", "mv strided", "ref_slot int8",
    "ref_slot int64", "ref_slot strided", "ref_slot too long"])
def test_mc_plan_refuses(bad):
    _, rs, mv = _frame_for_checks()
    key, how = bad.split(" ", 1)
    args = {"ref_slot": rs, "mv": mv}
    a = args[key]
    args[key] = {"int32": lambda: a.astype(np.int32),
                 "int8": lambda: a.astype(np.int8),
                 "int64": lambda: a.astype(np.int64),
                 "Fortran order": lambda: np.asfortranarray(a),
                 "strided": lambda: np.repeat(a, 2, axis=0)[::2],
                 "too long": lambda: np.concatenate([a, a[:1]])}[how]()
    with pytest.raises(ValueError, match=key):
        tmc.mc_plan(5, 3, args["ref_slot"], args["mv"], PAD)


def test_host_library_is_built_by_gxx_on_its_own():
    """The plan's library lies under build/host, apart from the kernels'
    library (which needs nvcc), and is current after its first use."""
    so = _build.host_lib()
    assert so.pip_plan_nnz.restype is not None
    assert os.path.dirname(_build.HOST_LIB_PATH) == _build.HOST_BUILD_DIR
    assert _build.HOST_LIB_PATH != _build.LIB_PATH
    assert _build.host_sources() and all(
        s.endswith(".cpp") for s in _build.host_sources())
    assert not _build.needs_host_build()
