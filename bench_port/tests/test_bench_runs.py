"""Whole runs of the drivers: sound runs come out correct, and runs with
the timed path broken underneath come out not correct.

On the CPU the fixture cells (64x48 and 96x80) run with the harness's
look for a card skipped. On the card (`-m cuda`) the benchmark's own
cells run at their own sizes with the control and each fault on three
seeds each, and print the numbers compared, which set the limits
(PERF.md)."""
import json
import os
import time

import numpy as np
import pytest

from conftest import ROOT
from harness import frames as gen
from harness import runner, spec

FAULTS = ("control", "stale_state", "alter_output")
# a fault the encoder and the decoder share (the encode cells only)
SHARED = ("shared_filter",)
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def run(root, cell, fault, device, seed=2 ** 31 + 7, seconds=0.5,
        trace=False):
    ctx = runner.Ctx(root=root, cell=spec.Cell(root, cell), seed=seed,
                     seconds=seconds, trace=trace, device=device,
                     fault=fault)
    return runner.run_cell(ctx, time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny_dec", "tiny_enc"])
@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_fixture_cell(fixture_root, cell, fault):
    result, out = run(fixture_root, cell, fault, "cpu")
    assert result["correct"] == (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0


def test_shared_fault_is_caught_by_the_reference(fixture_root):
    """The in-loop filter left out in the code the encoder and the
    decoder share: the two agree with each other, and only the numpy
    reference's reconstruction of the sampled P frame shows it."""
    result, _ = run(fixture_root, "tiny_enc", "shared_filter", "cpu")
    checks = result["checks"]
    assert not result["correct"]
    assert checks["recon_mismatch"]["value"] == 0, checks
    assert checks["reference_mismatch"]["value"] > 0, checks


def test_mark_ltr_drift_is_a_program_fault():
    """The program's fault that keeps the live cell out (PERF.md): after
    mark_ltr() the encoder predicts the next P frame from the picture it
    just marked long-term, but writes it as a prediction from the newest
    short-term picture, so the numpy reference decoder drifts from the
    encoder's recon from that frame on."""
    from losslessh264_tpu_torch.encoder_torch import TorchEncoder
    from reference import check as ref, decoder_np
    plan = gen.patch_plan(np.random.default_rng(3), 96, 80, 6, 1)
    enc = TorchEncoder(96, 80, qp=28, ltr=True, device="cpu")
    data, recons = [], []
    for i, f in enumerate(gen.pan_frames(96, 80, plan, seed=3)):
        if i == 2:
            enc.mark_ltr()
        data.append(enc.encode_frame(*f))
        recons.append(tuple(a.numpy() for a in enc.ref))
    pics = list(decoder_np.NpDecoder(b"".join(data)).frames())
    off = [ref.mismatched(p, r) for p, r in zip(pics, recons)]
    assert len(pics) == 6 and off[:3] == [0, 0, 0], off
    assert all(x > 0 for x in off[3:]), off


def test_traced_fixture_cell(fixture_root):
    result, out = run(fixture_root, "tiny_enc", None, "cpu", trace=True)
    assert result["correct"]
    assert out.trace.spans and out.trace.frames > 0
    assert out.trace.least_s > 0


def cell_faults():
    """(cell, fault) of every cell of BENCHMARK.json: the control and the
    faults, and on the encode cells the shared one."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        names = [w["name"] for w in json.load(fh)["workloads"]]
    out = []
    for name in names:
        encode = spec.Cell(ROOT, name).driver_name.startswith("encode")
        out += [(name, f) for f in FAULTS + (SHARED if encode else ())]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", cell_faults())
def test_cell_faults_on_the_card(card, cell, fault):
    """The control and each fault at the cell's own size, three seeds;
    their readings are appended to chiprun_out/readings.jsonl."""
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    for seed in SEEDS:
        result, _ = run(ROOT, cell, fault, card, seed=seed, seconds=3.0)
        with open(os.path.join(out_dir, "readings.jsonl"), "a") as fh:
            fh.write(json.dumps({"cell": cell, "fault": fault, "seed": seed,
                                 "checks": result["checks"]}) + "\n")
        assert not result["correct"], (seed, result["checks"])
