"""Shared set-up of the benchmark's own tests: the import paths, the card
marker, and a small checkout of fixture cells that a CPU can run.

    python -m pytest bench_port/tests -q          # on the CPU
    python -m pytest bench_port/tests -q -m cuda  # on the card
"""
import json
import os
import shutil
import sys

import numpy as np
import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import frames as gen  # noqa: E402

# a fixture configuration and traffic at 64x48: the drivers' whole path,
# the check and the faults, small enough for the CPU
TINY_IPPP = {"name": "tiny_ippp", "width": 64, "height": 48,
             "encoder": {"qp": 28, "gop": 6, "refs": 1, "cabac": False,
                         "deblock": True, "scene_cut": False}}
TRAFFIC = {
    "tiny_passes": {"driver": "decode_closed", "stream": "tiny",
                    "clip_frames": [3, 6], "trace_frames": 6,
                    "check_share": 0.5},
    "tiny_gops": {"driver": "encode_closed", "gops": 2, "batch": 2,
                  "patches_per_frame": 1, "trace_frames": 6,
                  "mse_limit": 100.0},
}
CELLS = {"tiny_dec": ("tiny_ippp", "tiny_passes"),
         "tiny_enc": ("tiny_ippp", "tiny_gops")}
TINY_STREAM_FRAMES = 8


def tiny_stream():
    """A 64x48 IPPP stream of the port's encoder (CPU) over the seeded
    pan, and NpDecoder's CRC32 of each of its frames."""
    from losslessh264_tpu_torch.encoder_torch import TorchEncoder
    from reference import check as ref, decoder_np
    plan = gen.patch_plan(np.random.default_rng(5), 64, 48,
                          TINY_STREAM_FRAMES, 1)
    enc = TorchEncoder(64, 48, qp=26, device="cpu")
    data = b"".join(enc.encode_frame(*f)
                    for f in gen.pan_frames(64, 48, plan, seed=5))
    crcs = [ref.frame_crc(*yuv)
            for yuv in decoder_np.NpDecoder(data).frames()]
    return data, crcs


def write_fixture(root, data, crcs, metrics=()):
    """A checkout at `root` with the benchmark's folder and, as new files
    only, the fixture cells: configurations, traffic, a stream and its
    CRCs, and the given (name, source code) per-layer metric readers."""
    shutil.copytree(BENCH, os.path.join(root, "bench_port"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "data"))
    b = os.path.join(root, "bench_port")
    os.makedirs(os.path.join(b, "data"))
    for cfg in (TINY_IPPP,):
        with open(os.path.join(b, "configs", cfg["name"] + ".json"),
                  "w") as fh:
            json.dump(cfg, fh)
    for name, t in TRAFFIC.items():
        with open(os.path.join(b, "traffic", name + ".json"), "w") as fh:
            json.dump(t, fh)
    with open(os.path.join(b, "data", "tiny.264"), "wb") as fh:
        fh.write(data)
    with open(os.path.join(b, "reference", "crc", "tiny.json"), "w") as fh:
        json.dump({"crc32": crcs}, fh)
    for name, src in metrics:
        with open(os.path.join(b, "metrics", name + ".py"), "w") as fh:
            fh.write(src)
    bench = {
        "command": ["python3", "bench_port/run.py"], "paths": ["bench_port"],
        "run_seconds": 1,
        "configs": [{"name": c["name"], "source": "https://example.org",
                     "file": f"bench_port/configs/{c['name']}.json",
                     "reduced": [], "why": "fixture"}
                    for c in (TINY_IPPP,)],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1,
                       "why": "fixture"} for n, (c, t) in CELLS.items()],
        "end_to_end": [
            {"name": "decode_fps", "unit": "frames/s", "better": "higher",
             "bound": 0.25, "source": "host_clock",
             "workloads": ["tiny_dec"]},
            {"name": "encode_fps", "unit": "frames/s", "better": "higher",
             "bound": 0.25, "source": "host_clock",
             "workloads": ["tiny_enc"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [
            {"name": n, "unit": "ms/frame", "better": "lower",
             "source": "program_span", "layer": "fixture",
             "moves": "decode_fps", "workloads": ["tiny_dec"]}
            for n, _ in metrics],
    }
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


@pytest.fixture(scope="session")
def tiny():
    import torch
    torch.set_num_threads(1)
    return tiny_stream()


@pytest.fixture
def fixture_root(tmp_path, tiny):
    return write_fixture(str(tmp_path), *tiny)


@pytest.fixture
def card():
    """Skips where no card is present (decided here, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
