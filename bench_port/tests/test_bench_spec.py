"""BENCHMARK.json and the files it names: the shapes and names the
benchmark's contract allows, every cell's configuration, traffic, driver
and metric readers, and a fixture cell added as new files only."""
import json
import os
import re

import pytest

from conftest import BENCH, ROOT
from harness import runner, spec

KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def line_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    b = bench()
    assert set(b) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH_RE.match(p) and ".." not in p.split("/")
        assert not p.endswith("_torch") and os.path.isdir(
            os.path.join(ROOT, p))
    assert len(b["command"]) <= 32 and all(line_ok(w) for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    for group, keys in (("configs", CONFIG_KEYS), ("workloads", CELL_KEYS)):
        names = [e["name"] for e in b[group]]
        assert len(names) == len(set(names))
        for e in b[group]:
            assert set(e) == keys, e["name"]
            assert spec.NAME_RE.match(e["name"]) and line_ok(e["why"])
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"])
    for m in metrics:
        assert spec.NAME_RE.match(m["name"]), m["name"]
        assert spec.UNIT_RE.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in names
    setup = next(m for m in b["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    for c in b["configs"]:
        assert line_ok(c["source"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        assert all(spec.NAME_RE.match(k) for k in c["reduced"])
    assert len({c["file"] for c in b["configs"]}) == len(b["configs"])
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert all(w["chips"] in (1, 4) for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_its_metrics_move():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for cell in cells:
        mine = [m for m in b["end_to_end"] if spec.applies(m, cell)]
        assert any(m["name"] == "setup_s" for m in mine)
        assert len(mine) >= 2, cell
        assert any(spec.applies(m, cell) for m in b["per_layer"]), cell
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert spec.applies(e2e[m["moves"]], cell), (m["name"], cell)
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    rooflines = [m for m in b["per_layer"] if "roofline" in m["name"]]
    assert all(m["unit"] == "%" for m in rooflines)


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_load(cell):
    c = spec.Cell(ROOT, cell)
    assert c.config["name"] == c.entry["config"]
    assert {"width", "height", "encoder"} <= set(c.config)
    assert {"reduced", "assumed", "source"} <= set(c.config)
    assert callable(c.driver().run)
    for m in c.per_layer:
        assert callable(c.reader(m["name"])), m["name"]
        assert c.reader(m["name"])(None) is None
    for f in os.listdir(os.path.join(BENCH, "traffic")):
        assert spec.NAME_RE.match(f[:-len(".json")]) and f.endswith(".json")


def test_files_are_named_from_names():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH_RE.match(rel), rel


def test_a_new_cell_config_and_metric_are_new_files(tmp_path, tiny):
    """A fixture cell in a temporary checkout: its configuration, traffic
    and per-layer metric are files that did not exist, and the harness
    finds each by the name BENCHMARK.json gives it."""
    reader = ('from harness.readers import stage_ms\n\n\n'
              'def read(t):\n    return stage_ms(t, ("symbols",))\n')
    root = spec_root = str(tmp_path)
    from conftest import write_fixture
    write_fixture(root, *tiny, metrics=[("fix.symbols_ms", reader)])
    before = set()
    for dirpath, _, files in os.walk(BENCH):
        before |= {os.path.relpath(os.path.join(dirpath, f), BENCH)
                   for f in files if "__pycache__" not in dirpath}
    after = set()
    for dirpath, _, files in os.walk(os.path.join(root, "bench_port")):
        after |= {os.path.relpath(os.path.join(dirpath, f),
                                  os.path.join(root, "bench_port"))
                  for f in files}
    for f in before & after:
        if not f.startswith("tests"):
            with open(os.path.join(BENCH, f), "rb") as a, \
                    open(os.path.join(root, "bench_port", f), "rb") as b:
                assert a.read() == b.read(), f
    cell = spec.Cell(spec_root, "tiny_dec")
    assert cell.config["name"] == "tiny_ippp"
    assert cell.traffic["stream"] == "tiny"
    assert [m["name"] for m in cell.per_layer] == ["fix.symbols_ms"]
    t = runner.TraceData(spans={"symbols": 30.0}, frames=3)
    assert cell.reader("fix.symbols_ms")(t) == 10.0
