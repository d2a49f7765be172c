"""Nothing the benchmark runs imports JAX or the JAX package: the import
statements of its files, and the modules a whole run leaves loaded,
compared by top-level name (the part before the first dot) whole, since
the port's name begins with the JAX package's."""
import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT
from harness import runner


def test_sources_import_no_jax():
    for dirpath, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                elif isinstance(node, ast.Call) and getattr(
                        node.func, "attr", "") == "import_module":
                    arg = node.args[0]
                    names = [arg.value] if isinstance(arg, ast.Constant) \
                        else []
                for n in names:
                    assert n.split(".")[0] not in runner.FORBIDDEN, (f, n)


RUN = """
import sys, time
sys.path[:0] = [{bench!r}, {tests!r}, {root!r}]
import conftest, tempfile
from harness import runner, spec
root = conftest.write_fixture(tempfile.mkdtemp(), *conftest.tiny_stream())
for cell in ("tiny_dec", "tiny_enc"):
    ctx = runner.Ctx(root=root, cell=spec.Cell(root, cell), seed=3,
                     seconds=0.3, trace=cell == "tiny_enc", device="cpu")
    runner.run_cell(ctx, time.perf_counter())
import losslessh264_tpu_torch.encoder_torch, losslessh264_tpu_torch.decoder_torch
print("loaded:", ",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
print("forbidden:", runner.forbidden_modules())
"""


def test_a_whole_run_loads_no_jax(tmp_path):
    code = RUN.format(bench=BENCH, tests=os.path.join(BENCH, "tests"),
                      root=ROOT)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "forbidden: []" in out.stdout, out.stdout
    assert "losslessh264_tpu_torch" in out.stdout
