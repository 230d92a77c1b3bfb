"""Nothing a run loads is JAX or the JAX package (top-level names compared
whole: the port's name begins with the package's), the yardstick imports
nothing of the port, and a run with no card or no port prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from ntp_bench.common import BENCH, ROOT, banned_modules

YARDSTICK = [BENCH / "cost.py", BENCH / "trace.py", *sorted((BENCH / "reference").glob("*.py")),
             *sorted((BENCH / "metrics").glob("*.py"))]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_banned_names_are_compared_whole():
    assert banned_modules(["repro_torch", "repro_torch.core", "jaxtyping", "torch"]) == []
    assert banned_modules(["repro.core", "jax.numpy", "jaxlib", "flax"]) == \
        ["flax", "jax", "jaxlib", "repro"]


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: p.name)
def test_the_yardstick_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_a_small_run_loads_no_jax_and_no_jax_package():
    code = ("import sys, json; sys.path[:0] = ['src', '.']\n"
            "from ntp_bench.tests.conftest import run_small\n"
            "from ntp_bench.common import banned_modules\n"
            "for cell in ('mlp-table-o10', 'trunk-serve'):\n"
            "    run_small(cell, seconds=0.3)\n"
            "print(json.dumps(banned_modules(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _cli(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "ntp_bench.run", "--workload",
                           "mlp-table-o10", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_card_means_no_result():
    out = _cli(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "ntp_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_runs_correct_on_the_card(cuda_device):
    out = _cli(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"table_rows_per_s", "setup_s"}
