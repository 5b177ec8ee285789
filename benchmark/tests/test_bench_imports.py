"""What the harness loads: no JAX and no JAX package; a reference that
imports nothing of the program; no fall-back to the CPU without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from benchmark import harness

HERE = Path(harness.__file__).resolve().parent


def imported_tops(path: Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").rglob("*.py")):
        tops = imported_tops(f)
        assert not tops & {"rag_challenge_2_tpu_torch", "rag_challenge_2_tpu", "jax",
                           "jaxlib", "flax", "benchmark"}, (f.name, tops)


def test_no_module_of_the_harness_imports_jax():
    for f in sorted(HERE.rglob("*.py")):
        assert not imported_tops(f) & {"jax", "jaxlib", "flax", "rag_challenge_2_tpu"}, f


def test_forbidden_names_are_compared_whole(monkeypatch):
    import rag_challenge_2_tpu_torch  # noqa: F401  (its name starts with the JAX package's)

    monkeypatch.setitem(sys.modules, "jaxlib_helpers", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, %r);"
            "from benchmark.tests.conftest import run_tiny;"
            "from benchmark import harness;"
            "line = run_tiny('flat10m_int8.hybrid_c1');"
            "print(line['correct'], harness.forbidden_modules(),"
            " 'rag_challenge_2_tpu_torch' in sys.modules)") % str(harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True [] True"


def test_without_a_card_it_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "flat10m_int8.scan127", "--seed", str(2**31 + 3), "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT, env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no CUDA card" in out.stderr


def test_fails_without_the_program(tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "flat10m_int8.scan127", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0 and "{" not in out.stdout
