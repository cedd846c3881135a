"""The import boundary: no run loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import os
import pathlib
import subprocess
import sys

from conftest import BENCH, ROOT

from harness import main

FORBIDDEN = {"jax", "jaxlib", "flax", "ribbit_tpu"}


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for p in BENCH.rglob("*.py"):
        assert not _imports(p) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "ribbitref").glob("*.py"):
        assert "ribbit_tpu_torch" not in _imports(p), p
    assert main.reference_imports() == []
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import ribbitref.engine, ribbitref.streams\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ribbit_tpu_torch', 'ribbit_tpu', 'jax'})\n"
            "print(bad); assert not bad" % str(BENCH))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ribbit_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfake.sub", sys)
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ribbit_tpu.pipeline", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert main.forbidden_modules() == ["jax", "ribbit_tpu"]


def test_a_run_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, "benchmarks/run.py", "--workload",
                        "r64_default.genomes", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT),
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout.strip() == ""
