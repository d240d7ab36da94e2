"""Nothing the benchmark runs imports JAX or the JAX package, and the
references import nothing of the port: top-level module names compared
whole (the port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
import types

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "nonlocalheatequation_tpu"}


def imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(harness.BENCH.rglob("*.py"))
    assert len(files) > 15
    for path in files:
        assert not FORBIDDEN & set(imported(path)), path


def test_references_import_nothing_of_the_port():
    for path in sorted((harness.BENCH / "reference").glob("*.py")):
        assert set(imported(path)) <= {"__future__", "math", "torch"}, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nonlocalheatequation_tpux", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    r = subprocess.run([sys.executable, str(harness.BENCH / "run.py"), "--workload",
                        "grid2d-eps8-8192.solo-long", "--seed", str(2**31 + 3), "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout == ""
