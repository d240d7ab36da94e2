"""The port stands alone: no JAX, no JAX package, no quiet CPU fallback.

* A subprocess with ``jax`` and ``nonlocalheatequation_tpu`` blocked in
  ``sys.modules`` imports every module of the port and chip_smoke.py and
  runs a small 2D and 3D CPU solve.
* No source file of the port names either package in an import.
* chip_smoke.py on a host without a CUDA card exits non-zero and prints no
  result line.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "nonlocalheatequation_torch"

BLOCKED_RUN = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["nonlocalheatequation_tpu"] = None
import nonlocalheatequation_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, prefix=pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from nonlocalheatequation_torch.models.solver2d import Solver2D
s = Solver2D(24, 24, 10, 4, device="cpu", method="cuda")
s.test_init()
s.do_work()
assert s.error_l2 / 24**2 <= 1e-6, s.error_l2
from nonlocalheatequation_torch.models.solver3d import Solver3D
s = Solver3D(10, 9, 8, 6, 2, device="cpu", method="cuda")
s.test_init()
s.do_work()
assert s.error_l2 / (10 * 9 * 8) <= 1e-6, s.error_l2
assert not any(m == "jax" or m.startswith(("jax.", "nonlocalheatequation_tpu"))
               for m, v in sys.modules.items() if v is not None)
print("imported", len(names))
"""


def test_port_imports_and_solves_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 23


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                root = m.split(".")[0]
                assert root not in ("jax", "jaxlib", "nonlocalheatequation_tpu"), (path, m)


def test_chip_smoke_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "is_available() is false" in r.stderr
