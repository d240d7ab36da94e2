"""Shared set-up of the benchmark's own tests: the repository root on the
path, and the small sizes at which a whole run fits in a test."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))



def _grid(n: int, steps: int, cfl: float) -> dict:
    """A square grid of ``n`` on the unit square, ``steps`` Euler steps at
    ``cfl`` times the bound (the configurations' eps 8 and k 1)."""
    from portbench.reference.grid2d import euler_dt

    return {"mesh": [n, n], "dh": 1.0 / n, "dt": euler_dt(1.0, 8, 1.0 / n, cfl), "nt": steps}


#: every cell of BENCHMARK.json at a size a test run holds on the CPU
SMALL = {
    "grid2d-eps8-8192.solo-long": {"config": _grid(48, 6, 0.8), "traffic": {"inputs": 2}},
}


@pytest.fixture
def run_small():
    """One run of a cell at its small size on the CPU (the look for a card
    skipped), returning the result line's object."""
    import time

    from portbench import harness

    def run(workload, seed=2**31 + 5, seconds=0.3, trace=False, control=False):
        return harness.run(workload, seed, seconds, trace, t_start=time.time(), device="cpu",
                           control=control, overrides=SMALL[workload])

    return run
