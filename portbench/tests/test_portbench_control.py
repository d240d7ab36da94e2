"""The output check at the small sizes, on the CPU with the look for a card
skipped: the program comes out correct; the control (the program's bfloat16
path) and each fault a solo cell can have (a time loop that returns its
state unchanged, an answer altered) come out not correct."""

import numpy as np
import pytest

from portbench.tests.conftest import SMALL

CELLS = sorted(SMALL)


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(run_small, workload):
    r = run_small(workload)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["checks"]["checked"]["value"] >= 1
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [11, 2**31 + 12, 3_000_000_013])
def test_control_is_not_correct(run_small, workload, seed):
    r = run_small(workload, seed=seed, control=True)
    assert not r["correct"]
    assert r["checks"]["rel_err"]["value"] > 3 * r["checks"]["rel_err"]["limit"]


def _unchanged(monkeypatch, workload):
    """The time loop returns its state unchanged."""
    from nonlocalheatequation_torch.models import solver2d

    monkeypatch.setattr(solver2d, "make_multi_step_fn", lambda *a, **k: (lambda u, t0: u))


def _altered(monkeypatch, workload):
    """One answer altered where it is produced: one value of the result."""
    from portbench import harness

    real = harness.drive_solve

    def drive(problem, *a, **k):
        solve = problem.solve

        def altered(iid):
            out = np.array(solve(iid))
            out.flat[out.size // 2] += 0.01 * np.abs(out).max()
            return out

        problem.solve = altered
        return real(problem, *a, **k)

    monkeypatch.setattr(harness, "drive_solve", drive)


FAULTS = [(w, name, plant) for w in CELLS
          for name, plant in (("unchanged", _unchanged), ("altered", _altered))]


@pytest.mark.parametrize("workload,fault,plant", FAULTS, ids=[f"{w}-{f}" for w, f, _ in FAULTS])
def test_fault_is_not_correct(run_small, monkeypatch, workload, fault, plant):
    plant(monkeypatch, workload)
    r = run_small(workload)
    assert not r["correct"], (fault, r["checks"])
