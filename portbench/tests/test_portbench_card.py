"""On the card: each cell runs end to end through ``run.py`` (a short window)
and comes out correct, with a trace; its control comes out not correct.
Skipped on a host without a CUDA device (decided inside the test)."""

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())
         ["workloads"]]


def run(workload, seed, trace, control):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed",
                        str(seed), "--seconds", "2", "--trace", str(trace), "--control",
                        str(control)], capture_output=True, text=True, timeout=1200,
                       cwd=harness.ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = run(workload, 2**31 + 21, 1, 0)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0 and r["metrics"]
    assert not run(workload, 2**31 + 22, 0, 1)["correct"]
