"""The plain reference against the port at small sizes on the CPU, in
float64: the same operator, constants and time step; and the
configurations' time steps against the rules their files state."""

import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import grid2d


def test_disc_and_constants():
    assert grid2d.disc_count(8) == 197  # the reference code's 197 points at eps 8
    assert grid2d.half_heights(3) == [0, 2, 2, 3, 2, 2, 0]
    h = 1 / 4096
    assert grid2d.euler_dt(1.0, 8, h, 0.8) == pytest.approx(0.8 * 1.549e-7, rel=1e-3)


@pytest.mark.parametrize("eps,shape", [(8, (40, 36)), (3, (17, 23))])
def test_grid_reference_matches_the_port(eps, shape):
    from nonlocalheatequation_torch.models.solver2d import Solver2D

    rng = np.random.default_rng(3)
    u0 = rng.standard_normal(shape)
    h = 1.0 / shape[0]
    dt = grid2d.euler_dt(1.0, eps, h, 0.8)
    s = Solver2D(*shape, 7, eps, k=1.0, dt=dt, dh=h, device="cpu", dtype=torch.float64)
    s.input_init(u0)
    port = s.do_work()
    ref = grid2d.solve(torch.as_tensor(u0), eps, 1.0, h, dt, 7).numpy()
    assert np.abs(port - ref).max() <= 1e-12 * np.abs(ref).max()
    control = grid2d.solve(torch.as_tensor(u0), eps, 1.0, h, dt, 7, "bfloat16").numpy()
    assert np.abs(control - ref).max() > 1e-4 * np.abs(ref).max()


def test_config_is_the_published_run_with_its_changes_named():
    c = json.loads((harness.BENCH / "configs" / "grid2d-eps8-8192.json").read_text())
    pub = c["published"]
    # the reference's documented run (README.md:64-67), stable at dh = 1/400:
    # 1e-5 is 0.616 of forward Euler's bound there
    assert pub == {"mesh": [400, 400], "tiles": [20, 20], "eps": 8, "dt": 1e-05, "nt": 20,
                   "nodes": 4}
    assert pub["dt"] / grid2d.euler_dt(c["k"], pub["eps"], 1 / 400, 1.0) == pytest.approx(0.615625)
    # the run as made: 8192^2 on the unit square, 500 steps at 0.8 of the bound
    assert c["mesh"] == [8192, 8192] and c["dh"] == 1 / 8192 and c["nt"] == 500
    assert c["eps"] == pub["eps"]
    assert c["dt"] == grid2d.euler_dt(c["k"], c["eps"], c["dh"], 0.8)
    # one float32 field is at least four times the card's 50 MiB L2
    assert c["mesh"][0] * c["mesh"][1] * 4 >= 4 * 50 * 2**20
    changed = {k for k, v in pub.items() if c[k] != v}
    assert changed | {"dh"} == set(c["reduced"])
