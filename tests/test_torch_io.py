"""The port's CSV/VTU logs (utils/csvlog.py, utils/vtu.py) against the JAX
package's, on the CPU.

* ``VtuWriter`` files are byte for byte the JAX writer's, plain and
  zlib-compressed, and round-trip through the port's
  ``read_vtu_point_data``.
* The same states through both ``SimulationCsvLogger``s give
  byte-identical simulate_*.csv, score_*.csv and snapshots, in 1D and 2D.
* A logged port solve writes the JAX row and snapshot counts
  (tests/test_io.py::test_csv_logger_columns), on the oracle, the chunked
  and the throttled paths.
* ``--log`` on solve1d, solve2d, solve2d_async and solve2d_distributed;
  solve2d's files have the rows of the JAX solver and logger on the same
  case (float64; the values as printed, 6 digits, agree).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.cli import solve1d, solve2d, solve2d_async, solve2d_distributed
from nonlocalheatequation_torch.models.solver1d import Solver1D
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp1D, NonlocalOp2D
from nonlocalheatequation_torch.utils.csvlog import SimulationCsvLogger
from nonlocalheatequation_torch.utils.vtu import (
    VtuWriter,
    read_vtu_point_data,
    write_point_cloud_vtu,
)
from nonlocalheatequation_tpu.models.solver2d import Solver2D as JaxSolver2D
from nonlocalheatequation_tpu.ops import nonlocal_op as jop
from nonlocalheatequation_tpu.utils import csvlog as jcsvlog
from nonlocalheatequation_tpu.utils import vtu as jvtu

torch.set_num_threads(1)
CPU = "cpu"


def _snapshot(writer_cls, path, compress, rng_seed=0):
    rng = np.random.default_rng(rng_seed)
    w = writer_cls(path, compress)
    w.append_nodes(rng.normal(size=(12, 3)), displacement=rng.normal(size=(12, 3)))
    w.append_point_data("Temperature", rng.normal(size=12).astype(np.float32))
    w.append_point_data("Velocity", rng.normal(size=(12, 3)))
    w.append_cell_data("Damage", rng.normal(size=12))
    w.append_field_data("Energy", 1.5)
    w.add_time_step(0.25)
    w.close()


@pytest.mark.parametrize("compress", ["", "zlib"])
def test_vtu_writer_is_byte_for_byte_the_jax_writer(tmp_path, compress):
    _snapshot(VtuWriter, str(tmp_path / "ours"), compress)
    _snapshot(jvtu.VtuWriter, str(tmp_path / "theirs"), compress)
    ours = (tmp_path / "ours.vtu").read_bytes()
    assert ours == (tmp_path / "theirs.vtu").read_bytes()
    data = read_vtu_point_data(str(tmp_path / "ours.vtu"))
    rng = np.random.default_rng(0)
    nodes = rng.normal(size=(12, 3)) + rng.normal(size=(12, 3))
    temp = rng.normal(size=12).astype(np.float32)
    assert np.array_equal(data["Points"].reshape(-1, 3), nodes)
    assert np.array_equal(data["Temperature"], temp.astype(np.float64))
    assert data["TIME"][0] == 0.25 and data["Energy"][0] == 1.5
    want = jvtu.read_vtu_point_data(str(tmp_path / "theirs.vtu"))
    assert sorted(data) == sorted(want)
    assert all(np.array_equal(data[k], want[k]) for k in want)


def test_empty_snapshot_and_point_cloud_match_the_jax_writer(tmp_path):
    VtuWriter(str(tmp_path / "ours")).close()
    jvtu.VtuWriter(str(tmp_path / "theirs")).close()
    assert (tmp_path / "ours.vtu").read_bytes() == (tmp_path / "theirs.vtu").read_bytes()
    pts = np.random.default_rng(1).uniform(size=(9, 2))
    write_point_cloud_vtu(str(tmp_path / "a.vtu"), pts, {"u": np.arange(9)}, time=0.5)
    jvtu.write_point_cloud_vtu(str(tmp_path / "b.vtu"), pts, {"u": np.arange(9)}, time=0.5)
    assert (tmp_path / "a.vtu").read_bytes() == (tmp_path / "b.vtu").read_bytes()


def _log_both(tmp_path, ours_op, theirs_op, states, tag, compress):
    out = {}
    for name, cls, op in (("ours", SimulationCsvLogger, ours_op),
                          ("theirs", jcsvlog.SimulationCsvLogger, theirs_op)):
        log = cls(op, test=True, out_csv=str(tmp_path / name / "csv"),
                  out_vtk=str(tmp_path / name / "vtk"), tag=tag, nlog=3, compress=compress)
        for t, u in states:
            log(t, u)
        out[name] = {p.relative_to(tmp_path / name): p.read_bytes()
                     for p in sorted((tmp_path / name).rglob("*")) if p.is_file()}
    return out


@pytest.mark.parametrize("compress", ["", "zlib"])
def test_csv_logger_files_are_the_jax_loggers_2d(tmp_path, compress):
    ours_op = NonlocalOp2D(3, 1.0, 1e-4, 0.05)
    theirs_op = jop.NonlocalOp2D(3, 1.0, 1e-4, 0.05)
    rng = np.random.default_rng(4)
    states = [(t, rng.normal(size=(7, 5))) for t in (0, 3, 6)]
    files = _log_both(tmp_path, ours_op, theirs_op, states, "2d", compress)
    assert sorted(map(str, files["ours"])) == [
        "csv/score_2d.csv", "csv/simulate_2d.csv", "vtk/simulate_0.vtu", "vtk/simulate_1.vtu",
        "vtk/simulate_2.vtu"]
    assert files["ours"] == files["theirs"]


def test_csv_logger_files_are_the_jax_loggers_1d(tmp_path):
    ours_op = NonlocalOp1D(2, 1.0, 1e-3, 0.02)
    theirs_op = jop.NonlocalOp1D(2, 1.0, 1e-3, 0.02)
    rng = np.random.default_rng(5)
    states = [(t, rng.normal(size=11).astype(np.float32)) for t in (0, 3)]
    files = _log_both(tmp_path, ours_op, theirs_op, states, "1d", "")
    assert len(files["ours"]) == 4 and files["ours"] == files["theirs"]


@pytest.mark.parametrize("path", ["oracle", "chunked", "throttled"])
def test_logged_solve_writes_the_jax_counts(tmp_path, path):
    s = Solver2D(8, 8, 6, eps=2, k=1.0, dt=1e-4, dh=0.02, device=CPU,
                 backend="oracle" if path == "oracle" else "torch",
                 nd=2 if path == "throttled" else None)
    s.test_init()
    s.logger = SimulationCsvLogger(s.op, test=True, out_csv=str(tmp_path / "c"),
                                   out_vtk=str(tmp_path / "v"), nlog=s.nlog)
    s.do_work()
    sim_lines = open(tmp_path / "c" / "simulate_2d.csv").read().strip().splitlines()
    assert len(sim_lines) == 2 * 64  # logged at t=0 and t=5
    first = sim_lines[0].split(",")
    assert first[:3] == ["0", "0", "0"] and len(first) == 8 and first[-1] == ""
    score_lines = open(tmp_path / "c" / "score_2d.csv").read().strip().splitlines()
    assert len(score_lines) == 2 and score_lines[0].split(",")[0] == "0"
    assert sorted(p.name for p in (tmp_path / "v").iterdir()) == ["simulate_0.vtu",
                                                                "simulate_1.vtu"]
    snap = read_vtu_point_data(str(tmp_path / "v" / "simulate_1.vtu"))
    one = Solver2D(8, 8, 6, eps=2, k=1.0, dt=1e-4, dh=0.02, device=CPU)
    one.test_init()
    assert np.array_equal(snap["Temperature"].reshape(8, 8).T, one.do_work())
    assert snap["TIME"][0] == 5 * 1e-4


def test_logged_1d_solve_writes_the_jax_counts(tmp_path):
    s = Solver1D(10, 7, 2, nlog=3, device=CPU)
    s.test_init()
    s.logger = SimulationCsvLogger(s.op, test=True, out_csv=str(tmp_path / "c"),
                                   out_vtk=str(tmp_path / "v"), tag="1d", nlog=3)
    s.do_work()
    assert len(open(tmp_path / "c" / "simulate_1d.csv").read().splitlines()) == 3 * 10
    assert len(list((tmp_path / "v").iterdir())) == 3


def test_solve2d_log_is_the_jax_solvers_and_loggers(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ours").mkdir()
    monkeypatch.chdir(tmp_path / "ours")
    assert solve2d.main(["--test", "--log", "--nlog", "2", "--nx", "9", "--ny", "7", "--nt",
                         "5", "--eps", "2", "--cmp", "false", "--platform", "cpu"]) == 0
    capsys.readouterr()
    j = JaxSolver2D(9, 7, 5, 2, nlog=2, backend="jit", method="conv", dtype=jnp.float64)
    j.logger = jcsvlog.SimulationCsvLogger(j.op, test=True,
                                           out_csv=str(tmp_path / "theirs" / "out_csv"),
                                           out_vtk=str(tmp_path / "theirs" / "out_vtk"),
                                           tag="2d", nlog=2)
    j.test_init()
    j.do_work()
    files = {}
    for name in ("ours", "theirs"):
        files[name] = {str(p.relative_to(tmp_path / name)): p.read_text()
                       for p in sorted((tmp_path / name).rglob("*")) if p.is_file()}
    assert sorted(files["ours"]) == sorted(files["theirs"]) == [
        "out_csv/score_2d.csv", "out_csv/simulate_2d.csv", "out_vtk/simulate_0.vtu",
        "out_vtk/simulate_1.vtu", "out_vtk/simulate_2.vtu"]
    for name in ("out_csv/simulate_2d.csv", "out_csv/score_2d.csv"):
        # the same rows; the values printed with %g (6 digits) from states
        # 1e-12 apart (the two sum the stencil in other orders)
        ours, theirs = ([[float(x) for x in row.split(",")[:-1]] for row in
                         files[k][name].splitlines()] for k in ("ours", "theirs"))
        assert np.allclose(ours, theirs, rtol=1e-5, atol=1e-12)
    for i in range(3):
        ours = read_vtu_point_data(str(tmp_path / "ours" / f"out_vtk/simulate_{i}.vtu"))
        theirs = jvtu.read_vtu_point_data(str(tmp_path / "theirs" / f"out_vtk/simulate_{i}.vtu"))
        assert ours["TIME"] == theirs["TIME"]
        assert np.max(np.abs(ours["Temperature"] - theirs["Temperature"])) <= 1e-12


@pytest.mark.parametrize("cli,argv,rows,snaps", [
    (solve1d, ["--nx", "12", "--nt", "7", "--nlog", "3", "--eps", "2"], 3 * 12, 3),
    (solve2d, ["--nx", "6", "--ny", "5", "--nt", "7", "--nlog", "3", "--eps", "2"], 3 * 30, 3),
    (solve2d_async, ["--nx", "3", "--ny", "3", "--np", "2", "--nt", "7", "--nlog", "3",
                     "--eps", "2"], 3 * 36, 3),
    (solve2d_distributed, ["--nx", "4", "--ny", "4", "--npx", "2", "--npy", "2", "--nt", "7",
                           "--nlog", "3", "--eps", "2", "--devices", "4"], 3 * 64, 3)],
    ids=["solve1d", "solve2d", "solve2d_async", "solve2d_distributed"])
def test_log_flag_on_each_cli(tmp_path, monkeypatch, capsys, cli, argv, rows, snaps):
    monkeypatch.chdir(tmp_path)
    test = [] if cli in (solve2d_async, solve2d_distributed) else ["--test"]
    assert cli.main(argv + test + ["--log", "--platform", "cpu"]) == 0
    assert "l2: " in capsys.readouterr().out
    tag = "1d" if cli is solve1d else "2d"
    assert len((tmp_path / "out_csv" / f"simulate_{tag}.csv").read_text().splitlines()) == rows
    assert len((tmp_path / "out_csv" / f"score_{tag}.csv").read_text().splitlines()) == snaps
    assert len(list((tmp_path / "out_vtk").iterdir())) == snaps
