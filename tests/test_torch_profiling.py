"""The port's ``--profile`` (utils/profiling.py, ``torch.profiler``), as
tests/test_profiling.py holds the JAX package's, on the CPU.

* ``trace(dir)`` around a CPU solve writes one Chrome trace under the
  directory; ``trace(None)`` and ``trace("")`` are no-ops.
* A profiler that fails to start or stop prints ``[profiling] ...`` and
  the solve runs to its end.
* ``run_batch`` runs the sequential and the ``--ensemble`` modes inside one
  capture, and ``profile=None`` enters the no-op.
* ``--profile`` on each CLI that has it writes a trace: solve1d, solve2d
  and solve3d (a single solve and a batch) and solve2d_distributed.
"""

import contextlib
import io
import json
import sys

import pytest
import torch

from nonlocalheatequation_torch.cli import common, solve1d, solve2d, solve2d_distributed, solve3d
from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.utils import profiling
from nonlocalheatequation_torch.utils.profiling import trace

torch.set_num_threads(1)


def _files(root):
    return sorted(p for p in root.rglob("*") if p.is_file())


def test_trace_captures_solve(tmp_path):
    logdir = tmp_path / "trace"
    s = Solver2D(20, 20, 3, eps=3, k=1.0, dt=1e-4, dh=0.05, device="cpu")
    s.test_init()
    with trace(str(logdir)):
        s.do_work()
    assert s.error_l2 / 400 <= 1e-6
    found = _files(logdir)
    assert len(found) == 1 and found[0].name.endswith(".pt.trace.json")
    events = json.loads(found[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_none_is_noop(tmp_path, monkeypatch, log_dir):
    monkeypatch.chdir(tmp_path)
    s = Solver2D(10, 10, 2, eps=2, device="cpu")
    s.test_init()
    with trace(log_dir):
        s.do_work()
    assert s.u is not None and _files(tmp_path) == []


@pytest.mark.parametrize("where", ["start", "stop"])
def test_a_failing_profiler_does_not_kill_the_solve(tmp_path, monkeypatch, capsys, where):
    class Broken:
        def __init__(self, **kw):
            if where == "start":
                raise RuntimeError("no profiler here")

        def start(self):
            pass

        def stop(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr("torch.profiler.profile", Broken)
    s = Solver2D(10, 10, 2, eps=2, device="cpu")
    s.test_init()
    with trace(str(tmp_path / "t")):
        s.do_work()
    assert s.u is not None
    assert f"[profiling] {where}_trace failed: RuntimeError('no profiler here')" in \
        capsys.readouterr().err


def test_run_batch_threads_profile_to_every_mode(monkeypatch, capsys):
    captures = []

    @contextlib.contextmanager
    def spy_trace(log_dir):
        captures.append(("enter", log_dir))
        yield
        captures.append(("exit", log_dir))

    monkeypatch.setattr(profiling, "trace", spy_trace)

    def read_case(toks, pos):
        return ((int(toks[pos]),), pos + 1)

    def run_case(case):
        assert captures == [("enter", "DIR")]  # the sequential loop runs inside
        return 0.0, case[0]

    monkeypatch.setattr(sys, "stdin", io.StringIO("2\n7\n8\n"))
    assert common.run_batch(read_case, run_case, row_tokens=1, profile="DIR") == 0
    assert captures == [("enter", "DIR"), ("exit", "DIR")]
    captures.clear()

    def run_ensemble(cases):
        assert captures == [("enter", None)]
        return [(0.0, n) for (n,) in cases]

    monkeypatch.setattr(sys, "stdin", io.StringIO("1\n7\n"))
    assert common.run_batch(read_case, None, row_tokens=1, run_ensemble=run_ensemble,
                            profile=None) == 0
    assert captures == [("enter", None), ("exit", None)]
    assert capsys.readouterr().out.count("Tests Passed") == 2


@pytest.mark.parametrize("cli,argv,stdin", [
    (solve1d, ["--test", "--nx", "12", "--nt", "3", "--eps", "2"], None),
    (solve2d, ["--test", "--nx", "8", "--ny", "6", "--nt", "3", "--eps", "2"], None),
    (solve2d, ["--test_batch"], "1\n8 8 3 2 1 0.0005 0.05\n"),
    (solve2d, ["--test_batch", "--ensemble"], "2\n8 8 3 2 1 0.0005 0.05\n8 8 3 2 0.5 0.0005 0.05\n"),
    (solve3d, ["--test", "--nx", "6", "--ny", "5", "--nz", "4", "--nt", "3", "--eps", "1"], None),
    (solve3d, ["--test_batch"], "1\n6 6 6 3 1 1 0.0005 0.1\n"),
    (solve2d_distributed, ["--nx", "4", "--ny", "4", "--nt", "3", "--eps", "2", "--devices",
                           "4"], None)],
    ids=["solve1d", "solve2d", "solve2d-batch", "solve2d-ensemble", "solve3d", "solve3d-batch",
         "solve2d_distributed"])
def test_profile_flag_on_each_cli(tmp_path, monkeypatch, capsys, cli, argv, stdin):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    logdir = tmp_path / "prof"
    assert cli.main(argv + ["--profile", str(logdir), "--platform", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("Tests Passed" in out) if "--test_batch" in argv else ("l2: " in out)
    found = _files(logdir)
    assert len(found) == 1 and found[0].name.endswith(".pt.trace.json")
