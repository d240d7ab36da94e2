"""The port's serving and observability flags on the CLIs, on the CPU in
float64 (``--platform cpu``).

* ``solve1d``, ``solve2d`` and ``solve3d --test_batch --serve 2`` over
  CASES_1D, CASES_2D and CASES_3D print "Tests Passed"; under
  ``NLHEAT_FAULT_PLAN=nan@c1x*`` the poison case fails the batch with a
  ``case 1 QUARANTINED`` line on stderr, as the JAX CLI does;
* every ``validate_serve_args`` and ``validate_obs_args`` refusal gives the
  JAX function's words on the same namespace;
* ``--metrics-out FILE`` writes the pipeline's ``metrics_json()`` line,
  ``--trace DIR`` writes ``host_trace.json`` with ``serve.dispatch`` spans
  beside the torch.profiler trace, ``--metrics-port 0`` serves ``/metrics``
  while a run is live; the four solve CLIs take the three flags, and
  ``--flight-dir`` is refused by name.
"""

import argparse
import io
import json
import os
import sys
import urllib.request

import pytest
import torch

from nonlocalheatequation_torch.cli import common, solve1d, solve2d, solve3d, solve_unstructured
from nonlocalheatequation_torch.serve import server as server_mod
from nonlocalheatequation_tpu.cli import common as jcommon
from tests.cases import CASES_1D, CASES_2D
from tests.test_oracle_3d import CASES_3D

torch.set_num_threads(1)

CPU = ["--platform", "cpu", "--x64", "1"]
QUARANTINE_ROWS = [(40, 40, 20, 3, 0.2, 0.001, 0.02), (40, 40, 20, 3, 0.2, 0.001, 0.02),
                   (50, 50, 20, 5, 1.0, 0.0005, 0.02)]


def _batch(rows) -> str:
    return f"{len(rows)}\n" + "".join(" ".join(map(str, r)) + "\n" for r in rows)


def _run(monkeypatch, capsys, main, argv, rows):
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch(rows)))
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("main,rows", [(solve1d.main, CASES_1D), (solve2d.main, CASES_2D),
                                       (solve3d.main, CASES_3D)],
                         ids=["solve1d", "solve2d", "solve3d"])
def test_serve_passes_the_case_tables(monkeypatch, capsys, main, rows):
    rc, out, err = _run(monkeypatch, capsys, main, ["--test_batch", "--serve", "2", *CPU], rows)
    assert rc == 0, err
    assert out.splitlines()[-1] == "Tests Passed"
    m = json.loads([ln for ln in err.splitlines() if ln.startswith("{")][-1])
    assert m["cases"] == len(rows) and m["depth"] == 2
    res = m["resilience"]
    assert (res["retries"], res["faults"], res["fallback_chunks"]) == (0, {}, 0)


def test_serve_quarantines_the_poison_case(monkeypatch, capsys):
    monkeypatch.setenv("NLHEAT_FAULT_PLAN", "nan@c1x*")
    rc, out, err = _run(monkeypatch, capsys, solve2d.main,
                        ["--test_batch", "--serve", "2", "--serve-retries", "1", *CPU],
                        QUARANTINE_ROWS)
    assert rc == 1 and out.splitlines()[-1] == "Tests Failed"
    assert "serve: case 1 QUARANTINED: case 1 quarantined" in err
    assert "classified 'corrupt'" in err
    m = json.loads([ln for ln in err.splitlines() if ln.startswith("{")][-1])
    assert [q["case"] for q in m["resilience"]["quarantined"]] == [1]


def test_serve_scores_fallback_served_cases_as_failed_on_the_card(monkeypatch, capsys):
    # with the engine on the card (set by hand here), a case the CPU fallback
    # served is not the card's result: the batch fails and stderr says why;
    # raise@0x3 opens the default threshold-3 breaker on case 0's first three
    # attempts, and its fourth is the fallback's
    class OnCard(server_mod.ServePipeline):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.on_card = True

    monkeypatch.setattr(server_mod, "ServePipeline", OnCard)
    monkeypatch.setenv("NLHEAT_FAULT_PLAN", "raise@0x3")
    rc, out, err = _run(monkeypatch, capsys, solve2d.main,
                        ["--test_batch", "--serve", "1", "--serve-window-ms", "0",
                         "--serve-retries", "3", *CPU],
                        QUARANTINE_ROWS)
    assert rc == 1 and out.splitlines()[-1] == "Tests Failed"
    for seq in range(len(QUARANTINE_ROWS)):
        assert (f"serve: case {seq} served by the CPU fallback while the engine is on the "
                "card: not the card's result") in err
    m = json.loads([ln for ln in err.splitlines() if ln.startswith("{")][-1])
    assert m["resilience"]["fallback_chunks"] >= 1 and m["resilience"]["quarantined"] == []


def test_serve_runs_the_batched_plain_versions(monkeypatch, capsys):
    # --method cuda on the CPU: the batched kernels' plain versions behind
    # the pipeline (B6 on the card); one bucket of mixed physics is one
    # chunk, as under --ensemble
    rows = [(50, 50, 45, 5, k, dt, 0.02) for k, dt in ((1.0, 5e-4), (0.5, 5e-4), (1.0, 4e-4))]
    base = ["--test_batch", "--method", "cuda", *CPU]
    rc, out, err = _run(monkeypatch, capsys, solve2d.main, [*base, "--serve", "1"], rows)
    assert rc == 0 and out.splitlines()[-1] == "Tests Passed"
    assert "serve: 3 cases -> 1 buckets, 1 dispatches" in err
    rc, out, err = _run(monkeypatch, capsys, solve2d.main, [*base, "--ensemble"], rows)
    assert rc == 0 and "ensemble: 3 cases -> 1 buckets, 1 dispatches" in err


def _ns(**kw):
    base = dict(serve=2, serve_window_ms=50.0, serve_retries=2, serve_deadline_ms=0.0,
                test_batch=True, ensemble=False, resync=0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kw,extra", [
    (dict(serve=-1), ()),
    (dict(serve_window_ms=-5.0), ()),
    (dict(serve_retries=-1), ()),
    (dict(serve_deadline_ms=-2.5), ()),
    (dict(test_batch=False), ()),
    (dict(ensemble=True), ()),
    (dict(resync=4), ()),
    (dict(), ((True, "--checkpoint/--resume cannot be combined with --serve"),)),
    (dict(), ()),
    (dict(serve=0, test_batch=False), ()),
])
def test_validate_serve_args_gives_the_jax_words(kw, extra):
    ours = common.validate_serve_args(_ns(**kw), list(extra))
    assert ours == jcommon.validate_serve_args(_ns(**kw), list(extra))
    assert (ours is None) == (kw in ({}, dict(serve=0, test_batch=False)) and not extra)


@pytest.mark.parametrize("case", ["port", "dir", "unwritable", "trace-profile", "env-trace",
                                  "ok", "none"])
def test_validate_obs_args_gives_the_jax_words(case, tmp_path, monkeypatch):
    kw = dict(trace=None, metrics_out=None, metrics_port=None, profile=None)
    if case == "port":
        kw["metrics_port"] = 70000
    elif case == "dir":
        kw["metrics_out"] = str(tmp_path)
    elif case == "unwritable":
        kw["metrics_out"] = str(tmp_path / "missing" / "m.json")
    elif case == "trace-profile":
        kw.update(trace=str(tmp_path / "t"), profile=str(tmp_path / "p"))
    elif case == "env-trace":
        monkeypatch.setenv("NLHEAT_TRACE", str(tmp_path / "t"))
        kw["profile"] = str(tmp_path / "p")
    elif case == "ok":
        kw.update(metrics_port=0, metrics_out=str(tmp_path / "m.json"), trace=str(tmp_path))
    ours = common.validate_obs_args(argparse.Namespace(**kw))
    assert ours == jcommon.validate_obs_args(argparse.Namespace(**kw))
    assert (ours is None) == (case in ("ok", "none"))


def test_cli_refusals_print_the_jax_words(monkeypatch, capsys, tmp_path):
    for main, argv, want in (
        (solve2d.main, ["--serve", "2"], "--serve streams batch-test cases; it requires "
                                         "--test_batch"),
        (solve1d.main, ["--test_batch", "--serve", "2", "--ensemble"],
         "--serve already schedules through the ensemble engine (overlapped); drop "
         "--ensemble"),
        (solve3d.main, ["--test_batch", "--serve", "2", "--distributed"],
         "--serve runs the serial batched engine; it cannot be combined with "
         "--distributed"),
        (solve2d.main, ["--test_batch", "--metrics-port", "-1"],
         "--metrics-port must be in [0, 65535] (got -1)"),
        (solve1d.main, ["--test", "--trace", str(tmp_path), "--profile", str(tmp_path)],
         "--trace already captures the jax.profiler device timeline"),
    ):
        assert main([*argv, *CPU]) == 1
        assert want in capsys.readouterr().err, argv


@pytest.mark.parametrize("main,argv", [
    (solve1d.main, ["--test", "--nx", "8", "--nt", "2", "--eps", "2"]),
    (solve2d.main, ["--test_batch"]),
    (solve3d.main, ["--test", "--nx", "4", "--ny", "4", "--nz", "4", "--nt", "2", "--eps",
                    "1"]),
    (solve_unstructured.main, ["--mesh", "data/10x10.msh", "--test", "--nt", "2"]),
], ids=["solve1d", "solve2d", "solve3d", "solve_unstructured"])
def test_flight_dir_is_refused_by_name(main, argv, monkeypatch, capsys, tmp_path):
    # ported since: --flight-dir arms the flight recorder for the session
    # (obs/flightrec.py) and restores the previous recorder on exit
    from nonlocalheatequation_torch.obs import flightrec

    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch(CASES_2D[:1])))
    box = tmp_path / "box"
    assert main([*argv, "--platform", "cpu", "--flight-dir", str(box)]) == 0
    assert "flight-dir" not in capsys.readouterr().err
    assert box.is_dir() and flightrec.get_recorder() is None


def test_metrics_out_writes_the_pipeline_metrics_line(monkeypatch, capsys, tmp_path):
    path = tmp_path / "m.json"
    rc, out, err = _run(monkeypatch, capsys, solve2d.main,
                        ["--test_batch", "--serve", "2", "--metrics-out", str(path), *CPU],
                        CASES_2D[:2])
    assert rc == 0 and f"metrics written to {path}" in err
    text = path.read_text()
    assert text.endswith("\n") and text.count("\n") == 1
    m = json.loads(text)
    assert m["cases"] == 2 and m["resilience"]["breaker"]["state"] == "closed"
    # the same line the driver printed on stderr
    assert text.strip() in err.splitlines()


def test_trace_writes_host_spans_beside_the_profiler_trace(monkeypatch, capsys, tmp_path):
    rc, out, err = _run(monkeypatch, capsys, solve2d.main,
                        ["--test_batch", "--serve", "2", "--trace", str(tmp_path), *CPU],
                        CASES_2D[:2])
    assert rc == 0, err
    doc = json.loads((tmp_path / "host_trace.json").read_text())
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("serve.dispatch") >= 1 and "serve.fetch" in names
    assert "ensemble.build" in names
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))


def test_metrics_port_serves_the_live_pipeline(monkeypatch, capsys):
    from nonlocalheatequation_torch.obs import export

    servers, scraped = [], []
    real_serve, real_drain = export.serve_metrics, server_mod.ServePipeline.drain

    def serve(port, registry):
        servers.append(real_serve(port, registry))
        return servers[-1]

    def drain(pipe):
        # mid-run: the endpoint follows the live pipeline's registry
        base = f"http://127.0.0.1:{servers[0].port}"
        scraped.append(urllib.request.urlopen(f"{base}/metrics", timeout=30).read().decode())
        real_drain(pipe)

    monkeypatch.setattr(export, "serve_metrics", serve)
    monkeypatch.setattr(server_mod.ServePipeline, "drain", drain)
    rc, out, err = _run(monkeypatch, capsys, solve2d.main,
                        ["--test_batch", "--serve", "2", "--metrics-port", "0", *CPU],
                        CASES_2D[:2])
    assert rc == 0 and f"metrics: http://127.0.0.1:{servers[0].port}/metrics" in err
    assert scraped and "nlheat_ensemble_cases 2" in scraped[0]
    assert "nlheat_serve_depth 2" in scraped[0]


@pytest.mark.parametrize("main,argv,tag", [
    (solve1d.main, ["--test", "--nx", "8", "--nt", "2", "--eps", "2"], "1d"),
    (solve3d.main, ["--test", "--nx", "4", "--ny", "4", "--nz", "4", "--nt", "2", "--eps",
                    "1"], "3d"),
    (solve_unstructured.main, ["--mesh", "data/10x10.msh", "--test", "--nt", "2"],
     "unstructured"),
], ids=["solve1d", "solve3d", "solve_unstructured"])
def test_single_solve_metrics_out_and_trace(main, argv, tag, capsys, tmp_path):
    # a single solve's payload is the registry snapshot with its
    # /solve{tag}/* gauges; --trace writes the host trace file
    path = tmp_path / "m.json"
    assert main([*argv, "--platform", "cpu", "--metrics-out", str(path), "--trace",
                 str(tmp_path / "t")]) == 0
    snap = json.loads(path.read_text())
    assert snap[f"/solve{{{tag}}}/steps"] == 2 and f"/solve{{{tag}}}/error-l2" in snap
    assert (tmp_path / "t" / "host_trace.json").exists()
    capsys.readouterr()


def test_run_batch_refuses_to_stream_under_several_ranks():
    with pytest.raises(SystemExit, match="cannot verify rank-identical input"):
        common.run_batch(None, None, 7, multi=True, run_serve=lambda it: [])
