"""One run of one cell: set-up, the measured window, the output check and
the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* its configuration's file (``configs/<config>.json``), whose ``kind``
  names the module that makes its inputs and calls the port
  (``kinds/<kind>.py``) and, through it, its plain reference
  (``reference/<kind>.py``);
* its traffic mix (``traffic/<traffic>.json``): the entry (``solve``, one
  client calling the solver in a closed loop), the number of seeded
  inputs, the share of answers checked, and how much of the window
  ``--trace 1`` records;
* the limits of its output check (``limits/<workload>.json``);
* one reader a metric (``metrics/<metric>.py``, a function ``read(run)``
  that returns a number, or None when it finds nothing to read).

A run makes its inputs from the seed, warms up every shape the traffic
uses (all of it set-up), measures for the window, then, with the program's
state freed, checks a seeded sample of the answers against the reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import devtrace, yardstick

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: the tuner's records: a fixed file inside the checkout, so that only a
#: checkout's first run of a cell tunes (the libraries go to the package's
#: own _build/, ops/_build.py)
TUNER_RECORDS = BENCH / ".cache" / "autotune_torch.json"
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "nonlocalheatequation_tpu")
#: solves run before the window
WARMUP = 2


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of BENCHMARK.json with the files it names."""

    name: str
    spec: dict  # the workload's entry in BENCHMARK.json
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, workload: str, root: Path = ROOT, overrides: dict | None = None) -> "Cell":
        spec = read_json(root / "BENCHMARK.json")
        cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
        if cell is None:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        bench = root / "portbench"
        cfg = next(c for c in spec["configs"] if c["name"] == cell["config"])
        config = read_json(root / cfg["file"])
        traffic = read_json(bench / "traffic" / f"{cell['traffic']}.json")
        limits = read_json(bench / "limits" / f"{workload}.json")
        overrides = overrides or {}
        config.update(overrides.get("config", {}))
        traffic.update(overrides.get("traffic", {}))

        def listed(m):
            return "workloads" not in m or workload in m["workloads"]

        return cls(workload, cell, config, traffic, limits,
                   [m for m in spec["end_to_end"] if listed(m)],
                   [m for m in spec["per_layer"] if listed(m)])


def reader(name: str):
    """``read`` of ``metrics/<name>.py`` (names may hold dots)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def prepare_environment() -> None:
    """The program's knobs as the deployment runs it: none of an ambient
    shell's ``NLHEAT_*`` settings, and the tuner's records in the checkout."""
    for key in [k for k in os.environ if k.startswith("NLHEAT_")]:
        del os.environ[key]
    TUNER_RECORDS.parent.mkdir(parents=True, exist_ok=True)
    os.environ["NLHEAT_AUTOTUNE_CACHE"] = str(TUNER_RECORDS)


class Sampler:
    """Which answers the check compares: each with probability ``share``,
    drawn from the seed in the order they complete."""

    def __init__(self, seed: int, share: float):
        self._rng = np.random.default_rng([seed, 0x5EED])
        self.share = share

    def __call__(self) -> bool:
        return bool(self._rng.random() < self.share)


@dataclass
class Window:
    """What the measured window saw."""

    t_open: float = 0.0
    t_close: float = 0.0
    latencies: list = field(default_factory=list)  # seconds, every completed solve
    attempted: int = 0
    failed: int = 0
    kept: list = field(default_factory=list)  # (input id, answer) to check
    traced: int = 0  # solves completed inside the traced part
    trace: devtrace.Trace | None = None

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open


def drive_solve(problem, seconds: float, rec: devtrace.Recorder, trace_seconds: float,
                keep: Sampler) -> Window:
    """One client calling the solo entry back to back for ``seconds``; input
    i of the pool for the i-th solve (cycling).  ``rec``, when started, is
    stopped after the first solve that ends ``trace_seconds`` into the
    window."""
    win, clock, n_inputs = Window(), time.perf_counter, len(problem.inputs)
    win.t_open = clock()
    last = None
    while True:
        iid = win.attempted % n_inputs
        win.attempted += 1
        t0 = clock()
        with rec.span("solve"):
            out = problem.solve(iid)
        t1 = clock()
        win.latencies.append(t1 - t0)
        if keep():
            win.kept.append((iid, out))
        last = (iid, out)
        if rec.active and t1 - win.t_open >= trace_seconds:
            rec.stop()
            win.traced = win.attempted
        if t1 - win.t_open >= seconds:
            break
    win.t_close = t1
    win.kept.append(last)
    return win


@dataclass
class RunView:
    """What a metric's reader sees of a run."""

    cell: Cell
    setup_s: float
    window: Window
    points: int  # a solve's points (nodes)
    steps: int  # a solve's steps
    step_bytes: int  # the least bytes a step needs
    bandwidth: float | None = None  # the card's peak, bytes a second
    merged: np.ndarray | None = None  # the traced window's device busy intervals

    @property
    def entry(self) -> str:
        return self.cell.traffic["entry"]

    @property
    def trace(self) -> devtrace.Trace | None:
        return self.window.trace

    @property
    def steps_traced(self) -> int:
        return self.window.traced * self.steps

    @property
    def untraced(self) -> list:
        """The latencies (seconds) of the solves made after the profiler
        stopped: the traced run's own measure free of the profiler's cost
        (empty in a run with no trace, or one traced to its end)."""
        return self.window.latencies[self.window.traced:] if self.trace is not None else []


def check(problem, kept: list, limits: dict, failed: int) -> tuple:
    """Compare every kept answer with the reference's, run once an input:
    the largest gap over the field, as a share of the reference's largest
    value.  Returns (correct, {name: {"value", "limit"}})."""
    import torch

    refs = problem.reference([iid for iid, _ in kept])
    worst = 0.0
    for iid, out in kept:
        want = refs[iid]
        got = torch.as_tensor(np.asarray(out)).to(want.device, torch.float64)
        gap = float((got - want.to(torch.float64)).abs().max() / want.abs().max())
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    checks = {"failed": {"value": failed, "limit": 0},
              "checked": {"value": len(kept), "limit": 1},
              "rel_err": {"value": worst, "limit": limits["rel_err"]}}
    correct = failed == 0 and len(kept) >= 1 and worst <= limits["rel_err"]
    return correct, checks


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
        device: str = "cuda", control: bool = False, overrides: dict | None = None,
        root: Path = ROOT) -> dict:
    """One run; returns the result line's object (``correct`` False where
    the check fails).  ``control`` puts the program's lower-precision path
    in place of the timed path; ``overrides`` replace keys of the configuration and
    the traffic (the tests' small sizes)."""
    import torch

    stamps = [("imports", time.time())]
    cell = Cell.load(workload, root, overrides)
    prepare_environment()
    kind = importlib.import_module(f"portbench.kinds.{cell.config['kind']}")
    torch.zeros(1, device=device)
    stamps.append(("device", time.time()))
    problem = kind.make(cell.config, cell.traffic, seed, device, control)
    stamps.append(("inputs", time.time()))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    traffic = cell.traffic
    keep = Sampler(seed, float(traffic["check_share"]))
    if traffic["entry"] != "solve":
        raise ValueError(f"traffic entry {traffic['entry']!r}: solve")
    for _ in range(WARMUP):
        problem.solve(0)
    if on_card:
        torch.cuda.synchronize()
    rec = devtrace.Recorder()
    trace_seconds = min(float(traffic.get("trace_seconds") or seconds), seconds)
    stamps.append(("warmup", time.time()))
    if trace:
        rec.start()
    setup_s = time.time() - t_start
    t = t_start
    for phase, stamp in stamps:  # where set-up went, for PERF.md
        print(f"setup {phase} {stamp - t:.3f} s", file=sys.stderr)
        t = stamp
    win = drive_solve(problem, seconds, rec, trace_seconds, keep)
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
    view = RunView(cell, setup_s, win, problem.points, problem.steps, problem.step_bytes)
    if trace:
        win.trace = rec.trace()
        view.merged = devtrace.merged_busy(win.trace)
        view.bandwidth = yardstick.peak_bandwidth(name) if on_card else None
        dev.update(busy_s=devtrace.busy_ns(view.merged) / 1e9,
                   window_s=win.trace.window_s, power_limit_w=power_limit_w())
        traced = win.latencies[:win.traced]
        if traced and view.untraced:  # the profiler's cost, for PERF.md
            print(f"trace cost: a solve {1e3 * np.mean(traced):.3f} ms traced, "
                  f"{1e3 * np.mean(view.untraced):.3f} ms untraced", file=sys.stderr)
    problem.close()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    correct, checks = check(problem, win.kept, cell.limits, win.failed)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": win.attempted, "failed": win.failed,
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = devtrace.breakdown(win.trace)
    result["checks"] = checks
    return result
