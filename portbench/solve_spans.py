"""The solo solve's own spans and counters, as a traced window holds them.

The port marks the host's steps of a solve (``GridSolver``,
nonlocalheatequation_torch/models/solver2d.py) with spans that a
``torch.profiler`` capture records as ``nlheat.solve.upload``,
``nlheat.solve.program`` and ``nlheat.solve.fetch`` ranges (``devtrace.parse``
files them with the host's events in ``Trace.host``), and counts
``/solver/solves`` and the bytes each copy moves in its
``obs.metrics.REGISTRY``.  The functions below turn them into figures per
solve over the harness's ``solve`` spans in the window.  A program without
those spans or counters gives None, never an error.
"""

from __future__ import annotations

import numpy as np

PREFIX = "nlheat.solve."
#: the copies' names in the profiler's record, by direction
COPIES = {"h2d": "Memcpy HtoD", "d2h": "Memcpy DtoH"}


def solves(trace) -> list:
    """The harness's ``solve`` spans that lie in the window, as (start, end)."""
    w0, w1 = trace.window
    return [(s, e) for s, e in trace.spans.get("solve", []) if w0 <= s and e <= w1]


def ranges(trace, step: str) -> list:
    """The ``nlheat.solve.<step>`` ranges that lie in the window."""
    w0, w1 = trace.window
    name = PREFIX + step
    return [(s, e) for n, s, e in trace.host if n == name and w0 <= s and e <= w1]


def traced_solves(run) -> int:
    """The traced window's solves, 0 without a trace, another entry than
    ``solve``, or a program that marks none of its steps."""
    trace = run.trace
    if trace is None or run.entry != "solve":
        return 0
    if not any(n.startswith(PREFIX) for n, _, _ in trace.host):
        return 0
    return len(solves(trace))


def mean_ms(run, step: str, none_read=None) -> float | None:
    """The summed duration of the window's ``step`` ranges over its solves,
    in ms; ``none_read`` where the program marks its solves but made no
    such range."""
    n = traced_solves(run)
    if not n:
        return None
    found = ranges(run.trace, step)
    if not found:
        return none_read
    return sum(e - s for s, e in found) / n / 1e6


def fetch_tail_ms(run) -> float | None:
    """For each fetch range, the part after the last kernel that ended
    inside it (all of it where none did): the copy back and the host's own
    work, without the wait for the loop; summed over the window's solves,
    in ms a solve."""
    n = traced_solves(run)
    found = ranges(run.trace, "fetch") if n else []
    if not found:
        return None
    ends = np.sort(np.array([e for _, k, _, e in run.trace.device if k == "kernel"],
                            dtype=np.int64))
    total = 0
    for s, e in found:
        i = int(np.searchsorted(ends, e, side="right"))
        last = int(ends[i - 1]) if i and ends[i - 1] >= s else s
        total += e - last
    return total / n / 1e6


def bytes_per_solve(direction: str) -> float | None:
    """The bytes a solve moved ``direction`` (h2d or d2h), from the
    program's counters over every solve of this process; None where the
    program has no such counter or made no solve."""
    from nonlocalheatequation_torch.obs.metrics import REGISTRY

    made, moved = REGISTRY.get("/solver/solves"), REGISTRY.get(f"/solver/{direction}-bytes")
    if made is None or moved is None or not made.value:
        return None
    return moved.value / made.value


def copy_gbps(run, direction: str) -> float | None:
    """A solve's bytes ``direction`` times the traced solves, over the
    device time of the window's copies that way, in GB/s."""
    n = traced_solves(run)
    per_solve = bytes_per_solve(direction) if n else None
    if not per_solve:
        return None
    w0, w1 = run.trace.window
    ns = sum(min(e, w1) - max(s, w0) for name, k, s, e in run.trace.device
             if k == "memcpy" and name.startswith(COPIES[direction]) and e > w0 and s < w1)
    if ns <= 0:
        return None
    return per_solve * n / ns
