"""``solve_host_ms`` (ms): the host's share of a solo solve: the mean wall
time of the solves made after the profiler stopped (the run's untraced
part), less the card's mean busy time inside a traced solve (the harness's
``solve`` spans around ``input_init`` + ``do_work``).  The wall comes from
the untraced part so that the profiler's own cost a launch stays out."""

import numpy as np

from portbench import devtrace


def read(run):
    trace = run.trace
    if trace is None or run.entry != "solve" or not len(run.merged) or not run.untraced:
        return None
    w0, w1 = trace.window
    spans = [(s, e) for s, e in trace.spans.get("solve", []) if w0 <= s and e <= w1]
    if not spans:
        return None
    start, end = zip(*spans, strict=True)
    busy = devtrace.busy_before(run.merged, end) - devtrace.busy_before(run.merged, start)
    return float(np.mean(run.untraced)) * 1e3 - float(busy.mean()) / 1e6
