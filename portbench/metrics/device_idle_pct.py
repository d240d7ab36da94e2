"""``device_idle_pct`` (%): 100 x the share of the traced window in which no
kernel, copy or fill ran on the card (the profiler's timeline).  The
profiler's own cost on the host lengthens the traced window; ``run.py``
prints a request's traced and untraced wall on standard error."""

from portbench import devtrace


def read(run):
    trace = run.trace
    if trace is None or not len(run.merged) or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_ns(run.merged) / 1e9 / trace.window_s)
