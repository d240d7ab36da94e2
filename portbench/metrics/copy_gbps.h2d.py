"""``copy_gbps.h2d`` (GB/s): the state's host-to-card copy: a solve's bytes
by the port's counters (``/solver/h2d-bytes`` over ``/solver/solves``)
times the traced solves, over the device time of the window's ``Memcpy
HtoD`` copies."""

from portbench import solve_spans


def read(run):
    return solve_spans.copy_gbps(run, "h2d")
