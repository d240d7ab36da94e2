"""``copy_gbps.d2h`` (GB/s): the state's card-to-host copy: a solve's bytes
by the port's counters (``/solver/d2h-bytes`` over ``/solver/solves``)
times the traced solves, over the device time of the window's ``Memcpy
DtoH`` copies."""

from portbench import solve_spans


def read(run):
    return solve_spans.copy_gbps(run, "d2h")
