"""``solve_fetch_ms`` (ms): the port's ``solve.fetch`` span a traced solve,
less its wait for the loop: the part of each ``nlheat.solve.fetch`` range
after the last kernel that ended inside it (the copy back and the host's
own work), over the harness's ``solve`` spans in the window."""

from portbench import solve_spans


def read(run):
    return solve_spans.fetch_tail_ms(run)
