"""``solve_upload_ms`` (ms): the port's ``solve.upload`` span a traced solve:
u0 converted to the solve's dtype on the host and copied to the card (the
summed ``nlheat.solve.upload`` ranges over the harness's ``solve`` spans in
the window)."""

from portbench import solve_spans


def read(run):
    return solve_spans.mean_ms(run, "upload")
