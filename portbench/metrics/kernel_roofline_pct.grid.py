"""``kernel_roofline_pct.grid`` (%): the solo 2D kernels' share of their byte
roofline: the traced solves' steps times the least bytes a step needs
(yardstick.least_step_bytes), over the peak bandwidth, against the device
time of every kernel in the traced window."""

from portbench import devtrace, yardstick

KERNELS = ("step2d", "carried2d", "superstep2d", "resident2d")


def read(run):
    trace = run.trace
    if trace is None or run.entry != "solve" or not devtrace.has_kernel(trace, KERNELS):
        return None
    return yardstick.roofline_pct(run.steps_traced, run.step_bytes,
                                  devtrace.kernel_seconds(trace), run.bandwidth)
