"""``throughput`` (Mpoint-steps/s): the points times steps of every solve
completed in the measured window, over the window's seconds."""


def read(run):
    win = run.window
    if not win.latencies or win.seconds <= 0:
        return None
    return len(win.latencies) * run.points * run.steps / win.seconds / 1e6
