"""``setup_s`` (s): from the process's start to the measured window's: torch
and CUDA, the kernels' libraries, the tuner's records, the inputs from the
seed, the program's set-up and the warm-up of every shape the traffic uses."""


def read(run):
    return run.setup_s
