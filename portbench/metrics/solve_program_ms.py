"""``solve_program_ms`` (ms): the port's ``solve.program`` span a traced
solve: the multi-step program's making on its first call (the tuner's pick
through ``solo_pick``).  It reads 0 where the program marks its solves and
made no program inside the window."""

from portbench import solve_spans


def read(run):
    return solve_spans.mean_ms(run, "program", none_read=0.0)
