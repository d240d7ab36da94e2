"""Wall-clock timing reports in the reference's CSV layouts
(include/print_time_results.hpp:19-97): distributed, async, 2D and 1D, and
the JAX package's 3D extension.  ``elapsed_s`` is in seconds; ``header``
prints the column line first (the CLIs' ``--no-header`` drops it)."""

from __future__ import annotations


def print_time_results_async(num_os_threads: int, elapsed_s: float, nx: int, ny: int,
                             np_parts: int, nt: int, header: bool = True):
    """print_time_results.hpp:44-63."""
    if header:
        print("OS_Threads,Execution_Time_sec,"
              "       nx,    ny,     Partitions,Time_Steps")
    print(
        f"{num_os_threads},".ljust(22)
        + f"{elapsed_s:.14g}, "
        + f"{nx},".ljust(22)
        + f"{ny},".ljust(22)
        + f"{np_parts},".ljust(22)
        + f"{nt} ".ljust(22).rstrip(),
        flush=True,
    )


def print_time_results_2d(num_os_threads: int, elapsed_s: float, nx: int, ny: int,
                          nt: int, header: bool = True):
    """print_time_results.hpp:65-82."""
    if header:
        print("OS_Threads,       Execution_Time_sec,"
              "       x dimension,        y dimension,        Time_Steps")
    print(
        f"{num_os_threads},".ljust(22)
        + f"{elapsed_s:10.12g},        "
        + f"{nx},".ljust(22)
        + f"{ny},".ljust(22)
        + f"{nt} ".ljust(22).rstrip(),
        flush=True,
    )


def print_time_results_1d(num_os_threads: int, elapsed_s: float, nx: int, nt: int,
                          header: bool = True):
    """print_time_results.hpp:84-97."""
    if header:
        print("OS_Threads,       Execution_Time_sec,"
              "       x dimension,        y dimension,        Time_Steps")
    print(
        f"{num_os_threads},".ljust(22)
        + f"{elapsed_s:10.12g},        "
        + f"{nx},".ljust(22)
        + f"{nt} ".ljust(22).rstrip(),
        flush=True,
    )


def print_time_results_3d(num_os_threads: int, elapsed_s: float, nx: int, ny: int, nz: int,
                          nt: int, header: bool = True):
    """The JAX package's 3D extension of print_time_results.hpp:65-82."""
    if header:
        print("OS_Threads,       Execution_Time_sec,"
              "       x dimension,        y dimension,        z dimension,"
              "        Time_Steps")
    print(
        f"{num_os_threads},".ljust(22)
        + f"{elapsed_s:10.12g},        "
        + f"{nx},".ljust(22)
        + f"{ny},".ljust(22)
        + f"{nz},".ljust(22)
        + f"{nt} ".ljust(22).rstrip(),
        flush=True,
    )


def print_time_results_distributed(num_localities: int, num_os_threads: int, elapsed_s: float,
                                   nx: int, ny: int, npx: int, npy: int, nt: int,
                                   header: bool = True):
    """print_time_results.hpp:19-41."""
    if header:
        print("Localities,OS_Threads,Execution_Time_sec,"
              "       nx,    ny,     npx,    npy,    Time_Steps")
    print(
        f"{num_localities},".ljust(7)
        + f"{num_os_threads},".ljust(7)
        + f"{elapsed_s:.14g}, "
        + f"{nx},".ljust(22)
        + f"{ny},".ljust(22)
        + f"{npx},".ljust(22)
        + f"{npy},".ljust(22)
        + f"{nt} ".ljust(22).rstrip(),
        flush=True,
    )
