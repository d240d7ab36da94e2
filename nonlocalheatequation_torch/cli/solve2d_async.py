"""2D pipelined-solver CLI — the flag surface of the reference's
2d_nonlocal_async binary (src/2d_nonlocal_async.cpp:544-580) and of
``nonlocalheatequation_tpu/cli/solve2d_async.py``, on the port.

    echo "1
    25 25 2 45 5 1 0.0005 0.02" | python -m nonlocalheatequation_torch.cli.solve2d_async --test_batch

The reference tiles the global (nx*np) x (ny*np) grid into np x np
partitions and throttles its task pipeline with a sliding semaphore of
depth nd; here the global grid runs on ``Solver2D(..., nd=nd)``: one step
launched at a time, at most nd of them in flight on the card
(models/solver2d.py).  Runs on the CUDA card (``--platform cpu`` for the
CPU); rows ``nx ny np nt eps k dt dh`` on stdin, "Tests Passed" when every
row meets error_l2/#points <= 1e-6.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nonlocalheatequation_torch.cli.common import (
    add_platform_flags,
    add_precision_flags,
    bool_flag,
    platform_kwargs,
    precision_kwargs,
    run_batch,
    version_banner,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="2d_nonlocal_async", add_help=True)
    bool_flag(p, "test", True, "compare against the manufactured solution")
    p.add_argument("--test_batch", action="store_true", help="run batch tests from stdin")
    p.add_argument("--results", action="store_true", help="print the final state")
    bool_flag(p, "cmp", False, "print expected vs actual outputs")
    p.add_argument("--nx", type=int, default=25, help="tile x size")
    p.add_argument("--ny", type=int, default=25, help="tile y size")
    p.add_argument("--nt", type=int, default=45)
    p.add_argument("--nd", type=int, default=5,
                   help="steps in flight at most (the sliding semaphore's depth)")
    p.add_argument("--np", type=int, default=2, dest="np_parts",
                   help="partitions per dimension")
    p.add_argument("--nlog", type=int, default=5)
    p.add_argument("--eps", type=int, default=5)
    p.add_argument("--k", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=0.0005)
    p.add_argument("--dh", type=float, default=0.02)
    p.add_argument("--no-header", action="store_true", dest="no_header")
    p.add_argument("--method", default="auto",
                   choices=("auto", "cuda", "conv", "shift", "sat"),
                   help="neighbour-sum evaluation: auto (cuda on the card, conv on "
                        "the CPU), cuda (the hand-written kernels), conv, shift, sat")
    p.add_argument("--log", action="store_true",
                   help="write csv/vtu logs every nlog steps")
    add_platform_flags(p)
    add_precision_flags(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    version_banner("2d_nonlocal_async")
    from nonlocalheatequation_torch.models.solver2d import Solver2D

    try:
        kw = {"method": args.method, "nlog": args.nlog, "nd": args.nd,
              **platform_kwargs(args), **precision_kwargs(args)}
    except RuntimeError as e:  # no card for --platform gpu
        print(f"error: {e}", file=sys.stderr)
        return 2

    def make_solver(nx, ny, np_parts, nt, eps, k, dt, dh):
        return Solver2D(nx * np_parts, ny * np_parts, nt, eps, k=k, dt=dt, dh=dh, **kw)

    if args.test_batch:
        # row: nx ny np nt eps k dt dh  (tests/2d_async.txt)
        def read_case(toks, pos):
            v = toks[pos:pos + 8]
            return ((int(v[0]), int(v[1]), int(v[2]), int(v[3]), int(v[4]),
                     float(v[5]), float(v[6]), float(v[7])), pos + 8)

        def run_case(case):
            s = make_solver(*case)
            s.test_init()
            s.do_work()
            return s.error_l2, s.nx * s.ny

        return run_batch(read_case, run_case, row_tokens=8)

    s = make_solver(args.nx, args.ny, args.np_parts, args.nt, args.eps, args.k, args.dt,
                    args.dh)
    if args.log:
        from nonlocalheatequation_torch.utils.csvlog import SimulationCsvLogger

        s.logger = SimulationCsvLogger(s.op, test=args.test, tag="2d", nlog=args.nlog)
    if args.test:
        s.test_init()
    else:
        n = s.nx * s.ny
        s.input_init(np.array(sys.stdin.read().split(), dtype=np.float64)[:n])
    t0 = time.perf_counter()
    s.do_work()
    elapsed = time.perf_counter() - t0
    if args.test:
        s.print_error(args.cmp)
    if args.results:
        s.print_soln()

    from nonlocalheatequation_torch.utils.timing import print_time_results_async

    print_time_results_async(os.cpu_count() or 1, elapsed, args.nx, args.ny, args.np_parts,
                             args.nt, header=not args.no_header)
    return 0


if __name__ == "__main__":
    sys.exit(main())
