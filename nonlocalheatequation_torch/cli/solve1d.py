"""1D solver CLI — the batch-test and single-solve surface of the reference's
1d_nonlocal_serial binary (src/1d_nonlocal_serial.cpp:313-344), on the port.

    echo "1
    50 45 5 1 0.001 0.02" | python -m nonlocalheatequation_torch.cli.solve1d --test_batch
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nonlocalheatequation_torch.cli.common import (
    add_ensemble_flag,
    add_platform_flags,
    add_precision_flags,
    announce_stable_dt,
    bool_flag,
    ensemble_refusal,
    ensemble_runner,
    platform_kwargs,
    precision_kwargs,
    run_batch,
    version_banner,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="1d_nonlocal", add_help=True)
    p.add_argument("--test", action="store_true",
                   help="use the manufactured solution for testing")
    p.add_argument("--test_batch", action="store_true", help="run batch tests from stdin")
    p.add_argument("--results", action="store_true", help="print the final state")
    bool_flag(p, "cmp", True, "print expected vs actual outputs")
    p.add_argument("--nx", type=int, default=50)
    p.add_argument("--nt", type=int, default=45)
    p.add_argument("--eps", type=int, default=5)
    p.add_argument("--k", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=0.001)
    p.add_argument("--dx", type=float, default=0.02)
    add_platform_flags(p)
    add_precision_flags(p)
    add_ensemble_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    err = ensemble_refusal(args)
    if err:
        print(err, file=sys.stderr)
        return 1
    version_banner("1d_nonlocal")
    if not args.test_batch:
        announce_stable_dt(1, args.k, args.eps, args.dx, args.dt)
    from nonlocalheatequation_torch.models.solver1d import Solver1D

    try:
        kw = {**platform_kwargs(args), **precision_kwargs(args)}
    except RuntimeError as e:  # no card for --platform gpu
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.test_batch:
        # row: nx nt eps k dt dx  (tests/1d.txt)
        def read_case(toks, pos):
            v = toks[pos:pos + 6]
            return ((int(v[0]), int(v[1]), int(v[2]),
                     float(v[3]), float(v[4]), float(v[5])), pos + 6)

        def make_solver(case):
            nx, nt, eps, k, dt, dx = case
            return Solver1D(nx, nt, eps, k=k, dt=dt, dx=dx, **kw)

        def run_case(case):
            s = make_solver(case)
            s.test_init()
            s.do_work()
            return s.error_l2, s.nx

        run_ensemble = None
        if args.ensemble:
            run_ensemble = ensemble_runner(make_solver, precision=args.precision,
                                           device=kw["device"], dtype=kw["dtype"])
        return run_batch(read_case, run_case, row_tokens=6, run_ensemble=run_ensemble)

    s = Solver1D(args.nx, args.nt, args.eps, k=args.k, dt=args.dt,
                 dx=args.dx, **kw)
    if args.test:
        s.test_init()
    else:
        s.input_init(np.array(sys.stdin.read().split(), dtype=np.float64)[: args.nx])
    t0 = time.perf_counter()
    u = s.do_work()
    elapsed = time.perf_counter() - t0
    if args.test:
        s.print_error(args.cmp)
    if args.results:
        for sx in range(args.nx):
            print(f"S[{sx}] = {u[sx]:g}")

    from nonlocalheatequation_torch.utils.timing import print_time_results_1d

    print_time_results_1d(os.cpu_count() or 1, elapsed, args.nx, args.nt)
    return 0


if __name__ == "__main__":
    sys.exit(main())
