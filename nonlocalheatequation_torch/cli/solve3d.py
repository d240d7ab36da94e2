"""3D solver CLI — the batch-test and single-solve surface of
``nonlocalheatequation_tpu/cli/solve3d.py`` (no 3D binary exists in the
reference; the 2D serial CLI's surface with an added --nz), on the port.

    echo "1
    16 16 16 20 3 1 0.0005 0.0625" | python -m nonlocalheatequation_torch.cli.solve3d --test_batch

runs on the CUDA card (``--platform cpu`` for the CPU): rows
``nx ny nz nt eps k dt dh`` on stdin, "Tests Passed" when every row meets
error_l2/#points <= 1e-6; ``--ensemble`` runs the rows through the batched
ensemble engine.  The JAX CLI's distributed, checkpoint, serving, network
and profiling flags and ``--method fft`` are refused by name: they are not
ported yet.
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

#: the JAX CLI's flags that the port does not have yet -> what they select
NOT_PORTED = {
    "--distributed": "the distributed 3D solve",
    "--comm": "the distributed 3D solve's halo-exchange engine",
    "--superstep": "the distributed 3D solve's communication-avoiding schedule",
    "--checkpoint": "checkpointing",
    "--ncheckpoint": "checkpointing",
    "--resume": "checkpointing",
    "--profile": "profiling",
    "--serve": "the serving engine",
    "--listen": "the network front door",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="3d_nonlocal", add_help=True)
    p.add_argument("--test", action="store_true",
                   help="use the manufactured solution for testing")
    p.add_argument("--test_batch", action="store_true", help="run batch tests from stdin")
    bool_flag(p, "cmp", False, "print expected vs actual outputs")
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--nz", type=int, default=16)
    p.add_argument("--nt", type=int, default=20)
    p.add_argument("--nlog", type=int, default=5)
    p.add_argument("--eps", type=int, default=3)
    p.add_argument("--k", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=0.0005)
    p.add_argument("--dh", type=float, default=0.0625)
    p.add_argument("--no-header", action="store_true", dest="no_header")
    p.add_argument("--backend", default="torch", choices=("oracle", "torch"))
    p.add_argument("--method", default="auto", choices=("auto", "shift", "sat", "cuda", "fft"),
                   help="neighbour-sum evaluation: auto (cuda on the card, sat on the CPU), "
                        "cuda (the hand-written kernels), shift, sat; fft is not ported yet")
    add_platform_flags(p)
    add_precision_flags(p)
    add_ensemble_flag(p)
    return p


def _refusal(args, rest) -> str | None:
    """The message refusing a flag the port does not have yet, or None."""
    for tok in rest:
        name = tok.split("=")[0]
        what = NOT_PORTED.get(name) or next(
            (v for k, v in NOT_PORTED.items() if name.startswith(k + "-")), None)
        if what is not None:
            return f"{name} is not ported yet to nonlocalheatequation_torch ({what})"
    if args.method == "fft":
        return "--method fft is not ported yet to nonlocalheatequation_torch (the spectral tier)"
    return None


def main(argv=None) -> int:
    p = build_parser()
    args, rest = p.parse_known_args(argv)
    err = _refusal(args, rest) or ensemble_refusal(args)
    if err:
        print(err, file=sys.stderr)
        return 1
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    version_banner("3d_nonlocal")
    if not args.test_batch:
        announce_stable_dt(3, args.k, args.eps, args.dh, args.dt)
    from nonlocalheatequation_torch.models.solver3d import Solver3D

    try:
        kw = {"backend": args.backend, "method": args.method, "nlog": args.nlog,
              **platform_kwargs(args), **precision_kwargs(args)}
    except RuntimeError as e:  # no card for --platform gpu
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.test_batch:
        # row: nx ny nz nt eps k dt dh
        def read_case(toks, pos):
            v = toks[pos:pos + 8]
            return ((int(v[0]), int(v[1]), int(v[2]), int(v[3]), int(v[4]),
                     float(v[5]), float(v[6]), float(v[7])), pos + 8)

        def make_solver(case):
            nx, ny, nz, nt, eps, k, dt, dh = case
            return Solver3D(nx, ny, nz, nt, eps, k=k, dt=dt, dh=dh, **kw)

        def run_case(case):
            s = make_solver(case)
            s.test_init()
            s.do_work()
            return s.error_l2, s.nx * s.ny * s.nz

        run_ensemble = None
        if args.ensemble:
            run_ensemble = ensemble_runner(make_solver, method=args.method,
                                           precision=args.precision, device=kw["device"],
                                           dtype=kw["dtype"])
        return run_batch(read_case, run_case, row_tokens=8, run_ensemble=run_ensemble)

    s = Solver3D(args.nx, args.ny, args.nz, args.nt, args.eps, k=args.k, dt=args.dt,
                 dh=args.dh, **kw)
    if args.test:
        s.test_init()
    else:
        n = args.nx * args.ny * args.nz
        s.input_init(np.array(sys.stdin.read().split(), dtype=np.float64)[:n])
    t0 = time.perf_counter()
    s.do_work()
    elapsed = time.perf_counter() - t0
    if args.test:
        s.print_error(args.cmp)

    from nonlocalheatequation_torch.utils.timing import print_time_results_3d

    print_time_results_3d(os.cpu_count() or 1, elapsed, args.nx, args.ny, args.nz, args.nt,
                          header=not args.no_header)
    return 0


if __name__ == "__main__":
    sys.exit(main())
