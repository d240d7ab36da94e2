"""Distributed 2D solver CLI — the reference's fourth binary,
2d_nonlocal_distributed (src/2d_nonlocal_distributed.cpp:1415-1458), on the
port's uniform SPMD path (parallel/distributed2d.py) or its elastic executor
(parallel/elastic.py).

    echo "1
    25 25 2 2 45 5 1 0.0005 0.02" | \\
        python -m nonlocalheatequation_torch.cli.solve2d_distributed --test_batch

runs on the CUDA card (``--platform cpu`` for the CPU): rows
``nx ny npx npy nt eps k dt dh`` on stdin (tests/2d_distributed.txt), "Tests
Passed" when every row meets error_l2/#points <= 1e-6.  The defaults are the
reference's: ``--test`` true, nx=ny=25, npx=npy=2, dh=0.05.  The mesh is the
largest whose shape divides the global grid, over ``--devices N`` devices
(0: every device of the platform; more than there are: virtual devices, one
device named again in turn, parallel/mesh.py).  ``--comm fused`` runs the
halo kernels (ops/cuda_halo.py: on cards, the halo read inside the kernel)
and needs ``--method cuda``.

A partition map (``--file``, the decomposition tool's output,
cli/decompose.py), ``--nbalance N`` or ``--test_load_balance`` select the
elastic executor, as in the JAX CLI: the map sets nx, ny, npx, npy and dh and
places each tile on its owner's device (owners beyond the device count are
folded onto the devices, with a warning); ``--nbalance`` rebalances every N
steps on measured busy rates; ``--test_load_balance`` measures every step
and prints the reference's balance report after the run.

Launched as ``srun -n N`` ranks (or with ``COORDINATOR_ADDRESS``,
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID`` set in each rank's environment,
parallel/multihost.py), every rank runs this same CLI over the blocks it
owns; ``--devices N`` counts each rank's own devices, rank 0 alone prints
and writes, a batch's stdin must be the same on every rank, and the elastic
executor's flags are refused in the JAX words.

A single solve takes ``--log`` (CSV/VTU logs of the global state every
``--nlog`` steps, written by rank 0),
``--checkpoint``/``--ncheckpoint``/``--resume`` (the global state, which
``solve2d`` resumes too) and ``--profile DIR``, as the JAX CLI does.

``--stepper rkc`` (``--superstep-stages S``, 8 by default) runs the stage loop
above the exchange on the SPMD path (parallel/stepper_halo.py; with
``--superstep K`` stage batches of K); ``--method fft`` the sharded spectral
tier (the pencil transposes), which also takes ``--stepper expo``.  A single
solve past the rkc bound exits 2 with the bound in force.  Refused in the JAX
words (rc 1): rkc, expo and fft under the elastic executor, fft with
``--comm fused`` or ``--superstep``, expo without ``--method fft``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nonlocalheatequation_torch.cli.common import (
    add_checkpoint_flags,
    add_platform_flags,
    add_precision_flags,
    add_profile_flag,
    add_stepper_flags,
    announce_stable_dt,
    bool_flag,
    check_same_input_state,
    checkpoint_refusal,
    cli_startup,
    guard_multihost_stdin,
    run_batch,
    stepper_kwargs,
    validate_stepper_args,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="2d_nonlocal_distributed", add_help=True)
    bool_flag(p, "test", True, "compare against the manufactured solution")
    p.add_argument("--test_batch", action="store_true", help="run batch tests from stdin")
    p.add_argument("--test_load_balance", action="store_true",
                   help="report the balance acceptance check after the run")
    p.add_argument("--results", action="store_true", help="print the final state")
    bool_flag(p, "cmp", False, "print expected vs actual outputs")
    p.add_argument("--file", default="None",
                   help="partition-map file (decomposition-tool output)")
    p.add_argument("--nx", type=int, default=25, help="tile x size")
    p.add_argument("--ny", type=int, default=25, help="tile y size")
    p.add_argument("--nt", type=int, default=45)
    p.add_argument("--npx", type=int, default=2)
    p.add_argument("--npy", type=int, default=2)
    p.add_argument("--nlog", type=int, default=5)
    p.add_argument("--nbalance", type=int, default=0,
                   help="steps between rebalance passes (0 = never)")
    p.add_argument("--eps", type=int, default=5)
    p.add_argument("--k", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=0.0005)
    p.add_argument("--dh", type=float, default=0.05)
    p.add_argument("--no-header", action="store_true", dest="no_header")
    p.add_argument("--devices", type=int, default=0,
                   help="the device count (the reference's number of localities); 0 = "
                        "every device of the platform, more than there are = virtual devices")
    p.add_argument("--superstep", type=int, default=1, metavar="K",
                   help="exchange a K*eps-wide halo once per K steps and advance K steps "
                        "locally (communication-avoiding; collective only)")
    p.add_argument("--comm", default="collective", choices=("collective", "fused"),
                   help="halo engine: 'collective' (the exchange, then apply_padded) or "
                        "'fused' (the halo kernels: on cards the halo is read inside the "
                        "kernel, elsewhere the exchange, then the split kernel; needs "
                        "--method cuda)")
    p.add_argument("--method", default="auto",
                   choices=("auto", "conv", "shift", "sat", "cuda", "fft"),
                   help="neighbour-sum evaluation: auto (cuda on the card, conv on the "
                        "CPU), cuda, conv, shift, sat, or fft (the sharded spectral tier: "
                        "the pencil-decomposed global transform)")
    add_stepper_flags(p)
    p.add_argument("--log", action="store_true",
                   help="write csv/vtu logs every nlog steps")
    add_checkpoint_flags(p)
    add_profile_flag(p)
    add_platform_flags(p)
    add_precision_flags(p)
    return p


def _uses_elastic(args) -> bool:
    """A partition map, a rebalance cadence or the balance report select
    the elastic executor (parallel/elastic.py)."""
    return args.file != "None" or args.nbalance > 0 or args.test_load_balance


def _refusal(args) -> str | None:
    """The message refusing the flags as given, or None (the elastic
    executor's refusals are the JAX CLI's, word for word)."""
    elastic = _uses_elastic(args)
    if elastic and args.comm != "collective":
        return ("--comm fused is the SPMD path's fused-exchange engine; "
                "the elastic executor (partition maps / --nbalance / "
                "--test_load_balance) does not support it")
    if args.resync:
        return ("--resync is not supported on the distributed/elastic paths; run the serial "
                "solver, or --precision bf16 without --resync")
    if elastic and args.method == "fft":
        return ("--method fft runs the SPMD pencil-transpose path; the "
                "elastic executor (partition maps / --nbalance / "
                "--test_load_balance) is stencil-only — drop one of "
                "them")
    if args.method == "fft" and args.comm == "fused":
        return ("--method fft runs on the collective all-to-all pencil "
                "transposes; --comm fused is a stencil-halo transport — "
                "drop one of them")
    if args.method == "fft" and args.superstep > 1:
        return ("--method fft has no superstep form (the transform is "
                "global every step); --stepper rkc/expo carry the big-dt "
                "claim on the spectral tier")
    if elastic and args.stepper != "euler":
        return ("--stepper rkc runs on the SPMD distributed path; the "
                "elastic executor (partition maps / --nbalance / "
                "--test_load_balance) steps with Euler — drop one of "
                "them")
    return validate_stepper_args(args)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    err = checkpoint_refusal(args) or _refusal(args)
    if err:
        print(err, file=sys.stderr)
        return 1

    def _no_elastic_multi(multi):
        if multi and _uses_elastic(args):
            # the elastic executor places every tile from one host-side view;
            # N ranks would run N independent balancers (the JAX words)
            raise SystemExit(
                "partition maps / --nbalance / --test_load_balance use "
                "the elastic executor, which is single-controller; run "
                "it on one process or drop those flags for the SPMD path")

    # the srun analog: every rank runs this same CLI, rank 0 owns the console
    try:
        multi, kw = cli_startup(args, "2d_nonlocal_distributed",
                                validate_multi=_no_elastic_multi)
    except RuntimeError as e:  # no card for --platform gpu
        print(f"error: {e}", file=sys.stderr)
        return 2
    nx, ny, npx, npy, dh = args.nx, args.ny, args.npx, args.npy, args.dh
    assignment = None
    if args.file != "None":
        from nonlocalheatequation_torch.utils.partition_map import read_partition_map

        pmap = read_partition_map(args.file)
        nx, ny, npx, npy, dh = pmap.nx, pmap.ny, pmap.npx, pmap.npy, pmap.dh
        assignment = pmap.assignment
    use_elastic = _uses_elastic(args)
    sk = stepper_kwargs(args)
    if not args.test_batch:
        # the bound in force (rkc's beta(s), not Euler's), policed at rc 2
        rc = announce_stable_dt(2, args.k, args.eps, dh, args.dt, **sk)
        if rc is not None:
            return rc
    if nx <= args.eps:
        print("[WARNING] Mesh size on a single node (nx * ny) is too small for given "
              "epsilon (eps)")
    from nonlocalheatequation_torch.parallel.distributed2d import (
        Solver2DDistributed,
        choose_mesh_for_grid,
    )
    from nonlocalheatequation_torch.parallel.mesh import device_list

    # --devices N: this rank's own devices; under a multi-process launch the
    # list holds every rank's, in rank order (parallel/mesh.py)
    devices = device_list(kw["device"], args.devices)

    def make_elastic(nx, ny, npx, npy, nt, eps, k, dt, dh):
        from nonlocalheatequation_torch.parallel.elastic import ElasticSolver2D

        place = assignment
        ndev = len(devices)
        if place is not None and int(np.max(place)) >= ndev:
            # fewer devices than the map's owners: fold owners onto the
            # devices, as the reference's distributed ctest degrades to one
            # locality (SURVEY.md section 4)
            print(f"[WARNING] partition map uses {int(np.max(place)) + 1} "
                  f"owners but only {ndev} devices are available; "
                  "folding owners onto devices", file=sys.stderr)
            place = place % ndev
        s = ElasticSolver2D(nx, ny, npx, npy, nt, eps, nlog=args.nlog,
                            nbalance=args.nbalance or None, k=k, dt=dt, dh=dh,
                            assignment=place, devices=devices, method=args.method,
                            dtype=kw["dtype"], checkpoint_path=args.checkpoint,
                            ncheckpoint=args.ncheckpoint, superstep=args.superstep,
                            precision=args.precision)
        if args.test_load_balance:
            s.measure = True  # report measured rates even without nbalance
        return s

    def make_solver(nx, ny, npx, npy, nt, eps, k, dt, dh):
        if use_elastic:
            return make_elastic(nx, ny, npx, npy, nt, eps, k, dt, dh)
        mesh = choose_mesh_for_grid(nx * npx, ny * npy, devices)
        return Solver2DDistributed(nx, ny, npx, npy, nt, eps, nlog=args.nlog, k=k, dt=dt,
                                   dh=dh, mesh=mesh, method=args.method, dtype=kw["dtype"],
                                   superstep=args.superstep, precision=args.precision,
                                   comm=args.comm, checkpoint_path=args.checkpoint,
                                   ncheckpoint=args.ncheckpoint, **sk)

    try:
        if args.test_batch:
            # row: nx ny npx npy nt eps k dt dh  (tests/2d_distributed.txt)
            def read_case(toks, pos):
                v = toks[pos:pos + 9]
                return ((int(v[0]), int(v[1]), int(v[2]), int(v[3]), int(v[4]), int(v[5]),
                         float(v[6]), float(v[7]), float(v[8])), pos + 9)

            def run_case(case):
                s = make_solver(*case)
                s.test_init()
                s.do_work()
                return s.error_l2, s.NX * s.NY

            return run_batch(read_case, run_case, row_tokens=9, multi=multi)

        s = make_solver(nx, ny, npx, npy, args.nt, args.eps, args.k, args.dt, dh)
    except ValueError as e:  # a configuration the solver refuses
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.log:
        from nonlocalheatequation_torch.utils.csvlog import SimulationCsvLogger

        s.logger = SimulationCsvLogger(s.op, test=args.test, tag="2d", nlog=args.nlog)
    if args.test:
        s.test_init()
    elif not args.resume:
        guard_multihost_stdin(multi)
        n = s.NX * s.NY
        s.input_init(np.array(sys.stdin.read().split(), dtype=np.float64)[:n])
        check_same_input_state(multi, s.u0)
    if args.resume:
        s.resume(args.checkpoint)

    from nonlocalheatequation_torch.utils.profiling import trace

    t0 = time.perf_counter()
    with trace(args.profile):
        s.do_work()
    elapsed = time.perf_counter() - t0
    if args.test_load_balance:
        from nonlocalheatequation_torch.parallel.load_balance import print_balance_report

        print_balance_report(s.busy_rates(), s.assignment)
    if args.test:
        s.print_error(args.cmp)
    if args.results:
        s.print_soln()

    from nonlocalheatequation_torch.utils.timing import print_time_results_distributed

    n_localities = len(s.devices) if use_elastic else s.mesh.size
    print_time_results_distributed(n_localities, os.cpu_count() or 1, elapsed, nx, ny, npx,
                                   npy, args.nt, header=not args.no_header)
    return 0


if __name__ == "__main__":
    sys.exit(main())
