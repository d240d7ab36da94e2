"""3D solver CLI — the batch-test and single-solve surface of
``nonlocalheatequation_tpu/cli/solve3d.py`` (no 3D binary exists in the
reference; the 2D serial CLI's surface with an added --nz), on the port.

    echo "1
    16 16 16 20 3 1 0.0005 0.0625" | python -m nonlocalheatequation_torch.cli.solve3d --test_batch

runs on the CUDA card (``--platform cpu`` for the CPU): rows
``nx ny nz nt eps k dt dh`` on stdin, "Tests Passed" when every row meets
error_l2/#points <= 1e-6; ``--ensemble`` runs the rows through the batched
ensemble engine.  ``--distributed`` shards the grid over ``--devices N`` devices
of the platform (0: every device; parallel/distributed3d.py; under a
multi-process launch each rank's N, rank 0 owning the console, as
cli/solve2d_distributed.py; ``--comm fused`` runs the halo
kernels of ops/cuda_halo.py and needs ``--method cuda``, ``--superstep K`` the
communication-avoiding schedule).  A single solve takes
``--checkpoint``/``--ncheckpoint``/``--resume`` (utils/checkpoint.py; a
checkpoint of either solver resumes in the other) and ``--profile DIR``.
``--stepper euler|rkc|expo`` (with ``--superstep-stages``) picks the time
integrator and ``--method fft`` the spectral apply, on the single-device
solve and with ``--distributed`` (rkc's stage loop above the exchange; fft
the sharded spectral tier, which refuses ``--comm fused`` and ``--superstep``
in the JAX words).  ``--test_batch --serve D`` streams the rows through the
serving pipeline (serve/server.py) with D chunks in flight (refused with
``--distributed``, as the JAX CLI refuses it); ``--trace DIR``,
``--metrics-out FILE`` and ``--metrics-port PORT`` are the observability
flags (cli/common.obs_session).  Refused by name, not ported yet: the JAX
CLI's network front door (``--listen``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nonlocalheatequation_torch.cli.common import (
    add_checkpoint_flags,
    add_ensemble_flag,
    add_obs_flags,
    add_platform_flags,
    add_precision_flags,
    add_profile_flag,
    add_program_store_flag,
    add_serve_flags,
    add_stepper_flags,
    announce_stable_dt,
    apply_program_store,
    bool_flag,
    check_same_input_state,
    checkpoint_refusal,
    cli_startup,
    ensemble_refusal,
    ensemble_runner,
    guard_multihost_stdin,
    obs_session,
    precision_kwargs,
    publish_solve_metrics,
    run_batch,
    serve_batch,
    stepper_kwargs,
    validate_obs_args,
    validate_serve_args,
    validate_stepper_args,
)

#: the JAX CLI's flags that the port does not have yet -> what they select
NOT_PORTED = {
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
                        "cuda (the hand-written kernels), shift, sat, fft (the padded-box "
                        "spectral apply; with --distributed the sharded pencil transform)")
    add_stepper_flags(p)
    p.add_argument("--distributed", action="store_true",
                   help="shard over the device mesh (blocks + halo exchange)")
    p.add_argument("--comm", default="collective", choices=("collective", "fused"),
                   help="with --distributed: halo engine, 'collective' (the exchange, then "
                        "apply_padded) or 'fused' (the halo kernels of ops/cuda_halo.py; "
                        "needs --method cuda)")
    p.add_argument("--superstep", type=int, default=1, metavar="K",
                   help="with --distributed: exchange a K*eps-wide halo once per K steps "
                        "(communication-avoiding)")
    p.add_argument("--devices", type=int, default=0,
                   help="with --distributed: this rank's device count; 0 = every device of "
                        "the platform, more than there are = virtual devices")
    add_checkpoint_flags(p)
    add_profile_flag(p)
    add_platform_flags(p)
    add_precision_flags(p)
    add_ensemble_flag(p)
    add_serve_flags(p)
    add_obs_flags(p)
    add_program_store_flag(p)
    return p


def _refusal(args, rest) -> str | None:
    """The message refusing a flag the port does not have yet, or None."""
    for tok in rest:
        name = tok.split("=")[0]
        what = NOT_PORTED.get(name) or next(
            (v for k, v in NOT_PORTED.items() if name.startswith(k + "-")), None)
        if what is not None:
            return f"{name} is not ported yet to nonlocalheatequation_torch ({what})"
    if args.method == "fft" and args.distributed and args.comm == "fused":
        return ("--method fft runs on the collective all-to-all pencil transposes; --comm "
                "fused is a stencil-halo transport — drop one of them")
    if args.method == "fft" and args.distributed and args.superstep > 1:
        return ("--method fft has no superstep form (the transform is global every step); "
                "--stepper rkc/expo carry the big-dt claim on the spectral tier")
    return validate_stepper_args(args) or _distributed_refusal(args)


def _distributed_refusal(args) -> str | None:
    """The JAX CLI's checks of the distributed flags, or None."""
    if args.comm != "collective" and not args.distributed:
        return "--comm fused requires --distributed"
    if args.devices and not args.distributed:
        return "--devices requires --distributed"
    if args.superstep > 1 and not args.distributed:
        return ("--superstep requires --distributed (the serial solvers have no halo "
                "exchange to avoid)")
    if args.distributed and args.resync:
        return ("--resync is not supported with --distributed; run the serial solver, or "
                "--precision bf16 without --resync")
    if args.distributed and args.backend == "oracle":
        return ("--distributed runs the device solver; it has no oracle backend (use the "
                "serial oracle for ground truth)")
    if args.ensemble and args.distributed:
        return ("--ensemble runs the serial batched engine; it cannot be combined with "
                "--distributed or --resync")
    return None


def main(argv=None) -> int:
    p = build_parser()
    args, rest = p.parse_known_args(argv)
    err = (_refusal(args, rest) or checkpoint_refusal(args) or ensemble_refusal(args)
           or validate_serve_args(args, [
               (args.serve and args.distributed,
                "--serve runs the serial batched engine; it cannot be combined "
                "with --distributed")])
           or validate_obs_args(args))
    if err:
        print(err, file=sys.stderr)
        return 1
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")

    def _need_distributed(multi):
        if multi and not args.distributed:
            raise SystemExit(
                "a multi-process launch needs --distributed (the serial "
                "backends would run N independent solves)")

    # the srun analog: every rank runs this same CLI, rank 0 owns the console
    try:
        multi, pkw = cli_startup(args, "3d_nonlocal", validate_multi=_need_distributed)
    except RuntimeError as e:  # no card for --platform gpu
        print(f"error: {e}", file=sys.stderr)
        return 2
    sk = stepper_kwargs(args)
    if not args.test_batch:
        rc = announce_stable_dt(3, args.k, args.eps, args.dh, args.dt, **sk)
        if rc is not None:
            return rc
    apply_program_store(args)
    with obs_session(args):
        return _run(args, multi, pkw, sk)


def _run(args, multi: bool, pkw: dict, sk: dict) -> int:
    from nonlocalheatequation_torch.models.solver3d import Solver3D
    from nonlocalheatequation_torch.parallel.distributed3d import (
        Solver3DDistributed,
        choose_mesh_for_grid_3d,
    )
    from nonlocalheatequation_torch.parallel.mesh import device_list

    kw = {"backend": args.backend, "method": args.method, "nlog": args.nlog, **pkw,
          **precision_kwargs(args)}
    # this rank's devices, and the other ranks' under a multi-process launch
    devices = device_list(kw["device"], args.devices) if args.distributed else None

    ckpt = {"checkpoint_path": args.checkpoint, "ncheckpoint": args.ncheckpoint}

    def solver(nx, ny, nz, nt, eps, k, dt, dh):
        if args.distributed:
            return Solver3DDistributed(nx, ny, nz, nt, eps, nlog=args.nlog, k=k, dt=dt, dh=dh,
                                       method=args.method, dtype=kw["dtype"],
                                       superstep=args.superstep, precision=args.precision,
                                       comm=args.comm,
                                       mesh=choose_mesh_for_grid_3d(nx, ny, nz, devices),
                                       **ckpt, **sk)
        return Solver3D(nx, ny, nz, nt, eps, k=k, dt=dt, dh=dh, **ckpt, **kw, **sk)

    if args.test_batch:
        # row: nx ny nz nt eps k dt dh
        def read_case(toks, pos):
            v = toks[pos:pos + 8]
            return ((int(v[0]), int(v[1]), int(v[2]), int(v[3]), int(v[4]),
                     float(v[5]), float(v[6]), float(v[7])), pos + 8)

        def make_solver(case):
            return solver(*case)

        def run_case(case):
            s = make_solver(case)
            s.test_init()
            s.do_work()
            return s.error_l2, int(np.prod(s._grid_shape))

        engine_kw = {"method": args.method, "precision": args.precision,
                     "device": kw["device"], "dtype": kw["dtype"], **sk}
        run_ensemble = ensemble_runner(make_solver, **engine_kw) if args.ensemble else None
        run_serve = None
        if args.serve:
            def run_serve(case_iter):
                return serve_batch(case_iter, make_solver, engine_kw, args)

        return run_batch(read_case, run_case, row_tokens=8, run_ensemble=run_ensemble,
                         run_serve=run_serve, profile=args.profile, multi=multi)

    try:
        s = solver(args.nx, args.ny, args.nz, args.nt, args.eps, args.k, args.dt, args.dh)
    except ValueError as e:  # a configuration the distributed solver refuses
        print(f"error: {e}", file=sys.stderr)
        return 1
    if args.test:
        s.test_init()
    elif not args.resume:
        guard_multihost_stdin(multi)
        n = args.nx * args.ny * args.nz
        s.input_init(np.array(sys.stdin.read().split(), dtype=np.float64)[:n])
        check_same_input_state(multi, s.u0)
    if args.resume:
        s.resume(args.checkpoint)

    from nonlocalheatequation_torch.utils.profiling import trace

    t0 = time.perf_counter()
    with trace(args.profile):
        s.do_work()
    elapsed = time.perf_counter() - t0
    publish_solve_metrics("3d", elapsed, args.nx * args.ny * args.nz, args.nt,
                          error_l2=s.error_l2 if args.test else None)
    if args.test:
        s.print_error(args.cmp)

    from nonlocalheatequation_torch.utils.timing import print_time_results_3d

    print_time_results_3d(os.cpu_count() or 1, elapsed, args.nx, args.ny, args.nz, args.nt,
                          header=not args.no_header)
    return 0


if __name__ == "__main__":
    sys.exit(main())
