"""Shared CLI plumbing — the batch-test subset of
``nonlocalheatequation_tpu/cli/common.py``.

The batch protocol is the reference's batch_tester
(src/1d_nonlocal_serial.cpp:239-266): stdin holds ``num_tests`` then one
parameter row per test; the CLI prints "Tests Passed" or "Tests Failed".
The sequential batch loop and ``--ensemble`` (the batched ensemble engine,
serve/ensemble.py) are ported, each under ``--profile``, and so are the
stepper flags (``--stepper``, ``--superstep-stages``) and the multi-process
launch (:func:`cli_startup`: ``srun -n N``, every rank running the same
binary, rank 0 owning the console and the files); serving and
observability wait for later slices.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from nonlocalheatequation_torch.utils.devices import resolve_device


def init_multihost(platform: str | None = None) -> bool:
    """Wire the CLI into a multi-process run when the launch environment
    says so (parallel/multihost.init_from_env: COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID, SLURM_NTASKS); a single-process
    launch is a no-op returning False.  Non-zero ranks silence stdout at the
    file descriptor, not only ``sys.stdout``: native transports (gloo)
    write straight to fd 1, and console output belongs to rank 0, as the
    reference's ``hpx_main`` runs on locality 0 only."""
    from nonlocalheatequation_torch.parallel import multihost

    if not multihost.init_from_env(platform=platform):
        return False
    if multihost.process_index() != 0:
        sys.stdout.flush()
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, 1)
        os.close(devnull)
    return True


def cli_startup(args, prog: str, validate_multi=None) -> tuple[bool, dict]:
    """The CLI prologue in the JAX package's order: the platform (the
    device ``--platform`` names; raises RuntimeError when it asks for a card
    there is not, which the CLIs turn into exit 2), the multi-process
    wiring, ``validate_multi(multi)`` if given (a launch-mode check that
    must fail before any solve), the version banner (rank 0's alone by
    then), and the solver's device kwargs.  Returns ``(multi, kwargs)``."""
    kw = platform_kwargs(args)
    multi = init_multihost(kw["device"].type)
    if validate_multi is not None:
        validate_multi(multi)
    version_banner(prog)
    return multi, kw


def guard_multihost_stdin(multi: bool) -> None:
    """Each rank reads its own stdin (srun broadcasts it to every task, the
    reference's input model), but a terminal would block one rank while
    its peers enter the first collective: refuse instead of hanging."""
    if multi and sys.stdin.isatty():
        raise SystemExit(
            "multi-process input runs need stdin piped to every rank "
            "(srun broadcasts by default); use --test/--resume or "
            "redirect the input file")


def check_same_input_state(multi: bool, u0) -> None:
    """Divergent per-rank input would silently break the one-program
    contract; fail on every rank instead."""
    if multi:
        from nonlocalheatequation_torch.parallel import multihost

        multihost.assert_same_on_all_hosts(u0, "input state")


def version_banner(prog: str):
    """Reference binaries print ``argv[0] (MAJOR.MINOR.UPDATE)`` at startup."""
    from nonlocalheatequation_torch import __version__

    print(f"{prog} ({__version__})")


def _bool_flag(s: str) -> bool:
    """argparse ``type=`` for boost-program_options-style bools; an
    unrecognized token is refused (rc 2), never read as False."""
    v = s.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(
        f"expected one of 0/1/true/false/yes/no/on/off, got {s!r}")


def bool_flag(p: argparse.ArgumentParser, name: str, default: bool, help: str):
    """Boost-program_options-style bool: --name true|false|0|1."""
    p.add_argument(f"--{name}", type=_bool_flag, default=default, help=help)


def add_platform_flags(p: argparse.ArgumentParser):
    p.add_argument("--platform", default="gpu", choices=("gpu", "cpu"),
                   help="device to run on: gpu (default, the CUDA card; refused "
                        "when there is none) or cpu")
    p.add_argument("--x64", type=_bool_flag, default=None,
                   help="state in float64 (1) or float32 (0); default float64 "
                        "on the CPU and float32 on the card")


def platform_kwargs(args) -> dict:
    """``device``/``dtype`` solver kwargs for add_platform_flags' namespace."""
    device = resolve_device(args.platform)
    dtype = None if args.x64 is None else (torch.float64 if args.x64 else torch.float32)
    return {"device": device, "dtype": dtype}


def add_precision_flags(p: argparse.ArgumentParser):
    p.add_argument("--precision", default="f32", choices=("f32", "bf16"),
                   help="operand precision tier: f32 (the state dtype end to end) "
                        "or bf16 (bfloat16 operand reads, state-dtype accumulate "
                        "and carry)")
    p.add_argument("--resync", type=int, default=0, metavar="R",
                   help="bf16 tier only: run a full-precision step every R steps "
                        "(0 = never)")


def precision_kwargs(args) -> dict:
    return {"precision": args.precision, "resync_every": args.resync}


def add_checkpoint_flags(p: argparse.ArgumentParser):
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file to write every --ncheckpoint steps")
    p.add_argument("--ncheckpoint", type=int, default=0,
                   help="steps between checkpoints (0 = never)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the --checkpoint file before running")


def checkpoint_refusal(args) -> str | None:
    """Why the checkpoint flags cannot run as given, or None."""
    if args.resume and not args.checkpoint:
        return "--resume requires --checkpoint"
    if args.test_batch and (args.resume or args.checkpoint):
        # the batch cases would all share the one --checkpoint path
        return "--checkpoint/--resume cannot be combined with --test_batch"
    return None


def add_profile_flag(p: argparse.ArgumentParser):
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the solve into DIR")


def add_ensemble_flag(p: argparse.ArgumentParser):
    """--ensemble: batch-test cases scheduled through the batched ensemble
    engine (serve/ensemble.py) instead of the sequential case loop."""
    p.add_argument(
        "--ensemble", action="store_true",
        help="with --test_batch: group the cases into shape buckets and run each bucket "
             "as one batched multi-step program (serve/ensemble.py); pass criterion and "
             "output are unchanged")


def ensemble_refusal(args) -> str | None:
    """Why ``--ensemble`` cannot run with these flags, or None."""
    if not args.ensemble:
        return None
    if not args.test_batch:
        return "--ensemble schedules batch-test cases; it requires --test_batch"
    if args.resync:
        # the batched paths have no per-step precision switch
        # (nonlocal_op.check_bucket_ops refuses it too)
        return ("--resync is not supported with --ensemble; run the sequential batch, or "
                "--precision bf16 without --resync")
    return None


def ensemble_runner(make_solver, **engine_kwargs):
    """``cases -> [(error_l2, n)]`` for :func:`run_batch`: one test-form
    solver per case, all run by one ensemble engine, each final state fed
    back through ``s.u`` and ``s.compute_l2`` (the solo path's error code).
    Prints ``ensemble: <report summary>`` on stderr."""
    def run_ensemble(cases):
        from nonlocalheatequation_torch.serve.ensemble import EnsembleEngine

        solvers = []
        for case in cases:
            s = make_solver(case)
            s.test_init()
            solvers.append(s)
        engine = EnsembleEngine(**engine_kwargs)
        states = engine.run([s.ensemble_case() for s in solvers])
        print(f"ensemble: {engine.report.summary()}", file=sys.stderr)
        out = []
        for s, u in zip(solvers, states, strict=True):
            s.u = u
            out.append((s.compute_l2(s.nt), u.size))
        return out

    return run_ensemble


def add_stepper_flags(p: argparse.ArgumentParser):
    """The time integrator's flags (models/steppers.py): forward Euler (the
    reference's scheme, the default), rkc super-stepping (every method; dt
    up to ~s^2/2 past the Euler bound) or the spectral exponential
    integrator (``--method fft`` only; unconditionally stable)."""
    p.add_argument(
        "--stepper", default="euler", choices=("euler", "rkc", "expo"),
        help="time integrator: euler (default, the reference's scheme), rkc (s-stage "
             "Runge-Kutta-Chebyshev super-stepping, every --method including cuda; dt may "
             "exceed the Euler bound by ~s^2/2), or expo (spectral exponential integrator, "
             "requires --method fft; unconditionally stable)")
    p.add_argument(
        "--superstep-stages", dest="stages", type=int, default=0, metavar="S",
        help="--stepper rkc: the stage count s >= 2 (0 picks the default 8); the "
             "stability interval grows ~2*s^2 at s operator applications a step.  "
             "--stepper expo: S >= 1 arms the boundary correction (S substeps; 0 = the "
             "plain step)")


def stepper_kwargs(args) -> dict:
    """The solver kwargs of add_stepper_flags' namespace (rkc's default stage
    count resolved here, so every surface agrees)."""
    from nonlocalheatequation_torch.models.steppers import DEFAULT_STAGES

    stages = args.stages
    if args.stepper == "rkc" and stages == 0:
        stages = DEFAULT_STAGES
    return {"stepper": args.stepper, "stages": stages}


def validate_stepper_args(args) -> str | None:
    """Why the stepper flags cannot run as given (the caller prints it and
    exits 1), or None; the dt bound is :func:`announce_stable_dt`'s."""
    if args.stepper != "euler" and getattr(args, "backend", "torch") == "oracle":
        return ("--backend oracle is Euler-only (the ground truth for the reference's own "
                f"scheme); run --stepper {args.stepper} on the torch backend")
    if args.stepper == "expo" and getattr(args, "method", "fft") != "fft":
        return ("--stepper expo integrates in the spectral domain; it requires --method fft "
                "(rkc super-steps every other method)")
    if args.stages and args.stepper == "euler":
        return ("--superstep-stages configures the rkc stage count or the expo boundary "
                "correction; --stepper euler takes no stage count")
    if args.stages < 0:
        return f"--superstep-stages must be >= 0 (got {args.stages})"
    if args.stepper == "rkc" and args.stages != 0 and args.stages < 2:
        return f"--stepper rkc needs --superstep-stages >= 2 (or 0 = default; got {args.stages})"
    return None


def announce_stable_dt(dim: int, k: float, eps: int, h: float, dt: float,
                       stepper: str = "euler", stages: int = 0) -> int | None:
    """Print the stability bound in force for (stepper, stages) and police
    ``dt`` against it: an rkc or expo run past its model is refused (returns
    2: it would amplify, not diffuse); an Euler run past its bound only
    warns, since several of the reference's own ctest rows sit marginally
    past it and reference parity means accepting them.  Returns the exit
    code, or None to proceed."""
    from nonlocalheatequation_torch.ops import constants as C
    from nonlocalheatequation_torch.ops import stencil as S

    mask = {1: S.horizon_mask_1d, 2: S.horizon_mask_2d, 3: S.horizon_mask_3d}[dim](eps)
    wsum = float(np.asarray(mask, np.float64).sum())
    c = {1: C.c_1d, 2: C.c_2d, 3: C.c_3d}[dim](k, eps, h)
    bound = C.stable_dt(c, h, dim, wsum, stepper=stepper, stages=stages)
    label = stepper if stepper != "rkc" else f"rkc[s={stages}]"
    print(f"stability: dt bound in force {bound:g} (stepper {label}; Euler bound "
          f"{C.stable_dt(c, h, dim, wsum):g}); dt {dt:g}", file=sys.stderr)
    if dt <= bound * (1.0 + 1e-12):
        return None
    if stepper == "euler":
        print(f"WARNING: dt {dt:g} exceeds the forward-Euler stability bound {bound:g}; "
              "accepted for reference parity (several reference ctest rows sit marginally "
              "past it) but the solve may amplify — consider --stepper rkc", file=sys.stderr)
        return None
    print(f"dt {dt:g} exceeds the {label} stability bound {bound:g}; raise "
          "--superstep-stages or shrink --dt", file=sys.stderr)
    return 2


def iter_batch_cases(read_case, row_tokens, stream=None):
    """Yield batch cases as their rows arrive, refusing loudly: empty input,
    a non-integer or negative header, a truncated stream (case index and
    expected token count) and a malformed row all SystemExit."""
    if row_tokens is None or row_tokens < 1:
        raise ValueError("iter_batch_cases needs the row's token count")
    stream = sys.stdin if stream is None else stream
    buf: list[str] = []
    eof = False

    def fill(need: int):
        nonlocal eof
        while len(buf) < need and not eof:
            line = stream.readline()
            if not line:
                eof = True
            else:
                buf.extend(line.split())

    fill(1)
    if not buf:
        raise SystemExit("batch input is empty: expected 'num_tests' followed by one "
                         "parameter row per test")
    head = buf.pop(0)
    try:
        num_tests = int(head)
    except ValueError:
        raise SystemExit(f"batch input header {head!r} is not an integer test "
                         "count") from None
    if num_tests < 0:
        raise SystemExit(f"batch input declares {num_tests} tests")
    for i in range(num_tests):
        fill(row_tokens)
        if len(buf) < row_tokens:
            raise SystemExit(
                f"batch case {i}: truncated input — expected {row_tokens} tokens per "
                f"case, found only {len(buf)} of the declared {num_tests} cases' "
                "tokens remaining")
        try:
            case, _pos = read_case(buf[:row_tokens], 0)
        except (IndexError, ValueError) as e:
            raise SystemExit(f"batch case {i}: malformed parameter row (expected "
                             f"{row_tokens} numeric tokens): {e}") from None
        del buf[:row_tokens]
        yield case


def parse_batch_cases(read_case, tokens, row_tokens=None):
    """Parse a whole batch token stream up front, refusing loudly (the same
    messages as :func:`iter_batch_cases`)."""
    if not tokens:
        raise SystemExit("batch input is empty: expected 'num_tests' followed by one "
                         "parameter row per test")
    try:
        num_tests = int(tokens[0])
    except ValueError:
        raise SystemExit(f"batch input header {tokens[0]!r} is not an integer test "
                         "count") from None
    if num_tests < 0:
        raise SystemExit(f"batch input declares {num_tests} tests")
    pos = 1
    cases = []
    for i in range(num_tests):
        if row_tokens is not None and len(tokens) - pos < row_tokens:
            raise SystemExit(
                f"batch case {i}: truncated input — expected {row_tokens} tokens per "
                f"case, found only {len(tokens) - pos} of the declared {num_tests} "
                "cases' tokens remaining")
        try:
            case, pos = read_case(tokens, pos)
        except (IndexError, ValueError) as e:
            raise SystemExit(
                f"batch case {i}: malformed parameter row"
                + (f" (expected {row_tokens} numeric tokens)" if row_tokens else "")
                + f": {e}") from None
        cases.append(case)
    return cases


def run_batch(read_case, run_case, row_tokens: int, threshold=1e-6, run_ensemble=None,
              profile=None, multi: bool = False):
    """The reference's batch_tester protocol.  ``read_case`` parses one row
    of ``row_tokens`` tokens; ``run_case(case) -> (error_l2, n)``.  Every
    row is validated before any solve runs.  With ``run_ensemble`` (a
    callable ``cases -> [(error_l2, n)]``, :func:`ensemble_runner`) the
    cases go to the ensemble engine as one submission, under the same pass
    criterion, instead of the sequential loop.  With ``profile`` (a
    directory) the whole batch, sequential or ensemble, runs under one
    ``torch.profiler`` capture (utils/profiling.py).  Under a multi-process
    launch (``multi``) every rank reads the whole stream first and the
    ranks' token streams must be identical (the ``"batch input"`` digest),
    or every rank fails.  Returns the exit code."""
    from nonlocalheatequation_torch.utils import profiling

    if multi:
        from nonlocalheatequation_torch.parallel import multihost

        guard_multihost_stdin(multi)
        tokens = sys.stdin.read().split()
        multihost.assert_same_on_all_hosts(
            np.frombuffer(" ".join(tokens).encode(), dtype=np.uint8), "batch input")
        cases = parse_batch_cases(read_case, tokens, row_tokens)
    else:
        cases = list(iter_batch_cases(read_case, row_tokens))
    with profiling.trace(profile):
        if run_ensemble is not None:
            failed = any(error_l2 / n > threshold for error_l2, n in run_ensemble(cases))
        else:
            failed = False
            for case in cases:
                error_l2, n = run_case(case)
                if error_l2 / n > threshold:
                    failed = True
                    break
    print("Tests Failed" if failed else "Tests Passed")
    return 1 if failed else 0
