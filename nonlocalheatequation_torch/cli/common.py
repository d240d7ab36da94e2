"""Shared CLI plumbing — the batch-test subset of
``nonlocalheatequation_tpu/cli/common.py``.

The batch protocol is the reference's batch_tester
(src/1d_nonlocal_serial.cpp:239-266): stdin holds ``num_tests`` then one
parameter row per test; the CLI prints "Tests Passed" or "Tests Failed".
The sequential batch loop and ``--ensemble`` (the batched ensemble engine,
serve/ensemble.py) are ported; serving, observability and the distributed
launch wait for later slices.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from nonlocalheatequation_torch.utils.devices import resolve_device


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


def announce_stable_dt(dim: int, k: float, eps: int, h: float, dt: float) -> None:
    """Print the forward-Euler stability bound in force and warn (never
    refuse) when dt exceeds it: several of the reference's own ctest rows sit
    marginally past it and reference parity means accepting them."""
    from nonlocalheatequation_torch.ops import constants as C
    from nonlocalheatequation_torch.ops import stencil as S

    mask = {1: S.horizon_mask_1d, 2: S.horizon_mask_2d, 3: S.horizon_mask_3d}[dim](eps)
    wsum = float(np.asarray(mask, np.float64).sum())
    c = {1: C.c_1d, 2: C.c_2d, 3: C.c_3d}[dim](k, eps, h)
    bound = C.stable_dt(c, h, dim, wsum)
    print(f"stability: dt bound in force {bound:g} (stepper euler); dt {dt:g}",
          file=sys.stderr)
    if dt > bound * (1.0 + 1e-12):
        print(f"WARNING: dt {dt:g} exceeds the forward-Euler stability bound "
              f"{bound:g}; accepted for reference parity but the solve may amplify",
              file=sys.stderr)


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


def run_batch(read_case, run_case, row_tokens: int, threshold=1e-6, run_ensemble=None):
    """The reference's batch_tester protocol.  ``read_case`` parses one row
    of ``row_tokens`` tokens; ``run_case(case) -> (error_l2, n)``.  Every
    row is validated before any solve runs.  With ``run_ensemble`` (a
    callable ``cases -> [(error_l2, n)]``, :func:`ensemble_runner`) the
    cases go to the ensemble engine as one submission, under the same pass
    criterion, instead of the sequential loop.  Returns the exit code."""
    cases = list(iter_batch_cases(read_case, row_tokens))
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
