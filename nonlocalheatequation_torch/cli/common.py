"""Shared CLI plumbing — the counterpart of
``nonlocalheatequation_tpu/cli/common.py``.

The batch protocol is the reference's batch_tester
(src/1d_nonlocal_serial.cpp:239-266): stdin holds ``num_tests`` then one
parameter row per test; the CLI prints "Tests Passed" or "Tests Failed".
Ported: the sequential batch loop, ``--ensemble`` (the batched ensemble
engine, serve/ensemble.py) and ``--serve D`` (the streaming serving
pipeline, serve/server.py, with its supervision flags), each under
``--profile``; the stepper flags (``--stepper``, ``--superstep-stages``);
the observability flags ``--trace``, ``--metrics-out`` and
``--metrics-port``, and the crash flight recorder ``--flight-dir``
(:func:`obs_session`); the program store ``--program-store``
(:func:`add_program_store_flag`); and the multi-process launch
(:func:`cli_startup`: ``srun -n N``, every rank running the same binary,
rank 0 owning the console and the files); and the network front door
(``--listen`` with ``--replicas``, ``--transport``, ``--worker-token``,
``--shard-threshold``, ``--gang-devices`` and ``--slo``: :func:`run_listen`,
a replica fleet behind the HTTP tier, with the live-session tier's six
``--session-*`` flags: serve/sessions.py over the same fleet).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import socket
import sys

import numpy as np
import torch

from nonlocalheatequation_torch.obs import flightrec
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
    Prints ``ensemble: <report summary>`` on stderr; the engine's registry
    backs ``--metrics-port`` and its metrics line is the ``--metrics-out``
    payload."""
    def run_ensemble(cases):
        from nonlocalheatequation_torch.serve.ensemble import EnsembleEngine

        solvers = []
        for case in cases:
            s = make_solver(case)
            s.test_init()
            solvers.append(s)
        engine = EnsembleEngine(**engine_kwargs)
        set_live_registry(engine.report.registry)
        states = engine.run([s.ensemble_case() for s in solvers])
        print(f"ensemble: {engine.report.summary()}", file=sys.stderr)
        set_metrics_payload(engine.report.metrics_json())
        out = []
        for s, u in zip(solvers, states, strict=True):
            s.u = u
            out.append((s.compute_l2(s.nt), u.size))
        return out

    return run_ensemble


def add_program_store_flag(p: argparse.ArgumentParser):
    """--program-store: the program store (serve/program_store.py), the
    CLI face of the warm-boot path.  The value lands in the
    ``NLHEAT_PROGRAM_STORE`` env knob so every layer under the CLI (the
    kernel build, the solo tuned path, the ensemble engine, the serving
    pipeline and its CPU fallback siblings) resolves the same store."""
    p.add_argument(
        "--program-store", dest="program_store", default=None, metavar="DIR",
        help="reuse built kernel libraries and tuned program recipes across sessions: a "
             "warm boot restores them from DIR instead of re-paying nvcc and the tuner's "
             "probes (bitwise the same results; loud refusal + fresh build on any "
             "version/topology mismatch). DIR=1 selects the per-user default dir, 0 "
             "disables; ambient NLHEAT_PROGRAM_STORE=DIR does the same")


def apply_program_store(args) -> None:
    """Publish --program-store into the env knob (before any solve or build
    machinery constructs, so all layers agree)."""
    ps = getattr(args, "program_store", None)
    if ps is not None:
        os.environ["NLHEAT_PROGRAM_STORE"] = ps


def add_serve_flags(p: argparse.ArgumentParser):
    """--serve D: batch-test cases streamed through the async serving
    pipeline (serve/server.py) with D chunks in flight; the JAX CLIs'
    six flags, defaults and help."""
    p.add_argument(
        "--serve", type=int, default=0, metavar="D",
        help="with --test_batch: stream cases from stdin into the continuous-batching "
             "serving pipeline (serve/server.py) with D chunks of dispatches in flight "
             "(D >= 1; 0 = off).  Cases are scheduled the moment their row arrives; results "
             "are bit-identical to --ensemble, only the schedule overlaps.  D=1 is the "
             "fenced A/B schedule.")
    p.add_argument(
        "--serve-window-ms", dest="serve_window_ms", type=float, default=50.0, metavar="T",
        help="--serve microbatch window: a chunk closes at the engine's batch size or after "
             "T ms, whichever first (default 50)")
    p.add_argument(
        "--serve-retries", dest="serve_retries", type=int, default=2, metavar="R",
        help="--serve supervision: re-dispatch a failed chunk up to R times with exponential "
             "backoff before bisecting it to isolate the poison case (default 2; the "
             "isolated case fails its test instead of killing the batch)")
    p.add_argument(
        "--serve-fallback", dest="serve_fallback", type=_bool_flag, default=True,
        metavar="0|1",
        help="--serve supervision: after K consecutive device-path failures open a circuit "
             "breaker and route chunks through the plain PyTorch program on the CPU until a "
             "half-open probe re-closes it (default 1; 0 keeps retry+quarantine only)")
    p.add_argument(
        "--serve-deadline-ms", dest="serve_deadline_ms", type=float, default=0.0,
        metavar="MS",
        help="--serve supervision: per-chunk fence/fetch deadline — a fetch that misses it "
             "is classified a hang and retried (0 = no watchdog, the default; the watchdog "
             "thread is abandoned on a miss, never killed)")
    p.add_argument(
        "--serve-nan-policy", dest="serve_nan_policy", default="quarantine",
        choices=("quarantine", "serve"),
        help="--serve supervision: what a non-finite fetched result means — 'quarantine' "
             "(default) classifies it a corrupt fault (retried, then bisected to the poison "
             "case); 'serve' restores the a-diverged-solve-is-a-legitimate-result contract, "
             "leaving the oracle criterion to judge it")


def validate_serve_args(args, extra_refusals=()) -> str | None:
    """The batch CLIs' shared --serve checks in the JAX words; returns an
    error string (the caller prints it and exits 1) or None.
    ``extra_refusals`` is a list of (condition, message) pairs for
    CLI-specific conflicts."""
    if not args.serve:
        return None
    if args.serve < 1:
        return f"--serve needs D >= 1 chunks in flight (got {args.serve})"
    if args.serve_window_ms < 0:
        return f"--serve-window-ms must be >= 0 (got {args.serve_window_ms:g})"
    if args.serve_retries < 0:
        return f"--serve-retries must be >= 0 (got {args.serve_retries})"
    if args.serve_deadline_ms < 0:
        return f"--serve-deadline-ms must be >= 0 (got {args.serve_deadline_ms:g})"
    if not args.test_batch:
        return "--serve streams batch-test cases; it requires --test_batch"
    if args.ensemble:
        return ("--serve already schedules through the ensemble engine "
                "(overlapped); drop --ensemble")
    if args.resync:
        return ("--resync is not supported with --serve (the batched "
                "paths have no per-step precision switch)")
    for cond, msg in extra_refusals:
        if cond:
            return msg
    return None


def serve_batch(case_iter, make_solver, engine_kwargs, args):
    """The --serve driver shared by the batch CLIs: stream parsed rows
    into a :class:`~nonlocalheatequation_torch.serve.server.ServePipeline`,
    drain, then feed each returned state back through its Solver's
    metrics — the same state-feedback contract as --ensemble (the oracle
    criterion ``error_l2/#points <= threshold`` is computed by the solo
    path's code).  Supervision knobs ride along (``--serve-retries/
    --serve-fallback/--serve-deadline-ms/--serve-nan-policy``); a
    QUARANTINED case is reported loudly on stderr and scored as a failed
    test (error inf) instead of killing the batch.  Prints the pipeline
    summary and the one-line JSON metrics dump (failure telemetry
    included) on stderr; the pipeline's registry backs --metrics-port
    while the run is live and the final ``metrics_json()`` line becomes
    the --metrics-out payload.  With the engine on the card, a case the
    CPU fallback served is not the card's result: it is reported on stderr
    and scored as failed too.  Returns ``[(error_l2, n)]`` in submission
    order."""
    from nonlocalheatequation_torch.serve.server import ServePipeline

    with ServePipeline(depth=args.serve, window_ms=args.serve_window_ms,
                       retries=args.serve_retries, fallback=args.serve_fallback,
                       fetch_deadline_ms=args.serve_deadline_ms or None,
                       nan_policy=args.serve_nan_policy, **engine_kwargs) as pipe:
        set_live_registry(pipe.registry)
        pairs = []
        for row in case_iter:
            s = make_solver(row)
            s.test_init()
            pairs.append((s, pipe.submit(s.ensemble_case())))
        pipe.drain()
        print(f"serve: {pipe.report.summary()}", file=sys.stderr)
        line = pipe.metrics_json()
        print(line, file=sys.stderr)
        set_metrics_payload(line)
        out = []
        for s, h in pairs:
            if h.error is not None:
                print(f"serve: case {h.seq} QUARANTINED: {h.error}", file=sys.stderr)
                out.append((float("inf"), 1))
                continue
            if pipe.on_card and h.route == "fallback":
                print(f"serve: case {h.seq} served by the CPU fallback while the engine is "
                      "on the card: not the card's result", file=sys.stderr)
                out.append((float("inf"), 1))
                continue
            s.u = h.result
            out.append((s.compute_l2(s.nt), int(np.prod(h.case.shape))))
        return out


def add_listen_flags(p: argparse.ArgumentParser):
    """--listen/--replicas: the network front door (serve/http.py +
    serve/router.py) — the CLI stops reading cases from stdin and serves
    them over HTTP from a replica fleet instead; the JAX CLIs' flags,
    defaults and help, the six ``--session-*`` flags of the live-session
    tier (serve/sessions.py) included."""
    p.add_argument(
        "--listen", type=int, default=None, metavar="PORT",
        help="serve cases over HTTP on 127.0.0.1:PORT (0 picks a free port, printed to "
             "stderr): POST /v1/cases submits, GET /v1/cases/<id>[?wait=1] polls/waits, "
             ".../result fetches, /healthz and /metrics expose the fleet.  Admission "
             "control sheds with 429 + Retry-After before any queue can grow without "
             "bound.  The process serves until stdin reaches EOF, then drains and exits.")
    p.add_argument(
        "--replicas", type=int, default=1, metavar="N",
        help="--listen: size of the replica fleet — N ServePipeline worker processes "
             "behind a sticky bucket-key router (serve/router.py); all replicas share one "
             "program store (--program-store/NLHEAT_PROGRAM_STORE) so added or respawned "
             "workers boot with no nvcc run and no probe")
    p.add_argument(
        "--transport", default=None, choices=("pipe", "tcp"),
        help="--listen: how the router reaches its workers — 'pipe' (default: "
             "stdin/stdout frames, one host) or 'tcp' (serve/transport.py: workers dial a "
             "loopback listener with --worker-connect and speak the identical frames)")
    p.add_argument(
        "--worker-token", default=None, metavar="SECRET",
        help="--transport tcp: shared secret checked on each worker's hello frame "
             "(required before a SocketTransport may bind non-loopback — the frames are "
             "pickle; see serve/transport.py trust boundary)")
    p.add_argument(
        "--shard-threshold", type=int, default=None, metavar="POINTS",
        help="--listen (2D): grids with MORE than POINTS cells are dispatched to the gang "
             "replica — one worker owning an N-device mesh that solves each such case as a "
             "space-parallel distributed run (comm=fused where the halo kernels serve it), "
             "bitwise the offline distributed solver.  0/unset = off")
    p.add_argument(
        "--gang-devices", type=int, default=None, metavar="N",
        help="--shard-threshold: devices in the gang replica's mesh (default: every card "
             "the gang worker sees; more than there are = virtual devices)")
    p.add_argument(
        "--slo", type=int, default=None, choices=(0, 1), metavar="0|1",
        help="--listen: the SLO promise-audit ledger (obs/slo.py) — 1 joins every "
             "accepted request's promise (picked engine, modeled cost, deadline) to its "
             "observed outcome: /slo/* metrics, the GET /v1/status burn/drift block, and "
             "per-worker live rate recalibration back into the tuner records; 0 forces "
             "off; unset defers to NLHEAT_SLO=1")
    # the live-session tier (serve/sessions.py): POST /v1/sessions opens a
    # stateful streaming simulation on the same fleet; these knobs configure
    # its budgets and crash-safety
    p.add_argument(
        "--session-chunk", type=int, default=None, metavar="STEPS",
        help="--listen: default steps per session chunk (one chunk = one dispatched "
             "program = one preview frame; per-session override via the POST body's "
             "chunk_steps)")
    p.add_argument(
        "--session-budget", type=int, default=None, metavar="STEPS",
        help="--listen: per-session step budget per second (0 = unlimited; env "
             "NLHEAT_SESSION_BUDGET) — a greedy stream DEFERS at chunk granularity instead "
             "of starving batch")
    p.add_argument(
        "--session-rate", type=float, default=None, metavar="STEPS_PER_S",
        help="--listen: FLEET-wide session step-rate cap through the admission "
             "controller's token bucket (unset = no cap; session chunks always defer while "
             "batch admission sheds)")
    p.add_argument(
        "--session-checkpoint-dir", default=None, metavar="DIR",
        help="--listen: crash-safe session checkpoints land here (utils/checkpoint.py, "
             "atomic+CRC, keyed session id + step) — enables resume after a front-door "
             "death and fork-from-checkpoint; unset = live-state forks only")
    p.add_argument(
        "--session-checkpoint-every", type=int, default=None, metavar="CHUNKS",
        help="--listen: checkpoint cadence in chunks (0 = off; env "
             "NLHEAT_SESSION_CKPT_EVERY)")
    p.add_argument(
        "--session-preview", type=int, default=None, metavar="STRIDE",
        help="--listen: preview-frame downsample stride (f32 u[::STRIDE] per chunk "
             "boundary; env NLHEAT_SESSION_PREVIEW, default 4)")


def validate_listen_args(args, dim: int | None = None) -> str | None:
    """The front-door flags' checks in the JAX words (the caller prints and
    exits 1).  ``dim`` is the calling CLI's grid rank: the sharded case
    class is the 2D flagship tier, so solve1d/solve3d refuse
    --shard-threshold."""
    if args.listen is None:
        if getattr(args, "replicas", 1) != 1:
            return "--replicas configures the --listen fleet; add --listen"
        for flag, name in [(getattr(args, "transport", None), "--transport"),
                           (getattr(args, "worker_token", None), "--worker-token"),
                           (getattr(args, "shard_threshold", None), "--shard-threshold"),
                           (getattr(args, "gang_devices", None), "--gang-devices"),
                           (getattr(args, "slo", None), "--slo"),
                           (getattr(args, "session_chunk", None), "--session-chunk"),
                           (getattr(args, "session_budget", None), "--session-budget"),
                           (getattr(args, "session_rate", None), "--session-rate"),
                           (getattr(args, "session_checkpoint_dir", None),
                            "--session-checkpoint-dir"),
                           (getattr(args, "session_checkpoint_every", None),
                            "--session-checkpoint-every"),
                           (getattr(args, "session_preview", None), "--session-preview")]:
            if flag is not None:
                return f"{name} configures the --listen fleet; add --listen"
        return None
    if not 0 <= args.listen <= 65535:
        return f"--listen must be in [0, 65535] (got {args.listen})"
    if args.replicas < 1:
        return f"--replicas needs N >= 1 (got {args.replicas})"
    if getattr(args, "worker_token", None) is not None \
            and (getattr(args, "transport", None) or "pipe") != "tcp":
        return ("--worker-token authenticates --transport tcp workers; "
                "the pipe transport is the same process tree")
    shard = getattr(args, "shard_threshold", None)
    if shard is not None and shard < 0:
        return f"--shard-threshold needs POINTS >= 0 (got {shard})"
    if shard and dim is not None and dim != 2:
        return ("--shard-threshold dispatches big 2D grids to the gang "
                f"replica; this CLI serves {dim}D cases — drop the flag "
                "or use solve2d")
    if getattr(args, "gang_devices", None) is not None and not shard:
        return "--gang-devices sizes the gang mesh; add --shard-threshold"
    for val, name in ((getattr(args, "session_chunk", None), "--session-chunk"),
                      (getattr(args, "session_preview", None), "--session-preview")):
        if val is not None and val < 1:
            return f"{name} needs a value >= 1 (got {val})"
    for val, name in ((getattr(args, "session_budget", None), "--session-budget"),
                      (getattr(args, "session_rate", None), "--session-rate"),
                      (getattr(args, "session_checkpoint_every", None),
                       "--session-checkpoint-every")):
        if val is not None and val < 0:
            return f"{name} needs a value >= 0 (0 = off; got {val})"
    if getattr(args, "session_checkpoint_every", None) \
            and not getattr(args, "session_checkpoint_dir", None):
        return ("--session-checkpoint-every needs a place to write; "
                "add --session-checkpoint-dir")
    for flag, name in ((getattr(args, "test", False), "--test"),
                       (getattr(args, "test_batch", False), "--test_batch"),
                       (getattr(args, "ensemble", False), "--ensemble"),
                       (getattr(args, "serve", 0), "--serve"),
                       (getattr(args, "checkpoint", None), "--checkpoint"),
                       (getattr(args, "resume", False), "--resume"),
                       (getattr(args, "results", False), "--results"),
                       (getattr(args, "log", False), "--log")):
        if flag:
            return (f"--listen serves cases over HTTP; {name} belongs to "
                    "the stdin-driven modes — drop one of them")
    if getattr(args, "resync", 0):
        return ("--resync is not supported with --listen (the batched "
                "paths have no per-step precision switch)")
    return None


def run_listen(args, engine_kwargs) -> int:
    """The --listen driver shared by the solve CLIs: a replica fleet
    (serve/router.py) behind the HTTP ingestion tier (serve/http.py),
    serving until stdin reaches EOF — the stdin-as-lifetime contract lets a
    supervisor stop the server by closing the pipe.  ``engine_kwargs``
    carry the engine's ``device``/``dtype`` (``--platform``, ``--x64``) to
    every worker; on the card the router builds the kernel libraries once
    before the first spawn.  The router registry backs --metrics-port and
    the final metrics dump becomes the --metrics-out payload.  One
    SessionManager (serve/sessions.py) over the same fleet serves
    /v1/sessions*, sharing the ingress's admission controller."""
    import json as _json
    import threading

    from nonlocalheatequation_torch.serve.http import AdmissionController, IngressServer
    from nonlocalheatequation_torch.serve.router import ReplicaRouter
    from nonlocalheatequation_torch.serve.sessions import (
        SESSION_BUDGET_ENV,
        SESSION_CKPT_ENV,
        SESSION_PREVIEW_ENV,
        SessionManager,
    )

    # the session knobs are env-backed per-session defaults
    # (SessionSpec.validate); the CLI flags pin the env for this server
    for flag, env_name in ((getattr(args, "session_budget", None), SESSION_BUDGET_ENV),
                           (getattr(args, "session_checkpoint_every", None), SESSION_CKPT_ENV),
                           (getattr(args, "session_preview", None), SESSION_PREVIEW_ENV)):
        if flag is not None:
            os.environ[env_name] = str(flag)

    serve_kwargs = {
        "retries": args.serve_retries,
        "fallback": args.serve_fallback,
        "fetch_deadline_ms": args.serve_deadline_ms or None,
        "nan_policy": args.serve_nan_policy,
    }
    # --trace DIR extends to the FLEET here: the router runs its own
    # tracer, every worker traces too, and shutdown dumps ONE merged
    # timeline next to the per-process artifacts
    trace_dir = getattr(args, "trace", None) or os.environ.get("NLHEAT_TRACE") or None
    # --slo pins the env so the WORKERS inherit it (the router's spawns
    # copy os.environ): one flag audits the whole fleet
    slo = getattr(args, "slo", None)
    if slo is not None:
        os.environ["NLHEAT_SLO"] = str(int(slo))
    # depth 1 per worker: the overlap a --serve depth buys in-process is
    # the fleet's job here (N workers ARE the in-flight chunks)
    with ReplicaRouter(replicas=args.replicas,
                       slo=(bool(slo) if slo is not None else None),
                       depth=1, window_ms=args.serve_window_ms,
                       serve_kwargs=serve_kwargs, trace_dir=trace_dir,
                       transport=getattr(args, "transport", None) or "pipe",
                       worker_token=getattr(args, "worker_token", None),
                       shard_threshold=getattr(args, "shard_threshold", None),
                       gang_devices=getattr(args, "gang_devices", None),
                       **engine_kwargs) as router:
        set_live_registry(router.registry)
        # the elastic loop: pull per-replica stats (absorbing each worker's
        # registry under /replica{r} for the scrape) and run the busy-rate
        # add/drain policy on a fixed cadence
        stop_scaling = threading.Event()

        def _scale_loop():
            while not stop_scaling.wait(10.0):
                try:
                    decision = router.maybe_scale()
                    if decision:
                        print(f"router: elastic {decision} -> "
                              f"{router.live_count()} replica(s)", file=sys.stderr)
                except Exception as e:  # noqa: BLE001 — scaling is advisory
                    print(f"router: stats/scale pull failed ({e})", file=sys.stderr)

        scaler = threading.Thread(target=_scale_loop, daemon=True,
                                  name="nlheat-router-scaler")
        scaler.start()
        # the session tier: one SessionManager over the same fleet, sharing
        # ONE admission controller with the ingress so the batch gate and
        # the session gate read the same budgets
        admission = AdmissionController(
            router, session_steps_per_s=getattr(args, "session_rate", None))
        sessions = SessionManager(
            router, admission=admission,
            checkpoint_dir=getattr(args, "session_checkpoint_dir", None),
            chunk_steps=getattr(args, "session_chunk", None) or 16)
        sessions.start_driver()
        try:
            with IngressServer(args.listen, router, admission=admission,
                               sessions=sessions) as ingress:
                print(f"ingress: http://127.0.0.1:{ingress.port}/v1/cases "
                      f"({args.replicas} replica(s); POST to submit, /v1/sessions opens "
                      "a live stream, /healthz, /v1/status, /metrics; EOF on stdin stops "
                      "the server)", file=sys.stderr, flush=True)
                for _line in sys.stdin:  # lifetime = stdin
                    pass
            # the ingress is CLOSED before the drain: new submissions must
            # stop landing or the shutdown drain could chase them forever
        finally:
            stop_scaling.set()
            sessions.close()
        router.drain()
        if trace_dir:
            merged = router.dump_fleet_trace(os.path.join(trace_dir, "fleet_trace.json"))
            if merged:
                print(f"fleet trace: {merged['events']} event(s) from "
                      f"{merged['processes']} process(es) -> {merged['path']}",
                      file=sys.stderr)
        line = _json.dumps(router.metrics())
        print(f"router: {line}", file=sys.stderr)
        set_metrics_payload(line)
    return 0


def add_obs_flags(p: argparse.ArgumentParser):
    """The obs/ surface shared by the solve CLIs: one trace directory, one
    metrics file, one scrape port (the JAX CLIs' flags and help, the
    device capture a torch.profiler one).  All three are opt-in; with none
    given the observability subsystem stays on its zero-cost disabled path.
    ``--flight-dir`` arms the crash flight recorder (obs/flightrec.py)."""
    p.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture the host-side span timeline (obs/trace.py) AND a torch.profiler "
             "device capture into DIR — DIR/host_trace.json plus the profiler's Chrome "
             "trace load side by side in ui.perfetto.dev (ambient NLHEAT_TRACE=DIR does the "
             "same)")
    p.add_argument(
        "--metrics-out", dest="metrics_out", default=None, metavar="FILE",
        help="atomically write the run's metrics JSON to FILE on exit (the same one-line "
             "dump --serve/--ensemble print to stderr; the obs registry snapshot "
             "otherwise); an unwritable path refuses loudly before the solve starts")
    p.add_argument(
        "--metrics-port", dest="metrics_port", type=int, default=None, metavar="PORT",
        help="serve Prometheus text at 127.0.0.1:PORT/metrics and the one-line JSON "
             "snapshot at /metrics.json while the run is live (PORT 0 picks a free port, "
             "printed to stderr); bound to the serving pipeline's registry during --serve")
    p.add_argument(
        "--flight-dir", dest="flight_dir", default=None, metavar="DIR",
        help="arm the crash flight recorder (obs/flightrec.py): a bounded black box of "
             "recent serve events, dumped to a timestamped postmortem JSON in DIR on "
             "quarantine, breaker open, or SIGTERM (ambient NLHEAT_FLIGHT_DIR=DIR does "
             "the same)")


def validate_obs_args(args) -> str | None:
    """The obs flags' checks in the JAX words (the caller prints the
    message and exits 1).  The --metrics-out probe runs BEFORE the solve: a
    typo'd path must refuse up front, not discard an hour of work at the
    final write."""
    port = getattr(args, "metrics_port", None)
    if port is not None and not 0 <= port <= 65535:
        return f"--metrics-port must be in [0, 65535] (got {port})"
    path = getattr(args, "metrics_out", None)
    if path:
        if os.path.isdir(path):
            # a sibling probe would pass but the final os.replace onto a
            # directory cannot — refuse now, not after the solve
            return f"--metrics-out {path!r} is a directory, not a file"
        # same-directory probe, the tmp naming of utils/checkpoint.atomic_file
        # (the final write reuses it), hostname included so ranks on hosts
        # sharing a filesystem never unlink each other's probe
        probe = f"{path}.tmp.probe.{socket.gethostname()}.{os.getpid()}"
        try:
            with open(probe, "w"):
                pass
            os.unlink(probe)
        except OSError as e:
            return f"--metrics-out {path!r} is not writable: {e}"
    if (getattr(args, "trace", None) or os.environ.get("NLHEAT_TRACE")) \
            and getattr(args, "profile", None):
        # two profiler captures cannot nest: --trace DIR already holds the
        # device capture (the words are the JAX CLI's)
        return ("--trace already captures the jax.profiler device "
                "timeline into its directory; drop --profile (or use "
                "--profile alone for a device-only capture)")
    return None


#: Holders obs_session reads at exit: the --metrics-out payload a batch
#: driver recorded (serve_batch / ensemble_runner), and the live registry
#: the --metrics-port endpoint follows while a pipeline runs.
_metrics_payload: list = [None]
_live_registry: list = [None]


def set_metrics_payload(line: str) -> None:
    """Record the metrics JSON --metrics-out should persist (the same line
    the batch drivers print to stderr)."""
    _metrics_payload[0] = line


def set_live_registry(registry) -> None:
    """Point the --metrics-port scrape endpoint at a live registry (the
    serving pipeline's / the ensemble report's own backing store, so a
    scrape mid-run and the final dump agree by construction)."""
    _live_registry[0] = registry


def _scrape_registry():
    if _live_registry[0] is not None:
        return _live_registry[0]
    from nonlocalheatequation_torch.obs.metrics import REGISTRY

    return REGISTRY


def publish_solve_metrics(tag: str, elapsed_s: float, points: int, steps: int,
                          error_l2=None) -> None:
    """Mirror one solo solve's outcome into the process registry
    (``/solve{tag}/...`` gauges) so --metrics-out and --metrics-port expose
    something meaningful on non-batch runs too.  Never raises."""
    try:
        from nonlocalheatequation_torch.obs.metrics import REGISTRY

        REGISTRY.gauge(f"/solve{{{tag}}}/elapsed-s").set(round(elapsed_s, 6))
        REGISTRY.gauge(f"/solve{{{tag}}}/points").set(int(points))
        REGISTRY.gauge(f"/solve{{{tag}}}/steps").set(int(steps))
        if error_l2 is not None:
            REGISTRY.gauge(f"/solve{{{tag}}}/error-l2").set(float(error_l2))
    except Exception:  # noqa: BLE001 — observability never raises
        pass


def _publish_batch_metrics(cases_n: int, failed: bool) -> None:
    """Mirror the batch verdict into the process registry so --metrics-out
    has a payload on the sequential path too (the serve/ensemble drivers
    record their full report instead).  Never raises."""
    try:
        from nonlocalheatequation_torch.obs.metrics import REGISTRY

        REGISTRY.gauge("/batch/cases").set(int(cases_n))
        REGISTRY.gauge("/batch/failed").set(int(failed))
    except Exception:  # noqa: BLE001 — observability never raises
        pass


@contextlib.contextmanager
def obs_session(args):
    """The observability lifecycle shared by the solve CLIs: install the
    span tracer and the torch.profiler capture under one ``--trace DIR``,
    start the ``--metrics-port`` scrape endpoint, arm the ``--flight-dir``
    flight recorder, and persist ``--metrics-out`` atomically on the way out.

    ``--trace DIR`` captures BOTH timelines into the same directory — the
    host-side spans as ``DIR/host_trace.json`` (``host_trace.rank{r}.json``
    on a rank r > 0 of a multi-process run) and the device-side
    torch.profiler trace (utils/profiling.py, around the body) — so one
    Perfetto session shows dispatch scheduling above the kernels.  A failed
    trace write or a dead scrape endpoint never fails the solve; only the
    --metrics-out write the user explicitly asked for exits non-zero when
    it cannot land."""
    from nonlocalheatequation_torch.obs import trace as obs_trace
    from nonlocalheatequation_torch.utils import profiling

    trace_dir = getattr(args, "trace", None) or os.environ.get("NLHEAT_TRACE") or None
    _metrics_payload[0] = None
    _live_registry[0] = None
    tracer = prev = server = None
    if trace_dir:
        try:
            os.makedirs(trace_dir, exist_ok=True)
        except OSError as e:
            print(f"[obs] --trace {trace_dir!r} cannot be created ({e}); "
                  "tracing disabled", file=sys.stderr)
            trace_dir = None
        else:
            tracer = obs_trace.Tracer()
            prev = obs_trace.set_tracer(tracer)
    port = getattr(args, "metrics_port", None)
    if port is not None:
        try:
            from nonlocalheatequation_torch.obs.export import serve_metrics

            server = serve_metrics(port, _scrape_registry)
            print(f"metrics: http://127.0.0.1:{server.port}/metrics "
                  "(Prometheus) and /metrics.json", file=sys.stderr)
        except OSError as e:
            print(f"[obs] --metrics-port {port} cannot bind ({e}); "
                  "scrape endpoint disabled", file=sys.stderr)
    # the crash flight recorder (obs/flightrec.py): installed process-wide so
    # the serving pipeline picks it up at construction; SIGTERM dumps the
    # black box before the previous handler runs.  The previous recorder
    # and handler are restored on exit.
    recorder = prev_rec = prev_sigterm = None
    flight_dir = getattr(args, "flight_dir", None) or os.environ.get("NLHEAT_FLIGHT_DIR") or None
    if flight_dir:
        try:
            recorder = flightrec.FlightRecorder(flight_dir)
        except OSError as e:
            print(f"[obs] --flight-dir {flight_dir!r} cannot be used ({e}); flight recorder "
                  "disabled", file=sys.stderr)
        else:
            prev_rec = flightrec.set_recorder(recorder)
            try:
                prev_sigterm = signal.getsignal(signal.SIGTERM)
            except (ValueError, OSError):
                prev_sigterm = None
            recorder.bind(registry=_scrape_registry)
            flightrec.install_sigterm(recorder)
    body_raised = False
    try:
        with profiling.trace(trace_dir):
            yield
    except BaseException:
        body_raised = True
        raise
    finally:
        if tracer is not None:
            obs_trace.set_tracer(prev)
            from nonlocalheatequation_torch.parallel import multihost

            # a rank > 0 of a multi-process run gets its own file:
            # concurrent ranks must not clobber rank 0's
            rank = multihost.process_index()
            name = f"host_trace.rank{rank}.json" if rank else "host_trace.json"
            out = os.path.join(trace_dir, name)
            if tracer.write(out):
                print(f"trace: {len(tracer)} spans ({tracer.spans_total} lifetime) -> {out}",
                      file=sys.stderr)
        if server is not None:
            server.close()
        if recorder is not None:
            flightrec.set_recorder(prev_rec)
            if prev_sigterm is not None:
                try:  # the handler must not outlive its session
                    signal.signal(signal.SIGTERM, prev_sigterm)
                except (ValueError, OSError, TypeError):
                    pass
        path = getattr(args, "metrics_out", None)
        if path:
            payload = _metrics_payload[0]
            if payload is None:
                payload = _scrape_registry().snapshot_json()
            from nonlocalheatequation_torch.utils.checkpoint import atomic_write_text

            try:
                atomic_write_text(path, payload + "\n")
                print(f"metrics written to {path}", file=sys.stderr)
            except OSError as e:
                # validated up front, so this is a mid-run filesystem
                # change — still refuse loudly; but never MASK an
                # exception already propagating out of the solve body
                print(f"--metrics-out {path!r} failed: {e}", file=sys.stderr)
                if not body_raised:
                    raise SystemExit(1) from None


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
              profile=None, multi: bool = False, run_serve=None):
    """The reference's batch_tester protocol.  ``read_case`` parses one row
    of ``row_tokens`` tokens; ``run_case(case) -> (error_l2, n)``.  Every
    row is validated before any solve runs.  With ``run_ensemble`` (a
    callable ``cases -> [(error_l2, n)]``, :func:`ensemble_runner`) the
    cases go to the ensemble engine as one submission, under the same pass
    criterion, instead of the sequential loop.  With ``run_serve`` (a
    callable ``case_iter -> [(error_l2, n)]``, :func:`serve_batch`) the
    cases STREAM: rows are parsed as stdin lines arrive
    (:func:`iter_batch_cases`) and handed to the serving pipeline
    incrementally — the only mode that does not validate the whole stream
    before work starts, because starting work before EOF is its point (a
    malformed later row still refuses loudly).  With ``profile`` (a
    directory) the whole batch, sequential, ensemble or served, runs under
    one ``torch.profiler`` capture (utils/profiling.py).  Under a
    multi-process launch (``multi``) every rank reads the whole stream
    first and the ranks' token streams must be identical (the ``"batch
    input"`` digest), or every rank fails; so streaming refuses several
    ranks.  Returns the exit code."""
    from nonlocalheatequation_torch.utils import profiling

    if run_serve is not None:
        if multi:
            raise SystemExit(
                "--serve streams stdin incrementally and cannot verify "
                "rank-identical input; run serving single-process")
        with profiling.trace(profile):
            results = run_serve(iter_batch_cases(read_case, row_tokens))
        failed = any(error_l2 / n > threshold for error_l2, n in results)
        _publish_batch_metrics(len(results), failed)
        print("Tests Failed" if failed else "Tests Passed")
        return 1 if failed else 0
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
    _publish_batch_metrics(len(cases), failed)
    print("Tests Failed" if failed else "Tests Passed")
    return 1 if failed else 0
