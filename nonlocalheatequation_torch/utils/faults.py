"""Deterministic fault injection for the serving stack — the port's copy of
``nonlocalheatequation_tpu/utils/faults.py`` (the same grammar, entries and
firing rules).

The device path's real failure modes — a launch that raises (a CUDA error
out of a kernel wrapper), a fetch that never returns, and a buffer that
comes back corrupted — cannot be scheduled on demand, and wall-clock fault
schedules flake under host load.  This module is a seed-free, PLAN-driven
injector that makes the supervised pipeline (serve/server.py) observe each
failure mode at chosen points, so the tests drive every breaker transition
and every quarantine path on the CPU with no card.

Plan grammar (env ``NLHEAT_FAULT_PLAN`` or an injected :class:`FaultPlan`)::

    plan  := entry ("," entry)*
    entry := kind "@" target ["x" count]
    kind  := "raise" | "stall" | "nan" | "die"
    target:= INT          -- fires at that dispatch-attempt index (the
                             plan's own 0-based counter of chunk
                             execution attempts, retries and fallback
                             attempts included)
           | "c" INT      -- fires whenever a chunk containing the case
                             with that submission seq executes (the
                             poison-case form: it follows the case
                             through retries and bisection)
    count := INT | "*"    -- how many times the entry fires (default 1).
                             Attempt-targeted entries fire at the N
                             CONSECUTIVE attempt indices starting at the
                             target ("*" = every attempt from the target
                             on) — a global attempt index passes exactly
                             once, so "fire the same index N times" would
                             be unsatisfiable; case-targeted entries fire
                             the first N times their case executes ("*"
                             = every time).

Examples: ``raise@1`` (the second dispatch attempt raises once),
``raise@1x2`` (attempts 1 AND 2 raise — with a depth-1 schedule that is
an attempt and its immediate retry), ``stall@3,nan@5`` (transient hang
then transient corruption), ``nan@c6x*`` (case 6 is poison: its chunk's
fetch is NaN-corrupted every time, driving bisection down to the single
case).

Fault semantics at the pipeline's stages:

* ``raise`` fires in the DISPATCH stage (:class:`InjectedFault`, the
  stand-in for a runtime error out of the device path);
* ``stall`` fires in the FETCH stage: the fetch blocks on an
  :class:`threading.Event` that only the supervisor's hang
  classification (or ``release_stalls``) sets — the stall can never
  "finish early" under host load, so the deadline path is exercised
  deterministically in OUTCOME even though the deadline itself is a
  real ``Thread.join`` timeout;
* ``nan`` fires in the FETCH stage: the fetched buffer's lane for the
  targeted case (lane 0 for attempt-indexed entries) is overwritten
  with NaN before the supervisor's finite scan sees it.
* ``die`` is the FLEET-level kind: in the JAX package the replica router
  (serve/router.py, not ported yet) fires it at its case-forward events
  and kills the worker process the case was routed to.  The in-process
  pipeline ignores armed ``die`` entries, as the JAX one does: a worker
  killing itself from inside its own scheduler would race the router's
  reader thread.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

import numpy as np

KINDS = ("raise", "stall", "nan", "die")

#: Env var holding the plan spec (tests/conftest.py scrubs it: a leaked plan
#: must never corrupt a test run).
PLAN_ENV = "NLHEAT_FAULT_PLAN"


class InjectedFault(RuntimeError):
    """The injected stand-in for a device-path runtime error."""

    def __init__(self, entry: "_Entry", attempt: int):
        super().__init__(
            f"injected {entry.kind!r} fault at dispatch attempt {attempt} "
            f"({entry.describe()})")
        self.kind = entry.kind
        self.attempt = attempt


@dataclass
class _Entry:
    kind: str
    attempt: int | None = None  # dispatch-attempt index target
    case: int | None = None  # case-seq target
    count: float = 1  # total firings declared (inf for "x*")
    left: float = 1  # remaining firings (case-targeted budget)

    def matches(self, attempt: int, case_seqs) -> bool:
        if self.attempt is not None:
            # attempt-targeted: the count is a RANGE of consecutive
            # attempt indices [target, target + count) — each global
            # index passes exactly once, so a per-index budget would be
            # unsatisfiable past 1 (module docstring)
            return self.attempt <= attempt < self.attempt + self.count
        return self.left > 0 and self.case in case_seqs

    def consume(self) -> None:
        self.left -= 1

    def describe(self) -> str:
        tgt = (f"c{self.case}" if self.case is not None else
               str(self.attempt))
        if self.count == 1:
            return f"{self.kind}@{tgt}"
        n = "*" if self.count == float("inf") else int(self.count)
        return f"{self.kind}@{tgt}x{n}"


@dataclass
class FiredFaults:
    """What :meth:`FaultPlan.draw` armed for one execution attempt."""

    raise_: _Entry | None = None
    stall: threading.Event | None = None
    nan: _Entry | None = None
    die: _Entry | None = None  # fleet-level: the pipeline ignores it

    def any(self) -> bool:
        return bool(self.raise_ or self.stall or self.nan or self.die)


#: The no-faults singleton the unplanned pipeline uses.
NO_FAULTS = FiredFaults()


@dataclass
class FaultPlan:
    """A parsed plan plus the attempt counter and stall bookkeeping."""

    entries: list = field(default_factory=list)
    spec: str = ""
    attempt: int = 0
    fired_log: list = field(default_factory=list)
    _stalls: list = field(default_factory=list)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        entries = []
        for raw in spec.split(","):
            raw = raw.strip()
            if not raw:
                continue
            try:
                kind, _, target = raw.partition("@")
                if kind not in KINDS:
                    raise ValueError(f"unknown fault kind {kind!r}")
                if not target:
                    raise ValueError("missing @target")
                count = 1.0
                if "x" in target:
                    target, _, cnt = target.partition("x")
                    count = float("inf") if cnt == "*" else float(int(cnt))
                    if count < 1:
                        raise ValueError(f"count {cnt!r} < 1")
                if target.startswith("c"):
                    entries.append(_Entry(kind, case=int(target[1:]),
                                          count=count, left=count))
                else:
                    entries.append(_Entry(kind, attempt=int(target),
                                          count=count, left=count))
            except ValueError as e:
                raise ValueError(
                    f"bad fault-plan entry {raw!r} in {spec!r} (grammar: "
                    f"kind@target[xN], kind in {KINDS}, target an attempt "
                    f"index or cCASE_SEQ, N an int or '*'): {e}") from None
        if not entries:
            raise ValueError(f"fault plan {spec!r} declares no entries")
        return cls(entries=entries, spec=spec)

    @classmethod
    def from_env(cls, environ=os.environ) -> "FaultPlan | None":
        spec = environ.get(PLAN_ENV)
        return cls.parse(spec) if spec else None

    def draw(self, case_seqs) -> FiredFaults:
        """Arm the faults for the next execution attempt (consuming one
        firing from each matching entry; first match per kind wins)."""
        i = self.attempt
        self.attempt += 1
        fired = FiredFaults()
        for e in self.entries:
            if getattr(fired, "raise_" if e.kind == "raise" else e.kind):
                continue
            if not e.matches(i, case_seqs):
                continue
            e.consume()
            self.fired_log.append(
                {"attempt": i, "kind": e.kind, "entry": e.describe()})
            if e.kind == "raise":
                fired.raise_ = e
            elif e.kind == "stall":
                ev = threading.Event()
                self._stalls.append(ev)
                fired.stall = ev
            elif e.kind == "die":
                fired.die = e
            else:
                fired.nan = e
        return fired

    def release_stalls(self) -> None:
        """Unblock every armed/active stall (the supervisor calls this
        after classifying a hang, and the pipeline at close, so injected
        stalls never leak a blocked thread past the test)."""
        for ev in self._stalls:
            ev.set()

    def apply_nan(self, fired: FiredFaults, vals: np.ndarray,
                  case_seqs) -> np.ndarray:
        """Corrupt the fetched buffer per the armed nan fault: the
        targeted case's lane (lane 0 for attempt-indexed entries)."""
        if fired.nan is None:
            return vals
        lane = 0
        if fired.nan.case is not None and fired.nan.case in case_seqs:
            lane = list(case_seqs).index(fired.nan.case)
        vals = np.array(vals)  # never corrupt a buffer someone else holds
        vals[lane] = np.nan
        return vals
