"""Fault-tolerance primitives for the serving pipeline — the port's copy of
``nonlocalheatequation_tpu/serve/resilience.py``.

The request path (serve/server.py) meets three failure modes on the card: a
dispatch that raises (a CUDA error out of a kernel wrapper), a fetch that
never returns, and a buffer that comes back corrupted.  This module gives it
the three answers, in-process:

* :class:`ServeError` — the typed exception a poisoned request's
  ``wait()`` raises, carrying the fault classification
  ("error" / "hang" / "corrupt"), the case seq, and the attempt count.
* :class:`CircuitBreaker` — the health state machine: ``closed`` ->
  ``open`` after K consecutive device-path failures -> ``half-open``
  probe once a cooldown elapses -> ``closed`` again on probe success
  (or straight back to ``open`` on probe failure).  While open, the
  pipeline routes chunks through the CPU fallback below.  The clock is
  injectable, so the tests drive every transition with a virtual timer.
* :class:`CpuFallback` — a CPU chunk runner reusing the engine's stage
  split (pad/build/stage/dispatch): a sibling
  :class:`~nonlocalheatequation_torch.serve.ensemble.EnsembleEngine` with
  ``device="cpu"`` per method, pinned to the plain PyTorch composition of
  the same operator (shift in 1D, conv in 2D, sat in 3D; fft passes
  through, as the JAX package's ``_SAFE``/``_XLA_METHODS`` rule does).  On
  the card its results are close to the card's, not bitwise (another
  summation order); on the CPU, where the engine's own chunks run the same
  plain composition, they are bitwise the device path's.

Threading note: like the pipeline itself, everything here runs on the
scheduler thread; the only thread ever created is the supervisor's fetch
watchdog (serve/server.py), and a genuinely hung fetch is ABANDONED
(a daemon thread), never killed.
"""

from __future__ import annotations

import time
from collections import deque

#: Fault classifications the supervisor assigns to a failed attempt.
CLASS_ERROR = "error"  # dispatch/fetch raised
CLASS_HANG = "hang"  # fetch missed its deadline
CLASS_CORRUPT = "corrupt"  # fetched buffer failed the finite scan

#: Breaker states.
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

#: Bound on the retained transition trail (mirrors server.LOG_CAP, which
#: cannot be imported here — server.py imports this module).  A breaker
#: flapping open/half-open/open against a persistently dead device makes
#: one transition pair per cooldown forever; the metrics dump keeps the
#: most recent window plus a lifetime-exact ``transition_count``.
TRANSITION_CAP = 4096


class ServeError(RuntimeError):
    """A request that completed exceptionally: its case was isolated as
    the poison member of a failing chunk (or failed alone) after the
    retry budget.  ``classification`` is one of CLASS_ERROR/HANG/CORRUPT;
    ``detail`` carries the last underlying exception's text, if any."""

    def __init__(self, classification: str, case_seq: int, chunk_id: int,
                 attempts: int, detail: str = ""):
        msg = (f"case {case_seq} quarantined after {attempts} attempts "
               f"(chunk {chunk_id}, classified {classification!r}")
        if detail:
            msg += f": {detail}"
        super().__init__(msg + ")")
        self.classification = classification
        self.case_seq = case_seq
        self.chunk_id = chunk_id
        self.attempts = attempts
        self.detail = detail


class CircuitBreaker:
    """closed -> open on K consecutive device-path failures -> half-open
    probe after ``cooldown_ms`` -> closed on probe success.

    ``route()`` answers "device" or "fallback" for the NEXT chunk
    execution; in half-open exactly ONE probe is routed to the device
    (others keep the fallback until the probe's outcome lands — the
    pipeline may have several chunks in motion between a probe's
    dispatch and its retire).  When the device route IS the probe,
    ``routed_probe`` is True until the next ``route()`` call — the
    caller tags that chunk and passes ``probe=`` back to the outcome
    recorders, so a STALE device chunk (dispatched before the breaker
    opened, retiring while half-open) can never settle the probe for
    it.  ``transitions`` is the timestamped audit trail
    ServeReport.metrics() surfaces — the most recent
    :data:`TRANSITION_CAP` entries; ``transition_count`` is
    lifetime-exact.
    """

    def __init__(self, threshold: int = 3, cooldown_ms: float = 5000.0,
                 clock=time.monotonic):
        threshold = int(threshold)
        if threshold < 1:
            raise ValueError(f"breaker threshold must be >= 1, got "
                             f"{threshold}")
        if cooldown_ms < 0:
            raise ValueError(f"breaker cooldown_ms must be >= 0, got "
                             f"{cooldown_ms}")
        self.threshold = threshold
        self.cooldown_s = cooldown_ms / 1e3
        self._clock = clock
        self.state = CLOSED
        self.failures = 0  # consecutive device-path failures
        self.opened_t: float | None = None
        self.probe_inflight = False
        self.routed_probe = False  # last route() handed out the probe
        self.transitions: deque = deque(maxlen=TRANSITION_CAP)
        self.transition_count = 0  # lifetime-exact
        #: Optional ``(from_state, to_state, t)`` callback the serving
        #: pipeline installs to mirror transitions into the obs
        #: subsystem (registry counter, trace instant, event log).
        #: Exceptions are swallowed — observability never fails a route.
        self.on_transition = None

    def _move(self, to: str) -> None:
        frm = self.state
        t = self._clock()
        self.transitions.append({"t": t, "from": frm, "to": to})
        self.transition_count += 1
        self.state = to
        cb = self.on_transition
        if cb is not None:
            try:
                cb(frm, to, t)
            except Exception:  # noqa: BLE001 — observability never raises
                pass

    def route(self) -> str:
        self.routed_probe = False
        if self.state == CLOSED:
            return "device"
        if self.state == OPEN:
            if self._clock() >= self.opened_t + self.cooldown_s:
                self._move(HALF_OPEN)
                self.probe_inflight = True
                self.routed_probe = True
                return "device"  # the probe
            return "fallback"
        # half-open: one probe at a time
        if not self.probe_inflight:
            self.probe_inflight = True
            self.routed_probe = True
            return "device"
        return "fallback"

    def record_success(self, probe: bool = True) -> None:
        """A device-path attempt completed ok.  ``probe=False`` marks a
        stale chunk's outcome (device-routed before the breaker opened):
        it clears the failure streak but never settles a half-open
        probe."""
        self.failures = 0
        if self.state == HALF_OPEN and probe:
            self.probe_inflight = False
            self._move(CLOSED)

    def record_failure(self, probe: bool = True) -> None:
        """A device-path attempt failed in a way that attests to device
        ill-health (the pipeline reports error/hang here; corrupt is
        data-shaped and never reaches the breaker).  ``probe=False``
        marks a stale chunk's outcome: it feeds the failure streak but
        only the probe's own failure re-opens a half-open breaker."""
        self.failures += 1
        if self.state == HALF_OPEN:
            if probe:
                self.probe_inflight = False
                self.opened_t = self._clock()
                self._move(OPEN)
        elif self.state == CLOSED and self.failures >= self.threshold:
            self.opened_t = self._clock()
            self._move(OPEN)


class CpuFallback:
    """Run a padded chunk on the CPU via the engine's own stage split.
    Built lazily by the pipeline (the happy path never pays for it); keeps
    its own per-method sibling engines so fallback program caches never
    collide with the device engine's."""

    #: The plain PyTorch composition per dimensionality (the off-card
    #: ``auto`` picks of ops/nonlocal_op.py).  A 1D key keeps ``auto``: a 1D
    #: grid engine maps every method but fft to shift, and a mesh bucket
    #: runs its gather tier's plain version on the CPU.  ``cuda`` must not
    #: leak into the fallback: it names the card's kernels.  fft is a plain
    #: composition too (and the only method an expo-stepper engine can run
    #: at all), so it passes through unchanged.
    _SAFE = {2: "conv", 3: "sat"}
    _PLAIN_METHODS = ("conv", "shift", "sat", "fft")

    def __init__(self, engine):
        self.engine = engine
        self._engines: dict = {}

    def _sibling(self, dim: int):
        e = self.engine
        method = (e.method if e.method in self._PLAIN_METHODS
                  else self._SAFE.get(dim, "auto"))
        sib = self._engines.get(method)
        if sib is None:
            # variant pinned to "auto": the carried/superstep schedules are
            # the card's kernels and refuse elsewhere; comm pinned to
            # "collective": the fused halo engine is cuda-only and a
            # fallback chunk runs on one device anyway
            sib = self._engines[method] = e.sibling(device="cpu", method=method,
                                                    variant="auto",
                                                    comm="collective")
        return sib

    def run_chunk(self, key, padded):
        """Build + stage + dispatch + fetch the chunk on the CPU.  The fetch
        IS the fence here (a CPU tensor's ``numpy()``), so a fallback chunk
        completes synchronously — there is nothing to overlap and nothing
        that can wedge."""
        sib = self._sibling(len(key[0]))
        multi = sib.build_program(key, padded)
        U0 = sib.stage_inputs(padded)
        return sib.dispatch_chunk(multi, U0).numpy()
