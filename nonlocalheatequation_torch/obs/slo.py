"""SLO promise-audit ledger: join the picker's promise to the outcome — the
port's copy of ``nonlocalheatequation_tpu/obs/slo.py``.

The serving stack makes auditable PROMISES at the front door: a picked
request carries the engine, the step schedule, the modeled cost
(``EngineChoice.est_ms``) and the client's deadline (serve/picker.py).  This
module joins each promise to the observed outcome, in the reference's
spirit of measurement driving decisions (the HPX idle-rate counters
balancing the work):

* :class:`SloLedger` — a per-request ledger.  ``promise()`` records the
  evidence at submit time (engine axis, modeled cost, deadline);
  ``resolve()`` joins the outcome (queue wait, device wall, e2e latency,
  error class, measured error when the caller has the manufactured
  oracle) exactly once — a second resolve for the same seq is counted
  (``/slo/duplicate``) and dropped, an unknown seq is counted
  (``/slo/unmatched``).  Everything lands in the bound registry under
  ``/slo/*``: hit/miss counters, a rolling burn-rate window,
  latency/queue/device histograms, and per-engine-axis (stepper x stages x
  method x precision [x mesh]) hit/miss tables.
* **Drift detector** — every resolve with both a modeled and an observed
  cost feeds a windowed modeled-vs-observed ratio; when the window's p50
  leaves the configured band the ledger warns LOUDLY once per excursion
  (EventLog line + flight-recorder note + ``/slo/drift-warnings``) and
  keeps ``/slo/drift`` pinned to the live p50.
* :class:`LiveRateRecorder` — live recalibration: observed per-apply
  milliseconds from retired chunks flow back into the port's tuner file
  cache (utils/autotune.py, ``NLHEAT_AUTOTUNE_CACHE``) as EWMA ``live``
  entries, under the key grammar of ``autotune.record_key`` that
  ``tuning_key`` and the picker's ``record_rate_fn`` share.  Records are
  buffered and merged on write in batches; ``""`` disables persistence
  (the suite's pin).

Zero-fence discipline: the ledger only consumes timestamps the scheduler
already took — ``promise``/``resolve`` take explicit times, never read a
device, never fence.  The disabled path in every instrumented component is
ONE attribute read (``self._slo is None``).  Ledger methods never raise
past argument errors: observability must not take the serving path down.

Env knobs (scrubbed in tests/conftest.py): ``NLHEAT_SLO=1`` enables the
ledger on pipelines built with the default ``slo=None``;
``NLHEAT_SLO_BAND=lo,hi`` the drift band (default ``0.25,4.0``: generous,
because analytic-rate promises are honest only to the order of
magnitude, serve/picker.py); ``NLHEAT_SLO_WINDOW`` the burn/drift window
(default 256); ``NLHEAT_SLO_MIN`` the minimum drift samples before a
warning can fire (default 8); ``NLHEAT_SLO_LIVE=0`` disables the live rate
write-back independently of the ledger.
"""

from __future__ import annotations

import math
import os
import threading
import time

from nonlocalheatequation_torch.obs import flightrec
from nonlocalheatequation_torch.obs.export import EventLog
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry

#: Default rolling window for the burn-rate and drift ratios
#: (NLHEAT_SLO_WINDOW overrides).
DEFAULT_WINDOW = 256

#: Default modeled-vs-observed drift band (NLHEAT_SLO_BAND overrides):
#: the window p50 of observed_ms/modeled_ms must stay inside [lo, hi].
#: Generous by design — analytic-rate promises are honest only to the
#: order of magnitude (serve/picker.py cost-model note); record/live
#: rates sit well inside.
DEFAULT_BAND = (0.25, 4.0)

#: Minimum drift-window samples before a warning can fire
#: (NLHEAT_SLO_MIN overrides): a first slow compile-adjacent chunk must
#: not page anyone.
DEFAULT_MIN_SAMPLES = 8

#: Live write-back flush cadence: records buffered per key are merged
#: into the autotune file cache every this-many observations (and at
#: close()).  Bounds file I/O to O(chunks / cadence).
LIVE_FLUSH_EVERY = 32

#: EWMA weight of one new observation in the live per-apply rate: heavy
#: enough to converge in a few chunks, light enough that one noisy
#: chunk cannot swing the persisted rate.
LIVE_ALPHA = 0.25


def _env_float_pair(name: str, default: tuple) -> tuple:
    env = os.environ.get(name)
    if not env:
        return default
    try:
        lo, hi = (float(t) for t in env.split(","))
    except ValueError:
        raise ValueError(
            f"{name} must be 'lo,hi' floats, got {env!r}") from None
    if not (0 < lo < hi):
        raise ValueError(f"{name} needs 0 < lo < hi, got {env!r}")
    return (lo, hi)


def _env_int(name: str, default: int, floor: int = 1) -> int:
    env = os.environ.get(name)
    if not env:
        return default
    try:
        v = int(env)
    except ValueError:
        raise ValueError(f"{name} must be an int, got {env!r}") from None
    if v < floor:
        raise ValueError(f"{name} must be >= {floor}, got {env!r}")
    return v


def engine_axis(engine_sel, mesh=None) -> str:
    """The per-engine-axis table label: ``stepper[s=N]/method/precision``
    (the picker's refusal-message format) from an engine-pool key tuple
    (serve/picker.py ``EngineChoice.key()``), ``"default"`` for None,
    with the mesh hash prefix appended for mesh-keyed cases."""
    if engine_sel is None:
        label = "default"
    else:
        stepper, stages, method, precision = engine_sel
        label = f"{stepper}[s={stages}]/{method}/{precision}"
    if mesh:
        label = f"{label}/mesh-{str(mesh)[:12]}"
    return label


def applies_per_step(stepper: str, stages: int) -> float:
    """Operator applies per step for the live per-apply rate: the
    picker's cost-model convention (serve/picker.py — s for rkc, ~3.5
    fft-equivalents per corrected expo substage, 1 otherwise)."""
    if stepper == "rkc":
        return float(max(1, int(stages)))
    if stepper == "expo":
        return 3.5 * max(1, int(stages))
    return 1.0


class LiveRateRecorder:
    """EWMA observed per-apply rates, persisted into the port's tuner
    records (utils/autotune.py file cache) under the tuner's key grammar
    (``autotune.record_key``), as each entry's ``live`` block:
    ``{"per-step": <ewma ms>, "n": <count>, "provenance": "live"}``.
    The block is DISJOINT from ``ms_per_step`` on purpose: the tuner's
    winner election must keep ranking only candidates it probed, while
    :func:`~nonlocalheatequation_torch.serve.picker.record_rate_fn`
    prefers the live block when present.  Buffered; ``flush()`` merges
    on write (autotune's own concurrency rule).  All methods swallow
    I/O errors — recalibration is an optimization, never a crash."""

    def __init__(self, device_kind: str, dtype_name: str = "float32",
                 version: str | None = None, alpha: float = LIVE_ALPHA,
                 flush_every: int = LIVE_FLUSH_EVERY):
        self.device_kind = str(device_kind)
        self.dtype_name = str(dtype_name)
        #: the key's first field (None: the kernels' digest, as the tuner keys)
        self.version = version
        self.alpha = float(alpha)
        self.flush_every = max(1, int(flush_every))
        self._lock = threading.Lock()
        # guarded_by: self._lock
        self._acc: dict = {}  # key -> {"ms": ewma, "n": int}
        # guarded_by: self._lock
        self._pending = 0
        self._seeded: set = set()  # guarded_by: self._lock

    def key(self, method: str, shape, eps: int, precision: str) -> str:
        """The tuner record key this observation recalibrates — built by
        ``autotune.record_key``, as the picker's record_rate_fn and the
        tuner's ``tuning_key`` (method ``cuda``) build theirs."""
        from nonlocalheatequation_torch.utils.autotune import record_key

        return record_key(self.device_kind, method, shape, eps, self.dtype_name, precision,
                          version=self.version)

    def record(self, method: str, shape, eps: int, precision: str,
               ms_per_apply: float) -> None:
        """Fold one observed per-apply rate into the key's EWMA; flush
        to the file cache every ``flush_every`` observations."""
        if not (isinstance(ms_per_apply, (int, float))
                and math.isfinite(ms_per_apply) and ms_per_apply > 0):
            return
        k = self.key(method, shape, eps, precision)
        with self._lock:
            slot = self._acc.get(k)
            if slot is None:
                seed = self._persisted_rate(k)
                if seed is not None:
                    slot = {"ms": seed, "n": 0}
                else:
                    slot = {"ms": float(ms_per_apply), "n": 0}
                    self._acc[k] = slot
                    slot["n"] = 1
                    self._pending += 1
                    if self._pending >= self.flush_every:
                        self._flush_locked()
                    return
                self._acc[k] = slot
            slot["ms"] += self.alpha * (float(ms_per_apply) - slot["ms"])
            slot["n"] += 1
            self._pending += 1
            if self._pending >= self.flush_every:
                self._flush_locked()

    def _persisted_rate(self, key: str) -> float | None:
        """Seed a fresh EWMA from a previously persisted live rate so
        recalibration accumulates across process lifetimes."""
        if key in self._seeded:
            return None
        self._seeded.add(key)
        try:
            from nonlocalheatequation_torch.utils.autotune import (
                _load_file_cache,
            )

            live = (_load_file_cache().get(key) or {}).get("live") or {}
            ms = live.get("per-step")
            if isinstance(ms, (int, float)) and not isinstance(ms, bool):
                return float(ms)
        except Exception:  # noqa: BLE001 — a broken cache seeds nothing
            pass
        return None

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def _flush_locked(self) -> None:
        # guarded_by: self._lock (callers hold it)
        self._pending = 0
        if not self._acc:
            return
        try:
            from nonlocalheatequation_torch.utils.autotune import (
                _cache_path,
                _load_file_cache,
                _store_file_cache,
            )

            if _cache_path() is None:
                return  # persistence disabled (NLHEAT_AUTOTUNE_CACHE="")
            cache = _load_file_cache()
            out = {}
            for k, slot in self._acc.items():
                entry = dict(cache.get(k) or {})
                prev_n = int((entry.get("live") or {}).get("n") or 0)
                entry["live"] = {"per-step": round(slot["ms"], 6),
                                 "n": prev_n + slot["n"],
                                 "provenance": "live"}
                out[k] = entry
                slot["n"] = 0
            _store_file_cache(out)  # merge-on-write with other keys
        except Exception:  # noqa: BLE001 — never take serving down
            pass


class SloLedger:
    """The per-request promise/outcome join (module docstring).  Built
    over a :class:`~nonlocalheatequation_torch.obs.metrics.MetricsRegistry`
    so every signal is scrapeable (``/slo/*``).  Thread-safe: a resolve
    may come from another thread than the promise."""

    def __init__(self, registry: MetricsRegistry | None = None, *,
                 clock=time.monotonic, window: int | None = None,
                 band: tuple | None = None,
                 min_samples: int | None = None,
                 live: LiveRateRecorder | bool | None = None,
                 events: EventLog | None = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._clock = clock
        self.window = window if window is not None \
            else _env_int("NLHEAT_SLO_WINDOW", DEFAULT_WINDOW)
        self.band = tuple(band) if band is not None \
            else _env_float_pair("NLHEAT_SLO_BAND", DEFAULT_BAND)
        self.min_samples = min_samples if min_samples is not None \
            else _env_int("NLHEAT_SLO_MIN", DEFAULT_MIN_SAMPLES)
        #: live recalibration sink: a prebuilt LiveRateRecorder, or None
        #: (False / NLHEAT_SLO_LIVE=0 also disable; True defers to the
        #: owner, which builds one lazily once it knows its device kind)
        if live is False or os.environ.get("NLHEAT_SLO_LIVE") == "0":
            self.live = None
            self._live_wanted = False
        else:
            self.live = live if isinstance(live, LiveRateRecorder) else None
            self._live_wanted = True
        self._events = events if events is not None else EventLog.from_env()
        self._lock = threading.Lock()
        # guarded_by: self._lock
        self._open: dict = {}  # seq -> promise record
        # guarded_by: self._lock
        self._burn = []  # rolling 0/1 deadline-miss window
        # guarded_by: self._lock
        self._ratios = []  # rolling observed/modeled cost ratios
        # guarded_by: self._lock
        self._drift_excursion = False
        r = self.registry
        self._c_promised = r.counter("/slo/promised")
        self._c_resolved = r.counter("/slo/resolved")
        self._c_hit = r.counter("/slo/deadline-hit")
        self._c_miss = r.counter("/slo/deadline-miss")
        self._c_errors = r.counter("/slo/errors")
        self._c_dup = r.counter("/slo/duplicate")
        self._c_unmatched = r.counter("/slo/unmatched")
        self._c_drift_warn = r.counter("/slo/drift-warnings")
        self._g_burn = r.gauge("/slo/burn")
        self._g_drift = r.gauge("/slo/drift")
        self._g_open = r.gauge("/slo/open")
        self._h_e2e = r.histogram("/slo/e2e-ms", window=self.window)
        self._h_queue = r.histogram("/slo/queue-wait-ms",
                                    window=self.window)
        self._h_device = r.histogram("/slo/device-ms", window=self.window)
        self._h_ratio = r.histogram("/slo/cost-ratio", window=self.window)
        self._h_err = r.histogram("/slo/measured-err", window=self.window)
        self._l_axis_req = r.labeled("/slo/axis-requests")
        self._l_axis_hit = r.labeled("/slo/axis-hit")
        self._l_axis_miss = r.labeled("/slo/axis-miss")

    # -- construction helpers ------------------------------------------------
    @classmethod
    def from_arg(cls, arg, *, registry=None, clock=time.monotonic,
                 live=None):
        """The component-ctor contract (ServePipeline / ReplicaRouter
        ``slo=`` kwarg): an :class:`SloLedger` is used as-is, ``True``
        builds one, ``False`` disables, ``None`` defers to the
        ``NLHEAT_SLO=1`` env knob.  Returns the ledger or None — the
        disabled path every instrumented site guards with one attribute
        read."""
        if isinstance(arg, cls):
            return arg
        if arg is False:
            return None
        if arg is None and os.environ.get("NLHEAT_SLO") != "1":
            return None
        return cls(registry=registry, clock=clock, live=live)

    # -- the ledger ----------------------------------------------------------
    def promise(self, seq: int, *, engine=None, engine_sel=None,
                deadline_ms: float | None = None, mesh=None,
                t: float | None = None) -> None:
        """Record one request's promise.  ``engine`` is the picked
        :class:`~nonlocalheatequation_torch.serve.picker.EngineChoice`
        when the front door picked (its ``est_ms`` is the modeled-cost
        side of the drift ratio); ``engine_sel`` the pool-key tuple for
        named-engine submissions (axis attribution, no cost model);
        both None = the default engine.  Never raises."""
        try:
            axis = engine_axis(
                engine.key() if hasattr(engine, "key") else engine_sel,
                mesh=mesh)
            est_ms = getattr(engine, "est_ms", None)
            rec = {
                "axis": axis,
                "est_ms": float(est_ms) if est_ms else None,
                "rates": getattr(engine, "rates", None),
                "deadline_ms": (float(deadline_ms)
                                if deadline_ms is not None else None),
                "t": t if t is not None else self._clock(),
            }
            with self._lock:
                self._open[seq] = rec
            self._c_promised.inc()
            self._g_open.set(len(self._open))
            ar = self._l_axis_req
            ar[axis] = ar.get(axis, 0) + 1
        except Exception:  # noqa: BLE001 — observability never raises
            pass

    def resolve(self, seq: int, *, latency_s: float | None = None,
                queue_wait_s: float | None = None,
                device_ms: float | None = None, error: str | None = None,
                err_l2: float | None = None,
                t: float | None = None) -> dict | None:
        """Join one outcome to its promise — exactly once (pop
        discipline; a duplicate increments ``/slo/duplicate`` and
        changes nothing, an unknown seq ``/slo/unmatched``).  All
        timings are the CALLER's timestamps (zero-fence contract).
        Returns the joined record, or None."""
        try:
            with self._lock:
                rec = self._open.pop(seq, None)
            if rec is None:
                # distinguish "resolved twice" from "never promised":
                # both are ledger-consistency signals the chaos test
                # asserts on, with different meanings
                (self._c_dup if seq in self._resolved_window
                 else self._c_unmatched).inc()
                return None
            self._resolved_window.add(seq)
            self._g_open.set(len(self._open))
            self._c_resolved.inc()
            rec.update(latency_s=latency_s, queue_wait_s=queue_wait_s,
                       device_ms=device_ms, error=error)
            if latency_s is not None:
                self._h_e2e.append(latency_s * 1e3)
            if queue_wait_s is not None:
                self._h_queue.append(queue_wait_s * 1e3)
            if device_ms is not None:
                self._h_device.append(device_ms)
            if err_l2 is not None:
                self._h_err.append(float(err_l2))
                rec["err_l2"] = float(err_l2)
            if error is not None:
                self._c_errors.inc()
            hit = None
            if rec["deadline_ms"] is not None and latency_s is not None:
                hit = (error is None
                       and latency_s * 1e3 <= rec["deadline_ms"])
                (self._c_hit if hit else self._c_miss).inc()
                table = self._l_axis_hit if hit else self._l_axis_miss
                table[rec["axis"]] = table.get(rec["axis"], 0) + 1
                with self._lock:
                    self._burn.append(0 if hit else 1)
                    del self._burn[:-self.window]
                    burn = sum(self._burn) / len(self._burn)
                self._g_burn.set(round(burn, 6))
            rec["deadline_hit"] = hit
            observed = device_ms if device_ms is not None else (
                latency_s * 1e3 if latency_s is not None else None)
            if rec["est_ms"] and observed and error is None:
                ratio = observed / rec["est_ms"]
                rec["cost_ratio"] = ratio
                self._h_ratio.append(ratio)
                self._check_drift(ratio)
            return rec
        except Exception:  # noqa: BLE001 — observability never raises
            return None

    # the duplicate-vs-unmatched discriminator: a bounded window of
    # recently resolved seqs (a set would grow with lifetime traffic)
    @property
    def _resolved_window(self):
        w = getattr(self, "_resolved_w", None)
        if w is None:
            w = self._resolved_w = _SeqWindow(self.window)
        return w

    def _check_drift(self, ratio: float) -> None:
        with self._lock:
            self._ratios.append(ratio)
            del self._ratios[:-self.window]
            rs = sorted(self._ratios)
            p50 = rs[len(rs) // 2]
            n = len(rs)
            lo, hi = self.band
            inside = lo <= p50 <= hi
            fire = (not inside and n >= self.min_samples
                    and not self._drift_excursion)
            self._drift_excursion = not inside and n >= self.min_samples
        self._g_drift.set(round(p50, 6))
        if fire:
            # loud, once per excursion: the picker's cost model left
            # the band — every future pick is priced wrong until the
            # live rates pull it back (or someone looks)
            self._c_drift_warn.inc()
            import sys

            print(f"slo: WARNING cost-model drift — modeled-vs-observed "
                  f"p50 ratio {p50:.3g} outside [{lo:g}, {hi:g}] over "
                  f"{n} requests (/slo/drift)", file=sys.stderr)
            if self._events is not None:
                self._events.emit(event="slo-drift", p50=round(p50, 6),
                                  band=[lo, hi], samples=n)
            flightrec.record("slo-drift", p50=round(p50, 6),
                             band=[lo, hi], samples=n)

    # -- surfaces ------------------------------------------------------------
    def axes(self) -> dict:
        """The per-engine-axis hit-rate table."""
        out = {}
        for axis, n in dict(self._l_axis_req).items():
            hit = dict(self._l_axis_hit).get(axis, 0)
            miss = dict(self._l_axis_miss).get(axis, 0)
            out[axis] = {
                "requests": n, "deadline_hit": hit,
                "deadline_miss": miss,
                "hit_rate": (round(hit / (hit + miss), 6)
                             if hit + miss else None),
            }
        return out

    def summary(self) -> dict:
        """The one-page SLO block (``ServePipeline.metrics()["slo"]``)."""
        hit, miss = self._c_hit.value, self._c_miss.value
        ratio_pct = self._h_ratio.percentiles()
        return {
            "promised": self._c_promised.value,
            "resolved": self._c_resolved.value,
            "open": len(self._open),
            "errors": self._c_errors.value,
            "duplicate": self._c_dup.value,
            "unmatched": self._c_unmatched.value,
            "deadline_hit": hit,
            "deadline_miss": miss,
            "deadline_hit_rate": (round(hit / (hit + miss), 6)
                                  if hit + miss else None),
            "burn": self._g_burn.value,
            "drift_ratio_p50": ratio_pct.get("p50"),
            "drift": self._g_drift.value,
            "drift_warnings": self._c_drift_warn.value,
            "drift_band": list(self.band),
            "e2e_ms": self._h_e2e.percentiles(),
            "queue_wait_ms": self._h_queue.percentiles(),
            "device_ms": self._h_device.percentiles(),
            "cost_ratio": ratio_pct,
            "measured_err": self._h_err.percentiles(),
            "axes": self.axes(),
        }

    def ensure_live(self, device_kind: str,
                    dtype_name: str = "float32") -> LiveRateRecorder | None:
        """Build the live rate recorder lazily, once the OWNER knows its
        device kind (a pipeline whose chunk has retired on its card; the
        picker stays backend-free).  No-op when live recalibration is
        disabled."""
        if not self._live_wanted:
            return None
        if self.live is None:
            self.live = LiveRateRecorder(device_kind,
                                         dtype_name=dtype_name)
        return self.live

    def close(self) -> None:
        if self.live is not None:
            self.live.flush()


class _SeqWindow:
    """A bounded membership window over recently seen seqs (the
    duplicate-vs-unmatched discriminator): O(1) add/contains, memory
    bounded at ``cap``."""

    def __init__(self, cap: int):
        self.cap = max(1, int(cap))
        self._set: set = set()
        self._order: list = []

    def add(self, seq) -> None:
        if seq in self._set:
            return
        self._set.add(seq)
        self._order.append(seq)
        if len(self._order) > self.cap:
            self._set.discard(self._order.pop(0))

    def __contains__(self, seq) -> bool:
        return seq in self._set
