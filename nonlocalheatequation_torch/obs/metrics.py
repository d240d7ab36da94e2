"""Process-wide counter/gauge/histogram registry with HPX-style names — the
port's copy of ``nonlocalheatequation_tpu/obs/metrics.py``.

The reference's observability backbone is HPX's performance-counter
namespace — hierarchical names like ``/threads{locality#0/total}/idle-rate``
read live by the load balancer (src/2d_nonlocal_distributed.cpp:112-128).
This module is that backbone for the port: one registry of named metrics
that the serving reports (serve/server.py ``ServeReport``,
serve/ensemble.py ``EnsembleReport``), the load-balance busy rates
(parallel/load_balance.py) and the solvers' counters WRITE THROUGH — the
reports' fields are properties over registry metrics, so
``ServeReport.metrics()`` and the registry's Prometheus/JSON expositions
read the same storage and cannot disagree.

Name grammar (the HPX counter shape)::

    /object/counter               e.g. /serve/retries
    /object{instance}/counter     e.g. /device{3}/busy-rate

Metric kinds:

* :class:`Counter` / :class:`Gauge` — one number (counters also accept
  ``set`` so a report field can be assigned, e.g. ``report.cases += 1``
  through its property).
* :class:`Histogram` — a WINDOWED sample deque (most recent ``window``
  observations feed the percentiles) plus lifetime-exact ``count`` and
  ``total`` — a long-lived server must not grow host memory with its
  request count (serve/server.py LOG_CAP).
* :class:`Trail` — a windowed deque of arbitrary entries (chunk logs,
  occupancy samples, quarantine records) with a lifetime-exact ``count``.
* :class:`LabeledCounters` — a dict of label -> count (fault
  classifications, forced-close reasons); each key is lifetime-exact.

Expositions: :meth:`MetricsRegistry.snapshot` (plain dict),
:meth:`MetricsRegistry.snapshot_json` (ONE line), and
:meth:`MetricsRegistry.prometheus` (text exposition format, names
sanitized ``/device{3}/busy-rate`` -> ``nlheat_device_busy_rate{device="3"}``),
byte-equal to the JAX registry's for the same recorded values.

Hard rules: recording never raises past registration time, never fences
or touches a device (host-side numbers only), and memory is bounded
(windows + a fixed set of names).  ``REGISTRY`` is the process-wide
default; reports default to a PRIVATE registry each so concurrent
engines never share counters — the serving pipeline exposes its
report's registry for scraping (obs/export.py).
"""

from __future__ import annotations

import json
import re
import threading
from collections import deque

import numpy as np

#: Default histogram/trail window (serve/server.py LOG_CAP).
DEFAULT_WINDOW = 4096


def _stable_copy(make_copy, default):
    """Copy a container a recorder thread may be appending to: CPython
    deque/dict iteration raises RuntimeError when it races a writer, and
    the scrape endpoint (obs/export.py) reads these from its handler
    thread while the pipeline records.  Retry the copy (the window is
    one append wide), then fall back to ``default`` — exposition must
    never raise."""
    for _ in range(8):
        try:
            return make_copy()
        except RuntimeError:
            continue
    return default


class Counter:
    """A single monotonically-growing number (``set`` exists so report
    fields can be written through properties)."""

    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def set(self, v):
        self.value = v

    def snapshot(self):
        return self.value


class Gauge(Counter):
    """A single settable number (depth, window size, busy rate)."""

    kind = "gauge"
    __slots__ = ()


class Histogram:
    """Windowed numeric samples + lifetime-exact count/total."""

    kind = "histogram"

    def __init__(self, name: str, window: int = DEFAULT_WINDOW):
        self.name = name
        self.samples: deque = deque(maxlen=int(window))
        self.count = 0  # lifetime-exact
        self.total = 0.0  # lifetime-exact

    def observe(self, v):
        self.samples.append(v)
        self.count += 1
        self.total += v

    # deque-compatible alias: report code appends samples
    append = observe

    def __iter__(self):
        return iter(self.samples)

    def __len__(self):
        return len(self.samples)

    def __bool__(self):
        return bool(self.samples)

    def percentiles(self) -> dict:
        xs = _stable_copy(lambda: list(self.samples), [])
        if not xs:
            return {}
        a = np.asarray(xs, np.float64)
        return {
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()),
            "max": float(a.max()),
        }

    def snapshot(self):
        return {"count": self.count, "sum": float(self.total),
                **self.percentiles()}


class Trail:
    """Windowed deque of arbitrary entries + lifetime-exact count."""

    kind = "trail"

    def __init__(self, name: str, window: int = DEFAULT_WINDOW):
        self.name = name
        self.entries: deque = deque(maxlen=int(window))
        self.count = 0  # lifetime-exact

    def append(self, entry):
        self.entries.append(entry)
        self.count += 1

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __bool__(self):
        return bool(self.entries)

    def snapshot(self):
        return {"count": self.count, "window": len(self.entries)}


class LabeledCounters(dict):
    """label -> lifetime-exact count; a dict, so report code that does
    ``d[k] = d.get(k, 0) + 1`` (and tests comparing against plain dicts)
    works unchanged while the registry exposes every label."""

    kind = "labeled"

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def snapshot(self):
        return _stable_copy(lambda: dict(self), {})


class backed:
    """Descriptor: a report field stored IN a registry metric — reads and
    writes go straight to the metric's ``value``, so the report and the
    registry expositions share one storage (they cannot disagree)."""

    def __init__(self, attr: str):
        self._attr = attr

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return getattr(obj, self._attr).value

    def __set__(self, obj, v):
        getattr(obj, self._attr).set(v)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram,
          "trail": Trail, "labeled": LabeledCounters}


class MetricsRegistry:
    """Thread-safe name -> metric store with the expositions above."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args)
            elif type(m) is not cls:
                # registration-time programming error: one name, one kind
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, window: int = DEFAULT_WINDOW) -> Histogram:
        return self._get(name, Histogram, window)

    def trail(self, name: str, window: int = DEFAULT_WINDOW) -> Trail:
        return self._get(name, Trail, window)

    def labeled(self, name: str) -> LabeledCounters:
        return self._get(name, LabeledCounters)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self):
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every metric (tests; a live process never resets)."""
        with self._lock:
            self._metrics.clear()

    def drop_prefix(self, prefix: str) -> int:
        """Drop every metric whose name starts with ``prefix`` — the
        staleness hook of a merged scrape: a dead or drained replica's
        absorbed ``/replica{r}/...`` gauges must not linger in the merged
        exposition forever.  Returns the number dropped."""
        with self._lock:
            doomed = [n for n in self._metrics if n.startswith(prefix)]
            for n in doomed:
                del self._metrics[n]
        return len(doomed)

    # -- expositions --------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain name -> value dict (counters/gauges as numbers,
        histograms as count/sum/percentiles, trails as count/window,
        labeled counters as dicts)."""
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def snapshot_json(self) -> str:
        """The one-line JSON form of :meth:`snapshot`."""
        return json.dumps(self.snapshot(), default=float)

    def prometheus(self) -> str:
        """Prometheus text exposition of every metric."""
        with self._lock:
            items = sorted(self._metrics.items())
        families: dict = {}  # metric name -> (type, [sample lines])

        def add(metric, ptype, line):
            fam = families.setdefault(metric, (ptype, []))
            fam[1].append(line)

        for name, m in items:
            metric, labels = _prom_name(name)
            if isinstance(m, (Counter, Gauge)):  # Gauge subclasses Counter
                ptype = "gauge" if isinstance(m, Gauge) else "counter"
                add(metric, ptype,
                    f"{metric}{_labels(labels)} {_num(m.value)}")
            elif isinstance(m, Histogram):
                p = m.percentiles()
                for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                    if p:
                        add(metric, "summary",
                            f"{metric}{_labels(labels + [('quantile', str(q))])}"
                            f" {_num(p[key])}")
                add(metric, "summary",
                    f"{metric}_count{_labels(labels)} {m.count}")
                add(metric, "summary",
                    f"{metric}_sum{_labels(labels)} {_num(m.total)}")
            elif isinstance(m, Trail):
                add(metric + "_count", "counter",
                    f"{metric}_count{_labels(labels)} {m.count}")
            elif isinstance(m, LabeledCounters):
                snap = m.snapshot()  # race-stable copy
                for k in sorted(snap):
                    add(metric, "counter",
                        f"{metric}{_labels(labels + [('key', str(k))])}"
                        f" {_num(snap[k])}")
                if not snap:
                    add(metric, "counter", None)  # TYPE line only
        lines = []
        for metric in sorted(families):
            ptype, samples = families[metric]
            lines.append(f"# TYPE {metric} {ptype}")
            lines.extend(s for s in samples if s is not None)
        return "\n".join(lines) + "\n"


_SEG_RE = re.compile(r"^([^{}]+)(?:\{(.*)\})?$")


def _prom_name(name: str):
    """``/device{3}/busy-rate`` -> (``nlheat_device_busy_rate``,
    [("device", "3")])."""
    parts, labels = [], []
    for seg in (s for s in name.split("/") if s):
        m = _SEG_RE.match(seg)
        base, inst = (m.group(1), m.group(2)) if m else (seg, None)
        clean = re.sub(r"[^0-9A-Za-z_]", "_", base)
        parts.append(clean)
        if inst is not None:
            labels.append((clean, inst))
    return "nlheat_" + "_".join(parts), labels


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _labels(items) -> str:
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in items) + "}"


def _num(v) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".10g")


def absorb_snapshot(registry: MetricsRegistry, prefix: str,
                    snapshot: dict) -> None:
    """Flatten a FOREIGN registry snapshot (another process's
    ``MetricsRegistry.snapshot()``, shipped over an IPC boundary) into
    ``registry`` under ``prefix`` — per-replica metric namespaces: a
    worker's ``/serve/retries`` lands as ``/replica{3}/serve/retries``, so
    one scrape exposes every process with the replica as a Prometheus
    label (the ``{instance}`` name grammar above).

    Scalars land as gauges verbatim (a snapshot is a point-in-time copy
    — monotonicity is the source registry's business); dict-valued
    entries (histogram count/sum/percentiles, trail counts, labeled
    counters) flatten one level to ``/name/<field>`` sub-gauges;
    non-numeric leaves are skipped.  Never raises past argument errors
    (absorbing telemetry must not fail its caller)."""
    for name, val in snapshot.items():
        base = prefix + name
        try:
            if isinstance(val, bool):
                registry.gauge(base).set(int(val))
            elif isinstance(val, (int, float)):
                registry.gauge(base).set(val)
            elif isinstance(val, dict):
                for k, v in val.items():
                    if isinstance(v, bool):
                        registry.gauge(f"{base}/{k}").set(int(v))
                    elif isinstance(v, (int, float)):
                        registry.gauge(f"{base}/{k}").set(v)
        except Exception:  # noqa: BLE001 — e.g. a name/kind clash with a
            continue  # caller-owned metric; skip the entry, keep the rest


#: The process-wide default registry: the solvers' counters (``/halo/*``,
#: ``/stepper/*``, ``/op/fft-applies``) and the load-balance busy-rate gauges
#: publish here.  Reports default
#: to a private registry each (see the module docstring).
REGISTRY = MetricsRegistry()
