"""Named counters and gauges with HPX-style names — the subset of
``nonlocalheatequation_tpu/obs/metrics.py`` that the ensemble engine's
report (serve/ensemble.py ``EnsembleReport``) writes through, and the
process-global :data:`REGISTRY` where the distributed solvers publish their
scheduled halo traffic (``/halo/bytes``, ``/halo/exchanges``).

Names follow the HPX performance-counter shape (``/object/counter``, e.g.
``/ensemble/cases``).  A report's fields are :class:`backed` properties over
registry metrics, so the report and the registry read one storage.  The
histograms, trails, labeled counters and the Prometheus/JSON expositions
wait for the serving slice.
"""

from __future__ import annotations

import threading


class Counter:
    """A single monotonically-growing number, written through a report's
    :class:`backed` properties (``report.cases += n``)."""

    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v):
        self.value = v

    def inc(self, n=1):
        self.value += n


class Gauge(Counter):
    """A single settable number (a resident count, a depth)."""

    kind = "gauge"
    __slots__ = ()


class backed:
    """Descriptor: a report field stored IN a registry metric — reads and
    writes go straight to the metric's ``value``, so the report and the
    registry share one storage."""

    def __init__(self, attr: str):
        self._attr = attr

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return getattr(obj, self._attr).value

    def __set__(self, obj, v):
        getattr(obj, self._attr).set(v)


class MetricsRegistry:
    """Thread-safe name -> metric store; one name has one kind."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif type(m) is not cls:
                raise ValueError(f"metric {name!r} already registered as {m.kind}, "
                                 f"requested {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)


#: The process-global registry (the distributed solvers' /halo/* counters).
REGISTRY = MetricsRegistry()
