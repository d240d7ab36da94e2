"""The traced window: ``torch.profiler`` over part of a run, and the device
timeline read from it.

The profiler records the card's kernels, copies and fills (CUPTI) and the
host's operators, runtime calls and the harness's own spans
(``record_function``) on one clock.  :func:`parse` keeps the device events
and the host events as plain tuples; the functions below it are the
arithmetic every per-layer reader shares: the union of device activity
(busy), what lies between (idle gaps) and what the host was doing in each
gap.  Timestamps are nanoseconds on the profiler's clock throughout.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np

WINDOW = "portbench.window"
#: the prefix of the harness's own spans (host annotations)
SPAN_PREFIX = "portbench."

_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


@dataclass
class Trace:
    """One traced window: ``window`` (start, end); ``device`` tuples
    (name, kind, start, end) with kind kernel, memcpy or memset; ``host``
    tuples (name, start, end) of the host's operators and runtime calls;
    ``spans`` the harness's annotations by name."""

    window: tuple
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


class Recorder:
    """The profiler over one window: :meth:`start` opens it (and the window
    span), :meth:`span` marks a harness span while it runs, :meth:`stop`
    closes the window and waits for the card, :meth:`trace` reads what was
    recorded (after the measured window: reading takes seconds)."""

    def __init__(self):
        self._prof = None
        self._window = None
        self._results = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def span(self, name: str):
        """A harness span while the profiler runs, else nothing at all."""
        if self._prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)

    def stop(self) -> None:
        import torch

        self._window.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # kernels begun in the window reach the record
        self._prof.__exit__(None, None, None)
        self._results = self._prof.profiler.kineto_results
        self._prof = None

    def trace(self) -> Trace:
        return parse(self._results.events())


def _kind(event) -> str | None:
    """kernel / memcpy / memset for a device event, None for the host."""
    name = str(getattr(event.device_type(), "name", event.device_type()))
    act = event.activity_type() if hasattr(event, "activity_type") else ""
    if name.upper() != "CUDA":
        return None
    if act:
        return _DEVICE_KINDS.get(act, "other")
    ev = event.name()
    return "memcpy" if ev.startswith("Memcpy") else "memset" if ev.startswith("Memset") else "kernel"


def parse(events) -> Trace:
    """A :class:`Trace` from the profiler's raw events (``kineto_results
    .events()``).  The window is the harness's ``portbench.window`` span; a
    record without it takes the span of everything recorded."""
    device, host, spans = [], [], {}
    window = None
    for e in events:
        start = e.start_ns()
        end = start + e.duration_ns()
        kind = _kind(e)
        name = e.name()
        if kind is None:
            if name == WINDOW:
                window = (start, end)
            elif name.startswith(SPAN_PREFIX):
                spans.setdefault(name[len(SPAN_PREFIX):], []).append((start, end))
            else:
                host.append((name, start, end))
        elif kind != "other" and not name.startswith(SPAN_PREFIX):
            device.append((name, kind, start, end))
    if window is None:
        stamps = [t for d in device for t in d[2:]] + [t for h in host for t in h[1:]]
        window = (min(stamps), max(stamps)) if stamps else (0, 0)
    return Trace(window=window, device=device, host=host, spans=spans)


# -- the timeline's arithmetic ---------------------------------------------------

def merged_busy(trace: Trace, kinds=("kernel", "memcpy", "memset")) -> np.ndarray:
    """The union of the device events of ``kinds``, clipped to the window,
    as sorted disjoint intervals: an (n, 2) array of (start, end)."""
    w0, w1 = trace.window
    ivs = sorted((max(s, w0), min(e, w1)) for _, k, s, e in trace.device
                 if k in kinds and e > w0 and s < w1)
    out: list = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return np.array(out, dtype=np.int64).reshape(-1, 2)


def busy_ns(merged: np.ndarray) -> int:
    return int((merged[:, 1] - merged[:, 0]).sum())


def kernel_seconds(trace: Trace) -> float:
    """The summed device time of every kernel in the window (clipped to it)."""
    w0, w1 = trace.window
    return sum(min(e, w1) - max(s, w0) for _, k, s, e in trace.device
               if k == "kernel" and e > w0 and s < w1) / 1e9


def has_kernel(trace: Trace, names) -> bool:
    """Whether a kernel whose name holds one of ``names`` ran in the window."""
    w0, w1 = trace.window
    return any(k == "kernel" and e > w0 and s < w1 and any(n in name for n in names)
               for name, k, s, e in trace.device)


def busy_before(merged: np.ndarray, t) -> np.ndarray:
    """Nanoseconds of ``merged`` before each time in ``t``."""
    t = np.asarray(t, dtype=np.int64)
    done = np.concatenate([[0], np.cumsum(merged[:, 1] - merged[:, 0])])
    i = np.searchsorted(merged[:, 1], t, side="right")  # intervals ended by t
    part = np.where(i < len(merged), t - merged[np.minimum(i, len(merged) - 1), 0], 0)
    return done[i] + np.clip(part, 0, None)


def idle_gaps(trace: Trace, merged: np.ndarray | None = None) -> list:
    """The window's stretches with no device activity, as (start, end)."""
    merged = merged_busy(trace) if merged is None else merged
    w0, w1 = trace.window
    gaps, t = [], w0
    for s, e in merged.tolist():
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def short_name(name: str, width: int = 60) -> str:
    """A kernel's name without its return type, namespace and argument
    list; copies and fills keep theirs ("Memcpy DtoH (Device -> Pageable)")."""
    if not name.startswith(("Memcpy", "Memset")):
        name = name.removeprefix("void ").removeprefix("(anonymous namespace)::")
        name = name.split("(")[0] or name
    return name[:width]


def host_at(trace: Trace, stamps, lookback: int = 64) -> list:
    """For each time in ``stamps``, the innermost host event or harness span
    that covers it (the shortest), or ``"(no host event)"``."""
    events = sorted(trace.host, key=lambda h: h[1])
    starts = np.array([h[1] for h in events], dtype=np.int64)
    ends = np.array([h[2] for h in events], dtype=np.int64)
    spans = [(name, s, e) for name, ivs in trace.spans.items() for s, e in ivs]
    stamps = np.asarray(stamps, dtype=np.int64)
    best_len = np.full(len(stamps), np.iinfo(np.int64).max)
    best = np.full(len(stamps), -1)
    if len(events):
        idx = np.searchsorted(starts, stamps, side="right") - 1
        for back in range(lookback):
            j = idx - back
            ok = j >= 0
            jj = np.where(ok, j, 0)
            cover = ok & (ends[jj] >= stamps)
            length = ends[jj] - starts[jj]
            take = cover & (length < best_len)
            best_len = np.where(take, length, best_len)
            best = np.where(take, jj, best)
    names = [events[b][0] if b >= 0 else None for b in best]
    for i, t in enumerate(stamps):
        for name, s, e in spans:
            if s <= t <= e and e - s < best_len[i]:
                best_len[i] = e - s
                names[i] = SPAN_PREFIX + name
    return [n if n is not None else "(no host event)" for n in names]


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by what the host was doing in them, ``top`` of each, in seconds."""
    w0, w1 = trace.window
    ops: dict = {}
    for name, _, s, e in trace.device:
        if e > w0 and s < w1:
            key = short_name(name)
            ops[key] = ops.get(key, 0) + min(e, w1) - max(s, w0)
    gaps = idle_gaps(trace)
    by_host: dict = {}
    if gaps:
        mids = [(s + e) // 2 for s, e in gaps]
        for (s, e), name in zip(gaps, host_at(trace, mids), strict=True):
            key = short_name(name)
            by_host[key] = by_host.get(key, 0) + e - s

    def ranked(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(by_host)}
