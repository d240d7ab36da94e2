"""Profiling — ``torch.profiler`` traces around a solve, the port's
counterpart of ``nonlocalheatequation_tpu/utils/profiling.py``
(``jax.profiler`` there).

Usage:

    with trace("/tmp/nlheat-trace"):
        solver.do_work()

or the CLIs' ``--profile DIR``.  The host's activity is always traced, the
CUDA card's kernels and copies too when a card is present; on exit a Chrome
trace (``<host>.<pid>.<ns>.pt.trace.json``) is written under the directory,
viewable in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import time


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a ``torch.profiler`` trace into ``log_dir`` (a no-op when
    None or empty).  Never raises: profiling is observability, and a
    failure to start or stop it prints ``[profiling] ...`` on stderr and
    lets the solve run."""
    if not log_dir:
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
    except Exception as e:
        print(f"[profiling] start_trace failed: {e!r}", file=sys.stderr)
        yield
        return
    try:
        yield
    finally:
        try:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            name = f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"
            prof.export_chrome_trace(os.path.join(log_dir, name))
        except Exception as e:
            print(f"[profiling] stop_trace failed: {e!r}", file=sys.stderr)
