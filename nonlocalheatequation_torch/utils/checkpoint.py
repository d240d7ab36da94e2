"""Checkpoint / resume for solver state — counterpart of
``nonlocalheatequation_tpu/utils/checkpoint.py``, in the same file format.

State is the temperature field plus the timestep and the solver parameters
that must match on resume; storage is a single .npz written atomically
(same-directory tmp + ``os.replace``), so a kill mid-write never corrupts
the latest checkpoint.  v2 files carry a CRC32 over the payload, so a torn
or bit-rotted file is refused at load with a resume-from-the-previous-
checkpoint hint instead of resuming a plausible-looking but wrong
trajectory.  A file written by either package resumes in the other.

:class:`CheckpointMixin` gives every solver the same canonical parameters
(the GLOBAL grid shape, eps, k, dt, dh and the test flag), so a checkpoint
written by the single-device solver resumes in the distributed one on the
same global grid, and the reverse.  The session checkpoints
(:func:`save_session_checkpoint` and its readers, for serve/sessions.py)
are the same files under the same names, so a session saved by either
package resumes in the other.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import zlib

import numpy as np

from nonlocalheatequation_torch.obs import trace as obs_trace

#: v1: u/t/params, no integrity marker.  v2 adds ``crc`` (CRC32 over the
#: state bytes, the timestep, and the params JSON); v1 files keep loading.
FORMAT_VERSION = 2

CORRUPT_HINT = (
    "the file is truncated or corrupt (torn write, disk fault); delete it "
    "and resume from the previous checkpoint, or restart from t=0"
)


def fetch_state(u) -> np.ndarray:
    """A host NumPy copy of a solver state in its own dtype: a tensor, an
    object array of mesh blocks (parallel/multihost.fetch_global, the
    global state on every rank), or a NumPy
    array (the oracle's, returned as it is)."""
    if isinstance(u, np.ndarray):
        if u.dtype == object:
            from nonlocalheatequation_torch.parallel.multihost import fetch_global

            return fetch_global(u)  # gathered to every rank
        return u
    # a copy: the step buffers are written again after this returns
    return u.to("cpu", copy=True).numpy()


def _process_index() -> int:
    from nonlocalheatequation_torch.parallel.multihost import process_index

    return process_index()


def _payload_crc(u: np.ndarray, t: int, params_json: bytes) -> int:
    crc = zlib.crc32(params_json)
    crc = zlib.crc32(np.int64(t).tobytes(), crc)
    # the crc is a function of the values the resume path reads back; .data
    # feeds the buffer without a byte copy of the whole field
    return zlib.crc32(np.ascontiguousarray(u).data, crc)


@contextlib.contextmanager
def atomic_file(path: str, mode: str = "wb"):
    """Crash-safe file write: yield a same-directory tmp file, fsync it,
    then atomically ``os.replace`` it onto ``path``; a kill mid-write leaves
    the previous file untouched, and a failed write never strands the tmp
    next to the live file."""
    # host-unique tmp: pids alone can collide across hosts sharing a filesystem
    tmp = f"{path}.tmp.{socket.gethostname()}.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            yield f
            # the replace is atomic only for bytes that reached the disk
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str) -> None:
    """Crash-safe small-text write."""
    with atomic_file(path, "w") as f:
        f.write(text)


def save_state(path: str, u: np.ndarray, t: int, params: dict | None = None):
    """Atomically write solver state at timestep ``t`` (u = state AFTER t
    steps, saved in its own dtype) via :func:`atomic_file`, its payload
    CRC32 included so that ``load_state`` can refuse a torn file."""
    meta = dict(params or {})
    u = np.asarray(u)
    params_json = json.dumps(meta).encode()
    with obs_trace.span("checkpoint.save", cat="checkpoint", step=int(t),
                        bytes=int(u.nbytes)):
        with atomic_file(path, "wb") as f:
            np.savez(
                f,
                u=u,
                t=np.int64(t),
                version=np.int64(FORMAT_VERSION),
                params=np.frombuffer(params_json, dtype=np.uint8),
                crc=np.uint32(_payload_crc(u, t, params_json)),
            )


def load_state(path: str):
    """-> (u, t, params).  Raises ValueError on an unknown format version
    and, with a resume-from-previous hint, on a truncated or corrupt file
    (unreadable archive, missing members, CRC mismatch).  A missing file
    propagates as FileNotFoundError."""
    with obs_trace.span("checkpoint.load", cat="checkpoint"):
        return _load_state(path)


def _load_state(path: str):
    try:
        with np.load(path) as z:
            version = int(z["version"])
            u = np.array(z["u"])
            t = int(z["t"])
            params_raw = z["params"].tobytes() if "params" in z else b"{}"
            crc = int(z["crc"]) if "crc" in z.files else None
    except FileNotFoundError:
        raise
    except Exception as e:
        # BadZipFile, EOFError, KeyError on a missing member, OSError
        # mid-read: the shapes a torn write takes, refused as one
        raise ValueError(
            f"checkpoint {path!r} could not be read "
            f"({type(e).__name__}: {e}): " + CORRUPT_HINT) from e
    if version not in (1, FORMAT_VERSION):
        raise ValueError(f"unsupported checkpoint version {version}")
    if version >= 2:
        if crc is None:
            raise ValueError(
                f"checkpoint {path!r} (v{version}) is missing its "
                "integrity marker: " + CORRUPT_HINT)
        got = _payload_crc(u, t, params_raw)
        if got != crc:
            raise ValueError(
                f"checkpoint {path!r} failed its integrity check "
                f"(crc {got:#010x} != recorded {crc:#010x}): "
                + CORRUPT_HINT)
    try:
        params = json.loads(params_raw.decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise ValueError(
            f"checkpoint {path!r} carries unreadable parameters "
            f"({type(e).__name__}): " + CORRUPT_HINT) from e
    # v1 files written before the 'shape' list carried nx/ny(/nz) keys
    if "shape" not in params and "nx" in params:
        shape = [params.pop("nx")]
        for key in ("ny", "nz"):
            if key in params:
                shape.append(params.pop(key))
        params["shape"] = shape
    return u, t, params


def check_params(saved: dict, current: dict):
    """Refuse resume when solver parameters differ from, or are absent
    from, the checkpoint's."""
    for key, val in current.items():
        if key not in saved:
            raise ValueError(
                f"checkpoint parameter mismatch: {key!r} missing from the "
                "saved state"
            )
        if saved[key] != val:
            raise ValueError(
                f"checkpoint parameter mismatch: {key} saved={saved[key]!r} "
                f"current={val!r}"
            )


class CheckpointMixin:
    """Checkpoint/resume and the barrier-segmented time loop every solver
    shares.  Hosts provide ``_grid_shape``, ``op``, ``nt``, ``test`` and
    ``u0``, and set ``checkpoint_path``/``ncheckpoint``/``t0``; a logging
    host also sets ``logger`` and ``nlog``."""

    checkpoint_path: str | None = None
    ncheckpoint: int = 0
    t0: int = 0

    def _ckpt_params(self) -> dict:
        op = self.op
        spacing = getattr(op, "dh", None)
        if spacing is None:
            spacing = getattr(op, "dx", 0.0)
        return dict(
            shape=list(self._grid_shape),
            eps=int(op.eps),
            k=float(op.k),
            dt=float(op.dt),
            dh=float(spacing),
            test=bool(self.test),
        )

    def resume(self, path: str):
        """Continue from a checkpoint written by a prior run (the test/init
        flags must already be set the same way; the parameters are
        checked)."""
        u, t, params = load_state(path)
        check_params(params, self._ckpt_params())
        if tuple(u.shape) != tuple(self._grid_shape):
            raise ValueError(
                f"checkpoint state shape {u.shape} != grid {self._grid_shape}"
            )
        if t > self.nt:
            raise ValueError(
                f"checkpoint is at timestep {t}, beyond nt={self.nt}; "
                "nothing to resume"
            )
        self.u0 = np.asarray(u, dtype=np.float64)
        self.t0 = t

    def _ckpt_due(self, t: int) -> bool:
        """The checkpoint cadence: a save after step ``t``."""
        return bool(self.checkpoint_path and self.ncheckpoint
                    and (t + 1) % self.ncheckpoint == 0)

    def _ckpt_chunks(self, extra_due=None):
        """(start, count) segments of [t0, nt) ending at each barrier step
        (the checkpoint cadence plus any ``extra_due(t)``, the logging
        cadence), so that each segment runs one multi-step program."""
        chunks = []
        start = self.t0
        for t in range(self.t0, self.nt):
            if (self._ckpt_due(t) or (extra_due is not None and extra_due(t))
                    or t == self.nt - 1):
                chunks.append((start, t - start + 1))
                start = t + 1
        return chunks

    def _run_chunked(self, u, make_runner):
        """The barrier-segmented time loop: one runner call per segment,
        one runner per DISTINCT segment length.  ``make_runner(count)``
        returns ``(u, start) -> u`` advancing ``count`` steps from
        ``start``.  At each barrier the logger (every ``nlog`` steps) runs
        before the checkpoint, as in the per-step loops."""
        logger = getattr(self, "logger", None)
        nlog = getattr(self, "nlog", 0)
        log_due = ((lambda t: t % nlog == 0)
                   if logger is not None and nlog else None)
        runners = {}
        for start, count in self._ckpt_chunks(log_due):
            if count not in runners:
                runners[count] = make_runner(count)
            # launches are asynchronous: the span measures the host's submit
            with obs_trace.span("solver.steps", cat="solver",
                                start=start, count=count):
                u = runners[count](u, start)
            last = start + count - 1
            if log_due is not None and log_due(last):
                logger(last, fetch_state(u))
            self._maybe_checkpoint(last, u)
        return u

    def _maybe_checkpoint(self, t: int, u) -> None:
        if self._ckpt_due(t):
            state = fetch_state(u)
            # one writer: N racing writers to one path corrupt it
            if _process_index() != 0:
                return
            save_state(self.checkpoint_path, state, t + 1, self._ckpt_params())


# -- session checkpoints (serve/sessions.py) ---------------------------------
# The live-session tier checkpoints long-running cases keyed by session id
# and step: one .npz per (session, chunk-boundary step), each written
# through save_state's atomic+CRC discipline, so a front-door death resumes
# from the newest UNCORRUPTED boundary and a fork can branch from ANY
# retained boundary.  Files are ``<dir>/<sid>@<step>.ckpt.npz``: the step
# in the name lets list/load work without opening every archive.


def session_checkpoint_path(ckpt_dir: str, sid: str, step: int) -> str:
    sid = str(sid)
    if "@" in sid or "/" in sid or sid != os.path.basename(sid):
        raise ValueError(f"bad session id {sid!r} for a checkpoint name")
    return os.path.join(ckpt_dir, f"{sid}@{int(step)}.ckpt.npz")


def save_session_checkpoint(ckpt_dir: str, sid: str, step: int,
                            u: np.ndarray, params: dict | None = None,
                            keep: int = 0) -> str:
    """Atomically write one session checkpoint at ``step`` (u = state at
    that chunk boundary).  ``keep`` > 0 prunes to the newest ``keep``
    boundaries AFTER the new file lands (never before: a crash mid-save
    must leave the previous boundary resumable).  Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = session_checkpoint_path(ckpt_dir, sid, step)
    save_state(path, u, step, dict(params or {}, session=str(sid)))
    if keep > 0:
        for old in list_session_checkpoints(ckpt_dir, sid)[:-keep]:
            try:
                os.unlink(session_checkpoint_path(ckpt_dir, sid, old))
            except OSError:
                pass  # pruning is best-effort; resume scans survivors
    return path


def list_session_checkpoints(ckpt_dir: str, sid: str) -> list:
    """Retained boundary steps for ``sid``, ascending (empty when none)."""
    prefix = f"{sid}@"
    steps = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    for name in names:
        if name.startswith(prefix) and name.endswith(".ckpt.npz"):
            try:
                steps.append(int(name[len(prefix):-len(".ckpt.npz")]))
            except ValueError:
                continue  # foreign file wearing the prefix
    return sorted(steps)


def load_session_checkpoint(ckpt_dir: str, sid: str,
                            step: int | None = None):
    """-> (u, step, params) for ``sid``.  ``step`` None loads the newest
    UNCORRUPTED boundary, falling back past torn files loudly (stderr):
    the resume path's half of the CORRUPT_HINT contract.  An explicit
    ``step`` refuses on corruption instead (the caller named the exact
    evidence it wants).  FileNotFoundError when nothing is retained."""
    import sys

    steps = list_session_checkpoints(ckpt_dir, sid)
    if not steps:
        raise FileNotFoundError(
            f"no checkpoints for session {sid!r} under {ckpt_dir!r}")
    if step is not None:
        if int(step) not in steps:
            raise ValueError(
                f"session {sid!r} has no checkpoint at step {step} "
                f"(retained: {steps})")
        return load_state(session_checkpoint_path(ckpt_dir, sid, int(step)))
    last_err = None
    for t in reversed(steps):
        try:
            u, got_t, params = load_state(
                session_checkpoint_path(ckpt_dir, sid, t))
            if last_err is not None:
                print(f"session {sid}: newest checkpoint unreadable "
                      f"({last_err}); resumed from step {got_t} instead",
                      file=sys.stderr)
            return u, got_t, params
        except ValueError as e:
            last_err = e
            continue
    raise ValueError(
        f"every retained checkpoint for session {sid!r} is corrupt "
        f"(steps {steps}); " + CORRUPT_HINT)
