"""The port's live-session tier (nonlocalheatequation_torch/serve/sessions.py,
the session checkpoints of utils/checkpoint.py) on the CPU, held against the
JAX package run from the same numpy seeds.

Each JAX test of tests/test_sessions.py has an analog here.  The JAX
SessionManager runs over the JAX ``ServePipeline(method="sat")``; the port's
over its own CPU ``ServePipeline`` (f64), or over its replica router where
the JAX test spawns one.  What is held:

* the final f64 fields and every f64 boundary state (read back from the
  per-boundary checkpoints) agree with the JAX package's to 1e-12 of the
  field's largest magnitude; a preview frame is the f32 rounding of such a
  state, so it agrees to within one float32 spacing of its value;
* frame steps and kinds, audit logs, deferral counts, the /session/*
  counters, the session-* event kinds and the refusal words are equal;
* each port run is BITWISE its own chunked oracle: the chunk-by-chunk
  composition through the port's offline ``EnsembleEngine`` with the
  session tier's source splitting (u += n*dt*b in f64 at the chunk's end).

Beyond the JAX tests: a session over a registered point cloud (a mesh
session), and session checkpoints across the packages (equal names, a file
saved by either loads bitwise in the other, equal refusal words for corrupt
and truncated files).  The fleet tests (die@ chaos, HTTP/SSE) spawn one
router each and batch their checks: a replica costs a torch import.
"""

import json
import os
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.obs.metrics import MetricsRegistry
from nonlocalheatequation_torch.serve import http as thttp
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.meshes import MeshStore
from nonlocalheatequation_torch.serve.router import ReplicaRouter, RouterOverloaded
from nonlocalheatequation_torch.serve.server import ServePipeline
from nonlocalheatequation_torch.serve.sessions import Session, SessionManager, SessionSpec
from nonlocalheatequation_torch.utils import checkpoint as tckpt
from nonlocalheatequation_tpu.obs.metrics import MetricsRegistry as JRegistry
from nonlocalheatequation_tpu.serve import http as jhttp
from nonlocalheatequation_tpu.serve import sessions as jsessions
from nonlocalheatequation_tpu.serve.ensemble import EnsembleCase as JCase
from nonlocalheatequation_tpu.serve.router import RouterOverloaded as JOverloaded
from nonlocalheatequation_tpu.serve.server import ServePipeline as JPipeline
from nonlocalheatequation_tpu.utils import checkpoint as jckpt

torch.set_num_threads(1)

G = 12
PHYS = dict(eps=2, k=1.0, dt=1e-5, dh=1.0 / G)
F64 = torch.float64
KW = dict(method="sat", batch_sizes=(1,), device="cpu", dtype=F64, spawn_timeout_s=120)
COUNTS = ("active", "opened", "completed", "closed", "failed", "chunks", "steps", "frames",
          "retargets", "forks", "resumes", "checkpoints", "deferrals")

PORT = types.SimpleNamespace(
    name="port", Manager=SessionManager, Spec=SessionSpec, Session=Session,
    Registry=MetricsRegistry, Admission=thttp.AdmissionController, Overloaded=RouterOverloaded,
    Case=EnsembleCase, ckpt=tckpt,
    pipe=lambda: ServePipeline(method="sat", batch_sizes=(1,), depth=1, window_ms=0.0,
                               device="cpu", dtype=F64))
JAX = types.SimpleNamespace(
    name="jax", Manager=jsessions.SessionManager, Spec=jsessions.SessionSpec,
    Session=jsessions.Session, Registry=JRegistry, Admission=jhttp.AdmissionController,
    Overloaded=JOverloaded, Case=JCase, ckpt=jckpt,
    pipe=lambda: JPipeline(method="sat", batch_sizes=(1,), depth=1, window_ms=0.0))


def u0_of(seed=0):
    return np.random.default_rng(seed).normal(size=(G, G))


def chunked_oracle(u0, plan, method="sat", **phys):
    """The session trajectory composed by hand through the port's offline
    engine: ``plan`` is a list of ``(n_steps, k, source)`` chunks, each one
    engine run plus the first-order source splitting (u += n*dt*b at the
    chunk's end).  Returns every boundary state (the initial one first)."""
    phys = {**PHYS, **phys}
    eng = EnsembleEngine(method=method, batch_sizes=(1,), device="cpu", dtype=F64)
    states = [np.asarray(u0, np.float64)]
    u = states[0]
    for n, k, source in plan:
        u = eng.run([EnsembleCase(shape=u.shape, nt=n, eps=phys["eps"], k=k, dt=phys["dt"],
                                  dh=phys["dh"], test=False, u0=u, mesh=phys.get("mesh"))])[0]
        u = np.asarray(u, np.float64)
        if source is not None:
            u = u + n * phys["dt"] * np.asarray(source, np.float64)
        states.append(u)
    return states


def preview_of(u, stride):
    return np.ascontiguousarray(u[(slice(None, None, stride),) * u.ndim].astype(np.float32))


def close64(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype == np.float64
    assert np.max(np.abs(a - b)) <= 1e-12 * max(1.0, float(np.max(np.abs(b))))


def close_frames(mine, theirs):
    """Frame lists equal in (step, kind, t, shape, dtype); final values to
    1e-12; preview values within one float32 spacing (each is the f32
    rounding of an f64 state held to 1e-12)."""
    assert [(f.step, f.kind, f.t, tuple(f.shape), f.values.dtype) for f in mine] == \
        [(f.step, f.kind, f.t, tuple(f.shape), f.values.dtype) for f in theirs]
    for a, b in zip(mine, theirs, strict=True):
        if a.kind == "final":
            close64(a.values, b.values)
        else:
            gap = np.abs(a.values.astype(np.float64) - b.values.astype(np.float64))
            assert np.all(gap <= np.spacing(np.abs(b.values))), (a.step, gap.max())


def frames_by_step(frames):
    return {(f.step, f.kind): np.array(f.values) for f in frames}


def both(fn, *args, **kwargs):
    return fn(PORT, *args, **kwargs), fn(JAX, *args, **kwargs)


# ---------------------------------------------------------------------------
# chunked stepping + stream (in-process pipeline)
# ---------------------------------------------------------------------------


def _chunked(ns, tmp):
    ckpt = os.path.join(tmp, ns.name)
    with ns.pipe() as pipe:
        with ns.Manager(pipe, checkpoint_dir=ckpt, chunk_steps=4) as mgr:
            s = mgr.open(shape=(G, G), u0=u0_of(1), nt=10, checkpoint_every=1,
                         preview_stride=3, **PHYS)
            mgr.drive(timeout_s=120)
            m = mgr.metrics()
            steps = mgr.checkpoints(s.sid)
            return dict(
                state=s.state, step=s.step, result=s.result(),
                frames=list(mgr.stream(s.sid, from_step=-1, timeout_s=5)),
                tail=[(f.step, f.kind) for f in mgr.stream(s.sid, from_step=4, timeout_s=5)],
                ckpts=steps, states=[ns.ckpt.load_session_checkpoint(ckpt, s.sid, t)
                                     for t in steps],
                counts={k: m[k] for k in COUNTS}, registry=pipe.registry.get(
                    "/session/chunks").value, status=s.status())


def test_session_chunked_stream_bit_identity(tmp_path):
    mine, theirs = both(_chunked, str(tmp_path))
    states = chunked_oracle(u0_of(1), [(4, 1.0, None), (4, 1.0, None), (2, 1.0, None)])
    assert mine["state"] == "done" and mine["step"] == 10
    assert np.array_equal(mine["result"], states[-1]) and mine["result"].dtype == np.float64
    kinds = [(f.step, f.kind) for f in mine["frames"]]
    assert kinds == [(0, "preview"), (4, "preview"), (8, "preview"), (10, "preview"),
                     (10, "final")]
    for f, u in zip(mine["frames"][:-1], states, strict=True):
        assert f.values.dtype == np.float32 and np.array_equal(f.values, preview_of(u, 3))
    assert mine["tail"] == [(8, "preview"), (10, "preview"), (10, "final")]
    assert mine["ckpts"] == [4, 8, 10] and mine["registry"] == 3
    for (u, t, params), want in zip(mine["states"], states[1:], strict=True):
        assert np.array_equal(u, want) and params["session"] == "s0"
    assert mine["counts"]["chunks"] == 3 and mine["counts"]["frames"] == 5
    # against the JAX package
    close64(mine["result"], theirs["result"])
    close_frames(mine["frames"], theirs["frames"])
    for (ua, ta, pa), (ub, tb, pb) in zip(mine["states"], theirs["states"], strict=True):
        close64(ua, ub)
        assert ta == tb and pa == pb
    for key in ("state", "step", "tail", "ckpts", "counts", "registry", "status"):
        assert mine[key] == theirs[key], key


# ---------------------------------------------------------------------------
# retarget at the chunk boundary
# ---------------------------------------------------------------------------


def _retarget(ns, tmp, monkeypatch):
    events = os.path.join(tmp, f"events-{ns.name}.jsonl")
    monkeypatch.setenv("NLHEAT_EVENT_LOG", events)
    b = np.full((G, G), 0.25)
    out = {}
    with ns.pipe() as pipe:
        with ns.Manager(pipe, chunk_steps=3) as mgr:
            s = mgr.open(shape=(G, G), u0=u0_of(2), nt=9, **PHYS)
            out["ticket"] = mgr.retarget(s.sid, k=1.5, source=b)
            mgr.drive(timeout_s=120)
            out["r1"], out["audit1"] = s.result(), s.status()["audit"]
            s2 = mgr.open(shape=(G, G), u0=u0_of(2), nt=6, **PHYS)
            mgr.retarget(s2.sid, source=b)
            while s2.step < 3:
                mgr.pump(block=True)
            out["ticket2"] = mgr.retarget(s2.sid, clear_source=True)
            mgr.drive(timeout_s=120)
            out["r2"], out["audit2"] = s2.result(), s2.status()["audit"]
            out["frames"] = s.frames_after(-1) + s2.frames_after(-1)
            out["counts"] = {k: mgr.metrics()[k] for k in COUNTS}
    monkeypatch.delenv("NLHEAT_EVENT_LOG")
    with open(events) as f:
        lines = [json.loads(ln) for ln in f]
    out["events"] = [{k: v for k, v in ln.items() if k not in ("pid", "seq", "t")}
                     for ln in lines if ln["event"].startswith("session-")]
    return out


def test_retarget_at_chunk_boundary_determinism(tmp_path, monkeypatch):
    mine, theirs = both(_retarget, str(tmp_path), monkeypatch)
    b = np.full((G, G), 0.25)
    states = chunked_oracle(u0_of(2), [(3, 1.0, None), (3, 1.5, b), (3, 1.5, b)])
    assert np.array_equal(mine["r1"], states[-1])
    assert mine["ticket"]["requested_at_step"] == 0
    assert mine["audit1"] == [{"verb": "retarget", "applied_at_step": 3,
                               "requested_at_step": 0, "k": 1.5, "source": "set"}]
    states2 = chunked_oracle(u0_of(2), [(3, 1.0, None), (3, 1.0, b)])
    assert np.array_equal(mine["r2"], states2[-1])
    kinds = [e["event"] for e in mine["events"]]
    for kind in ("session-open", "session-chunk", "session-retarget",
                 "session-retarget-applied", "session-done"):
        assert kind in kinds
    applied = next(e for e in mine["events"] if e["event"] == "session-retarget-applied")
    assert applied["applied_at_step"] == 3
    close64(mine["r1"], theirs["r1"])
    close64(mine["r2"], theirs["r2"])
    close_frames(mine["frames"], theirs["frames"])
    for key in ("ticket", "ticket2", "audit1", "audit2", "counts", "events"):
        assert mine[key] == theirs[key], key


# ---------------------------------------------------------------------------
# fork and resume
# ---------------------------------------------------------------------------


def _fork_resume(ns, tmp, capsys):
    ckpt, ckpt_b = os.path.join(tmp, ns.name, "a"), os.path.join(tmp, ns.name, "b")
    out = {}
    with ns.pipe() as pipe:  # arm A: uninterrupted
        with ns.Manager(pipe, checkpoint_dir=ckpt, chunk_steps=4) as mgr:
            a = mgr.open(shape=(G, G), u0=u0_of(3), nt=16, checkpoint_every=1, **PHYS)
            mgr.drive(timeout_s=180)
            out["want_frames"] = list(mgr.stream(a.sid, from_step=-1, timeout_s=5))
            out["want_final"] = a.result()
            sid_a = a.sid
    with ns.pipe() as pipe:  # arm B: the manager dies after 2 chunks
        mgr = ns.Manager(pipe, checkpoint_dir=ckpt_b, chunk_steps=4)
        b = mgr.open(shape=(G, G), u0=u0_of(3), nt=16, checkpoint_every=1, **PHYS)
        sid = b.sid
        while b.step < 8:
            mgr.pump(block=True)
        out["pre"] = b.frames_after(-1)
        out["retained"] = ns.ckpt.list_session_checkpoints(ckpt_b, sid)
        mgr.close()
    with ns.pipe() as pipe:
        with ns.Manager(pipe, checkpoint_dir=ckpt_b) as mgr2:
            br = mgr2.resume(sid)
            out["resumed"] = (br.resumed_from, br.step, br.status()["audit"])
            mgr2.drive(timeout_s=180)
            out["post"] = list(mgr2.stream(sid, from_step=-1, timeout_s=5))
            out["resumed_final"] = br.result()
            out["resumes"] = mgr2.metrics()["resumes"]
    newest = ns.ckpt.session_checkpoint_path(
        ckpt, sid_a, ns.ckpt.list_session_checkpoints(ckpt, sid_a)[-1])
    with open(newest, "wb") as f:
        f.write(b"torn")
    capsys.readouterr()
    with ns.pipe() as pipe:
        with ns.Manager(pipe, checkpoint_dir=ckpt) as mgr3:
            c = mgr3.resume(sid_a)
            out["fallback_step"] = c.step
            mgr3.drive(timeout_s=180)
            out["fallback_final"] = c.result()
    out["stderr"] = capsys.readouterr().err.replace(os.path.join(tmp, ns.name), "<dir>")
    return out


def test_fork_and_manager_death_resume_bit_identical(tmp_path, capsys):
    mine, theirs = both(_fork_resume, str(tmp_path), capsys)
    want = frames_by_step(mine["want_frames"])
    assert mine["retained"] == [4, 8] and mine["resumed"][:2] == (8, 8)
    got = frames_by_step(mine["pre"])
    dupes = 0
    for f in mine["post"]:
        key = (f.step, f.kind)
        if key in got:
            dupes += 1
            assert np.array_equal(got[key], f.values)
        got[key] = np.array(f.values)
    assert dupes >= 1 and set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key], want[key]), key
    assert np.array_equal(mine["resumed_final"], mine["want_final"])
    assert mine["resumes"] == 1 and mine["fallback_step"] == 12
    assert np.array_equal(mine["fallback_final"], mine["want_final"])
    assert "unreadable" in mine["stderr"]
    states = chunked_oracle(u0_of(3), [(4, 1.0, None)] * 4)
    assert np.array_equal(mine["want_final"], states[-1])
    for key in ("want_final", "resumed_final", "fallback_final"):
        close64(mine[key], theirs[key])
    for key in ("want_frames", "pre", "post"):
        close_frames(mine[key], theirs[key])
    for key in ("retained", "resumed", "resumes", "fallback_step", "stderr"):
        assert mine[key] == theirs[key], key


def _fork_branch(ns, tmp):
    b = np.full((G, G), -0.5)
    with ns.pipe() as pipe:
        with ns.Manager(pipe, checkpoint_dir=os.path.join(tmp, ns.name),
                        chunk_steps=4) as mgr:
            parent = mgr.open(shape=(G, G), u0=u0_of(4), nt=12, checkpoint_every=1, **PHYS)
            while parent.step < 4:
                mgr.pump(block=True)
            child = mgr.fork(parent.sid, step=4)
            where = (child.parent, child.step)
            mgr.retarget(child.sid, source=b)
            mgr.drive(timeout_s=180)
            return dict(where=where, parent=parent.result(), child=child.result(),
                        audit=child.status()["audit"], forks=mgr.metrics()["forks"],
                        status=(parent.status(), child.status()))


def test_fork_branches_and_parent_unaffected(tmp_path):
    mine, theirs = both(_fork_branch, str(tmp_path))
    b = np.full((G, G), -0.5)
    p_states = chunked_oracle(u0_of(4), [(4, 1.0, None)] * 3)
    c_states = chunked_oracle(p_states[1], [(4, 1.0, None), (4, 1.0, b)])
    assert mine["where"] == (("s0", 4), 4)
    assert np.array_equal(mine["parent"], p_states[-1])
    assert np.array_equal(mine["child"], c_states[-1])
    assert mine["audit"][0] == {"verb": "fork", "parent": "s0", "from_step": 4}
    assert mine["forks"] == 1
    close64(mine["parent"], theirs["parent"])
    close64(mine["child"], theirs["child"])
    for key in ("where", "audit", "forks", "status"):
        assert mine[key] == theirs[key], key


# ---------------------------------------------------------------------------
# die@ chaos over a real fleet
# ---------------------------------------------------------------------------


def _chaos_reference(ns):
    """The same session and fork over the in-process pipeline, no chaos."""
    with ns.pipe() as pipe:
        with ns.Manager(pipe, chunk_steps=4) as mgr:
            s = mgr.open(shape=(G, G), u0=u0_of(5), nt=12, **PHYS)
            while s.step < 8:
                mgr.pump(block=True)
            child = mgr.fork(s.sid)
            mgr.drive(timeout_s=120)
            return s.result(), child.result(), s.frames_after(-1)


def test_die_chaos_mid_session_and_mid_fork_bit_identical(tmp_path):
    states = chunked_oracle(u0_of(5), [(4, 1.0, None)] * 3)
    with ReplicaRouter(replicas=2, faults="die@1,die@4", respawn=True, **KW) as router:
        with SessionManager(router, checkpoint_dir=str(tmp_path), chunk_steps=4) as mgr:
            s = mgr.open(shape=(G, G), u0=u0_of(5), nt=12, checkpoint_every=1, **PHYS)
            while True:
                mgr.pump(block=True)
                if s.step >= 8:
                    break
            child = mgr.fork(s.sid, step=8)
            mgr.drive(timeout_s=300)
            assert s.state == "done" and child.state == "done"
            assert np.array_equal(s.result(), states[-1])
            assert np.array_equal(child.result(), states[-1])
            frames = list(mgr.stream(s.sid, from_step=-1, timeout_s=5))
            assert [(f.step, f.kind) for f in frames] == [
                (0, "preview"), (4, "preview"), (8, "preview"), (12, "preview"),
                (12, "final")]
        m = router.metrics()
        assert m["deaths"] >= 1 and m["requeued"] >= 1 and m["outstanding"] == 0
        assert any(key[0] == "session" for key in router._owner)
    jfinal, jchild, jframes = _chaos_reference(JAX)
    close64(s.result(), jfinal)
    close64(child.result(), jchild)
    close_frames(frames, jframes)


# ---------------------------------------------------------------------------
# budgets (injected clock, stub backends)
# ---------------------------------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _StubRequest:
    def __init__(self, case, seq, submit_t):
        self.case = case
        self.seq = seq
        self.submit_t = submit_t
        self.result = None
        self.error = None
        self.latency_s = None
        self.replica = 0
        self.requeues = 0
        self.done = threading.Event()


def stub_backend(ns, clock, max_outstanding=4):
    """A router-shaped backend of the side ``ns`` with test-controlled
    completion and an injected clock."""

    class Backend:
        def __init__(self):
            self.registry = ns.Registry()
            self.max_outstanding = max_outstanding
            self.clock = clock
            self._pending = []
            self._seq = 0
            self._lat = self.registry.histogram("/router/request-latency-ms")
            self.registry.gauge("/router/outstanding")

        def live_count(self):
            return 1

        def outstanding_total(self):
            return len(self._pending)

        def retry_after_s(self):
            return 0.25

        def submit(self, case, deadline_ms=None, priority=0, sticky_key=None, trace=None,
                   engine=None):
            if len(self._pending) >= self.max_outstanding:
                raise ns.Overloaded(len(self._pending), self.max_outstanding, 0.25)
            req = _StubRequest(case, self._seq, self.clock())
            self._seq += 1
            self._pending.append(req)
            return req

        def finish(self, n=1):
            for _ in range(n):
                req = self._pending.pop(0)
                req.result = np.asarray(req.case.u0, np.float64)
                req.latency_s = self.clock() - req.submit_t
                self._lat.observe(req.latency_s * 1e3)
                req.done.set()

    return Backend()


def _greedy_sessions(mgr, n, budget=0):
    return [mgr.open(shape=(G, G), u0=u0_of(10 + i), nt=None, chunk_steps=4,
                     budget_steps=budget, preview_stride=4, checkpoint_every=0, **PHYS)
            for i in range(n)]


def _budget(ns):
    obs = []
    clock = _FakeClock()
    backend = stub_backend(ns, clock)
    adm = ns.Admission(backend, max_pending=4, max_queue_wait_ms=250.0,
                       session_steps_per_s=8.0, clock=clock)
    reg = backend.registry
    with ns.Manager(backend, admission=adm, clock=clock) as mgr:
        _greedy_sessions(mgr, 8)
        obs += [mgr.pump(), backend.outstanding_total(), mgr.metrics()["deferrals"],
                reg.get("/ingress/session-deferred").value]
        for i in range(2):
            req, retry = adm.try_submit(ns.Case(shape=(G, G), nt=2, test=False,
                                                u0=u0_of(30 + i), **PHYS))
            obs.append((req is not None, retry))
        backend.finish(4)
        clock.advance(0.1)
        obs += [reg.get("/router/request-latency-ms").percentiles()["p99"],
                reg.get("/ingress/shed").value]
        clock.advance(0.5)
        obs += [mgr.pump(), backend.outstanding_total(), reg.get("/ingress/session-steps").value]
        obs.append([s.status()["deferrals"] for s in mgr.sessions()])
    clock2 = _FakeClock()
    backend2 = stub_backend(ns, clock2)
    adm2 = ns.Admission(backend2, max_pending=4, clock=clock2)
    with ns.Manager(backend2, admission=adm2, clock=clock2) as mgr2:
        _greedy_sessions(mgr2, 8)
        mgr2.pump()
        obs.append(backend2.outstanding_total())
        req, retry = adm2.try_submit(ns.Case(shape=(G, G), nt=2, test=False, u0=u0_of(40),
                                             **PHYS))
        obs += [req is None, retry, backend2.registry.get("/ingress/shed").value]
    return obs


def test_session_budget_cannot_starve_batch():
    mine, theirs = both(_budget)
    assert mine == theirs
    assert mine[:4] == [2, 2, 6, 6]
    assert mine[4:6] == [(True, None), (True, None)]
    assert mine[6] <= 250.0 and mine[7] == 0
    assert mine[8:11] == [3, 1, 12]
    assert mine[12] == 4 and mine[13] is True and mine[14] > 0 and mine[15] == 1


def _window(ns, monkeypatch):
    clock = _FakeClock()
    backend = stub_backend(ns, clock, max_outstanding=8)
    obs = []
    with ns.Manager(backend, clock=clock) as mgr:
        s = mgr.open(shape=(G, G), u0=u0_of(11), nt=12, chunk_steps=4, budget_steps=4,
                     budget_window_s=1.0, checkpoint_every=0, **PHYS)
        obs.append(mgr.pump())
        backend.finish(1)
        obs += [mgr.pump(), s.step, mgr.pump(), s.status()["deferrals"]]
        clock.advance(1.1)
        obs.append(mgr.pump())
        backend.finish(1)
        monkeypatch.setenv("NLHEAT_SESSION_BUDGET", "16")
        s2 = mgr.open(shape=(G, G), u0=u0_of(12), nt=4, chunk_steps=4, checkpoint_every=0,
                      **PHYS)
        monkeypatch.delenv("NLHEAT_SESSION_BUDGET")
        obs += [s2.spec.budget_steps, s.status(), mgr.metrics()["deferrals"]]
    return obs


def test_per_session_budget_window(monkeypatch):
    mine, theirs = both(_window, monkeypatch)
    assert mine == theirs
    assert mine[:6] == [1, 1, 4, 0, 1, 1] and mine[6] == 16


def _close_mid_stream(ns):
    clock = _FakeClock()
    backend = stub_backend(ns, clock)
    obs = []
    with ns.Manager(backend, clock=clock) as mgr:
        s = mgr.open(shape=(G, G), u0=u0_of(13), nt=None, chunk_steps=4, checkpoint_every=0,
                     **PHYS)
        mgr.pump()
        backend.finish(1)
        mgr.pump()
        obs.append([(f.step, f.kind) for f in s.frames_after(-1)])
        obs.append(mgr.close_session(s.sid))
        due = s.frames_after(4, 0)
        obs.append([(f.step, f.kind, f.values.dtype) for f in due])
        obs.append([(f.step, f.kind) for f in mgr.stream(s.sid, from_step=4, timeout_s=1)])
        s2 = mgr.open(shape=(G, G), u0=u0_of(14), nt=8, chunk_steps=4, checkpoint_every=0,
                      **PHYS)
        with s2._lock:
            s2._pump_busy = True
        obs.append(mgr.pump())
        with s2._lock:
            s2._pump_busy = False
        obs.append(mgr.pump())
        obs.append({k: mgr.metrics()[k] for k in COUNTS})
    return obs, due


def test_close_mid_stream_delivers_final_frame():
    (mine, due), (theirs, jdue) = both(_close_mid_stream)
    assert mine == theirs
    assert mine[0] == [(0, "preview"), (4, "preview")]
    assert mine[2] == [(4, "final", np.float64)] and mine[3] == [(4, "final")]
    assert mine[4:6] == [0, 1]
    # the stub serves u0 back: the final field is the opening state, bitwise
    assert np.array_equal(due[0].values, u0_of(13)) and np.array_equal(jdue[0].values,
                                                                       due[0].values)


# ---------------------------------------------------------------------------
# HTTP surface over a real fleet: open / stream (SSE) / retarget / fork /
# close / result
# ---------------------------------------------------------------------------


def _post(base, path, payload):
    try:
        r = urllib.request.urlopen(urllib.request.Request(base + path,
                                                          json.dumps(payload).encode()))
        return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def _sse(base, path):
    raw = urllib.request.urlopen(base + path, timeout=120).read().decode()
    return raw, [json.loads(ln[len("data: "):]) for ln in raw.splitlines()
                 if ln.startswith("data: ")]


def _http_reference(ns):
    """The HTTP test's sessions through the side's in-process manager: the
    parent's frames and the fork's final field."""
    with ns.pipe() as pipe:
        with ns.Manager(pipe, checkpoint_dir=None, chunk_steps=4) as mgr:
            s = mgr.open(shape=(G, G), u0=u0_of(6), nt=8, checkpoint_every=0, **PHYS)
            while s.step < 4:
                mgr.pump(block=True)
            child = mgr.fork(s.sid)
            mgr.drive(timeout_s=120)
            return s.frames_after(-1), child.result()


def test_http_session_endpoints_end_to_end(tmp_path):
    import io

    u0 = u0_of(6)
    states = chunked_oracle(u0, [(4, 1.0, None), (4, 1.0, None)])
    codes = []
    with ReplicaRouter(replicas=1, **KW) as router:
        adm = thttp.AdmissionController(router)
        with SessionManager(router, admission=adm, checkpoint_dir=str(tmp_path),
                            chunk_steps=4) as mgr:
            mgr.start_driver()
            with thttp.IngressServer(0, router, admission=adm, sessions=mgr) as ing:
                base = f"http://127.0.0.1:{ing.port}"
                body = dict(shape=[G, G], nt=8, eps=PHYS["eps"], k=PHYS["k"], dt=PHYS["dt"],
                            dh=PHYS["dh"], u0=u0.tolist(), chunk_steps=4, checkpoint_every=1)
                st, r = _post(base, "/v1/sessions", body)
                assert st == 201 and r["status"] == "running"
                sid = r["session"]
                assert r["stream"] == f"/v1/sessions/{sid}/stream"
                raw, frames = _sse(base, f"/v1/sessions/{sid}/stream?timeout_s=60")
                assert [(f["step"], f["kind"]) for f in frames[:-1]] == [
                    (0, "preview"), (4, "preview"), (8, "preview"), (8, "final")]
                assert "event: end" in raw and frames[-1]["state"] == "done"
                for f, u in zip(frames[:3], states, strict=True):
                    assert np.array_equal(np.asarray(f["values"], np.float32).reshape(
                        f["shape"]), preview_of(u, 4))
                final = np.asarray(frames[-2]["values"]).reshape(frames[-2]["shape"])
                assert np.array_equal(final, states[-1])
                r = json.load(urllib.request.urlopen(base + f"/v1/sessions/{sid}"))
                assert r["state"] == "done" and r["step"] == 8
                r = json.load(urllib.request.urlopen(base + f"/v1/sessions/{sid}/result"))
                assert np.array_equal(np.asarray(r["values"]).reshape(r["shape"]), states[-1])
                raw_bin = urllib.request.urlopen(
                    base + f"/v1/sessions/{sid}/result?bin=1").read()
                assert np.array_equal(np.load(io.BytesIO(raw_bin)), states[-1])
                st, r = _post(base, f"/v1/sessions/{sid}/fork", {"step": 4})
                assert st == 201 and r["from_step"] == 4 and r["parent"] == sid
                child = r["session"]
                _, cframes = _sse(base, f"/v1/sessions/{child}/stream?timeout_s=60")
                finals = [f for f in cframes if f.get("kind") == "final"]
                cfinal = np.asarray(finals[-1]["values"]).reshape(finals[-1]["shape"])
                assert np.array_equal(cfinal, states[-1])
                st, r = _post(base, "/v1/sessions", dict(body, nt=4000))
                assert st == 201
                slow = r["session"]
                st, early = _post(base, f"/v1/sessions/{slow}/retarget", {"k": 2.0})
                codes.append(st)
                try:
                    urllib.request.urlopen(base + f"/v1/sessions/{slow}/result")
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
                st, r = _post(base, f"/v1/sessions/{slow}/close", {})
                assert st == 200 and r["state"] == "closed"
                codes.append(st)
                for path, payload in (("/v1/sessions", {"shape": [G, G]}),
                                      ("/v1/sessions/nope/retarget", {"k": 2.0}),
                                      (f"/v1/sessions/{sid}/explode", {}),
                                      ("/v1/sessions", dict(body, test=True))):
                    codes.append(_post(base, path, payload))
                health = json.load(urllib.request.urlopen(base + "/healthz"))
                status = json.load(urllib.request.urlopen(base + "/v1/status"))
                text = urllib.request.urlopen(base + "/metrics").read().decode()
    assert early["session"] == slow and early["requested_at_step"] >= 0
    assert codes[:3] == [202, 409, 200]
    assert codes[3][0] == 400 and "missing case field" in codes[3][1]["error"]
    assert codes[4] == (404, {"error": "no live session 'nope'"})
    assert codes[5] == (404, {"error": "no session verb 'explode'"})
    assert codes[6][0] == 400 and "test" in codes[6][1]["error"]
    assert "sessions" in health and "sessions" in status
    assert "nlheat_session_opened" in text and "nlheat_session_chunks" in text
    jframes, jchild = _http_reference(JAX)
    close64(final, np.asarray(jframes[-1].values))
    close64(cfinal, jchild)
    assert [(f["step"], f["kind"]) for f in frames[:-1]] == [(f.step, f.kind) for f in jframes]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

OK = dict(shape=(G, G), u0=u0_of(7), nt=8, **PHYS)
SPEC_REFUSALS = [
    (dict(OK, u0=None), "needs an initial state"),
    (dict(OK, nt=0), "nt must be"),
    (dict(OK, shape=(0,)), "bad session shape"),
    (dict(OK, chunk_steps=0), "chunk_steps"),
    (dict(OK, u0=np.zeros(3)), "u0 has 3 values"),
    (dict(OK, budget_steps=-1), "budget_steps"),
    (dict(OK, preview_stride=0), "preview_stride"),
    (dict(OK, checkpoint_every=-1), "checkpoint_every"),
    (dict(OK, eps=0), "eps must be"),
    (dict(OK, budget_window_s=0), "budget_window_s"),
]


@pytest.mark.parametrize("bad,msg", SPEC_REFUSALS, ids=[m for _, m in SPEC_REFUSALS])
def test_session_spec_refusals(bad, msg):
    words = []
    for ns in (PORT, JAX):
        with pytest.raises(ValueError, match=msg) as e:
            ns.Spec(**bad).validate()
        words.append(str(e.value))
    assert words[0] == words[1]


def _words(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)
    return None


def _manager_refusals(ns, tmp):
    clock = _FakeClock()
    backend = stub_backend(ns, clock)
    out = []
    with ns.Manager(backend, clock=clock) as mgr:
        s = mgr.open(**OK)
        sp = ns.Spec(**dict(OK, preview_stride=2.5, budget_steps="10",
                            chunk_steps=4.0)).validate()
        out.append((sp.preview_stride, sp.budget_steps, sp.chunk_steps,
                    type(sp.chunk_steps).__name__))
        out += [_words(lambda: mgr.retarget(s.sid)),
                _words(lambda: mgr.retarget(s.sid, source=[1.0, 2.0])),
                _words(lambda: mgr.get("nope")), _words(lambda: mgr.resume("nope")),
                _words(lambda: mgr.fork(s.sid, step=4)),
                _words(lambda: mgr.open(ns.Spec(**OK), nt=3)),
                _words(lambda: mgr.open(sid=s.sid, **OK))]
        mgr.close_session(s.sid)
        out.append(_words(lambda: mgr.retarget(s.sid, k=2.0)))
        mgr.close_session(s.sid)
        out.append(backend.registry.get("/session/closed").value)
    out.append(_words(lambda: mgr.open(**OK)))
    with ns.Manager(backend, clock=clock, retain_ended=2) as mgr:
        sids = []
        for i in range(4):
            si = mgr.open(**dict(OK, u0=u0_of(20 + i)))
            sids.append(si.sid)
            mgr.close_session(si.sid)
        out.append((sids, sorted(mgr._sessions)))
    ckpt = os.path.join(tmp, ns.name)
    with ns.Manager(backend, clock=clock, checkpoint_dir=ckpt) as mgr:
        s = mgr.open(**OK)
        out += [_words(lambda: mgr.resume(s.sid)),
                _words(lambda: mgr.resume("never-existed")),
                _words(lambda: mgr.fork(s.sid, step=99))]
    out.append(ns.Session("s9", ns.Spec(**OK).validate()).sticky_key())
    return [o if not isinstance(o, tuple) or len(o) != 2 or not isinstance(o[1], str)
            else (o[0], o[1].replace(ckpt, "<dir>")) for o in out]


def test_session_spec_and_manager_refusals(tmp_path):
    mine, theirs = both(_manager_refusals, str(tmp_path))
    assert mine == theirs
    assert mine[0] == (2, 10, 4, "int")
    assert mine[1] == ("ValueError", "retarget needs k=, source=, or clear_source=True")
    assert mine[3][0] == "KeyError" and mine[4][0] == mine[5][0] == "ValueError"
    assert mine[8][0] == "ValueError" and "running" in mine[8][1] and mine[9] == 1
    assert mine[10] == ("RuntimeError", "session manager is closed")
    assert mine[11] == (["s0", "s1", "s2", "s3"], ["s2", "s3"])
    assert mine[12][0] == "ValueError" and "already live" in mine[12][1]
    assert mine[13][0] == mine[14][0] == "FileNotFoundError"
    assert mine[-1] == ("session", "s9")


# ---------------------------------------------------------------------------
# beyond the JAX tests: a mesh session, and checkpoints across the packages
# ---------------------------------------------------------------------------


def _cloud(n=10, seed=3):
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pts = np.stack([ii.ravel(), jj.ravel()], axis=1) / n
    return pts + rng.uniform(-0.1, 0.1, pts.shape) / n, 3.0 / n


def _mesh_session(ns, mhash, n):
    u0 = np.random.default_rng(8).normal(size=n)
    kw = dict(device="cpu", dtype=F64) if ns is PORT else {}
    server = ServePipeline if ns is PORT else JPipeline
    with server(method="gather", batch_sizes=(1,), depth=1, window_ms=0.0, **kw) as pipe:
        with ns.Manager(pipe, chunk_steps=3) as mgr:
            s = mgr.open(shape=(n,), u0=u0, nt=7, eps=0, k=1.0, dt=1e-6, dh=0.0, mesh=mhash,
                         preview_stride=2, checkpoint_every=0)
            mgr.retarget(s.sid, source=np.linspace(0.0, 1.0, n))
            mgr.drive(timeout_s=120)
            return u0, s.result(), s.frames_after(-1), s.status()


def test_mesh_session_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("NLHEAT_MESH_DIR", str(tmp_path))
    pts, eps = _cloud()
    mhash = MeshStore(str(tmp_path)).put(pts, eps)
    n = len(pts)
    (u0, got, frames, status), (_, jgot, jframes, jstatus) = both(_mesh_session, mhash, n)
    src = np.linspace(0.0, 1.0, n)
    states = chunked_oracle(u0, [(3, 1.0, None), (3, 1.0, src), (1, 1.0, src)],
                            method="gather", eps=0, dt=1e-6, dh=0.0, mesh=mhash)
    assert status["state"] == "done" and status["step"] == 7
    assert np.array_equal(got, states[-1]) and np.isfinite(got).all()
    assert [(f.step, f.kind) for f in frames] == [(0, "preview"), (3, "preview"),
                                                  (6, "preview"), (7, "preview"),
                                                  (7, "final")]
    for f, u in zip(frames[:-1], states, strict=True):
        assert np.array_equal(f.values, preview_of(u, 2))
    close64(got, jgot)
    close_frames(frames, jframes)
    assert status == jstatus


def test_session_checkpoints_across_the_packages(tmp_path, capsys):
    d = str(tmp_path)
    for sid, step in (("s0", 0), ("s12", 48), ("my-run", 7)):
        assert tckpt.session_checkpoint_path(d, sid, step) == \
            jckpt.session_checkpoint_path(d, sid, step)
    for bad in ("a@b", "a/b", "../x"):
        assert _words(lambda: tckpt.session_checkpoint_path(d, bad, 1)) == \
            _words(lambda: jckpt.session_checkpoint_path(d, bad, 1))
    rng = np.random.default_rng(9)
    params = dict(shape=[G, G], eps=2, k=1.5, dt=1e-5, dh=1.0 / G, mesh=None, nt=16,
                  chunk_steps=4, source=rng.normal(size=4).tolist())
    saved = {}
    for name, writer, reader in (("a", jckpt, tckpt), ("b", tckpt, jckpt)):
        for step in (4, 8, 12):
            u = rng.normal(size=(G, G))
            path = writer.save_session_checkpoint(d, name, step, u, params, keep=2)
            assert path == reader.session_checkpoint_path(d, name, step)
            saved[(name, step)] = u
        assert tckpt.list_session_checkpoints(d, name) == \
            jckpt.list_session_checkpoints(d, name) == [8, 12]
        for step in (8, None):
            u, t, p = reader.load_session_checkpoint(d, name, step)
            u2, t2, p2 = writer.load_session_checkpoint(d, name, step)
            want = saved[(name, 8 if step else 12)]
            assert np.array_equal(u, want) and np.array_equal(u2, want) and u.dtype == want.dtype
            assert t == t2 and p == p2 == dict(params, session=name)
    # refusals: a missing step, nothing retained, a truncated and a torn file
    for fn in (lambda m: m.load_session_checkpoint(d, "a", 4),
               lambda m: m.load_session_checkpoint(d, "nobody")):
        assert _words(lambda: fn(tckpt)) == _words(lambda: fn(jckpt))
    path12 = tckpt.session_checkpoint_path(d, "a", 12)
    with open(path12, "rb") as f:
        whole = f.read()
    for damaged in (whole[: len(whole) // 2], b"torn"):
        with open(path12, "wb") as f:
            f.write(damaged)
        assert _words(lambda: tckpt.load_session_checkpoint(d, "a", 12)) == \
            _words(lambda: jckpt.load_session_checkpoint(d, "a", 12))
        capsys.readouterr()
        u, t, _ = tckpt.load_session_checkpoint(d, "a")
        mine = capsys.readouterr().err
        ju, jt, _ = jckpt.load_session_checkpoint(d, "a")
        assert t == jt == 8 and np.array_equal(u, ju) and mine == capsys.readouterr().err
        assert "newest checkpoint unreadable" in mine
    flipped = bytearray(whole)
    flipped[len(flipped) // 2] ^= 0xFF
    with open(path12, "wb") as f:
        f.write(bytes(flipped))
    assert _words(lambda: tckpt.load_session_checkpoint(d, "a", 12)) == \
        _words(lambda: jckpt.load_session_checkpoint(d, "a", 12))
    with open(tckpt.session_checkpoint_path(d, "a", 8), "wb") as f:
        f.write(b"torn")
    words = _words(lambda: tckpt.load_session_checkpoint(d, "a"))
    assert words == _words(lambda: jckpt.load_session_checkpoint(d, "a"))
    assert words[0] == "ValueError" and "every retained checkpoint" in words[1]


def test_backend_failure_fails_the_session_and_propagates():
    """The port's rule for a failure the backend raises past its
    classification (its pipeline on the card re-raises any failure that was
    not injected): the session fails with the error, the error propagates
    out of the pump, and the chunk is not submitted again.  The JAX
    pipeline classifies every failure, so this path has no JAX analog."""
    clock = _FakeClock()
    backend = stub_backend(PORT, clock)
    real = backend.submit

    def submit(case, **kw):
        if case.u0 is not None and backend._seq == 1:
            raise RuntimeError("CUDA error: unspecified launch failure")
        return real(case, **kw)

    backend.submit = submit
    with SessionManager(backend, clock=clock) as mgr:
        s = mgr.open(shape=(G, G), u0=u0_of(15), nt=8, chunk_steps=4, checkpoint_every=0,
                     **PHYS)
        assert mgr.pump() == 1
        backend.finish(1)
        assert mgr.pump() == 1 and s.step == 4
        with pytest.raises(RuntimeError, match="launch failure"):
            mgr.pump()
        assert s.state == "failed" and s.inflight is None and "launch" in s.status()["error"]
        assert mgr.pump() == 0 and backend._seq == 1
        m = mgr.metrics()
        assert (m["failed"], m["active"], m["chunks"]) == (1, 0, 1)

    class Handle:  # a pipeline-shaped handle whose fence fails on the card
        result = error = None

        def wait(self):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    class Pipe:
        registry = MetricsRegistry()

        def submit(self, case, **kw):
            return Handle()

        def pump(self):
            pass

    with SessionManager(Pipe()) as mgr:
        s = mgr.open(shape=(G, G), u0=u0_of(16), nt=8, chunk_steps=4, checkpoint_every=0,
                     **PHYS)
        assert mgr.pump() == 1
        with pytest.raises(RuntimeError, match="illegal memory access"):
            mgr.pump(block=True)
        assert s.state == "failed" and mgr.metrics()["failed"] == 1


def _stress(ns):
    """Sixteen reader threads stream four sessions of a driverless manager
    at once (each stream pumps), over a thread-safe backend whose chunks
    complete at submit, with a short thread switch interval.  Returns per
    session: the chunks submitted, the frames each reader saw, the state."""
    import sys

    class Backend:
        def __init__(self):
            self.registry = ns.Registry()
            self.lock = threading.Lock()
            self.submitted = {}

        def submit(self, case, priority=0, sticky_key=None, **kw):
            with self.lock:
                self.submitted[sticky_key] = self.submitted.get(sticky_key, 0) + 1
            req = _StubRequest(case, 0, 0.0)
            req.result = np.asarray(case.u0, np.float64) * 0.5
            req.done.set()
            return req

    backend = Backend()
    seen = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ns.Manager(backend) as mgr:
            sessions = [mgr.open(shape=(G, G), u0=u0_of(50 + i), nt=40, chunk_steps=4,
                                 preview_stride=6, checkpoint_every=0, **PHYS)
                        for i in range(4)]

            def read(j):
                s = sessions[j % 4]
                seen[j] = [(f.step, f.kind) for f in mgr.stream(s.sid, timeout_s=60)]

            threads = [threading.Thread(target=read, args=(j,)) for j in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            return ([backend.submitted[s.sticky_key()] for s in sessions],
                    [seen[j] for j in range(16)],
                    [(s.state, s.step, s.status()["chunks"]) for s in sessions],
                    [s.result() for s in sessions])
    finally:
        sys.setswitchinterval(old)


def test_concurrent_streams_never_double_submit():
    """Every reader sees the whole stream.  The JAX reader reads the frames
    and the state under two separate locks, so a session that ends between
    them can end a stream with its last frames unread: the port reads both
    in one critical section, and only the port's streams are held whole."""
    (mine, mframes, mstate, mres), (theirs, _, jstate, jres) = both(_stress)
    want = [(t, "preview") for t in range(0, 41, 4)] + [(40, "final")]
    assert mine == theirs == [10] * 4
    assert all(f == want for f in mframes), [f for f in mframes if f != want]
    assert mstate == jstate == [("done", 40, 10)] * 4
    for i, (a, b) in enumerate(zip(mres, jres, strict=True)):
        assert np.array_equal(a, u0_of(50 + i) * 0.5 ** 10) and np.array_equal(a, b)


def test_measurement_helpers(tmp_path):
    """session_resume_ab and session_stream_bench, the two measurement
    helpers of the module: the resume A/B answers as the JAX one does at a
    small grid (bit-identical, resumed from the kill point), and the stream
    bench drives its sessions beside a paced batch load over a one-replica
    fleet, every chunk of every session streamed."""
    from nonlocalheatequation_torch.serve.sessions import session_resume_ab, session_stream_bench
    from nonlocalheatequation_tpu.serve.sessions import session_resume_ab as jresume_ab

    kw = dict(grid=G, chunk_steps=3, chunks=4, eps=2, dt=1e-5)
    mine = session_resume_ab(dict(method="sat", batch_sizes=(1,), device="cpu", dtype=F64),
                             ckpt_dir=str(tmp_path / "mine"), **kw)
    theirs = jresume_ab(dict(method="sat", batch_sizes=(1,)), ckpt_dir=str(tmp_path / "theirs"),
                        **kw)
    assert mine == theirs == {"bit_identical": True, "resumed_from": 6, "kill_at": 6,
                              "frames": 6}
    out = session_stream_bench(KW, sessions=2, grid=G, chunk_steps=2, chunks=3, batch_cases=2,
                               replicas=1, eps=2, queue_wait_bound_ms=60_000.0)
    assert set(out) == {"sessions", "chunks", "chunk_steps", "wall_s", "unloaded_wall_s",
                        "capacity_hz", "frames", "frames_per_s", "steps_streamed", "deferrals",
                        "session_rate_steps_s", "batch", "bound_ms", "unloaded_p99_ms",
                        "budget_held"}
    assert out["frames"] == 2 * (3 + 2) and out["steps_streamed"] == 2 * 3 * 2
    assert out["batch"]["offered"] == 4 and out["batch"]["accepted"] + out["batch"]["shed"] == 4
