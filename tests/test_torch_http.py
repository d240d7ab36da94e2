"""The port's HTTP front door (nonlocalheatequation_torch/serve/http.py) and
the ``--listen`` CLI on the CPU, held against the JAX package.

* ``parse_case`` gives equal case fields, or equal refusal words, for each
  good and bad body, the mesh-keyed form included
  (test_router.py::test_parse_case_refusals).
* ``AdmissionController`` sheds with the same Retry-After sequence over a
  stub backend, and its session gate on an injected clock answers as the
  JAX one (::test_admission_sheds_before_queues_grow).
* ``IngressServer`` over twin stub backends gives the JAX status codes,
  JSON bodies and Retry-After headers request by request: 202, 400, 404,
  409, 410, 429, the picked form's engine evidence and its 422, the sharded
  fft pick's 422 (test_spectral_sharded.py::test_http_sharded_fft_pick_and_422_body),
  the sessions 404 of a server built without a session manager and
  /v1/status (::test_http_ingress_end_to_end_over_stub).
* ``IngressServer(sessions=...)`` over twin stub backends and each
  package's SessionManager gives the JAX status codes and bodies on every
  ``/v1/sessions*`` route: 201, 202, 400, 404 (an unknown mesh too), 409,
  429 with Retry-After, the status document, the JSON and ``?bin=1``
  results, the SSE stream ending in ``event: end``, and the ``"sessions"``
  count of /healthz and /v1/status
  (test_sessions.py::test_http_session_endpoints_end_to_end).
* ``validate_listen_args`` gives the JAX message for each bad argv on the
  three solve CLIs, the six ``--session-*`` flags' range checks and
  "needs a place to write" included.
* A traced, black-boxed, SLO-audited fleet behind the ingress under a
  worker-side injected retry and a ``die`` kill: served bitwise, one merged
  multi-process timeline whose flows cross processes, the postmortem, the
  staleness label, a balanced SLO ledger, /v1/status
  (test_trace_fleet.py::test_golden_end_to_end_fleet_trace_with_retry_and_die,
  test_slo.py::test_router_chaos_leaves_ledger_balanced).
* ``solve2d --listen 0 --replicas 2 --platform cpu`` as a child: a POSTed
  case's ``?bin=1`` result bitwise the offline engine, a mesh upload and a
  case on it (test_pallas_gather.py::test_mesh_http_and_router_warm_boot,
  with the store off), /metrics with both replicas' namespaces, then EOF on
  stdin: rc 0 and the --metrics-out file.
"""

import http.client
import io
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.cli import solve1d, solve2d, solve3d
from nonlocalheatequation_torch.cli.common import validate_listen_args
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry
from nonlocalheatequation_torch.serve import http as thttp
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.meshes import MeshStore
from nonlocalheatequation_torch.serve.resilience import ServeError
from nonlocalheatequation_torch.serve.router import RouterOverloaded
from nonlocalheatequation_tpu.cli import common as jcommon
from nonlocalheatequation_tpu.cli import solve1d as jsolve1d
from nonlocalheatequation_tpu.cli import solve2d as jsolve2d
from nonlocalheatequation_tpu.cli import solve3d as jsolve3d
from nonlocalheatequation_tpu.obs.metrics import MetricsRegistry as JRegistry
from nonlocalheatequation_tpu.serve import http as jhttp
from nonlocalheatequation_tpu.serve.resilience import ServeError as JServeError
from nonlocalheatequation_tpu.serve.router import RouterOverloaded as JOverloaded

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

PORT_SIDE = (thttp, MetricsRegistry, RouterOverloaded, ServeError)
JAX_SIDE = (jhttp, JRegistry, JOverloaded, JServeError)


def _cloud(n=12, seed=3):
    rng = np.random.default_rng(seed)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    pts = np.stack([ii.ravel(), jj.ravel()], axis=1) / n
    return pts + rng.uniform(-0.1, 0.1, pts.shape) / n, 3.0 / n


# ---------------------------------------------------------------------------
# parse_case
# ---------------------------------------------------------------------------

U16 = np.arange(16.0).tolist()
BODIES = [
    {"shape": [4], "nt": 2, "eps": 1, "k": 1.0, "dt": 1e-5, "dh": 0.25, "test": True},
    {"shape": [4, 4], "nt": 3, "eps": 2, "k": 0.5, "dt": 1e-4, "dh": 0.1, "u0": U16},
    {"shape": [2, 2, 4], "nt": 1, "eps": 1, "k": 1, "dt": 1, "dh": 1, "u0": U16,
     "deadline_ms": 5, "priority": 3},
    {"shape": [4, 4], "nt": 2, "eps": 1, "k": 1, "dt": 1, "dh": 1},
    {"shape": [0], "nt": 2, "eps": 1, "k": 1, "dt": 1, "dh": 1},
    {"shape": [1, 1, 1, 1], "nt": 2, "eps": 1, "k": 1, "dt": 1, "dh": 1, "test": True},
    {"shape": [4], "nt": 0, "eps": 1, "k": 1, "dt": 1, "dh": 1},
    {"shape": [4], "nt": 2, "eps": 0, "k": 1, "dt": 1, "dh": 1, "test": True},
    {"shape": [4], "nt": 2, "eps": 1, "k": 1, "dt": 1, "dh": 1, "u0": [1.0, 2.0]},
    {"nt": 2},
    {"shape": [4], "nt": 2, "eps": 1, "k": 1, "dt": 1, "dh": 1, "test": True,
     "deadline_ms": "soon"},
    {"shape": [4], "nt": 2, "eps": 1, "k": 1, "dt": 1, "dh": 1, "test": True,
     "deadline_ms": -1},
    {"shape": [4], "nt": 2, "eps": 1, "k": 1, "dt": 1, "dh": 1, "test": True,
     "priority": True},
    {"shape": [4], "nt": 2, "eps": 1, "k": "x", "dt": 1, "dh": 1, "test": True},
    {"mesh": 7, "nt": 2, "k": 1, "dt": 1},
    {"mesh": "MESH", "nt": 2, "k": 1.0, "dt": 1e-4, "test": True},
    {"mesh": "MESH", "nt": 2, "k": 1.0, "dt": 1e-4},
    {"mesh": "MESH", "nt": 0, "k": 1.0, "dt": 1e-4, "test": True},
    {"mesh": "MESH", "shape": [144], "nt": 2, "k": 1.0, "dt": 1e-4, "test": True},
    {"mesh": "deadbeefdeadbeef", "nt": 2, "k": 1.0, "dt": 1e-4, "test": True},
    {"mesh": "../../etc", "nt": 2, "k": 1.0, "dt": 1e-4, "test": True},
]


def _outcome(parse, body, meshes):
    try:
        c = parse(body, meshes=meshes)
    except Exception as e:  # noqa: BLE001 — compared across packages
        return type(e).__name__, str(e)
    u0 = None if c.u0 is None else np.asarray(c.u0).tolist()
    return ("ok", (tuple(c.shape), c.nt, c.eps, c.k, c.dt, c.dh, c.test, c.mesh, u0))


def test_parse_case_matches_jax(tmp_path):
    from nonlocalheatequation_tpu.serve.meshes import MeshStore as JMeshStore

    pts, eps = _cloud()
    mhash = MeshStore(str(tmp_path)).put(pts, eps)
    for meshes, jmeshes in ((MeshStore(str(tmp_path)), JMeshStore(str(tmp_path))),
                            (None, None)):
        for body in BODIES:
            body = {k: (mhash if v == "MESH" else v) for k, v in body.items()}
            mine = _outcome(thttp.parse_case, body, meshes)
            theirs = _outcome(jhttp.parse_case, body, jmeshes)
            assert mine == theirs, body
    assert thttp.RESULTS_CAP == jhttp.RESULTS_CAP
    assert thttp.WAIT_TIMEOUT_S == jhttp.WAIT_TIMEOUT_S


# ---------------------------------------------------------------------------
# stub backends (the test controls completion)
# ---------------------------------------------------------------------------


class _Req:
    def __init__(self, case, seq):
        self.case = case
        self.seq = seq
        self.result = None
        self.error = None
        self.latency_s = None
        self.replica = 0
        self.requeues = 0
        self.done = threading.Event()


def make_backend(side, max_outstanding=2, fft_ok=None, method="sat"):
    _, registry_cls, overloaded, serve_error = side

    class Backend:
        def __init__(self):
            self.registry = registry_cls()
            self.max_outstanding = max_outstanding
            self.engine_kwargs = {"method": method}
            self.pending, self.submitted = [], []
            self.seq = 0
            self._gauge = self.registry.gauge("/router/outstanding")
            self.registry.histogram("/router/request-latency-ms").observe(100.0)

        def live_count(self):
            return 1

        def outstanding_total(self):
            return len(self.pending)

        def retry_after_s(self):
            return 0.25

        def submit(self, case, deadline_ms=None, priority=0, **kw):
            if len(self.pending) >= self.max_outstanding:
                raise overloaded(len(self.pending), self.max_outstanding, 0.25)
            req = _Req(case, self.seq)
            self.seq += 1
            self.pending.append(req)
            self.submitted.append(kw.get("engine"))
            self._gauge.set(len(self.pending))
            return req

        def finish(self, n=1, fail=False):
            for _ in range(n):
                req = self.pending.pop(0)
                if fail:
                    req.error = serve_error("error", req.seq, 3, 1, "poisoned")
                else:
                    req.result = np.asarray(req.case.u0, np.float64)
                req.latency_s = 0.1
                req.done.set()
            self._gauge.set(len(self.pending))

        def metrics(self):
            return {"replicas": 1, "outstanding": len(self.pending), "deaths": 0,
                    "cases": self.seq, "transport": "pipe",
                    "per_replica": {0: {"outstanding": len(self.pending), "alive": True}}}

    b = Backend()
    if fft_ok is not None:
        b.is_sharded = lambda shape: True
        b.sharded_fft_capability = lambda shape, eps: fft_ok
    return b


def test_admission_controller_matches_jax():
    from nonlocalheatequation_torch.serve.ensemble import EnsembleCase as C

    case = C(shape=(4, 4), nt=3, eps=1, k=1.0, dt=1e-5, dh=0.25, test=False,
             u0=np.zeros((4, 4)))
    seqs = []
    for side in (PORT_SIDE, JAX_SIDE):
        mod = side[0]
        backend = make_backend(side, max_outstanding=4)
        adm = mod.AdmissionController(backend, max_pending=4)
        out = [adm.try_submit(case)[1] for _ in range(8)]
        backend.finish(2)
        out.append(adm.try_submit(case)[1])
        # the router's hard cap backstops a soft gate left open
        loose = mod.AdmissionController(backend, max_pending=100)
        out.append(loose.try_submit(case)[1])
        tight = mod.AdmissionController(backend, max_pending=100, max_queue_wait_ms=50.0)
        out.append(tight.try_submit(case)[1])
        reg = backend.registry
        out.append((reg.get("/ingress/accepted").value, reg.get("/ingress/shed").value,
                    reg.get("/ingress/retry-after-s").value))
        # the session gate's token bucket on an injected clock
        now = [0.0]
        gate = mod.AdmissionController(make_backend(side, max_outstanding=4),
                                       session_steps_per_s=10.0, clock=lambda: now[0])
        for steps, t in ((5, 0.0), (5, 0.1), (5, 0.2), (20, 0.3), (1, 5.0), (3, 5.1)):
            now[0] = t
            out.append(gate.admit_session(steps))
        for bad in (dict(session_steps_per_s=-1), dict(session_burst_steps=0)):
            with pytest.raises(ValueError) as e:
                mod.AdmissionController(make_backend(side), **bad)
            out.append(str(e.value))
        seqs.append(out)
    assert seqs[0] == seqs[1]
    assert seqs[0][:8] == [None] * 4 + [seqs[0][4]] * 4 and seqs[0][4] > 0


# ---------------------------------------------------------------------------
# the ingress over twin stubs, request by request
# ---------------------------------------------------------------------------


def _request(port, method, path, body=None, raw=False):
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        r = urllib.request.urlopen(req, timeout=60)
        code, headers, payload = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        code, headers, payload = e.code, e.headers, e.read()
    if raw:
        return code, payload
    return code, json.loads(payload.decode()), headers.get("Retry-After")


def _drive_ingress(side, monkeypatch):
    mod = side[0]
    monkeypatch.setattr(mod, "RESULTS_CAP", 1)
    backend = make_backend(side)
    ing = mod.IngressServer(0, backend, max_pending=2)
    out = []
    try:
        p = ing.port
        u0 = np.random.default_rng(3).normal(size=(4, 4))
        body = dict(shape=[4, 4], nt=3, eps=1, k=1.0, dt=1e-5, dh=0.25, u0=u0.tolist())
        for payload in (body, body, body, {"shape": [4, 4]}, {**body, "deadline_ms": "soon"},
                        {**body, "priority": "high"}, [1, 2, 3], b"{not json"):
            out.append(_request(p, "POST", "/v1/cases", payload))
        out.append(_request(p, "GET", "/v1/cases/0?wait=1&timeout_s=abc"))
        out.append(_request(p, "GET", "/v1/cases/0"))
        out.append(_request(p, "GET", "/v1/cases/abc"))
        backend.finish(1)
        out.append(_request(p, "GET", "/v1/cases/0?wait=1&timeout_s=10"))
        out.append(_request(p, "GET", "/v1/cases/0/result"))
        backend.finish(1, fail=True)
        out.append(_request(p, "GET", "/v1/cases/1?wait=1"))
        out.append(_request(p, "GET", "/v1/cases/1/result"))
        out.append(_request(p, "GET", "/v1/cases/0"))  # aged out: 410
        out.append(_request(p, "GET", "/v1/cases/999"))
        out.append(_request(p, "POST", "/v1/cases", body))
        backend.finish(1)
        code, raw = _request(p, "GET", "/v1/cases/2/result?bin=1", raw=True)
        out.append((code, np.load(io.BytesIO(raw)).tolist()))
        for path in ("/healthz", "/metrics.json", "/v1/status", "/v1/meshes/abc",
                     "/v1/sessions/s1", "/v1/sessions/s1/stream", "/v1/sessions", "/nope"):
            out.append(_request(p, "GET", path))
        for path in ("/v1/sessions", "/v1/sessions/s1/close", "/v1/meshes", "/v1/nope"):
            out.append(_request(p, "POST", path, {}))
        out.append(_request(p, "GET", "/metrics", raw=True)[1].decode())
        # the picked form: evidence on 202, an impossible contract is 422
        picked = {"shape": [16, 16], "eps": 2, "k": 1.0, "dh": 0.01, "T_final": 0.01,
                  "accuracy": 1e-6, "test": True}
        out.append(_request(p, "POST", "/v1/cases", picked))
        out.append(_request(p, "POST", "/v1/cases", {**picked, "deadline_ms": 1e-9}))
        out.append(_request(p, "POST", "/v1/cases", {**picked, "nt": 3}))
        out.append(_request(p, "POST", "/v1/cases", {**picked, "dh": 0}))
        out.append(_request(p, "POST", "/v1/cases", {"T_final": 0.01, "accuracy": 1e-6}))
        out.append([None if e is None else e.wire() for e in backend.submitted])
    finally:
        ing.close()
    # a sharded-bound fft fleet with no fft capability refuses at 422
    fft = make_backend(side, fft_ok=False, method="fft")
    with mod.IngressServer(0, fft) as ing:
        out.append(_request(ing.port, "POST", "/v1/cases",
                            {"shape": [32, 32], "eps": 5, "k": 1.0, "dh": 0.02,
                             "T_final": 1e-3, "accuracy": 1e-3, "test": True}))
    return out


def test_ingress_answers_as_the_jax_ingress(monkeypatch):
    mine = _drive_ingress(PORT_SIDE, monkeypatch)
    theirs = _drive_ingress(JAX_SIDE, monkeypatch)
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs, strict=True)):
        assert a == b, (i, a, b)
    codes = [o[0] for o in mine if isinstance(o, tuple) and isinstance(o[0], int)]
    for code in (202, 400, 404, 409, 410, 422, 429):
        assert code in codes, code
    assert mine[2][0] == 429 and int(mine[2][2]) >= 1
    sessions = [o for o in mine if isinstance(o, tuple) and o[0] == 404
                and "no session tier" in str(o[1])]
    assert len(sessions) == 4
    # a server built with a session manager serves the routes (held against
    # the JAX routes by test_session_routes_answer_as_the_jax_routes)
    from nonlocalheatequation_torch.serve.sessions import SessionManager

    backend = make_backend(PORT_SIDE)
    with SessionManager(backend) as mgr, thttp.IngressServer(0, backend, sessions=mgr) as ing:
        assert ing.sessions is mgr
        code, body, _ = _request(ing.port, "GET", "/v1/sessions/s0")
        assert (code, body) == (404, {"error": "no live session 's0'"})


def _drive_sessions(side, tmp):
    """Every /v1/sessions* route of an IngressServer over a stub backend and
    the side's SessionManager (no driver: the test pumps and completes the
    chunks), answer by answer."""
    from nonlocalheatequation_torch.serve import sessions as tsessions
    from nonlocalheatequation_tpu.serve import sessions as jsessions

    mod = side[0]
    smod = tsessions if mod is thttp else jsessions
    backend = make_backend(side, max_outstanding=8)
    mgr = smod.SessionManager(backend, checkpoint_dir=tmp, chunk_steps=2)
    ing = mod.IngressServer(0, backend, sessions=mgr, max_pending=4)
    out = []
    try:
        p = ing.port
        u0 = np.random.default_rng(4).normal(size=(4, 4))
        body = dict(shape=[4, 4], nt=4, eps=1, k=1.0, dt=1e-5, dh=0.25, u0=u0.tolist(),
                    chunk_steps=2, checkpoint_every=1, preview_stride=2)
        out.append(_request(p, "POST", "/v1/sessions", body))
        for bad in ({"shape": [4, 4]}, {**body, "test": True}, {**body, "chunk_steps": 0},
                    {**body, "preview_stride": "x"}, {**body, "u0": [1.0]},
                    {"mesh": "deadbeefdeadbeef", "nt": 2, "k": 1.0, "dt": 1e-4, "u0": [1.0]},
                    [1, 2], b"{not json"):
            out.append(_request(p, "POST", "/v1/sessions", bad))
        out.append(_request(p, "GET", "/v1/sessions/s0"))
        out.append(_request(p, "GET", "/v1/sessions/s0/result"))
        out.append(_request(p, "POST", "/v1/sessions/s0/retarget", {"k": 0.5}))
        out.append(_request(p, "POST", "/v1/sessions/s0/retarget", {}))
        out.append(_request(p, "POST", "/v1/sessions/s0/retarget", {"source": [1.0]}))
        out.append(_request(p, "POST", "/v1/sessions/s0/retarget",
                            {"source": np.full(16, 0.5).tolist()}))
        out.append(_request(p, "POST", "/v1/sessions/nope/retarget", {"k": 1.0}))
        out.append(_request(p, "POST", "/v1/sessions/s0/explode", {}))
        out.append(_request(p, "POST", "/v1/sessions/s0/fork", {"step": 2}))
        for _ in range(2):  # two chunks: submit, complete, retire
            mgr.pump()
            backend.finish(1)
            mgr.pump()
        out.append(_request(p, "POST", "/v1/sessions/s0/fork", {"step": 3}))
        out.append(_request(p, "POST", "/v1/sessions/s0/fork", {"step": 2}))
        out.append(_request(p, "GET", "/v1/sessions/s0"))
        out.append(_request(p, "GET", "/healthz"))
        code, status, _ = _request(p, "GET", "/v1/status")
        out.append((code, status.get("sessions")))
        out.append(_request(p, "POST", "/v1/sessions/s1/close", {}))
        out.append(_request(p, "POST", "/v1/sessions/s1/close", {}))
        out.append(_request(p, "GET", "/v1/sessions/s1/result"))
        out.append(_request(p, "GET", "/v1/sessions/s0/stream?from_step=abc"))
        out.append(_request(p, "GET", "/v1/sessions/s0/nope"))
        out.append(_request(p, "GET", "/v1/sessions/zzz"))
        code, raw = _request(p, "GET", "/v1/sessions/s1/stream?from_step=0", raw=True)
        out.append((code, raw.decode()))
        out.append(_request(p, "POST", "/v1/sessions/s0/close", {}))
        out.append(_request(p, "GET", "/v1/sessions/s0/result"))
        code, raw = _request(p, "GET", "/v1/sessions/s0/result?bin=1", raw=True)
        out.append((code, np.load(io.BytesIO(raw)).tolist()))
        code, raw = _request(p, "GET", "/v1/sessions/s0/stream?from_step=-1", raw=True)
        out.append((code, raw.decode()))
        # admission: a saturated backend sheds the OPEN with 429 + Retry-After
        backend.pending.extend([None] * 8)
        out.append(_request(p, "POST", "/v1/sessions", body))
        out.append(_request(p, "GET", "/healthz"))
    finally:
        ing.close()
        mgr.close()
    return out


def test_session_routes_answer_as_the_jax_routes(tmp_path):
    dirs = str(tmp_path / "mine"), str(tmp_path / "theirs")
    mine, theirs = _drive_sessions(PORT_SIDE, dirs[0]), _drive_sessions(JAX_SIDE, dirs[1])
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs, strict=True)):
        assert repr(a).replace(dirs[0], "<dir>") == repr(b).replace(dirs[1], "<dir>"), (i, a, b)
    codes = {o[0] for o in mine if isinstance(o, tuple) and isinstance(o[0], int)}
    assert {200, 201, 202, 400, 404, 409, 429} <= codes
    assert mine[0][0] == 201 and mine[0][1]["stream"] == "/v1/sessions/s0/stream"
    assert mine[-2][0] == 429 and int(mine[-2][2]) >= 1
    assert "event: end" in mine[-3][1]


# ---------------------------------------------------------------------------
# the CLI flags
# ---------------------------------------------------------------------------

LISTEN_ARGV = [
    ["--replicas", "2"], ["--transport", "tcp"], ["--worker-token", "s"],
    ["--shard-threshold", "64"], ["--gang-devices", "4"], ["--slo", "1"],
    ["--session-chunk", "4"], ["--session-rate", "2.5"], ["--session-checkpoint-dir", "d"],
    ["--listen", "99999"], ["--listen", "0", "--replicas", "0"],
    ["--listen", "0", "--worker-token", "s"],
    ["--listen", "0", "--transport", "tcp", "--worker-token", "s"],
    ["--listen", "0", "--shard-threshold", "-1"], ["--listen", "0", "--shard-threshold", "64"],
    ["--listen", "0", "--gang-devices", "4"], ["--listen", "0", "--test"],
    ["--listen", "0", "--test_batch"], ["--listen", "0", "--ensemble"],
    ["--listen", "0", "--serve", "2"], ["--listen", "0", "--resync", "3"],
    ["--listen", "0", "--log"], ["--listen", "0", "--results"],
    ["--listen", "0", "--checkpoint", "x.npz"], ["--listen", "0", "--resume"],
    ["--listen", "0", "--replicas", "3", "--transport", "tcp", "--slo", "0"], [],
    ["--session-budget", "0"], ["--session-checkpoint-every", "1"], ["--session-preview", "2"],
    ["--listen", "0", "--session-chunk", "0"], ["--listen", "0", "--session-chunk", "-3"],
    ["--listen", "0", "--session-preview", "0"], ["--listen", "0", "--session-budget", "-1"],
    ["--listen", "0", "--session-rate", "-0.5"],
    ["--listen", "0", "--session-checkpoint-every", "-1"],
    ["--listen", "0", "--session-checkpoint-every", "2"],
    ["--listen", "0", "--session-checkpoint-every", "0"],
    ["--listen", "0", "--session-checkpoint-every", "2", "--session-checkpoint-dir", "d"],
    ["--listen", "0", "--session-chunk", "8", "--session-budget", "0", "--session-rate", "0",
     "--session-preview", "1", "--session-checkpoint-dir", "d"],
    ["--listen", "0", "--session-chunk", "0", "--replicas", "0"],
    ["--listen", "0", "--session-preview", "0", "--test"],
]


@pytest.mark.parametrize("cli", ["1d", "2d", "3d"])
def test_validate_listen_args_matches_jax(cli):
    mine_p = {"1d": solve1d, "2d": solve2d, "3d": solve3d}[cli].build_parser()
    their_p = {"1d": jsolve1d, "2d": jsolve2d, "3d": jsolve3d}[cli].build_parser()
    dim = int(cli[0])
    for argv in LISTEN_ARGV:
        try:
            a = their_p.parse_args(argv)
        except SystemExit:
            continue  # a flag this CLI does not have, in both
        b = mine_p.parse_args(argv)
        assert validate_listen_args(b, dim=dim) == jcommon.validate_listen_args(a, dim=dim), \
            (cli, argv)
    for name in ("--session-chunk", "--session-budget", "--session-rate",
                 "--session-checkpoint-dir", "--session-checkpoint-every",
                 "--session-preview"):
        for value in ("2", "0", "-1"):
            argv = ["--listen", "0", name, value]
            b, a = mine_p.parse_args(argv), their_p.parse_args(argv)
            assert validate_listen_args(b, dim=dim) == \
                jcommon.validate_listen_args(a, dim=dim), (cli, argv)


def test_session_flags_refused_by_name_on_the_cli(capsys):
    # the JAX checks, by name: a range, a missing place to write, no --listen
    assert solve2d.main(["--listen", "0", "--session-chunk", "0", "--platform", "cpu"]) == 1
    assert capsys.readouterr().err.strip() == "--session-chunk needs a value >= 1 (got 0)"
    assert solve2d.main(["--listen", "0", "--session-checkpoint-every", "4",
                         "--platform", "cpu"]) == 1
    assert capsys.readouterr().err.strip() == (
        "--session-checkpoint-every needs a place to write; add --session-checkpoint-dir")
    assert solve2d.main(["--session-preview", "4", "--platform", "cpu"]) == 1
    assert capsys.readouterr().err.strip() == \
        "--session-preview configures the --listen fleet; add --listen"
    with pytest.raises(SystemExit) as e:
        solve2d.main(["--listen", "0", "--transport", "bogus"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# a traced, black-boxed, audited fleet behind the ingress (real workers)
# ---------------------------------------------------------------------------


def _make_cases(n, grid=16, nt=4, buckets=2, seed=0):
    rng = np.random.default_rng(seed)
    return [EnsembleCase(shape=(grid, grid), nt=nt + (i % buckets), eps=2, k=1.0, dt=1e-5,
                         dh=1.0 / grid, test=False, u0=rng.normal(size=(grid, grid)))
            for i in range(n)]


def _post_case(base, case):
    body = dict(shape=list(case.shape), nt=case.nt, eps=case.eps, k=case.k, dt=case.dt,
                dh=case.dh, u0=np.asarray(case.u0).tolist())
    r = urllib.request.urlopen(urllib.request.Request(base + "/v1/cases",
                                                      json.dumps(body).encode()))
    assert r.status == 202
    return json.load(r), r.headers.get("X-NLHEAT-Trace")


def test_traced_audited_fleet_with_retry_and_die(tmp_path):
    from nonlocalheatequation_torch.serve.router import ReplicaRouter
    from nonlocalheatequation_torch.utils.faults import FaultPlan

    cases = _make_cases(6)
    offline = EnsembleEngine(method="sat", batch_sizes=(1,), device="cpu",
                             dtype=torch.float64).run(cases)
    trace_dir, flight_dir = str(tmp_path / "trace"), str(tmp_path / "flight")
    with ReplicaRouter(replicas=2, method="sat", batch_sizes=(1,), device="cpu",
                       dtype=torch.float64, trace_dir=trace_dir, flight_dir=flight_dir,
                       faults="die@2", respawn=True, slo=True, spawn_timeout_s=120,
                       # every worker's FIRST dispatch attempt raises and retries
                       serve_kwargs={"faults": FaultPlan.parse("raise@0"),
                                     "backoff_ms": 0.0}) as router:
        with thttp.IngressServer(0, router) as ing:
            base = f"http://127.0.0.1:{ing.port}"
            ids, traces = [], []

            def post(sub):
                for c in sub:
                    d, hdr = _post_case(base, c)
                    ids.append(d["id"])
                    traces.append(d["trace"])
                    assert hdr.startswith(d["trace"])

            post(cases[:2])
            for i in ids:
                urllib.request.urlopen(base + f"/v1/cases/{i}?wait=1&timeout_s=300")
            router.refresh_stats()
            post(cases[2:])
            results = []
            for i in ids:
                d = json.load(urllib.request.urlopen(base + f"/v1/cases/{i}?wait=1"
                                                            "&timeout_s=300"))
                assert d["status"] == "done", d
                res = json.load(urllib.request.urlopen(base + f"/v1/cases/{i}/result"))
                results.append(np.asarray(res["values"]).reshape(res["shape"]))
            status = json.load(urllib.request.urlopen(base + "/v1/status"))
            router.refresh_stats()
            names_in_window = router.registry.names()
            router.stale_after_s = 0.0
            router.refresh_stats()
            names_after = router.registry.names()
            tpath = os.path.join(trace_dir, "fleet_trace.json")
            for i in range(8):  # until every live worker has traced
                merged = router.dump_fleet_trace(tpath)
                assert merged is not None and merged["processes"] >= 2
                pids = {e["pid"] for e in json.load(open(tpath))["traceEvents"]
                        if e["ph"] != "M"}
                if len(pids) > 2:
                    break
                time.sleep(0.25)
                d, _ = _post_case(base, _make_cases(1, grid=8, nt=20 + i, buckets=1,
                                                    seed=99 + i)[0])
                traces.append(d["trace"])
                urllib.request.urlopen(base + f"/v1/cases/{d['id']}?wait=1&timeout_s=300")
        m = router.metrics()
    for got, want in zip(results, offline, strict=True):
        assert np.array_equal(got, want)
    assert m["deaths"] == 1 and m["requeued"] >= 1
    # the SLO ledger stays balanced through the kill
    s = m["slo"]
    assert s["promised"] == s["resolved"] == m["cases"] and s["open"] == 0
    assert s["duplicate"] == 0 and s["unmatched"] == 0 and s["errors"] == 0
    assert status["ok"] is True and status["deaths"] == 1 and "slo" in status
    assert status["slo"]["promised"] >= 6 and set(status["per_replica"])
    # the merged timeline: multi-process, chained to ingress-minted ids
    events = json.load(open(tpath))["traceEvents"]
    pids = {e["pid"] for e in events if e["ph"] != "M"}
    assert len(pids) >= 3
    labels = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert "router" in labels and any(lbl.startswith("replica") for lbl in labels)
    stamped = [e for e in events if e.get("args", {}).get("trace") is not None]
    assert stamped and {e["args"]["trace"] for e in stamped} <= set(traces)
    assert [e for e in stamped if e["name"].startswith("serve.")]
    assert [e for e in events if e["name"] == "serve.retry"]
    flows: dict = {}
    for e in events:
        if e["ph"] in ("s", "t", "f"):
            flows.setdefault(e["id"], []).append(e)
    crossing = [fid for fid, evs in flows.items()
                if {x["ph"] for x in evs} >= {"s", "t", "f"}
                and len({x["pid"] for x in evs}) >= 2]
    assert crossing
    for fid in crossing:
        evs = sorted(flows[fid], key=lambda x: x["ts"])
        assert evs[0]["ph"] == "s" and evs[-1]["ph"] == "f"
    per = [f for f in os.listdir(trace_dir) if f.startswith("host_trace.replica")]
    assert per and "clock_sync" in json.load(open(os.path.join(trace_dir, per[0])))["metadata"]
    # the postmortem names the killed replica, its orphans, each decision
    pms = sorted(f for f in os.listdir(flight_dir) if f.startswith("postmortem-"))
    pm = json.load(open(os.path.join(flight_dir, pms[0])))
    assert pm["postmortem"] == "replica-death" and pm["orphans"]
    assert {d["case"] for d in pm["decisions"]} == set(pm["orphans"])
    assert any(d["action"] == "re-route" for d in pm["decisions"])
    dead = pm["replica"]
    assert f"/replica{{{dead}}}/stale" in names_in_window
    assert not any(n.startswith(f"/replica{{{dead}}}/") for n in names_after)
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# solve2d --listen as a child process
# ---------------------------------------------------------------------------


def test_solve2d_listen_serves_meshes_scrapes_and_stops_on_eof(tmp_path):
    u0 = np.random.default_rng(7).normal(size=(12, 12))
    case = EnsembleCase(shape=(12, 12), nt=3, eps=2, k=1.0, dt=1e-5, dh=1.0 / 12, test=False,
                        u0=u0)
    want = EnsembleEngine(device="cpu").run([case])[0]
    mdir, out = str(tmp_path / "meshes"), str(tmp_path / "m.json")
    sdir = str(tmp_path / "sessions")
    env = dict(os.environ, NLHEAT_MESH_DIR=mdir, OMP_NUM_THREADS="1")
    env.pop("NLHEAT_PROGRAM_STORE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "nonlocalheatequation_torch.cli.solve2d", "--listen", "0",
         "--replicas", "2", "--platform", "cpu", "--metrics-out", out,
         "--session-checkpoint-dir", sdir, "--session-checkpoint-every", "1",
         "--session-chunk", "2", "--session-preview", "5", "--session-rate", "1000000"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)
    lines: list = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stderr.readline, "")),
                              daemon=True)
    reader.start()
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline and proc.poll() is None:
            for line in list(lines):
                m = re.search(r"ingress: http://127.0.0.1:(\d+)/v1/cases", line)
                if m:
                    port = int(m.group(1))
            time.sleep(0.1)
        assert port, "".join(lines)
        body = dict(shape=[12, 12], nt=3, eps=2, k=1.0, dt=1e-5, dh=1.0 / 12, u0=u0.tolist())
        code, resp, _ = _request(port, "POST", "/v1/cases", body)
        assert code == 202
        code, done, _ = _request(port, "GET", f"/v1/cases/{resp['id']}?wait=1&timeout_s=120")
        assert done["status"] == "done"
        code, raw = _request(port, "GET", f"/v1/cases/{resp['id']}/result?bin=1", raw=True)
        assert code == 200 and np.array_equal(np.load(io.BytesIO(raw)), want)
        # a mesh upload, then a case on it (the store off)
        pts, eps = _cloud()
        code, meta, _ = _request(port, "POST", "/v1/meshes", {"points": pts.tolist(),
                                                               "eps": eps})
        assert code == 201 and meta["nodes"] == 144
        code, again, _ = _request(port, "GET", f"/v1/meshes/{meta['hash']}")
        assert code == 200 and again == meta
        assert _request(port, "GET", "/v1/meshes/deadbeefdeadbeef")[0] == 404
        assert _request(port, "POST", "/v1/meshes", {"points": [[0.0, 0.0]]})[0] == 400
        conn = http.client.HTTPConnection("127.0.0.1", port)
        try:
            conn.putrequest("POST", "/v1/meshes")
            conn.putheader("Content-Length", str((256 << 20) + 1))
            conn.endheaders()
            assert conn.getresponse().status == 400
        finally:
            conn.close()
        mcase = {"mesh": meta["hash"], "nt": 5, "k": 1.0, "dt": 1e-4, "test": True}
        code, r2, _ = _request(port, "POST", "/v1/cases", mcase)
        assert code == 202
        _request(port, "GET", f"/v1/cases/{r2['id']}?wait=1&timeout_s=120")
        code, res, _ = _request(port, "GET", f"/v1/cases/{r2['id']}/result")
        assert res["shape"] == [144]
        os.environ["NLHEAT_MESH_DIR"] = mdir
        try:
            direct = EnsembleEngine(device="cpu").run([EnsembleCase(
                shape=(144,), nt=5, eps=0, k=1.0, dt=1e-4, dh=0.0, test=True,
                mesh=meta["hash"])])[0]
        finally:
            del os.environ["NLHEAT_MESH_DIR"]
        assert np.array_equal(np.asarray(res["values"]), direct)
        assert _request(port, "POST", "/v1/cases", dict(mcase, shape=[144]))[0] == 400
        # a live session through the CLI's session tier: the SSE stream,
        # bitwise the chunk-by-chunk composition, a checkpoint a boundary
        code, body, _ = _request(port, "POST", "/v1/sessions", {})
        assert code == 400 and "missing case field" in body["error"]
        code, opened, _ = _request(port, "POST", "/v1/sessions",
                                   dict(shape=[12, 12], nt=4, eps=2, k=1.0, dt=1e-5,
                                        dh=1.0 / 12, u0=u0.tolist()))
        assert code == 201 and opened["chunk_steps"] == 2
        code, raw = _request(port, "GET", opened["stream"] + "?timeout_s=120", raw=True)
        frames = [json.loads(ln[len("data: "):]) for ln in raw.decode().splitlines()
                  if ln.startswith("data: ")]
        assert [(f.get("step"), f.get("kind")) for f in frames] == [
            (0, "preview"), (2, "preview"), (4, "preview"), (4, "final"), (4, None)]
        assert frames[0]["shape"] == [3, 3] and frames[-1]["state"] == "done"
        half = EnsembleEngine(device="cpu").run([EnsembleCase(
            shape=(12, 12), nt=2, eps=2, k=1.0, dt=1e-5, dh=1.0 / 12, test=False, u0=u0)])[0]
        whole = EnsembleEngine(device="cpu").run([EnsembleCase(
            shape=(12, 12), nt=2, eps=2, k=1.0, dt=1e-5, dh=1.0 / 12, test=False,
            u0=half)])[0]
        assert np.array_equal(np.asarray(frames[3]["values"]).reshape(12, 12), whole)
        assert sorted(os.listdir(sdir)) == [f"{opened['session']}@2.ckpt.npz",
                                           f"{opened['session']}@4.ckpt.npz"]
        code, health, _ = _request(port, "GET", "/healthz")
        assert code == 200 and health["sessions"] == 0
        # the fleet scrape (the router's stats loop runs every 10 s)
        text = ""
        for _ in range(60):
            text = _request(port, "GET", "/metrics", raw=True)[1].decode()
            if all(f'replica="{r}"' in text for r in (0, 1)):
                break
            time.sleep(0.5)
        assert 'nlheat_replica_serve_depth{replica="0"}' in text
        assert 'nlheat_replica_serve_depth{replica="1"}' in text
    finally:
        proc.stdin.close()  # EOF = shutdown
        rc = proc.wait(timeout=120)
        reader.join(timeout=10)
    err = "".join(lines)
    assert rc == 0, err
    # the router served the two cases and the session's two chunks
    assert "router:" in err and '"cases": 4' in err
    payload = json.loads(Path(out).read_text())
    assert payload["cases"] == 4 and payload["deaths"] == 0
