"""The port's replica router (nonlocalheatequation_torch/serve/router.py) on
the CPU, with real worker processes, held against the JAX package's
serve/router.py.  Each check is the analog of the JAX test named beside it;
the fleets batch several checks each (a worker costs a torch import).

* Sticky routing, the fleet scrape and bitwise offline
  (test_router.py::test_sticky_routing_bit_identity_and_fleet_scrape),
  the poison frame (::test_poison_frame_classifies_without_killing_the_worker),
  a live ``sticky_key``, the warm-added replica booting from the shared
  program store (loaded >= 1, built 0, bitwise) and the elastic actuation
  (::test_elastic_scale_actuation), in one fleet whose workers are started
  by a transport object of the test: each worker reports at exit that no
  ``jax`` module was imported and no CUDA context was made in it.
* ``die`` chaos re-routed bitwise with no loss and no duplicate (in the
  cross-package test below), and the respawn to the floor
  (::test_replica_kill_chaos_reroutes_bit_identically).
* A replica-killing case quarantined at the requeue cap
  (::test_replica_killing_case_quarantines_at_requeue_cap).
* The same f64 case sequence through the JAX ``ReplicaRouter`` and the
  port's, under the same ``die`` plan: equal bucket owners, equal
  cases/routed/requeued/deaths, states within 1e-12.
* Constructor refusals in the JAX words (::test_router_ctor_refusals,
  test_fleet_tcp.py::test_router_sharded_ctor_refusals) and the A/B
  helpers' bucket-starvation refusals.

After every fleet the test process has no CUDA context.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.serve import router as router_mod
from nonlocalheatequation_torch.serve import transport as transport_mod
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.router import ReplicaRouter, RouterOverloaded
from nonlocalheatequation_tpu.serve import ensemble as jens
from nonlocalheatequation_tpu.serve import router as jrouter

torch.set_num_threads(1)

KW = dict(method="sat", batch_sizes=(1,), device="cpu", dtype=torch.float64,
          spawn_timeout_s=120)


def make_cases(n, grid=16, nt=4, buckets=2, seed=0, cls=EnsembleCase):
    """n production cases over `buckets` distinct bucket keys (nt varies)."""
    rng = np.random.default_rng(seed)
    return [cls(shape=(grid, grid), nt=nt + (i % buckets), eps=2, k=1.0, dt=1e-5,
                dh=1.0 / grid, test=False, u0=rng.normal(size=(grid, grid)))
            for i in range(n)]


def offline(cases):
    return EnsembleEngine(method="sat", batch_sizes=(1,), device="cpu",
                          dtype=torch.float64).run(cases)


def same(got, want):
    return all(np.array_equal(a, b) for a, b in zip(got, want, strict=True))


CHILD = r"""
import os, sys
fd = os.dup(1)
os.dup2(2, 1)
from nonlocalheatequation_torch.serve import router
try:
    router._worker_main(frame_fd=fd)
finally:
    import json
    import torch
    bad = sorted(m for m, v in sys.modules.items() if v is not None
                 and (m == "jax" or m.startswith(("jax.", "nonlocalheatequation_tpu"))))
    path = os.environ["NLHEAT_TEST_CHILD_REPORT"] + "." + str(os.getpid())
    with open(path, "w") as f:
        json.dump({"jax": bad, "cuda": torch.cuda.is_initialized(),
                   "tpu": "nonlocalheatequation_tpu" in sys.modules}, f)
"""


class ChildTransport(transport_mod.PipeTransport):
    """Pipe workers started as a child of this test: the port's worker main
    behind the same fd-1 hand-over, reporting its imports at exit."""

    def __init__(self, report: str):
        self.report = report

    def spawn(self, rid, env, timeout_s=180.0):
        env = dict(env, NLHEAT_TEST_CHILD_REPORT=self.report)
        proc = subprocess.Popen([sys.executable, "-c", CHILD], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, env=env)
        return transport_mod.WorkerHandle(proc, proc.stdout, proc.stdin, transport=self.name)


def test_sticky_scrape_poison_warm_add_and_elastic(tmp_path, monkeypatch):
    cases = make_cases(8, buckets=4)
    want = offline(cases)
    report = str(tmp_path / "child")
    with ReplicaRouter(replicas=2, max_replicas=3, program_store=str(tmp_path / "store"),
                       transport=ChildTransport(report), **KW) as router:
        got = router.serve_cases(cases)
        assert same(got, want)
        assert all(isinstance(v, np.ndarray) for v in got)
        m = router.metrics()
        assert m["cases"] == 8 and m["outstanding"] == 0
        assert m["deaths"] == 0 and m["buckets"] == 4 and m["transport"] == "pipe"
        # sticky: each bucket owned by one replica, spread over the fleet
        owners = {c.bucket_key(): router._owner[c.bucket_key()] for c in cases}
        assert sorted(owners.values()) == [0, 0, 1, 1]
        assert same(router.serve_cases(cases), want)
        assert {k: router._owner[k] for k in owners} == owners
        # the fleet scrape: each worker's registry under /replica{r}
        stats = router.refresh_stats()
        assert set(stats) == {0, 1}
        for rid, frame in stats.items():
            assert frame["pid"] > 0 and frame["replica"] == rid
            assert frame["metrics"]["cases"] == 8
            assert frame["metrics"]["store"]["saves"] >= 2
        names = router.registry.names()
        for rid in (0, 1):
            assert any(n.startswith(f"/replica{{{rid}}}/serve/") for n in names)
            assert f"/replica{{{rid}}}/busy-rate" in names
        text = router.registry.prometheus()
        assert 'nlheat_replica_serve_depth{replica="0"}' in text
        assert 'nlheat_replica_serve_depth{replica="1"}' in text
        # the poison frame: the worker refuses it, survives and serves on
        h_bad = router.submit(cases[0], deadline_ms="soon")
        with pytest.raises(Exception, match="submit refused"):
            h_bad.wait(timeout=60)
        bad = EnsembleCase(shape=None, nt=3, eps=2, k=1.0, dt=1e-5, dh=0.1, test=False)
        with pytest.raises(TypeError):
            router.submit(bad)
        assert router.outstanding_total() == 0 and router.metrics()["deaths"] == 0
        # elastic actuation: every replica saturated -> add; the newcomer
        # inherits a bucket and boots it from the shared store
        monkeypatch.setattr(router, "refresh_stats", lambda: {})
        for rid in (0, 1):
            router._telemetry.record_window(rid, 0.95, 1.0)
        assert router.maybe_scale() == "add"
        assert router.live_count() == 3 and router.metrics()["scale_ups"] == 1
        new = max(r.rid for r in router._replicas.values() if r.alive)
        assert len(router._replicas[new].buckets) == 1
        moved = next(iter(router._replicas[new].buckets))
        assert router._owner[moved] == new
        assert same(router.serve_cases(cases), want)
        fresh = ReplicaRouter.refresh_stats(router)[new]["metrics"]
        assert fresh["cases"] >= 1
        assert fresh["programs_built"] == 0 and fresh["programs_loaded"] >= 1
        assert fresh["store"]["hits"] >= 1
        # every replica idle -> drain back; inside the band -> hold
        for rep in list(router._replicas.values()):
            if rep.alive:
                router._telemetry.record_window(rep.rid, 0.01, 1.0)
        assert router.maybe_scale() == "drain"
        assert router.live_count() == 2 and router.metrics()["scale_downs"] == 1
        for rep in list(router._replicas.values()):
            if rep.alive:
                router._telemetry.record_window(rep.rid, 0.5, 1.0)
        assert router.maybe_scale() is None
        assert same(router.serve_cases(cases), want)
        # sticky_key is the routing identity: a fresh key takes the
        # emptiest replica, what is computed does not change
        h = router.submit(cases[1], sticky_key=("session", "s1"))
        assert np.array_equal(h.wait(timeout=60), want[1])
        assert router._owner[("session", "s1")] == h.replica
    reports = [json.loads(open(os.path.join(tmp_path, f)).read())
               for f in os.listdir(tmp_path) if f.startswith("child.")]
    assert len(reports) == 3  # every worker stopped cleanly wrote one
    assert all(r == {"jax": [], "cuda": False, "tpu": False} for r in reports)
    assert not torch.cuda.is_initialized()


def test_replica_kill_respawns_to_the_floor():
    # the only worker dies with the second forward in flight: the router
    # respawns to its floor and still serves everything, bitwise
    cases = make_cases(8, buckets=2)
    want = offline(cases)
    with ReplicaRouter(replicas=1, faults="die@1", respawn=True, **KW) as router:
        assert same(router.serve_cases(cases), want)
        m = router.metrics()
        assert m["deaths"] == 1 and m["spawns"] == 2 and m["replicas"] == 1
        assert m["requeued"] >= 1 and m["outstanding"] == 0
    assert not torch.cuda.is_initialized()


def test_replica_killing_case_quarantines_at_requeue_cap(monkeypatch):
    # die@0x* kills the replica of EVERY forward: the re-route budget ends
    # the cycle with a typed error (the cap lowered to 1 to spare spawns)
    monkeypatch.setattr(router_mod, "MAX_REQUEUES", 1)
    case = make_cases(1, buckets=1)[0]
    with ReplicaRouter(replicas=1, faults="die@0x*", respawn=True, **KW) as router:
        h = router.submit(case)
        with pytest.raises(Exception, match="MAX_REQUEUES"):
            h.wait(timeout=180)
        m = router.metrics()
        assert m["deaths"] == 2 and m["requeued"] == 2 and m["outstanding"] == 0


def _drive(router_cls, case_cls, kw):
    """Six cases, one at a time, under die@2: the third forward's replica
    dies with it in flight; with no respawn the survivor takes the orphan
    and, from then on, both buckets."""
    cases = make_cases(6, buckets=2, seed=5, cls=case_cls)
    with router_cls(replicas=2, faults="die@2", respawn=False, **kw) as router:
        out = [router.submit(c).wait(timeout=120) for c in cases]
        m = router.metrics()
        owners = dict(router._owner)
    return out, owners, m


def test_the_same_die_plan_through_both_packages():
    # die@2 kills a replica with a case in flight: re-routed bitwise the
    # offline engine, no loss, no duplicate — and the JAX fleet agrees
    mine, mine_owners, mm = _drive(ReplicaRouter, EnsembleCase, KW)
    assert same(mine, offline(make_cases(6, buckets=2, seed=5)))
    assert mm["outstanding"] == 0 and len(mine) == 6
    theirs, their_owners, jm = _drive(jrouter.ReplicaRouter, jens.EnsembleCase,
                                      dict(method="sat", batch_sizes=(1,)))
    assert mine_owners == their_owners
    assert set(mine_owners.values()) == {1}
    for key in ("cases", "routed", "requeued", "deaths", "buckets", "spawns"):
        assert mm[key] == jm[key], key
    assert (mm["cases"], mm["routed"], mm["requeued"], mm["deaths"]) == (6, 7, 1, 1)
    for a, b in zip(mine, theirs, strict=True):
        assert np.abs(a - np.asarray(b)).max() <= 1e-12


def _words(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("kw", [
    dict(replicas=0), dict(replicas=1, max_outstanding=0),
    dict(replicas=2, min_replicas=3, max_replicas=2), dict(replicas=1, faults="explode@1"),
    dict(replicas=1, shard_threshold=-1), dict(replicas=1, shard_threshold=64, gang_comm="x"),
    dict(replicas=1, shard_threshold=64, gang_devices=0), dict(replicas=1, transport="bogus"),
    dict(replicas=1, worker_token="s")],
    ids=["replicas", "outstanding", "floor", "plan", "threshold", "comm", "gang", "transport",
         "token"])
def test_router_ctor_refusals_in_the_jax_words(kw):
    assert _words(lambda: ReplicaRouter(device="cpu", **kw)) == \
        _words(lambda: jrouter.ReplicaRouter(**kw))


def test_constants_exceptions_and_ab_refusals():
    assert router_mod.MAX_OUTSTANDING == jrouter.MAX_OUTSTANDING
    assert router_mod.MAX_REQUEUES == jrouter.MAX_REQUEUES
    e = RouterOverloaded(5, 4, 0.25)
    assert str(e) == str(jrouter.RouterOverloaded(5, 4, 0.25))
    assert e.retry_after_s == 0.25 and e.cap == 4 and e.outstanding == 5
    one_bucket = make_cases(4, buckets=1)
    for fn, jfn in ((router_mod.router_load_ab, jrouter.router_load_ab),
                    (router_mod.fleet_tcp_ab, jrouter.fleet_tcp_ab)):
        with pytest.raises(ValueError, match="distinct buckets") as mine:
            fn({}, one_bucket, 2, None)
        with pytest.raises(ValueError) as theirs:
            jfn({}, make_cases(4, buckets=1, cls=jens.EnsembleCase), 2, None)
        assert str(mine.value) == str(theirs.value)
