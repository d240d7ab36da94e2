"""The port's program store (serve/program_store.py), held to its contract.

The JAX store keeps XLA executables and is not the oracle here (its tests
fail in part on some hosts); the port's store keeps kernel libraries and
program recipes, and these tests hold it to the module's stated rules:

* a warm boot never calls ``build`` and never probes (spies), and is bitwise
  the cold one — the ensemble engine's tuned and fixed buckets, the solo
  tuned path in 2D and 3D;
* store off is today's run bitwise and writes nothing;
* fingerprint, topology and corrupt entries each raise a loud refusal with
  the JAX reason word, then rebuild (and re-persist);
* two processes racing on one key leave a loadable store;
* the LRU cap and its env refusals; ``NLHEAT_PROGRAM_STORE`` resolution; a
  group/world-writable directory is refused;
* the CPU fallback sibling is keyed apart from a card engine;
* ``ServeReport.store()`` carries the JAX keys; the ``store.load`` and
  ``store.save`` spans;
* library entries, with a fake ``nvcc`` on PATH that writes bytes and counts
  its calls: a warm boot from an empty ``_build`` directory runs it 0 times,
  and a program entry restores the libraries its first call launched.
"""

import json
import os
import stat
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.ops import _build
from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.serve import program_store as ps
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.serve.server import ServePipeline
from nonlocalheatequation_torch.utils import autotune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _cases(n=3, shape=(16, 16), nt=3, eps=2, seed=0):
    rng = np.random.default_rng(seed)
    return [EnsembleCase(shape=shape, nt=nt, eps=eps, k=1.0 - 0.1 * i, dt=1e-5,
                         dh=1.0 / shape[0], test=False, u0=rng.normal(size=shape))
            for i in range(n)]


def _entries(d, suffix=ps.PROGRAM_SUFFIX):
    return sorted(p for p in os.listdir(d) if p.endswith(suffix)) if os.path.isdir(d) else []


@pytest.fixture
def spies(monkeypatch):
    """Counts of the store's ``build`` calls and of the tuner's probes."""
    n = {"build": 0, "probe": 0}
    real_lob = ps.ProgramStore.load_or_build

    def load_or_build(self, key_desc, build, *a, **kw):
        def counted():
            n["build"] += 1
            return build()
        return real_lob(self, key_desc, counted, *a, **kw)

    real_measure = autotune._measure
    monkeypatch.setattr(ps.ProgramStore, "load_or_build", load_or_build)
    monkeypatch.setattr(autotune, "_measure",
                        lambda *a: n.__setitem__("probe", n["probe"] + 1) or real_measure(*a))
    monkeypatch.setattr(autotune, "_memory_cache", {})
    return n


@pytest.mark.parametrize("tuned", [False, True], ids=["fixed", "tuned"])
def test_warm_boot_never_builds_or_probes_and_is_bitwise(tmp_path, monkeypatch, spies,
                                                         tuned):
    if tuned:
        monkeypatch.setenv("NLHEAT_TUNE_BATCH", "1")
    cases = _cases(6) + _cases(2, shape=(12, 12), seed=3)
    base = EnsembleEngine(method="cuda", device=CPU).run(cases)
    base_probes = spies["probe"]
    autotune.reset()
    cold = EnsembleEngine(method="cuda", device=CPU, program_store=str(tmp_path))
    got = cold.run(cases)
    assert cold.report.programs_built == 2 and cold.program_store.stats()["saves"] == 2
    assert spies["build"] == 2 and (spies["probe"] > base_probes) == tuned
    if tuned:
        assert {v.split(":")[0] for v in cold.report.strategies.values()} == {"tuned"}
        recipe = json.loads(ps.ProgramStore(str(tmp_path))._read(
            str(tmp_path / _entries(tmp_path)[0]), "cpu"))
        assert recipe["winner"] and recipe["libs"] == {}  # no kernel launches on the CPU
        assert all("ms_per_step" in r for r in recipe["tuning"].values())
    autotune.reset()  # a fresh process: no tuner records
    n_build, n_probe = spies["build"], spies["probe"]
    warm = EnsembleEngine(method="cuda", device=CPU, program_store=str(tmp_path))
    again = warm.run(cases)
    assert (spies["build"], spies["probe"]) == (n_build, n_probe)
    assert (warm.report.programs_loaded, warm.report.programs_built) == (2, 0)
    assert set(warm.report.strategies.values()) == {"stored"}
    assert warm.program_store.stats()["hits"] == 2
    assert "2 loaded" in warm.report.summary()
    for a, b, c in zip(base, got, again, strict=True):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_store_off_is_todays_run_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("NLHEAT_PROGRAM_STORE", raising=False)
    cases = _cases()
    eng = EnsembleEngine(method="cuda", device=CPU)
    out = eng.run(cases)
    assert eng.program_store is None and eng.report.programs_loaded == 0
    monkeypatch.setenv("NLHEAT_PROGRAM_STORE", "0")
    again = EnsembleEngine(method="cuda", device=CPU).run(cases)
    assert all(np.array_equal(a, b) for a, b in zip(out, again, strict=True))
    assert os.listdir(tmp_path) == []
    # the solo path with the store off is the tuner's own pick
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D

    op = NonlocalOp2D(2, 1.0, 1e-5, 1 / 16)
    u = torch.as_tensor(cases[0].u0)
    fn = ps.solo_pick(op, 4, (16, 16), torch.float64, CPU)
    want = autotune.pick_multi_step_fn(op, 4, (16, 16), torch.float64, CPU)[0]
    assert torch.equal(fn(u, 0), want(u, 0)) and os.listdir(tmp_path) == []


def _store_one(tmp_path):
    cases = _cases()
    out = EnsembleEngine(method="cuda", device=CPU, program_store=str(tmp_path)).run(cases)
    return cases, out, str(tmp_path / _entries(tmp_path)[0])


def _rerun(tmp_path, cases):
    eng = EnsembleEngine(method="cuda", device=CPU, program_store=str(tmp_path))
    return eng.run(cases), eng.program_store.stats()


@pytest.mark.parametrize("what", ["fingerprint", "topology"])
def test_fingerprint_and_topology_mismatch_refuse_then_rebuild(tmp_path, monkeypatch, capsys,
                                                               what):
    cases, out, _ = _store_one(tmp_path)
    if what == "fingerprint":
        real = ps.version_fingerprint()
        monkeypatch.setattr(ps, "version_fingerprint", lambda: {**real, "torch": "9.9.9"})
        reason = ps.REFUSE_FINGERPRINT
    else:
        real = ps.topology_fingerprint("cpu")
        monkeypatch.setattr(ps, "topology_fingerprint", lambda b: {**real, "devices": 1024})
        reason = ps.REFUSE_TOPOLOGY
    got, stats = _rerun(tmp_path, cases)
    assert stats["hits"] == 0 and stats["refusals"] == {reason: 1}
    assert all(np.array_equal(a, b) for a, b in zip(out, got, strict=True))
    err = capsys.readouterr().err
    assert f"program store refusal [{reason}]" in err and "falling back" in err
    # the rebuild re-persisted the entry under the current build: it hits
    got2, stats2 = _rerun(tmp_path, cases)
    assert stats2["hits"] == 1 and stats2["refusals"] == {}


@pytest.mark.parametrize("mutate", ["truncate", "flip", "foreign", "recipe"])
def test_corrupt_entry_refuses_then_rebuilds(tmp_path, monkeypatch, capsys, mutate):
    cases, out, entry = _store_one(tmp_path)
    raw = open(entry, "rb").read()
    if mutate == "truncate":
        open(entry, "wb").write(raw[: len(raw) // 2])
    elif mutate == "flip":
        body = bytearray(raw)
        body[-3] ^= 0xFF  # payload rot: the CRC catches it
        open(entry, "wb").write(bytes(body))
    elif mutate == "foreign":
        open(entry, "wb").write(b"not a program store entry")
    else:  # a whole entry whose recipe names a library the store lacks
        payload = json.dumps({"strategy": "x", "libs": {"nsum2d.cu": _build.source_digest(
            "nsum2d.cu")}}).encode()
        st = ps.ProgramStore(str(tmp_path))
        os.remove(entry)
        st._write(entry, payload, "k", "cpu", "program")
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")  # nothing built
    got, stats = _rerun(tmp_path, cases)
    assert stats["hits"] == 0 and stats["refusals"] == {ps.REFUSE_CORRUPT: 1}
    assert all(np.array_equal(a, b) for a, b in zip(out, got, strict=True))
    assert "[corrupt]" in capsys.readouterr().err
    got2, stats2 = _rerun(tmp_path, cases)
    assert stats2["hits"] == 1 and stats2["refusals"] == {}


RACE_CHILD = r"""
import sys
import numpy as np
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
rng = np.random.default_rng(0)
cases = [EnsembleCase(shape=(16, 16), nt=3, eps=2, k=1.0, dt=1e-5, dh=1 / 16, test=False,
                      u0=rng.normal(size=(16, 16))) for _ in range(3)]
eng = EnsembleEngine(method="cuda", device="cpu", program_store=sys.argv[1])
np.save(sys.argv[2], np.stack(eng.run(cases)))
st = eng.program_store.stats()
print("STATS", st["hits"], st["misses"], st["saves"])
"""


def test_two_process_writer_race_leaves_a_loadable_store(tmp_path):
    d = str(tmp_path / "store")
    env = {k: v for k, v in os.environ.items() if k != "NLHEAT_PROGRAM_STORE"}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", RACE_CHILD, d,
                               str(tmp_path / f"out{i}.npy")], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-800:]
            assert "STATS" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    a, b = np.load(tmp_path / "out0.npy"), np.load(tmp_path / "out1.npy")
    assert np.array_equal(a, b) and len(_entries(d)) == 1
    rng = np.random.default_rng(0)
    cases = [EnsembleCase(shape=(16, 16), nt=3, eps=2, k=1.0, dt=1e-5, dh=1 / 16, test=False,
                          u0=rng.normal(size=(16, 16))) for _ in range(3)]
    eng = EnsembleEngine(method="cuda", device=CPU, program_store=d)
    got = eng.run(cases)
    assert eng.program_store.stats()["hits"] == 1
    assert np.array_equal(np.stack(got), a)
    assert not [f for f in os.listdir(d) if ".tmp." in f]


def test_lru_cap_evicts_least_recently_used(tmp_path):
    d = tmp_path / "store"
    d.mkdir(mode=0o700)
    store = ps.ProgramStore(str(d), cap_bytes=150)
    now = time.time()
    for i, suffix in enumerate((ps.PROGRAM_SUFFIX, ps.LIBRARY_SUFFIX, ps.PROGRAM_SUFFIX)):
        p = d / f"e{i}{suffix}"
        p.write_bytes(b"x" * 60)
        os.utime(p, (now - 100 + i, now - 100 + i))
    os.utime(d / f"e0{ps.PROGRAM_SUFFIX}", None)  # a hit refreshes recency
    kept = d / f"kept{ps.PROGRAM_SUFFIX}"
    kept.write_bytes(b"x" * 60)
    os.utime(kept, (now - 200, now - 200))  # the oldest, but just written
    (d / "other.txt").write_bytes(b"x" * 1000)  # not an entry: never counted
    assert store._gc(keep=str(kept)) == 2
    assert store.stats()["gc_evictions"] == 2
    assert sorted(os.listdir(d)) == ["e0.prog", "kept.prog", "other.txt"]
    # end to end: real saves over a tiny cap keep the directory within it
    small = ps.ProgramStore(str(tmp_path / "small"), cap_bytes=900)
    eng = EnsembleEngine(method="cuda", device=CPU, batch_sizes=(1,), program_store=small)
    cases = [_cases(1, nt=3 + i, seed=i)[0] for i in range(4)]
    want = EnsembleEngine(method="cuda", device=CPU, batch_sizes=(1,)).run(cases)
    assert all(np.array_equal(a, b) for a, b in zip(want, eng.run(cases), strict=True))
    assert small.stats()["saves"] == 4 and small.stats()["gc_evictions"] >= 1
    assert sum(os.path.getsize(tmp_path / "small" / p)
               for p in _entries(tmp_path / "small")) <= 900


def test_env_knobs_resolve_and_refuse(monkeypatch):
    monkeypatch.delenv("NLHEAT_PROGRAM_STORE", raising=False)
    assert ps.store_dir_from_env() is None and ps.resolve_store(None) is None
    monkeypatch.setenv("NLHEAT_PROGRAM_STORE", "0")
    assert ps.store_dir_from_env() is None
    monkeypatch.setenv("NLHEAT_PROGRAM_STORE", "1")
    assert ps.store_dir_from_env() == ps.DEFAULT_DIR
    assert ps.DEFAULT_DIR.endswith(os.path.join("nlheat", "program_store_torch"))
    monkeypatch.setenv("NLHEAT_PROGRAM_STORE", "/tmp/somewhere")
    assert ps.resolve_store(None).root == "/tmp/somewhere"
    given = ps.ProgramStore("/tmp/x")
    assert ps.resolve_store(given) is given
    monkeypatch.setenv("NLHEAT_PROGRAM_STORE_CAP_MB", "0")
    assert ps.store_cap_from_env() is None
    monkeypatch.setenv("NLHEAT_PROGRAM_STORE_CAP_MB", "0.5")
    assert ps.store_cap_from_env() == 512 * 1024
    monkeypatch.setenv("NLHEAT_PROGRAM_STORE_CAP_MB", "-1")
    with pytest.raises(ValueError, match="CAP_MB must be >= 0"):
        ps.store_cap_from_env()


def test_open_directory_is_refused_and_new_ones_are_private(tmp_path, capsys):
    cases = _cases()
    _store_one(tmp_path / "private")
    assert stat.S_IMODE(os.stat(tmp_path / "private").st_mode) == 0o700
    d = tmp_path / "open"
    d.mkdir()
    os.chmod(d, 0o777)
    eng = EnsembleEngine(method="cuda", device=CPU, program_store=str(d))
    eng.run(cases)
    eng.run(_cases(seed=5, nt=4))
    assert eng.program_store.stats()["refusals"] == {ps.REFUSE_UNSUPPORTED: 2}
    assert os.listdir(d) == [] and eng.report.programs_built == 2
    assert capsys.readouterr().err.count("group- or world-writable") == 1


def test_cpu_fallback_sibling_is_keyed_apart(tmp_path, monkeypatch):
    from nonlocalheatequation_torch.serve.resilience import CpuFallback

    real = ps.topology_fingerprint
    monkeypatch.setattr(ps, "topology_fingerprint",  # a card this host does not have
                        lambda b: {"platform": b} if b.startswith("cuda") else real(b))
    cases = _cases()
    card = EnsembleEngine(method="conv", device=CPU, program_store=str(tmp_path),
                          store_backend="cuda:Fake Card")
    card.run(cases)
    assert card.program_store.stats()["saves"] == 1
    fb = CpuFallback(card)._sibling(2)
    assert fb.store_backend is None and fb.device.type == "cpu"
    fb.run(cases)
    assert fb.program_store.stats()["hits"] == 0 and len(_entries(tmp_path)) == 2
    for backend in ("cuda:Fake Card", "cpu"):
        d = ps._digest("program", "k", "t(1,)", backend)
        assert d != ps._digest("program", "k", "t(1,)", "cuda:Other Card")
    # the tuner knobs join the digest
    os.environ["NLHEAT_TUNE_BATCH"] = "1"
    try:
        tuned = ps._digest("program", "k", "", "cpu")
    finally:
        del os.environ["NLHEAT_TUNE_BATCH"]
    assert tuned != ps._digest("program", "k", "", "cpu")


def test_serve_report_store_block_and_spans(tmp_path):
    from nonlocalheatequation_tpu.serve import server as jserver

    tracer = obs_trace.Tracer()
    prev = obs_trace.set_tracer(tracer)
    try:
        for _ in range(2):
            with ServePipeline(engine=EnsembleEngine(method="cuda", device=CPU,
                                                     program_store=str(tmp_path)),
                               depth=2, window_ms=0.0) as pipe:
                pipe.serve_cases(_cases(4))
            m = pipe.metrics()
    finally:
        obs_trace.set_tracer(prev)
    store = m["store"]
    assert set(store) == set(jserver.ServeReport().store())
    # window 0: a chunk a case, four physics, four programs
    assert (store["hits"], store["misses"], store["refusals"]) == (4, 0, {})
    assert store["load_ms"]["p50"] >= 0 and m["programs_loaded"] == 4
    names = {e["name"] for e in tracer.events}
    assert {"store.save", "store.load"} <= names


@pytest.mark.parametrize("dim", [2, 3])
def test_solo_path_warm_solve_runs_no_probe(tmp_path, monkeypatch, spies, dim):
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, NonlocalOp3D

    monkeypatch.setenv("NLHEAT_PROGRAM_STORE", str(tmp_path))
    hits = ps.library_store().stats()["hits"]  # the process registry's
    shape = (14, 13) if dim == 2 else (8, 7, 6)
    op = (NonlocalOp2D if dim == 2 else NonlocalOp3D)(2, 1.0, 1e-5, 1 / 14)
    u = torch.as_tensor(np.random.default_rng(dim).normal(size=shape))
    cold = ps.solo_pick(op, 6, shape, torch.float64, CPU)(u, 0)
    assert spies["probe"] > 0 and spies["build"] == 1
    autotune.reset()
    n_probe = spies["probe"]
    warm_fn = ps.solo_pick(op, 6, shape, torch.float64, CPU)
    assert torch.equal(warm_fn(u, 0), cold)
    assert (spies["probe"], spies["build"]) == (n_probe, 1)
    assert ps.library_store().stats()["hits"] == hits + 1
    # another step count is another program
    ps.solo_pick(op, 7, shape, torch.float64, CPU)(u, 0)
    assert spies["build"] == 2 and len(_entries(tmp_path)) == 2


FAKE_NVCC = """#!{python}
import sys
with open({count!r}, "a") as f:
    f.write("x\\n")
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "wb") as f:
    f.write(b"fake library of " + sys.argv[-1].encode())
print("ptxas info    : Used 1 registers")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A fake nvcc on PATH that writes bytes and counts its runs; the
    package's _build directory moved under tmp_path."""
    bindir, count = tmp_path / "bin", tmp_path / "nvcc_runs"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, count=str(count)))
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return lambda: len(count.read_text().splitlines()) if count.exists() else 0


def test_library_entries_warm_boot_runs_no_nvcc(tmp_path, monkeypatch, fake_nvcc, capsys):
    import shutil

    sources = ("nsum2d.cu", "gather_L.cu")
    store_dir = tmp_path / "store"
    # store off: nvcc runs, nothing is stored
    monkeypatch.delenv("NLHEAT_PROGRAM_STORE", raising=False)
    _build.build(sources)
    assert fake_nvcc() == 2 and not store_dir.exists()
    built = {s: _build.library_path(s).read_bytes() for s in sources}
    # store on: libraries found built are saved
    monkeypatch.setenv("NLHEAT_PROGRAM_STORE", str(store_dir))
    assert _build.build(sources) == {s: 0.0 for s in sources}
    assert len(_entries(store_dir, ps.LIBRARY_SUFFIX)) == 2 and fake_nvcc() == 2
    # a warm boot from an empty _build: restored from the store, nvcc never runs
    shutil.rmtree(_build.BUILD_DIR)
    assert _build.build(sources) == {s: 0.0 for s in sources}
    assert fake_nvcc() == 2
    assert {s: _build.library_path(s).read_bytes() for s in sources} == built
    assert ps.library_store().stats()["library_loads"] >= 2
    # a corrupt library entry is refused loudly and rebuilt by nvcc
    lib_entry = store_dir / _entries(store_dir, ps.LIBRARY_SUFFIX)[0]
    lib_entry.write_bytes(lib_entry.read_bytes()[:-4])
    shutil.rmtree(_build.BUILD_DIR)
    _build.build(sources)
    assert fake_nvcc() == 3 and "[corrupt]" in capsys.readouterr().err


def test_program_entry_restores_the_libraries_its_first_call_launched(tmp_path, monkeypatch,
                                                                      fake_nvcc):
    import shutil

    monkeypatch.setenv("NLHEAT_PROGRAM_STORE", str(tmp_path / "store"))
    _build.build(("gather_L.cu",))
    assert fake_nvcc() == 1
    store = ps.library_store()
    made = {"build": 0, "materialize": 0}

    def program(x):
        ck.LAUNCHES["gather_L"] += 1  # what a launch of the kernel counts
        return x + 1

    def build():
        made["build"] += 1
        return program, {"strategy": "fixed"}

    def materialize(recipe):
        made["materialize"] += 1
        assert recipe["libs"] == {"gather_L.cu": _build.source_digest("gather_L.cu")}
        return program

    ex = (torch.empty((4,), device="meta"),)
    fn, outcome = store.load_or_build("key", build, ex, backend="cpu", materialize=materialize)
    assert outcome == "miss" and _entries(tmp_path / "store") == []  # written at first call
    assert fn(1) == 2 and fn(2) == 3
    assert len(_entries(tmp_path / "store")) == 1
    shutil.rmtree(_build.BUILD_DIR)
    fn2, outcome = store.load_or_build("key", build, ex, backend="cpu",
                                       materialize=materialize)
    assert (outcome, made) == ("hit", {"build": 1, "materialize": 1})
    assert _build.library_path("gather_L.cu").exists() and fake_nvcc() == 1
    assert fn2(1) == 2
