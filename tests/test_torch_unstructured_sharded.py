"""The port's sharded unstructured operator (ops/unstructured.py
``ShardedUnstructuredOp``), its K-step superstep under ``UnstructuredSolver``,
``serve/meshes.gang_order`` and ``solve_unstructured --devices/--halo/
--superstep/--gang-order`` against the JAX package's on the CPU.

The JAX operator runs on the suite's 8 virtual CPU devices
(tests/conftest.py), as tests/test_unstructured_sharded.py runs it; the
port's mesh holds the same number of virtual CPU devices.  Clouds are seeded
jittered grids of a few hundred to a thousand nodes.

Tolerances: halo modes, comm ratios, layouts, fit gates and node orders equal
the JAX package's; export and gather bitwise equal (and, on the CPU, bitwise
the single-device ``edges`` layout); the offsets form and its superstep
bitwise the single-device offsets layout's per-step solve; every form to
1e-12 against the JAX sharded operator, the NumPy oracle and the JAX solves
(float64); states crossing the packages bitwise.
"""

import io
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nonlocalheatequation_torch import convert
from nonlocalheatequation_torch.cli import solve_unstructured as tcli
from nonlocalheatequation_torch.ops import unstructured as tu
from nonlocalheatequation_torch.parallel.mesh import device_list
from nonlocalheatequation_torch.serve import meshes as tmeshes
from nonlocalheatequation_torch.utils.checkpoint import load_state
from nonlocalheatequation_tpu.ops import unstructured as ju
from nonlocalheatequation_tpu.serve import meshes as jmeshes
from tests.cases import L2_THRESHOLD

torch.set_num_threads(1)


def jittered_cloud(m=16, seed=0):
    """m x m grid nodes jittered 20% (the JAX test's cloud)."""
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    xs, ys = np.meshgrid(np.arange(m) * h, np.arange(m) * h, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    return pts, h


def _pair(pts, eps, **kw):
    return (tu.UnstructuredNonlocalOp(pts, eps, device="cpu", **kw),
            ju.UnstructuredNonlocalOp(pts, eps, **kw))


def _devs(S):
    return device_list("cpu", S)


def _jsharded(jop, S, **kw):
    return ju.ShardedUnstructuredOp(jop, devices=jax.devices()[:S], **kw)


def _apply(sh, u):
    return sh.apply(torch.as_tensor(u)).numpy()


# -- the operator --------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["auto", "edges"])
def test_sharded_apply_matches_single_device_and_jax(S, layout):
    pts, h = jittered_cloud()
    eps = 3.05 * h * (1.0 + 0.2 * np.sin(7.0 * pts[:, 0]))  # a variable horizon
    top, jop = _pair(pts, eps, k=1.0, dt=1e-5, vol=h * h)
    ours, theirs = tu.ShardedUnstructuredOp(top, devices=_devs(S), layout=layout), \
        _jsharded(jop, S, layout=layout)
    assert (ours.layout, ours.halo_mode, ours.B, ours.pad) == (
        theirs.layout, theirs.halo_mode, theirs.B, theirs.pad)
    assert ours.halo_comm_ratio == theirs.halo_comm_ratio
    u = np.random.default_rng(1).normal(size=top.n)
    got = _apply(ours, u)
    single = top.apply(torch.as_tensor(u), layout="edges" if ours.layout == "edges"
                       else "offsets").numpy()
    assert np.array_equal(got, single)
    if ours.layout == "edges":  # (the JAX offsets form compiles for tens of seconds;
        # the superstep test below holds it through the JAX solver)
        assert np.abs(got - np.asarray(theirs.apply(jnp.asarray(u)))).max() < 1e-12
    assert np.abs(got - top.apply_np(u)).max() < 1e-12


@pytest.mark.parametrize("halo", ["export", "gather"])
def test_sharded_apply_uneven_block_padding(halo):
    # n = 225 over 8 devices: B = 29, the last block short
    pts, h = jittered_cloud(m=15, seed=3)
    top, jop = _pair(pts, 2.5 * h, k=1.0, dt=1e-5, vol=h * h)
    ours = tu.ShardedUnstructuredOp(top, devices=_devs(8), halo=halo)
    assert top.n % 8 and ours.pad == 8 * 29 - 225
    u = np.random.default_rng(2).normal(size=top.n)
    got = _apply(ours, u)
    want = np.asarray(_jsharded(jop, 8, halo=halo).apply(jnp.asarray(u)))
    assert np.abs(got - want).max() < 1e-12
    assert np.abs(got - top.apply_np(u)).max() < 1e-12


def test_export_halo_bitwise_the_full_gather():
    pts, h = jittered_cloud(m=16, seed=11)
    top, _ = _pair(pts, 3.0 * h, k=1.0, dt=1e-5, vol=h * h)
    a = tu.ShardedUnstructuredOp(top, devices=_devs(8), halo="export")
    b = tu.ShardedUnstructuredOp(top, devices=_devs(8), halo="gather")
    assert a.halo_mode == "export" and b.halo_mode == "gather"
    u = np.random.default_rng(4).normal(size=top.n)
    ra, rb = _apply(a, u), _apply(b, u)
    assert np.array_equal(ra, rb)
    assert np.abs(ra - top.apply_np(u)).max() < 1e-12


def test_export_halo_auto_selection_equals_jax():
    # thick blocks on a grid order: export; a random permutation: gather
    pts, h = jittered_cloud(m=128, seed=13)
    top, jop = _pair(pts, 3.0 * h, k=1.0, dt=1e-5, vol=h * h)
    s1, j1 = tu.ShardedUnstructuredOp(top, devices=_devs(8), layout="edges"), \
        _jsharded(jop, 8, layout="edges")
    assert s1.halo_mode == j1.halo_mode == "export"
    assert s1.halo_comm_ratio == j1.halo_comm_ratio < 0.5
    assert np.array_equal(s1._exp_idx, np.asarray(j1._exp_idx))
    pts, h = jittered_cloud(m=16, seed=13)
    rng = np.random.default_rng(5)
    perm = rng.permutation(len(pts))
    top2, jop2 = _pair(pts[perm], 3.0 * h, k=1.0, dt=1e-5, vol=h * h)
    s2, j2 = tu.ShardedUnstructuredOp(top2, devices=_devs(8)), _jsharded(jop2, 8)
    assert s2.halo_mode == j2.halo_mode == "gather"
    u = rng.normal(size=top2.n)
    assert np.abs(_apply(s2, u) - top2.apply_np(u)).max() < 1e-12


def test_constructor_refusals_match_jax():
    pts, h = jittered_cloud(m=16, seed=2)
    top, jop = _pair(pts, 3.0 * h, k=1.0, dt=1e-6, vol=h * h)
    for kw, words in ((dict(layout="offsets", halo="export"), "cannot honor"),
                      (dict(layout="diag"), "auto/offsets/edges"),
                      (dict(halo="ring", layout="edges"), "auto/export/gather")):
        with pytest.raises(ValueError, match=words):
            tu.ShardedUnstructuredOp(top, devices=_devs(4), **kw)
        with pytest.raises(ValueError, match=words):
            _jsharded(jop, 4, **kw)
    # the shuffled cloud cannot take the offsets layout
    perm = np.random.default_rng(0).permutation(top.n)
    top_s, _ = _pair(pts[perm], 3.0 * h, k=1.0, dt=1e-6, vol=h * h)
    with pytest.raises(ValueError, match="full offset coverage"):
        tu.ShardedUnstructuredOp(top_s, devices=_devs(2), layout="offsets")


# -- the solver ------------------------------------------------------------------------

def test_sharded_solver_matches_single_device_and_jax():
    pts, h = jittered_cloud(m=12, seed=5)
    top, jop = _pair(pts, 2.8 * h, k=0.5, dt=1e-5, vol=h * h)
    single = tu.UnstructuredSolver(top, nt=20, layout="edges")
    sharded = tu.UnstructuredSolver(tu.ShardedUnstructuredOp(top, devices=_devs(8)), nt=20)
    js = ju.UnstructuredSolver(ju.ShardedUnstructuredOp(jop), nt=20)
    for s in (single, sharded, js):
        s.test_init()
        s.do_work()
    assert np.array_equal(sharded.u, single.u)
    assert np.abs(sharded.u - np.asarray(js.u)).max() < 1e-12
    assert sharded.error_l2 / top.n <= L2_THRESHOLD


def _offsets_cloud_4dev(m=32, seed=0):
    """A jittered grid whose offsets form fits K=2 on 4 devices."""
    pts, h = jittered_cloud(m=m, seed=seed)
    top, jop = _pair(pts, 3.0 * h, k=1.0, dt=1e-6, vol=h * h)
    sh = tu.ShardedUnstructuredOp(top, devices=_devs(4))
    jsh = _jsharded(jop, 4)
    assert sh.layout == jsh.layout == "offsets"
    return top, jop, sh, jsh


def test_superstep_engages_and_matches_the_oracle_and_jax(monkeypatch):
    top, jop, sh, jsh = _offsets_cloud_4dev()
    for K in (2, 3, 5):
        assert sh.superstep_fits(K) == jsh.superstep_fits(K)
    assert sh.superstep_fits(2) and not sh.superstep_fits(5)
    o = tu.UnstructuredSolver(top, nt=7, backend="oracle")
    o.test_init()
    uo = o.do_work()
    built = []
    real = tu.ShardedUnstructuredOp.make_superstep

    def probed(self, *a, **kw):
        built.append(a[0])
        return real(self, *a, **kw)

    monkeypatch.setattr(tu.ShardedUnstructuredOp, "make_superstep", probed)
    outs = {}
    for K in (1, 2):
        s = tu.UnstructuredSolver(sh, nt=7, superstep=K)
        s.test_init()
        outs[K] = s.do_work()
        assert s.error_l2 / top.n <= L2_THRESHOLD
    assert built == [2], "the superstep block did not engage"
    single = tu.UnstructuredSolver(top, nt=7, layout="offsets")
    single.test_init()
    single.do_work()
    js = ju.UnstructuredSolver(jsh, nt=7, superstep=2)
    js.test_init()
    js.do_work()
    for K in (1, 2):
        # each level runs the per-step program: bitwise the single-device offsets solve
        assert np.array_equal(outs[K], single.u)
    assert np.abs(outs[2] - uo).max() < 1e-12
    assert np.abs(outs[2] - np.asarray(js.u)).max() < 1e-12


def test_superstep_input_path_and_checkpoint_chunks(tmp_path):
    # free decay and a checkpoint every 3 of 7 steps: K-blocks and remainders
    top, _, sh, _ = _offsets_cloud_4dev(seed=4)
    u0 = np.random.default_rng(7).normal(size=top.n)
    outs = {}
    for K in (1, 2):
        ck = tmp_path / f"ck{K}.npz"
        s = tu.UnstructuredSolver(sh, nt=7, superstep=K, checkpoint_path=str(ck),
                                  ncheckpoint=3)
        s.input_init(u0)
        outs[K] = s.do_work()
        u, t, _ = load_state(str(ck))
        assert t == 6 and u.shape == (top.n,)
    assert np.array_equal(outs[1], outs[2])


def test_superstep_honesty_gates():
    pts, h = jittered_cloud(m=16, seed=2)
    top, jop = _pair(pts, 3.0 * h, k=1.0, dt=1e-6, vol=h * h)
    with pytest.raises(ValueError, match="Sharded"):
        tu.UnstructuredSolver(top, nt=4, superstep=2)
    with pytest.raises(ValueError, match="Sharded"):
        ju.UnstructuredSolver(jop, nt=4, superstep=2)
    sh8 = tu.ShardedUnstructuredOp(top, devices=_devs(8))
    assert sh8.layout == _jsharded(jop, 8).layout
    with pytest.raises(ValueError, match="does not fit"):
        tu.UnstructuredSolver(sh8, nt=4, superstep=2)
    perm = np.random.default_rng(0).permutation(top.n)
    top_s, _ = _pair(pts[perm], 3.0 * h, k=1.0, dt=1e-6, vol=h * h)
    shs = tu.ShardedUnstructuredOp(top_s, devices=_devs(2))
    assert shs.layout == "edges"
    with pytest.raises(ValueError, match="does not fit"):
        tu.UnstructuredSolver(shs, nt=4, superstep=2)
    with pytest.raises(ValueError, match="K=1 IS the"):
        shs.superstep_check(1)
    with pytest.raises(ValueError, match="torch backend"):
        tu.UnstructuredSolver(sh8, nt=4, backend="oracle", superstep=2)


def test_superstep_refuses_a_cadence_with_no_k_block(tmp_path):
    _, _, sh, _ = _offsets_cloud_4dev(seed=9)
    s = tu.UnstructuredSolver(sh, nt=8, superstep=2, checkpoint_path=str(tmp_path / "c.npz"),
                              ncheckpoint=1)
    s.test_init()
    with pytest.raises(RuntimeError, match="cannot engage"):
        s.do_work()


def test_superstep_checkpoint_portable_across_schedules(tmp_path):
    _, _, sh, _ = _offsets_cloud_4dev(seed=11)
    straight = tu.UnstructuredSolver(sh, nt=8)
    straight.test_init()
    u_ref = straight.do_work()
    for k_write, k_resume in ((2, 1), (1, 2)):
        ck = tmp_path / f"ck-{k_write}-{k_resume}.npz"
        w = tu.UnstructuredSolver(sh, nt=8, superstep=k_write, checkpoint_path=str(ck),
                                  ncheckpoint=4)
        w.test_init()
        w.nt = 6  # stopped after step 6: the file holds t=4
        w.do_work()
        r = tu.UnstructuredSolver(sh, nt=8, superstep=k_resume)
        r.test_init()
        r.resume(str(ck))
        assert r.t0 == 4
        assert np.array_equal(r.do_work(), u_ref)


def test_sharded_3d_cloud_offsets_and_superstep():
    rng = np.random.default_rng(3)
    m = 12
    h = 1.0 / m
    ax = np.arange(m) * h
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], 1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    top, jop = _pair(pts, 2.5 * h, k=1.0, dt=1e-7, vol=h ** 3)
    sh, jsh = tu.ShardedUnstructuredOp(top, devices=_devs(2)), _jsharded(jop, 2)
    assert sh.layout == jsh.layout == "offsets"
    u = rng.normal(size=top.n)
    assert np.abs(_apply(sh, u) - top.apply_np(u)).max() < 1e-12
    s = tu.UnstructuredSolver(sh, nt=5)
    s.test_init()
    us = s.do_work()
    assert s.error_l2 / top.n <= L2_THRESHOLD
    assert sh.superstep_fits(2) and jsh.superstep_fits(2)
    if sh.superstep_fits(2):
        ss = tu.UnstructuredSolver(sh, nt=5, superstep=2)
        ss.test_init()
        assert np.array_equal(ss.do_work(), us)


# -- gang order ----------------------------------------------------------------------

@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_gang_order_equals_jax(nd):
    pts, _ = jittered_cloud(m=24, seed=6)
    pts = pts[np.random.default_rng(1).permutation(len(pts))]
    order = tmeshes.gang_order(pts, nd)
    assert np.array_equal(order, jmeshes.gang_order(pts, nd))
    assert np.array_equal(np.sort(order), np.arange(len(pts)))


def test_gang_order_cuts_the_halo_of_a_shuffled_cloud():
    pts, h = jittered_cloud(m=32, seed=7)
    pts = pts[np.random.default_rng(2).permutation(len(pts))]
    perm = tmeshes.gang_order(pts, 4)
    shuffled = tu.ShardedUnstructuredOp(
        tu.UnstructuredNonlocalOp(pts, 3.0 * h, 1.0, 1e-6, vol=h * h, device="cpu"),
        devices=_devs(4), layout="edges")
    ordered = tu.ShardedUnstructuredOp(
        tu.UnstructuredNonlocalOp(pts[perm], 3.0 * h, 1.0, 1e-6, vol=h * h, device="cpu"),
        devices=_devs(4), layout="edges")
    assert (shuffled.halo_mode, ordered.halo_mode) == ("gather", "export")
    assert ordered.halo_comm_ratio < 0.5


# -- the CLI ---------------------------------------------------------------------------

def _run_tcli(argv, monkeypatch, capsys, stdin=""):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = tcli.main(["--platform", "cpu", *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def _jax_cli(argv, monkeypatch, capsys, stdin=""):
    from nonlocalheatequation_tpu.cli import solve_unstructured as jcli

    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = jcli.main(["--platform", "cpu", *argv])
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--devices", "4", "--superstep", "2", "--gang-order",
                                   "false"],
                                  ["--devices", "4", "--halo", "export"],
                                  ["--devices", "4", "--halo", "gather", "--gang-order",
                                   "false"],
                                  ["--devices", "8"]])
def test_cli_devices_lines_match_the_jax_cli(argv, monkeypatch, capsys):
    base = ["--mesh", "data/50x50.msh", "--test", "--nt", "6", "--no-header"]
    rc, out, err = _run_tcli(base + argv, monkeypatch, capsys)
    assert rc == 0, err
    rc_j, jout = _jax_cli(base + argv, monkeypatch, capsys)
    assert rc_j == 0
    ours, theirs = out.splitlines(), jout.splitlines()
    # the sharding line, the cloud line and the contract line, word for word
    shard = [r for r in ours if r.startswith("sharded over")]
    assert shard and shard == [r for r in theirs if r.startswith("sharded over")]
    assert [r for r in ours if r.startswith("nodes ")] == [
        r for r in theirs if r.startswith("nodes ")]
    e_ours = next(r for r in ours if r.startswith("error_l2/N"))
    e_theirs = next(r for r in theirs if r.startswith("error_l2/N"))
    assert e_ours.endswith("(<= 1e-6)") and e_theirs.endswith("(<= 1e-6)")
    assert float(e_ours.split()[1]) == pytest.approx(float(e_theirs.split()[1]), rel=1e-9)


def test_cli_results_in_the_file_order(monkeypatch, capsys):
    # --results prints the state in the .msh file's order, gang-ordered or not
    u0 = np.random.default_rng(3).normal(size=121)  # the 10x10 mesh's 121 nodes
    stdin = " ".join(f"{v:.17g}" for v in u0)
    base = ["--mesh", "data/10x10.msh", "--nt", "4", "--results", "--no-header",
            "--eps-h", "3"]
    outs = []
    for extra in (["--devices", "1"], ["--devices", "4"],
                  ["--devices", "4", "--gang-order", "false"]):
        rc, out, err = _run_tcli(base + extra, monkeypatch, capsys, stdin)
        assert rc == 0, err
        vals = [r for r in out.splitlines() if r and r[0] in "-0123456789" and "," not in r]
        outs.append(np.array([float(v) for v in vals[-121:]]))
    assert np.allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)  # printed with %g
    assert np.allclose(outs[0], outs[2], rtol=1e-5, atol=1e-6)


def test_cli_superstep_refusals(monkeypatch, capsys):
    base = ["--mesh", "data/50x50.msh", "--test", "--nt", "4"]
    rc, _, err = _run_tcli(base + ["--superstep", "2"], monkeypatch, capsys)
    assert rc == 1 and "ShardedUnstructuredOp" in err
    # gang-ordered, the cloud leaves the offsets layout; K=8 overruns the blocks
    for extra in (["--devices", "4", "--superstep", "2"],
                  ["--devices", "4", "--superstep", "8", "--gang-order", "false"]):
        rc, _, err = _run_tcli(base + extra, monkeypatch, capsys)
        assert rc == 1 and "does not fit" in err, (extra, err)


# -- states across the packages --------------------------------------------------------

@pytest.mark.parametrize("ordered", [False, True])
def test_sharded_state_crosses_the_packages(ordered, tmp_path):
    pts, h = jittered_cloud(m=32, seed=12)
    if ordered:
        pts = pts[tmeshes.gang_order(pts, 4)]
    top, jop = _pair(pts, 3.0 * h, k=1.0, dt=1e-6, vol=h * h)
    jsh = _jsharded(jop, 4)
    K = 2 if jsh.superstep_fits(2) else 1  # gang-ordered, the cloud takes the edge form
    # a JAX sharded solve checkpointed at step 3, resumed in the port to step 6
    ck = tmp_path / "jax.npz"
    j = ju.UnstructuredSolver(jsh, nt=3, checkpoint_path=str(ck), ncheckpoint=3)
    j.test_init()
    j.do_work()
    u, t, params = load_state(str(ck))
    s = convert.unstructured_solver_from_jax_state(jsh, u, t, device="cpu", test=True, nt=6,
                                                   devices=_devs(4), superstep=K)
    assert isinstance(s.op, tu.ShardedUnstructuredOp)
    assert (s.op.layout, s.op.halo_mode) == (jsh.layout, jsh.halo_mode)
    assert s._ckpt_params() == params
    assert s.u0.tobytes() == np.asarray(u).tobytes()  # the state crosses as it is
    ours = s.do_work()
    j6 = ju.UnstructuredSolver(jsh, nt=6)
    j6.test_init()
    assert np.abs(ours - np.asarray(j6.do_work())).max() < 1e-12
    # the reverse: the port's checkpoint at step 6 continues in JAX to step 8
    ck2 = tmp_path / "port.npz"
    p = tu.UnstructuredSolver(tu.ShardedUnstructuredOp(top, devices=_devs(4)), nt=6,
                              checkpoint_path=str(ck2), ncheckpoint=6, superstep=K)
    p.test_init()
    up = p.do_work()
    u6, t6, params6 = load_state(str(ck2))
    assert t6 == 6 and params6 == params and np.array_equal(u6, up)
    r = ju.UnstructuredSolver(jsh, nt=8)
    r.test_init()
    r.resume(str(ck2))
    assert r.t0 == 6 and np.asarray(r.u0).tobytes() == up.tobytes()
    j8 = ju.UnstructuredSolver(jsh, nt=8)
    j8.test_init()
    assert np.abs(np.asarray(r.do_work()) - np.asarray(j8.do_work())).max() < 1e-12
