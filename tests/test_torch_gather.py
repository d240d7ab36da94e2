"""The port's CSR gather tier (ops/gather.py), the plain version of the
``gather_L`` kernel (ops/cuda_unstructured.py), the mesh registry
(serve/meshes.py) and the ensemble engine's mesh buckets against the JAX
package's ``ops/pallas_gather.py``, ``serve/meshes.py`` and engine.

On the CPU: the packed strips equal the JAX strips row for row, and the CSR
table holds the same entries; the plain gather holds the JAX
``build_gather_L`` (Pallas in interpret mode) to 1e-12 in float64 and 1e-5
in float32, and its bf16 operand tier equals the edges-layout oracle on the
bf16-rounded state to 1e-12 (as tests/test_pallas_gather.py bounds the JAX
tier); the rounding goes through float32, as the JAX package's ``astype``
does on the CPU.  Stacked lanes are bitwise their solo runs; ``mesh_hash``
is the JAX hash; a mesh stored by either package resolves in the other; a
mesh bucket holds the JAX engine to 1e-12 (the JAX warm-boot and program
store paths are not used).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch import convert
from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops import cuda_unstructured as cu
from nonlocalheatequation_torch.ops import gather as tg
from nonlocalheatequation_torch.ops import unstructured as tun
from nonlocalheatequation_torch.serve import ensemble as tens
from nonlocalheatequation_torch.serve import meshes as tmesh
from nonlocalheatequation_tpu.ops import pallas_gather as jg
from nonlocalheatequation_tpu.ops import unstructured as jun
from nonlocalheatequation_tpu.serve import ensemble as jens
from nonlocalheatequation_tpu.serve import meshes as jmesh
from tests.cases import L2_THRESHOLD

torch.set_num_threads(1)

CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def cloud(n=120, seed=7):
    """Random planar cloud with a variable horizon (factor ~1.5)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n, 2)), 0.12 * (1.0 + 0.5 * rng.uniform(size=n))


def _ops(n=120, seed=7, k=1.0, dt=1e-4):
    pts, eps = cloud(n, seed)
    return (jun.UnstructuredNonlocalOp(pts, eps, k=k, dt=dt, vol=1.0 / n),
            tun.UnstructuredNonlocalOp(pts, eps, k=k, dt=dt, vol=1.0 / n, device=CPU))


def grid_cloud(n, dh):
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return np.stack([ii.ravel() * dh, jj.ravel() * dh], axis=1)


# -- the baked table ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("seed", [7, 3])
def test_strips_equal_the_jax_strips(dtype, seed):
    jop, top = _ops(seed=seed)
    jcol, jw, tm, n_pad, n_upad = jg.pack_strips(jop, dtype)
    col, w = tg.pack_strips(top, dtype)
    assert tg.pack_strips(top, dtype) is tg.pack_strips(top, dtype)  # cached on the op
    assert col.shape == (top.n, jcol.shape[1]) and w.dtype == np.dtype(dtype)
    assert np.array_equal(col, jcol[:top.n]) and np.array_equal(w, jw[:top.n])
    assert not jw[top.n:].any()  # the JAX rows past n are zero-weight padding
    # the CSR table is the strips' entries without their padding
    rowptr, ccol, cw = tg.csr_table(top)
    deg = np.diff(rowptr)
    assert rowptr[0] == 0 and rowptr[-1] == len(ccol) == len(top.tgt) + top.n
    assert (deg == np.bincount(top.tgt, minlength=top.n) + 1).all()
    for i in range(top.n):
        assert np.array_equal(ccol[rowptr[i]:rowptr[i + 1]], col[i, :deg[i]])
        assert np.array_equal(cw[rowptr[i]:rowptr[i + 1]].astype(dtype), w[i, :deg[i]])
        assert not w[i, deg[i]:].any()


# -- the gather against the JAX kernel -------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_gather_matches_the_jax_kernel(dtype, tol):
    jop, top = _ops()
    u = np.random.default_rng(1).normal(size=top.n)
    want = np.asarray(jg.build_gather_L(jop, dtype)(jnp.asarray(u)), np.float64)
    oracle = np.asarray(jop.apply(jnp.asarray(u), layout="edges"), np.float64)
    ck.reset_launch_counts()
    L = tg.build_gather_L(top, getattr(torch, dtype), device=CPU)
    got = L(torch.tensor(u))
    assert ck.launch_counts()["gather_L"] == 0  # the plain version ran
    assert got.dtype == getattr(torch, dtype) and got.shape == (top.n,)
    assert _rel(got.numpy(), want) <= tol and _rel(got.numpy(), oracle) <= tol


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_bf16_operand_tier_matches_the_rounded_oracle(dtype):
    jop, top = _ops(seed=11)
    u = np.random.default_rng(2).normal(size=top.n)
    rounded = np.asarray(jnp.asarray(u).astype(jnp.bfloat16), np.float64)
    want = np.asarray(jop.apply(jnp.asarray(rounded), layout="edges"), np.float64)
    jax_tier = np.asarray(jg.build_gather_L(jop, dtype, "bf16")(jnp.asarray(u)), np.float64)
    got = tg.build_gather_L(top, getattr(torch, dtype), "bf16", CPU)(torch.tensor(u)).numpy()
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert _rel(got, want) <= tol and _rel(got, jax_tier) <= tol
    full = tg.build_gather_L(top, getattr(torch, dtype), "f32", CPU)(torch.tensor(u)).numpy()
    assert np.abs(full - got).max() > 0  # the rounding is engaged


def test_bf16_rounds_a_float64_state_through_float32_as_jax_does():
    # 1 + 2**-8 + 2**-30 rounds to 1 + 2**-7 directly, but to 1.0 through
    # float32 (which drops the 2**-30 and leaves a tie, rounded to even)
    x = np.array([1 + 2 ** -8 + 2 ** -30, 1 + 3 * 2 ** -8 - 2 ** -30, -(1 + 2 ** -8 + 2 ** -29)])
    jax_rounded = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float64))
    assert jax_rounded[0] == 1.0
    rowptr = torch.arange(len(x) + 1)
    col = torch.arange(len(x), dtype=torch.int32)
    got = cu.gather_L(rowptr, col, torch.ones(len(x), dtype=torch.float64),
                      torch.tensor(x), "bf16")
    assert np.array_equal(got.numpy(), jax_rounded)


def test_grid_cloud_matches_the_grid_operator_interior():
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D

    n, eps, dh = 16, 3, 1.0 / 16
    gop = NonlocalOp2D(eps, k=1.0, dt=1e-4, dh=dh, method="shift")
    uop = tun.UnstructuredNonlocalOp(grid_cloud(n, dh), eps * dh, k=1.0, dt=1e-4,
                                     vol=dh * dh, c=gop.c, device=CPU)
    u = np.random.default_rng(0).normal(size=(n, n))
    a = gop.apply_np(u)
    b = tg.build_gather_L(uop, torch.float64)(torch.tensor(u.ravel())).numpy().reshape(n, n)
    interior = (slice(eps, n - eps),) * 2
    assert np.abs(a[interior] - b[interior]).max() <= 1e-12 * np.abs(a[interior]).max()


def test_gather_refusals():
    _, top = _ops(n=24, seed=4)
    with pytest.raises(ValueError, match="precision"):
        tg.build_gather_L(top, torch.float64, "f16")
    L = tg.build_gather_L(top, torch.float64)
    t = L.table
    u = torch.zeros(top.n, dtype=torch.float64)
    with pytest.raises(ValueError, match="int64"):
        cu.gather_L(t.rowptr.int(), t.col, t.w, u)
    with pytest.raises(ValueError, match="do not fit"):
        cu.gather_L(t.rowptr[:-1], t.col, t.w, u[:-2])
    with pytest.raises(ValueError, match="precision"):
        cu.gather_L(t.rowptr, t.col, t.w, u, "fp8")


# -- the kernel's width and visit order (ops/gather.py) ------------------------------


def jittered(m, d, seed, shuffle=False):
    """An m^d lattice on [0, 1)^d jittered by +/-0.2 spacings, optionally
    shuffled (chip_smoke.py's clouds); (points, spacing)."""
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    grids = np.meshgrid(*([np.arange(m) * h] * d), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    return (pts[rng.permutation(len(pts))] if shuffle else pts), h


def graded(nm, a=0.6):
    """bench.py's graded cloud: spacing (1 -/+ a)/nm, eps = 8 local spacings."""
    xi = (np.arange(nm) + 0.5) / nm
    gp = 1 + a * np.cos(2 * np.pi * xi)
    X, Y = np.meshgrid(xi + a * np.sin(2 * np.pi * xi) / (2 * np.pi),
                       xi + a * np.sin(2 * np.pi * xi) / (2 * np.pi), indexing="ij")
    HX, HY = np.meshgrid(gp / nm, gp / nm, indexing="ij")
    return np.stack([X.ravel(), Y.ravel()], 1), 4.0 * (HX + HY).ravel(), (HX * HY).ravel()


def _cloud_op(name):
    if name == "graded":
        pts, eps, vol = graded(32)
    else:
        m, d, f, shuffle = {"shuffled": (40, 2, 3.0, True), "lattice": (40, 2, 3.0, False),
                            "1D": (700, 1, 4.0, False), "3D": (12, 3, 2.5, False)}[name]
        pts, h = jittered(m, d, 5, shuffle)
        eps, vol = f * h, h ** d
    return tun.UnstructuredNonlocalOp(pts, eps, k=1.0, dt=1e-6, vol=vol, device=CPU)


# (cloud, entries a row with the centres, width, visited in Morton order)
CLOUD_WIDTHS = [("shuffled", 28, 4, True), ("lattice", 28, 4, False), ("1D", 9, 4, False),
                ("3D", 57, 8, False), ("graded", 208, 32, False)]


@pytest.mark.parametrize("name,mean,width,morton", CLOUD_WIDTHS)
def test_gather_width_and_order_of_the_clouds(name, mean, width, morton):
    op = _cloud_op(name)
    rowptr, col, _ = tg.csr_table(op)
    assert -(-len(col) // op.n) == mean
    assert tg.gather_width(len(col), op.n) == width
    table = tg.GatherTable(op, torch.float64, CPU)
    assert table.width == width and (table.order is not None) == morton
    if morton:  # the rows in the Morton order of their points, each once
        assert isinstance(table.order, cu.VisitOrder)
        order = table.order.perm.numpy()
        assert table.order.perm.dtype == torch.int32
        assert np.array_equal(np.sort(order), np.arange(op.n))
        from nonlocalheatequation_torch.ops.windowed import morton_perm
        assert np.array_equal(order, morton_perm(op.points, float(op.eps.max())))
    L = tg.build_gather_L(op, torch.float64, device=CPU)
    assert L.table is tg.GatherTable.of(op, torch.float64, CPU)
    u = torch.tensor(np.random.default_rng(6).normal(size=op.n))
    # the plain version computes the same function whatever the order
    want = cu.gather_L_plain(table.rowptr, table.col, table.w, u)
    assert torch.equal(L(u), want)


@pytest.mark.parametrize("n,nnz,width", [(0, 0, 32), (5, 0, 4), (10, 320, 4), (10, 321, 8),
                                         (10, 640, 8), (10, 641, 16), (10, 1280, 16),
                                         (10, 1281, 32), (3, 10**6, 32)])
def test_gather_width_rule(n, nnz, width):
    # the smallest width whose iteration (8 entries a lane) covers a row of
    # the mean length; 32 for an empty table
    assert tg.gather_width(nnz, n) == width


def test_gather_width_and_order_refusals():
    _, top = _ops(n=24, seed=4)
    t = tg.GatherTable(top, torch.float64, CPU)
    u = torch.zeros(top.n, dtype=torch.float64)
    ck.reset_launch_counts()
    for width in (0, 2, 5, 64, None):
        with pytest.raises(ValueError, match="lanes a row"):
            cu.gather_L(t.rowptr, t.col, t.w, u, "f32", width)
    order = torch.arange(top.n, dtype=torch.int32)
    # a visit order is a permutation of the rows, checked once where it is
    # made: not int32, an entry out of range, a repeated entry
    with pytest.raises(ValueError, match="int32"):
        cu.VisitOrder(order.long())
    for bad in (order + 1, torch.cat([order[:-1], order[:1]]), order - 1):
        with pytest.raises(ValueError, match="permutation"):
            cu.VisitOrder(bad)
    # gather_L takes only a checked order, of the state's length
    with pytest.raises(TypeError, match="VisitOrder"):
        cu.gather_L(t.rowptr, t.col, t.w, u, "f32", 4, order)
    with pytest.raises(ValueError, match="visit order"):
        cu.gather_L(t.rowptr, t.col, t.w, u, "f32", 4, cu.VisitOrder(order[:-1]))
    assert ck.launch_counts()["gather_L"] == 0
    # a good width and order take the plain version on the CPU
    got = cu.gather_L(t.rowptr, t.col, t.w, u + 1.0, "f32", 4, cu.VisitOrder(order.flip(0)))
    assert torch.equal(got, cu.gather_L_plain(t.rowptr, t.col, t.w, u + 1.0))
    assert ck.launch_counts()["gather_L"] == 0


# -- step forms -------------------------------------------------------------------


@pytest.mark.parametrize("test", [False, True])
def test_multi_step_matches_jax_and_lanes_are_bitwise_solo(test):
    jop, top = _ops(n=80, seed=5, dt=1e-5)
    rng = np.random.default_rng(3)
    u0 = top.spatial_profile() if test else rng.normal(size=top.n)
    want = np.asarray(jg.make_gather_multi_step_fn(jop, 7, dtype=jnp.float64, test=test)(
        jnp.asarray(u0), 0))
    got = tg.make_gather_multi_step_fn(top, 7, dtype=torch.float64, test=test)(
        torch.tensor(u0), 0)
    assert _rel(got.numpy(), want) <= 1e-12
    step = tg.make_gather_step_fn(top, dtype=torch.float64, test=test)
    u = torch.tensor(u0)
    for t in range(7):
        u = step(u, t)
    assert torch.equal(u, got)
    # a stacked chunk of three physics: each lane is bitwise its solo run
    pts, eps = cloud(80, 5)
    ops = [tun.UnstructuredNonlocalOp(pts, eps, k=k, dt=dt, vol=1.0 / 80, device=CPU)
           for k, dt in ((1.0, 1e-5), (0.5, 2e-5), (2.0, 5e-6))]
    U0 = np.stack([u0, u0 * 0.5, rng.normal(size=top.n)])
    for dtype in (torch.float64, torch.float32):
        out = tg.make_batched_gather_multi_step_fn(ops, 6, dtype=dtype, test=test)(
            torch.tensor(U0), 2)
        assert out.shape == (3, top.n) and out.dtype == dtype
        for b, op in enumerate(ops):
            solo = tg.make_gather_multi_step_fn(op, 6, dtype=dtype, test=test)(
                torch.tensor(U0[b]), 2)
            assert torch.equal(out[b], solo)


# -- the mesh registry -----------------------------------------------------------


def test_mesh_hash_and_validation_match_jax():
    pts, eps = cloud(60, 2)
    tgt, src = tun.build_edges(pts, eps)
    assert tmesh.mesh_hash(pts, eps, tgt, src) == jmesh.mesh_hash(pts, eps, tgt, src)
    for bad in ((np.zeros(3), 1.0), (np.zeros((1, 2)), 1.0), (np.zeros((3, 4)), 1.0),
                (np.full((3, 2), np.nan), 1.0), (np.zeros((3, 2)), -1.0)):
        with pytest.raises(ValueError) as a:
            tmesh.validate_mesh(*bad)
        with pytest.raises(ValueError) as b:
            jmesh.validate_mesh(*bad)
        assert str(a.value) == str(b.value)


def test_a_mesh_stored_by_either_package_resolves_in_the_other(tmp_path, monkeypatch):
    pts, eps = cloud(90, 3)
    jstore, tstore = jmesh.MeshStore(str(tmp_path / "j")), tmesh.MeshStore(str(tmp_path / "t"))
    jh, th = jstore.put(pts, eps, 0.01), tstore.put(pts, eps, 0.01)
    assert jh == th
    with np.load(os.path.join(jstore.root, f"{jh}.npz")) as a, \
            np.load(os.path.join(tstore.root, f"{th}.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a.files)
    assert tstore.meta(th) == jstore.meta(jh)
    for root in (jstore.root, tstore.root):
        top = tmesh.get_mesh_op(jh, 0.5, 1e-4, mesh_dir=root, device=CPU)
        jop = jmesh.get_mesh_op(jh, 0.5, 1e-4, mesh_dir=root)
        assert tmesh.get_mesh_op(jh, 0.5, 1e-4, mesh_dir=root, device=CPU) is top
        for field in ("tgt", "src", "edge_w", "c", "wsum"):
            assert np.array_equal(getattr(top, field), getattr(jop, field)), field
    with pytest.raises(ValueError, match="malformed mesh hash"):
        tstore.get("../etc")
    with pytest.raises(tmesh.UnknownMesh, match="unknown mesh hash"):
        tstore.get("0" * 16)
    assert not tstore.has("../x") and tstore.has(th)
    # a stored edge table that the rebuild disagrees with is refused
    bad = dict(tstore.get(th))
    bad["src"] = bad["src"][::-1].copy()
    forged = tmesh.MeshStore(str(tmp_path / "forged"))
    os.makedirs(forged.root)
    np.savez(os.path.join(forged.root, f"{th}.npz"), **bad)
    with pytest.raises(RuntimeError, match="edge-builder drift"):
        tmesh.get_mesh_op(th, 1.0, 1e-4, mesh_dir=forged.root, device=CPU)
    monkeypatch.setenv("NLHEAT_MESH_DIR", "0")
    assert tmesh.resolve_mesh_store() is None
    with pytest.raises(RuntimeError, match="no mesh registry configured"):
        tmesh.get_mesh_op(th, 1.0, 1e-4, device=CPU)
    monkeypatch.setenv("NLHEAT_MESH_DIR", "1")
    assert tmesh.mesh_dir_from_env() == tmesh.DEFAULT_DIR


# -- the engine's mesh buckets -----------------------------------------------------


def _register(tmp_path, monkeypatch, n=20):
    dh = 1.0 / n
    root = str(tmp_path / "meshes")
    mhash = tmesh.MeshStore(root).put(grid_cloud(n, dh), 3 * dh, dh * dh)
    monkeypatch.setenv("NLHEAT_MESH_DIR", root)
    return mhash, n * n


PHYSICS = [(1.0, 1e-4), (0.5, 2e-4), (2.0, 5e-5), (1.0, 1e-4), (0.7, 1e-4)]


@pytest.mark.parametrize("test", [True, False])
def test_mesh_bucket_matches_the_jax_engine(tmp_path, monkeypatch, test):
    mhash, n = _register(tmp_path, monkeypatch)
    rng = np.random.default_rng(4)
    jcases = [jens.EnsembleCase(shape=(n,), nt=6, eps=0, k=k, dt=dt, dh=0.0, test=test,
                                u0=None if test else rng.normal(size=n), mesh=mhash)
              for k, dt in PHYSICS]
    want = jens.EnsembleEngine(method="gather").run(jcases)
    cases = [convert.ensemble_case_from_jax(c) for c in jcases]
    assert all(c.mesh == mhash for c in cases)
    engine = tens.EnsembleEngine(method="gather", device=CPU, dtype=torch.float64)
    got = engine.run(cases)
    r = engine.report
    assert (r.buckets, r.programs_built, r.dispatches, r.padded_cases) == (1, 1, 1, 3)
    assert set(r.strategies.values()) == {"gather[stacked]"}
    for a, b in zip(got, want, strict=True):
        assert a.shape == (n,) and _rel(a, b) <= 1e-12
    # each lane is bitwise its solo gather loop
    for case, u in zip(cases, got, strict=True):
        op = engine._make_op(case)
        u0 = op.spatial_profile() if test else case.u0
        solo = tg.make_gather_multi_step_fn(op, 6, dtype=torch.float64, test=test)(
            torch.tensor(u0), 0)
        assert np.array_equal(u, solo.numpy())
    if test:
        errs = tens.run_test_cases(cases, device=CPU, dtype=torch.float64)
        jerrs = jens.run_test_cases(jcases)
        for (e, m), (je, jm) in zip(errs, jerrs, strict=True):
            assert m == jm == n and e / n <= L2_THRESHOLD
            assert abs(e - je) <= 1e-10 * je


def test_mesh_bucket_bf16_tier_and_refusals(tmp_path, monkeypatch):
    mhash, n = _register(tmp_path, monkeypatch, n=12)
    jcases = [jens.EnsembleCase(shape=(n,), nt=4, eps=0, k=k, dt=dt, dh=0.0, test=True,
                                mesh=mhash) for k, dt in PHYSICS[:2]]
    want = jens.EnsembleEngine(precision="bf16").run(jcases)
    cases = [convert.ensemble_case_from_jax(c) for c in jcases]
    got = tens.EnsembleEngine(precision="bf16", device=CPU, dtype=torch.float64).run(cases)
    assert all(_rel(a, b) <= 1e-12 for a, b in zip(got, want, strict=True))
    for kw, what in (({"method": "cuda"}, "mesh buckets need method='gather' or 'auto'"),
                     ({"variant": "vmap"}, "ensemble variant 'vmap' has no gather form")):
        with pytest.raises(ValueError, match=what):
            tens.EnsembleEngine(device=CPU, **kw).run(cases)
    # an rkc engine builds, and its mesh buckets are refused, as in the JAX engine
    eng = tens.EnsembleEngine(device=CPU, stepper="rkc", stages=4)
    with pytest.raises(ValueError, match="mesh buckets are Euler-only"):
        eng.run(cases)
