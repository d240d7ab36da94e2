"""The port's windowed and offset layouts (ops/windowed.py) and the plain
version of the ``windowed_matvec`` kernel (ops/cuda_unstructured.py)
against the JAX package's ``ops/windowed.py``.

On the CPU: ``morton_perm``, the plan search (``perm``, ``s128``, ``we``,
R, coverage) and the strips P are equal to the JAX plan's for 1D, 2D, 3D,
shuffled, ragged (n not a multiple of 128), self-only and forced-overflow
clouds, one and two windows; the packed in-window entries the kernel reads
unpack to exactly those strips; the plain matvec over them holds the JAX
``_build_windowed_matvec`` (Pallas in interpret mode) and the dense strips'
product to 1e-12 in float64;
the offset layout's plan and residual equal the JAX plan's and hold the
oracle to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops import cuda_unstructured as cu
from nonlocalheatequation_torch.ops import unstructured as tun
from nonlocalheatequation_torch.ops import windowed as tw
from nonlocalheatequation_tpu.ops import unstructured as jun
from nonlocalheatequation_tpu.ops import windowed as jw

torch.set_num_threads(1)

CPU = "cpu"


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(1.0, np.max(np.abs(b))))


def _cloud(m, d=2, seed=0, shuffle=False):
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    grids = np.meshgrid(*([np.arange(m) * h] * d), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    if shuffle:
        pts = pts[rng.permutation(len(pts))]
    return pts, 3.0 * h * (1.0 + 0.2 * np.sin(7.0 * pts[:, 0])), h ** d


def _ragged():
    rng = np.random.default_rng(4)
    return rng.uniform(size=(1000, 2)), 0.08, 1e-3  # 1000 is not a multiple of 128


def _self_only():
    return np.stack([np.linspace(0, 1, 40), np.zeros(40)], axis=1), 1e-6, 1.0


CASES = {
    "2d": (_cloud(32), {}),
    "2d-shuffled-1win": (_cloud(32, seed=1, shuffle=True), {"windows": 1}),
    "2d-shuffled-2win": (_cloud(32, seed=1, shuffle=True), {"windows": 2}),
    "2d-overflow": (_cloud(32, seed=2), {"wmax": 128}),
    "2d-keep": (_cloud(24, seed=3), {"order": "keep"}),
    "3d": (_cloud(10, d=3, seed=5), {}),
    "1d": (_cloud(500, d=1, seed=6), {}),
    "ragged": (_ragged(), {}),
    "self-only": (_self_only(), {}),
}


def _ops(points, eps, vol):
    return (jun.UnstructuredNonlocalOp(points, eps, k=1.0, dt=1e-6, vol=vol),
            tun.UnstructuredNonlocalOp(points, eps, k=1.0, dt=1e-6, vol=vol, device=CPU))


def _plans(jop, top, **kw):
    args = lambda op: (op.points, op.eps, op.tgt, op.src, op.edge_w, op.c, op.wsum)  # noqa: E731
    return jw.build_plan(*args(jop), **kw), tw.build_plan(*args(top), **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_plan_equals_the_jax_plan(name):
    (points, eps, vol), kw = CASES[name]
    jop, top = _ops(points, eps, vol)
    cell = float(np.max(np.broadcast_to(eps, (len(points),))))
    assert np.array_equal(tw.morton_perm(points, cell), jw.morton_perm(points, cell))
    jp, tp = _plans(jop, top, **kw)
    for field in ("n", "n_pad", "bm", "nb", "we", "R", "W", "coverage"):
        assert getattr(tp, field) == getattr(jp, field), field
    for field in ("perm", "rank", "s128", "ov_tgt", "ov_src", "ov_w", "c_p", "wsum_p"):
        assert np.array_equal(getattr(tp, field), getattr(jp, field)), field
    assert np.array_equal(tp.strips(torch.float64, CPU).numpy(), jp.P)
    assert np.array_equal(tp.strips(torch.float32, CPU).numpy(), np.asarray(jp.P, np.float32))
    assert tp.p_bytes_f32 == jp.p_bytes_f32
    # every edge sits in the strips or in the residual list, once
    assert len(tp.p_vals) + tp.ov_tgt.size == len(top.tgt)
    assert tw.plan_stats(points, eps, top.tgt, top.src, **kw) == jw.plan_stats(
        points, eps, jop.tgt, jop.src, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matvec_matches_the_jax_kernel(name):
    (points, eps, vol), kw = CASES[name]
    jop, top = _ops(points, eps, vol)
    jp, tp = _plans(jop, top, **kw)
    ex = tp.for_dtype(torch.float64, CPU)
    u = np.random.default_rng(1).normal(size=top.n)
    jmv = jw._build_windowed_matvec(jp.nb, jp.bm, jp.we, jp.R, (jp.n_pad + jp.we) // 128,
                                    "float64")
    upad = np.zeros((jp.n_pad + jp.we,))
    upad[:top.n] = u
    want = np.asarray(jmv(jnp.asarray(jp.s128), jnp.asarray(jp.P),
                          jnp.asarray(upad.reshape(-1, 128))))[:top.n, 0]
    ck.reset_launch_counts()
    got = cu.windowed_matvec(ex.rowptr, ex.cols, ex.vals, ex.s128, torch.tensor(u), ex.we)
    assert ck.launch_counts()["windowed_matvec"] == 0  # the plain version ran
    assert got.shape == (top.n,) and _rel(got.numpy(), want) <= 1e-12
    # the packed plain version against the dense strips' product
    dense = cu.dense_matvec_plain(tp.strips(torch.float64, CPU), ex.s128, torch.tensor(u),
                                  ex.we)
    assert _rel(got.numpy(), dense.numpy()) <= 1e-12
    # and the whole windowed operator, residual included
    want_L = jop.apply_np(u)
    assert _rel(ex.L(torch.tensor(u)).numpy(), want_L) <= 1e-12
    assert _rel(np.asarray(jp.for_dtype(jnp.float64).L(jnp.asarray(u))), want_L) <= 1e-12
    u32 = torch.tensor(u, dtype=torch.float32)
    assert _rel(tp.for_dtype(torch.float32, CPU).L(u32).numpy(), want_L) <= 1e-5


def test_matvec_wrapper_checks_its_arguments():
    (points, eps, vol), _ = CASES["2d"]
    _, top = _ops(points, eps, vol)
    ex = top.windowed_plan().for_dtype(torch.float64, CPU)
    u = torch.zeros(top.n, dtype=torch.float64)
    packed = (ex.rowptr, ex.cols, ex.vals)
    with pytest.raises(ValueError, match="needs a 1-D torch.float64"):
        cu.windowed_matvec(ex.rowptr, ex.cols, ex.vals.float(), ex.s128, u, ex.we)
    with pytest.raises(ValueError, match="int32"):
        cu.windowed_matvec(*packed, ex.s128.long(), u, ex.we)
    with pytest.raises(ValueError, match="int32"):
        cu.windowed_matvec(ex.rowptr.long(), ex.cols, ex.vals, ex.s128, u, ex.we)
    with pytest.raises(ValueError, match="int16"):
        cu.windowed_matvec(ex.rowptr, ex.cols.int(), ex.vals, ex.s128, u, ex.we)
    with pytest.raises(ValueError, match="do not match"):
        cu.windowed_matvec(ex.rowptr[:-1], ex.cols, ex.vals, ex.s128, u, ex.we)
    with pytest.raises(ValueError, match="do not match"):
        cu.windowed_matvec(ex.rowptr, ex.cols[:-1], ex.vals, ex.s128, u, ex.we)
    with pytest.raises(ValueError, match="multiple of 128"):
        cu.windowed_matvec(*packed, ex.s128, u, 100)
    with pytest.raises(TypeError, match="1-D float32/float64"):
        cu.windowed_matvec(*packed, ex.s128, u.int(), ex.we)


@pytest.mark.parametrize("name", list(CASES))
def test_packed_entries_unpack_to_the_strips(name):
    (points, eps, vol), kw = CASES[name]
    jop, top = _ops(points, eps, vol)
    jp, tp = _plans(jop, top, **kw)
    rowptr, cols, vals = tp.packed()
    assert tp.packed() is tp.packed()  # built once per plan
    assert rowptr.dtype == np.int32 and cols.dtype == np.uint16 and vals.dtype == np.float64
    assert rowptr.shape == (tp.n_pad + 1,) and rowptr[0] == 0 and rowptr[-1] == len(vals)
    assert np.all(np.diff(rowptr) >= 0) and np.all(np.diff(rowptr)[tp.n:] == 0)
    rows = np.repeat(np.arange(tp.n_pad), np.diff(rowptr))
    # each row's entries by ascending column, each (row, column) once
    assert np.all((np.diff(rows) > 0) | (np.diff(cols.astype(np.int64)) > 0))
    dense = np.zeros((tp.n_pad, tp.W))
    dense[rows, cols] = vals
    assert np.array_equal(dense, jp.P)
    for dtype in (torch.float64, torch.float32):
        ex = tp.for_dtype(dtype, CPU)
        assert ex.vals.dtype == dtype and ex.cols.dtype == torch.int16
        assert np.array_equal(ex.cols.numpy().view(np.uint16), cols)
        dense_t = torch.zeros((tp.n_pad, tp.W), dtype=dtype)
        dense_t[torch.as_tensor(rows), torch.as_tensor(cols.astype(np.int64))] = ex.vals
        assert torch.equal(dense_t, tp.strips(dtype, CPU))
        assert not hasattr(ex, "P")  # no dense strips in the exec


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", ["2d-overflow", "ragged", "self-only", "2d-shuffled-2win"])
def test_packed_plain_equals_the_dense_plain(name, dtype, tol):
    (points, eps, vol), kw = CASES[name]
    _, top = _ops(points, eps, vol)
    plan = top.windowed_plan(**kw)
    ex = plan.for_dtype(dtype, CPU)
    u = torch.tensor(np.random.default_rng(3).normal(size=top.n), dtype=dtype)
    got = cu.windowed_matvec_plain(ex.rowptr, ex.cols, ex.vals, ex.s128, u, ex.we)
    want = cu.dense_matvec_plain(plan.strips(dtype, CPU), ex.s128, u, ex.we)
    assert got.shape == (top.n,) and got.dtype == dtype
    assert _rel(got.numpy(), want.numpy()) <= tol


def test_packed_columns_past_int16_stay_unsigned():
    # row 0 holds the only entry, at window column 40000 (> int16's 32767):
    # the plain version reads the column as unsigned
    nb, we = 320, 40064
    s128 = torch.zeros((nb, 1), dtype=torch.int32)
    u = torch.arange(nb * 128, dtype=torch.float64)
    rowptr = torch.ones(nb * 128 + 1, dtype=torch.int32)
    rowptr[0] = 0
    cols = torch.tensor(np.array([40000], np.uint16).view(np.int16))
    assert int(cols[0]) < 0
    got = cu.windowed_matvec(rowptr, cols, torch.tensor([2.0], dtype=torch.float64), s128, u,
                             we)
    assert got[0] == 80000.0 and torch.all(got[1:] == 0)


def test_plan_cache_rebuilds_on_different_kwargs():
    (points, eps, vol), _ = CASES["2d"]
    _, top = _ops(points, eps, vol)
    a = top.windowed_plan()
    assert top.windowed_plan() is a
    b = top.windowed_plan(wmax=128)
    assert b is not a and b.W == 128
    assert top.offset_plan() is top.offset_plan()
    assert top.offset_plan(max_offsets=4) is not top.offset_plan()


def test_morton_perm_and_plan_on_an_empty_cloud():
    assert tw.morton_perm(np.zeros((0, 2)), 1.0).size == 0
    assert np.array_equal(tw.morton_perm(np.zeros((0, 2)), 1.0),
                          jw.morton_perm(np.zeros((0, 2)), 1.0))


# -- offsets ---------------------------------------------------------------


def _offset_plans(jop, top, **kw):
    args = lambda op: (op.tgt, op.src, op.edge_w, op.c, op.wsum, op.n)  # noqa: E731
    return jw.build_offset_plan(*args(jop), **kw), tw.build_offset_plan(*args(top), **kw)


@pytest.mark.parametrize("kw", [{}, {"max_offsets": 4}, {"coverage_target": 0.9}],
                         ids=["full", "residual", "partial"])
@pytest.mark.parametrize("name", ["2d", "2d-shuffled-2win", "3d", "1d", "ragged"])
def test_offset_plan_and_residual_match_jax(name, kw):
    (points, eps, vol), _ = CASES[name]
    jop, top = _ops(points, eps, vol)
    jp, tp = _offset_plans(jop, top, **kw)
    assert tp.offs == jp.offs and (tp.pad_lo, tp.pad_hi) == (jp.pad_lo, jp.pad_hi)
    assert tp.coverage == jp.coverage and tp.w_bytes_f32 == jp.w_bytes_f32
    for field in ("W", "ov_tgt", "ov_src", "ov_w", "c", "wsum"):
        assert np.array_equal(getattr(tp, field), getattr(jp, field)), field
    if kw.get("max_offsets"):
        assert tp.ov_tgt.size > 0  # the residual path is engaged
    assert tw.offset_stats(top.tgt, top.src, top.n, **kw) == jw.offset_stats(
        jop.tgt, jop.src, jop.n, **kw)
    u = np.random.default_rng(7).normal(size=top.n)
    want = jop.apply_np(u)
    got = tp.for_dtype(torch.float64, CPU).L(torch.tensor(u)).numpy()
    assert _rel(got, want) <= 1e-12
    assert _rel(got, np.asarray(jp.for_dtype(jnp.float64).L(jnp.asarray(u)))) <= 1e-12


def test_offset_plan_duplicate_edges_accumulate():
    tgt = np.array([0, 0, 1, 1, 1], np.int32)
    src = np.array([1, 1, 0, 1, 1], np.int32)
    w = np.array([1.0, 2.0, 3.0, 4.0, 0.5])
    c, wsum = np.ones(2), np.zeros(2)
    a = jw.build_offset_plan(tgt, src, w, c, wsum, 2)
    b = tw.build_offset_plan(tgt, src, w, c, wsum, 2)
    assert np.array_equal(a.W, b.W) and b.offs == a.offs


def test_windowed_plan_duplicate_edges_accumulate():
    pts = np.array([[0.0, 0.0], [0.1, 0.0]])
    eps = np.array([0.2, 0.2])
    tgt = np.array([0, 0, 1, 1, 1], np.int32)
    src = np.array([1, 1, 0, 1, 1], np.int32)
    w = np.array([1.0, 2.0, 3.0, 4.0, 0.5])
    c, wsum = np.ones(2), np.zeros(2)
    a = jw.build_plan(pts, eps, tgt, src, w, c, wsum)
    b = tw.build_plan(pts, eps, tgt, src, w, c, wsum)
    assert np.array_equal(b.strips(torch.float64, CPU).numpy(), a.P)
    rowptr, cols, vals = b.packed()
    assert rowptr[:3].tolist() == [0, 1, 3] and cols[:3].tolist() == [1, 0, 1]
    assert vals.tolist() == [3.0, 3.0, 4.5]
    ex = b.for_dtype(torch.float64, CPU)
    u = torch.tensor([0.5, -2.0], dtype=torch.float64)
    got = cu.windowed_matvec(ex.rowptr, ex.cols, ex.vals, ex.s128, u, ex.we)
    assert got.tolist() == [3.0 * -2.0, 3.0 * 0.5 + 4.5 * -2.0]
