"""The port's tests that need the card: every kernel against its plain
version and the multi-step kernels bitwise against step2d (step3d)
launches, the resident kernels' gates, and the tuner as the default
production path, in 2D and 3D.

Each test carries the ``cuda`` marker and skips inside the test when
``torch.cuda.is_available()`` is false.  The file imports torch, numpy and
the port only, so it also runs where JAX is not installed; tests/conftest.py
imports JAX, so on such a machine run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

The batched kernels (ops/cuda_batched.py) are held per lane, bitwise, to the
solo kernels (``batched_step2d`` also bitwise to its plain version, in its
register design and its tile body), and the ensemble engine runs a
mixed-physics bucket in one ``batched_step2d`` launch per step.  The
unstructured kernels (ops/cuda_unstructured.py) are held to their plain
versions (the packed windowed matvec also on empty rows, ragged n,
duplicate edges and an unaligned state), a windowed solve to the
manufactured contract, and an 8-lane mesh bucket's lanes bitwise to their
solo gather loops.  The halo kernels (ops/cuda_halo.py:
the in-kernel exchange and the split kernels) are held to their plain
versions and bitwise to the one-pass nsum2d/nsum3d on the exchanged frame,
and the distributed solves' fused path (both transports) bitwise to their
collective path on meshes of virtual devices of the one card.

The CPU tests hold the plain versions against the JAX package
(tests/test_torch_kernels.py, test_torch_multistep.py, test_torch_autotune.py,
test_torch_kernels3d.py, test_torch_3d.py, test_torch_batched_kernels.py,
test_torch_ensemble.py, test_torch_unstructured.py, test_torch_windowed.py,
test_torch_gather.py, test_torch_halo.py, test_torch_distributed.py).
"""

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.models.solver3d import Solver3D
from nonlocalheatequation_torch.ops import cuda_batched as cb
from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
from nonlocalheatequation_torch.ops.nonlocal_op import (
    NonlocalOp2D,
    NonlocalOp3D,
    case_scale,
    make_multi_step_fn,
    make_multi_step_fn_base,
)
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.utils import autotune


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device: the kernels have no CPU mode")
    # the default production path, with tuning records kept in the process
    monkeypatch.delenv("NLHEAT_TUNE_PRECISION", raising=False)
    monkeypatch.setenv("NLHEAT_AUTOTUNE_CACHE", "")
    monkeypatch.setattr(autotune, "_memory_cache", {})
    ck.reset_launch_counts()
    return torch.device("cuda")


def _op(n, eps, precision="f32"):
    """A 2D operator at 0.8x the Euler bound (the operator, not the carry,
    dominates each step)."""
    dh = 1.0 / n
    probe = NonlocalOp2D(eps, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)
    return NonlocalOp2D(eps, 1.0, dt, dh, method="cuda", precision=precision)


def _state(n, card, dtype, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, n))).to(
        device=card, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_kernels_match_plain_on_card(card, dtype, tol):
    for nx, ny, eps in [(37, 50, 3), (64, 64, 8), (13, 45, 10), (1, 1, 1)]:
        upad = torch.randn(nx + 2 * eps, ny + 2 * eps, dtype=dtype, device=card)
        u = upad[eps:eps + nx, eps:eps + ny].contiguous()
        for prec in ("f32", "bf16"):
            a, b = ck.nsum2d(upad, eps, prec), ck.nsum2d_plain(upad, eps, prec)
            assert float((a - b).abs().max() / b.abs().max()) <= tol
            a = ck.step2d(u, eps, 3.0, 50.0, 1e-3, precision=prec, g=u, lg=u, t=2)
            b = ck.step2d_plain(u, eps, 3.0, 50.0, 1e-3, precision=prec, g=u, lg=u, t=2)
            assert float((a - b).abs().max() / b.abs().max()) <= tol
    assert {k: ck.launch_counts()[k] for k in ("nsum2d", "step2d")} == {"nsum2d": 8, "step2d": 8}
    with pytest.raises(ValueError, match="beyond what the kernel takes"):
        ck.nsum2d(torch.zeros(200, 200, dtype=dtype, device=card), 70)
    assert {k: ck.launch_counts()[k] for k in ("nsum2d", "step2d")} == {"nsum2d": 8, "step2d": 8}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_multistep_kernels_bitwise_step2d_on_card(card, dtype):
    for n, eps, prec in [(37, 3, "f32"), (64, 8, "f32"), (45, 5, "bf16"), (1, 1, "f32")]:
        top = _op(n, eps, prec)
        u = _state(n, card, dtype, n)
        for steps in (1, 4, 7):
            ck.reset_launch_counts()
            ref = make_multi_step_fn_base(top, steps)(u, 0)
            variants = {"carried2d": ck.make_carried_multi_step_fn(top, steps)}
            for k in (2, 3, 4):
                variants[f"superstep2d/{k}"] = ck.make_superstep_multi_step_fn(top, steps, k)
            if prec == "f32":
                variants["resident2d"] = ck.make_resident_multi_step_fn(top, steps)
            for name, fn in variants.items():
                assert torch.equal(fn(u, 0), ref), (name, n, eps, prec, steps)
            counts = ck.launch_counts()
            assert counts["step2d"] == steps and counts["carried2d"] == steps
            if prec == "f32":
                assert counts["resident2d"] == 1


@pytest.mark.cuda
def test_resident_refuses_a_large_grid_on_card(card):
    assert not ck.fits_resident(4096, 4096, 8, torch.float32, card)
    with pytest.raises(ValueError, match="resident kernel"):
        ck.make_resident_multi_step_fn(_op(4096, 8), 2)(torch.zeros(4096, 4096, device=card), 0)
    assert ck.launch_counts()["resident2d"] == 0


@pytest.mark.cuda
def test_tuner_is_the_default_on_the_card(card, monkeypatch):
    probed = []
    real = autotune._measure
    monkeypatch.setattr(autotune, "_measure", lambda maker, *a: probed.append(maker)
                        or real(maker, *a))
    op, u = _op(64, 8), _state(64, card, torch.float32, 3)
    ref = make_multi_step_fn_base(op, 9)(u, 0)
    assert torch.equal(make_multi_step_fn(op, 9)(u, 0), ref)
    (_key, entry), = autotune.records().items()
    assert set(entry["ms_per_step"]) == {"per-step", "carried", "superstep2", "superstep3",
                                        "resident"}
    assert len(probed) == 5 and all(t > 0 for t in entry["ms_per_step"].values())


@pytest.mark.cuda
def test_solver2d_production_solve_is_tuned_on_card(card, monkeypatch):
    probed = []
    real = autotune._measure
    monkeypatch.setattr(autotune, "_measure", lambda maker, *a: probed.append(maker)
                        or real(maker, *a))
    n, nt, eps = 64, 9, 8
    op = _op(n, eps)
    u0 = np.random.default_rng(5).standard_normal((n, n))
    s = Solver2D(n, n, nt, eps, k=1.0, dt=op.dt, dh=op.dh, method="cuda",
                 dtype=torch.float32, device=card)
    s.input_init(u0)
    got = s.do_work()
    assert len(probed) == 5
    ref = make_multi_step_fn_base(op, nt)(torch.as_tensor(u0, device=card).float(), 0)
    assert np.array_equal(got, ref.cpu().numpy())


def _op3(n, eps, precision="f32"):
    """A 3D operator at 0.8x the Euler bound."""
    dh = 1.0 / n
    probe = NonlocalOp3D(eps, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh**3 * probe.wsum)
    return NonlocalOp3D(eps, 1.0, dt, dh, method="cuda", precision=precision)


def _state3(shape, card, dtype, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(
        device=card, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_3d_kernels_match_plain_on_card(card, dtype, tol):
    for shape, eps in [((9, 17, 33), 3), ((20, 11, 6), 4), ((5, 7, 9), 6), ((1, 1, 1), 1)]:
        op = _op3(max(shape), eps)
        u = _state3(shape, card, dtype, eps)
        upad = torch.nn.functional.pad(u, (eps,) * 6)
        g, lg = torch.randn_like(u), torch.randn_like(u)
        for prec in ("f32", "bf16"):
            a, b = k3.nsum3d(upad, eps, prec), k3.nsum3d_plain(upad, eps, prec)
            assert float((a - b).abs().max() / b.abs().max()) <= tol
            args = (u, eps, case_scale(op), op.wsum, op.dt)
            a = k3.step3d(*args, precision=prec, g=g, lg=lg, t=2)
            b = k3.step3d_plain(*args, precision=prec, g=g, lg=lg, t=2)
            assert float((a - b).abs().max() / b.abs().max()) <= tol
    assert {k: ck.launch_counts()[k] for k in ("nsum3d", "step3d")} == {"nsum3d": 8, "step3d": 8}
    with pytest.raises(ValueError, match="beyond what the kernel takes"):
        k3.nsum3d(torch.zeros(30, 30, 30, dtype=dtype, device=card), 13)
    assert ck.launch_counts()["nsum3d"] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_3d_multistep_kernels_bitwise_step3d_on_card(card, dtype):
    for shape, eps in [((13, 11, 9), 3), ((16, 16, 40), 4), ((6, 6, 6), 8)]:
        top = _op3(max(shape), eps)
        u = _state3(shape, card, dtype, sum(shape))
        for steps in (1, 2, 5):
            ck.reset_launch_counts()
            ref = make_multi_step_fn_base(top, steps)(u, 0)
            for name in ("carried3d", "resident3d"):
                maker = getattr(k3, f"make_{name[:-2]}_multi_step_fn_3d")
                assert torch.equal(maker(top, steps)(u, 0), ref), (name, shape, eps, steps)
            assert {k: v for k, v in ck.launch_counts().items() if v} == {
                "step3d": steps, "carried3d": steps, "resident3d": 1}
        # each frame kernel against its plain version (another summation order)
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        eps_, scale, wsum, dt = k3._production_args(top)
        frame = torch.nn.functional.pad(u, (eps,) * 6)
        for got, want in ((k3.carried3d(frame, eps_, scale, wsum, dt),
                           k3.carried3d_plain(frame, eps_, scale, wsum, dt)),
                          (k3.resident3d(u, eps_, scale, wsum, dt, 3),
                           k3.resident3d_plain(u, eps_, scale, wsum, dt, 3))):
            assert float((got - want).abs().max() / want.abs().max()) <= tol, (shape, eps)


@pytest.mark.cuda
def test_resident3d_refuses_a_large_grid_on_card(card):
    assert k3.fits_resident_3d(128, 128, 128, 6, torch.float32, card)
    assert not k3.fits_resident_3d(256, 256, 256, 4, torch.float32, card)
    with pytest.raises(ValueError, match="resident 3D kernel"):
        k3.make_resident_multi_step_fn_3d(_op3(256, 4), 2)(
            torch.zeros(256, 256, 256, device=card), 0)
    assert ck.launch_counts()["resident3d"] == 0


@pytest.mark.cuda
def test_solver3d_production_solve_is_tuned_on_card(card, monkeypatch):
    probed = []
    real = autotune._measure
    monkeypatch.setattr(autotune, "_measure", lambda maker, *a: probed.append(maker)
                        or real(maker, *a))
    n, nt, eps = 24, 9, 3
    op = _op3(n, eps)
    u0 = np.random.default_rng(6).standard_normal((n, n, n))
    s = Solver3D(n, n, n, nt, eps, k=1.0, dt=op.dt, dh=op.dh, method="cuda",
                 dtype=torch.float32, device=card)
    s.input_init(u0)
    got = s.do_work()
    (_key, entry), = autotune.records().items()
    assert set(entry["ms_per_step"]) == {"per-step", "carried3d", "resident3d"}
    assert len(probed) == 3
    ref = make_multi_step_fn_base(op, nt)(torch.as_tensor(u0, device=card).float(), 0)
    assert np.array_equal(got, ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_batched_kernels_bitwise_solo_launches_on_card(card, dtype, tol, prec):
    rng = np.random.default_rng(11)
    for (nx, ny), eps, batch in [((37, 50), 3, 3), ((64, 64), 8, 8), ((13, 45), 5, 2),
                                 ((1, 1), 1, 1), ((20, 90), 16, 2)]:
        wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(eps)))
        scales = [2.0 + eps + b for b in range(batch)]  # mixed physics
        dts = [0.8 / (sc * wsum) * (1 + 0.1 * b) for b, sc in enumerate(scales)]
        params = cb.case_params(scales, dts, dtype, card)
        U = torch.tensor(rng.standard_normal((batch, nx, ny)), dtype=dtype, device=card)
        G, LG = torch.randn_like(U), torch.randn_like(U)
        coefs = cb.source_coef_table([7], dts, dtype, card)[0]
        frames = torch.nn.functional.pad(U, (eps,) * 4).contiguous()
        shadow = ck.shadow_of(frames) if prec == "bf16" else None
        ck.reset_launch_counts()
        got = {"step": cb.batched_step2d(U, eps, params, wsum, precision=prec),
               "test": cb.batched_step2d(U, eps, params, wsum, G=G, LG=LG, coefs=coefs,
                                         precision=prec),
               "carried": cb.batched_carried2d(frames, eps, params, wsum, shadow=shadow)}
        plain = {"step": cb.batched_step2d_plain(U, eps, params, wsum, precision=prec),
                 "test": cb.batched_step2d_plain(U, eps, params, wsum, G=G, LG=LG,
                                                 coefs=coefs, precision=prec),
                 "carried": cb.batched_carried2d_plain(frames, eps, params, wsum, shadow)}
        ks = [k for k in (1, 2, 3, 4) if cb.fits_batched_superstep(eps, k, dtype, prec, card)]
        for k in ks:
            got[k] = cb.batched_superstep2d(U, eps, params, wsum, k, prec)
            plain[k] = cb.batched_superstep2d_plain(U, eps, params, wsum, k, prec)
        assert {n: v for n, v in ck.launch_counts().items() if v} == {
            "batched_step2d": 2, "batched_carried2d": 1, "batched_superstep2d": len(ks)}
        if prec == "bf16":
            assert torch.equal(got["carried"][1], ck.shadow_of(got["carried"][0]))
            got["carried"], plain["carried"] = got["carried"][0], plain["carried"][0]
        for name in got:
            want = plain[name]
            assert float((got[name] - want).abs().max() / want.abs().max()) <= tol, name
        for b in range(batch):
            u = U[b].contiguous()
            assert torch.equal(got["step"][b], ck.step2d(u, eps, scales[b], wsum, dts[b],
                                                         precision=prec))
            assert torch.equal(got["test"][b], ck.step2d(
                u, eps, scales[b], wsum, dts[b], g=G[b].contiguous(), lg=LG[b].contiguous(),
                t=7, precision=prec))
            solo = ck.carried2d(frames[b].contiguous(), eps, scales[b], wsum, dts[b],
                                shadow=None if shadow is None else shadow[b].contiguous())
            assert torch.equal(got["carried"][b], solo if shadow is None else solo[0])
            for k in ks:
                assert torch.equal(got[k][b], ck.superstep2d(u, eps, scales[b], wsum, dts[b],
                                                             k, prec)), (b, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,prec", [(torch.float64, "f32"), (torch.float32, "f32"),
                                        (torch.float64, "bf16"), (torch.float32, "bf16")])
def test_batched_step2d_bitwise_plain_and_solo_on_card(card, dtype, prec):
    # the register design (eps <= 16) and the shared tile body (eps 33, 64)
    # alike: bitwise the plain version, step2d on every lane, and the first
    # step of batched_carried2d and batched_superstep2d; ragged planes (f32
    # tiles are 128 x 32, f64 64 x 32), mixed physics, both forms
    rng = np.random.default_rng(19)
    for eps in (1, 3, 8, 16, 33, 64):
        wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(eps)))
        for batch, (nx, ny) in ((1, (37, 50)), (3, (130, 45)), (8, (70, 33))):
            scales = [2.0 + eps + b for b in range(batch)]
            dts = [0.8 / (sc * wsum) * (1 + 0.1 * b) for b, sc in enumerate(scales)]
            params = cb.case_params(scales, dts, dtype, card)
            U = torch.tensor(rng.standard_normal((batch, nx, ny)), dtype=dtype, device=card)
            if dtype == torch.float64 and eps == 64:  # the 2D tile exceeds shared memory
                with pytest.raises(ValueError):
                    cb.batched_step2d(U, eps, params, wsum, precision=prec)
                continue
            G, LG = torch.randn_like(U), torch.randn_like(U)
            coefs = cb.source_coef_table([5], dts, dtype, card)[0]
            step = cb.batched_step2d(U, eps, params, wsum, precision=prec)
            test = cb.batched_step2d(U, eps, params, wsum, G=G, LG=LG, coefs=coefs,
                                     precision=prec)
            form = (eps, batch, nx, ny)
            assert torch.equal(step, cb.batched_step2d_plain(U, eps, params, wsum,
                                                             precision=prec)), form
            assert torch.equal(test, cb.batched_step2d_plain(
                U, eps, params, wsum, G=G, LG=LG, coefs=coefs, precision=prec)), form
            assert torch.equal(step, cb.batched_step2d(U, eps, params, wsum, precision=prec))
            for b in range(batch):
                u = U[b].contiguous()
                assert torch.equal(step[b], ck.step2d(u, eps, scales[b], wsum, dts[b],
                                                      precision=prec)), form
                assert torch.equal(test[b], ck.step2d(
                    u, eps, scales[b], wsum, dts[b], g=G[b].contiguous(),
                    lg=LG[b].contiguous(), t=5, precision=prec)), form
            frames = torch.nn.functional.pad(U, (eps,) * 4).contiguous()
            shadow = ck.shadow_of(frames) if prec == "bf16" else None
            carried = cb.batched_carried2d(frames, eps, params, wsum, shadow=shadow)
            if shadow is not None:
                carried = carried[0]
            assert torch.equal(carried[:, eps:eps + nx, eps:eps + ny], step), form
            if cb.fits_batched_superstep(eps, 1, dtype, prec, card):
                assert torch.equal(cb.batched_superstep2d(U, eps, params, wsum, 1, prec),
                                   step), form


@pytest.mark.cuda
def test_mixed_bucket_runs_one_launch_per_step_on_card(card):
    rng = np.random.default_rng(12)
    physics = [(1.0, 1e-4, 0.02), (0.5, 2e-4, 0.02), (0.2, 1e-4, 0.01), (1.0, 5e-5, 0.03)]
    cases = [EnsembleCase(shape=(40, 36), nt=5, eps=3, k=k, dt=dt, dh=dh, test=False,
                          u0=rng.standard_normal((40, 36)))
             for k, dt, dh in physics * 2]
    engine = EnsembleEngine(method="cuda", device=card, dtype=torch.float64)
    res = engine.run(cases)
    assert (engine.report.buckets, engine.report.programs_built,
            engine.report.dispatches) == (1, 1, 1)
    assert {n: v for n, v in ck.launch_counts().items() if v} == {"batched_step2d": 5}
    for case, got in zip(cases, res, strict=True):
        op = NonlocalOp2D(case.eps, case.k, case.dt, case.dh, method="cuda")
        want = make_multi_step_fn_base(op, case.nt)(torch.as_tensor(case.u0, device=card), 0)
        assert np.array_equal(got, want.cpu().numpy())


@pytest.mark.cuda
def test_batch_tuner_probes_every_batched_candidate_on_card(card, monkeypatch):
    monkeypatch.setenv("NLHEAT_TUNE_BATCH", "1")
    rng = np.random.default_rng(13)
    cases = [EnsembleCase(shape=(64, 64), nt=9, eps=8, k=1.0, dt=1e-5 * (1 + b), dh=1 / 64,
                          test=False, u0=rng.standard_normal((64, 64))) for b in range(4)]
    engine = EnsembleEngine(method="cuda", device=card)
    res = engine.run(cases)
    (_key, entry), = autotune.records().items()
    assert set(entry["ms_per_step"]) == {"batched-per-step", "batched-carried",
                                        "batched-superstep2", "batched-superstep3", "vmap"}
    assert engine.report.strategies.popitem()[1] == f"tuned:{entry['winner']}"
    for case, got in zip(cases, res, strict=True):
        op = NonlocalOp2D(case.eps, case.k, case.dt, case.dh, method="cuda")
        want = make_multi_step_fn_base(op, case.nt)(
            torch.as_tensor(case.u0, device=card).float(), 0)
        tol = 0.0 if entry["winner"] != "vmap" else 1e-5
        assert float(np.abs(got - want.cpu().numpy()).max()) <= tol * float(np.abs(got).max())


# -- the unstructured kernels (ops/cuda_unstructured.py) --------------------------


def _cloud(m, d=2, seed=0, shuffle=False):
    """A jittered lattice cloud with a varying horizon of about 3 spacings."""
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    grids = np.meshgrid(*([np.arange(m) * h] * d), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    if shuffle:
        pts = pts[rng.permutation(len(pts))]
    return pts, 3.0 * h * (1.0 + 0.2 * np.sin(7.0 * pts[:, 0])), h ** d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_unstructured_kernels_match_plain_on_card(card, dtype, tol):
    from nonlocalheatequation_torch.ops import cuda_unstructured as cu
    from nonlocalheatequation_torch.ops.gather import GatherTable
    from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp

    rng = np.random.default_rng(21)
    for m, d, shuffle in [(40, 2, False), (40, 2, True), (10, 3, False), (300, 1, False)]:
        pts, eps, vol = _cloud(m, d, seed=m + d, shuffle=shuffle)
        op = UnstructuredNonlocalOp(pts, eps, k=1.0, dt=1e-6, vol=vol, device=card)
        u = torch.tensor(rng.standard_normal(op.n), device=card, dtype=dtype)
        for wmax in (4096, 128):  # 128: most edges overflow to the residual
            ex = op.windowed_plan(wmax=wmax).for_dtype(dtype, card)
            packed = (ex.rowptr, ex.cols, ex.vals, ex.s128)
            a = cu.windowed_matvec(*packed, u, ex.we)
            b = cu.windowed_matvec_plain(*packed, u, ex.we)
            assert float((a - b).abs().max() / b.abs().max()) <= tol
            L = ex.L(u).double().cpu().numpy()
            want = op.apply_np(u.double().cpu().numpy())
            assert float(np.abs(L - want).max() / np.abs(want).max()) <= tol
        table = GatherTable(op, dtype, card)
        for prec in ("f32", "bf16"):
            a = cu.gather_L(table.rowptr, table.col, table.w, u, prec)
            b = cu.gather_L_plain(table.rowptr, table.col, table.w, u, prec)
            assert float((a - b).abs().max() / b.abs().max()) <= tol
            assert torch.equal(a, cu.gather_L(table.rowptr, table.col, table.w, u, prec))
    # per cloud: two plans x (the matvec + the operator), two tiers x two launches
    assert {k: v for k, v in ck.launch_counts().items() if v} == {"windowed_matvec": 16,
                                                                 "gather_L": 16}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_packed_windowed_matvec_edge_cases_on_card(card, dtype, tol):
    # the packed kernel against its plain version where the layout is
    # awkward: every row empty (a self-only horizon), n not a multiple of
    # 128 (rows and window cells past n), duplicate edges, a forced residual,
    # and a state that is not 16-byte aligned (no bulk copy of the windows)
    from nonlocalheatequation_torch.ops import cuda_unstructured as cu
    from nonlocalheatequation_torch.ops import windowed as tw
    from nonlocalheatequation_torch.ops.unstructured import UnstructuredNonlocalOp

    rng = np.random.default_rng(23)
    clouds = [(np.stack([np.linspace(0, 1, 300), np.zeros(300)], 1), 1e-6, 1.0, {}),
              (rng.uniform(size=(1000, 2)), 0.08, 1e-3, {}),
              (rng.uniform(size=(1000, 2)), 0.08, 1e-3, {"wmax": 128})]
    for pts, eps, vol, kw in clouds:
        op = UnstructuredNonlocalOp(pts, eps, k=1.0, dt=1e-6, vol=vol, device=card)
        ex = op.windowed_plan(**kw).for_dtype(dtype, card)
        packed = (ex.rowptr, ex.cols, ex.vals, ex.s128)
        full = torch.tensor(rng.standard_normal(op.n + 1), device=card, dtype=dtype)
        for u in (full[:-1], full[1:]):  # aligned, then off by one value
            a = cu.windowed_matvec(*packed, u, ex.we)
            b = cu.windowed_matvec_plain(*packed, u, ex.we)
            scale = max(float(b.abs().max()), 1.0)
            assert float((a - b).abs().max()) / scale <= tol
            assert torch.equal(a, cu.windowed_matvec(*packed, u, ex.we))
    tgt = np.array([0, 0, 1, 1, 1], np.int32)
    src = np.array([1, 1, 0, 1, 1], np.int32)
    plan = tw.build_plan(np.array([[0.0, 0.0], [0.1, 0.0]]), np.array([0.2, 0.2]), tgt, src,
                         np.array([1.0, 2.0, 3.0, 4.0, 0.5]), np.ones(2), np.zeros(2))
    ex = plan.for_dtype(dtype, card)
    u = torch.tensor([0.5, -2.0], device=card, dtype=dtype)
    got = cu.windowed_matvec(ex.rowptr, ex.cols, ex.vals, ex.s128, u, ex.we)
    assert got.cpu().tolist() == [3.0 * -2.0, 3.0 * 0.5 + 4.5 * -2.0]


@pytest.mark.cuda
def test_windowed_solver_holds_the_contract_on_card(card):
    from nonlocalheatequation_torch.ops.unstructured import (
        UnstructuredNonlocalOp,
        UnstructuredSolver,
    )

    pts, eps, vol = _cloud(24, seed=2)
    op = UnstructuredNonlocalOp(pts, eps, k=1.0, dt=1e-6, vol=vol, device=card)
    for dtype in (torch.float64, torch.float32):
        ck.reset_launch_counts()
        s = UnstructuredSolver(op, nt=25, layout="windowed", dtype=dtype)
        s.test_init()
        s.do_work()
        assert s.error_l2 / op.n <= 1e-6
        assert ck.launch_counts()["windowed_matvec"] == 25


@pytest.mark.cuda
def test_mesh_bucket_lanes_bitwise_solo_on_card(card, tmp_path, monkeypatch):
    from nonlocalheatequation_torch.ops.gather import make_gather_multi_step_fn
    from nonlocalheatequation_torch.serve.meshes import MeshStore

    pts, eps, vol = _cloud(30, seed=5)
    root = str(tmp_path / "meshes")
    mhash = MeshStore(root).put(pts, eps, vol)
    monkeypatch.setenv("NLHEAT_MESH_DIR", root)
    physics = [(1.0, 1e-6), (0.5, 2e-6), (2.0, 5e-7), (1.5, 1e-6)] * 2
    cases = [EnsembleCase(shape=(len(pts),), nt=7, eps=0, k=k, dt=dt, dh=0.0, test=True,
                          mesh=mhash) for k, dt in physics]
    engine = EnsembleEngine(device=card, dtype=torch.float32)
    res = engine.run(cases)
    assert (engine.report.buckets, engine.report.programs_built,
            engine.report.dispatches) == (1, 1, 1)
    assert {n: v for n, v in ck.launch_counts().items() if v} == {"gather_L": 8 * 7}
    for case, got in zip(cases, res, strict=True):
        op = engine._make_op(case)
        solo = make_gather_multi_step_fn(op, 7, dtype=torch.float32, test=True)(
            torch.as_tensor(op.spatial_profile(), device=card), 0)
        assert np.array_equal(got, solo.cpu().numpy())


# -- the halo kernels and the distributed solves ----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_split_kernels_match_plain_and_the_one_pass_sum_on_card(card, dtype, tol):
    from nonlocalheatequation_torch.ops import cuda_halo as th

    # a normal block, a degenerate one (a side <= 2*eps) and a multi-hop-sized one
    for (bx, by), eps, launches in [((70, 45), 5, 2), ((8, 40), 4, 1), ((8, 8), 9, 1)]:
        for prec in ("f32", "bf16"):
            frame = torch.randn(bx + 2 * eps, by + 2 * eps, dtype=dtype, device=card)
            ck.reset_launch_counts()
            a = th.split_nsum2d(frame, eps, prec)
            assert ck.launch_counts()["split_nsum2d"] == launches
            b = th.split_nsum2d_plain(frame, eps, prec)
            assert float((a - b).abs().max() / b.abs().max()) <= tol
            assert torch.equal(a, ck.nsum2d(frame, eps, prec))
    for (bx, by, bz), eps, launches in [((20, 12, 40), 3, 2), ((4, 4, 4), 2, 1),
                                        ((4, 4, 4), 5, 1)]:
        for prec in ("f32", "bf16"):
            frame = torch.randn(bx + 2 * eps, by + 2 * eps, bz + 2 * eps, dtype=dtype,
                                device=card)
            ck.reset_launch_counts()
            a = th.split_nsum3d(frame, eps, prec)
            assert ck.launch_counts()["split_nsum3d"] == launches
            b = th.split_nsum3d_plain(frame, eps, prec)
            assert float((a - b).abs().max() / b.abs().max()) <= tol
            assert torch.equal(a, k3.nsum3d(frame, eps, prec))
    with pytest.raises(ValueError, match="beyond what the kernel takes"):
        th.split_nsum2d(torch.zeros(200, 200, dtype=dtype, device=card), 70)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_in_kernel_exchange_matches_plain_and_the_one_pass_sum_on_card(card, dtype, tol):
    from nonlocalheatequation_torch.ops import cuda_halo as th
    from nonlocalheatequation_torch.parallel import halo as thalo
    from nonlocalheatequation_torch.parallel import mesh as tmesh

    # every block of meshes of virtual devices: normal, degenerate, multi-hop
    for mesh_shape, block, eps in [((2, 2), (70, 45), 5), ((2, 2), (8, 40), 4),
                                   ((4, 2), (8, 8), 9), ((2, 2, 2), (20, 12, 40), 3),
                                   ((2, 2, 2), (4, 4, 4), 2), ((2, 2, 2), (4, 4, 4), 5)]:
        d = len(mesh_shape)
        mesh = tmesh.create_mesh(("x", "y", "z")[:d], mesh_shape,
                                 tmesh.device_list(card, int(np.prod(mesh_shape))))
        u = torch.randn([m * b for m, b in zip(mesh_shape, block)], dtype=dtype)
        blocks = tmesh.put_global(u, mesh, dtype)
        frames = thalo.halo_pad_nd(blocks, eps)
        fused = th.fused_nsum2d if d == 2 else th.fused_nsum3d
        one_pass = ck.nsum2d if d == 2 else k3.nsum3d
        for prec in ("f32", "bf16"):
            for pos in np.ndindex(*mesh_shape):
                ck.reset_launch_counts()
                a = fused(blocks, pos, eps, prec)
                assert ck.launch_counts()[f"fused_nsum{d}d"] == 1
                b = th.fused_nsum_plain(blocks, pos, eps, prec)
                assert float((a - b).abs().max() / b.abs().max()) <= tol
                assert torch.equal(a, one_pass(frames[pos], eps, prec))
    big = tmesh.put_global(torch.zeros(400, 400), tmesh.make_mesh(2, 2, tmesh.device_list(
        card, 4)), dtype)
    with pytest.raises(ValueError, match="beyond what the kernel takes"):
        th.fused_nsum2d(big, (0, 0), 70)


@pytest.mark.cuda
def test_distributed_solves_fused_bitwise_collective_on_card(card, monkeypatch):
    from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
    from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
    from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh, make_mesh_3d

    devs = device_list(card, 8)  # virtual devices of the one card
    u0 = np.random.default_rng(2).standard_normal((64, 48))
    kw = dict(nt=5, eps=5, k=1.0, dt=1e-5, dh=1.0 / 64, method="cuda", dtype=torch.float32,
              mesh=make_mesh(2, 2, devs))
    runs = {}
    # the card's fused path reads the halo inside the kernel; the split
    # kernels' transport (band copies, interior then ring) on request
    for comm, transport in (("fused", ""), ("fused", "interp"), ("collective", "")):
        monkeypatch.setenv("NLHEAT_FUSED_TRANSPORT", transport)
        ck.reset_launch_counts()
        s = Solver2DDistributed(32, 24, 2, 2, comm=comm, **kw)
        s.input_init(u0)
        runs[f"{comm} {transport}".strip()] = (s.do_work(), ck.launch_counts())
    monkeypatch.delenv("NLHEAT_FUSED_TRANSPORT")
    assert np.array_equal(runs["fused"][0], runs["collective"][0])
    assert np.array_equal(runs["fused interp"][0], runs["collective"][0])
    assert runs["fused"][1]["fused_nsum2d"] == 4 * 5
    assert runs["fused"][1]["split_nsum2d"] == 0
    assert runs["fused interp"][1]["split_nsum2d"] == 2 * 4 * 5
    assert runs["collective"][1]["nsum2d"] == 4 * 5
    solo = Solver2D(64, 48, 5, 5, k=1.0, dt=1e-5, dh=1.0 / 64, method="cuda",
                    dtype=torch.float32, device=card)
    solo.input_init(u0)
    ref = solo.do_work()
    assert np.abs(runs["fused"][0] - ref).max() <= 1e-5 * np.abs(ref).max()
    kw3 = dict(nt=3, eps=2, k=1.0, dt=1e-4, dh=0.05, method="cuda", dtype=torch.float64,
               mesh=make_mesh_3d(2, 2, 2, devs))
    f = Solver3DDistributed(16, 16, 24, comm="fused", **kw3)
    c = Solver3DDistributed(16, 16, 24, **kw3)
    for s in (f, c):
        s.test_init()
    ck.reset_launch_counts()
    assert np.array_equal(f.do_work(), c.do_work())
    assert ck.launch_counts()["fused_nsum3d"] == 3 * 8
    assert f.error_l2 / (16 * 16 * 24) <= 1e-6


@pytest.mark.cuda
def test_in_kernel_exchange_across_cards_on_card(card):
    # blocks on different cards: the kernel reads its neighbours' blocks by
    # peer access, the streams of the cards meet before and after the reads
    from nonlocalheatequation_torch.ops import cuda_halo as th
    from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
    from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
    from nonlocalheatequation_torch.parallel.mesh import make_mesh, make_mesh_3d

    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more cards")
    cards = [torch.device("cuda", i) for i in range(n)]
    shape = (2, n // 2)
    if th.fused_transport(cards) != "peer":
        pytest.skip("these cards cannot read each other's memory")
    u0 = np.random.default_rng(7).standard_normal((256, 128 * shape[1]))
    kw = dict(nt=6, eps=8, k=1.0, dt=1e-6, dh=1.0 / 256, method="cuda", dtype=torch.float32,
              mesh=make_mesh(*shape, cards))
    runs = {}
    for comm in ("fused", "collective"):
        ck.reset_launch_counts()
        s = Solver2DDistributed(128, 128, *shape, comm=comm, **kw)
        s.input_init(u0)
        runs[comm] = (s.do_work(), ck.launch_counts())
    assert np.array_equal(runs["fused"][0], runs["collective"][0])
    assert runs["fused"][1]["fused_nsum2d"] == 6 * shape[0] * shape[1]
    kw3 = dict(nt=3, eps=3, k=1.0, dt=1e-4, dh=0.05, method="cuda", dtype=torch.float64,
               mesh=make_mesh_3d(*shape, 1, cards))
    f = Solver3DDistributed(16, 8 * shape[1], 12, comm="fused", **kw3)
    c = Solver3DDistributed(16, 8 * shape[1], 12, **kw3)
    for s in (f, c):
        s.test_init()
    assert np.array_equal(f.do_work(), c.do_work())
