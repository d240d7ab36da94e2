"""The port's tests that need the card: every kernel against its plain
version and the multi-step kernels bitwise against step2d (step3d)
launches, the resident kernels' gates, and the tuner as the default
production path, in 2D and 3D.

Each test carries the ``cuda`` marker and skips inside the test when
``torch.cuda.is_available()`` is false.  The file imports torch, numpy and
the port only, so it also runs where JAX is not installed; tests/conftest.py
imports JAX, so on such a machine run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

The CPU tests hold the plain versions against the JAX package
(tests/test_torch_kernels.py, test_torch_multistep.py, test_torch_autotune.py,
test_torch_kernels3d.py, test_torch_3d.py).
"""

import numpy as np
import pytest
import torch

from nonlocalheatequation_torch.models.solver2d import Solver2D
from nonlocalheatequation_torch.models.solver3d import Solver3D
from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
from nonlocalheatequation_torch.ops.nonlocal_op import (
    NonlocalOp2D,
    NonlocalOp3D,
    case_scale,
    make_multi_step_fn,
    make_multi_step_fn_base,
)
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
