"""The port's tests that need the card: every kernel against its plain
version and the multi-step kernels bitwise against step2d (step3d)
launches, the resident kernels' gates, and the tuner as the default
production path, in 2D and 3D.  step3d/nsum3d (their register design and
the tile body) are held bitwise to their plain versions and to carried3d,
and superstep2d bitwise to K step2d launches, over eps, ragged shapes and
every tier.

Each test carries the ``cuda`` marker and skips inside the test when
``torch.cuda.is_available()`` is false.  The file imports torch, numpy and
the port only, so it also runs where JAX is not installed; tests/conftest.py
imports JAX, so on such a machine run it without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py -q

The batched kernels (ops/cuda_batched.py) are held per lane, bitwise, to the
solo kernels (``batched_step2d`` and ``batched_superstep2d`` also bitwise to
their plain versions, in their register designs and their tile bodies), and
the ensemble engine runs a
mixed-physics bucket in one ``batched_step2d`` launch per step.  The
unstructured kernels (ops/cuda_unstructured.py) are held to their plain
versions (the packed windowed matvec also on empty rows, ragged n,
duplicate edges and an unaligned state), a windowed solve to the
manufactured contract, and an 8-lane mesh bucket's lanes bitwise to their
solo gather loops.  The halo kernels (ops/cuda_halo.py:
the in-kernel exchange and the split kernels) are held to their plain
versions and bitwise to the one-pass nsum2d/nsum3d on the exchanged frame
(fused_nsum2d in its register design and its tile body), and the
distributed solves' fused path (both transports) bitwise to their
collective path on meshes of virtual devices of the one card.  An rkc
solve (models/steppers.py) launches one nsum2d/nsum3d a stage and is
bitwise the same solve through their plain versions; fft
(ops/spectral.py) meets the kernels' neighbour sums; expo meets the
manufactured contract and launches no kernel.  Distributed rkc
(parallel/stepper_halo.py) per stage, over every transport, is the
single-device rkc solve bitwise with exact launch counts; the sharded fft
solves (parallel/spectral_halo.py) meet the single-device fft solves in
float64; the sharded unstructured operator's halo forms are bitwise each
other and its one-device form, and its offsets form and superstep the
single-device offsets solve.  With a card a rank, the multi-process legs
(tests/torch_multihost_child.py) run in an nccl group, each bitwise the
rank's one-card solve.  The serving pipeline (serve/server.py) serves
lanes bitwise the offline engine run, dispatches two chunks with no fence
between them (explicit or implicit: the staged copy goes through page-locked
memory), and cycles its breaker through the CPU fallback and back.

The CPU tests hold the plain versions against the JAX package
(tests/test_torch_kernels.py, test_torch_multistep.py, test_torch_autotune.py,
test_torch_kernels3d.py, test_torch_3d.py, test_torch_batched_kernels.py,
test_torch_ensemble.py, test_torch_unstructured.py, test_torch_windowed.py,
test_torch_gather.py, test_torch_halo.py, test_torch_distributed.py,
test_torch_steppers.py, test_torch_spectral.py, test_torch_distributed_rkc.py,
test_torch_spectral_sharded.py, test_torch_unstructured_sharded.py,
test_torch_serve.py, test_torch_serve_faults.py).
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
from nonlocalheatequation_torch.ops.stencil import horizon_mask_3d
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_torch.utils import autotune


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device: the kernels have no CPU mode")
    # the default production path, with tuning records kept in the process
    monkeypatch.delenv("NLHEAT_TUNE_PRECISION", raising=False)
    monkeypatch.delenv("NLHEAT_TUNE_METHOD", raising=False)
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
    # csrc/nsum2d.cu's register walk up to eps 16 (16-byte staging at (1100,
    # 700) and (1100, 736), whose padded rows and windows are 16-byte
    # aligned; a value a copy at (1100, 701) and from an unaligned base), the
    # tile body at eps 17 and, in float32, on a 512^2 plane (fewer tiles than
    # SMs): bitwise the plain version, which sums in the tile body's order
    walk = [(1100, 700, 8), (1100, 736, 16), (1100, 701, 8), (70, 45, 17), (512, 512, 8)]
    for nx, ny, eps in walk:
        upad = torch.randn(nx + 2 * eps, ny + 2 * eps, dtype=dtype, device=card)
        for prec in ("f32", "bf16"):
            a, b = ck.nsum2d(upad, eps, prec), ck.nsum2d_plain(upad, eps, prec)
            assert float((a - b).abs().max() / b.abs().max()) <= tol
            assert torch.equal(a, b), (nx, ny, eps, prec)
    unaligned = torch.randn(1116 * 716 + 1, dtype=dtype, device=card)[1:].view(1116, 716)
    assert torch.equal(ck.nsum2d(unaligned, 8), ck.nsum2d_plain(unaligned, 8))
    n = 8 + 2 * len(walk) + 1
    assert {k: ck.launch_counts()[k] for k in ("nsum2d", "step2d")} == {"nsum2d": n, "step2d": 8}
    with pytest.raises(ValueError, match="beyond what the kernel takes"):
        ck.nsum2d(torch.zeros(200, 200, dtype=dtype, device=card), 70)
    assert {k: ck.launch_counts()[k] for k in ("nsum2d", "step2d")} == {"nsum2d": n, "step2d": 8}


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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_solo_step_kernels_bitwise_plain_on_card(card, dtype, prec):
    # step2d and carried2d are one batched_step2d / batched_carried2d launch
    # at B=1: the register walk (up to eps 16; 1100 x 700 has more tiles
    # than the card has SMs), the tile body (eps 17, 40, and in float32 a
    # lattice below the SM count: 512^2 and the small shapes), ragged
    # shapes, both forms, carried2d into a NaN-filled out; counted under
    # their own names
    rng = np.random.default_rng(31)
    for eps in (0, 1, 3, 8, 16, 17, 40):
        wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(eps)))
        scale, dt = 2.0 + eps, 0.8 / ((2.0 + eps) * wsum)
        for nx, ny in ((1, 1), (37, 50), (130, 45), (512, 512), (1100, 700)):
            form = (eps, nx, ny)
            u = torch.tensor(rng.standard_normal((nx, ny)), dtype=dtype, device=card)
            g, lg = torch.randn_like(u), torch.randn_like(u)
            ck.reset_launch_counts()
            got = ck.step2d(u, eps, scale, wsum, dt, precision=prec)
            test = ck.step2d(u, eps, scale, wsum, dt, g=g, lg=lg, t=300, precision=prec)
            frame = torch.nn.functional.pad(u, (eps,) * 4).contiguous()
            carried = ck.carried2d(frame, eps, scale, wsum, dt, prec,
                                   out=torch.full_like(frame, float("nan")))
            assert {k: v for k, v in ck.launch_counts().items() if v} == {
                "step2d": 2, "carried2d": 1}, form
            assert torch.equal(got, ck.step2d_plain(u, eps, scale, wsum, dt,
                                                    precision=prec)), form
            assert torch.equal(test, ck.step2d_plain(u, eps, scale, wsum, dt, g=g, lg=lg, t=300,
                                                     precision=prec)), form
            want = ck.carried2d_plain(frame, eps, scale, wsum, dt,
                                      ck.shadow_of(frame) if prec == "bf16" else None)
            assert torch.equal(carried, want[0] if prec == "bf16" else want), form
            assert torch.equal(carried[eps:eps + nx, eps:eps + ny], got), form
    z = torch.zeros(200, 200, dtype=dtype, device=card)
    with pytest.raises(ValueError, match="^step2d: eps=70 .*batched_step2d.cu"):
        ck.step2d(z, 70, 1.0, 1.0, 1e-3)
    with pytest.raises(ValueError, match="^carried2d: eps=70 .*batched_carried2d.cu"):
        ck.carried2d(torch.nn.functional.pad(z, (70,) * 4), 70, 1.0, 1.0, 1e-3)


@pytest.mark.cuda
def test_per_step_loop_copies_no_table_a_step_on_card(card, monkeypatch):
    # the per-step loop's step2d launches read cached device tables: one
    # (scale, dt) row, and in the test form one coefficient table per
    # COEF_ROWS steps, so no step copies from the host
    monkeypatch.setattr(ck, "_TABLES", type(ck._TABLES)())
    top = _op(64, 3)
    u = _state(64, card, torch.float32, 5)
    g, lg = top.source_parts(64, 64)
    make_multi_step_fn_base(top, 300)(u, 0)
    assert len(ck._TABLES) == 1
    make_multi_step_fn_base(top, 300, g, lg)(u, 0)
    assert len(ck._TABLES) == 1 + -(-300 // ck.COEF_ROWS)
    assert ck.launch_counts()["step2d"] == 600


@pytest.mark.cuda
def test_resident_refuses_a_large_grid_on_card(card):
    assert not ck.fits_resident(4096, 4096, 8, torch.float32, card)
    with pytest.raises(ValueError, match="resident kernel"):
        ck.make_resident_multi_step_fn(_op(4096, 8), 2)(torch.zeros(4096, 4096, device=card), 0)
    assert ck.launch_counts()["resident2d"] == 0


def _held_to_steps(run, step, u, steps=(1, 2, 7, 64)):
    """run(u, n) against n launches of step, bitwise, for each n of steps (a
    long odd run shows a stale read of either frame)."""
    ref, done = u, 0
    for n in steps:
        for _ in range(n - done):
            ref = step(ref)
        done = n
        assert torch.equal(run(u, n), ref), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_resident2d_bitwise_step2d_launches_on_card(card, dtype):
    # the register design at eps 5 and 7 (a window line padded to 16 bytes
    # in float32) and 8, a row padded to 16 bytes (ny = 250), the tile body
    # (eps 17), and two grids on the two sides of csrc/resident2d.cu's RUN
    # rule on a 132-SM card: float32 RUN 32 at 768 x 704 (6 x 22 tiles), 16 at
    # 768 x 672; float64 RUN 16 at 384 x 704 (6 x 22 tiles), 8 at 256 x 256
    sides = {torch.float32: [(768, 704), (768, 672)],
             torch.float64: [(384, 704), (256, 256)]}[dtype]
    for (nx, ny), eps in [((70, 90), 5), ((45, 250), 7), ((64, 64), 8), ((40, 45), 17),
                          (sides[0], 8), (sides[1], 8)]:
        top = _op(max(nx, ny), eps)
        _e, scale, wsum, dt = ck._production_args(top)
        u = torch.from_numpy(np.random.default_rng(nx + ny + eps).standard_normal((nx, ny))).to(
            device=card, dtype=dtype)
        _held_to_steps(lambda v, n: ck.resident2d(v, eps, scale, wsum, dt, n),
                       lambda v: ck.step2d(v, eps, scale, wsum, dt), u)


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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_step3d_bitwise_plain_and_carried3d_on_card(card, dtype, prec):
    # the register design (eps <= 6) and the tile body (eps 7-12) of
    # csrc/nsum3d.cu alike: nsum3d and step3d (both forms) bitwise their
    # sphere_sum plain versions, and (no bf16 tier there) one carried3d
    # launch; ragged shapes (the register design's tiles are 8 x 8 x 32 in
    # f32), 16-byte staging (nz = 40 at even eps) and one cell at a time,
    # heights without columns (eps=5), narrower tiles (f64)
    for eps in range(13):
        wsum = float(horizon_mask_3d(eps).sum())
        scale, dt = 2.0 + eps, 0.8 / ((2.0 + eps) * wsum)
        for shape in ((1, 1, 1), (9, 17, 33), (20, 11, 6), (13, 5, 70), (7, 10, 40)):
            u = _state3(shape, card, dtype, eps + sum(shape))
            upad = torch.nn.functional.pad(u, (eps,) * 6)
            form = (eps, shape, prec)
            if not k3.tile3d(eps, dtype, card):  # beyond the tile body's shared memory
                with pytest.raises(ValueError, match="beyond what the kernel takes"):
                    k3.step3d(u, eps, scale, wsum, dt, precision=prec)
                continue
            g, lg = torch.randn_like(u), torch.randn_like(u)
            assert torch.equal(k3.nsum3d(upad, eps, prec), k3.nsum3d_plain(upad, eps, prec)), form
            for kw in ({}, {"g": g, "lg": lg, "t": 5}):
                got = k3.step3d(u, eps, scale, wsum, dt, precision=prec, **kw)
                assert torch.equal(got, k3.step3d_plain(u, eps, scale, wsum, dt,
                                                        precision=prec, **kw)), (form, kw)
            if prec == "f32":
                nxt = k3.carried3d(upad.contiguous(), eps, scale, wsum, dt)
                inner = nxt[eps:eps + shape[0], eps:eps + shape[1], eps:eps + shape[2]]
                assert torch.equal(inner, k3.step3d(u, eps, scale, wsum, dt)), form
                assert torch.equal(nxt, k3.carried3d_plain(upad, eps, scale, wsum, dt)), form


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_carried3d_runs_bitwise_step3d_launches_on_card(card, dtype):
    # the register design (eps <= 6) and the tile body (eps 7) of
    # csrc/carried3d.cu: N launches through the multi-step maker (two frames
    # whose halos stay zero) bitwise N step3d launches, and one launch
    # bitwise carried3d_plain, halo included; frame z 41 and 9 + 2eps (one
    # cell a copy) and 40 + 2eps (16 bytes a copy in f32 at even eps)
    for eps in range(8):
        wsum = float(horizon_mask_3d(eps).sum())
        scale, dt = 2.0 + eps, 0.8 / ((2.0 + eps) * wsum)
        for shape in ((9, 17, 33), (5, 7, 9), (7, 10, 40)):
            u = _state3(shape, card, dtype, eps + sum(shape))
            frame = torch.nn.functional.pad(u, (eps,) * 6)
            assert torch.equal(k3.carried3d(frame, eps, scale, wsum, dt),
                               k3.carried3d_plain(frame, eps, scale, wsum, dt)), (eps, shape)
            if eps == 0:  # no operator has a horizon of 0: the wrappers alone
                nxt, spare, ref = frame, None, u
                for _ in range(3):
                    nxt, spare = k3.carried3d(nxt, eps, scale, wsum, dt, out=spare), nxt
                    ref = k3.step3d(ref, eps, scale, wsum, dt)
                assert torch.equal(nxt, torch.nn.functional.pad(ref, (0,) * 6)), shape
                continue
            top = _op3(max(shape), eps)
            for steps in (1, 3):
                ck.reset_launch_counts()
                want = make_multi_step_fn_base(top, steps)(u, 0)
                got = k3.make_carried_multi_step_fn_3d(top, steps)(u, 0)
                assert torch.equal(got, want), (eps, shape, steps)
                assert {k: v for k, v in ck.launch_counts().items() if v} == {
                    "step3d": steps, "carried3d": steps}


@pytest.mark.cuda
def test_resident3d_refuses_a_large_grid_on_card(card):
    assert k3.fits_resident_3d(128, 128, 128, 6, torch.float32, card)
    assert not k3.fits_resident_3d(256, 256, 256, 4, torch.float32, card)
    with pytest.raises(ValueError, match="resident 3D kernel"):
        k3.make_resident_multi_step_fn_3d(_op3(256, 4), 2)(
            torch.zeros(256, 256, 256, device=card), 0)
    assert ck.launch_counts()["resident3d"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_resident3d_bitwise_step3d_launches_on_card(card, dtype):
    # the register design at eps 5 (a window line padded to 16 bytes in
    # float32) with a frame z of 50 (padded to 16 bytes in float32) and of
    # 52, at eps 6 and 1, and the tile body at eps 7
    for shape, eps in [((9, 10, 40), 5), ((11, 9, 42), 5), ((17, 9, 33), 6), ((8, 5, 3), 1),
                       ((10, 9, 42), 7)]:
        _e, scale, wsum, dt = k3._production_args(_op3(max(shape), eps))
        u = _state3(shape, card, dtype, sum(shape) + eps)
        _held_to_steps(lambda v, n: k3.resident3d(v, eps, scale, wsum, dt, n),
                       lambda v: k3.step3d(v, eps, scale, wsum, dt), u)


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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_superstep2d_bitwise_step2d_launches_on_card(card, dtype, prec):
    # the register design (eps <= 8) and the tile body (16, 17, 33) of
    # csrc/superstep2d.cu alike: K = 1-4 levels bitwise K step2d launches and
    # superstep2d_plain; ragged planes (f32 items 32 x 32, f64 16 x 32; a
    # band's last item shifted back), every tier; a K the gate refuses raises
    rng = np.random.default_rng(29)
    for eps in (0, 1, 3, 8, 16, 17, 33):
        wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(eps)))
        scale, dt = 2.0 + eps, 0.8 / ((2.0 + eps) * wsum)
        for nx, ny in ((1, 1), (37, 50), (70, 90), (130, 45)):
            u = torch.tensor(rng.standard_normal((nx, ny)), dtype=dtype, device=card)
            steps = [u]
            for _ in range(4):
                steps.append(ck.step2d(steps[-1], eps, scale, wsum, dt, precision=prec))
            for k in (1, 2, 3, 4):
                form = (eps, nx, ny, k)
                if not ck.fits_superstep(nx, ny, eps, k, dtype, prec, card):
                    with pytest.raises(ValueError, match="beyond what the kernel takes"):
                        ck.superstep2d(u, eps, scale, wsum, dt, k, prec)
                    continue
                got = ck.superstep2d(u, eps, scale, wsum, dt, k, prec)
                assert torch.equal(got, steps[k]), form
                assert torch.equal(got, ck.superstep2d_plain(u, eps, scale, wsum, dt, k,
                                                             prec)), form


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
               "carried": cb.batched_carried2d(frames, eps, params, wsum, precision=prec)}
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
        if prec == "bf16":  # the plain version carries the pair
            plain["carried"] = plain["carried"][0]
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
                                precision=prec)
            assert torch.equal(got["carried"][b], solo)
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
            carried = cb.batched_carried2d(frames, eps, params, wsum, precision=prec)
            assert torch.equal(carried[:, eps:eps + nx, eps:eps + ny], step), form
            if cb.fits_batched_superstep(eps, 1, dtype, prec, card):
                assert torch.equal(cb.batched_superstep2d(U, eps, params, wsum, 1, prec),
                                   step), form


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,prec", [(torch.float64, "f32"), (torch.float32, "f32"),
                                        (torch.float64, "bf16"), (torch.float32, "bf16")])
def test_batched_carried2d_bitwise_plain_and_step_lanes_on_card(card, dtype, prec):
    # the register design (eps <= 16) and the tile body (eps 17, 40) of
    # csrc/batched_carried2d.cu: one launch bitwise batched_carried2d_plain
    # (which carries the (master, shadow) pair in the bf16 tier;
    # batched_carried2d keeps the masters and rounds them as it stages them,
    # the same only if the plain next shadow is the rounding of its next
    # master) and, lane by lane, one carried2d launch; three launches
    # through the multi-step maker (two stacks whose halos stay zero) lane
    # by lane bitwise three batched_step2d launches; ragged planes, uniform
    # and mixed physics
    rng = np.random.default_rng(23)
    for eps in (0, 3, 8, 16, 17, 40):
        wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(eps)))
        for batch, (nx, ny), mixed in ((1, (37, 50), False), (3, (130, 45), True),
                                       (8, (70, 33), True), (2, (20, 90), False)):
            scales = [2.0 + eps + (b if mixed else 0) for b in range(batch)]
            dts = [0.8 / (sc * wsum) * (1 + (0.1 * b if mixed else 0))
                   for b, sc in enumerate(scales)]
            params = cb.case_params(scales, dts, dtype, card)
            U = torch.tensor(rng.standard_normal((batch, nx, ny)), dtype=dtype, device=card)
            frames = torch.nn.functional.pad(U, (eps,) * 4).contiguous()
            shadow = ck.shadow_of(frames) if prec == "bf16" else None
            form = (eps, batch, nx, ny, mixed)
            got = cb.batched_carried2d(frames, eps, params, wsum, precision=prec)
            want = cb.batched_carried2d_plain(frames, eps, params, wsum, shadow)
            assert torch.equal(got, want if shadow is None else want[0]), form
            if shadow is not None:
                assert torch.equal(want[1], ck.shadow_of(want[0])), form
            for b in range(batch):
                solo = ck.carried2d(frames[b].contiguous(), eps, scales[b], wsum, dts[b],
                                    precision=prec)
                assert torch.equal(solo, got[b]), (form, b)
            if eps == 0:  # no operator has a horizon of 0
                continue
            ops = [_op(64, eps, prec)] * batch if not mixed else [
                NonlocalOp2D(eps, 1.0 + 0.5 * b, _op(64, eps).dt / (1.0 + b), 1 / 64,
                             method="cuda", precision=prec) for b in range(batch)]
            ck.reset_launch_counts()
            runs = cb.make_batched_carried_multi_step_fn(ops, 3)(U, 0)
            steps = cb.make_batched_cuda_multi_step_fn(ops, 3)(U, 0)
            assert {k: v for k, v in ck.launch_counts().items() if v} == {
                "batched_carried2d": 3, "batched_step2d": 3}
            for b in range(batch):
                assert torch.equal(runs[b], steps[b]), (form, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_carried_wrappers_zero_the_halo_of_a_given_out_on_card(card, dtype):
    # the carried kernels write the interior only; a caller's ``out`` full of
    # NaN must come back with a zero halo, the same frame as without ``out``,
    # in both designs of each kernel
    for eps in (3, 7):
        wsum = float(horizon_mask_3d(eps).sum())
        frame = torch.nn.functional.pad(_state3((9, 17, 33), card, dtype, eps), (eps,) * 6)
        out = torch.full_like(frame, float("nan"))
        got = k3.carried3d(frame, eps, 2.0, wsum, 1e-3, out=out)
        assert got is out and torch.equal(got, k3.carried3d(frame, eps, 2.0, wsum, 1e-3)), eps
    for eps, prec in ((3, "f32"), (3, "bf16"), (17, "f32"), (17, "bf16")):
        wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(eps)))
        params = cb.case_params([2.0, 3.0], [1e-3, 2e-3], dtype, card)
        U = torch.tensor(np.random.default_rng(eps).standard_normal((2, 37, 50)), dtype=dtype,
                         device=card)
        frames = torch.nn.functional.pad(U, (eps,) * 4).contiguous()
        out = torch.full_like(frames, float("nan"))
        got = cb.batched_carried2d(frames, eps, params, wsum, precision=prec, out=out)
        assert got is out and torch.equal(
            got, cb.batched_carried2d(frames, eps, params, wsum, precision=prec)), (eps, prec)
        out = torch.full_like(frames[0], float("nan"))  # carried2d: one launch at B=1
        got = ck.carried2d(frames[0], eps, 2.0, wsum, 1e-3, prec, out=out)
        assert got is out and torch.equal(
            got, ck.carried2d(frames[0], eps, 2.0, wsum, 1e-3, prec)), (eps, prec)


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

    # a normal block, a degenerate one (a side <= 2*eps) and a multi-hop-sized
    # one; csrc/split_nsum2d.cu's register walk with 16-byte staging at eps 8
    # and 16 ((1100, 700), (1100, 736), (1024, 1024): phases on the walk's
    # lattice), a value a copy where the padded row is not 16-byte aligned
    # ((1100, 701)) or the base is not; a block whose rows hold no lattice
    # tile inside [eps, bx-eps) ((100, 4300): the interior falls back to
    # it); the tile body on blocks whose lattice has fewer tiles than SMs
    # ((300, 200), (512, 512)) and at eps 17
    for (bx, by), eps, launches in [((70, 45), 5, 2), ((8, 40), 4, 1), ((8, 8), 9, 1),
                                    ((1100, 700), 8, 2), ((1100, 736), 16, 2),
                                    ((1100, 701), 8, 2), ((100, 4300), 8, 2),
                                    ((1024, 1024), 8, 2), ((300, 200), 8, 2), ((512, 512), 8, 2),
                                    ((70, 45), 17, 2), ((300, 200), 17, 2)]:
        for prec in ("f32", "bf16"):
            for base in (0, 1):
                shape = (bx + 2 * eps, by + 2 * eps)
                frame = torch.randn(shape[0] * shape[1] + base, dtype=dtype,
                                    device=card)[base:].view(shape)
                ck.reset_launch_counts()
                a = th.split_nsum2d(frame, eps, prec)
                assert ck.launch_counts()["split_nsum2d"] == launches
                b = th.split_nsum2d_plain(frame, eps, prec)
                assert float((a - b).abs().max() / b.abs().max()) <= tol
                assert torch.equal(a, ck.nsum2d(frame, eps, prec)), (bx, by, eps, prec, base)
    # the walk's interior reads no halo cell: a frame whose halo is NaN gives
    # the interior's outputs of the real frame
    frame = torch.randn(1116, 716, dtype=dtype, device=card)
    nan_halo = torch.full_like(frame, float("nan"))
    nan_halo[8:-8, 8:-8] = frame[8:-8, 8:-8]
    out = torch.full((1100, 700), float("nan"), dtype=dtype, device=card)
    th.launch_phase("split_nsum2d", nan_halo, out, 8, "f32", "interior")
    inner = ~torch.isnan(out)
    # the lattice tiles: rows [128, 1024) in float32 (128-row tiles), [64,
    # 1088) in float64 (64-row tiles), columns [32, 672)
    assert int(inner.sum()) == (896 if dtype == torch.float32 else 1024) * 640
    assert torch.equal(out[inner], ck.nsum2d(frame, 8)[inner])
    # 3D: csrc/split_nsum3d.cu's register design up to eps 6 (16-byte staging
    # at (16, 16, 64) and (24, 24, 100) eps 4 in float32, the latter with a
    # lattice interior; unaligned bz at eps 3 and 6), its tile body at eps 7;
    # degenerate and multi-hop-sized blocks
    for (bx, by, bz), eps, launches in [((20, 12, 40), 3, 2), ((4, 4, 4), 2, 1),
                                        ((4, 4, 4), 5, 1), ((16, 16, 64), 4, 2),
                                        ((24, 24, 100), 4, 2), ((9, 7, 13), 3, 2),
                                        ((18, 17, 70), 6, 2), ((16, 16, 72), 7, 2)]:
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

    # every block of meshes of virtual devices: normal, degenerate, multi-hop;
    # in 3D csrc/fused_nsum3d.cu's register design up to eps 6 (windows staged
    # from the mesh 16 bytes a copy at (16, 16, 64) and (24, 24, 100) eps 4 in
    # float32, the latter with tiles inside the block; unaligned bz at eps 3
    # and 6; multi-hop in z at (6, 8, 4) eps 6) and its tile body at eps 7
    for mesh_shape, block, eps in [((2, 2), (70, 45), 5), ((2, 2), (8, 40), 4),
                                   ((4, 2), (8, 8), 9), ((2, 2, 2), (20, 12, 40), 3),
                                   ((2, 2, 2), (4, 4, 4), 2), ((2, 2, 2), (4, 4, 4), 5),
                                   ((2, 2, 2), (16, 16, 64), 4), ((2, 2, 2), (24, 24, 100), 4),
                                   ((2, 2, 2), (9, 7, 13), 3), ((2, 2, 2), (18, 17, 70), 6),
                                   ((1, 2, 3), (6, 8, 4), 6), ((2, 2, 2), (16, 16, 72), 7)]:
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_in_kernel_exchange_both_designs_bitwise_the_one_pass_sum_on_card(card, dtype):
    from nonlocalheatequation_torch.ops import cuda_halo as th
    from nonlocalheatequation_torch.parallel import halo as thalo
    from nonlocalheatequation_torch.parallel import mesh as tmesh

    # csrc/fused_nsum2d.cu's register design (eps <= 10: interior windows
    # staged 16 bytes a copy at (300, 200) eps 8 and 10 in float64, rows
    # across two block edges at (40, 12), multi-hop (1, 3) x (5, 7) and
    # degenerate (8, 8) blocks, eps 0) and its tile body (eps 11, 12):
    # every block bitwise nsum2d on its exchanged frame, one launch each
    for mesh_shape, block, eps in [((2, 2), (300, 200), 8), ((2, 2), (300, 200), 10),
                                   ((2, 2), (40, 12), 8), ((2, 2), (24, 24), 10),
                                   ((1, 3), (5, 7), 10), ((4, 2), (8, 8), 9),
                                   ((3, 3), (2, 2), 5), ((2, 3), (150, 70), 0),
                                   ((2, 2), (50, 30), 11), ((1, 3), (5, 7), 12)]:
        mesh = tmesh.create_mesh(("x", "y"), mesh_shape,
                                 tmesh.device_list(card, int(np.prod(mesh_shape))))
        u = np.random.default_rng(eps).standard_normal(
            [m * b for m, b in zip(mesh_shape, block)])
        blocks = tmesh.put_global(u, mesh, dtype)
        frames = thalo.halo_pad_nd(blocks, eps)
        for prec in ("f32", "bf16"):
            for pos in np.ndindex(*mesh_shape):
                ck.reset_launch_counts()
                got = th.fused_nsum2d(blocks, pos, eps, prec)
                assert ck.launch_counts()["fused_nsum2d"] == 1
                assert torch.equal(got, ck.nsum2d(frames[pos], eps, prec)), (
                    mesh_shape, block, eps, prec, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_batched_superstep2d_lanes_bitwise_superstep2d_in_both_designs_on_card(card, dtype,
                                                                               prec):
    # csrc/batched_superstep2d.cu's register design (eps <= 8) and its tile
    # body (9, 16): mixed physics, K = 1-4, ragged planes; every lane bitwise
    # one superstep2d launch of the same K, the stack bitwise the plain version
    rng = np.random.default_rng(31)
    for eps in (0, 1, 3, 5, 8, 9, 16):
        wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(eps)))
        scales = [2.0 + eps + b for b in range(3)]
        dts = [0.8 / (sc * wsum) * (1 + 0.1 * b) for b, sc in enumerate(scales)]
        params = cb.case_params(scales, dts, dtype, card)
        for nx, ny in ((37, 50), (70, 90), (130, 45)):
            U = torch.tensor(rng.standard_normal((3, nx, ny)), dtype=dtype, device=card)
            for k in (1, 2, 3, 4):
                if not cb.fits_batched_superstep(eps, k, dtype, prec, card):
                    continue
                got = cb.batched_superstep2d(U, eps, params, wsum, k, prec)
                form = (eps, nx, ny, k)
                assert torch.equal(got, cb.batched_superstep2d_plain(U, eps, params, wsum, k,
                                                                     prec)), form
                for b in range(3):
                    assert torch.equal(got[b], ck.superstep2d(U[b].contiguous(), eps,
                                                              scales[b], wsum, dts[b], k,
                                                              prec)), (form, b)


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


@pytest.mark.cuda
def test_elastic_solve_bitwise_across_placements_on_card(card):
    # the elastic executor on 2 virtual devices of the card: every tile's
    # frame through nsum2d, bitwise whatever the placement, the schedule
    # (gang stretches, or every step measured through the rectangle walk)
    # and a mid-run migration
    from nonlocalheatequation_torch.parallel.elastic import ElasticSolver2D
    from nonlocalheatequation_torch.parallel.load_balance import WorkTelemetry
    from nonlocalheatequation_torch.parallel.mesh import device_list

    devs = device_list(card, 2)
    imbalanced = np.ones((4, 4), dtype=np.int64)
    imbalanced[0, 0] = 0
    kw = dict(nt=12, eps=4, k=1.0, dt=1e-5, dh=1.0 / 64, method="cuda",
              dtype=torch.float64, devices=devs)
    runs = []
    for extra, measure in ((dict(), False), (dict(assignment=imbalanced), False),
                           (dict(assignment=imbalanced), True),
                           (dict(assignment=imbalanced, nbalance=5,
                                 telemetry=WorkTelemetry(2)), False)):
        ck.reset_launch_counts()
        s = ElasticSolver2D(16, 16, 4, 4, **kw, **extra)
        s.measure = measure
        s.test_init()
        runs.append(s.do_work())
        # one nsum2d a tile a step, and one for the source's L(G)
        assert ck.launch_counts()["nsum2d"] == 12 * 16 + 1
        assert s.error_l2 / 64**2 <= 1e-6
    assert all(np.array_equal(runs[0], r) for r in runs[1:])
    assert not np.array_equal(s.assignment, imbalanced)  # the migration happened


# -- the stepper tier and the spectral method ---------------------------------------------

def _rkc_solver(dim, dtype, steps):
    """A test-form rkc[4] solve on the card through nsum2d/nsum3d, at twice
    the Euler bound (inside rkc[4]'s, about 15 times it; its first-order
    error stays inside the contract on these coarse grids)."""
    from nonlocalheatequation_torch.ops.constants import stable_dt_op

    shape, eps = ((96, 80), 8) if dim == 2 else ((24, 20, 16), 4)
    dh = 1.0 / shape[0]
    cls, op_cls = (Solver2D, NonlocalOp2D) if dim == 2 else (Solver3D, NonlocalOp3D)
    dt = 2.0 * stable_dt_op(op_cls(eps, 1.0, 1.0, dh))
    s = cls(*shape, steps, eps, k=1.0, dt=dt, dh=dh, method="cuda", stepper="rkc", stages=4,
            dtype=dtype)
    s.test_init()
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rkc_solve_launches_the_kernel_bitwise_its_plain_version_on_card(card, monkeypatch,
                                                                          dim, dtype):
    # each stage is one nsum2d/nsum3d launch, and L(G) one more; the same solve
    # through the plain versions on the card is bitwise the same
    kernel, mod = ("nsum2d", ck) if dim == 2 else ("nsum3d", k3)
    s = _rkc_solver(dim, dtype, 3)
    got = s.do_work()
    counts = {k: v for k, v in ck.launch_counts().items() if v}
    assert counts == {kernel: 4 * 3 + 1}
    assert s.error_l2 / got.size <= 1e-6
    monkeypatch.setattr(mod, kernel, getattr(mod, f"{kernel}_plain"))
    plain = _rkc_solver(dim, dtype, 3)
    assert np.array_equal(plain.do_work(), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_fft_neighbour_sum_matches_the_kernels_on_card(card, dtype, tol):
    from nonlocalheatequation_torch.ops import spectral

    gen = np.random.default_rng(17)
    for shape, eps, kernel in (((256, 200), 8, ck.nsum2d), ((48, 40, 36), 4, k3.nsum3d)):
        u = torch.from_numpy(gen.standard_normal(shape)).to(card, dtype)
        cls = NonlocalOp2D if len(shape) == 2 else NonlocalOp3D
        op = cls(eps, 1.0, 1e-5, 1.0 / shape[0], method="fft")
        got = spectral.neighbor_sum_fft(op, u)
        assert got.device.type == "cuda" and got.dtype == dtype
        want = kernel(torch.nn.functional.pad(u, (eps,) * (2 * len(shape))), eps)
        assert float((got - want).abs().max() / want.abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("stages", [0, 1])
def test_expo_gate_on_card(card, stages):
    from nonlocalheatequation_torch.ops.constants import stable_dt_op

    n = 128
    dt = 0.25 * stable_dt_op(NonlocalOp2D(5, 1.0, 1.0, 1.0 / n))
    s = Solver2D(n, n, 45, 5, k=1.0, dt=dt, dh=1.0 / n, method="fft", stepper="expo",
                 stages=stages, dtype=torch.float32)
    s.test_init()
    u = s.do_work()
    assert s.error_l2 / n**2 <= 1e-6
    assert np.isfinite(u).all() and np.abs(u).max() <= np.abs(s.u0).max() * 1.01
    assert not any(ck.launch_counts().values())  # the spectral path launches no kernel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_distributed_rkc_bitwise_the_single_device_rkc_on_card(card, monkeypatch, dtype):
    # per stage, every transport is the single-device rkc solve bitwise: one
    # nsum2d (fused_nsum2d; split_nsum2d a phase) a block a stage, and L(G)
    from nonlocalheatequation_torch.ops.constants import stable_dt_op
    from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
    from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh

    n, eps, steps = 256, 5, 3
    dt = 0.8 * stable_dt_op(NonlocalOp2D(eps, 1.0, 1.0, 1.0 / n), "rkc", 4)
    kw = dict(k=1.0, dt=dt, dh=1.0 / n, method="cuda", dtype=dtype, stepper="rkc", stages=4)
    solo = Solver2D(n, n, steps, eps, device=card, **kw)
    solo.test_init()
    ref = solo.do_work()
    mesh = make_mesh(2, 2, device_list(card, 4))
    for comm, transport, kernel, per in (("collective", "", "nsum2d", 1),
                                         ("fused", "", "fused_nsum2d", 1),
                                         ("fused", "interp", "split_nsum2d", 2)):
        monkeypatch.setenv("NLHEAT_FUSED_TRANSPORT", transport)
        ck.reset_launch_counts()
        s = Solver2DDistributed(n // 2, n // 2, 2, 2, steps, eps, mesh=mesh, comm=comm, **kw)
        s.test_init()
        got = s.do_work()
        counts = {k: v for k, v in ck.launch_counts().items() if v}
        want = {kernel: per * 4 * 4 * steps}
        want["nsum2d"] = want.get("nsum2d", 0) + 1  # L(G) on the first device
        assert counts == want, (comm, transport)
        assert np.array_equal(got, ref), (comm, transport)
    monkeypatch.delenv("NLHEAT_FUSED_TRANSPORT")
    batch = Solver2DDistributed(n // 2, n // 2, 2, 2, steps, eps, mesh=mesh, superstep=2, **kw)
    batch.test_init()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert np.abs(batch.do_work() - ref).max() <= tol * np.abs(ref).max()
    assert solo.error_l2 / n**2 <= 1e-6


@pytest.mark.cuda
def test_sharded_fft_matches_the_single_device_fft_on_card(card):
    from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed
    from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed
    from nonlocalheatequation_torch.parallel.mesh import device_list, make_mesh, make_mesh_3d

    devs = device_list(card, 8)
    for stepper, stages in (("euler", 0), ("rkc", 4), ("expo", 0), ("expo", 1)):
        kw = dict(k=1.0, dt=2e-4, dh=1.0 / 48, method="fft", dtype=torch.float64,
                  stepper=stepper, stages=stages)
        pairs = ((Solver2DDistributed(24, 20, 2, 2, 4, 5, mesh=make_mesh(2, 2, devs), **kw),
                  Solver2D(48, 40, 4, 5, device=card, **kw)),
                 (Solver3DDistributed(16, 16, 24, 4, 3, mesh=make_mesh_3d(2, 2, 2, devs), **kw),
                  Solver3D(16, 16, 24, 4, 3, device=card, **kw)))
        for d, s in pairs:
            d.test_init()
            s.test_init()
            got, want = d.do_work(), s.do_work()
            assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max(), stepper
    assert not any(ck.launch_counts().values())  # cuFFT's transforms, no kernel of ours


@pytest.mark.cuda
def test_sharded_unstructured_forms_bitwise_on_card(card):
    # the padded-row sums add in an order fixed by the edge list, whatever the
    # shard count; the offsets form and its superstep run the single-device
    # offsets layout's elementwise program
    from nonlocalheatequation_torch.ops.unstructured import (
        ShardedUnstructuredOp,
        UnstructuredNonlocalOp,
        UnstructuredSolver,
    )
    from nonlocalheatequation_torch.parallel.mesh import device_list

    m = 48
    h = 1.0 / m
    rng = np.random.default_rng(5)
    g = np.stack(np.meshgrid(np.arange(m) * h, np.arange(m) * h, indexing="ij"), -1)
    pts = g.reshape(-1, 2) + rng.uniform(-0.2 * h, 0.2 * h, (m * m, 2))
    shuffled = pts[rng.permutation(m * m)]

    def solve(op, nt=6, **kw):
        s = UnstructuredSolver(op, nt=nt, dtype=torch.float32, **kw)
        s.test_init()
        return s.do_work()

    for cloud in (pts, shuffled):
        op = UnstructuredNonlocalOp(cloud, 3 * h, 1.0, 1e-6, vol=h * h, device=card)
        one = solve(ShardedUnstructuredOp(op, devices=device_list(card, 1), layout="edges"))
        for halo in ("export", "gather"):
            sh = ShardedUnstructuredOp(op, devices=device_list(card, 4), halo=halo)
            assert np.array_equal(solve(sh), one), halo
        ell = solve(op, layout="ell")
        assert np.abs(one - ell).max() <= 1e-5 * np.abs(ell).max()
    op = UnstructuredNonlocalOp(pts, 3 * h, 1.0, 1e-6, vol=h * h, device=card)
    sh = ShardedUnstructuredOp(op, devices=device_list(card, 4))
    assert sh.layout == "offsets" and sh.superstep_fits(2)
    ref = solve(op, layout="offsets")
    for K in (1, 2):
        assert np.array_equal(solve(sh, superstep=K), ref), K
    assert not any(ck.launch_counts().values())  # torch ops only


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [[2, 2], [2, 2, 2, 2], [3, 1]], ids=["2x2", "4x2", "3+1"])
def test_multihost_legs_over_cards(card, tmp_path, counts):
    """tests/torch_multihost_child.py's legs in an nccl group, one rank a card
    (``TMH_PLATFORM=gpu``, float64 through the kernels): every leg on every
    rank bitwise the rank's one-card solve of the same mesh.  Needs a card a
    rank: nccl takes one rank a card."""
    import os
    import subprocess
    import sys

    from nonlocalheatequation_torch.ops import _build

    if torch.cuda.device_count() < len(counts):
        pytest.skip(f"needs {len(counts)} cards, one a rank")
    _build.build(("nsum2d.cu", "nsum3d.cu") + _build.SOURCES_HALO)  # once, before the ranks
    child = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_multihost_child.py")
    procs = [subprocess.Popen(
        [sys.executable, child, f"file://{tmp_path / 'pg'}", str(len(counts)), str(r)],
        env=dict(os.environ, TMH_PLATFORM="gpu", TMH_LOCAL=str(c), TMH_NDEV=str(sum(counts)),
                 TMH_OUT=str(tmp_path), LOCAL_RANK=str(r), NLHEAT_DIST_TIMEOUT="60"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r, c in enumerate(counts)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
            assert p.returncode == 0, outs[-1][-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    legs = 21 if sum(counts) == 4 else 20  # 8 devices: the K=2 superstep does not fit
    for r, out in enumerate(outs):
        assert sum(line.startswith(f"TMH-OK p{r} ") for line in out.splitlines()) == legs, out


# -- the serving pipeline (serve/server.py) ---------------------------------------

def _serve_cases(n, shape, nt, eps, seed, test=False):
    rng = np.random.default_rng(seed)
    physics = [(1.0, 2e-5, 0.02), (0.5, 3e-5, 0.02)]
    return [EnsembleCase(shape=shape, nt=nt, eps=eps, k=k, dt=dt, dh=dh, test=test,
                         u0=None if test else rng.standard_normal(shape))
            for i in range(n) for k, dt, dh in [physics[i % 2]]]


@pytest.mark.cuda
def test_served_lanes_bitwise_the_offline_run_on_card(card):
    """A production bucket and a test-form bucket, mixed physics, padding
    engaged, through ServePipeline on the card: every lane bitwise the
    offline EnsembleEngine.run(), the same batched_step2d launches, no
    retry, no fallback chunk, the breaker closed."""
    from nonlocalheatequation_torch.serve.server import ServePipeline

    cases = (_serve_cases(6, (96, 80), 12, 3, 41)
             + _serve_cases(3, (64, 64), 10, 5, 42, test=True))
    offline = EnsembleEngine(method="cuda", device=card, dtype=torch.float32).run(cases)
    want = ck.launch_counts()["batched_step2d"]
    ck.reset_launch_counts()
    with ServePipeline(depth=3, window_ms=10_000.0, method="cuda",
                       dtype=torch.float32) as pipe:
        served = pipe.serve_cases(cases)
    assert pipe.engine.device.type == "cuda"
    assert ck.launch_counts()["batched_step2d"] == want == 12 + 10
    for got, ref in zip(served, offline, strict=True):
        assert np.array_equal(got, ref)
    res = pipe.metrics()["resilience"]
    assert (res["retries"], res["fallback_chunks"], res["breaker"]["state"]) == (0, 0, "closed")


@pytest.mark.cuda
def test_pipeline_dispatches_without_a_fence_on_card(card, monkeypatch):
    """Two chunks in flight: no fence_scalar between their dispatches, one a
    retire, and no implicit fence either — a spin kernel queued behind the
    first chunk is still running when the second dispatch (its staging
    through page-locked memory and its launches) returns, and the stream is
    busy then.  The second pass, after a warm-up, reuses the programs and
    the page-locked blocks, as a steady server does."""
    from nonlocalheatequation_torch.serve import server as srv
    from nonlocalheatequation_torch.serve.server import ServePipeline

    cases = _serve_cases(16, (512, 512), 20, 8, 43)
    engine = EnsembleEngine(method="cuda", device=card, dtype=torch.float32)
    with ServePipeline(engine=engine, depth=2, window_ms=10_000.0) as pipe:
        warm = pipe.serve_cases(cases)
    cycles = 10 ** 7
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    torch.cuda._sleep(cycles)
    t1.record()
    t1.synchronize()
    cycles = int(cycles * 500.0 / max(t0.elapsed_time(t1), 1e-3))  # about 500 ms
    events, probe = [], {}
    real_fence, real_dispatch = srv.fence_scalar, engine.dispatch_chunk
    monkeypatch.setattr(srv, "fence_scalar",
                        lambda x: (events.append("fence"), real_fence(x))[1])

    def dispatch(multi, U0):
        out = real_dispatch(multi, U0)
        events.append("dispatch")
        if "spin" not in probe:
            torch.cuda._sleep(cycles)
            probe["spin"] = torch.cuda.Event()
            probe["spin"].record()
        else:
            probe["done"] = probe["spin"].query()
            probe["idle"] = torch.cuda.current_stream().query()
        return out

    monkeypatch.setattr(engine, "dispatch_chunk", dispatch)
    with ServePipeline(engine=engine, depth=2, window_ms=10_000.0) as pipe:
        served = pipe.serve_cases(cases)
    assert events == ["dispatch", "dispatch", "fence", "fence"]
    assert probe["done"] is False and probe["idle"] is False
    assert pipe.report.max_inflight == 2
    for got, ref in zip(served, warm, strict=True):
        assert np.array_equal(got, ref)


@pytest.mark.cuda
def test_breaker_cycle_ends_closed_on_card(card):
    """Two failed device attempts open a threshold-2 breaker; the CPU
    fallback serves the open window within 1e-12 of the card's lanes (f64,
    no launch); after the cooldown the half-open probe runs on the card
    (bitwise, fetched by the deadline's watchdog thread) and closes the
    breaker."""
    from nonlocalheatequation_torch.serve.server import ServePipeline
    from nonlocalheatequation_torch.utils.faults import FaultPlan

    cases = _serve_cases(6, (64, 48), 8, 4, 44)
    offline = EnsembleEngine(method="cuda", device=card, dtype=torch.float64,
                             batch_sizes=(2,)).run(cases)
    ck.reset_launch_counts()
    clock = [0.0]
    with ServePipeline(depth=1, window_ms=10_000.0, clock=lambda: clock[0], retries=2,
                       backoff_ms=0.0, breaker_threshold=2, breaker_cooldown_ms=1000.0,
                       fetch_deadline_ms=5000.0,
                       faults=FaultPlan.parse("raise@0x2"), method="cuda",
                       dtype=torch.float64, batch_sizes=(2,)) as pipe:
        handles = [pipe.submit(c) for c in cases[:4]]
        pipe.drain()
        assert pipe.metrics()["resilience"]["breaker"]["state"] == "open"
        assert ck.launch_counts()["batched_step2d"] == 0  # the fallback launches nothing
        clock[0] += 1.5
        handles += [pipe.submit(c) for c in cases[4:]]
        pipe.drain()
    res = pipe.metrics()["resilience"]
    assert [(t["from"], t["to"]) for t in res["breaker"]["transitions"]] == [
        ("closed", "open"), ("open", "half-open"), ("half-open", "closed")]
    assert res["fallback_chunks"] == 2 and res["faults"] == {"error": 2}
    assert ck.launch_counts()["batched_step2d"] == 8  # the probe chunk
    for h, ref in zip(handles[:4], offline[:4], strict=True):
        assert np.abs(h.result - ref).max() <= 1e-12 * np.abs(ref).max()
    for h, ref in zip(handles[4:], offline[4:], strict=True):
        assert np.array_equal(h.result, ref)


@pytest.mark.cuda
def test_a_failed_launch_propagates_and_never_falls_back_on_card(card, monkeypatch):
    """A launch that raises on the card (not an injected fault) is not
    classified: it propagates out of the pipeline with no retry, no open
    breaker and no chunk served by the CPU fallback."""
    from nonlocalheatequation_torch.serve.server import ServePipeline

    engine = EnsembleEngine(method="cuda", device=card, dtype=torch.float64,
                            batch_sizes=(2,))

    def failed(multi, U0):
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(engine, "dispatch_chunk", failed)
    pipe = ServePipeline(engine=engine, depth=2, window_ms=0.0, breaker_threshold=1)
    assert pipe.on_card
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        with pipe:
            pipe.serve_cases(_serve_cases(4, (64, 48), 8, 4, 45))
    res = pipe.metrics()["resilience"]
    assert (res["faults"], res["retries"], res["fallback_chunks"]) == ({}, 0, 0)
    assert res["breaker"]["state"] == "closed"


@pytest.mark.cuda
def test_cli_serve_scores_the_fallback_as_failed_on_card(card, monkeypatch, capsys):
    """solve2d --test_batch --serve on the card: cases the CPU fallback
    served while the breaker was open are reported and fail the batch."""
    import io
    import sys

    from nonlocalheatequation_torch.cli import solve2d

    rows = [(40, 40, 20, 3, 0.2, 0.001, 0.02), (50, 50, 20, 5, 1.0, 0.0005, 0.02)]
    monkeypatch.setenv("NLHEAT_FAULT_PLAN", "raise@0x3")
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        f"{len(rows)}\n" + "".join(" ".join(map(str, r)) + "\n" for r in rows)))
    rc = solve2d.main(["--test_batch", "--serve", "1", "--serve-window-ms", "0",
                       "--serve-retries", "3", "--x64", "1"])
    out, err = capsys.readouterr()
    assert rc == 1 and out.splitlines()[-1] == "Tests Failed"
    for seq in range(len(rows)):
        assert (f"serve: case {seq} served by the CPU fallback while the engine is on the "
                "card: not the card's result") in err


@pytest.mark.cuda
def test_warm_boot_from_the_store_is_bitwise_and_probes_nothing_on_card(card, monkeypatch,
                                                                        tmp_path):
    """The program store (serve/program_store.py) on the card: a tuned
    production bucket and a tuned solo solve, cold then warm from a fresh
    tuner; the warm boot runs no probe, loads its programs, launches only
    the recorded winners and is bitwise the cold boot."""
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D
    from nonlocalheatequation_torch.serve import program_store as ps

    monkeypatch.setenv("NLHEAT_PROGRAM_STORE", str(tmp_path / "store"))
    monkeypatch.setenv("NLHEAT_TUNE_BATCH", "1")
    probes = []
    real = autotune._measure
    monkeypatch.setattr(autotune, "_measure", lambda *a: probes.append(1) or real(*a))
    cases = _serve_cases(8, (256, 256), 20, 8, 46)
    op = NonlocalOp2D(8, 1.0, 2e-5, 1.0 / 256)
    u = torch.as_tensor(np.random.default_rng(47).standard_normal((256, 256)),
                        device=card, dtype=torch.float32)

    def boot():
        eng = EnsembleEngine(method="cuda", device=card, dtype=torch.float32)
        states = eng.run(cases)
        solo = ps.solo_pick(op, 50, (256, 256), torch.float32, card)(u, 0)
        return eng, states, solo

    cold_eng, cold, cold_solo = boot()
    assert probes and cold_eng.report.programs_built == 1
    autotune.reset()
    n_probes = len(probes)
    ck.reset_launch_counts()
    warm_eng, warm, warm_solo = boot()
    assert len(probes) == n_probes
    assert (warm_eng.report.programs_loaded, warm_eng.report.programs_built) == (1, 0)
    ran = {k for k, v in ck.launch_counts().items() if v}
    assert ran <= {"batched_step2d", "batched_carried2d", "batched_superstep2d", "nsum2d",
                   "step2d", "carried2d", "superstep2d", "resident2d"}
    for a, b in zip(cold, warm, strict=True):
        assert np.array_equal(a, b)
    assert torch.equal(cold_solo, warm_solo)


@pytest.mark.cuda
def test_slo_taps_add_no_fence_on_card(card, monkeypatch):
    """ServePipeline(slo=True) on the card: the same dispatches and fences
    as the ledger off (no fence between the dispatches), every promise
    resolved once, the lanes bitwise."""
    from nonlocalheatequation_torch.serve import server as srv
    from nonlocalheatequation_torch.serve.server import ServePipeline

    cases = _serve_cases(16, (256, 256), 20, 8, 48)
    engine = EnsembleEngine(method="cuda", device=card, dtype=torch.float32)
    real_fence, real_dispatch = srv.fence_scalar, engine.dispatch_chunk
    runs = {}
    for slo in (False, True):
        events = []
        monkeypatch.setattr(srv, "fence_scalar",
                            lambda x, ev=events: (ev.append("fence"), real_fence(x))[1])
        monkeypatch.setattr(engine, "dispatch_chunk",
                            lambda m, U, ev=events: (ev.append("dispatch"),
                                                     real_dispatch(m, U))[1])
        with ServePipeline(engine=engine, depth=2, window_ms=10_000.0, slo=slo) as pipe:
            runs[slo] = (events, pipe.serve_cases(cases), pipe.metrics())
    assert runs[True][0] == runs[False][0] == ["dispatch", "dispatch", "fence", "fence"]
    for a, b in zip(runs[True][1], runs[False][1], strict=True):
        assert np.array_equal(a, b)
    s = runs[True][2]["slo"]
    assert (s["promised"], s["resolved"], s["duplicate"], s["open"]) == (16, 16, 0, 0)


# -- the fleet front door (serve/router.py) on the card ---------------------------------

#: a router child: the fleet's results saved beside whether its own process
#: ever made a CUDA context (the router must not: workers are exec'd)
ROUTER_CHILD = r"""
import json, sys
import numpy as np
import torch
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase
from nonlocalheatequation_torch.serve.router import ReplicaRouter
out, seed = sys.argv[1], int(sys.argv[2])
rng = np.random.default_rng(seed)
cases = [EnsembleCase(shape=(256, 256), nt=20 + i % 2, eps=8, k=1.0, dt=2e-5, dh=0.02,
                      test=False, u0=rng.standard_normal((256, 256))) for i in range(8)]
with ReplicaRouter(replicas=2, method="cuda", dtype=torch.float32, batch_sizes=(8,)) as r:
    got = r.serve_cases(cases)
    owners = sorted(set(r._owner.values()))
np.save(out, np.stack(got))
print(json.dumps({"cuda": torch.cuda.is_initialized(), "owners": owners}))
"""

#: a worker whose chunk holding a case of 77 steps raises at dispatch, as a
#: failed launch on the card would, when its replica id is listed
FAILING_WORKER = r"""
import os, sys
fd = os.dup(1)
os.dup2(2, 1)
from nonlocalheatequation_torch.serve import router
from nonlocalheatequation_torch.serve.ensemble import EnsembleEngine
failing = os.environ["FAILING_REPLICAS"].split(",")
if "*" in failing or os.environ.get("NLHEAT_REPLICA_ID") in failing:
    stage, dispatch = EnsembleEngine.stage_inputs, EnsembleEngine.dispatch_chunk
    def staged(self, chunk):
        self.marked = any(c.nt == 77 for c in chunk)
        return stage(self, chunk)
    def dispatched(self, multi, U0):
        if getattr(self, "marked", False):
            raise RuntimeError("CUDA error: unspecified launch failure")
        return dispatch(self, multi, U0)
    EnsembleEngine.stage_inputs, EnsembleEngine.dispatch_chunk = staged, dispatched
router._worker_main(frame_fd=fd)
"""


@pytest.mark.cuda
def test_pipe_fleet_bitwise_offline_and_the_router_makes_no_context(card, tmp_path):
    """A 2-replica pipe fleet on the card (a router in a child process):
    every lane bitwise the offline engine, one bucket a replica, and the
    router's process never made a CUDA context."""
    import json
    import os
    import subprocess
    import sys

    out = tmp_path / "fleet.npy"
    r = subprocess.run([sys.executable, "-c", ROUTER_CHILD, str(out), "49"],
                       capture_output=True, text=True, timeout=900,
                       cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0, r.stderr[-4000:]
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    assert rep == {"cuda": False, "owners": [0, 1]}
    rng = np.random.default_rng(49)
    cases = [EnsembleCase(shape=(256, 256), nt=20 + i % 2, eps=8, k=1.0, dt=2e-5, dh=0.02,
                          test=False, u0=rng.standard_normal((256, 256))) for i in range(8)]
    want = EnsembleEngine(method="cuda", device=card, dtype=torch.float32,
                          batch_sizes=(8,)).run(cases)
    got = np.load(out)
    for a, b in zip(got, want, strict=True):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_gang_replica_bitwise_the_distributed_solve_on_card(card):
    """The gang replica on 4 virtual devices of the card: the fused
    in-kernel exchange ('peer'), bitwise solve_case_sharded and
    Solver2DDistributed in this process."""
    from nonlocalheatequation_torch.parallel.distributed2d import (
        Solver2DDistributed,
        choose_mesh_for_grid,
    )
    from nonlocalheatequation_torch.parallel.gang import solve_case_sharded
    from nonlocalheatequation_torch.parallel.mesh import device_list
    from nonlocalheatequation_torch.serve.router import ReplicaRouter

    case = EnsembleCase(shape=(512, 512), nt=20, eps=8, k=1.0, dt=2e-6, dh=1 / 512,
                        test=True)
    with ReplicaRouter(replicas=1, method="cuda", dtype=torch.float32,
                       shard_threshold=256 * 256, gang_devices=4) as router:
        got = router.submit(case).wait(600)
        assert router.metrics()["sharded_cases"] == 1
    want, info = solve_case_sharded(case, ndevices=4, method="cuda", dtype=torch.float32)
    assert info["comm"] == "fused" and info["transport"] == "peer"
    assert np.array_equal(got, want)
    mesh = choose_mesh_for_grid(512, 512, device_list(card, 4))
    mx, my = mesh.shape["x"], mesh.shape["y"]
    s = Solver2DDistributed(512 // mx, 512 // my, mx, my, 20, 8, k=1.0, dt=2e-6, dh=1 / 512,
                            mesh=mesh, method="cuda", dtype=torch.float32, comm="fused")
    s.test_init()
    assert np.array_equal(np.asarray(s.do_work(), np.float64), got)
    assert s.error_l2 / 512 ** 2 <= 1e-6


@pytest.mark.cuda
def test_a_failed_launch_in_a_worker_ends_it_and_never_falls_back(card):
    """A worker whose dispatch raises a CUDA error on a marked case ends
    (no retry, no breaker, no CPU route); the router counts a death and a
    healthy replica serves the case bitwise.  With the failure in every
    worker the case completes exceptionally after MAX_REQUEUES."""
    import subprocess
    import sys

    from nonlocalheatequation_torch.serve import router as router_mod
    from nonlocalheatequation_torch.serve import transport as tr
    from nonlocalheatequation_torch.serve.router import ReplicaRouter

    class Failing(tr.PipeTransport):
        def __init__(self, which):
            self.which = which

        def spawn(self, rid, env, timeout_s=180.0):
            proc = subprocess.Popen([sys.executable, "-c", FAILING_WORKER],
                                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                    env=dict(env, FAILING_REPLICAS=self.which))
            return tr.WorkerHandle(proc, proc.stdout, proc.stdin)

    rng = np.random.default_rng(50)
    cases = [EnsembleCase(shape=(128, 128), nt=77 if i == 0 else 10, eps=8, k=1.0, dt=2e-5,
                          dh=0.02, test=False, u0=rng.standard_normal((128, 128)))
             for i in range(3)]
    want = EnsembleEngine(method="cuda", device=card, dtype=torch.float32,
                          batch_sizes=(8,)).run(cases)
    kw = dict(method="cuda", dtype=torch.float32, batch_sizes=(8,))
    with ReplicaRouter(replicas=2, transport=Failing("0"), **kw) as router:
        hs = [router.submit(c) for c in cases]
        router.drain(timeout_s=600)
        assert router.metrics()["deaths"] == 1
        for h, w in zip(hs, want, strict=True):
            assert h.error is None and h.replica != 0 and np.array_equal(h.result, w)
        for frame in router.refresh_stats().values():
            res = frame["metrics"]["resilience"]
            assert (res["retries"], res["fallback_chunks"]) == (0, 0)
    with ReplicaRouter(replicas=1, transport=Failing("*"), **kw) as router:
        h = router.submit(cases[0])
        with pytest.raises(Exception, match="MAX_REQUEUES"):
            h.wait(600)
        assert router.metrics()["deaths"] == router_mod.MAX_REQUEUES + 1
        assert np.array_equal(router.submit(cases[1]).wait(600), want[1])


def _session_case(n, eps, seed):
    """(u0, physics) of an n^2 session at 0.8x the Euler bound."""
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D as Op

    dh = 1.0 / n
    probe = Op(eps, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)
    u0 = np.random.default_rng(seed).standard_normal((n, n))
    return u0, dict(eps=eps, k=1.0, dt=dt, dh=dh)


@pytest.mark.cuda
def test_session_bitwise_its_chunked_oracle_on_card(card):
    """A 256^2 eps=8 f32 session through ServePipeline on the card, with a
    retarget of k and a source queued during chunk 1 and a final partial
    chunk: every preview and the final f64 field bitwise the chunk-by-chunk
    composition through an EnsembleEngine on the card (the source added on
    the host in f64 at each chunk's end), the retarget applied at step 8,
    and every chunk served by the card (no retry, no fallback chunk)."""
    from nonlocalheatequation_torch.serve.server import ServePipeline
    from nonlocalheatequation_torch.serve.sessions import SessionManager

    n, chunk, nt = 256, 8, 30
    u0, phys = _session_case(n, 8, 60)
    src = np.linspace(-1.0, 1.0, n * n).reshape(n, n)
    kw = dict(method="cuda", dtype=torch.float32, batch_sizes=(1,))
    with ServePipeline(depth=1, window_ms=0.0, **kw) as pipe:
        with SessionManager(pipe, chunk_steps=chunk) as mgr:
            s = mgr.open(shape=(n, n), u0=u0, nt=nt, preview_stride=4, **phys)
            mgr.pump()  # chunk 1 in flight
            mgr.retarget(s.sid, k=0.5, source=src)
            mgr.drive(timeout_s=600)
            frames = s.frames_after(-1)
    assert s.state == "done" and s.status()["audit"][0]["applied_at_step"] == chunk
    res = pipe.metrics()["resilience"]
    assert (res["retries"], res["fallback_chunks"]) == (0, 0)
    eng = EnsembleEngine(device=card, **kw)
    u, states, k, source = np.asarray(u0, np.float64), [np.asarray(u0, np.float64)], 1.0, None
    for start in range(0, nt, chunk):
        m = min(chunk, nt - start)
        u = np.asarray(eng.run([EnsembleCase(shape=(n, n), nt=m, eps=phys["eps"], k=k,
                                             dt=phys["dt"], dh=phys["dh"], test=False,
                                             u0=u)])[0], np.float64)
        if source is not None:
            u = u + (m * phys["dt"]) * source
        states.append(u)
        k, source = 0.5, src
    assert [(f.step, f.kind) for f in frames] == \
        [(t, "preview") for t in (0, 8, 16, 24, 30)] + [(30, "final")]
    for f, want in zip(frames[:-1], states, strict=True):
        assert np.array_equal(f.values, want[::4, ::4].astype(np.float32))
    assert np.array_equal(frames[-1].values, states[-1]) and np.isfinite(states[-1]).all()


@pytest.mark.cuda
def test_a_failed_launch_fails_the_session_and_never_falls_back_on_card(card, monkeypatch):
    """A launch that raises on the card inside a session's second chunk
    fails the session (the error kept, the step at the last boundary) and
    propagates out of the drive: no retry, no chunk served by the CPU."""
    from nonlocalheatequation_torch.serve.server import ServePipeline
    from nonlocalheatequation_torch.serve.sessions import SessionManager

    engine = EnsembleEngine(method="cuda", device=card, dtype=torch.float64, batch_sizes=(1,))
    real, calls = engine.dispatch_chunk, []

    def dispatch(multi, U0):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("CUDA error: unspecified launch failure")
        return real(multi, U0)

    monkeypatch.setattr(engine, "dispatch_chunk", dispatch)
    u0, phys = _session_case(64, 4, 61)
    pipe = ServePipeline(engine=engine, depth=1, window_ms=0.0, breaker_threshold=1)
    mgr = SessionManager(pipe, chunk_steps=4)
    s = mgr.open(shape=(64, 64), u0=u0, nt=12, **phys)
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        mgr.drive(timeout_s=600)
    assert s.state == "failed" and s.step == 4 and "launch failure" in str(s.error)
    assert mgr.metrics()["failed"] == 1
    res = pipe.metrics()["resilience"]
    assert (res["faults"], res["retries"], res["fallback_chunks"]) == ({}, 0, 0)
    mgr.close()
    pipe.close()
