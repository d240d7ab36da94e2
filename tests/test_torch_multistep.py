"""The port's multi-step variants (carried, superstep, resident) against the
JAX package's, and against the port's own per-step loop.

On the CPU the port's wrappers run their plain versions and the JAX makers
run their Pallas kernels in interpret mode (tests/conftest.py forces CPU
and x64), at the shapes of tests/test_pallas.py and
tests/test_precision_tier.py, 64^2 or less.  Tolerances, relative to the
largest magnitude of the result (the two packages sum the stencil in
different orders): 1e-12 in float64, 1e-5 in float32 and in the bf16 tier
(compared in float32: both round the same float32 operand to bfloat16 and
accumulate in float32), plus, over several bf16 steps, one bfloat16
rounding flip per step (see _bf16_tol).  Within the port, every plain
multi-step result is bitwise the per-step plain loop: the kernels are held
to the same on the card (tests/test_torch_card.py and chip_smoke.py).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, make_multi_step_fn_base
from nonlocalheatequation_tpu.ops import pallas_kernel as jpk
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp2D as JaxOp2D

torch.set_num_threads(1)

DTYPES = [(np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-5)]
CARRIED = [(64, 5, 4), (40, 3, 3), (48, 12, 2)]                      # test_pallas.py:181
SUPERSTEP = [(64, 5, 5, 2), (40, 3, 6, 3), (48, 12, 2, 2), (56, 7, 4, 4),
             (33, 4, 4, 2), (40, 1, 5, 2), (64, 16, 4, 2)]           # test_pallas.py:211-213
RESIDENT = [(64, 5, 5), (40, 3, 4), (48, 12, 1)]                     # test_pallas.py:312
# and the eps whose window lines the resident kernel pads to 16 bytes in
# float32 (5, 7), over 1, 2, 7 steps
RESIDENT += [(30, 5, 7), (26, 7, 2), (21, 5, 1)]
SUPERSTEP_BF16 = [(64, 5, 5, 2), (40, 3, 6, 3), (33, 4, 4, 2), (48, 12, 2, 2)]


def _ops(n, eps, precision="f32"):
    """The JAX and port operators at 0.8x the Euler bound (so the operator,
    not the carry, dominates each step)."""
    dh = 1.0 / n
    probe = JaxOp2D(eps, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh * dh * probe.wsum)
    return (JaxOp2D(eps, 1.0, dt, dh, method="pallas", precision=precision),
            NonlocalOp2D(eps, 1.0, dt, dh, method="cuda", precision=precision))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _state(n, np_dtype, seed):
    return np.random.default_rng(seed).standard_normal((n, n)).astype(np_dtype)


@pytest.mark.parametrize("n,eps,steps", CARRIED)
@pytest.mark.parametrize("np_dtype,dtype,tol", DTYPES)
def test_plain_carried_matches_jax(n, eps, steps, np_dtype, dtype, tol):
    jop, top = _ops(n, eps)
    u = _state(n, np_dtype, n + eps)
    ref = jpk.make_carried_multi_step_fn(jop, steps, dtype=jnp.dtype(np_dtype))(
        jnp.asarray(u), jnp.int32(0))
    got = ck.make_carried_multi_step_fn(top, steps, dtype=dtype)(torch.from_numpy(u), 0)
    assert got.dtype == dtype and got.shape == (n, n)
    assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("n,eps,steps,K", SUPERSTEP)
@pytest.mark.parametrize("np_dtype,dtype,tol", DTYPES)
def test_plain_superstep_matches_jax(n, eps, steps, K, np_dtype, dtype, tol):
    jop, top = _ops(n, eps)
    u = _state(n, np_dtype, n * K + eps)
    ref = jpk.make_superstep_multi_step_fn(jop, steps, ksteps=K, dtype=jnp.dtype(np_dtype))(
        jnp.asarray(u), jnp.int32(0))
    got = ck.make_superstep_multi_step_fn(top, steps, ksteps=K, dtype=dtype)(
        torch.from_numpy(u), 0)
    assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("n,eps,steps", RESIDENT)
@pytest.mark.parametrize("np_dtype,dtype,tol", DTYPES)
def test_plain_resident_matches_jax(n, eps, steps, np_dtype, dtype, tol):
    jop, top = _ops(n, eps)
    assert jpk.fits_resident(n, n, eps)
    u = _state(n, np_dtype, 3 * n + eps)
    ref = jpk.make_resident_multi_step_fn(jop, steps, dtype=jnp.dtype(np_dtype))(
        jnp.asarray(u), jnp.int32(0))
    got = ck.make_resident_multi_step_fn(top, steps, dtype=dtype)(torch.from_numpy(u), 0)
    assert _rel(got.numpy(), ref) <= tol


def _bf16_ops(n, eps):
    """The operators of test_precision_tier.py:150-188 (dt=1e-6, dh=1/n)."""
    return (JaxOp2D(eps, 1.0, 1e-6, 1.0 / n, method="pallas", precision="bf16"),
            NonlocalOp2D(eps, 1.0, 1e-6, 1.0 / n, method="cuda", precision="bf16"))


def _bf16_tol(top, steps) -> float:
    """1e-5, plus one bfloat16 rounding flip per step.  The two packages sum
    in different orders, so after a step their float32 states differ in the
    last bits; where a value lies on a bfloat16 rounding boundary the next
    operand then differs by one bfloat16 ulp (2^-8 relative), which the
    operator passes on with gain dt*scale*wsum.  (The first step's operand
    is the same in both: a single bf16 step is held at 1e-5 in
    test_torch_kernels.py.)"""
    gain = top.dt * top.c * top.dh * top.dh * top.wsum
    return 1e-5 + steps * gain * 2.0 ** -8


@pytest.mark.parametrize("n,eps,steps", CARRIED)                   # test_precision_tier.py:156
def test_plain_carried_bf16_matches_jax(n, eps, steps):
    jop, top = _bf16_ops(n, eps)
    u = _state(n, np.float32, 5 * n + eps)
    ref = jpk.make_carried_multi_step_fn(jop, steps, dtype=jnp.float32)(
        jnp.asarray(u), jnp.int32(0))
    got = ck.make_carried_multi_step_fn(top, steps, dtype=torch.float32)(
        torch.from_numpy(u), 0)
    assert _rel(got.numpy(), ref) <= _bf16_tol(top, steps)
    one = ck.make_carried_multi_step_fn(top, 1, dtype=torch.float32)(torch.from_numpy(u), 0)
    ref1 = jpk.make_carried_multi_step_fn(jop, 1, dtype=jnp.float32)(
        jnp.asarray(u), jnp.int32(0))
    assert _rel(one.numpy(), ref1) <= 1e-5


@pytest.mark.parametrize("n,eps,steps,K", SUPERSTEP_BF16)         # test_precision_tier.py:175
def test_plain_superstep_bf16_matches_jax(n, eps, steps, K):
    jop, top = _bf16_ops(n, eps)
    u = _state(n, np.float32, 7 * n + eps)
    ref = jpk.make_superstep_multi_step_fn(jop, steps, ksteps=K, dtype=jnp.float32)(
        jnp.asarray(u), jnp.int32(0))
    got = ck.make_superstep_multi_step_fn(top, steps, ksteps=K, dtype=torch.float32)(
        torch.from_numpy(u), 0)
    assert _rel(got.numpy(), ref) <= _bf16_tol(top, steps)


TIERS = [("f32", torch.float64), ("f32", torch.float32), ("bf16", torch.float32),
         ("bf16", torch.float64)]


# the resident kernel has no bf16 tier (its refusal is tested below)
@pytest.mark.parametrize("variant,precision,dtype", [
    (v, p, d) for v in ("carried", "superstep2", "superstep3", "superstep4", "resident")
    for p, d in TIERS if not (v == "resident" and p == "bf16")])
def test_plain_variants_equal_the_per_step_loop_bitwise(variant, precision, dtype):
    _jop, top = _ops(37, 4, precision)
    u = torch.from_numpy(_state(37, np.float64, 11)).to(dtype)[:, :29].contiguous()
    for steps in (1, 5, 7):
        ref = make_multi_step_fn_base(top, steps)(u, 0)
        if variant == "carried":
            fn = ck.make_carried_multi_step_fn(top, steps)
        elif variant == "resident":
            fn = ck.make_resident_multi_step_fn(top, steps)
        else:
            fn = ck.make_superstep_multi_step_fn(top, steps, ksteps=int(variant[-1]))
        got = fn(u, 0)
        assert got.dtype == dtype and torch.equal(got, ref), (variant, steps)


def test_plain_carried_frame_bookkeeping():
    _jop, top = _ops(20, 3, "bf16")
    eps, scale, wsum, dt = ck._production_args(top)
    u = torch.from_numpy(_state(20, np.float32, 2))
    frame = torch.nn.functional.pad(u, (eps,) * 4)
    # the bf16 tier keeps no shadow: the next frame is the plain pair's master,
    # whose shadow is that frame's rounding
    nxt = ck.carried2d(frame, eps, scale, wsum, dt, precision="bf16")
    master, shadow = ck.carried2d_plain(frame, eps, scale, wsum, dt, ck.shadow_of(frame))
    assert torch.equal(nxt, master) and torch.equal(shadow, ck.shadow_of(nxt))
    halo = torch.ones_like(nxt, dtype=torch.bool)
    halo[eps:-eps, eps:-eps] = False
    assert not nxt[halo].any()
    step = ck.step2d(u, eps, scale, wsum, dt, precision="bf16")
    assert torch.equal(nxt[eps:-eps, eps:-eps], step)
    out = torch.full_like(frame, 7.0)
    assert ck.carried2d(frame, eps, scale, wsum, dt, out=out) is out
    assert not out[halo].any()
    with pytest.raises(ValueError, match="unknown precision tier"):
        ck.carried2d(frame, eps, scale, wsum, dt, precision="fp8")


def test_resident_refuses_a_bf16_operator():
    _jop, top = _ops(16, 2, "bf16")
    with pytest.raises(ValueError, match="resident kernel has no bf16 precision tier"):
        ck.make_resident_multi_step_fn(top, 3)


def test_resident_refuses_a_grid_past_the_cards_gate(monkeypatch):
    """The gate is the card's (csrc/resident2d.cu): stand in for the library
    with one that refuses, and for the device context (no card here)."""
    asked = []
    monkeypatch.setattr(torch.cuda, "device", lambda _d: contextlib.nullcontext())
    monkeypatch.setattr(ck, "_entry", lambda name: lambda *a: asked.append((name, a)) or 0)
    assert not ck.fits_resident(4096, 4096, 8, torch.float32, "cuda")
    assert asked == [("nlheat_resident2d_fits", (0, 4096, 4096, 8))]
    assert not ck.fits_superstep(4096, 4096, 64, 4, torch.float64, "bf16", "cuda")
    assert asked[-1] == ("nlheat_superstep2d_fits", (1, 1, 64, 4))
    # the plain version has no such limit: the CPU answer is always yes
    assert ck.fits_resident(4096, 4096, 8, torch.float32, "cpu")
    # the library's refusal (-1) names the kernel and its source
    with pytest.raises(ValueError, match=r"resident2d: eps=8 .* csrc/resident2d.cu"):
        ck._raise_on(-1, "resident2d", 8, torch.zeros(4, 4))


@pytest.mark.parametrize("dtype,per", [(torch.float32, 4), (torch.float64, 2)])
def test_resident_frame_pads_the_last_axis_to_16_bytes(dtype, per):
    # the frames csrc/resident2d.cu and resident3d.cu take: eps cells of halo,
    # the last axis padded with zeros to whole 16-byte copies
    for shape, eps in [((3, 250), 8), ((5, 7), 5), ((2, 3), 0), ((4, 6, 9), 5),
                       ((2, 3, 40), 5), ((3, 2, 42), 5)]:
        u = torch.from_numpy(np.random.default_rng(eps).standard_normal(shape)).to(dtype)
        frame = ck.resident_frame(u, eps)
        last = shape[-1] + 2 * eps
        assert frame.shape[-1] == ck.resident_pitch(shape[-1], eps, dtype)
        assert frame.shape[-1] % per == 0 and last <= frame.shape[-1] < last + per
        assert frame.shape[:-1] == tuple(n + 2 * eps for n in shape[:-1])
        assert frame.is_contiguous() and frame.dtype == dtype
        inner = tuple(slice(eps, eps + n) for n in shape)
        assert torch.equal(frame[inner], u)
        frame[inner] = 0
        assert not frame.any(), (shape, eps)


@pytest.mark.parametrize("nsteps", [0, 1, 2, 3, 5, 12])
def test_superstep_k_equals_jax(nsteps):
    for k in (1, 2, 3, 4, 8):
        assert ck.superstep_k(k, nsteps) == jpk.superstep_k(k, nsteps)


def test_zero_steps_and_input_never_written():
    _jop, top = _ops(12, 2)
    u = torch.from_numpy(_state(12, np.float64, 4))
    keep = u.clone()
    for fn in (ck.make_carried_multi_step_fn(top, 0), ck.make_superstep_multi_step_fn(top, 0),
               ck.make_resident_multi_step_fn(top, 0)):
        assert torch.equal(fn(u, 0), keep)
    for fn in (ck.make_carried_multi_step_fn(top, 3), ck.make_superstep_multi_step_fn(top, 3),
               ck.make_resident_multi_step_fn(top, 3)):
        fn(u, 0)
    assert torch.equal(u, keep)
