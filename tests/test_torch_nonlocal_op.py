"""The port's nonlocal operators against the JAX package's NumPy oracle.

Every NonlocalOp2D method (shift, conv, sat, cuda — its plain version on
the CPU — and auto) against the JAX ``neighbor_sum_np``/``apply_np`` at
1e-12 relative in float64 (the methods sum in different orders); the 1D
operator likewise; the step functions against the JAX generic step.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops.nonlocal_op import (
    NonlocalOp1D,
    NonlocalOp2D,
    make_multi_step_fn,
    make_step_fn,
    source_at,
)
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp1D as JaxOp1D
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp2D as JaxOp2D
from nonlocalheatequation_tpu.ops.nonlocal_op import make_step_fn as jax_make_step_fn

# small grids: one intra-op thread keeps parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("method", ["shift", "conv", "sat", "cuda", "auto"])
@pytest.mark.parametrize("nx,ny,eps", [(40, 33, 5), (21, 48, 8), (6, 9, 10)])
def test_2d_methods_match_jax_oracle(method, nx, ny, eps):
    rng = np.random.default_rng(nx + ny + eps)
    u = rng.standard_normal((nx, ny))
    jop = JaxOp2D(eps, 1.0, 5e-4, 0.02, method="shift")
    top = NonlocalOp2D(eps, 1.0, 5e-4, 0.02, method=method)
    ut = torch.from_numpy(u)
    assert _rel(top.neighbor_sum(ut), jop.neighbor_sum_np(u)) <= 1e-12
    assert _rel(top.apply(ut), jop.apply_np(u)) <= 1e-12
    e = eps
    upad = np.pad(u, e)
    assert _rel(top.apply_padded(torch.from_numpy(upad)), jop.apply_np(u)) <= 1e-12
    assert np.array_equal(top.neighbor_sum_np(u), jop.neighbor_sum_np(u))
    assert np.array_equal(top.apply_np(u), jop.apply_np(u))


def test_method_resolution_and_weighted_j_demotion():
    op = NonlocalOp2D(4, 1.0, 1e-4, 0.02)
    assert op.method == "auto"
    assert op.resolve_method(CPU) == "conv"
    assert op.resolve_method(torch.device("cuda")) == "cuda"
    J = lambda r: math.exp(-r)  # noqa: E731
    for m in ("sat", "cuda", "auto"):
        assert NonlocalOp2D(4, 1.0, 1e-4, 0.02, influence=J, method=m).method == "conv"
    jw = JaxOp2D(4, 1.0, 1e-4, 0.02, influence=J)
    tw = NonlocalOp2D(4, 1.0, 1e-4, 0.02, influence=J)
    u = np.random.default_rng(1).standard_normal((20, 17))
    assert _rel(tw.apply(torch.from_numpy(u)), jw.apply_np(u)) <= 1e-12
    # fft resolves to itself on either device and meets the JAX operator
    fft = NonlocalOp2D(4, 1.0, 1e-4, 0.02, method="fft")
    assert fft.resolve_method(CPU) == fft.resolve_method(torch.device("cuda")) == "fft"
    assert _rel(fft.apply(torch.from_numpy(u)), JaxOp2D(4, 1.0, 1e-4, 0.02).apply_np(u)) <= 1e-12


@pytest.mark.parametrize("method", ["shift", "conv", "sat", "cuda"])
def test_bf16_tier_matches_jax_bf16_tier(method):
    rng = np.random.default_rng(5)
    u = rng.standard_normal((30, 26)).astype(np.float32)
    jop = JaxOp2D(5, 1.0, 1e-4, 0.02, method="shift", precision="bf16")
    top = NonlocalOp2D(5, 1.0, 1e-4, 0.02, method=method, precision="bf16")
    ref = np.asarray(jop.neighbor_sum(jnp.asarray(u)))
    assert _rel(top.neighbor_sum(torch.from_numpy(u)), ref) <= 1e-5
    with pytest.raises(ValueError, match="bf16-tier knob"):
        NonlocalOp2D(5, 1.0, 1e-4, 0.02, resync_every=2)


def test_1d_operator_matches_jax():
    rng = np.random.default_rng(3)
    u = rng.standard_normal(57)
    for eps, k, dx in ((5, 1.0, 0.02), (40, 0.5, 0.02)):
        jop, top = JaxOp1D(eps, k, 1e-3, dx), NonlocalOp1D(eps, k, 1e-3, dx)
        assert top.c == jop.c and top.wsum == jop.wsum
        assert _rel(top.apply(torch.from_numpy(u)), jop.apply_np(u)) <= 1e-12
        assert np.array_equal(top.source_parts(57)[1], jop.source_parts(57)[1])
        fft = NonlocalOp1D(eps, k, 1e-3, dx, method="fft")
        assert _rel(fft.apply(torch.from_numpy(u)), jop.apply_np(u)) <= 1e-12


@pytest.mark.parametrize("method", ["conv", "cuda"])
@pytest.mark.parametrize("test", [False, True])
def test_step_matches_jax_generic_step(method, test):
    rng = np.random.default_rng(11)
    nx, ny, eps, k, dt, dh = 36, 30, 6, 0.2, 1e-3, 0.02
    u = rng.standard_normal((nx, ny))
    jop = JaxOp2D(eps, k, dt, dh, method="conv")
    top = NonlocalOp2D(eps, k, dt, dh, method=method)
    g, lg = jop.source_parts(nx, ny) if test else (None, None)
    jstep = jax_make_step_fn(jop, g, lg, jnp.float64)
    tstep = make_step_fn(top, g, lg, torch.float64)
    for t in (0, 4):
        ref = np.asarray(jstep(jnp.asarray(u), t))
        assert _rel(tstep(torch.from_numpy(u), t), ref) <= 1e-12


def test_multi_step_uses_two_buffers_and_leaves_input():
    op = NonlocalOp2D(3, 1.0, 1e-4, 0.02, method="cuda")
    u = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 16)))
    before = u.clone()
    multi = make_multi_step_fn(op, 5)
    got = multi(u, 0)
    assert torch.equal(u, before)
    step = make_step_fn(op)
    ref = u
    for t in range(5):
        ref = step(ref, t)
    assert torch.equal(got, ref)
    assert torch.equal(make_multi_step_fn(op, 0)(u, 0), u)


def test_resync_runs_full_precision_steps():
    op_r = NonlocalOp2D(4, 1.0, 1e-4, 0.02, method="cuda", precision="bf16", resync_every=1)
    op_f = NonlocalOp2D(4, 1.0, 1e-4, 0.02, method="cuda")
    u = torch.from_numpy(np.random.default_rng(4).standard_normal((20, 20)).astype(np.float32))
    assert torch.equal(make_multi_step_fn(op_r, 3)(u, 0), make_multi_step_fn(op_f, 3)(u, 0))


def test_source_at_and_device_source_parts():
    op = NonlocalOp2D(5, 1.0, 5e-4, 0.02)
    g, lg = op.source_parts(24, 20)
    gt, lgt = op.source_parts_on(24, 20, CPU)
    assert np.array_equal(gt.numpy(), g)
    assert _rel(lgt, lg) <= 1e-12
    assert _rel(source_at(gt, lgt, 3, op.dt), source_at(g, lg, 3, op.dt)) <= 1e-12
    coef_g, coef_lg = ck.source_coefs(3, op.dt)
    assert _rel(coef_g * g + coef_lg * lg, source_at(g, lg, 3, op.dt)) <= 1e-15
