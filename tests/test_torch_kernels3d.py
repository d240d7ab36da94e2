"""The port's 3D kernel plain versions against the JAX package's 3D Pallas
kernels, and the 3D wrappers' CPU behaviour.

On the CPU the JAX kernels run in Pallas interpret mode (tests/conftest.py
forces CPU and x64, as tests/test_pallas.py runs them), so the grids stay at
16^3 or less and eps at 4 or less.  The port's wrappers route CPU tensors to
the plain versions; the CUDA kernels themselves run only on a card
(tests/test_torch_card.py and chip_smoke.py).

The port's plain versions sum the sphere in the tile body's order
(``cuda_kernel.sphere_sum``), so the card holds the kernels to them bitwise.
Tolerances against the JAX package, relative to the largest magnitude of
the result (the two packages sum the sphere in different orders): 1e-12 in
float64, 1e-5 in float32; the bf16 operand forms are compared in float32 at 1e-5, since both
round the same float32 operand to bfloat16 and accumulate in float32.
"""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
from nonlocalheatequation_torch.ops.nonlocal_op import (
    NonlocalOp3D,
    case_scale,
    make_multi_step_fn_base,
)
from nonlocalheatequation_torch.ops.stencil import sphere_column_heights
from nonlocalheatequation_tpu.ops import pallas_kernel as jpk
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp3D as JaxOp3D
from nonlocalheatequation_tpu.ops.nonlocal_op import make_step_fn as jax_make_step_fn

torch.set_num_threads(1)

SHAPES = [(12, 12, 12, 2), (16, 10, 8, 3), (9, 11, 14, 4), (1, 1, 1, 1), (5, 16, 3, 3)]
DTYPES = [(np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-5)]
# (n, eps, steps): odd and even step counts and one step, as
# tests/test_pallas.py:284 and :356 run the JAX makers (scaled to <= 16^3)
MULTI = [(16, 4, 3), (12, 3, 2), (14, 2, 1), (16, 3, 4)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _ops(n, eps, precision="f32"):
    """The JAX and port operators at 0.8x the Euler bound (so the operator,
    not the carry, dominates each step)."""
    dh = 1.0 / n
    probe = JaxOp3D(eps, 1.0, 1.0, dh)
    dt = 0.8 / (probe.c * dh**3 * probe.wsum)
    return (JaxOp3D(eps, 1.0, dt, dh, method="pallas", precision=precision),
            NonlocalOp3D(eps, 1.0, dt, dh, method="cuda", precision=precision))


def _state(shape, np_dtype, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np_dtype)


@pytest.mark.parametrize("nx,ny,nz,eps", SHAPES)
@pytest.mark.parametrize("precision,dtype", [("f32", np.float64), ("bf16", np.float32)])
def test_plain_nsum3d_matches_pallas(nx, ny, nz, eps, precision, dtype):
    upad = _state((nx + 2 * eps, ny + 2 * eps, nz + 2 * eps), dtype, nx * 100 + ny + eps)
    ref = jpk.build_neighbor_sum_3d(eps, nx, ny, nz, np.dtype(dtype).name,
                                    precision=precision)(jnp.asarray(upad))
    got = k3.nsum3d(torch.from_numpy(upad), eps, precision)  # CPU tensor -> plain
    assert got.dtype == torch.from_numpy(upad).dtype and got.shape == (nx, ny, nz)
    assert _rel(got.numpy(), ref) <= (1e-12 if dtype == np.float64 else 1e-5)


def _slice_order_sum(upad, eps):
    """The sphere sum by one shifted slice-add per offset, (i, j, k)
    ascending: the plain versions' order before they took the tile body's."""
    e = int(eps)
    nx, ny, nz = (s - 2 * e for s in upad.shape)
    acc = torch.zeros((nx, ny, nz), dtype=upad.dtype)
    heights = sphere_column_heights(e)
    for i in range(2 * e + 1):
        for j in range(2 * e + 1):
            h = int(heights[i, j])
            for k in range(e - h, e + h + 1):
                acc = acc + upad[i:i + nx, j:j + ny, k:k + nz]
    return acc


@pytest.mark.parametrize("eps", range(7))
def test_sphere_sum_matches_pallas_and_the_slice_order(eps):
    nx, ny, nz = 4, 5, 6
    upad = _state((nx + 2 * eps, ny + 2 * eps, nz + 2 * eps), np.float64, 40 + eps)
    ref = jpk.build_neighbor_sum_3d(eps, nx, ny, nz, "float64")(jnp.asarray(upad))
    got = ck.sphere_sum(torch.from_numpy(upad), eps)
    assert got.dtype == torch.float64 and got.shape == (nx, ny, nz)
    assert _rel(got.numpy(), ref) <= 1e-12
    assert _rel(got.numpy(), _slice_order_sum(torch.from_numpy(upad), eps).numpy()) <= 1e-12


@pytest.mark.parametrize("eps", [0, 1, 3, 5])
def test_sphere_sum_adds_in_the_tile_body_order(eps):
    # the kernels' contract (csrc/stencil_tile3d.cuh, csrc/nsum3d.cu), written
    # out one float32 scalar at a time: W_0 = line[0], W_h = (W_{h-1} +
    # line[-h]) + line[+h] along z; each output adds W_{h(i,j)} of its plane
    # offsets from 0, heights ascending, then (i, j) ascending.  eps=5 has a
    # height with no column (h=1)
    rng = np.random.default_rng(eps)
    nx, ny, nz = 3, 4, 5
    upad = rng.standard_normal((nx + 2 * eps, ny + 2 * eps, nz + 2 * eps)).astype(np.float32)
    heights = sphere_column_heights(eps)
    want = np.zeros((nx, ny, nz), np.float32)
    for x, y, z in np.ndindex(want.shape):
        acc = np.float32(0)
        for h in range(eps + 1):
            for i, j in np.ndindex(heights.shape):
                if heights[i, j] == h:
                    line = upad[x + i, y + j]
                    w = line[z + eps]
                    for k in range(1, h + 1):
                        w = (w + line[z + eps - k]) + line[z + eps + k]
                    acc = acc + w
        want[x, y, z] = acc
    got = ck.sphere_sum(torch.from_numpy(upad), eps)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert torch.equal(k3.nsum3d_plain(torch.from_numpy(upad), eps), got)


@pytest.mark.parametrize("nx,ny,nz,eps", SHAPES[:3])
@pytest.mark.parametrize("test", [False, True])
def test_plain_step3d_matches_the_jax_pallas_step(nx, ny, nz, eps, test):
    jop, top = _ops(max(nx, ny, nz), eps)
    u = _state((nx, ny, nz), np.float64, 7 + eps)
    g, lg = jop.source_parts(nx, ny, nz) if test else (None, None)
    jstep = jax_make_step_fn(jop, g, lg, jnp.float64)  # the generic step, pallas sum
    for t in (0, 3):
        ref = jstep(jnp.asarray(u), t)
        kw = dict(g=torch.tensor(g), lg=torch.tensor(lg), t=t) if test else {}
        got = k3.step3d(torch.from_numpy(u), eps, case_scale(top), top.wsum, top.dt, **kw)
        assert _rel(got.numpy(), ref) <= 1e-12, (t, test)


def test_plain_step3d_bf16_matches_the_jax_pallas_step():
    jop, top = _ops(12, 3, "bf16")
    u = _state((12, 9, 10), np.float32, 3)
    ref = jax_make_step_fn(jop, dtype=jnp.float32)(jnp.asarray(u), 0)
    got = k3.step3d(torch.from_numpy(u), 3, case_scale(top), top.wsum, top.dt, precision="bf16")
    assert _rel(got.numpy(), ref) <= 1e-5


# the carried kernel's branches on the card (csrc/carried3d.cu): a frame z
# of 17, not a multiple of 4 (one-cell staging); eps 6, the register
# design's last; eps 7, the tile body's first
CARRIED = MULTI + [(9, 4, 2), (8, 6, 2), (8, 7, 1)]


@pytest.mark.parametrize("n,eps,steps", CARRIED)
@pytest.mark.parametrize("np_dtype,dtype,tol", DTYPES)
def test_plain_carried3d_matches_jax(n, eps, steps, np_dtype, dtype, tol):
    jop, top = _ops(n, eps)
    u = _state((n, n, n), np_dtype, n + eps)
    ref = jpk.make_carried_multi_step_fn_3d(jop, steps, dtype=jnp.dtype(np_dtype))(
        jnp.asarray(u), jnp.int32(0))
    got = k3.make_carried_multi_step_fn_3d(top, steps, dtype=dtype)(torch.from_numpy(u), 0)
    assert got.dtype == dtype and got.shape == (n, n, n)
    assert _rel(got.numpy(), ref) <= tol


# and eps 5, whose window lines the resident kernel pads to 16 bytes in
# float32, with a frame z of 20 and of 21 (padded to 24 in float32)
RESIDENT3D = MULTI + [(10, 5, 7), (11, 5, 2)]


@pytest.mark.parametrize("n,eps,steps", RESIDENT3D)
@pytest.mark.parametrize("np_dtype,dtype,tol", DTYPES)
def test_plain_resident3d_matches_jax(n, eps, steps, np_dtype, dtype, tol):
    jop, top = _ops(n, eps)
    assert jpk.fits_resident_3d(n, n, n, eps)
    u = _state((n, n, n), np_dtype, 3 * n + eps)
    ref = jpk.make_resident_multi_step_fn_3d(jop, steps, dtype=jnp.dtype(np_dtype))(
        jnp.asarray(u), jnp.int32(0))
    got = k3.make_resident_multi_step_fn_3d(top, steps, dtype=dtype)(torch.from_numpy(u), 0)
    assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("variant", ["carried3d", "resident3d"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_variants_equal_the_per_step_loop_bitwise(variant, dtype):
    _jop, top = _ops(13, 3)
    u = torch.from_numpy(_state((13, 11, 9), np.float64, 11)).to(dtype)
    maker = {"carried3d": k3.make_carried_multi_step_fn_3d,
             "resident3d": k3.make_resident_multi_step_fn_3d}[variant]
    for steps in (1, 2, 5):
        got = maker(top, steps)(u, 0)
        ref = make_multi_step_fn_base(top, steps)(u, 0)
        assert got.dtype == dtype and torch.equal(got, ref), (variant, steps)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    ck.reset_launch_counts()
    u = torch.randn(7, 5, 9, dtype=torch.float64)
    upad = F.pad(u, (2,) * 6)
    out = torch.empty_like(u)
    got = k3.step3d(u, 2, 1.5, 33.0, 0.01, out=out)
    assert got is out and torch.equal(got, k3.step3d_plain(u, 2, 1.5, 33.0, 0.01))
    assert torch.equal(k3.nsum3d(upad, 2), k3.nsum3d_plain(upad, 2))
    nxt = k3.carried3d(upad, 2, 1.5, 33.0, 0.01)
    assert torch.equal(nxt, k3.carried3d_plain(upad, 2, 1.5, 33.0, 0.01))
    assert torch.equal(nxt[2:-2, 2:-2, 2:-2], got)
    halo = torch.ones_like(nxt, dtype=torch.bool)
    halo[2:-2, 2:-2, 2:-2] = False
    assert not nxt[halo].any()
    # a caller's out comes back with a zero halo, here as on the card
    out3 = torch.full_like(upad, float("nan"))
    assert k3.carried3d(upad, 2, 1.5, 33.0, 0.01, out=out3) is out3 and torch.equal(out3, nxt)
    assert torch.equal(k3.resident3d(u, 2, 1.5, 33.0, 0.01, 1), got)
    assert set(ck.launch_counts().values()) == {0}


def test_wrappers_refuse_bad_arguments():
    u = torch.randn(6, 6, 6, dtype=torch.float64)
    with pytest.raises(ValueError, match="both g and lg"):
        k3.step3d(u, 1, 1.0, 7.0, 0.1, g=u)
    with pytest.raises(ValueError, match="state must be 3D"):
        k3.step3d(u[0], 1, 1.0, 7.0, 0.1)
    with pytest.raises(ValueError, match="too small"):
        k3.nsum3d(torch.zeros(3, 9, 9, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="unknown precision tier"):
        k3.nsum3d(torch.zeros(9, 9, 9, dtype=torch.float64), 2, "fp8")
    with pytest.raises(ValueError, match="nsteps must be >= 0"):
        k3.resident3d(u, 1, 1.0, 7.0, 0.1, -1)
    # the library's refusal (-1) names the kernel, its source and the remedy
    with pytest.raises(ValueError, match=r"step3d: eps=13 .* csrc/nsum3d.cu.*'shift' or 'sat'"):
        ck._raise_on(-1, "step3d", 13, u, k3._REMEDY)
    assert k3.step3d(u, 1, 1.0, 7.0, 0.0).equal(u)  # dt = 0 leaves the state as is


@pytest.mark.parametrize("maker,what", [
    (k3.make_carried_multi_step_fn_3d, "carried 3D kernel"),
    (k3.make_resident_multi_step_fn_3d, "resident 3D kernel")])
def test_frame_kernels_refuse_a_bf16_operator(maker, what):
    _jop, top = _ops(12, 2, "bf16")
    with pytest.raises(ValueError, match=f"the {what} has no bf16 precision tier; use the "
                                         "per-step 3D path"):
        maker(top, 3)


def test_resident3d_gate_is_the_cards(monkeypatch):
    """The gate lives in csrc/resident3d.cu: stand in for the library with
    one that refuses, and for the device context (no card here)."""
    asked = []
    monkeypatch.setattr(torch.cuda, "device", lambda _d: contextlib.nullcontext())
    monkeypatch.setattr(k3, "_entry", lambda name: lambda *a: asked.append((name, a)) or 0)
    assert not k3.fits_resident_3d(256, 256, 256, 4, torch.float32, "cuda")
    assert asked == [("nlheat_resident3d_fits", (0, 256, 256, 256, 4))]
    assert not k3.fits_resident_3d(8, 8, 8, 4, torch.float16, "cuda")
    # the plain version has no such limit: the CPU answer is always yes
    assert k3.fits_resident_3d(256, 256, 256, 4, torch.float32, "cpu")
    # the library's refusal (-1) names the kernel and its source
    with pytest.raises(ValueError, match=r"resident3d: eps=4 .* csrc/resident3d.cu"):
        ck._raise_on(-1, "resident3d", 4, torch.zeros(4, 4, 4))


def test_zero_steps_and_input_never_written():
    _jop, top = _ops(10, 2)
    u = torch.from_numpy(_state((10, 8, 6), np.float64, 4))
    keep = u.clone()
    for maker in (k3.make_carried_multi_step_fn_3d, k3.make_resident_multi_step_fn_3d):
        assert torch.equal(maker(top, 0)(u, 0), keep)
        maker(top, 3)(u, 0)
    assert torch.equal(u, keep)
