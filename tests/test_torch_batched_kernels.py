"""The port's batched kernels (ops/cuda_batched.py) against the JAX package's
batched makers, and lane by lane against the port's solo kernels.

On the CPU the port's wrappers run their plain versions and the JAX makers
run their Pallas kernels in interpret mode (tests/conftest.py forces CPU and
x64), at the JAX suite's ensemble size (tests/test_ensemble.py: 40x36,
eps=3, 5 steps).  A physics-mixed bucket runs the JAX package's stacked
composition (per-case solo kernels) and the port's one batched kernel.
Tolerances, relative to the largest magnitude of the result (the two
packages sum the stencil in different orders): 1e-12 in float64, 1e-5 in
float32 and, over several bf16 steps, one bfloat16 rounding flip per step on
top (tests/test_torch_multistep.py's _bf16_tol).  Within the port, each lane
of a batched plain version is bitwise the solo plain version on that case:
the kernels are held to the same on the card (tests/test_torch_card.py and
chip_smoke.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from nonlocalheatequation_torch.ops import cuda_batched as cb
from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D
from nonlocalheatequation_tpu.ops import pallas_kernel as jpk
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp2D as JaxOp2D

torch.set_num_threads(1)

NX, NY, EPS, NSTEPS = 40, 36, 3, 5                               # test_ensemble.py:37
MIXED = [(1.0, 1e-4, 0.02), (0.5, 2e-4, 0.02), (0.2, 1e-4, 0.01), (1.0, 5e-5, 0.03)]
PHYSICS = {"uniform": MIXED[:1] * 3, "mixed": MIXED[:3]}
DTYPES = [(np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-5)]


def _ops(physics, precision="f32"):
    """The JAX and port operators of one bucket, one per case."""
    return ([JaxOp2D(EPS, k, dt, dh, method="pallas", precision=precision)
             for k, dt, dh in physics],
            [NonlocalOp2D(EPS, k, dt, dh, method="cuda", precision=precision)
             for k, dt, dh in physics])


def _stack(batch, np_dtype, seed):
    return np.random.default_rng(seed).standard_normal((batch, NX, NY)).astype(np_dtype)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _bf16_tol(ops, steps) -> float:
    """1e-5 plus one bfloat16 rounding flip per step, at the bucket's largest
    operator gain dt*scale*wsum."""
    gain = max(op.dt * op.c * op.dh * op.dh * op.wsum for op in ops)
    return 1e-5 + steps * gain * 2.0 ** -8


@pytest.mark.parametrize("test", [False, True], ids=["production", "test-form"])
@pytest.mark.parametrize("physics", ["uniform", "mixed"])
@pytest.mark.parametrize("np_dtype,dtype,tol", DTYPES, ids=["f64", "f32"])
def test_plain_batched_step_matches_jax(np_dtype, dtype, tol, physics, test):
    jops, tops = _ops(PHYSICS[physics])
    U = _stack(len(jops), np_dtype, 1)
    gs = lgs = None
    if test:
        parts = [op.source_parts(NX, NY) for op in jops]
        gs, lgs = [g for g, _ in parts], [lg for _, lg in parts]
    ref = jpk.make_batched_pallas_multi_step_fn(
        jops, NSTEPS, dtype=jnp.dtype(np_dtype), test=test,
        gs=None if gs is None else np.stack(gs), lgs=None if lgs is None else np.stack(lgs))(
        jnp.asarray(U), 0)
    got = cb.make_batched_cuda_multi_step_fn(tops, NSTEPS, dtype=dtype, test=test, gs=gs,
                                             lgs=lgs)(torch.from_numpy(U), 0)
    assert got.dtype == dtype and got.shape == U.shape
    assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("physics", ["uniform", "mixed"])
@pytest.mark.parametrize("np_dtype,dtype,tol", DTYPES, ids=["f64", "f32"])
def test_plain_batched_carried_matches_jax(np_dtype, dtype, tol, physics):
    jops, tops = _ops(PHYSICS[physics])
    U = _stack(len(jops), np_dtype, 2)
    ref = jpk.make_batched_carried_multi_step_fn(jops, NSTEPS, dtype=jnp.dtype(np_dtype))(
        jnp.asarray(U), 0)
    got = cb.make_batched_carried_multi_step_fn(tops, NSTEPS, dtype=dtype)(
        torch.from_numpy(U), 0)
    assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("ksteps,nsteps", [(2, 5), (3, 5), (4, 4)])
@pytest.mark.parametrize("physics", ["uniform", "mixed"])
@pytest.mark.parametrize("np_dtype,dtype,tol", DTYPES, ids=["f64", "f32"])
def test_plain_batched_superstep_matches_jax(np_dtype, dtype, tol, physics, ksteps, nsteps):
    jops, tops = _ops(PHYSICS[physics])
    U = _stack(len(jops), np_dtype, 3)
    ref = jpk.make_batched_superstep_multi_step_fn(jops, nsteps, ksteps=ksteps,
                                                   dtype=jnp.dtype(np_dtype))(
        jnp.asarray(U), 0)
    got = cb.make_batched_superstep_multi_step_fn(tops, nsteps, ksteps=ksteps, dtype=dtype)(
        torch.from_numpy(U), 0)
    assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("variant", ["per-step", "carried", "superstep"])
@pytest.mark.parametrize("physics", ["uniform", "mixed"])
def test_plain_batched_bf16_tier_matches_jax(physics, variant):
    jops, tops = _ops(PHYSICS[physics], "bf16")
    U = _stack(len(jops), np.float32, 4)
    jmake = {"per-step": jpk.make_batched_pallas_multi_step_fn,
             "carried": jpk.make_batched_carried_multi_step_fn,
             "superstep": jpk.make_batched_superstep_multi_step_fn}[variant]
    tmake = {"per-step": cb.make_batched_cuda_multi_step_fn,
             "carried": cb.make_batched_carried_multi_step_fn,
             "superstep": cb.make_batched_superstep_multi_step_fn}[variant]
    ref = jmake(jops, NSTEPS, dtype=jnp.float32)(jnp.asarray(U), 0)
    got = tmake(tops, NSTEPS, dtype=torch.float32)(torch.from_numpy(U), 0)
    assert _rel(got.numpy(), ref) <= _bf16_tol(tops, NSTEPS)


# -- within the port: each lane is the solo plain version --------------------------

def _bucket(shape, eps, batch, dtype, seed):
    """A mixed-physics stack with its (scale, dt) table and test-form inputs."""
    rng = np.random.default_rng(seed)
    wsum = float(sum(2 * h + 1 for h in ck.column_half_heights(eps)))
    scales = [2.0 + eps + b for b in range(batch)]
    dts = [0.8 / (s * wsum) * (1 + 0.1 * b) for b, s in enumerate(scales)]
    U = torch.tensor(rng.standard_normal((batch, *shape)), dtype=dtype)
    G = torch.tensor(rng.standard_normal((batch, *shape)), dtype=dtype)
    LG = torch.tensor(rng.standard_normal((batch, *shape)), dtype=dtype)
    return U, G, LG, scales, dts, wsum, cb.case_params(scales, dts, dtype, "cpu")


@pytest.mark.parametrize("prec", ["f32", "bf16"])
@pytest.mark.parametrize("shape,eps,batch", [((1, 1), 1, 1), ((13, 45), 5, 3), ((37, 50), 8, 2),
                                             ((20, 9), 12, 4)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_lanes_are_the_solo_plain_versions(dtype, shape, eps, batch, prec):
    U, G, LG, scales, dts, wsum, params = _bucket(shape, eps, batch, dtype, eps)
    coefs = cb.source_coef_table([7], dts, dtype, "cpu")[0]
    step = cb.batched_step2d(U, eps, params, wsum, precision=prec)
    test = cb.batched_step2d(U, eps, params, wsum, G=G, LG=LG, coefs=coefs, precision=prec)
    frames = F.pad(U, (eps,) * 4)
    shadow = ck.shadow_of(frames) if prec == "bf16" else None
    carried = cb.batched_carried2d(frames, eps, params, wsum, shadow=shadow)
    sup = cb.batched_superstep2d(U, eps, params, wsum, 3, prec)
    for b in range(batch):
        args = (U[b], eps, scales[b], wsum, dts[b])
        assert torch.equal(step[b], ck.step2d(*args, precision=prec))
        assert torch.equal(test[b], ck.step2d(*args, g=G[b], lg=LG[b], t=7, precision=prec))
        solo = ck.carried2d(frames[b], eps, scales[b], wsum, dts[b],
                            shadow=None if shadow is None else shadow[b])
        if shadow is None:
            assert torch.equal(carried[b], solo)
        else:
            assert torch.equal(carried[0][b], solo[0]) and torch.equal(carried[1][b], solo[1])
        assert torch.equal(sup[b], ck.superstep2d(*args, 3, prec))


@pytest.mark.parametrize("eps", [0, 1, 2, 5, 8])
def test_disc_sum_adds_in_the_tile_body_order(eps):
    # the kernels' contract (csrc/stencil_tile.cuh, csrc/batched_step2d.cu),
    # written out one float32 scalar at a time: W_0 = row[0], W_h = (W_{h-1}
    # + row[-h]) + row[+h]; each output adds W_{h_i} at x offset i from 0,
    # heights ascending, then i ascending
    rng = np.random.default_rng(eps)
    upad = rng.standard_normal((2, 5 + 2 * eps, 4 + 2 * eps)).astype(np.float32)
    heights = [int(h) for h in ck.column_half_heights(eps)]
    want = np.zeros((2, 5, 4), np.float32)
    for b, x, y in np.ndindex(want.shape):
        acc = np.float32(0)
        for h in range(eps + 1):
            for i in range(2 * eps + 1):
                if heights[i] == h:
                    row = upad[b, x + i]
                    w = row[y + eps]
                    for k in range(1, h + 1):
                        w = (w + row[y + eps - k]) + row[y + eps + k]
                    acc = acc + w
        want[b, x, y] = acc
    got = ck.disc_sum(torch.from_numpy(upad), eps)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert torch.equal(ck.nsum2d_plain(torch.from_numpy(upad[1]), eps), got[1])


def test_tables_round_once_from_float64():
    dts = [1e-4, 3e-4 / 7]
    table = cb.source_coef_table(range(2, 5), dts, torch.float32, "cpu")
    assert table.shape == (3, 2, 2) and table.dtype == torch.float32
    for i, t in enumerate(range(2, 5)):
        for b, dt in enumerate(dts):
            want = torch.tensor(ck.source_coefs(t, dt), dtype=torch.float64).float()
            assert torch.equal(table[i, b], want)
    params = cb.case_params([1 / 3, 2 / 3], dts, torch.float32, "cpu")
    assert torch.equal(params, torch.tensor([[1 / 3, dts[0]], [2 / 3, dts[1]]]).float())


def test_wrappers_check_their_arguments():
    U, G, LG, _scales, dts, wsum, params = _bucket((8, 9), 2, 2, torch.float64, 0)
    with pytest.raises(ValueError, match="a .B, nx, ny. case stack"):
        cb.batched_step2d(U[0], 2, params, wsum)
    with pytest.raises(ValueError, match=r"needs a \(2, 2\) torch.float64 table"):
        cb.batched_step2d(U, 2, params[:1], wsum)
    with pytest.raises(ValueError, match=r"needs a \(2, 2\) torch.float64 table"):
        cb.batched_superstep2d(U, 2, params.float(), wsum, 2)
    with pytest.raises(ValueError, match="G, LG and coefs"):
        cb.batched_step2d(U, 2, params, wsum, G=G, LG=LG)
    with pytest.raises(ValueError, match="too small for eps"):
        cb.batched_carried2d(U, 5, params, wsum)
    with pytest.raises(ValueError, match="bfloat16 stack"):
        cb.batched_carried2d(F.pad(U, (2,) * 4), 2, params, wsum, shadow=U)
    with pytest.raises(ValueError, match="ksteps must be >= 1"):
        cb.batched_superstep2d(U, 2, params, wsum, 0)
    out = torch.empty_like(U)
    assert cb.batched_step2d(U, 2, params, wsum, out=out) is out
    # a CPU tensor runs the plain version: no launch is counted
    assert ck.launch_counts()["batched_step2d"] == 0
    assert cb.fits_batched_superstep(64, 4, torch.float64, "bf16", "cpu")


def test_makers_refuse_what_a_batched_kernel_cannot_run():
    from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp3D

    op = NonlocalOp2D(EPS, 1.0, 1e-4, 0.02, method="cuda")
    with pytest.raises(ValueError, match="mixes operators"):
        cb.make_batched_cuda_multi_step_fn([op, NonlocalOp2D(4, 1.0, 1e-4, 0.02)], 2)
    with pytest.raises(ValueError, match="resync"):
        cb.make_batched_carried_multi_step_fn(
            [NonlocalOp2D(EPS, 1.0, 1e-4, 0.02, precision="bf16", resync_every=2)], 2)
    with pytest.raises(ValueError, match="weighted J"):
        cb.make_batched_superstep_multi_step_fn(
            [NonlocalOp2D(EPS, 1.0, 1e-4, 0.02, influence=lambda r: 1.0 / (1.0 + r))], 2)
    with pytest.raises(ValueError, match="the batched kernels are 2D"):
        cb.make_batched_cuda_multi_step_fn([NonlocalOp3D(2, 1.0, 1e-5, 0.1)], 2)
