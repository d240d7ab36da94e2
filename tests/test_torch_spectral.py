"""The port's spectral method (ops/spectral.py, ``method="fft"``) against the
JAX package's ``ops/spectral.py``, on the CPU in float64.

* ``fft_size``, ``fft_box``, ``neighbor_symbol``, ``symbol_direct`` and
  ``operator_symbol`` equal the JAX package's (all NumPy float64) at eps
  1, 3, 5 and 8 in 1D, 2D and 3D; the baked symbol meets the direct cosine
  sum.
* ``neighbor_sum_fft`` and the fft operators in 1D, 2D and 3D within 1e-12
  of the JAX fft path and of the port's stencil methods (``cuda`` is its
  kernels' plain versions on the CPU), weighted J included.
* The padded entry points refuse fft in the JAX package's words; the
  ``/op/fft-applies`` counter counts; an f32 state keeps an f32 spectrum.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.obs.metrics import REGISTRY
from nonlocalheatequation_torch.ops import spectral as TS
from nonlocalheatequation_torch.ops import stencil as TST
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp1D, NonlocalOp2D, NonlocalOp3D
from nonlocalheatequation_tpu.ops import spectral as JS
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp1D as JaxOp1D
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp2D as JaxOp2D
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp3D as JaxOp3D

torch.set_num_threads(1)

T_OPS = {1: NonlocalOp1D, 2: NonlocalOp2D, 3: NonlocalOp3D}
J_OPS = {1: JaxOp1D, 2: JaxOp2D, 3: JaxOp3D}
MASKS = {1: TST.horizon_mask_1d, 2: TST.horizon_mask_2d, 3: TST.horizon_mask_3d}
# each side at least eps + 1 at eps 8, so the box holds 2*eps + 1 offsets a side (a
# smaller grid aliases offsets in the embedding, in the JAX package too)
SHAPES = {1: (17,), 2: (12, 18), 3: (9, 10, 11)}


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


@pytest.mark.parametrize("n,eps", [(1, 0), (2, 1), (13, 2), (50, 5), (511, 8), (4096, 8),
                                   (256, 4), (4104, 16), (97, 40)])
def test_fft_size_and_box_equal_jax(n, eps):
    assert TS.fft_size(n) == JS.fft_size(n)
    assert TS.fft_box((n, n // 2 + 1), eps) == JS.fft_box((n, n // 2 + 1), eps)
    (b,) = TS.fft_box((n,), eps)
    assert b >= n + eps
    for p in (2, 3, 5):
        while b % p == 0:
            b //= p
    assert b == 1


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("eps", [1, 3, 5, 8])
def test_symbols_equal_jax(dim, eps):
    w = TST.influence_weights(MASKS[dim](eps), None, 0.02)
    box = TS.fft_box(SHAPES[dim], eps)
    baked = TS.neighbor_symbol(w, box)
    direct = TS.symbol_direct(w, box)
    assert np.array_equal(baked, JS.neighbor_symbol(w, box))
    assert np.array_equal(direct, JS.symbol_direct(w, box))
    assert baked.shape == direct.shape
    assert np.abs(baked - direct).max() <= 1e-11 * max(1.0, w.sum())


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_operator_symbol_equals_jax_nonpositive_zero_at_dc(dim):
    shape, h = SHAPES[dim], 1.0 / 24
    op, jop = T_OPS[dim](3, 1.0, 1e-4, h, method="fft"), J_OPS[dim](3, 1.0, 1e-4, h,
                                                                      method="fft")
    lam = TS.operator_symbol(op, shape)
    assert np.array_equal(lam, JS.operator_symbol(jop, shape))
    assert lam.flat[0] == pytest.approx(0.0, abs=1e-7)
    assert lam.max() <= 1e-7


# 1D: shift; 2D: conv, shift, sat, cuda (the plain versions here); 3D: shift, sat, cuda
STENCILS = {1: ("shift",), 2: ("conv", "shift", "sat", "cuda"), 3: ("shift", "sat", "cuda")}


@pytest.mark.parametrize("dim,eps,shape", [
    (1, 5, (50,)), (1, 3, (31,)), (1, 8, (20,)),
    (2, 4, (24, 24)), (2, 9, (20, 28)), (2, 1, (7, 5)),
    (3, 3, (12, 12, 12)), (3, 2, (9, 7, 10)),
])
def test_fft_apply_matches_jax_and_the_stencils(dim, eps, shape):
    h = 1.0 / shape[0]
    op = T_OPS[dim](eps, 1.0, 1e-5, h, method="fft")
    jop = J_OPS[dim](eps, 1.0, 1e-5, h, method="fft")
    u = np.random.default_rng(dim + eps).normal(size=shape)
    ut = torch.from_numpy(u)
    nsum = TS.neighbor_sum_fft(op, ut)
    assert nsum.dtype == torch.float64 and tuple(nsum.shape) == shape
    assert _rel(nsum, JS.neighbor_sum_fft(jop, jnp.asarray(u))) <= 1e-12
    assert _rel(TS.neighbor_sum_fft_np(op, u), JS.neighbor_sum_fft_np(jop, u)) <= 1e-12
    got = op.apply(ut)
    want = jop.apply_np(u)
    assert _rel(got, np.asarray(jop.apply(jnp.asarray(u)))) <= 1e-12
    assert _rel(got, want) <= 1e-12
    for method in STENCILS[dim]:
        assert _rel(got, op.with_method(method).apply(ut)) <= 1e-12, method


def test_weighted_influence_keeps_fft_and_matches_jax():
    J = lambda r: math.exp(-r)  # noqa: E731
    u = np.random.default_rng(4).normal(size=(16, 14))
    op = NonlocalOp2D(3, 1.0, 1e-4, 0.05, influence=J, method="fft")
    jop = JaxOp2D(3, 1.0, 1e-4, 0.05, influence=J, method="fft")
    assert op.method == jop.method == "fft"
    assert _rel(op.apply(torch.from_numpy(u)), jop.apply_np(u)) <= 1e-12
    u3 = np.random.default_rng(5).normal(size=(7, 6, 8))
    op3 = NonlocalOp3D(2, 1.0, 1e-4, 0.05, influence=J, method="fft")
    jop3 = JaxOp3D(2, 1.0, 1e-4, 0.05, influence=J, method="shift")
    assert op3.method == "fft"
    assert _rel(op3.apply(torch.from_numpy(u3)), jop3.apply_np(u3)) <= 1e-12


def test_fft_refuses_padded_blocks_in_jax_words():
    op = NonlocalOp2D(3, 1.0, 1e-4, 0.02, method="fft")
    for call in (op.neighbor_sum_padded, op.apply_padded):
        with pytest.raises(ValueError, match="whole-domain") as e:
            call(torch.zeros(20, 20))
        assert "halo-padded block evaluation" in str(e.value)
    op3 = NonlocalOp3D(2, 1.0, 1e-4, 0.05, method="fft")
    for call in (op3.neighbor_sum_padded, op3.apply_padded):
        with pytest.raises(ValueError, match="whole-domain"):
            call(torch.zeros(12, 12, 12))
    jop = JaxOp2D(3, 1.0, 1e-4, 0.02, method="fft")
    with pytest.raises(ValueError) as je:
        jop.neighbor_sum_padded(jnp.zeros((20, 20)))
    with pytest.raises(ValueError) as te:
        op.neighbor_sum_padded(torch.zeros(20, 20))
    # the JAX message with the port's kernel method in place of pallas
    assert str(te.value) == str(je.value).replace("pallas", "cuda")


def test_auto_never_resolves_to_fft_and_methods_are_checked():
    for cls in (NonlocalOp2D, NonlocalOp3D):
        op = cls(2, 1.0, 1e-4, 0.05)
        assert op.resolve_method(torch.device("cpu")) != "fft"
        assert op.resolve_method(torch.device("cuda")) == "cuda"
        assert op.with_method("fft").resolve_method(torch.device("cuda")) == "fft"
    with pytest.raises(ValueError, match="unknown method 'pallas'"):
        NonlocalOp1D(5, 1.0, 1e-3, 0.02, method="pallas")
    with pytest.raises(ValueError, match="unknown method 'conv'"):
        NonlocalOp3D(2, 1.0, 1e-3, 0.02, method="conv")


def test_fft_applies_counter_and_f32_spectrum():
    counter = REGISTRY.counter("/op/fft-applies")
    before = counter.value
    op = NonlocalOp2D(4, 1.0, 1e-4, 1.0 / 32, method="fft")
    u = np.random.default_rng(6).normal(size=(32, 30))
    got32 = op.apply(torch.from_numpy(u.astype(np.float32)))
    assert counter.value == before + 1
    # the symbol is cast to the spectrum's real dtype: an f32 state stays f32
    assert got32.dtype == torch.float32
    key = next(k for k in TS._device_symbols if k[2] == torch.float32)
    assert TS._device_symbols[key].dtype == torch.float32
    assert _rel(got32.double(), op.apply(torch.from_numpy(u))) <= 1e-5
    assert counter.value == before + 2


def test_bf16_tier_fft_reads_the_rounded_state():
    u = np.random.default_rng(7).normal(size=(20, 18)).astype(np.float32)
    op = NonlocalOp2D(3, 1.0, 1e-4, 0.05, method="fft", precision="bf16")
    jop = JaxOp2D(3, 1.0, 1e-4, 0.05, method="fft", precision="bf16")
    assert _rel(op.apply(torch.from_numpy(u)), np.asarray(jop.apply(jnp.asarray(u)))) <= 1e-5
