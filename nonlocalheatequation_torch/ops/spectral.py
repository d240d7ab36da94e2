"""Spectral (FFT) evaluation of the nonlocal operator — counterpart of
``nonlocalheatequation_tpu/ops/spectral.py``.

On the uniform grid the horizon operator is a convolution with a fixed
eps-ball stencil, so the DFT of a periodic box diagonalizes it: an
O(N log N) apply whose cost does not depend on eps, where the stencil paths
pay O(N * eps^d).

Volumetric boundary (u = 0 outside the domain): the (n_1, ..., n_d) grid is
embedded in a zero-padded periodic box of N_a >= n_a + eps points per axis.
Every read an interior point makes at an offset |o| <= eps lands in the
domain or in the zero collar, wrapped reads included (index -j wraps to
N - j >= n), so the circular convolution over the box equals the
volumetric-boundary operator; the interior of the inverse transform is the
answer.  Box edges round up to the next 5-smooth integer.

The neighbour-sum symbol ``sigma(xi) = sum_o w_o cos(xi . o)`` is computed
once per (weights, box) in NumPy float64 on the host (the real part of the
rfftn of the centered kernel's embedding; :func:`symbol_direct` is the
literal cosine sum the tests hold it to) and copied once per (device,
dtype).  The transforms are ``torch.fft.rfftn``/``irfftn`` on the state's
own device (cuFFT on the card), the counterpart of the XLA FFT the JAX
package lowers to: no hand-written kernel stands behind this path there
either.  ``lambda(xi) = c*h^d * (sigma(xi) - Wsum)``, the operator's symbol,
is <= 0 everywhere and 0 at DC: the exponential stepper
(models/steppers.py) exponentiates it.

The embedding is exact for one application with the collar zero, which is
what the whole-domain entry points do, so ``method='fft'`` holds the same
<= 1e-12 contract as the stencil methods (not bitwise: the transform
reassociates every sum).  A halo-padded block's halo carries neighbour data,
not zeros, so the padded entry points refuse fft (ops/nonlocal_op.py).
"""

from __future__ import annotations

import numpy as np
import torch

from nonlocalheatequation_torch.obs.metrics import REGISTRY

#: Host float64 symbols, keyed by (weights bytes, weights shape, box); the
#: physics scalars stay outside, so one symbol serves every operator that
#: shares a stencil.
_symbol_cache: dict = {}
#: The symbols on a device: (host key, device, real dtype) -> tensor.
_device_symbols: dict = {}

#: Operator applications that entered the fft path (one per eager call: the
#: port runs no traced programs).
_fft_applies = REGISTRY.counter("/op/fft-applies")


def fft_size(n: int) -> int:
    """Smallest 5-smooth integer >= n (an FFT-friendly box edge)."""
    if n <= 1:
        return 1
    best = None
    p2 = 1
    while p2 < 2 * n:
        p23 = p2
        while p23 < 2 * n:
            p235 = p23
            while p235 < n:
                p235 *= 5
            if best is None or p235 < best:
                best = p235
            p23 *= 3
        p2 *= 2
    return best


def fft_box(shape, eps: int) -> tuple:
    """The periodic box of a grid of ``shape`` and horizon ``eps``: per axis
    the smallest 5-smooth size >= n + eps."""
    return tuple(fft_size(int(n) + int(eps)) for n in shape)


def _kernel_embedding(weights: np.ndarray, box: tuple) -> np.ndarray:
    """The centered offset kernel in the periodic box: offset o in
    [-eps, eps] sits at index (o mod N) per axis."""
    w = np.asarray(weights, np.float64)
    eps = (w.shape[0] - 1) // 2
    k = np.zeros(box, np.float64)
    idx = tuple((np.arange(-eps, eps + 1) % n) for n in box)
    k[np.ix_(*idx)] = w
    return k


def _symbol_key(weights, box) -> tuple:
    w = np.asarray(weights, np.float64)
    return (w.tobytes(), tuple(w.shape), tuple(box))


def neighbor_symbol(weights: np.ndarray, box: tuple) -> np.ndarray:
    """sigma(xi) = sum_o w_o cos(xi . o) on the rfftn frequency grid of
    ``box``, NumPy float64.  The kernel is real and even, so its transform
    is real; the rounding residue of the imaginary part is dropped."""
    key = _symbol_key(weights, box)
    sig = _symbol_cache.get(key)
    if sig is None:
        sig = np.ascontiguousarray(np.fft.rfftn(_kernel_embedding(weights, box)).real)
        _symbol_cache[key] = sig
    return sig


def symbol_on(weights, box: tuple, device, dtype) -> torch.Tensor:
    """:func:`neighbor_symbol` as a tensor of real ``dtype`` on ``device``,
    copied there once."""
    key = (_symbol_key(weights, box), torch.device(device), dtype)
    sig = _device_symbols.get(key)
    if sig is None:
        sig = torch.as_tensor(neighbor_symbol(weights, box)).to(device=device, dtype=dtype)
        _device_symbols[key] = sig
    return sig


def symbol_direct(weights: np.ndarray, box: tuple) -> np.ndarray:
    """The literal cosine sum sigma(xi) = sum_o w_o cos(xi . o) over the
    rfftn frequency grid, O(#offsets * #frequencies): the form the baked
    symbol is held to."""
    w = np.asarray(weights, np.float64)
    eps = (w.shape[0] - 1) // 2
    d = w.ndim
    freq_shape = tuple(box[:-1]) + (box[-1] // 2 + 1,)
    xi = [2.0 * np.pi * np.arange(freq_shape[a]) / n for a, n in enumerate(box)]
    sig = np.zeros(freq_shape, np.float64)
    for o_flat, wo in np.ndenumerate(w):
        if wo == 0.0:
            continue
        phase = np.zeros(freq_shape, np.float64)
        for a in range(d):
            shape_a = [1] * d
            shape_a[a] = freq_shape[a]
            phase = phase + (xi[a] * (o_flat[a] - eps)).reshape(shape_a)
        sig += wo * np.cos(phase)
    return sig


def operator_symbol(op, shape) -> np.ndarray:
    """lambda(xi) = c*h^d * (sigma(xi) - Wsum) of ``op`` on a grid of
    ``shape``: the operator's exact spectrum on the padded box, float64."""
    from nonlocalheatequation_torch.ops.nonlocal_op import case_scale

    box = fft_box(shape, op.eps)
    return case_scale(op) * (neighbor_symbol(op.weights, box) - op.wsum)


def neighbor_sum_fft(op, u: torch.Tensor) -> torch.Tensor:
    """The eps-ball neighbour sum of an unpadded domain tensor through the
    padded box's rFFT on ``u``'s device: the transform zero-pads to the box,
    the spectrum is scaled by the symbol in the spectrum's real dtype (f32
    for complex64, f64 for complex128), and the interior of the inverse is
    the sum."""
    _fft_applies.inc()
    box = fft_box(u.shape, op.eps)
    uh = torch.fft.rfftn(u, s=box)
    sig = symbol_on(op.weights, box, u.device, uh.real.dtype)
    out = torch.fft.irfftn(uh * sig, s=box)
    return out[tuple(slice(0, n) for n in u.shape)]


def neighbor_sum_fft_np(op, u: np.ndarray) -> np.ndarray:
    """NumPy float64 twin of :func:`neighbor_sum_fft`."""
    box = fft_box(u.shape, op.eps)
    sig = neighbor_symbol(op.weights, box)
    up = np.zeros(box, np.float64)
    up[tuple(slice(0, s) for s in u.shape)] = u
    out = np.fft.irfftn(np.fft.rfftn(up) * sig, s=box, axes=tuple(range(-len(box), 0)))
    return out[tuple(slice(0, s) for s in u.shape)]
