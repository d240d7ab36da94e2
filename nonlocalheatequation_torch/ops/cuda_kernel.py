"""The 2D kernels of the port: wrappers, plain versions, makers and launch
counts.

Counterpart of ``nonlocalheatequation_tpu/ops/pallas_kernel.py`` for the
main path.  Five Pallas kernels are replaced by hand-written CUDA kernels
(csrc/, on the sums of csrc/stencil_tile.cuh):

* :func:`nsum2d` replaces ``build_neighbor_sum_2d`` (pallas_kernel.py:468):
  the masked-circle neighbour sum of a halo-padded ``(nx+2e, ny+2e)``
  block, returning ``(nx, ny)`` (csrc/nsum2d.cu, the tile body).
* :func:`step2d` replaces ``_build_step_kernel`` (pallas_kernel.py:515, via
  ``make_pallas_step_fn`` :1601): one fused forward-Euler step
  ``u + dt*(scale*(nsum - wsum*u) [+ b_t])`` on the UNPADDED state (the
  kernel reads out-of-domain cells as 0), with the manufactured source
  ``b_t = coef_g*G + coef_lg*L(G)`` whose coefficients come from the host
  from the integer step.  It is one ``batched_step2d`` launch at B=1
  (csrc/batched_step2d.cu: the register walk up to eps 16).
* :func:`carried2d` replaces ``_build_carried_kernel`` (:856): one step of
  the state kept in a halo-padded frame.  It is one ``batched_carried2d``
  launch at B=1 (csrc/batched_carried2d.cu), which writes the interior
  only; in the bf16 tier it rounds the frame as it stages it, so no shadow
  frame is kept.
* :func:`superstep2d` replaces ``_build_superstep_kernel`` (:1032): K steps
  per launch by trapezoidal temporal blocking.
* :func:`resident2d` replaces ``_build_resident_kernel`` (:1292): the whole
  run in one cooperative launch, the state ping-ponging between two frames
  (:func:`resident_frame`, kept in the L2) and summed up to eps 16 by the
  register walk's sums on a lattice of 4*RUN x 32 tiles, RUN chosen per
  grid by csrc/resident2d.cu.

The solo step kernels read (scale, dt) and the test form's (coef_g,
coef_lg) from one-row device tables, made once and cached
(:func:`_params_row`, :func:`_coef_row`), so a loop of steps copies
nothing from the host per step.  The multi-step kernels take the
production (source-free) step and are bit-identical to the same number of
``step2d`` launches.  Their makers ``make_carried_multi_step_fn``,
``make_superstep_multi_step_fn`` and ``make_resident_multi_step_fn``, and
the gates ``fits_superstep``, ``fits_resident`` and ``superstep_k``, keep
the JAX package's names.

Each wrapper checks its arguments, allocates its output with
``torch.empty`` (or writes into a caller's buffer), launches on the current
stream, raises on a non-zero launch status and counts the launch in
:data:`LAUNCHES` under its own name.  A CPU tensor goes to the plain
version beside it (plain PyTorch: shifted slice-adds over the mask, as the
reference package's ``_neighbor_sum_shift``; for a multi-step kernel, the
per-step plain loop in the kernel's frame bookkeeping); a CUDA tensor
launches the kernel or raises.  The plain versions are what the CPU tests
hold against the JAX package and what ``chip_smoke.py`` holds the kernels
against on the card.
"""

from __future__ import annotations

import ctypes
import math
from collections import OrderedDict

import torch
import torch.nn.functional as F

from nonlocalheatequation_torch.ops import _build
from nonlocalheatequation_torch.ops.constants import validate_precision
from nonlocalheatequation_torch.ops.stencil import column_half_heights, sphere_column_heights

TWO_PI = 2.0 * math.pi
SOURCE = "nsum2d.cu"

#: kernel name -> launches since the last reset_launch_counts() (the 3D
#: kernels' wrappers live in ops/cuda_kernel3d.py, the batched 2D kernels'
#: in ops/cuda_batched.py, the unstructured kernels' in
#: ops/cuda_unstructured.py, the split halo kernels' in ops/cuda_halo.py)
LAUNCHES = {"nsum2d": 0, "step2d": 0, "carried2d": 0, "superstep2d": 0, "resident2d": 0,
            "nsum3d": 0, "step3d": 0, "carried3d": 0, "resident3d": 0,
            "batched_step2d": 0, "batched_carried2d": 0, "batched_superstep2d": 0,
            "windowed_matvec": 0, "gather_L": 0, "split_nsum2d": 0, "split_nsum3d": 0,
            "fused_nsum2d": 0, "fused_nsum3d": 0}
#: kernel name of LAUNCHES -> the source in csrc/ whose library launches it
#: (the program store names the libraries a program launched by it)
LAUNCH_SOURCES = {name: f"{name}.cu" for name in LAUNCHES}
LAUNCH_SOURCES.update({"step2d": "batched_step2d.cu", "carried2d": "batched_carried2d.cu",
                       "step3d": "nsum3d.cu"})

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: C entry point -> (source in csrc/, argument types); each returns an int
_ENTRIES = {
    "nlheat_nsum2d": ("nsum2d.cu", [_I, _I, _P, _P, _I, _I, _I, _P]),
    "nlheat_superstep2d": ("superstep2d.cu", [_I, _I, _P, _P, _I, _I, _I, _I, _D, _D, _D,
                                              _P]),
    "nlheat_superstep2d_fits": ("superstep2d.cu", [_I, _I, _I, _I]),
    "nlheat_resident2d": ("resident2d.cu", [_I, _P, _P, _I, _I, _I, _I, _I, _D, _D, _D, _P]),
    "nlheat_resident2d_fits": ("resident2d.cu", [_I, _I, _I, _I]),
    "nlheat_nsum3d": ("nsum3d.cu", [_I, _I, _P, _P, _I, _I, _I, _I, _P]),
    "nlheat_step3d": ("nsum3d.cu", [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _D, _D,
                                    _D, _P]),
    "nlheat_tile3d": ("nsum3d.cu", [_I, _I]),
    "nlheat_carried3d": ("carried3d.cu", [_I, _P, _P, _I, _I, _I, _I, _D, _D, _D, _P]),
    "nlheat_resident3d": ("resident3d.cu", [_I, _P, _P, _I, _I, _I, _I, _I, _I, _D, _D, _D,
                                            _P]),
    "nlheat_resident3d_fits": ("resident3d.cu", [_I, _I, _I, _I, _I]),
    "nlheat_batched_step2d": ("batched_step2d.cu", [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                                    _I, _I, _D, _P]),
    "nlheat_batched_carried2d": ("batched_carried2d.cu", [_I, _I, _P, _P, _P, _I, _I, _I, _I,
                                                          _D, _P]),
    "nlheat_batched_superstep2d": ("batched_superstep2d.cu", [_I, _I, _P, _P, _P, _I, _I, _I,
                                                              _I, _I, _D, _P]),
    "nlheat_batched_superstep2d_fits": ("batched_superstep2d.cu", [_I, _I, _I, _I]),
    "nlheat_windowed_matvec": ("windowed_matvec.cu", [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                                      _I, _P]),
    "nlheat_gather_L": ("gather_L.cu", [_I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P]),
    "nlheat_split_nsum2d": ("split_nsum2d.cu", [_I, _I, _P, _P, _I, _I, _I, _I, _P]),
    "nlheat_split_nsum3d": ("split_nsum3d.cu", [_I, _I, _P, _P, _I, _I, _I, _I, _I, _P]),
    "nlheat_fused_nsum2d": ("fused_nsum2d.cu", [_I, _I, _P, _I, _I, _P, _I, _I, _I, _P]),
    "nlheat_fused_nsum3d": ("fused_nsum3d.cu", [_I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I,
                                                _P]),
    "nlheat_enable_peer": ("fused_nsum2d.cu", [_I, _I]),
}
_entries: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _entry(name: str):
    """The C entry point ``name``; its library is built and loaded at first use."""
    fn = _entries.get(name)
    if fn is None:
        source, argtypes = _ENTRIES[name]
        fn = getattr(_build.load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def source_coefs(t: int, dt: float) -> tuple:
    """(coef_g, coef_lg) of b_t = -2*pi*sin(2*pi*t*dt)*G - cos(2*pi*t*dt)*L(G),
    computed on the host in float64."""
    ang = TWO_PI * (t * dt)
    return -TWO_PI * math.sin(ang), -math.cos(ang)


def to_device(host: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``.  On the card the copy is non-blocking
    from page-locked memory: a copy from pageable memory synchronises the
    stream, so a table made while earlier chunks run would wait for their
    kernels (the serving pipeline's overlap, serve/server.py).  PyTorch's
    page-locked allocator keeps the buffer until the copy has run."""
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def case_params(scales, dts, dtype, device) -> torch.Tensor:
    """The ``(B, 2)`` table of each case's (scale, dt): the host floats
    rounded once to ``dtype``, as a kernel rounds a by-value argument."""
    pairs = [[float(s), float(d)] for s, d in zip(scales, dts, strict=True)]
    return to_device(torch.tensor(pairs, dtype=torch.float64).to(dtype), device)


def source_coef_table(ts, dts, dtype, device) -> torch.Tensor:
    """The ``(len(ts), B, 2)`` table of each case's test-source coefficients
    (coef_g, coef_lg) at each integer step of ``ts``: ``source_coefs`` in
    float64 on the host, rounded once to ``dtype`` and copied once."""
    rows = [[list(source_coefs(t, float(dt))) for dt in dts] for t in ts]
    return to_device(torch.tensor(rows, dtype=torch.float64).reshape(
        len(rows), len(dts), 2).to(dtype), device)


#: the solo step kernels' device tables, least recently used first; a
#: CUDA graph captured over step2d/carried2d reads its tables, so it stays
#: valid while they are among the _TABLES_KEPT most recently used
_TABLES: OrderedDict = OrderedDict()
_TABLES_KEPT = 256
#: steps of test-source coefficients one table holds (one copy per so many steps)
COEF_ROWS = 256


def _table(key, make) -> torch.Tensor:
    """The cached table ``key``, made by ``make()`` (one host-to-device copy)
    the first time it is asked for."""
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = make()
        if len(_TABLES) > _TABLES_KEPT:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    return table


def _params_row(scale: float, dt: float, like: torch.Tensor) -> torch.Tensor:
    """The ``(1, 2)`` (scale, dt) table of one solo step on ``like``'s dtype
    and device, made once."""
    scale, dt = float(scale), float(dt)
    return _table(("params", scale, dt, like.dtype, like.device),
                  lambda: case_params([scale], [dt], like.dtype, like.device))


def _coef_row(t: int, dt: float, like: torch.Tensor) -> torch.Tensor:
    """The ``(1, 2)`` (coef_g, coef_lg) row of integer step ``t``: a view of
    a table of COEF_ROWS steps from a multiple of COEF_ROWS, made once, so
    a loop of test-form steps copies once per COEF_ROWS steps."""
    t, dt = int(t), float(dt)
    t0 = t - t % COEF_ROWS
    table = _table(("coefs", t0, dt, like.dtype, like.device),
                   lambda: source_coef_table(range(t0, t0 + COEF_ROWS), [dt], like.dtype,
                                             like.device))
    return table[t - t0]


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 storage rounding, upcast back to the accumulate dtype."""
    return shadow_of(x).to(x.dtype)


def shadow_of(x: torch.Tensor) -> torch.Tensor:
    """The bfloat16 rounding of a state, as the kernels round: through
    float32, to nearest even."""
    return x.to(torch.float32).to(torch.bfloat16)


# -- plain versions -----------------------------------------------------------

def disc_sum(upad: torch.Tensor, eps: int) -> torch.Tensor:
    """The masked-disc sum of the halo-padded ``(..., nx+2e, ny+2e)`` block(s)
    in the tile body's order (csrc/stencil_tile.cuh), so that the kernels
    give its bits: every window row's column sums ``W_h = (W_{h-1} +
    row[-h]) + row[+h]`` grow one pair of columns per height, and each
    output adds ``W_{h_i}`` of its x offsets i, heights ascending, then i
    ascending, from 0."""
    e = int(eps)
    nx, ny = upad.shape[-2] - 2 * e, upad.shape[-1] - 2 * e
    acc = torch.zeros((*upad.shape[:-2], nx, ny), dtype=upad.dtype, device=upad.device)
    heights = [int(h) for h in column_half_heights(e)]
    W = upad[..., e:e + ny]
    for h in range(e + 1):
        if h:
            W = (W + upad[..., e - h:e - h + ny]) + upad[..., e + h:e + h + ny]
        for i in range(2 * e + 1):
            if heights[i] == h:
                acc = acc + W[..., i:i + nx, :]
    return acc


def sphere_sum(upad: torch.Tensor, eps: int) -> torch.Tensor:
    """The masked-sphere sum of the halo-padded ``(nx+2e, ny+2e, nz+2e)``
    block in the 3D tile body's order (csrc/stencil_tile3d.cuh, csrc/nsum3d.cu),
    so that the kernels give its bits: every window line's z sums ``W_h =
    (W_{h-1} + line[-h]) + line[+h]`` grow one pair of cells per height, and
    each output adds ``W_{h(i,j)}`` of its plane offsets (i, j), heights
    ascending, then (i, j) ascending, from 0."""
    e = int(eps)
    nx, ny, nz = (s - 2 * e for s in upad.shape)
    acc = torch.zeros((nx, ny, nz), dtype=upad.dtype, device=upad.device)
    heights = sphere_column_heights(e)
    W = upad[..., e:e + nz]
    for h in range(e + 1):
        if h:
            W = (W + upad[..., e - h:e - h + nz]) + upad[..., e + h:e + h + nz]
        for i in range(2 * e + 1):
            for j in range(2 * e + 1):
                if heights[i, j] == h:
                    acc = acc + W[i:i + nx, j:j + ny]
    return acc


def nsum2d_plain(upad: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """Neighbour sum of a halo-padded block (:func:`disc_sum`)."""
    if precision == "bf16":
        upad = bf16_round(upad)
    return disc_sum(upad, eps)


def step2d_plain(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float, *,
                 g: torch.Tensor | None = None, lg: torch.Tensor | None = None,
                 t: int = 0, precision: str = "f32") -> torch.Tensor:
    """One forward-Euler step with zero extension outside the domain, in the
    kernel's arithmetic order."""
    opnd = bf16_round(u) if precision == "bf16" else u
    return _euler_plain(opnd, u, eps, scale, wsum, dt, g=g, lg=lg, t=t)


def _euler_plain(opnd, carry, eps, scale, wsum, dt, *, g=None, lg=None, t=0):
    """carry + dt*(scale*(nsum(opnd) - wsum*opnd) [+ b_t]) with zero extension:
    the tile body's epilogue (csrc/stencil_tile.cuh), one rounding per
    operation."""
    e = int(eps)
    acc = nsum2d_plain(F.pad(opnd, (e, e, e, e)), e)
    du = scale * (acc - wsum * opnd)
    if g is not None:
        coef_g, coef_lg = source_coefs(t, dt)
        du = du + coef_g * g
        du = du + coef_lg * lg
    return carry + dt * du


# -- kernel wrappers ------------------------------------------------------------

def _check_state(name: str, x: torch.Tensor, shape, like: torch.Tensor | None = None):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32, float64)")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)} != {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    if like is not None and (x.dtype != like.dtype or x.device != like.device):
        raise ValueError(f"{name}: {x.dtype} on {x.device} does not match "
                         f"{like.dtype} on {like.device}")


def _check_device(x: torch.Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got {x.device}")


def _raise_on(rc: int, what: str, eps: int, x: torch.Tensor,
              remedy: str = "use method='conv' for this horizon", entry: str | None = None):
    """Turn a C entry point's status into an exception: -1 is the kernel
    library's refusal (eps, the shared-memory tile or the grid beyond its
    limits, which its source in csrc/ alone decides), anything else non-zero
    is cudaGetLastError().  ``entry`` is the C entry point that ran, by
    default ``nlheat_<what>``."""
    if rc == -1:
        raise ValueError(
            f"{what}: eps={eps} on a {tuple(x.shape)} {x.dtype} tensor is beyond what "
            f"the kernel takes (its eps, shared-memory or grid limit, "
            f"csrc/{_ENTRIES[entry or 'nlheat_' + what][0]}); {remedy}")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaGetLastError {rc}")


def _buffer(name: str, buf: torch.Tensor | None, like: torch.Tensor, dtype, inputs):
    """``buf`` checked (shape, dtype, device, contiguity, no overlap with
    ``inputs``), or a new ``torch.empty`` buffer."""
    if buf is None:
        return torch.empty(like.shape, dtype=dtype, device=like.device)
    if (tuple(buf.shape) != tuple(like.shape) or buf.dtype != dtype
            or buf.device != like.device or not buf.is_contiguous()):
        raise ValueError(f"{name}: needs a contiguous {tuple(like.shape)} {dtype} buffer on "
                         f"{like.device}, got {tuple(buf.shape)} {buf.dtype} on {buf.device}")
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel() * buf.element_size()
    for x in inputs:
        if x is not None and x.numel() and lo < x.data_ptr() + x.numel() * x.element_size() \
                and x.data_ptr() < hi:
            raise ValueError(f"{name} overlaps an input (the step reads neighbours of "
                             "every point it writes)")
    return buf


def _zero_halo(frame: torch.Tensor, eps: int, ndim: int) -> torch.Tensor:
    """``frame`` with the eps-wide halo of its last ``ndim`` axes set to zero
    in place, its interior left as it was."""
    if eps:
        for d in range(frame.dim() - ndim, frame.dim()):
            frame.narrow(d, 0, eps).zero_()
            frame.narrow(d, frame.shape[d] - eps, eps).zero_()
    return frame


def nsum2d(upad: torch.Tensor, eps: int, precision: str = "f32") -> torch.Tensor:
    """(nx+2e, ny+2e) halo-padded block -> (nx, ny) masked-circle neighbour
    sum.  ``precision="bf16"`` rounds the operand to bfloat16 at the load
    and accumulates in the block's dtype."""
    eps = int(eps)
    validate_precision(precision)
    if upad.dim() != 2 or upad.shape[0] < 2 * eps or upad.shape[1] < 2 * eps:
        raise ValueError(f"nsum2d: padded block {tuple(upad.shape)} too small for eps={eps}")
    if upad.device.type == "cpu":
        return nsum2d_plain(upad, eps, precision)
    nx, ny = upad.shape[0] - 2 * eps, upad.shape[1] - 2 * eps
    _check_state("nsum2d upad", upad, upad.shape)
    _check_device(upad)
    out = torch.empty((nx, ny), dtype=upad.dtype, device=upad.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(upad.device):
        rc = _entry("nlheat_nsum2d")(
            _DTYPE_CODE[upad.dtype], int(precision == "bf16"), upad.data_ptr(),
            out.data_ptr(), nx, ny, eps, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "nsum2d", eps, upad)
    LAUNCHES["nsum2d"] += 1
    return out


def step2d(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float, *,
           g: torch.Tensor | None = None, lg: torch.Tensor | None = None, t: int = 0,
           precision: str = "f32", out: torch.Tensor | None = None) -> torch.Tensor:
    """One fused forward-Euler step of the unpadded state ``u`` (nx, ny):
    ``u + dt*(scale*(nsum - wsum*u) + b_t)``, with the test source when
    ``g``/``lg`` are given (``t`` is the integer step).  ``out`` is an
    optional preallocated (nx, ny) buffer that must not overlap ``u``."""
    eps = int(eps)
    validate_precision(precision)
    if (g is None) != (lg is None):
        raise ValueError("step2d: pass both g and lg (test form) or neither")
    if u.dim() != 2:
        raise ValueError(f"step2d: state must be 2D, got shape {tuple(u.shape)}")
    if u.device.type == "cpu":
        nxt = step2d_plain(u, eps, scale, wsum, dt, g=g, lg=lg, t=t, precision=precision)
        return nxt if out is None else out.copy_(nxt)
    nx, ny = u.shape
    _check_state("step2d u", u, u.shape)
    _check_device(u)
    if g is not None:
        _check_state("step2d g", g, u.shape, like=u)
        _check_state("step2d lg", lg, u.shape, like=u)
    out = _buffer("step2d out", out, u, u.dtype, (u,))
    if u.numel() == 0:
        return out
    # one csrc/batched_step2d.cu launch at B=1, (scale, dt) and the test
    # form's (coef_g, coef_lg) read from cached (1, 2) device tables
    coefs = None if g is None else _coef_row(t, dt, u)
    params = _params_row(scale, dt, u)
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_batched_step2d")(
            _DTYPE_CODE[u.dtype], int(precision == "bf16"), u.data_ptr(), out.data_ptr(),
            None if g is None else g.data_ptr(), None if lg is None else lg.data_ptr(),
            None if coefs is None else coefs.data_ptr(), params.data_ptr(), 1, nx, ny, eps,
            float(wsum), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "step2d", eps, u, entry="nlheat_batched_step2d")
    LAUNCHES["step2d"] += 1
    return out


# -- multi-step kernels: plain versions -------------------------------------------

def carried2d_plain(frame: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
                    shadow: torch.Tensor | None = None):
    """One production step of the halo-padded frame: the next frame with a
    zero halo, and with ``shadow`` (the bf16 tier) the pair (next frame, its
    bf16 shadow).  The window reads the shadow, the carry the frame."""
    e = int(eps)
    nx, ny = frame.shape[0] - 2 * e, frame.shape[1] - 2 * e
    master = frame[e:e + nx, e:e + ny]
    opnd = master if shadow is None else shadow[e:e + nx, e:e + ny].to(frame.dtype)
    nxt = F.pad(_euler_plain(opnd, master, e, scale, wsum, dt), (e, e, e, e))
    return nxt if shadow is None else (nxt, shadow_of(nxt))


def superstep2d_plain(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
                      ksteps: int, precision: str = "f32") -> torch.Tensor:
    """``ksteps`` production steps of the unpadded state, one plain step each."""
    for _ in range(int(ksteps)):
        u = step2d_plain(u, eps, scale, wsum, dt, precision=precision)
    return u


def resident_pitch(n: int, eps: int, dtype) -> int:
    """The last axis of a resident kernel's frame for a state whose last axis
    is ``n``: ``n + 2*eps`` cells padded to a multiple of 16 bytes, so that
    csrc/resident2d.cu and csrc/resident3d.cu stage every window by 16-byte
    copies."""
    per = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-(int(n) + 2 * int(eps)) // per) * per


def resident_frame(u: torch.Tensor, eps: int) -> torch.Tensor:
    """A resident kernel's frame of the 2D or 3D state ``u``: zero
    everywhere but its interior, which holds ``u``, ``eps`` cells from the
    start of every axis; ``eps`` cells of halo after it on every axis but
    the last, which is :func:`resident_pitch` long."""
    e = int(eps)
    extra = resident_pitch(u.shape[-1], e, u.dtype) - u.shape[-1] - 2 * e
    return F.pad(u, (e, e + extra) + (e, e) * (u.dim() - 1)).contiguous()


def resident2d_plain(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
                     nsteps: int) -> torch.Tensor:
    """``nsteps`` production steps, the state kept in a zero-halo frame."""
    e = int(eps)
    nx, ny = u.shape
    frame = F.pad(u, (e, e, e, e))
    for _ in range(int(nsteps)):
        inner = frame[e:e + nx, e:e + ny]
        frame = F.pad(_euler_plain(inner, inner, e, scale, wsum, dt), (e, e, e, e))
    return frame[e:e + nx, e:e + ny].contiguous()


# -- multi-step kernels: wrappers -------------------------------------------------

def carried2d(frame: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
              precision: str = "f32", out: torch.Tensor | None = None) -> torch.Tensor:
    """One production step of the state kept in a halo-padded
    ``(nx+2e, ny+2e)`` frame: returns the next frame, its halo zero.
    ``precision="bf16"`` runs the bf16 tier: the operand is the frame's
    :func:`shadow_of`, rounded from the master as the window is staged.
    ``out`` is an optional buffer that must not overlap ``frame``; its halo
    is zeroed here."""
    eps = int(eps)
    validate_precision(precision)
    if frame.dim() != 2 or frame.shape[0] < 2 * eps or frame.shape[1] < 2 * eps:
        raise ValueError(f"carried2d: frame {tuple(frame.shape)} too small for eps={eps}")
    if frame.device.type != "cpu":
        out = (torch.zeros_like(frame) if out is None else _zero_halo(
            _buffer("carried2d out", out, frame, frame.dtype, (frame,)), eps, 2))
    return _carried2d(frame, out, eps, scale, wsum, dt, precision)


def _carried2d(frame, out, eps: int, scale: float, wsum: float, dt: float, precision: str):
    """:func:`carried2d` into ``out``, whose halo must already be zero on the
    card: one csrc/batched_carried2d.cu launch at B=1, which writes the
    interior only.  The multi-step maker's two frames, made with zero halos,
    keep them."""
    if frame.device.type == "cpu":
        res = carried2d_plain(frame, eps, scale, wsum, dt,
                              shadow_of(frame) if precision == "bf16" else None)
        res = res if precision != "bf16" else res[0]
        return res if out is None else out.copy_(res)
    _check_state("carried2d frame", frame, frame.shape)
    _check_device(frame)
    nx, ny = frame.shape[0] - 2 * eps, frame.shape[1] - 2 * eps
    if nx <= 0 or ny <= 0:  # no interior: the next frame is all halo
        return out.zero_()
    params = _params_row(scale, dt, frame)
    with torch.cuda.device(frame.device):
        rc = _entry("nlheat_batched_carried2d")(
            _DTYPE_CODE[frame.dtype], int(precision == "bf16"), frame.data_ptr(),
            out.data_ptr(), params.data_ptr(), 1, nx, ny, eps, float(wsum),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "carried2d", eps, frame, entry="nlheat_batched_carried2d")
    LAUNCHES["carried2d"] += 1
    return out


def superstep2d(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
                ksteps: int, precision: str = "f32",
                out: torch.Tensor | None = None) -> torch.Tensor:
    """``ksteps`` production steps of the unpadded state ``u`` (nx, ny) in
    one launch, by trapezoidal temporal blocking (csrc/superstep2d.cu takes
    K up to 4).  ``out`` is an optional (nx, ny) buffer that must not
    overlap ``u``."""
    eps, ksteps = int(eps), int(ksteps)
    validate_precision(precision)
    if u.dim() != 2:
        raise ValueError(f"superstep2d: state must be 2D, got shape {tuple(u.shape)}")
    if ksteps < 1:
        raise ValueError(f"superstep2d: ksteps must be >= 1, got {ksteps}")
    if u.device.type == "cpu":
        nxt = superstep2d_plain(u, eps, scale, wsum, dt, ksteps, precision)
        return nxt if out is None else out.copy_(nxt)
    _check_state("superstep2d u", u, u.shape)
    _check_device(u)
    out = _buffer("superstep2d out", out, u, u.dtype, (u,))
    if u.numel() == 0:
        return out
    nx, ny = u.shape
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_superstep2d")(
            _DTYPE_CODE[u.dtype], int(precision == "bf16"), u.data_ptr(), out.data_ptr(), nx,
            ny, eps, ksteps, float(scale), float(wsum), float(dt),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "superstep2d", eps, u)
    LAUNCHES["superstep2d"] += 1
    return out


def resident2d(u: torch.Tensor, eps: int, scale: float, wsum: float, dt: float,
               nsteps: int) -> torch.Tensor:
    """All ``nsteps`` production steps of the unpadded state ``u`` in one
    cooperative launch; returns the new (nx, ny) state.  A grid beyond the
    card's gate (:func:`fits_resident`) raises a ``ValueError`` naming the
    resident kernel, before anything is allocated or launched."""
    eps, nsteps = int(eps), int(nsteps)
    if u.dim() != 2:
        raise ValueError(f"resident2d: state must be 2D, got shape {tuple(u.shape)}")
    if nsteps < 0:
        raise ValueError(f"resident2d: nsteps must be >= 0, got {nsteps}")
    if u.device.type == "cpu":
        return resident2d_plain(u, eps, scale, wsum, dt, nsteps)
    _check_state("resident2d u", u, u.shape)
    _check_device(u)
    if nsteps == 0 or u.numel() == 0:
        return u.clone()
    nx, ny = u.shape
    if not fits_resident(nx, ny, eps, u.dtype, u.device):
        raise ValueError(
            f"resident kernel: {nx}x{ny} eps={eps} {u.dtype} does not fit this card (its "
            "blocks co-resident, its two frames within the L2: csrc/resident2d.cu); use "
            "the per-step path")
    fa = resident_frame(u, eps)
    fb = torch.zeros_like(fa)
    with torch.cuda.device(u.device):
        rc = _entry("nlheat_resident2d")(
            _DTYPE_CODE[u.dtype], fa.data_ptr(), fb.data_ptr(), nx, ny, fa.shape[1], eps,
            nsteps, float(scale), float(wsum), float(dt), torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "resident2d", eps, u)
    LAUNCHES["resident2d"] += 1
    return (fb if nsteps % 2 else fa)[eps:eps + nx, eps:eps + ny].contiguous()


# -- gates and makers (the JAX package's names) -----------------------------------

def superstep_k(ksteps: int, nsteps: int) -> int:
    """The fused-step depth make_superstep_multi_step_fn runs: K never
    exceeds the step count (pallas_kernel.superstep_k)."""
    return max(1, min(int(ksteps), nsteps if nsteps else 1))


def fits_superstep(nx: int, ny: int, eps: int, ksteps: int, dtype=torch.float32,
                   precision: str = "f32", device="cuda") -> bool:
    """Whether the K-step kernel takes this grid on ``device``: on the card,
    the answer of csrc/superstep2d.cu (the widened window's shared memory,
    K <= 4); on the CPU always, since the plain version has no such limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    if dtype not in _DTYPE_CODE:
        return False
    with torch.cuda.device(device):
        return _entry("nlheat_superstep2d_fits")(
            _DTYPE_CODE[dtype], int(precision == "bf16"), int(eps), int(ksteps)) > 0


def fits_resident(nx: int, ny: int, eps: int, dtype=torch.float32, device="cuda") -> bool:
    """Whether the whole-run kernel takes this grid on ``device``: on the
    card, the answer of csrc/resident2d.cu (its blocks co-resident, its two
    frames within the L2); on the CPU always, since the plain version has no
    such limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return True
    if dtype not in _DTYPE_CODE:
        return False
    with torch.cuda.device(device):
        return _entry("nlheat_resident2d_fits")(
            _DTYPE_CODE[dtype], int(nx), int(ny), int(eps)) > 0


def _production_args(op) -> tuple:
    """(eps, scale, wsum, dt) of a 2D operator's production step; scale is
    c*h^2 as nonlocal_op.case_scale computes it."""
    return int(op.eps), op.c * op.dh * op.dh, op.wsum, op.dt


def _reject_bf16_variant(op, what: str,
                        remedy: str = "the per-step, carried, or superstep 2D paths") -> None:
    """A variant without a bf16 tier refuses a bf16-tier operator: running
    the f32 function instead would break the tier's rule that every variant
    computes the same rounded-operand result."""
    if getattr(op, "precision", "f32") == "bf16":
        raise ValueError(f"the {what} has no bf16 precision tier; use {remedy} "
                         "(or precision='f32')")


def make_carried_multi_step_fn(op, nsteps: int, dtype=None):
    """``multi(u, t0) -> u`` after ``nsteps`` production steps, the state
    carried in a halo-padded frame: one ``carried2d`` launch per step, into
    two frames used in turn, whose halos stay the zeros they were made with
    (the bf16 tier rounds the master as it stages it: one frame, no
    shadow).  ``t0`` is accepted for signature parity (the production step
    does not depend on time); ``u`` is never written."""
    eps, scale, wsum, dt = _production_args(op)

    def multi(u, t0):
        del t0
        u = u.to(dtype or u.dtype)
        nx, ny = u.shape
        frame = F.pad(u, (eps, eps, eps, eps)).contiguous()
        spare = torch.zeros_like(frame)
        for _ in range(nsteps):
            nxt = _carried2d(frame, spare, eps, scale, wsum, dt, op.precision)
            spare, frame = frame, nxt
        return frame[eps:eps + nx, eps:eps + ny].contiguous()

    return multi


def make_superstep_multi_step_fn(op, nsteps: int, ksteps: int = 2, dtype=None):
    """``multi(u, t0) -> u`` after ``nsteps`` production steps, ``ksteps``
    per ``superstep2d`` launch; the remainder ``nsteps % K`` runs as one
    shallower launch.  ``u`` is never written."""
    eps, scale, wsum, dt = _production_args(op)
    K = superstep_k(ksteps, nsteps)
    q, r = divmod(nsteps, K)
    depths = [K] * q + ([r] if r else [])

    def multi(u, t0):
        del t0
        cur = u.to(dtype=dtype or u.dtype, memory_format=torch.contiguous_format, copy=True)
        spare = torch.empty_like(cur)
        for k in depths:
            nxt = superstep2d(cur, eps, scale, wsum, dt, k, op.precision, out=spare)
            spare, cur = cur, nxt
        return cur

    return multi


def make_resident_multi_step_fn(op, nsteps: int, dtype=None):
    """``multi(u, t0) -> u`` after ``nsteps`` production steps in one
    ``resident2d`` launch.  No bf16 tier: a bf16-tier operator is refused
    here; a grid beyond the card's gate raises when the run is called."""
    _reject_bf16_variant(op, "resident kernel")
    eps, scale, wsum, dt = _production_args(op)

    def multi(u, t0):
        del t0
        return resident2d(u.to(dtype or u.dtype).contiguous(), eps, scale, wsum, dt, nsteps)

    return multi
