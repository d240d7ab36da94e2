"""Variant autotuner for the port's production 2D and 3D multi-step runs and
the ensemble engine's 2D buckets.

Counterpart of ``nonlocalheatequation_tpu/utils/autotune.py``.  The
production 2D solve has four interchangeable programs, bit-identical by
construction (ops/cuda_kernel.py): the per-step loop (``step2d``), the
carried frame (``carried2d``), K-step temporal blocking (``superstep2d``)
and the whole run in one launch (``resident2d``).  The 3D solve has three
(ops/cuda_kernel3d.py): the per-step loop (``step3d``), the carried frame
(``carried3d``) and the whole run in one launch (``resident3d``); there is
no 3D superstep, as in the JAX tuner.  Which is fastest depends
on the card and the shape: launch overhead dominates small grids, the
kernel's own costs large ones.  :func:`pick_multi_step_fn` measures the
candidates that fit, once per (kernel sources, card, shape, eps, dtype,
tier), and builds the winner; since every candidate computes the same
function, the swap cannot change results.

On the card a probe is timed with CUDA events.  ``make_multi_step_fn``
tunes CUDA tensors only; called with ``device="cpu"`` (the tests),
:func:`pick_multi_step_fn` times the plain versions with the host clock.
One difference from the JAX tuner, on purpose: a candidate that
passed its fit gate and then fails to build or launch raises.  That is a
kernel fault; letting it "not compete" would hide it behind another
variant.  The JAX rule against tuning float64 is a TPU rule; the port tunes
float64 on the card like float32.

The winners and every candidate's ms/step persist in a JSON file:
``NLHEAT_AUTOTUNE_CACHE=/path/file.json`` relocates it, ``""`` keeps the
cache in the process only, and unset it is
``$XDG_CACHE_HOME/nlheat/autotune_torch.json`` (``~/.cache`` without
``XDG_CACHE_HOME``), beside the JAX package's ``autotune.json``.

The batched half, :func:`pick_batched_multi_step_fn`, tunes the ensemble
engine's 2D ``cuda`` production buckets (``NLHEAT_TUNE_BATCH=1``,
serve/ensemble.py) over the batched kernels of ops/cuda_batched.py and the
vmap composition, once per shape and batch size, under the same rule: a
probe that fails raises.

Not ported yet, and refused by name: the precision dimension
(``NLHEAT_TUNE_PRECISION=1``).
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import time

import torch

from nonlocalheatequation_torch.ops import _build, cuda_kernel, cuda_kernel3d

# the probe program: long enough that per-launch overhead weighs as it does
# in a real run, short enough to keep tuning cheap
PROBE_STEPS = 32
PROBE_ITERS = 2

_memory_cache: dict = {}


def _cache_path() -> str | None:
    env = os.environ.get("NLHEAT_AUTOTUNE_CACHE")
    if env is not None:
        return env or None
    base = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return os.path.join(base, "nlheat", "autotune_torch.json")


def _load_file_cache() -> dict:
    path = _cache_path()
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_file_cache(cache: dict) -> None:
    path = _cache_path()
    if not path:
        return
    # merge on write: processes tuning other shapes keep their entries
    merged = {**_load_file_cache(), **cache}
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(tmp) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.remove(tmp)
        except OSError:
            pass


def records() -> dict:
    """The tuning records of this process: key -> {"winner", "ms_per_step"}."""
    return {k: dict(v) for k, v in _memory_cache.items()}


def reset() -> None:
    """Forget this process's tuning records (a file cache stays as it is)."""
    _memory_cache.clear()


def candidates(op, shape, nsteps: int, dtype, device):
    """[(name, maker(op, nsteps, dtype) -> multi)] that fit this shape.

    2D: per-step, carried, superstep2 and superstep3 (when K does not exceed
    ``nsteps`` and the kernel takes the shape) and resident (when the grid
    passes the card's gate; not in the bf16 tier).  3D: per-step, carried3d
    and resident3d (when the grid passes the card's gate); the bf16 tier
    gets per-step only, since the 3D frame kernels have no bf16 tier."""
    from nonlocalheatequation_torch.ops.nonlocal_op import make_multi_step_fn_base

    if len(shape) not in (2, 3):
        raise ValueError(f"autotune: no {len(shape)}D branch (the tuner takes 2D and 3D "
                         "solves)")
    precision = op.precision
    out = [("per-step", lambda o, n, d: make_multi_step_fn_base(o, n, dtype=d))]
    if len(shape) == 3:
        if precision != "bf16":
            out.append(("carried3d", lambda o, n, d: cuda_kernel3d.make_carried_multi_step_fn_3d(
                o, n, dtype=d)))
            if cuda_kernel3d.fits_resident_3d(*shape, op.eps, dtype, device):
                out.append(("resident3d",
                            lambda o, n, d: cuda_kernel3d.make_resident_multi_step_fn_3d(
                                o, n, dtype=d)))
        return out
    out.append(("carried",
                lambda o, n, d: cuda_kernel.make_carried_multi_step_fn(o, n, dtype=d)))
    for k in (2, 3):
        if cuda_kernel.superstep_k(k, nsteps) == k and cuda_kernel.fits_superstep(
                *shape, op.eps, k, dtype, precision, device):
            out.append((f"superstep{k}",
                        lambda o, n, d, k=k: cuda_kernel.make_superstep_multi_step_fn(
                            o, n, ksteps=k, dtype=d)))
    if precision != "bf16" and cuda_kernel.fits_resident(*shape, op.eps, dtype, device):
        out.append(("resident",
                    lambda o, n, d: cuda_kernel.make_resident_multi_step_fn(o, n, dtype=d)))
    return out


def _probe_state(shape, dtype, device) -> torch.Tensor:
    """The probes' initial state: seeded normal values, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float64).to(dtype)


def _measure(maker, op, u) -> float:
    """Best seconds per step of a PROBE_STEPS program from state ``u``
    (which no candidate writes), its first run, which builds the kernels,
    excluded."""
    fn = maker(op, PROBE_STEPS, u.dtype)
    out = fn(u, 0)
    on_card = u.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(u.device)
    best = float("inf")
    for _ in range(PROBE_ITERS):
        if on_card:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(out, 0)
            b.record()
            b.synchronize()
            seconds = a.elapsed_time(b) / 1e3
        else:
            t = time.perf_counter()
            out = fn(out, 0)
            seconds = time.perf_counter() - t
        best = min(best, seconds)
    return best / PROBE_STEPS


def kernels_digest(ndim: int = 2) -> str:
    """A hash of every kernel source, header and compiler flag the
    candidates of an ``ndim``-D solve are built from (ops/_build.py): a
    change to any of those kernels may move the crossovers, so it starts new
    records; a change to the other rank's kernels does not."""
    sources = _build.SOURCES_3D if ndim == 3 else _build.SOURCES_2D
    joined = "".join(_build.source_digest(s) for s in sources)
    return hashlib.sha256(joined.encode()).hexdigest()[:16]


def tuning_key(op, shape, dtype, device) -> str:
    """The record's key: the kernels' digest, the card's name, the shape,
    eps, dtype and any non-default precision tier.  nsteps is not in it:
    every candidate is timed on the same PROBE_STEPS program, so the rates
    do not depend on it."""
    device = torch.device(device)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return "/".join([f"k{kernels_digest(len(shape))}", card, "cuda", "x".join(map(str, shape)),
                     f"eps{op.eps}", str(dtype).replace("torch.", "")]
                    + ([f"prec-{op.precision}"] if op.precision != "f32" else []))


def _winner(key: str, cands: dict, measure) -> str:
    """The fastest of ``cands`` by the record under ``key``: this process's,
    else the file cache's, probing (``measure(name)``, seconds per step)
    only the candidates no record holds and storing the merged record."""

    def covers(e) -> bool:
        # an entry is reusable only if it measured every candidate that fits
        # THIS call (which candidates fit depends on nsteps)
        return all(n in e.get("ms_per_step", {}) for n in cands)

    entry = _memory_cache.get(key)
    partial = None
    if entry is not None and not covers(entry):
        partial, entry = entry, None
    if entry is None:
        file_cache = _load_file_cache()
        entry = file_cache.get(key)
        if entry is None or not covers(entry):
            # probe only what no record holds, and merge
            recorded = {**(entry or {}).get("ms_per_step", {}),
                        **(partial or {}).get("ms_per_step", {})}
            for name in cands:
                if name not in recorded:
                    recorded[name] = measure(name) * 1e3
            valid = {n: t for n, t in recorded.items() if isinstance(t, (int, float))}
            entry = {"winner": min(valid, key=valid.get), "ms_per_step": recorded}
            file_cache[key] = entry
            _store_file_cache(file_cache)
        _memory_cache[key] = entry
    winner = entry["winner"]
    if winner not in cands:
        # the recorded winner does not fit this nsteps (superstep3 won on a
        # long run, this one has 2 steps): run the fastest one that does
        rates = {n: t for n, t in entry["ms_per_step"].items()
                 if n in cands and isinstance(t, (int, float))}
        winner = min(rates, key=rates.get)
    return winner


def pick_multi_step_fn(op, nsteps: int, shape, dtype, device):
    """Measure the fitting variants (cached) and build the winner at the
    real step count.  Returns (fn, winner_name)."""
    if os.environ.get("NLHEAT_TUNE_PRECISION") == "1":
        raise ValueError("NLHEAT_TUNE_PRECISION=1 (precision as a tuned dimension) is not "
                         "ported yet; unset it to tune the operator's own tier")
    device = torch.device(device)
    shape = tuple(shape)
    cands = dict(candidates(op, shape, nsteps, dtype, device))
    probe = functools.cache(lambda: _probe_state(shape, dtype, device))
    winner = _winner(tuning_key(op, shape, dtype, device), cands,
                     lambda name: _measure(cands[name], op, probe()))
    return cands[winner](op, nsteps, dtype), winner


def batched_candidates(ops, shape, nsteps: int, dtype, device, ksteps: int = 0):
    """[(name, maker(ops, nsteps, dtype) -> multi)] for a 2D ``cuda``
    production bucket of the ensemble engine (NLHEAT_TUNE_BATCH=1): the
    batched per-step, carried and superstep kernels (superstep at K = 2, 3
    and the engine's ``ksteps`` where K does not exceed ``nsteps`` and the
    kernel takes it) and the vmap composition.  Each batched kernel serves
    uniform and mixed physics in one launch, so a mixed bucket probes the
    same programs it would run."""
    from nonlocalheatequation_torch.ops import cuda_batched as cb
    from nonlocalheatequation_torch.ops.nonlocal_op import make_batched_multi_step_fn_vmap

    op0 = ops[0]
    out = [("batched-per-step",
            lambda o, n, d: cb.make_batched_cuda_multi_step_fn(o, n, dtype=d)),
           ("batched-carried",
            lambda o, n, d: cb.make_batched_carried_multi_step_fn(o, n, dtype=d))]
    for k in sorted({2, 3} | ({int(ksteps)} if ksteps >= 2 else set())):
        if cuda_kernel.superstep_k(k, nsteps) == k and cb.fits_batched_superstep(
                op0.eps, k, dtype, op0.precision, device):
            out.append((f"batched-superstep{k}",
                        lambda o, n, d, k=k: cb.make_batched_superstep_multi_step_fn(
                            o, n, ksteps=k, dtype=d)))
    out.append(("vmap", lambda o, n, d: make_batched_multi_step_fn_vmap(o, n, dtype=d)))
    return out


def _measure_batched(maker, ops, shape, dtype, device) -> float:
    """:func:`_measure` for the batched makers: the probe state gains the
    leading case axis."""
    return _measure(lambda _op, n, d: maker(ops, n, d), None,
                    _probe_state((len(ops),) + tuple(shape), dtype, device))


def pick_batched_multi_step_fn(ops, nsteps: int, shape, dtype, device, ksteps: int = 0):
    """Measure the batched variants once per (kernel sources, card, shape,
    eps, dtype, B, tier) and build the winner at the real step count.
    Returns (fn, winner_name).  Every candidate computes the bucket's
    function (the batched kernels bit-identically to the solo kernels, vmap
    to 1e-12), so the swap cannot change results beyond that.  Records share
    the file of :func:`pick_multi_step_fn`, under ``batch{B}`` keys.

    As in :func:`pick_multi_step_fn`, a candidate that fails to build or
    launch raises.  The JAX tuner instead records the error, lets the
    candidate not compete and falls back to the stacked composition when
    every probe errors (tests/test_ensemble.py:243)."""
    device = torch.device(device)
    shape = tuple(shape)
    cands = dict(batched_candidates(ops, shape, nsteps, dtype, device, ksteps))
    key = f"{tuning_key(ops[0], shape, dtype, device)}/batch{len(ops)}"
    winner = _winner(key, cands,
                     lambda name: _measure_batched(cands[name], ops, shape, dtype, device))
    return cands[winner](ops, nsteps, dtype), winner
