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

Two opt-in dimensions change results within a stated bound, not bitwise,
as in the JAX tuner.  ``NLHEAT_TUNE_PRECISION=1`` adds the bf16 tier's
candidates (``+bf16`` names) to an f32-tier solve; a bf16 winner must pass
:func:`_bf16_gate` (constants.BF16_TUNE_GATE), recorded beside the rates.
``NLHEAT_TUNE_METHOD=1`` (models/steppers.make_multi_step_fn, production
solves) times the op's own method against its fft twin,
:func:`pick_op_method`, under ``method-ab`` keys.
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
# the batched tuner probes every candidate in rounds, in turns, and keeps
# each one's best; a candidate beats the batched per-step program only by
# BATCH_MARGIN of that program's time.  One round and no margin let the
# host's noise on a 32-step probe pick a program slower on the real run.
BATCH_PROBE_ROUNDS = 2
BATCH_MARGIN = 0.2

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


def solo_maker(name: str):
    """The maker ``(op, nsteps, dtype) -> multi`` of the candidate ``name``
    of :func:`candidates` (a ``+bf16`` name runs the op's bf16 twin),
    without its fit gate: a recorded pick is re-made from its name alone
    (serve/program_store.py)."""
    from nonlocalheatequation_torch.ops.nonlocal_op import make_multi_step_fn_base

    if name.endswith("+bf16"):
        inner = solo_maker(name[:-len("+bf16")])
        return lambda o, n, d: inner(o.with_precision("bf16"), n, d)
    if name == "per-step":
        return lambda o, n, d: make_multi_step_fn_base(o, n, dtype=d)
    if name == "carried":
        return lambda o, n, d: cuda_kernel.make_carried_multi_step_fn(o, n, dtype=d)
    if name in ("superstep2", "superstep3"):
        k = int(name[-1])
        return lambda o, n, d: cuda_kernel.make_superstep_multi_step_fn(o, n, ksteps=k, dtype=d)
    if name == "resident":
        return lambda o, n, d: cuda_kernel.make_resident_multi_step_fn(o, n, dtype=d)
    if name == "carried3d":
        return lambda o, n, d: cuda_kernel3d.make_carried_multi_step_fn_3d(o, n, dtype=d)
    if name == "resident3d":
        return lambda o, n, d: cuda_kernel3d.make_resident_multi_step_fn_3d(o, n, dtype=d)
    raise KeyError(f"autotune: no solo candidate named {name!r}")


def candidates(op, shape, nsteps: int, dtype, device):
    """[(name, maker(op, nsteps, dtype) -> multi)] that fit this shape.

    2D: per-step, carried, superstep2 and superstep3 (when K does not exceed
    ``nsteps`` and the kernel takes the shape) and resident (when the grid
    passes the card's gate; not in the bf16 tier).  3D: per-step, carried3d
    and resident3d (when the grid passes the card's gate); the bf16 tier
    gets per-step only, since the 3D frame kernels have no bf16 tier."""
    if len(shape) not in (2, 3):
        raise ValueError(f"autotune: no {len(shape)}D branch (the tuner takes 2D and 3D "
                         "solves)")
    precision = op.precision
    names = ["per-step"]
    if len(shape) == 3:
        if precision != "bf16":
            names.append("carried3d")
            if cuda_kernel3d.fits_resident_3d(*shape, op.eps, dtype, device):
                names.append("resident3d")
        return [(n, solo_maker(n)) for n in names]
    names.append("carried")
    for k in (2, 3):
        if cuda_kernel.superstep_k(k, nsteps) == k and cuda_kernel.fits_superstep(
                *shape, op.eps, k, dtype, precision, device):
            names.append(f"superstep{k}")
    if precision != "bf16" and cuda_kernel.fits_resident(*shape, op.eps, dtype, device):
        names.append("resident")
    return [(n, solo_maker(n)) for n in names]


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


def card_name(device) -> str:
    """The card's name in the records' keys (``"cpu"`` off the card)."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def record_key(device_kind: str, method: str, shape, eps: int, dtype_name: str,
               precision: str = "f32", version: str | None = None) -> str:
    """The one key grammar of the records in the tuner's file:
    ``k{kernels digest}/{card}/{method}/{shape}/eps{e}/{dtype}[/prec-...]``.
    :func:`tuning_key` is it with the method ``cuda``; the serving
    pipeline's live rates (obs/slo.LiveRateRecorder) and the picker's
    ``record_rate_fn`` (serve/picker.py) build theirs here too.
    ``version`` replaces the kernels' digest."""
    shape = tuple(int(s) for s in shape)
    if version is None:
        version = kernels_digest(len(shape))
    return "/".join([f"k{version}", str(device_kind), str(method), "x".join(map(str, shape)),
                     f"eps{int(eps)}", str(dtype_name)]
                    + ([f"prec-{precision}"] if precision != "f32" else []))


def tuning_key(op, shape, dtype, device) -> str:
    """The record's key: the kernels' digest, the card's name, the shape,
    eps, dtype and any non-default precision tier.  nsteps is not in it:
    every candidate is timed on the same PROBE_STEPS program, so the rates
    do not depend on it."""
    return record_key(card_name(device), "cuda", shape, op.eps,
                      str(dtype).replace("torch.", ""), op.precision)


def batched_key(ops, shape, dtype, device) -> str:
    """The batched tuner's record key: :func:`tuning_key` under ``batch{B}``."""
    return f"{tuning_key(ops[0], shape, dtype, device)}/batch{len(ops)}"


def adopt_records(recs: dict) -> None:
    """Install tuning records (key -> record, as :func:`records` returns
    them) in this process's cache: a program stored with its pick is
    re-made without a probe (serve/program_store.py)."""
    _memory_cache.update({k: dict(v) for k, v in recs.items()})


def _winner(key: str, cands: dict, measure, default: str | None = None,
            margin: float = 0.0, gate=None) -> str:
    """The fastest of ``cands`` by the record under ``key``: this process's,
    else the file cache's, probing (``measure(name)``, seconds per step)
    only the candidates no record holds and storing the merged record.
    ``default`` keeps the win unless another candidate is faster by
    ``margin`` of its time.  ``gate()`` (the bf16 tier's accuracy gate) is
    run once per record when ``+bf16`` candidates compete and kept in it; a
    ``+bf16`` candidate wins only where it passed."""

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
            entry = {"ms_per_step": recorded}
            bf16_gate = _entry_gate(partial) or _entry_gate(file_cache.get(key))
            if bf16_gate is None and gate is not None:
                bf16_gate = gate()
            if bf16_gate is not None:
                entry["bf16_gate"] = bf16_gate
            entry["winner"] = _fastest(recorded, _eligible(recorded, entry), default, margin)
            file_cache[key] = entry
            _store_file_cache(file_cache)
        _memory_cache[key] = entry
    winner = entry["winner"]
    if winner not in cands:
        # the recorded winner does not fit this nsteps (superstep3 won on a
        # long run, this one has 2 steps): run the fastest one that does,
        # by the same rule
        winner = _fastest(entry["ms_per_step"], _eligible(cands, entry), default, margin)
    return winner


def _entry_gate(entry) -> dict | None:
    return (entry or {}).get("bf16_gate")


def _eligible(names, entry: dict) -> list:
    """``names`` less the ``+bf16`` candidates unless the record's gate passed."""
    ok = (_entry_gate(entry) or {}).get("ok")
    return [n for n in names if ok or not n.endswith("+bf16")]


def _bf16_gate(op, op_bf16, shape, dtype, device) -> dict:
    """The precision dimension's accuracy gate: l2/#points between the f32
    and the bf16 tier's per-step programs over a PROBE_STEPS run from the
    probe state, against constants.BF16_TUNE_GATE."""
    from nonlocalheatequation_torch.ops.constants import BF16_TUNE_GATE
    from nonlocalheatequation_torch.ops.nonlocal_op import make_multi_step_fn_base

    u = _probe_state(shape, dtype, device)
    a = make_multi_step_fn_base(op, PROBE_STEPS, dtype=dtype)(u, 0)
    b = make_multi_step_fn_base(op_bf16, PROBE_STEPS, dtype=dtype)(u, 0)
    l2 = float(torch.sum((a.double() - b.double()) ** 2)) / float(a.numel())
    return {"l2_per_n": l2, "budget": BF16_TUNE_GATE, "ok": bool(l2 <= BF16_TUNE_GATE)}


def _fastest(ms_per_step: dict, names, default: str | None, margin: float) -> str:
    """The fastest of ``names`` by their recorded ms/step, or ``default``
    (when recorded) unless that one is faster by ``margin`` of its time."""
    valid = {n: t for n, t in ms_per_step.items()
             if n in names and isinstance(t, (int, float))}
    best = min(valid, key=valid.get)
    if default in valid and valid[best] > (1.0 - margin) * valid[default]:
        best = default
    return best


def pick_multi_step_fn(op, nsteps: int, shape, dtype, device):
    """Measure the fitting variants (cached) and build the winner at the
    real step count.  Returns (fn, winner_name).  Under
    ``NLHEAT_TUNE_PRECISION=1`` an f32-tier op's bf16 twins compete too
    (``+bf16``), behind :func:`_bf16_gate`."""
    device = torch.device(device)
    shape = tuple(shape)
    cands = dict(candidates(op, shape, nsteps, dtype, device))
    gate = None
    if os.environ.get("NLHEAT_TUNE_PRECISION") == "1" and op.precision == "f32":
        op_bf16 = op.with_precision("bf16")
        for name, maker in candidates(op_bf16, shape, nsteps, dtype, device):
            cands[f"{name}+bf16"] = lambda _o, n, d, m=maker: m(op_bf16, n, d)
        gate = lambda: _bf16_gate(op, op_bf16, shape, dtype, device)  # noqa: E731
    probe = functools.cache(lambda: _probe_state(shape, dtype, device))
    winner = _winner(tuning_key(op, shape, dtype, device), cands,
                     lambda name: _measure(cands[name], op, probe()), gate=gate)
    return cands[winner](op, nsteps, dtype), winner


def pick_op_method(op, shape, dtype, device):
    """The stencil/fft crossover (``NLHEAT_TUNE_METHOD=1``): time the op's
    own method against its fft twin (ops/spectral.py) on the same
    PROBE_STEPS per-step program, once per (card, method pair, shape, eps,
    dtype, tier), and return the operator to run, the op or its twin.  The
    stencil methods cost O(N * eps^d) an apply, fft O(N log N) whatever
    eps.  The twin computes the same function within 1e-12, not bitwise.
    Records share the file of :func:`pick_multi_step_fn` under
    ``method-ab`` keys."""
    from nonlocalheatequation_torch.ops.nonlocal_op import make_multi_step_fn_base

    device = torch.device(device)
    shape = tuple(shape)
    key = "/".join([f"k{kernels_digest(len(shape))}", card_name(device), "method-ab",
                    f"{op.method}-vs-fft", "x".join(map(str, shape)), f"eps{op.eps}",
                    str(dtype).replace("torch.", "")]
                   + ([f"prec-{op.precision}"] if op.precision != "f32" else []))
    cands = {op.method: op, "fft": op.with_method("fft")}
    probe = functools.cache(lambda: _probe_state(shape, dtype, device))
    winner = _winner(key, cands, lambda name: _measure(
        lambda o, n, d: make_multi_step_fn_base(o, n, dtype=d), cands[name], probe()))
    return cands[winner]


def batched_maker(name: str):
    """The maker ``(ops, nsteps, dtype) -> multi`` of the batched candidate
    ``name`` of :func:`batched_candidates`, without its fit gate (a
    recorded pick re-made from its name, serve/program_store.py)."""
    from nonlocalheatequation_torch.ops import cuda_batched as cb
    from nonlocalheatequation_torch.ops.nonlocal_op import make_batched_multi_step_fn_vmap

    if name == "batched-per-step":
        return lambda o, n, d: cb.make_batched_cuda_multi_step_fn(o, n, dtype=d)
    if name == "batched-carried":
        return lambda o, n, d: cb.make_batched_carried_multi_step_fn(o, n, dtype=d)
    if name.startswith("batched-superstep"):
        k = int(name[len("batched-superstep"):])
        return lambda o, n, d: cb.make_batched_superstep_multi_step_fn(o, n, ksteps=k, dtype=d)
    if name == "vmap":
        return lambda o, n, d: make_batched_multi_step_fn_vmap(o, n, dtype=d)
    raise KeyError(f"autotune: no batched candidate named {name!r}")


def batched_candidates(ops, shape, nsteps: int, dtype, device, ksteps: int = 0):
    """[(name, maker(ops, nsteps, dtype) -> multi)] for a 2D ``cuda``
    production bucket of the ensemble engine (NLHEAT_TUNE_BATCH=1): the
    batched per-step, carried and superstep kernels (superstep at K = 2, 3
    and the engine's ``ksteps`` where K does not exceed ``nsteps`` and the
    kernel takes it) and the vmap composition.  Each batched kernel serves
    uniform and mixed physics in one launch, so a mixed bucket probes the
    same programs it would run."""
    from nonlocalheatequation_torch.ops import cuda_batched as cb

    op0 = ops[0]
    names = ["batched-per-step", "batched-carried"]
    for k in sorted({2, 3} | ({int(ksteps)} if ksteps >= 2 else set())):
        if cuda_kernel.superstep_k(k, nsteps) == k and cb.fits_batched_superstep(
                op0.eps, k, dtype, op0.precision, device):
            names.append(f"batched-superstep{k}")
    names.append("vmap")
    return [(n, batched_maker(n)) for n in names]


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
    Every candidate is probed in BATCH_PROBE_ROUNDS rounds, in turns, and
    a candidate wins over the batched per-step program only when its best
    probe is BATCH_MARGIN faster than that program's.

    As in :func:`pick_multi_step_fn`, a candidate that fails to build or
    launch raises.  The JAX tuner instead records the error, lets the
    candidate not compete and falls back to the stacked composition when
    every probe errors (tests/test_ensemble.py:243)."""
    device = torch.device(device)
    shape = tuple(shape)
    cands = dict(batched_candidates(ops, shape, nsteps, dtype, device, ksteps))
    key = batched_key(ops, shape, dtype, device)
    best: dict = {}

    def measure(name):
        # the first call probes every candidate, BATCH_PROBE_ROUNDS rounds
        if not best:
            for _ in range(BATCH_PROBE_ROUNDS):
                for n, maker in cands.items():
                    t = _measure_batched(maker, ops, shape, dtype, device)
                    best[n] = min(best.get(n, t), t)
        return best[name]

    winner = _winner(key, cands, measure, default="batched-per-step", margin=BATCH_MARGIN)
    return cands[winner](ops, nsteps, dtype), winner
