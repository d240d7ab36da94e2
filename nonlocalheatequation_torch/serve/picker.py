"""Deadline-aware engine picker: (physics, grid, T_final, accuracy,
deadline_ms) -> the cheapest engine that meets both targets — the port's
copy of ``nonlocalheatequation_tpu/serve/picker.py``.

The picker chooses over **stepper x stages x method x precision** for the
request's real contract — an accuracy target and a deadline — with the JAX
package's models and constants, so that its picks equal the JAX picks:

* **Stability model** — ``ops/constants.stable_dt`` caps each candidate's
  dt at the 0.8x headroom (``models/steppers.superstep_floor``'s rule);
  expo is unconditionally stable (floor 1 step).
* **Accuracy model** — every shipped stepper is first order, so the
  manufactured-solution class (``u = cos(2 pi t) G(x)``, the protocol every
  test case runs) carries a closed-form time-discretization error: local
  truncation ``(2 pi)^2 dt^2 / 2`` accumulated over ``T/dt`` steps gives
  ``err(x, T) ~ 0.5 T (2 pi)^2 dt G(x)``, hence ``error_l2/#points ~
  (0.5 T (2 pi)^2 dt)^2 mean(G^2)`` with ``mean(G^2) = 0.5^d`` for the
  cosine-product profile.  The model is applied with :data:`ERR_SAFETY`
  margin; a candidate whose modeled error exceeds ``accuracy`` at its
  stability-capped dt is INFEASIBLE — the picker never gambles accuracy for
  the deadline.  bf16 candidates carry the tier's error floor
  (``constants.BF16_L2_BUDGET``) on top.  Corrected expo carries the
  collar-defect model :func:`modeled_expo_defect` (amplitude ``min(1, C
  r^2)`` with ``r`` the substep/Euler-bound ratio, squared over the ``2 d
  eps / min(shape)`` boundary band), so it competes without opt-in whenever
  ``ERR_SAFETY * defect <= accuracy`` at the minimal feasible substep
  count.  ``allow_expo=True`` / ``NLHEAT_PICK_EXPO=1`` forces a
  caller-asserted candidate at ``expo_stages``; ``allow_expo=False``
  excludes the stepper.
* **Cost model** — steps x operator applies per step (s for rkc, 1 for
  euler, ~3.5 fft-equivalents per corrected expo substage) x per-apply
  milliseconds.  Rates come from ``rate_fn`` when the caller has one (the
  tuner's records through :func:`record_rate_fn`, the serving pipeline's
  live rates among them), else from the analytic proxy (stencil ``O(N (2
  eps + 1)^d)``, fft ``O(N_box log N_box)``) whose constants are the JAX
  package's relative-cost constants: good enough to rank candidates,
  honest for a deadline only to the order of magnitude — which is why the
  refusal message names the model used.  The default is backend-free: the
  picker never touches ``torch.cuda``; the card's name is the caller's
  argument.

The selection is the cheapest feasible candidate; when nothing meets both
targets the picker REFUSES loudly (:class:`PickerRefusal` names the best
accuracy-feasible candidate and what it would cost).

Env knobs (scrubbed in tests/conftest.py): ``NLHEAT_PICK_STAGES`` — the
rkc stage ladder (comma list, default ``4,8,16,32``);
``NLHEAT_PICK_EXPO=1`` — FORCE the caller-asserted expo candidate at
``expo_stages``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

#: Default rkc stage ladder the picker enumerates (beta(s) ~ 2 s^2:
#: dt reach ~15x/61x/246x/990x the Euler bound at the 0.8x headroom).
STAGE_LADDER = (4, 8, 16, 32)

#: Safety factor on the manufactured-class error model (the JAX
#: package's value): the model neglects the diffusive decay of
#: accumulated truncation error (it overestimates), so the margin guards
#: the other direction — constant slop on unusually boundary-loaded or
#: long-horizon requests.  A candidate is feasible only when
#: ``ERR_SAFETY * modeled_error <= accuracy``.
ERR_SAFETY = 4.0

#: Analytic per-apply cost constants (nanoseconds per point-op), the
#: backend-free fallback rate model: the JAX package's relative-cost
#: constants, kept so that picks equal the JAX picks; not measurements of
#: the card (its rates come from record_rate_fn).
NS_PER_STENCIL_POINT = 0.6
NS_PER_FFT_POINT = 4.0

#: Operator applies per corrected expo substage (the midpoint Duhamel
#: correction costs ~3.5 fft round trips per substep; the plain step 1).
EXPO_CORR_APPLIES = 3.5

#: Collar-defect amplitude model for corrected expo, the JAX package's
#: calibration: ``e ~ min(EXPO_DEFECT_CAP, EXPO_DEFECT_COEF * r^2)`` with
#: ``r`` the substep-to-Euler-bound ratio ``(T_final / S) /
#: stable_dt(euler)``.  Its fit over S in {1,2,4,8} and r in [0.25, 45] on
#: 24^2/eps 3 and 50^2/eps 5 gave coefficients up to 1.05e-3, so 2e-3 is
#: conservative by 2x at the worst point.
EXPO_DEFECT_COEF = 2e-3
EXPO_DEFECT_CAP = 1.0

#: bf16 operand windows halve the bytes of the stencil reads; the
#: analytic model (the JAX package's constant) credits the tier
#: conservatively.
BF16_RATE = 0.7


class PickerRefusal(ValueError):
    """No engine meets the request's accuracy + deadline.  Loud by
    design: the picker must never quietly select an engine that misses
    the accuracy target, and a deadline nothing can meet is the
    CLIENT's 422, not a silently slow solve."""

    def __init__(self, message: str, best=None):
        super().__init__(message)
        self.best = best  # the cheapest accuracy-feasible EngineChoice


@dataclass(frozen=True)
class EngineChoice:
    """One picked engine: the ensemble-engine settings plus the step
    schedule (dt, steps) and the model's evidence (est_ms, est_err,
    rate source) — everything a worker needs to run the case and a
    client needs to audit the pick."""

    stepper: str
    stages: int
    method: str
    precision: str
    dt: float
    steps: int
    est_ms: float
    est_err: float
    rates: str  # "measured" | "live" | "records" | "analytic"

    def engine_kwargs(self) -> dict:
        """The EnsembleEngine/sibling settings of this choice."""
        return {"stepper": self.stepper, "stages": self.stages,
                "method": self.method, "precision": self.precision}

    def key(self) -> tuple:
        """The engine-pool key (serve/server.py ``_engine_for``)."""
        return (self.stepper, self.stages, self.method, self.precision)

    def wire(self) -> dict:
        """Frame/JSON form (the JAX router's case frames, the ingress
        response)."""
        return {"stepper": self.stepper, "stages": self.stages,
                "method": self.method, "precision": self.precision,
                "dt": self.dt, "steps": self.steps,
                "est_ms": self.est_ms,
                "est_err": self.est_err, "rates": self.rates}

    @classmethod
    def from_wire(cls, d):
        if d is None:
            return None
        return cls(stepper=str(d["stepper"]), stages=int(d["stages"]),
                   method=str(d["method"]), precision=str(d["precision"]),
                   dt=float(d["dt"]), steps=int(d["steps"]),
                   est_ms=float(d.get("est_ms", 0.0)),
                   est_err=float(d.get("est_err", 0.0)),
                   rates=str(d.get("rates", "analytic")))


def _wsum(dim: int, eps: int) -> float:
    import numpy as np

    from nonlocalheatequation_torch.ops.stencil import (
        horizon_mask_1d,
        horizon_mask_2d,
        horizon_mask_3d,
    )

    mask = {1: horizon_mask_1d, 2: horizon_mask_2d,
            3: horizon_mask_3d}[dim](eps)
    return float(np.asarray(mask, np.float64).sum())


def _c_const(dim: int, k: float, eps: int, h: float) -> float:
    from nonlocalheatequation_torch.ops import constants as C

    return {1: C.c_1d, 2: C.c_2d, 3: C.c_3d}[dim](k, eps, h)


def analytic_rate_fn(method: str, shape, eps: int,
                     precision: str) -> float:
    """Per-apply milliseconds from the backend-free analytic proxy
    (module docstring honesty note): stencil O(N (2 eps + 1)^d), fft
    O(N_box log2 N_box).  ``method='gather'`` (the mesh axis) rides the
    stencil branch on purpose: with the rank-1 ``(n,)`` shape and the
    mesh's effective eps (:func:`_mesh_eps_eff`) the same formula
    prices O(nnz), the gather tier's true per-apply work."""
    n = 1
    for s in shape:
        n *= int(s)
    if method == "fft":
        from nonlocalheatequation_torch.ops.spectral import fft_box

        nb = 1
        for s in fft_box(shape, eps):
            nb *= int(s)
        ms = nb * max(1.0, math.log2(nb)) * NS_PER_FFT_POINT * 1e-6
    else:
        ms = n * (2 * eps + 1) ** len(shape) * NS_PER_STENCIL_POINT * 1e-6
        if precision == "bf16":
            ms *= BF16_RATE
    return ms


def record_rate_fn(device_kind: str, dtype_name: str = "float32",
                   version: str | None = None):
    """A rate_fn over the port's tuner records (utils/autotune file
    cache): per-apply ms from each record's LIVE recalibrated rate when
    serving traffic has banked one (obs/slo.py ``LiveRateRecorder``), else
    the probed ``per-step`` entry where one exists, else the analytic
    proxy.  Keys are ``autotune.record_key``'s (the tuner's ``tuning_key``
    with ``method`` in the third field; ``version`` replaces the kernels'
    digest).  ``device_kind`` is the CALLER's knowledge (the card's name,
    ``torch.cuda.get_device_name``) — the picker itself stays
    backend-free.  The closure's ``provenance`` reports ``"live"``
    when any loaded record carries a live rate (the EngineChoice.rates
    audit label then names the freshest source a lookup can hit),
    ``"records"`` otherwise."""
    from nonlocalheatequation_torch.utils.autotune import _load_file_cache, record_key

    cache = _load_file_cache()

    def _num(v):
        return (float(v) if isinstance(v, (int, float))
                and not isinstance(v, bool) else None)

    def rate(method, shape, eps, precision):
        key = record_key(device_kind, method, shape, eps, dtype_name, precision,
                         version=version)
        entry = cache.get(key) or {}
        ms = _num(((entry.get("live") or {}).get("per-step")))
        if ms is None:
            ms = _num((entry.get("ms_per_step") or {}).get("per-step"))
        if ms is not None:
            return ms
        return analytic_rate_fn(method, shape, eps, precision)

    rate.provenance = "live" if any(
        _num(((e or {}).get("live") or {}).get("per-step")) is not None
        for e in cache.values() if isinstance(e, dict)) else "records"
    return rate


def _stage_ladder() -> tuple:
    env = os.environ.get("NLHEAT_PICK_STAGES")
    if not env:
        return STAGE_LADDER
    try:
        ladder = tuple(sorted({int(t) for t in env.split(",") if t.strip()}))
    except ValueError:
        raise ValueError(
            f"NLHEAT_PICK_STAGES must be a comma list of ints, got "
            f"{env!r}") from None
    if not ladder or any(s < 2 for s in ladder):
        raise ValueError(
            f"NLHEAT_PICK_STAGES needs stage counts >= 2, got {env!r}")
    return ladder


def modeled_error(dim: int, T_final: float, dt: float) -> float:
    """The manufactured-class time-discretization error model (module
    docstring): ``(0.5 T (2 pi)^2 dt)^2 * 0.5^d`` — error_l2/#points
    units, the repo's accuracy currency."""
    amp = 0.5 * T_final * (2.0 * math.pi) ** 2 * dt
    return amp * amp * 0.5 ** dim


def _boundary_frac(shape, eps: int) -> float:
    """Fraction of grid points inside the eps-wide collar-coupled band
    (two faces per axis; the defect lives there, the interior is
    time-exact)."""
    return min(1.0, 2.0 * len(shape) * eps / min(int(s) for s in shape))


def modeled_expo_defect(shape, eps: int, euler_bound: float,
                        T_final: float, stages: int) -> float:
    """The corrected expo collar defect for ONE step to ``T_final``
    with ``stages = S >= 1`` substeps, in error_l2/#points units:
    amplitude ``min(cap, C r^2)`` (:data:`EXPO_DEFECT_COEF` calibration
    note) squared over the boundary band fraction.  Conservative by
    construction — the qualification gate multiplies ERR_SAFETY on
    top, so a defect the model clears really does sit under the
    measured one with >= 10x total margin at every probe point."""
    S = max(1, int(stages))
    r = (T_final / S) / euler_bound
    e = min(EXPO_DEFECT_CAP, EXPO_DEFECT_COEF * r * r)
    return e * e * _boundary_frac(shape, eps)


def _expo_min_stages(shape, eps: int, euler_bound: float,
                     T_final: float, accuracy: float) -> int | None:
    """Smallest S with ``ERR_SAFETY * modeled_expo_defect <= accuracy``
    (defect is monotone decreasing and cost monotone increasing in S,
    so the minimal feasible S is also the cheapest).  None when even
    the unsaturated quadratic regime cannot reach the budget."""
    e_budget = math.sqrt(accuracy / (ERR_SAFETY * _boundary_frac(shape,
                                                                 eps)))
    if e_budget >= EXPO_DEFECT_CAP:
        return 1  # any substep count models inside the budget
    r_max = math.sqrt(e_budget / EXPO_DEFECT_COEF)
    if r_max <= 0 or not math.isfinite(r_max):
        return None
    return max(1, math.ceil(T_final / (r_max * euler_bound)))


def _mesh_eps_eff(op) -> int:
    """The mesh's effective integer eps for the RATE models: chosen so
    the analytic stencil formula ``n * (2 eps + 1)^rank`` over the
    rank-1 ``(n,)`` shape prices ``O(nnz)`` — the gather tier's true
    per-apply work.  Records use the same key (``gather/<n>/eps<e>``),
    so measured gather rates slot in next to stencil/fft without a new
    rate_fn signature."""
    mean_deg = (len(op.tgt) / op.n) if op.n else 1.0
    return max(0, round((mean_deg - 1.0) / 2.0))


def _pick_mesh_engine(mesh: str, k: float, T_final: float,
                      accuracy: float, deadline_ms, rate_fn,
                      rates_label: str, mesh_dir) -> EngineChoice:
    """The mesh axis: candidates are the ``gather_L`` tier (ops/gather.py)
    — method='gather', Euler-only (the tier has no rkc/expo schedule),
    f32 + bf16 precisions.  The stability bound is the mesh's REAL
    per-point bound ``1 / max(c_i * wsum_i)`` (the unstructured CLI's
    rule, cli/solve_unstructured.py), computed from the registered cloud
    by a CPU operator on the host — the card is not touched."""
    import numpy as np

    from nonlocalheatequation_torch.ops.constants import BF16_L2_BUDGET
    from nonlocalheatequation_torch.serve.meshes import get_mesh_op

    op = get_mesh_op(mesh, k, dt=1.0, mesh_dir=mesh_dir, device="cpu")
    dim = op.d
    bound = float(np.max(op.c * op.wsum))
    if not (bound > 0 and math.isfinite(bound)):
        raise PickerRefusal(
            f"mesh {mesh}: degenerate stability bound {bound!r} "
            "(empty edge table?)")
    eps_eff = _mesh_eps_eff(op)
    shape = (int(op.n),)

    def dt_cap(floor: float = 0.0) -> float:
        budget = accuracy / ERR_SAFETY - floor
        if budget <= 0:
            return 0.0
        return math.sqrt(budget / 0.5 ** dim) / (
            0.5 * T_final * (2.0 * math.pi) ** 2)

    candidates: list[EngineChoice] = []
    for prec in ("f32", "bf16"):
        cap = dt_cap(BF16_L2_BUDGET if prec == "bf16" else 0.0)
        if cap <= 0:
            continue
        dt = min(0.8 / bound, cap)
        if not math.isfinite(dt) or dt <= 0:
            continue
        steps = max(1, math.ceil(T_final / dt))
        dt = T_final / steps
        err = modeled_error(dim, T_final, dt)
        if prec == "bf16":
            err = err + BF16_L2_BUDGET
        if ERR_SAFETY * err > accuracy:
            continue
        candidates.append(EngineChoice(
            stepper="euler", stages=0, method="gather", precision=prec,
            dt=dt, steps=steps,
            est_ms=steps * rate_fn("gather", shape, eps_eff, prec),
            est_err=err, rates=rates_label))
    if not candidates:
        raise PickerRefusal(
            f"no gather engine meets accuracy {accuracy:g} for "
            f"T_final={T_final:g} on mesh {mesh} ({op.n} nodes)")
    candidates.sort(key=lambda ch: (ch.est_ms, ch.steps))
    if deadline_ms is not None:
        feasible = [ch for ch in candidates if ch.est_ms <= deadline_ms]
        if not feasible:
            best = candidates[0]
            raise PickerRefusal(
                f"no gather engine meets deadline {deadline_ms:g} ms "
                f"at accuracy {accuracy:g} on mesh {mesh}: the "
                f"cheapest accuracy-feasible engine models "
                f"{best.est_ms:.1f} ms ({best.rates} rates)", best=best)
        return feasible[0]
    return candidates[0]


def pick_engine(shape, eps: int, k: float, dh: float, T_final: float,
                accuracy: float, deadline_ms: float | None = None, *,
                method: str = "auto", rate_fn=None,
                stages_ladder=None, allow_expo: bool | None = None,
                allow_fft: bool = True,
                expo_stages: int = 2, mesh: str | None = None,
                mesh_dir=None) -> EngineChoice:
    """The cheapest (stepper, stages, method, precision) engine meeting
    ``accuracy`` (error_l2/#points, the manufactured contract's units)
    and ``deadline_ms`` (None = no deadline) for a solve of ``T_final``
    physical time on ``shape`` — or :class:`PickerRefusal`.

    ``method`` is the fleet's stencil base ('auto' models as the conv/
    sat stencil); the fft twin competes unless ``allow_fft=False``.
    ``allow_fft`` is a router's sharded-fft capability verdict for
    cases bound for a gang (the JAX package's ``sharded_fft_capability``):
    True when the pencil-decomposed sharded transform
    (ops/spectral_sharded.py) can serve the (grid, mesh) pair, False when
    it cannot, which excludes fft and expo.
    ``rate_fn(method, shape, eps, precision) -> ms`` is
    the caller's measured cost model; default analytic (backend-free).

    ``mesh`` switches to the MESH axis: the hash of a registered point
    cloud (serve/meshes.py).  Candidates are then the gather tier only (:func:`_pick_mesh_engine`); ``shape``,
    ``eps``, ``dh`` and the stepper/fft knobs are ignored — the mesh
    carries its own geometry and stability bound.
    """
    from nonlocalheatequation_torch.ops.constants import (
        BF16_L2_BUDGET,
        stable_dt,
    )

    shape = tuple(int(s) for s in shape)
    dim = len(shape)
    if T_final <= 0:
        raise ValueError(f"T_final must be > 0, got {T_final}")
    if accuracy <= 0:
        raise ValueError(f"accuracy must be > 0, got {accuracy}")
    if deadline_ms is not None and deadline_ms <= 0:
        raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
    if mesh is not None:
        if rate_fn is None:
            mesh_rate, mesh_label = analytic_rate_fn, "analytic"
        else:
            mesh_rate = rate_fn
            mesh_label = getattr(rate_fn, "provenance", "measured")
        return _pick_mesh_engine(mesh, k, T_final, accuracy,
                                 deadline_ms, mesh_rate, mesh_label,
                                 mesh_dir)
    # cost-model provenance for the audit trail: an injected rate_fn is
    # the caller's measurement unless it declares otherwise (the
    # record_rate_fn closure tags itself "records")
    if rate_fn is None:
        rate_fn = analytic_rate_fn
        rates_label = "analytic"
    else:
        rates_label = getattr(rate_fn, "provenance", "measured")
    if allow_expo is None and os.environ.get("NLHEAT_PICK_EXPO") == "1":
        allow_expo = True  # forced opt-in; None stays the model gate
    ladder = tuple(stages_ladder) if stages_ladder else _stage_ladder()
    wsum = _wsum(dim, eps)
    c = _c_const(dim, k, eps, dh)
    stencil = method if method not in ("auto", "fft") else "auto"
    if not allow_fft:
        if method == "fft":
            raise PickerRefusal(
                "the router's sharded-fft capability gate excludes "
                "method='fft' for this case (the pencil transposes "
                "cannot serve the (grid, mesh) pair, or "
                "NLHEAT_FFT_SHARDED=0 — serve/router.py "
                "sharded_fft_capability) and the fleet's base method "
                "IS fft: no servable candidate axis")
        methods = [stencil]
        allow_expo = False  # expo is fft-only
    else:
        methods = [stencil, "fft"] if stencil != "fft" else ["fft"]

    # accuracy cap on dt per error floor (the bf16 tier carries its
    # measured floor INSIDE the budget, so an accuracy-capped bf16
    # candidate gets a genuinely smaller dt instead of being generated
    # and then unconditionally rejected by its own feasibility check):
    # ERR_SAFETY * (model(dt) + floor) <= accuracy
    def dt_cap(floor: float = 0.0) -> float:
        budget = accuracy / ERR_SAFETY - floor
        if budget <= 0:
            return 0.0
        return math.sqrt(budget / 0.5 ** dim) / (
            0.5 * T_final * (2.0 * math.pi) ** 2)

    dt_acc = dt_cap()
    candidates: list[EngineChoice] = []
    steppers = [("euler", 0)] + [("rkc", s) for s in ladder]
    for m in methods:
        for prec in ("f32", "bf16"):
            cap = dt_acc
            if prec == "bf16":
                if m == "fft":
                    # the spectral path has no bf16 operand windows
                    continue
                cap = dt_cap(BF16_L2_BUDGET)
                if cap <= 0:
                    # the tier's measured error floor alone exceeds
                    # the budget at the safety margin
                    continue
            for stepper, stages in steppers:
                bound = stable_dt(c, dh, dim, wsum, stepper=stepper,
                                  stages=stages)
                dt = min(0.8 * bound, cap)  # superstep_floor headroom
                if not math.isfinite(dt) or dt <= 0:
                    continue
                steps = max(1, math.ceil(T_final / dt))
                dt = T_final / steps
                err = modeled_error(dim, T_final, dt)
                if prec == "bf16":
                    err = err + BF16_L2_BUDGET
                if ERR_SAFETY * err > accuracy:
                    continue  # infeasible: accuracy is never gambled
                applies = steps * (stages if stepper == "rkc" else 1)
                est_ms = applies * rate_fn(m, shape, eps, prec)
                candidates.append(EngineChoice(
                    stepper=stepper, stages=stages, method=m,
                    precision=prec, dt=dt, steps=steps, est_ms=est_ms,
                    est_err=err, rates=rates_label))
    eul = stable_dt(c, dh, dim, wsum)
    if allow_expo is True:
        # forced opt-in (the pre-model envelope): the caller asserts
        # the interior contract at its chosen substep count; est_err
        # still reports the model's verdict for the audit trail
        S = max(0, int(expo_stages))
        applies = max(1.0, EXPO_CORR_APPLIES * S)
        candidates.append(EngineChoice(
            stepper="expo", stages=S, method="fft", precision="f32",
            dt=T_final, steps=1,
            est_ms=applies * rate_fn("fft", shape, eps, "f32"),
            est_err=modeled_expo_defect(shape, eps, eul, T_final,
                                        max(1, S)),
            rates=rates_label))
    elif allow_expo is None and "fft" in methods:
        # the qualification: corrected expo competes without
        # opt-in when the measured collar-defect model clears the
        # accuracy target at the minimal (= cheapest) substep count —
        # one step to the horizon, unconditionally stable, never a
        # gamble (ERR_SAFETY rides the gate like every other candidate)
        S = _expo_min_stages(shape, eps, eul, T_final, accuracy)
        if S is not None:
            defect = modeled_expo_defect(shape, eps, eul, T_final, S)
            if ERR_SAFETY * defect <= accuracy:
                candidates.append(EngineChoice(
                    stepper="expo", stages=S, method="fft",
                    precision="f32", dt=T_final, steps=1,
                    est_ms=(EXPO_CORR_APPLIES * S
                            * rate_fn("fft", shape, eps, "f32")),
                    est_err=defect, rates=rates_label))

    if not candidates:
        # the accuracy cap comes from the closed-form manufactured
        # error model, never the rate model — name it correctly
        raise PickerRefusal(
            f"no engine meets accuracy {accuracy:g} for T_final="
            f"{T_final:g} on {shape} (dt cap {dt_acc:g} from the "
            "manufactured-class error model at ERR_SAFETY margin; "
            "even the finest stable step models past the target)")
    candidates.sort(key=lambda ch: (ch.est_ms, ch.steps, ch.stages))
    if deadline_ms is not None:
        feasible = [ch for ch in candidates if ch.est_ms <= deadline_ms]
        if not feasible:
            best = candidates[0]
            raise PickerRefusal(
                f"no engine meets deadline {deadline_ms:g} ms at "
                f"accuracy {accuracy:g} on {shape}: the cheapest "
                f"accuracy-feasible engine ({best.stepper}"
                f"[s={best.stages}]/{best.method}/{best.precision}, "
                f"{best.steps} steps) models {best.est_ms:.1f} ms "
                f"({best.rates} rates)", best=best)
        return feasible[0]
    return candidates[0]
