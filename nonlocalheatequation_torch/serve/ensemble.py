"""Shape-bucketed ensemble scheduler: N independent solves, few programs —
counterpart of ``nonlocalheatequation_tpu/serve/ensemble.py``.

The reference's batch_tester protocol (src/1d_nonlocal_serial.cpp:239-266)
runs its rows one after another, each paying its own launches.  The engine
runs them as batched programs:

* **Bucketing** — :class:`EnsembleCase` rows group by ``(shape, nt, eps,
  test)``; the engine's settings (dtype, device, precision tier, method,
  variant) complete the key.  Cases in one bucket may differ in physics
  (k, dt, dh).
* **Padding** — each bucket is cut into chunks of the largest allowed batch
  size, and the last chunk is padded UP to the smallest allowed size that
  fits (1/2/4/8 by default) by repeating its last case, so a few batch
  shapes serve every case count.  Padding lanes are dropped from the
  results.
* **Dispatch** — one multi-step program per chunk.  A 2D ``cuda`` bucket
  runs one batched kernel launch per step (or per K steps) over the whole
  chunk (ops/cuda_batched.py), whatever its physics: each case reads its
  own (scale, dt), where the JAX package runs mixed-physics chunks as
  per-case solo programs.

Results come back as NumPy arrays in submission order; the CLIs feed each
into its Solver (``s.u``, ``s.compute_l2``) so the error is computed by the
solo path's code.

``variant="auto"`` keeps the JAX rule: a 2D ``cuda`` bucket runs the batched
per-step kernel, or under ``NLHEAT_TUNE_BATCH=1`` (production buckets) the
batched tuner's winner (utils/autotune.pick_batched_multi_step_fn); every
other bucket (1D, 3D, a 2D method that is not ``cuda``) runs the vmap
composition.  A mesh bucket (unstructured cases keyed by a registered
cloud's content hash, serve/meshes.py) runs each case's solo loop of the
``gather_L`` kernel in turn (ops/gather.py, the stacked composition), as
the JAX package runs its Pallas gather tier.  Not ported yet, and refused
by name: non-Euler steppers, ``comm='fused'`` and the AOT program store.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry, backed
from nonlocalheatequation_torch.utils.devices import resolve_device, resolve_dtype

#: Allowed chunk sizes, ascending.  Buckets larger than the top size are
#: split into top-size chunks; the remainder pads up to the smallest size
#: that fits.
BATCH_SIZES = (1, 2, 4, 8)

#: Default bound on the in-memory program cache (LRU; the ``program_cache_cap``
#: argument overrides it, 0 = unbounded).  An
#: evicted program is rebuilt on its next use; the cache holds operators and
#: closures, never state, so eviction cannot change results.
PROGRAM_CACHE_CAP = 64


@dataclass
class EnsembleCase:
    """One solve submitted to the engine.

    ``shape`` is the grid ((nx,), (nx, ny) or (nx, ny, nz)); ``dh`` holds
    the 1D operator's dx for rank-1 cases.  ``test=True`` runs the
    manufactured-solution source (the batch_tester protocol); ``u0=None``
    with ``test=True`` starts from the spatial profile G, as
    ``Solver*.test_init`` does.  ``mesh`` keys an unstructured case: the
    content hash of a registered point cloud (serve/meshes.py); ``shape``
    is then the node count ``(n,)``, ``eps``/``dh`` are carried by the mesh
    (set them 0), and the hash joins :meth:`bucket_key`.
    """

    shape: tuple
    nt: int
    eps: int
    k: float
    dt: float
    dh: float
    test: bool = True
    u0: np.ndarray | None = None
    mesh: str | None = None

    def bucket_key(self):
        return (tuple(int(s) for s in self.shape), int(self.nt), int(self.eps),
                bool(self.test), self.mesh)

    def physics(self):
        return (float(self.k), float(self.dt), float(self.dh))


class EnsembleReport:
    """Counters for one engine's lifetime (an 8-case same-shape bucket must
    read 1 program built and 1 dispatch), each backed by a metric of the
    report's own registry under the JAX package's names."""

    cases = backed("_m_cases")
    buckets = backed("_m_buckets")
    dispatches = backed("_m_dispatches")
    programs_built = backed("_m_programs_built")
    padded_cases = backed("_m_padded_cases")
    programs_evicted = backed("_m_programs_evicted")
    programs_resident = backed("_m_programs_resident")

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._m_cases = r.counter("/ensemble/cases")
        self._m_buckets = r.counter("/ensemble/buckets")
        self._m_dispatches = r.counter("/ensemble/dispatches")
        self._m_programs_built = r.counter("/ensemble/programs-built")
        self._m_padded_cases = r.counter("/ensemble/padded-cases")
        self._m_programs_evicted = r.counter("/store/evictions")
        self._m_programs_resident = r.gauge("/store/resident-programs")
        self.strategies: dict = {}

    def summary(self) -> str:
        return (f"{self.cases} cases -> {self.buckets} buckets, {self.dispatches} dispatches, "
                f"{self.programs_built} programs built ({self.padded_cases} padding lanes)")

    def metrics(self) -> dict:
        return {"cases": self.cases, "buckets": self.buckets, "dispatches": self.dispatches,
                "programs_built": self.programs_built, "padded_cases": self.padded_cases,
                "strategies": {str(k): v for k, v in self.strategies.items()}}

    def metrics_json(self) -> str:
        return json.dumps(self.metrics())


class EnsembleEngine:
    """Run a list of :class:`EnsembleCase` as few batched programs on
    ``device`` (the CUDA card unless ``device="cpu"``).

    ``variant`` selects the composition of a 2D ``cuda`` bucket:
    ``per-step`` (one ``batched_step2d`` launch per step), ``carried``
    (``batched_carried2d``), ``superstep`` (``batched_superstep2d``, needs
    ``ksteps >= 2``), ``stacked`` (each case's solo loop in turn), ``vmap``
    (the parity oracle) or ``auto`` (see the module docstring).  A request
    that cannot engage — carried or superstep on another bucket, or on a
    test bucket — is refused, never downgraded.
    """

    VARIANTS = ("auto", "per-step", "carried", "superstep", "stacked", "vmap")
    COMMS = ("collective", "fused")

    def __init__(self, method: str = "auto", precision: str = "f32", dtype=None,
                 variant: str = "auto", ksteps: int = 0,
                 comm: str = "collective", stepper: str = "euler", stages: int = 0,
                 program_store=None, program_cache_cap: int | None = None,
                 store_backend: str | None = None, device=None):
        from nonlocalheatequation_torch.models.steppers import validate_stepper

        if variant not in self.VARIANTS:
            raise ValueError(f"unknown ensemble variant {variant!r}; one of {self.VARIANTS}")
        if variant == "superstep" and ksteps < 2:
            raise ValueError("variant='superstep' needs ksteps >= 2")
        if comm not in self.COMMS:
            raise ValueError(f"unknown comm {comm!r}; one of {self.COMMS}")
        if comm == "fused":
            raise ValueError("comm='fused' (the fused halo-exchange engine) is not ported yet "
                             "to nonlocalheatequation_torch; use comm='collective'")
        validate_stepper(stepper, stages)
        if program_store is not None or store_backend is not None:
            raise ValueError("the AOT program store (program_store, store_backend) is not "
                             "ported yet to nonlocalheatequation_torch")
        cap = program_cache_cap if program_cache_cap is not None else PROGRAM_CACHE_CAP
        if cap < 0:
            raise ValueError(f"program_cache_cap must be >= 0, got {cap}")
        self.device = resolve_device(device)
        self.method = method
        self.precision = precision
        self.dtype = resolve_dtype(dtype, self.device)
        self.variant = variant
        self.ksteps = int(ksteps)
        self.comm = comm
        self.stepper = stepper
        self.stages = int(stages)
        #: ``auto`` tunes 2D cuda production buckets (NLHEAT_TUNE_BATCH=1), read
        #: once here so a cached program never outlives the rule it was built under
        self.tune_batch = os.environ.get("NLHEAT_TUNE_BATCH") == "1"
        self.report = EnsembleReport()
        #: LRU program cache, bounded at ``program_cache_cap`` (0 = unbounded)
        self._programs: OrderedDict = OrderedDict()
        self.program_cache_cap = cap

    def sibling(self, **overrides) -> "EnsembleEngine":
        """A fresh engine with this engine's settings except ``overrides``,
        with its own program cache and report."""
        kw = dict(method=self.method, precision=self.precision, dtype=self.dtype,
                  variant=self.variant, ksteps=self.ksteps,
                  comm=self.comm, stepper=self.stepper, stages=self.stages,
                  program_cache_cap=self.program_cache_cap, device=self.device)
        kw.update(overrides)
        return EnsembleEngine(**kw)

    def engine_key(self) -> tuple:
        """This engine's position on the picker's axes (stepper, stages,
        method, precision), as the JAX package keys its engine pools."""
        return (self.stepper, self.stages, self.method, self.precision)

    # -- case -> operator ---------------------------------------------------
    def _make_op(self, case: EnsembleCase):
        from nonlocalheatequation_torch.ops.nonlocal_op import (
            NonlocalOp1D,
            NonlocalOp2D,
            NonlocalOp3D,
        )

        if case.mesh is not None:
            # the registered point cloud under this case's physics
            # (serve/meshes.py caches the op; the stored edge table is checked)
            from nonlocalheatequation_torch.serve.meshes import get_mesh_op

            return get_mesh_op(case.mesh, case.k, case.dt, device=self.device)
        dim = len(case.shape)
        if dim == 1:
            # the port's 1D operator has one method; the 2D/3D settings map to it
            return NonlocalOp1D(case.eps, case.k, case.dt, case.dh, precision=self.precision)
        cls = NonlocalOp2D if dim == 2 else NonlocalOp3D
        return cls(case.eps, case.k, case.dt, case.dh, method=self.method,
                   precision=self.precision)

    # -- scheduling ---------------------------------------------------------
    def _chunks(self, idxs):
        """Split a bucket's case indices into top-batch-size runs."""
        top = BATCH_SIZES[-1]
        for start in range(0, len(idxs), top):
            yield idxs[start:start + top]

    def pad_chunk(self, chunk: list) -> list:
        """Pad a chunk UP to the smallest allowed batch size that fits by
        repeating its last case (callers drop the padding lanes)."""
        if len(chunk) > BATCH_SIZES[-1]:
            raise ValueError(f"chunk of {len(chunk)} cases exceeds the top batch size "
                             f"{BATCH_SIZES[-1]}; split it first (engine._chunks)")
        B = next(b for b in BATCH_SIZES if b >= len(chunk))
        pad = B - len(chunk)
        if pad:
            self.report.padded_cases += pad
            return chunk + [chunk[-1]] * pad
        return chunk

    def run(self, cases) -> list:
        """Solve every case; returns the final states (NumPy arrays of the
        engine's dtype) in submission order."""
        cases = list(cases)
        self.report.cases += len(cases)
        results: list = [None] * len(cases)
        buckets: dict = {}
        for i, case in enumerate(cases):
            buckets.setdefault(case.bucket_key(), []).append(i)
        self.report.buckets += len(buckets)
        for key, idxs in buckets.items():
            for part in self._chunks(idxs):
                with obs_trace.span("ensemble.chunk", cat="ensemble", bucket=str(key),
                                    cases=len(part)):
                    chunk = self.pad_chunk([cases[i] for i in part])
                    out = self._run_chunk(key, chunk)
                for j, i in enumerate(part):
                    results[i] = out[j]
        return results

    # -- one chunk = one program, one dispatch ------------------------------
    def build_program(self, key, chunk):
        """The chunk's multi-step callable, cached per (bucket, size,
        variant, physics, dtype) in a bounded LRU."""
        prog_key = (key, len(chunk), self.variant, tuple(c.physics() for c in chunk),
                    str(self.dtype))
        multi = self._programs.get(prog_key)
        if multi is None:
            with obs_trace.span("ensemble.build", cat="ensemble", bucket=str(key),
                                cases=len(chunk), variant=self.variant):
                ops = [self._make_op(c) for c in chunk]
                multi = self._build_program(key, chunk, ops, key[3])
            self._programs[prog_key] = multi
            self.report.programs_built += 1
            while self.program_cache_cap and len(self._programs) > self.program_cache_cap:
                self._programs.popitem(last=False)
                self.report.programs_evicted += 1
            self.report.programs_resident = len(self._programs)
        else:
            self._programs.move_to_end(prog_key)
        return multi

    def stage_inputs(self, chunk) -> torch.Tensor:
        """The stacked initial state, a fresh tensor on the engine's device."""
        return torch.as_tensor(np.stack([self._u0(c) for c in chunk])).to(
            device=self.device, dtype=self.dtype)

    def dispatch_chunk(self, multi, U0):
        """Launch the chunk's program (asynchronous on the card)."""
        out = multi(U0, 0)
        self.report.dispatches += 1
        return out

    def _run_chunk(self, key, chunk):
        multi = self.build_program(key, chunk)
        return self.dispatch_chunk(multi, self.stage_inputs(chunk)).cpu().numpy()

    def _u0(self, case: EnsembleCase) -> np.ndarray:
        if case.u0 is not None:
            return np.asarray(case.u0, np.float64).reshape(case.shape)
        if not case.test:
            raise ValueError("a production (test=False) EnsembleCase needs an initial "
                             "state u0")
        if case.mesh is not None:
            # the unstructured profile is evaluated at the node coordinates
            return self._make_op(case).spatial_profile()
        return self._make_op(case).spatial_profile(*case.shape)

    def _build_program(self, key, chunk, ops, test):
        from nonlocalheatequation_torch.ops import cuda_batched as cb
        from nonlocalheatequation_torch.ops.nonlocal_op import (
            make_batched_multi_step_fn_stacked,
            make_batched_multi_step_fn_vmap,
        )

        if chunk[0].mesh is not None:
            return self._build_mesh_program(key, ops, test)
        shape, nt = key[0], key[1]
        dim = len(shape)
        op0 = ops[0]
        gs = lgs = None
        if test:
            # (G, L(G)) as each rank's solo solver makes them (2D/3D: L(G) on
            # the device by the operator's own method; 1D: NumPy)
            parts = [op.source_parts_on(*shape, self.device) if dim > 1
                     else op.source_parts(*shape) for op in ops]
            gs = [g for g, _ in parts]
            lgs = [lg for _, lg in parts]
        resolved = op0.resolve_method(self.device) if dim > 1 else op0.method
        cuda2d = dim == 2 and resolved == "cuda" and op0.uniform
        variant = self.variant
        if variant in ("carried", "superstep"):
            # production schedules of the batched 2D kernels: a request that
            # cannot engage is refused, never silently downgraded
            if not cuda2d:
                raise ValueError(f"ensemble variant {variant!r} needs the 2D cuda method "
                                 f"(bucket resolved to {resolved!r}, dim {dim})")
            if test:
                raise ValueError(f"ensemble variant {variant!r} is production-only (the "
                                 "carried/superstep kernels carry no manufactured source); "
                                 "use per-step/stacked/vmap for --test_batch solves")
        if variant == "auto":
            if cuda2d and not test and self.tune_batch:
                from nonlocalheatequation_torch.utils.autotune import (
                    pick_batched_multi_step_fn,
                )

                fn, winner = pick_batched_multi_step_fn(ops, nt, shape, self.dtype,
                                                        self.device, ksteps=self.ksteps)
                self.report.strategies[key] = f"tuned:{winner}"
                return fn
            variant = "per-step" if cuda2d else "vmap"
        self.report.strategies[key] = self._label(variant, chunk, cuda2d)
        if variant == "vmap":
            return make_batched_multi_step_fn_vmap(ops, nt, dtype=self.dtype, test=test,
                                                   gs=gs, lgs=lgs)
        if variant == "stacked" or not cuda2d:
            # per-step on a bucket without the batched kernels: each case's
            # solo per-step loop is that schedule there
            return make_batched_multi_step_fn_stacked(ops, nt, dtype=self.dtype, test=test,
                                                      gs=gs, lgs=lgs)
        if variant == "carried":
            return cb.make_batched_carried_multi_step_fn(ops, nt, dtype=self.dtype)
        if variant == "superstep":
            return cb.make_batched_superstep_multi_step_fn(ops, nt, ksteps=self.ksteps,
                                                           dtype=self.dtype)
        return cb.make_batched_cuda_multi_step_fn(ops, nt, dtype=self.dtype, test=test,
                                                  gs=gs, lgs=lgs)

    def _build_mesh_program(self, key, ops, test):
        """A mesh bucket: every case shares the edge table (the hash is in
        the bucket key), physics may differ per lane.  Euler only, the
        stacked composition of each case's ``gather_L`` loop; what the tier
        cannot honour is refused, in the JAX package's words."""
        from nonlocalheatequation_torch.ops.gather import make_batched_gather_multi_step_fn

        if self.stepper != "euler":
            raise ValueError(f"mesh buckets are Euler-only (the gather tier has no "
                             f"{self.stepper!r} schedule)")
        if self.method not in ("auto", "gather"):
            raise ValueError(f"mesh buckets need method='gather' or 'auto' (engine has "
                             f"method={self.method!r})")
        if self.variant not in ("auto", "per-step", "stacked"):
            raise ValueError(f"ensemble variant {self.variant!r} has no gather form; mesh "
                             "buckets run 'auto'/'per-step'/'stacked'")
        self.report.strategies[key] = "gather[stacked]"
        return make_batched_gather_multi_step_fn(ops, key[1], dtype=self.dtype, test=test,
                                                 precision=self.precision, device=self.device)

    @staticmethod
    def _label(variant, chunk, cuda2d) -> str:
        """The strategy's name in the report: a batched-kernel variant says
        whether its chunk's physics was uniform or mixed (one launch serves
        both)."""
        if variant in ("vmap", "stacked") or not cuda2d:
            return variant
        form = "uniform" if len({c.physics() for c in chunk}) == 1 else "mixed"
        return f"{variant}[{form}]"


def run_test_cases(cases, **engine_kwargs):
    """The batch_tester protocol without Solver objects: run manufactured
    test cases through one engine; returns [(error_l2, n_points)] in
    submission order, the error against the float64 manufactured solution
    at t = nt, as the solvers compute it."""
    engine = EnsembleEngine(**engine_kwargs)
    cases = list(cases)
    states = engine.run(cases)
    out = []
    for case, u in zip(cases, states, strict=True):
        op = engine._make_op(case)
        want = (op.manufactured_solution(case.nt) if case.mesh is not None
                else op.manufactured_solution(*case.shape, case.nt))
        d = np.asarray(u, np.float64) - want
        out.append((float(np.sum(d * d)), int(np.prod(case.shape))))
    return out
