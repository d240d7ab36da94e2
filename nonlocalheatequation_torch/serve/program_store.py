"""Program store: the port's warm-boot layer — counterpart of
``nonlocalheatequation_tpu/serve/program_store.py``.

The reference is an ahead-of-time-compiled HPX binary: it pays no build
cost at startup.  The JAX package's store keeps AOT-compiled XLA
executables for the same reason.  The port traces and compiles no program;
a cold boot of it pays two other costs, and the store holds one kind of
entry for each:

* **library entries** — the bytes of a kernel library that ``nvcc`` built
  (ops/_build.py), keyed on ``_build.source_digest(source)``.  With the
  store on, ``_build`` restores a missing library from the store before it
  starts ``nvcc``, and saves a library it built (or found built) there.
* **program entries** — one per store key, as the ensemble engine and the
  solo path build a program: the RECIPE that fixed it, as JSON (the
  strategy, the tuner's winning variant and the record behind it,
  ``ms_per_step`` and any ``bf16_gate``), and the digests of the libraries
  the program launched on its first call.  A hit re-makes the program from
  the recipe (``materialize``) after restoring those libraries: ``build``
  never runs, so there is no probe launch and no ``nvcc`` run, and since
  every candidate of the tuner computes the same function, the program is
  bitwise the cold one.

Keying (never serve a wrong program):

* the **digest** (file name) hashes the caller's key (the engine passes
  ``repr((prog_key, method, precision, ksteps))``, the solo path its
  operator and step count), the example shape and dtype, the tuner knobs
  that change which program a key builds (:data:`TUNE_ENV_KNOBS`), and the
  backend name — the device type plus the card's name — so a CPU fallback
  sibling can never load a card entry;
* the **header** carries :data:`MAGIC`, the version fingerprint (torch,
  ``torch.version.cuda``, the package version, the nvcc flags and a digest
  of every kernel source), the topology (platform, device name and compute
  capability, device count, ``torch.distributed`` world size) and a CRC32
  of the payload.  Any mismatch raises a typed :class:`StoreRefusal`,
  printed on stderr and counted in ``/store/refusals{reason}``, and the
  caller builds afresh.

Writes go through ``utils/checkpoint.atomic_file`` (same-directory unique
tmp, fsync, ``os.replace``), so writers racing on one key leave one whole
winner.  ``NLHEAT_PROGRAM_STORE_CAP_MB`` bounds the directory: after each
save the least recently USED entries go (a hit refreshes its entry's
mtime), counted in ``/store/gc-evictions``.  Metrics: ``/store/hits``,
``/store/misses``, ``/store/saves``, ``/store/load-ms``,
``/store/serialize-ms``, ``/store/library-loads``,
``/store/library-saves``, and the ``store.load`` / ``store.save`` spans.

``NLHEAT_PROGRAM_STORE``: unset, ``0`` or empty = OFF (today's behaviour,
bitwise: nothing is read or written outside ``_build/`` and the tuner
cache); ``1`` = :data:`DEFAULT_DIR`; anything else is the directory.

TRUST BOUNDARY: a library entry is code this process loads.  The CRC,
fingerprint and topology checks are integrity checks, not authenticity:
whoever can write the store directory can run code in every process that
boots from it.  Directories are created ``0700``, and a group- or
world-writable store directory is refused.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import sys
import time
import zlib

from nonlocalheatequation_torch.obs import trace as obs_trace
from nonlocalheatequation_torch.obs.metrics import MetricsRegistry
from nonlocalheatequation_torch.utils.checkpoint import atomic_file

#: Entry format marker; bump on any layout change so old files refuse
#: loudly instead of decoding garbage.
MAGIC = b"NLPROGTORCH1\n"

#: Default store location for ``NLHEAT_PROGRAM_STORE=1``, beside the tuner's
#: ``autotune_torch.json``: the two packages never read each other's entries.
DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".cache", "nlheat", "program_store_torch")

#: Refusal reasons (the JAX package's words).
REFUSE_FINGERPRINT = "fingerprint-mismatch"
REFUSE_TOPOLOGY = "topology-mismatch"
REFUSE_CORRUPT = "corrupt"
REFUSE_UNSUPPORTED = "unsupported"

PROGRAM_SUFFIX = ".prog"
LIBRARY_SUFFIX = ".lib"

#: Env knobs that decide which program a key builds (the tuners'
#: dimensions): they join the digest, so an A/B of them never shares
#: entries.
TUNE_ENV_KNOBS = ("NLHEAT_TUNE_BATCH", "NLHEAT_TUNE_PRECISION", "NLHEAT_TUNE_METHOD")


class StoreRefusal(RuntimeError):
    """The store cannot serve (or persist) this entry.  Always recovered
    from — the caller builds afresh, never runs a wrong program — but LOUD:
    every refusal prints one stderr line and counts under
    ``/store/refusals{reason}``."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"program store refusal [{reason}]: {detail}")
        self.reason = reason
        self.detail = detail


def store_dir_from_env() -> str | None:
    """The configured store directory, or None when the store is off
    (unset/empty/``0``).  ``1`` selects :data:`DEFAULT_DIR`."""
    raw = os.environ.get("NLHEAT_PROGRAM_STORE", "")
    if raw in ("", "0"):
        return None
    if raw == "1":
        return DEFAULT_DIR
    return raw


def store_cap_from_env() -> int | None:
    """The on-disk size cap in BYTES from ``NLHEAT_PROGRAM_STORE_CAP_MB``
    (0/unset = unbounded; negatives refuse)."""
    raw = os.environ.get("NLHEAT_PROGRAM_STORE_CAP_MB", "")
    if raw in ("", "0"):
        return None
    mb = float(raw)
    if mb < 0:
        raise ValueError(f"NLHEAT_PROGRAM_STORE_CAP_MB must be >= 0, got {raw!r}")
    return int(mb * 1024 * 1024)


@functools.lru_cache(maxsize=1)
def version_fingerprint() -> dict:
    """The build half of the load-time check: torch, its CUDA, the package
    version, the nvcc flags and a digest of every kernel source."""
    import torch

    from nonlocalheatequation_torch import __version__
    from nonlocalheatequation_torch.ops import _build

    kernels = hashlib.sha256("".join(_build.source_digest(s) for s in _build.ALL_SOURCES)
                             .encode()).hexdigest()[:16]
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "package": __version__,
            "nvcc_flags": " ".join(_build.NVCC_FLAGS), "kernels": kernels}


def backend_name(device=None) -> str:
    """The store's name of a backend: ``"cpu"``, or ``"cuda:<card name>"``
    (``device`` None: the current card where there is one)."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return f"cuda:{torch.cuda.get_device_name(device)}"


def topology_fingerprint(backend: str) -> dict:
    """The topology half of the load-time check for ``backend``: platform,
    device name and compute capability, device count, world size."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if not backend.startswith("cuda"):
        return {"platform": backend, "device_kind": backend, "capability": None,
                "devices": 1, "world": world}
    dev = torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(dev)
    return {"platform": "cuda", "device_kind": torch.cuda.get_device_name(dev),
            "capability": f"{major}.{minor}", "devices": torch.cuda.device_count(),
            "world": world}


def _tune_env_desc() -> str:
    return ";".join(f"{k}={os.environ.get(k, '')}" for k in TUNE_ENV_KNOBS)


def _example_desc(example_args) -> str:
    """Each example argument as shape and dtype (a tensor, ``meta`` tensors
    included) or as a literal."""
    parts = []
    for a in example_args:
        if hasattr(a, "shape") and hasattr(a, "dtype"):
            parts.append(f"t{tuple(a.shape)}:{str(a.dtype).replace('torch.', '')}")
        else:
            parts.append(f"lit:{type(a).__name__}:{a!r}")
    return ";".join(parts)


def _digest(kind: str, key_desc: str, example_desc: str, backend: str) -> str:
    h = hashlib.sha256()
    for part in (MAGIC.decode(), kind, key_desc, example_desc, backend, _tune_env_desc()):
        h.update(part.encode())
        h.update(b"\x00")
    return h.hexdigest()


class ProgramStore:
    """One store directory and its counters.  Shared by sibling engines (the
    backend joins the digest); every failure mode degrades to a fresh
    build.  ``registry`` receives the ``/store/*`` metrics (the ensemble
    engine passes its report's registry, so the serving expositions carry
    them)."""

    def __init__(self, root: str, registry: MetricsRegistry | None = None,
                 cap_bytes: int | None = None):
        self.root = str(root)
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._m_hits = r.counter("/store/hits")
        self._m_misses = r.counter("/store/misses")
        self._m_saves = r.counter("/store/saves")
        self._m_refusals = r.labeled("/store/refusals")
        self._m_gc_evictions = r.counter("/store/gc-evictions")
        self._m_lib_loads = r.counter("/store/library-loads")
        self._m_lib_saves = r.counter("/store/library-saves")
        self._h_load_ms = r.histogram("/store/load-ms")
        self._h_serialize_ms = r.histogram("/store/serialize-ms")
        if cap_bytes is None:
            cap_bytes = store_cap_from_env()
        if cap_bytes is not None and cap_bytes <= 0:
            cap_bytes = None  # 0 = unbounded
        self.cap_bytes = cap_bytes

    # -- programs -----------------------------------------------------------
    def load_or_build(self, key_desc: str, build, example_args, backend: str | None = None,
                      materialize=None):
        """The one entry point for programs: return ``(callable, outcome)``.

        ``build()`` returns ``(fn, recipe)``: the program and the JSON-able
        recipe that fixed it.  ``materialize(recipe)`` re-makes the program
        from a stored recipe without probing or compiling.  The outcome is
        ``"hit"`` (a stored recipe, its libraries restored; ``build`` never
        ran), ``"miss"`` (``build()``'s program; its entry is written once
        its first call has launched, so the entry names the libraries it
        launched) or ``"plain"`` (the store refused its directory:
        ``build()``'s program, nothing written)."""
        if not self._root_ok():
            return build()[0], "plain"
        backend = backend or backend_name()
        path = os.path.join(self.root, _digest("program", key_desc,
                                               _example_desc(example_args), backend)
                            + PROGRAM_SUFFIX)
        raw = self._read(path, backend)
        if raw is not None:
            try:
                recipe = json.loads(raw.decode())
                self._restore_libraries(recipe.get("libs") or {}, backend)
                fn = materialize(recipe)
            except StoreRefusal as e:
                self._refuse(e.reason, e.detail)
            except Exception as e:  # noqa: BLE001 — a recipe this build cannot re-make
                self._refuse(REFUSE_CORRUPT, f"{path}: recipe cannot be re-made "
                                             f"({type(e).__name__}: {e})")
            else:
                self._m_hits.inc()
                return fn, "hit"
        self._m_misses.inc()
        fn, recipe = build()
        return self._save_on_first_call(fn, recipe, path, key_desc, backend), "miss"

    def _save_on_first_call(self, fn, recipe: dict, path: str, key_desc: str, backend: str):
        """``fn``, wrapped so that its first call that returns writes the
        entry, with the libraries that call launched (``cuda_kernel.LAUNCHES``
        before and after), and saves those libraries too."""
        done = []

        def program(*args, **kwargs):
            if done:
                return fn(*args, **kwargs)
            from nonlocalheatequation_torch.ops import _build, cuda_kernel

            before = cuda_kernel.launch_counts()
            out = fn(*args, **kwargs)
            after = cuda_kernel.launch_counts()
            done.append(True)
            sources = sorted({cuda_kernel.LAUNCH_SOURCES[k] for k, n in after.items()
                              if n > before.get(k, 0)})
            for source in sources:
                self.save_library(source, backend)
            self._write(path, json.dumps({**recipe, "libs": {
                s: _build.source_digest(s) for s in sources}}, sort_keys=True).encode(),
                key_desc, backend, "program")
            return out

        return program

    def _restore_libraries(self, libs: dict, backend: str) -> None:
        """Put every library a stored program launches into ``_build/``,
        from the store where it is missing; refuse an entry whose library is
        not this build's or that the store cannot supply."""
        from nonlocalheatequation_torch.ops import _build

        for source, digest in libs.items():
            if digest != _build.source_digest(source):
                raise StoreRefusal(REFUSE_FINGERPRINT, f"the stored program launches {source} "
                                   f"of digest {digest}, this build's is "
                                   f"{_build.source_digest(source)}")
            if not _build.library_path(source).exists() and not self.load_library(source,
                                                                                   backend):
                raise StoreRefusal(REFUSE_CORRUPT, f"the stored program launches {source}, "
                                   "whose library the store does not hold")

    # -- libraries ----------------------------------------------------------
    def _library_path(self, source: str, backend: str) -> str:
        from nonlocalheatequation_torch.ops import _build

        key = f"lib|{source}|{_build.source_digest(source)}"
        return os.path.join(self.root, _digest("library", key, "", backend) + LIBRARY_SUFFIX)

    def load_library(self, source: str, backend: str | None = None) -> bool:
        """Write the stored library of ``source`` to its place in
        ``_build/``; False when the store does not hold it (or refused
        it, loudly)."""
        if not self._root_ok():
            return False
        from nonlocalheatequation_torch.ops import _build

        backend = backend or backend_name()
        raw = self._read(self._library_path(source, backend), backend)
        if raw is None:
            return False
        target = _build.library_path(source)
        target.parent.mkdir(parents=True, exist_ok=True)
        with atomic_file(str(target), "wb") as f:
            f.write(raw)
        self._m_lib_loads.inc()
        return True

    def save_library(self, source: str, backend: str | None = None) -> None:
        """Save the built library of ``source`` (from ``_build/``) unless
        the store holds it already."""
        if not self._root_ok():
            return
        from nonlocalheatequation_torch.ops import _build

        backend = backend or backend_name()
        path = self._library_path(source, backend)
        if os.path.exists(path):
            return
        try:
            raw = _build.library_path(source).read_bytes()
        except OSError as e:
            self._refuse(REFUSE_UNSUPPORTED, f"{source}: no built library to save ({e})")
            return
        if self._write(path, raw, f"lib|{source}|{_build.source_digest(source)}", backend,
                       "library"):
            self._m_lib_saves.inc()

    # -- stats --------------------------------------------------------------
    def stats(self) -> dict:
        """Counter snapshot."""
        return {
            "hits": self._m_hits.value,
            "misses": self._m_misses.value,
            "saves": self._m_saves.value,
            "gc_evictions": self._m_gc_evictions.value,
            "refusals": dict(self._m_refusals),
            "library_loads": self._m_lib_loads.value,
            "library_saves": self._m_lib_saves.value,
        }

    # -- internals ----------------------------------------------------------
    def _root_ok(self) -> bool:
        """False (with a loud refusal) when the store directory exists and
        is group- or world-writable: its entries are code this process
        loads."""
        try:
            mode = os.stat(self.root).st_mode
        except FileNotFoundError:
            return True  # made 0700 at the first save
        except OSError as e:
            self._refuse(REFUSE_UNSUPPORTED, f"{self.root}: cannot stat ({e})", once=True)
            return False
        if mode & 0o022:
            self._refuse(REFUSE_UNSUPPORTED, f"{self.root} is group- or world-writable "
                         f"(mode {oct(mode & 0o777)}); a store entry is code this process "
                         "loads", once=True)
            return False
        return True

    def _refuse(self, reason: str, detail: str, once: bool = False) -> None:
        if once and self._m_refusals.get(reason):
            self._m_refusals[reason] += 1
            return
        self._m_refusals[reason] = self._m_refusals.get(reason, 0) + 1
        print(f"program store refusal [{reason}]: {detail} — falling back to a fresh build",
              file=sys.stderr)

    def _read(self, path: str, backend: str) -> bytes | None:
        """An entry's verified payload, or None (a missing entry is a silent
        miss; every other failure a loud typed refusal)."""
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        except OSError as e:
            self._refuse(REFUSE_CORRUPT, f"{path}: unreadable ({e})")
            return None
        t0 = time.perf_counter()
        try:
            payload = self._decode(raw, path, backend)
        except StoreRefusal as e:
            self._refuse(e.reason, e.detail)
            return None
        ms = (time.perf_counter() - t0) * 1e3
        self._h_load_ms.observe(ms)
        try:
            # a hit marks its entry recently USED: the GC evicts by mtime
            os.utime(path, None)
        except OSError:
            pass  # a racing GC deleted it after our read
        with obs_trace.span("store.load", cat="store", ms=round(ms, 3),
                            path=os.path.basename(path)):
            pass
        return payload

    def _decode(self, raw: bytes, path: str, backend: str) -> bytes:
        if not raw.startswith(MAGIC):
            raise StoreRefusal(REFUSE_CORRUPT, f"{path}: bad magic (foreign or torn file)")
        body = raw[len(MAGIC):]
        if len(body) < 8:
            raise StoreRefusal(REFUSE_CORRUPT, f"{path}: truncated header")
        hlen = int.from_bytes(body[:8], "little")
        if len(body) < 8 + hlen:
            raise StoreRefusal(REFUSE_CORRUPT, f"{path}: truncated header")
        try:
            header = json.loads(body[8:8 + hlen].decode())
        except Exception as e:
            raise StoreRefusal(REFUSE_CORRUPT, f"{path}: unreadable header ({e})") from e
        payload = body[8 + hlen:]
        if len(payload) != header.get("payload_len", -1):
            raise StoreRefusal(REFUSE_CORRUPT, f"{path}: payload truncated ({len(payload)} "
                               f"of {header.get('payload_len')} bytes)")
        if zlib.crc32(payload) != header.get("payload_crc"):
            raise StoreRefusal(REFUSE_CORRUPT, f"{path}: payload failed its integrity check "
                               "(torn write, disk fault)")
        for reason, saved, now, what in (
                (REFUSE_FINGERPRINT, header.get("fingerprint", {}), version_fingerprint(),
                 "entries never cross builds"),
                (REFUSE_TOPOLOGY, header.get("topology", {}), topology_fingerprint(backend),
                 "entries never cross topologies")):
            if saved != now:
                diff = {k: (saved.get(k), now.get(k)) for k in set(saved) | set(now)
                        if saved.get(k) != now.get(k)}
                raise StoreRefusal(reason, f"{path}: saved under {diff} (saved, current) — "
                                   f"{what}")
        return payload

    def _write(self, path: str, payload: bytes, key_desc: str, backend: str,
               kind: str) -> bool:
        """Atomically persist one entry; failures are loud refusals, never
        errors (the built program still serves this process)."""
        t0 = time.perf_counter()
        header = json.dumps({
            "key": key_desc,
            "kind": kind,
            "backend": backend,
            "fingerprint": version_fingerprint(),
            "topology": topology_fingerprint(backend),
            "payload_len": len(payload),
            "payload_crc": zlib.crc32(payload),
        }).encode()
        try:
            # 0700: the trust boundary (module docstring); a directory that
            # exists keeps its mode, and _root_ok refuses an open one
            os.makedirs(self.root, mode=0o700, exist_ok=True)
            with atomic_file(path, "wb") as f:
                f.write(MAGIC)
                f.write(len(header).to_bytes(8, "little"))
                f.write(header)
                f.write(payload)
        except OSError as e:
            self._refuse(REFUSE_UNSUPPORTED, f"{path}: store write failed ({e}); entry not "
                         "persisted")
            return False
        ms = (time.perf_counter() - t0) * 1e3
        self._h_serialize_ms.observe(ms)
        self._m_saves.inc()
        with obs_trace.span("store.save", cat="store", ms=round(ms, 3), bytes=len(payload),
                            path=os.path.basename(path)):
            pass
        self._gc(keep=path)
        return True

    def _gc(self, keep: str | None = None) -> int:
        """Size-capped LRU eviction over the store directory: oldest-mtime
        entries go first (hits refresh mtime, so mtime order IS use order);
        the entry just written is never evicted by its own save.  Returns
        the number of entries THIS process removed; a FileNotFoundError
        mid-delete is a concurrent GC's win, skipped silently, and any other
        OSError ends the pass as a loud refusal."""
        if self.cap_bytes is None:
            return 0
        try:
            entries = []
            with os.scandir(self.root) as it:
                for de in it:
                    if not de.name.endswith((PROGRAM_SUFFIX, LIBRARY_SUFFIX)):
                        continue
                    try:
                        st = de.stat()
                    except FileNotFoundError:
                        continue  # a racing GC or writer: already gone
                    entries.append((st.st_mtime, st.st_size, de.path))
        except OSError:
            return 0
        total = sum(sz for _, sz, _ in entries)
        removed = 0
        for _mtime, sz, path in sorted(entries):
            if total <= self.cap_bytes:
                break
            if keep is not None and os.path.abspath(path) == os.path.abspath(keep):
                continue
            try:
                os.remove(path)
            except FileNotFoundError:
                total -= sz  # another process evicted it: the same outcome
                continue
            except OSError as e:
                self._refuse(REFUSE_UNSUPPORTED, f"store GC cannot remove {path}: {e}")
                break
            total -= sz
            removed += 1
            self._m_gc_evictions.inc()
        return removed


def resolve_store(program_store, registry=None):
    """The callers' one resolution rule: a :class:`ProgramStore` instance is
    used as is; a path opens a store there; ``None`` consults
    ``NLHEAT_PROGRAM_STORE`` (off when unset).  ``registry`` is bound only
    when this call constructs the store."""
    if isinstance(program_store, ProgramStore):
        return program_store
    if program_store is not None:
        return ProgramStore(str(program_store), registry=registry)
    d = store_dir_from_env()
    if d is None:
        return None
    return ProgramStore(d, registry=registry)


def library_store():
    """The store ``ops/_build.py`` keeps libraries in, or None when the store
    is off; its counters live in the process registry."""
    from nonlocalheatequation_torch.obs.metrics import REGISTRY

    return resolve_store(None, registry=REGISTRY)


# -- the solo path (ops/nonlocal_op.make_multi_step_fn) ----------------------------------

def solo_key_desc(op, nsteps: int, dtype) -> str:
    """The tuned solo program's identity: the operator's class, method,
    physics, precision tier and influence weights, the step count and the
    state dtype."""
    import numpy as np

    spacing = getattr(op, "dh", None)
    if spacing is None:
        spacing = getattr(op, "dx", 0.0)
    parts = ["solo", type(op).__name__, getattr(op, "method", ""), repr(int(op.eps)),
             repr(float(op.k)), repr(float(op.dt)), repr(float(spacing)),
             getattr(op, "precision", "f32"),
             repr(int(getattr(op, "resync_every", 0) or 0)), repr(int(nsteps)),
             str(dtype).replace("torch.", ""), repr(bool(getattr(op, "uniform", True)))]
    if not getattr(op, "uniform", True):
        w = np.ascontiguousarray(np.asarray(op.weights))
        parts.append(hashlib.sha256(w.tobytes()).hexdigest())
    return "|".join(parts)


def solo_pick(op, nsteps: int, shape, dtype, device):
    """``autotune.pick_multi_step_fn(...)[0]`` through the store: with the
    store off exactly that call; with it on, a warm solve re-makes the
    recorded winner (``autotune.solo_maker``) with its record adopted, and
    runs no probe."""
    import torch

    from nonlocalheatequation_torch.utils import autotune

    store = library_store()
    if store is None:
        return autotune.pick_multi_step_fn(op, nsteps, shape, dtype, device)[0]
    shape = tuple(int(s) for s in shape)

    def build():
        fn, winner = autotune.pick_multi_step_fn(op, nsteps, shape, dtype, device)
        key = autotune.tuning_key(op, shape, dtype, device)
        return fn, {"strategy": f"tuned:{winner}", "winner": winner,
                    "tuning": {key: autotune.records()[key]}}

    def materialize(recipe):
        autotune.adopt_records(recipe["tuning"])
        return autotune.solo_maker(recipe["winner"])(op, nsteps, dtype)

    fn, _ = store.load_or_build(solo_key_desc(op, nsteps, dtype), build,
                                (torch.empty(shape, dtype=dtype, device="meta"),),
                                backend=backend_name(device), materialize=materialize)
    return fn
