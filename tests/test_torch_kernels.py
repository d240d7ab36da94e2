"""The port's kernel plain versions against the JAX package's Pallas kernels.

On the CPU the JAX kernels run in Pallas interpret mode (the JAX suite's
own way, tests/conftest.py forces CPU and x64), so the grids stay at 48^2 or
less.  The port's wrappers route CPU tensors to the plain versions; the
CUDA kernels themselves run only on a card (tests/test_torch_card.py and
chip_smoke.py).

Tolerances: float64 1e-12 relative to the largest magnitude of the result
(the two sum the stencil in different orders); the bf16 operand forms are
compared in float32, 1e-5, since both round the same float32 operand to
bfloat16 and accumulate in float32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nonlocalheatequation_torch.ops import _build
from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, case_scale
from nonlocalheatequation_tpu.ops.nonlocal_op import NonlocalOp2D as JaxOp2D
from nonlocalheatequation_tpu.ops.pallas_kernel import (
    build_neighbor_sum_2d,
    make_pallas_step_fn,
)

# small grids: one intra-op thread keeps parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

SHAPES = [(48, 48, 8), (37, 29, 5), (10, 12, 7), (1, 1, 3), (24, 40, 1),
          # csrc/nsum2d.cu's register walk at its top eps (16), the tile body
          # above it (17), a padded row of 7 + 34 = 41 cells (no 16-byte copies)
          (20, 36, 16), (12, 7, 17)]
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _rel(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.mark.parametrize("nx,ny,eps", SHAPES)
@pytest.mark.parametrize("precision,dtype", [("f32", np.float64), ("bf16", np.float32)])
def test_plain_nsum2d_matches_pallas(nx, ny, eps, precision, dtype):
    rng = np.random.default_rng(nx * 1000 + ny * 10 + eps)
    upad = rng.standard_normal((nx + 2 * eps, ny + 2 * eps)).astype(dtype)
    ref = build_neighbor_sum_2d(eps, nx, ny, np.dtype(dtype).name, precision=precision)(
        jnp.asarray(upad))
    got = ck.nsum2d(torch.from_numpy(upad), eps, precision)  # CPU tensor -> plain
    assert got.dtype == torch.from_numpy(upad).dtype
    assert _rel(got.numpy(), ref) <= TOL[dtype]


@pytest.mark.parametrize("nx,ny,eps", SHAPES[:3])
@pytest.mark.parametrize("test", [False, True])
@pytest.mark.parametrize("precision,dtype", [("f32", np.float64), ("bf16", np.float32)])
def test_plain_step2d_matches_pallas_step(nx, ny, eps, test, precision, dtype):
    rng = np.random.default_rng(7 + eps)
    u = rng.standard_normal((nx, ny)).astype(dtype)
    k, dh = 0.5, 0.02
    jop = JaxOp2D(eps, k, 1.0, dh, method="pallas", precision=precision)
    dt = 0.8 / (jop.c * dh * dh * jop.wsum)
    jop = JaxOp2D(eps, k, dt, dh, method="pallas", precision=precision)
    top = NonlocalOp2D(eps, k, dt, dh, method="cuda", precision=precision)
    g, lg = jop.source_parts(nx, ny) if test else (None, None)
    jstep = make_pallas_step_fn(jop, g, lg, dtype=jnp.dtype(dtype))
    for t in (0, 3):
        ref = jstep(jnp.asarray(u), t)
        kw = {}
        if test:
            kw = dict(g=torch.tensor(g, dtype=torch.from_numpy(u).dtype),
                      lg=torch.tensor(lg, dtype=torch.from_numpy(u).dtype), t=t)
        got = ck.step2d(torch.from_numpy(u), eps, case_scale(top), top.wsum, dt,
                        precision=precision, **kw)
        assert _rel(got.numpy(), ref) <= TOL[dtype], (t, test)


def test_cpu_tensors_take_the_plain_version_and_do_not_count():
    ck.reset_launch_counts()
    u = torch.randn(9, 11, dtype=torch.float64)
    out = torch.empty_like(u)
    got = ck.step2d(u, 2, 1.5, 13.0, 0.01, out=out)
    assert got is out
    assert torch.equal(got, ck.step2d_plain(u, 2, 1.5, 13.0, 0.01))
    assert torch.equal(ck.nsum2d(torch.nn.functional.pad(u, (2, 2, 2, 2)), 2),
                       ck.nsum2d_plain(torch.nn.functional.pad(u, (2, 2, 2, 2)), 2))
    assert set(ck.launch_counts().values()) == {0}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solo_step_tables_are_made_once(monkeypatch, dtype):
    # step2d and carried2d read (scale, dt) and the test form's (coef_g,
    # coef_lg) from device tables (one batched launch at B=1): made once and
    # cached, rounded once from the host's float64, the coefficients
    # COEF_ROWS steps a table, so a loop of steps copies nothing a step
    monkeypatch.setattr(ck, "_TABLES", type(ck._TABLES)())
    like = torch.zeros(3, dtype=dtype)
    params = ck._params_row(2.5, 1e-3, like)
    assert ck._params_row(2.5, 1e-3, like) is params
    assert torch.equal(params, torch.tensor([[2.5, 1e-3]], dtype=torch.float64).to(dtype))
    rows = [ck._coef_row(t, 1e-3, like) for t in range(0, 2 * ck.COEF_ROWS, 7)]
    assert len(ck._TABLES) == 3  # one params row, two coefficient tables
    for t, row in zip(range(0, 2 * ck.COEF_ROWS, 7), rows, strict=True):
        assert row.shape == (1, 2) and row.is_contiguous()
        want = torch.tensor([ck.source_coefs(t, 1e-3)], dtype=torch.float64).to(dtype)
        assert torch.equal(row, want), t
    ck._coef_row(301, 1e-3, like)
    assert len(ck._TABLES) == 3  # step 301 is a row of the second table
    for i in range(ck._TABLES_KEPT + 5):  # least recently used tables go first
        ck._params_row(1.0 + i, 1e-3, like)
    assert len(ck._TABLES) == ck._TABLES_KEPT


def test_wrappers_refuse_bad_arguments():
    u = torch.randn(6, 6, dtype=torch.float64)
    with pytest.raises(ValueError, match="both g and lg"):
        ck.step2d(u, 1, 1.0, 5.0, 0.1, g=u)
    with pytest.raises(ValueError, match="too small"):
        ck.nsum2d(torch.zeros(3, 9, dtype=torch.float64), 2)
    with pytest.raises(ValueError, match="unknown precision tier"):
        ck.nsum2d(torch.zeros(9, 9, dtype=torch.float64), 2, "fp8")
    # the kernel library alone decides its limits (csrc/nsum2d.cu): its
    # refusal (-1) is a ValueError, any other non-zero status a CUDA error
    x = torch.randn(5, 5, dtype=torch.float64)
    with pytest.raises(ValueError, match=r"eps=70 on a \(5, 5\) torch.float64 tensor is beyond"):
        ck._raise_on(-1, "nsum2d", 70, x)
    with pytest.raises(RuntimeError, match="step2d launch failed: cudaGetLastError 700"):
        ck._raise_on(700, "step2d", 8, x)
    ck._raise_on(0, "step2d", 8, x)
    assert ck.step2d(x, 1, 1.0, 5.0, 0.0).equal(x)  # dt = 0 leaves the state as is


@pytest.mark.parametrize("ok", [True, False])
def test_build_is_keyed_on_the_source_and_reports_compiler_failure(tmp_path, monkeypatch, ok):
    # a stand-in compiler: nvcc does not run on this host
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + (
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && : > "$2"; shift; done\n'
        "echo 'ptxas info: Used 40 registers'\n" if ok else "echo 'error: boom'; exit 2\n"))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    lib = _build.library_path(ck.SOURCE)
    assert lib.parent == tmp_path / "_build" and lib.name.startswith("libnsum2d-")
    if not ok:
        with pytest.raises(RuntimeError, match="nvcc failed on nsum2d.cu .rc 2.:\nerror: boom"):
            _build.build()
        assert list(lib.parent.iterdir()) == []
        return
    first = _build.build()
    assert first[ck.SOURCE] > 0.0 and lib.is_file()
    assert "Used 40 registers" in lib.with_suffix(".log").read_text()
    assert _build.build() == {s: 0.0 for s in _build.SOURCES}  # same sources and flags: reused
