"""The port's halo path (ops/cuda_halo.py, parallel/halo.py, parallel/mesh.py)
against the JAX package's (ops/pallas_halo.py, parallel/halo.py) on the CPU.

The JAX side runs as its own suite runs it: the split kernels in Pallas
interpret mode, the band exchange under ``shard_map`` on the suite's 8
virtual CPU devices (tests/conftest.py).  The JAX package's in-kernel
exchange (``build_fused_nsum_2d/3d``) runs only on a TPU; off it, its
compute body is the split kernel on the exchanged frame, which is what the
port's in-kernel-exchange sums are held to here.  The port's wrappers route
CPU tensors to their plain versions; the CUDA kernels run only on a card
(tests/test_torch_card.py, chip_smoke.py).

Tolerances: the exchange plan, byte counts, mesh shapes and exchanged
frames are equal; the plain split sums hold the Pallas split kernels to
1e-12 (float64, relative to the largest magnitude: the two sum the stencil
in different orders) and, on the bf16 operand tier in float32, to
``BF16_L2_BUDGET``; the split sum is bitwise the one-pass sum on the same
frame, and the fused operator (either transport) bitwise the collective
one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from nonlocalheatequation_torch.ops import cuda_halo as th
from nonlocalheatequation_torch.ops import cuda_kernel as ck
from nonlocalheatequation_torch.ops import cuda_kernel3d as k3
from nonlocalheatequation_torch.ops.constants import BF16_L2_BUDGET
from nonlocalheatequation_torch.ops.nonlocal_op import NonlocalOp2D, NonlocalOp3D
from nonlocalheatequation_torch.parallel import halo as thalo
from nonlocalheatequation_torch.parallel import mesh as tmesh
from nonlocalheatequation_torch.serve.ensemble import EnsembleCase, EnsembleEngine
from nonlocalheatequation_tpu.ops import pallas_halo as jh
from nonlocalheatequation_tpu.ops.pallas_kernel import _strip_plan_3d, _window_pad
from nonlocalheatequation_tpu.parallel import halo as jhalo
from nonlocalheatequation_tpu.parallel import mesh as jmesh
from nonlocalheatequation_tpu.utils.compat import shard_map

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _rel(a, b) -> float:
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)) / max(np.max(np.abs(b)), 1e-300))


# -- the exchange geometry -----------------------------------------------------------

PLANS = [((4, 2), (16, 8), 3), ((4, 1), (8, 8), 9), ((2, 1), (8, 8), 9), ((2, 4), (16, 8), 3),
         ((4, 2), (8, 8), 17), ((2, 2, 2), (4, 4, 4), 5), ((2, 2, 2), (4, 4, 4), 2),
         ((1, 3), (5, 7), 4), ((3, 3), (2, 2), 5)]


@pytest.mark.parametrize("mesh_shape,block,eps", PLANS)
def test_plan_stats_and_bytes_equal_jax(mesh_shape, block, eps):
    assert th.plan_exchange(mesh_shape, block, eps) == tuple(
        th.HaloMsg(m.offset, m.src, m.dst) for m in jh.plan_exchange(mesh_shape, block, eps))
    plan = th.plan_exchange(mesh_shape, block, eps)
    for itemsize in (4, 8):
        assert th.plan_bytes(plan, itemsize) == jh.plan_bytes(
            jh.plan_exchange(mesh_shape, block, eps), itemsize)
        assert th.collective_bytes(mesh_shape, block, eps, itemsize) == jh.collective_bytes(
            mesh_shape, block, eps, itemsize)
        for comm in ("collective", "fused"):
            assert th.halo_stats(mesh_shape, block, eps, comm, itemsize) == jh.halo_stats(
                mesh_shape, block, eps, comm, itemsize)
    for bs in block:
        assert thalo.hop_widths(eps, bs) == jhalo.hop_widths(eps, bs)
    assert th.degenerate(block, eps) == jh._degenerate(block, eps)


def test_plan_rank_mismatch_is_refused():
    with pytest.raises(ValueError, match="disagree in rank"):
        th.plan_exchange((2, 2), (8, 8, 8), 1)


def test_mesh_factoring_equals_jax():
    for n in range(1, 33):
        assert tmesh.factor_devices(n) == jmesh.factor_devices(n)
        assert tmesh.factor_devices_3d(n) == jmesh.factor_devices_3d(n)


def test_meshes_of_virtual_devices():
    devs = tmesh.device_list("cpu", 8)
    assert devs == [CPU] * 8
    m = tmesh.make_mesh(devices=devs)
    assert m.shape == {"x": 4, "y": 2} and m.size == 8
    m3 = tmesh.make_mesh_3d(devices=devs)
    assert m3.shape == {"x": 2, "y": 2, "z": 2} and m3.axis_names == ("x", "y", "z")
    with pytest.raises(ValueError, match="needs 16 devices"):
        tmesh.make_mesh(4, 4, devs)
    with pytest.raises(ValueError, match="disagree in rank"):
        tmesh.create_mesh(("x", "y"), (8,), devs)
    # the entry points' default is the card: no quiet CPU fallback
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tmesh.device_list()


def test_scatter_gather_round_trip():
    u = np.random.default_rng(0).normal(size=(12, 10))
    mesh = tmesh.make_mesh(3, 2, tmesh.device_list("cpu", 6))
    blocks = tmesh.put_global(u, mesh, torch.float64)
    assert blocks.shape == (3, 2) and tuple(blocks[1, 1].shape) == (4, 5)
    assert np.array_equal(blocks[2, 1].numpy(), u[8:12, 5:10])
    assert np.array_equal(tmesh.fetch_global(blocks), u)
    u3 = np.random.default_rng(1).normal(size=(4, 6, 8))
    mesh3 = tmesh.make_mesh_3d(2, 3, 2, tmesh.device_list("cpu", 12))
    assert np.array_equal(tmesh.fetch_global(tmesh.put_global(u3, mesh3, torch.float64)), u3)


@pytest.mark.parametrize("mesh_shape,block,eps", [((4, 2), (8, 8), 3), ((4, 2), (5, 5), 7),
                                                  ((2, 4), (8, 4), 9), ((2, 2, 2), (4, 4, 4), 5)])
def test_exchanged_frames_equal_jax(mesh_shape, block, eps):
    # the same global field through both exchanges: every block's frame is equal
    names = ("x", "y", "z")[:len(mesh_shape)]
    grid = tuple(m * b for m, b in zip(mesh_shape, block))
    u = np.random.default_rng(eps).normal(size=grid)
    jm = (jmesh.make_mesh(*mesh_shape) if len(mesh_shape) == 2
          else jmesh.make_mesh_3d(*mesh_shape, devices=jax.devices()[:8]))
    f = shard_map(lambda b: jhalo.halo_pad_nd(b, eps, mesh_shape, names), mesh=jm,
                  in_specs=P(*names), out_specs=P(*names), check_vma=False)
    stacked = np.asarray(jax.jit(f)(jnp.asarray(u)))  # each block's frame, stacked
    tm = tmesh.create_mesh(names, mesh_shape, tmesh.device_list("cpu", int(np.prod(mesh_shape))))
    frames = thalo.halo_pad_nd(tmesh.put_global(u, tm, torch.float64), eps)
    fshape = tuple(b + 2 * eps for b in block)
    for pos in np.ndindex(*mesh_shape):
        sl = tuple(slice(p * s, (p + 1) * s) for p, s in zip(pos, fshape))
        assert np.array_equal(frames[pos].numpy(), stacked[sl]), pos


# -- the split kernels' plain versions -------------------------------------------------

# the last four: the shapes csrc/split_nsum2d.cu's partition on its walk's
# lattice brings in: eps 16 (the walk's top) and 17 (the tile body's
# partition), a block whose rows hold no lattice tile of 64 or 128 rows
# inside [eps, bx-eps) (the interior falls back to it), an unaligned by
CASES_2D = [(24, 16, 3), (8, 8, 1), (8, 8, 2), (6, 16, 3), (8, 8, 9), (37, 29, 5), (12, 20, 4),
            (40, 36, 16), (38, 35, 17), (100, 40, 8), (36, 21, 4)]


@pytest.mark.parametrize("bx,by,eps", CASES_2D)
@pytest.mark.parametrize("precision,dtype", [("f32", np.float64), ("bf16", np.float32)])
def test_plain_split_nsum2d_matches_pallas(bx, by, eps, precision, dtype):
    rng = np.random.default_rng(bx * 100 + by + eps)
    frame = rng.standard_normal((bx + 2 * eps, by + 2 * eps)).astype(dtype)
    jframe = np.pad(frame, ((0, _window_pad(eps)), (0, 0)))  # the TPU frame's roll slack
    ref = jh.build_split_nsum_2d(eps, bx, by, np.dtype(dtype).name, precision)(
        jnp.asarray(jframe))
    got = th.split_nsum2d(torch.from_numpy(frame), eps, precision)  # CPU tensor -> plain
    assert got.dtype == torch.from_numpy(frame).dtype and tuple(got.shape) == (bx, by)
    assert _rel(got.numpy(), ref) <= (1e-12 if dtype == np.float64 else BF16_L2_BUDGET)
    # the split sum is bitwise the one-pass sum on the same frame
    assert torch.equal(got, ck.nsum2d_plain(torch.from_numpy(frame), eps, precision))


# the last three: eps 3, 4 and 6, where csrc/split_nsum3d.cu runs its register
# design, two with a bz that is not a multiple of 4 (its one-cell staging)
CASES_3D = [(4, 4, 4, 1), (4, 4, 4, 2), (4, 4, 4, 5), (9, 7, 8, 2), (6, 6, 10, 1),
            (6, 5, 9, 3), (8, 8, 12, 4), (5, 5, 7, 6)]


@pytest.mark.parametrize("bx,by,bz,eps", CASES_3D)
@pytest.mark.parametrize("precision,dtype", [("f32", np.float64), ("bf16", np.float32)])
def test_plain_split_nsum3d_matches_pallas(bx, by, bz, eps, precision, dtype):
    rng = np.random.default_rng(bx * 100 + by * 10 + bz + eps)
    frame = rng.standard_normal((bx + 2 * eps, by + 2 * eps, bz + 2 * eps)).astype(dtype)
    pad = _strip_plan_3d(eps)[3]
    jframe = np.pad(frame, ((0, pad), (0, 0), (0, 0)))
    ref = jh.build_split_nsum_3d(eps, bx, by, bz, np.dtype(dtype).name, precision)(
        jnp.asarray(jframe))
    got = th.split_nsum3d(torch.from_numpy(frame), eps, precision)
    assert tuple(got.shape) == (bx, by, bz)
    assert _rel(got.numpy(), ref) <= (1e-12 if dtype == np.float64 else BF16_L2_BUDGET)
    assert torch.equal(got, k3.nsum3d_plain(torch.from_numpy(frame), eps, precision))


def test_split_wrappers_run_the_plain_version_on_the_cpu():
    ck.reset_launch_counts()
    th.split_nsum2d(torch.zeros(12, 12, dtype=torch.float64), 2)
    th.split_nsum3d(torch.zeros(8, 8, 8, dtype=torch.float64), 2)
    assert ck.launch_counts()["split_nsum2d"] == ck.launch_counts()["split_nsum3d"] == 0
    with pytest.raises(ValueError, match="too small"):
        th.split_nsum2d(torch.zeros(3, 12), 2)
    with pytest.raises(ValueError, match="too small"):
        th.split_nsum3d(torch.zeros(12, 12), 2)
    with pytest.raises(ValueError, match="unknown precision tier"):
        th.split_nsum2d(torch.zeros(12, 12), 2, "f16")


def test_phases_follow_the_jax_split():
    assert th._phases((8, 8), 3) == ("interior", "ring")
    assert th._phases((8, 8), 4) == ("all",)  # a side <= 2*eps: one pass
    assert th._phases((8, 8), 0) == ("all",)
    assert th._phases((8, 8, 4), 2) == ("all",)
    assert th._phases((8, 8, 5), 2) == ("interior", "ring")
    assert th.PHASES == {"all": 0, "interior": 1, "ring": 2}


# -- gates and the fused operator ------------------------------------------------------

def test_require_fused_refusals():
    op = NonlocalOp2D(2, 1.0, 1e-4, 0.02, method="cuda")
    th.require_fused(op, (8, 8), torch.float64)
    # no size gate: the kernels stream the frame (the JAX VMEM gate refuses this block)
    th.require_fused(op, (8192, 8192), torch.float32)
    assert not jh.fits_fused((8192, 8192), 8, jnp.float32)
    with pytest.raises(ValueError, match="needs method='cuda'"):
        th.require_fused(NonlocalOp2D(2, 1.0, 1e-4, 0.02, method="conv"), (8, 8))
    weighted = NonlocalOp2D(2, 1.0, 1e-4, 0.02, influence=lambda r: 1.0 - r, method="cuda")
    weighted.method = "cuda"  # a weighted J demotes cuda to conv; force the gate's case
    with pytest.raises(ValueError, match="uniform influence function"):
        th.require_fused(weighted, (8, 8))
    with pytest.raises(ValueError, match="superstep"):
        th.require_fused(op, (8, 8), ksteps=2)
    with pytest.raises(ValueError, match="2D/3D"):
        th.require_fused(op, (8,))
    with pytest.raises(ValueError, match="float32 or float64"):
        th.require_fused(op, (8, 8), torch.float16)


def test_fused_transport_is_the_jax_answer_off_the_tpu():
    assert th.fused_transport() == jh.fused_transport() == "interp"


@pytest.mark.parametrize("dims,eps,precision", [(2, 2, "f32"), (2, 5, "f32"), (2, 2, "bf16"),
                                                (3, 1, "f32"), (3, 3, "f32")])
def test_fused_apply_bitwise_the_collective_apply(dims, eps, precision):
    mesh_shape = (2, 2) if dims == 2 else (2, 2, 2)
    names = ("x", "y", "z")[:dims]
    block = (8,) * dims if dims == 2 else (4,) * dims
    cls = NonlocalOp2D if dims == 2 else NonlocalOp3D
    op = cls(eps, 1.0, 1e-4, 0.05, method="cuda", precision=precision)
    mesh = tmesh.create_mesh(names, mesh_shape, tmesh.device_list("cpu", 2 ** dims))
    u = np.random.default_rng(3).normal(size=tuple(m * b for m, b in zip(mesh_shape, block)))
    blocks = tmesh.put_global(u, mesh, torch.float64)
    fused = th.make_fused_apply(op, mesh_shape, names)(blocks)
    frames = thalo.halo_pad_nd(blocks, eps)
    for pos in np.ndindex(*mesh_shape):
        assert torch.equal(fused[pos], op.apply_padded(frames[pos])), pos


def test_ensemble_comm_joins_the_program_key():
    # the JAX engine's rule: comm='fused' needs the kernel method and changes
    # the program key, not the (single-device) programs
    case = EnsembleCase(shape=(16, 16), nt=2, eps=2, k=1.0, dt=1e-4, dh=0.02, test=True)
    a = EnsembleEngine(method="cuda", comm="collective", device=CPU)
    b = EnsembleEngine(method="cuda", comm="fused", device=CPU)
    ua, ub = a.run([case]), b.run([case])
    assert np.array_equal(ua[0], ub[0])
    (ka,), (kb,) = a._programs.keys(), b._programs.keys()
    assert ka[:-1] == kb[:-1] and (ka[-1], kb[-1]) == ("collective", "fused")
    assert b.sibling().comm == "fused"


# -- the in-kernel exchange (fused_nsum2d/3d) ---------------------------------------------

# then: a block narrower than a window row of csrc/fused_nsum2d.cu's
# register design (a row crosses two block edges in y), a block at the
# design's largest eps, 10, and a 3D block at eps 4 with bz a multiple of 4
# (csrc/fused_nsum3d.cu stages its windows from the mesh 16 bytes a copy)
FUSED_MESHES = [((2, 2), (8, 8), 2), ((2, 2), (8, 8), 4), ((4, 2), (8, 8), 9),
                ((2, 4), (6, 16), 3), ((4, 2), (2, 2), 5), ((2, 2, 2), (4, 4, 4), 1),
                ((2, 2, 2), (4, 4, 4), 5), ((2, 2), (40, 12), 8), ((2, 2), (24, 24), 10),
                ((2, 2, 2), (8, 8, 12), 4)]


@pytest.mark.parametrize("mesh_shape,block,eps", FUSED_MESHES)
@pytest.mark.parametrize("precision,dtype", [("f32", np.float64), ("bf16", np.float32)])
def test_plain_fused_nsum_matches_pallas_on_the_jax_exchange(mesh_shape, block, eps,
                                                             precision, dtype):
    # every block's sum with its halo read from the blocks around it, against
    # the JAX package's fused compute body (the split kernel, interpret mode)
    # on the frame its exchange fills; normal, degenerate and multi-hop blocks
    d = len(mesh_shape)
    names = ("x", "y", "z")[:d]
    grid = tuple(m * b for m, b in zip(mesh_shape, block))
    u = np.random.default_rng(sum(grid) + eps).normal(size=grid).astype(dtype)
    jm = (jmesh.make_mesh(*mesh_shape) if d == 2
          else jmesh.make_mesh_3d(*mesh_shape, devices=jax.devices()[:8]))
    f = shard_map(lambda b: jhalo.halo_pad_nd(b, eps, mesh_shape, names), mesh=jm,
                  in_specs=P(*names), out_specs=P(*names), check_vma=False)
    stacked = np.asarray(jax.jit(f)(jnp.asarray(u)))
    pad = _window_pad(eps) if d == 2 else _strip_plan_3d(eps)[3]
    build = jh.build_split_nsum_2d if d == 2 else jh.build_split_nsum_3d
    kernel = build(eps, *block, np.dtype(dtype).name, precision)
    tm = tmesh.create_mesh(names, mesh_shape, tmesh.device_list("cpu", int(np.prod(mesh_shape))))
    blocks = tmesh.put_global(u, tm, torch.from_numpy(u).dtype)
    fused = th.fused_nsum2d if d == 2 else th.fused_nsum3d
    split = th.split_nsum2d if d == 2 else th.split_nsum3d
    frames = thalo.halo_pad_nd(blocks, eps)
    fshape = tuple(b + 2 * eps for b in block)
    for pos in np.ndindex(*mesh_shape):
        sl = tuple(slice(p * s, (p + 1) * s) for p, s in zip(pos, fshape))
        widths = [(0, pad)] + [(0, 0)] * (d - 1)  # the TPU frame's roll slack
        ref = kernel(jnp.asarray(np.pad(stacked[sl], widths)))
        got = fused(blocks, pos, eps, precision)
        assert tuple(got.shape) == block and got.dtype == blocks[pos].dtype
        assert _rel(got.numpy(), ref) <= (1e-12 if dtype == np.float64 else BF16_L2_BUDGET)
        # bitwise the split sum of the exchanged frame
        assert torch.equal(got, split(frames[pos], eps, precision)), pos


@pytest.mark.parametrize("dims,eps,precision", [(2, 2, "f32"), (2, 5, "f32"), (2, 9, "f32"),
                                                (2, 2, "bf16"), (3, 1, "f32"), (3, 5, "f32")])
def test_fused_in_kernel_exchange_apply_bitwise_the_collective_apply(dims, eps, precision):
    mesh_shape = (2, 2) if dims == 2 else (2, 2, 2)
    names = ("x", "y", "z")[:dims]
    block = (8,) * dims if dims == 2 else (4,) * dims
    cls = NonlocalOp2D if dims == 2 else NonlocalOp3D
    op = cls(eps, 1.0, 1e-4, 0.05, method="cuda", precision=precision)
    mesh = tmesh.create_mesh(names, mesh_shape, tmesh.device_list("cpu", 2 ** dims))
    u = np.random.default_rng(4).normal(size=tuple(m * b for m, b in zip(mesh_shape, block)))
    blocks = tmesh.put_global(u, mesh, torch.float64)
    peer = th.make_fused_apply(op, mesh_shape, names, transport="peer")(blocks)
    frames = thalo.halo_pad_nd(blocks, eps)
    for pos in np.ndindex(*mesh_shape):
        assert torch.equal(peer[pos], op.apply_padded(frames[pos])), pos


def test_fused_transport_follows_the_devices(monkeypatch):
    monkeypatch.delenv("NLHEAT_FUSED_TRANSPORT", raising=False)
    # off a card: the JAX package's off-TPU answer, the split kernels
    assert th.fused_transport(tmesh.device_list("cpu", 4)) == jh.fused_transport() == "interp"
    # one card (virtual devices) always reads its own memory: the in-kernel exchange
    one_card = [torch.device("cuda", 0)] * 4
    assert th.fused_transport(one_card) == "peer"
    assert th.fused_transport(one_card + [CPU]) == "interp"
    monkeypatch.setenv("NLHEAT_FUSED_TRANSPORT", "interp")
    assert th.fused_transport(one_card) == "interp"
    monkeypatch.setenv("NLHEAT_FUSED_TRANSPORT", "rdma")
    with pytest.raises(ValueError, match="NLHEAT_FUSED_TRANSPORT"):
        th.fused_transport(one_card)
    with pytest.raises(ValueError, match="transport must be"):
        th.make_fused_apply(NonlocalOp2D(2, 1.0, 1e-4, 0.02, method="cuda"), (2, 2),
                            ("x", "y"), transport="rdma")


def test_neighbour_hops_follow_the_plan():
    assert th.neighbour_hops((2, 2), (8, 8), 2) == (1, 1)
    assert th.neighbour_hops((4, 2), (8, 8), 17) == (3, 1)  # widths (8, 8, 1), capped on y
    assert th.neighbour_hops((1, 3), (5, 7), 4) == (0, 1)
    assert th.neighbour_hops((2, 2, 2), (4, 4, 4), 5) == (1, 1, 1)
    for mesh_shape, block, eps in PLANS:
        hops = th.neighbour_hops(mesh_shape, block, eps)
        offsets = {m.offset for m in th.plan_exchange(mesh_shape, block, eps)}
        assert all(abs(o) <= h for off in offsets for o, h in zip(off, hops))


def test_fused_wrappers_run_the_plain_version_and_refuse_on_the_cpu():
    ck.reset_launch_counts()
    mesh = tmesh.make_mesh(2, 2, tmesh.device_list("cpu", 4))
    blocks = tmesh.put_global(np.ones((16, 16)), mesh, torch.float64)
    got = th.fused_nsum2d(blocks, (1, 0), 2)
    assert torch.equal(got, th.fused_nsum_plain(blocks, (1, 0), 2))
    assert ck.launch_counts()["fused_nsum2d"] == ck.launch_counts()["fused_nsum3d"] == 0
    with pytest.raises(ValueError, match="rank-3 mesh"):
        th.fused_nsum3d(blocks, (0, 0), 2)
    with pytest.raises(ValueError, match="unknown precision tier"):
        th.fused_nsum2d(blocks, (0, 0), 2, "f16")
    # a horizon reaching past the neighbour table (13 x 13 blocks > 125)
    wide = tmesh.put_global(np.ones((12, 12)),
                            tmesh.make_mesh(12, 12, tmesh.device_list("cpu", 144)), torch.float64)
    with pytest.raises(ValueError, match="in-kernel exchange's table of 125 blocks"):
        th.fused_nsum2d(wide, (0, 0), 6)
