"""One rank of the port's multi-process loopback solve.

Run by tests/test_torch_multihost.py (no ``test_`` prefix, so pytest does not
collect it), one process a rank:

    python tests/torch_multihost_child.py <init_method> <num_processes> <rank>

``init_method`` is a ``file://`` URL in the group's own directory.  Each rank
owns ``TMH_LOCAL`` virtual CPU devices (uneven counts welcome; with
``TMH_PLATFORM=gpu``, virtual devices of its own card in an nccl group, one
card a rank, float64 through the CUDA kernels); the meshes
lay over every rank's devices in rank order, so the bands, pencils and
gathers cross the ``gloo`` transport.  ``TMH_OUT`` is a directory where rank
0 saves each leg's result (``<leg>.npy``) for the parent to hold against the
JAX package; ``TMH_LEGS`` selects legs (comma list, default
``2d,superstep,rkc,fft,3d,unstructured``):

* ``2d`` — 16 x (8*my) on a (2, my) mesh, my = ndev//2, eps 3 (one hop) and
  9 (the multi-hop ring), ``comm`` collective and fused (``'interp'``); then
  on a (2, 1) mesh of rank 0's devices alone (the stencil and the fft), where
  the other ranks own no block;
* ``superstep`` — the K=2 superstep; ``rkc`` — rkc[4] per stage and in stage
  batches of K=2; ``fft`` — the sharded fft, euler, rkc[4] and expo S=1;
* ``3d`` — 8^3 on (2, 2, ndev//4 or 1), eps 2 and 5, both comm forms;
* ``unstructured`` — the sharded offsets form, the export and gather forms
  of the edge layout, the solver with a checkpoint, the K=2 superstep;
* ``crashu`` — a long checkpointed unstructured run the parent kills;
  ``resumeu`` — resume ``TMH_CK`` and run to ``TMH_NT_TOTAL``; ``crash2d``
  and ``resume2d`` — the same pair for the 2D grid solver.

Every leg is held bitwise to the same solve in this one process (a mesh of
virtual devices of this rank's device alone) and checked equal on every rank
(``assert_same_on_all_hosts``), then prints ``TMH-OK p<rank> <leg>``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from nonlocalheatequation_torch.parallel import multihost  # noqa: E402

init, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
PLATFORM = os.environ.get("TMH_PLATFORM", "cpu")  # "gpu": nccl, one card a rank
assert multihost.init_from_env(init, nproc, pid, platform=PLATFORM, timeout=60)
assert multihost.process_count() == nproc and multihost.process_index() == pid

from nonlocalheatequation_torch.models.solver2d import Solver2D  # noqa: E402
from nonlocalheatequation_torch.ops import unstructured as tu  # noqa: E402
from nonlocalheatequation_torch.parallel.distributed2d import Solver2DDistributed  # noqa: E402
from nonlocalheatequation_torch.parallel.distributed3d import Solver3DDistributed  # noqa: E402
from nonlocalheatequation_torch.parallel.mesh import (  # noqa: E402
    create_mesh,
    device_list,
    make_mesh,
    make_mesh_3d,
)

LEGS = set(os.environ.get("TMH_LEGS", "2d,superstep,rkc,fft,3d,unstructured").split(","))
OUT = os.environ.get("TMH_OUT", "")
DEVS = device_list(PLATFORM, int(os.environ.get("TMH_LOCAL", "2")))
NDEV = len(DEVS)
assert NDEV == int(os.environ.get("TMH_NDEV", NDEV)), NDEV
assert any(multihost.is_remote(d) for d in DEVS) == (nproc > 1)
MY = NDEV // 2
NX, NY = 16, 8 * MY
MZ = NDEV // 4 if NDEV % 4 == 0 else 1
HERE = next(d for d in DEVS if not multihost.is_remote(d))  # this rank's device


def solo(axes, shape):
    """The same mesh shape over virtual devices of this process alone."""
    return create_mesh(axes, shape, [HERE] * int(np.prod(shape)))


def held(leg, u, ref):
    """Every rank holds ``u``; it is ``ref`` bitwise; rank 0 saves it."""
    multihost.assert_same_on_all_hosts(u, leg)
    assert u.shape == ref.shape and np.array_equal(u, ref), (
        f"{leg}: differs from the one-process solve by {np.abs(u - ref).max():.3e}")
    if OUT and pid == 0:
        np.save(os.path.join(OUT, f"{leg}.npy"), u)
    print(f"TMH-OK p{pid} {leg}", flush=True)


def solve2d(mesh, **kw):
    kw = dict(dict(nt=3, eps=3, k=1.0, dt=1e-4, dh=1.0 / NX, method="cuda"), **kw)
    s = Solver2DDistributed(NX, NY, 1, 1, mesh=mesh, dtype=torch.float64, **kw)
    s.test_init()
    return s.do_work()


def leg2d(leg, **kw):
    held(leg, solve2d(make_mesh(2, MY, DEVS), **kw), solve2d(solo(("x", "y"), (2, MY)), **kw))


def jittered_cloud(m=32, seed=0):
    """m x m grid nodes jittered 20% (tests/test_torch_unstructured_sharded.py's
    cloud, the same in every rank by its seed)."""
    rng = np.random.default_rng(seed)
    h = 1.0 / m
    xs, ys = np.meshgrid(np.arange(m) * h, np.arange(m) * h, indexing="ij")
    pts = np.stack([xs.ravel(), ys.ravel()], axis=1)
    pts += rng.uniform(-0.2 * h, 0.2 * h, pts.shape)
    return pts, h


def cloud_op():
    pts, h = jittered_cloud()
    return tu.UnstructuredNonlocalOp(pts, 3.0 * h, k=1.0, dt=1e-6, vol=h * h, device=HERE)


if "2d" in LEGS:
    for eps in (3, 9):
        for comm in ("collective", "fused"):
            leg2d(f"2d-eps{eps}-{comm}", eps=eps, comm=comm)

    # a mesh of rank 0's first two devices: the other ranks own no block and
    # receive the gathered state
    for leg, kw in (("2d-rank0-only", {}), ("2d-rank0-only-fft", dict(method="fft"))):
        held(leg, solve2d(make_mesh(2, 1, DEVS[:2]), **kw), solve2d(solo(("x", "y"), (2, 1)),
                                                                   **kw))

if "superstep" in LEGS:
    leg2d("2d-superstep2", superstep=2)

if "rkc" in LEGS:
    leg2d("2d-rkc-perstage", stepper="rkc", stages=4)
    leg2d("2d-rkc-batch2", stepper="rkc", stages=4, superstep=2)

if "fft" in LEGS:
    leg2d("2d-fft-euler", method="fft")
    leg2d("2d-fft-rkc", method="fft", stepper="rkc", stages=4)
    leg2d("2d-fft-expo", method="fft", stepper="expo", stages=1, dt=1e-3)

if "3d" in LEGS:
    def solve3d(mesh, eps, comm):
        s = Solver3DDistributed(8, 8, 8, nt=2, eps=eps, k=1.0, dt=1e-4, dh=0.05, mesh=mesh,
                                method="cuda", comm=comm, dtype=torch.float64)
        s.test_init()
        return s.do_work()

    for eps in (2, 5):
        for comm in ("collective", "fused"):
            held(f"3d-eps{eps}-{comm}", solve3d(make_mesh_3d(2, 2, MZ, DEVS), eps, comm),
                 solve3d(solo(("x", "y", "z"), (2, 2, MZ)), eps, comm))

if "unstructured" in LEGS:
    op = cloud_op()
    u = np.random.default_rng(1).normal(size=op.n)  # the same draw on every rank
    for form, kw in (("offsets", {}), ("export", dict(halo="export")),
                     ("gather", dict(halo="gather"))):
        sh = tu.ShardedUnstructuredOp(op, devices=DEVS, **kw)
        one = tu.ShardedUnstructuredOp(op, devices=[HERE] * NDEV, **kw)
        assert sh.layout == one.layout == ("offsets" if form == "offsets" else "edges")
        assert sh.halo_mode == one.halo_mode
        held(f"unstructured-{form}", sh.apply(torch.as_tensor(u)).numpy(),
             one.apply(torch.as_tensor(u)).numpy())
    ck = os.path.join(OUT or ".", "unstructured-ck.npz")
    outs = {}
    for name, devs in (("multi", DEVS), ("one", [HERE] * NDEV)):
        s = tu.UnstructuredSolver(tu.ShardedUnstructuredOp(op, devices=devs), nt=3,
                                  checkpoint_path=ck if name == "multi" else None,
                                  ncheckpoint=2, dtype=torch.float64)
        s.test_init()
        outs[name] = s.do_work()
        assert s.error_l2 / op.n <= 1e-6, s.error_l2
    held("unstructured-solver", outs["multi"], outs["one"])
    if tu.ShardedUnstructuredOp(op, devices=DEVS).superstep_fits(2):
        for name, devs in (("multi", DEVS), ("one", [HERE] * NDEV)):
            s = tu.UnstructuredSolver(tu.ShardedUnstructuredOp(op, devices=devs), nt=3,
                                      superstep=2, dtype=torch.float64)
            s.test_init()
            outs[name] = s.do_work()
        held("unstructured-superstep2", outs["multi"], outs["one"])

if "crashu" in LEGS:
    s = tu.UnstructuredSolver(tu.ShardedUnstructuredOp(cloud_op(), devices=DEVS), nt=400,
                              checkpoint_path=os.environ["TMH_CK"], ncheckpoint=2)
    s.test_init()
    print(f"TMH-CRASH-RUNNING p{pid}", flush=True)
    s.do_work()
    print(f"TMH-UNEXPECTED p{pid} crashu finished", flush=True)

if "resumeu" in LEGS:
    op = cloud_op()
    nt_total = int(os.environ["TMH_NT_TOTAL"])
    s = tu.UnstructuredSolver(tu.ShardedUnstructuredOp(op, devices=DEVS), nt=nt_total)
    s.test_init()
    s.resume(os.environ["TMH_CK"])
    assert s.t0 > 0, "the resume restarted instead of continuing"
    ur = s.do_work()
    multihost.assert_same_on_all_hosts(ur, "resumed unstructured")
    o = tu.UnstructuredSolver(op, nt=nt_total, backend="oracle")
    o.test_init()
    err = float(np.abs(ur - o.do_work()).max())
    assert err < 1e-12, f"the resumed run is {err:.3e} from the oracle"
    print(f"TMH-OK p{pid} resumeu t0={s.t0} err={err:.2e}", flush=True)

if "crash2d" in LEGS:
    d = Solver2DDistributed(16, 16, 1, 1, nt=400, eps=3, k=1.0, dt=1e-4, dh=1.0 / 16,
                            mesh=make_mesh(2, MY, DEVS), dtype=torch.float64,
                            checkpoint_path=os.environ["TMH_CK"], ncheckpoint=2)
    d.test_init()
    print(f"TMH-CRASH-RUNNING p{pid}", flush=True)
    d.do_work()
    print(f"TMH-UNEXPECTED p{pid} crash2d finished", flush=True)

if "resume2d" in LEGS:
    nt_total = int(os.environ["TMH_NT_TOTAL"])
    d = Solver2DDistributed(16, 16, 1, 1, nt=nt_total, eps=3, k=1.0, dt=1e-4, dh=1.0 / 16,
                            mesh=make_mesh(2, MY, DEVS), dtype=torch.float64)
    d.test_init()
    d.resume(os.environ["TMH_CK"])
    assert d.t0 > 0, "the resume restarted instead of continuing"
    ur = d.do_work()
    multihost.assert_same_on_all_hosts(ur, "resumed solution")
    o = Solver2D(16, 16, nt_total, 3, k=1.0, dt=1e-4, dh=1.0 / 16, backend="oracle",
                 device="cpu")
    o.test_init()
    err = float(np.abs(ur - o.do_work()).max())
    assert err < 1e-12, f"the resumed run is {err:.3e} from the oracle"
    print(f"TMH-OK p{pid} resume2d t0={d.t0} err={err:.2e}", flush=True)

multihost.shutdown()
