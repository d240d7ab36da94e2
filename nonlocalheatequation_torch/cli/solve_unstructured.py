"""Unstructured-mesh solver CLI — the single-device surface of
``nonlocalheatequation_tpu/cli/solve_unstructured.py``, on the port.

Solves the nonlocal heat equation on the NODES of a GMSH .msh file with a
variable horizon:

    python -m nonlocalheatequation_torch.cli.solve_unstructured \\
        --mesh data/100x100.msh --eps-h 3 --nt 30 --test

runs on the CUDA card (``--platform cpu`` for the CPU).  ``--eps-h`` scales
the horizon in multiples of the estimated node spacing; ``--eps`` gives an
absolute radius instead.  The test contract is the solvers'
``error_l2/#points <= 1e-6``.  ``--layout`` picks the operator layout
(ops/unstructured.py; ``auto`` prefers offsets, then the windowed kernel,
on the card).  ``--devices N`` shards the solve over N devices of the
platform (more than there are: virtual devices, parallel/mesh.py) with
``ShardedUnstructuredOp``: the nodes reordered first by ``gang_order``
(``--gang-order false`` keeps the file's order), ``--halo auto|export|gather``
the edge form's halo, ``--superstep K`` the offsets form's K-step schedule
(refused where it cannot engage).  Under a multi-process launch
(cli/solve2d_distributed.py) ``--devices N`` counts each rank's own
devices, the operator is sharded over every rank's, rank 0 prints and
writes.  ``--trace DIR``, ``--metrics-out FILE`` and ``--metrics-port PORT``
are the observability flags and ``--flight-dir DIR`` the crash flight
recorder (cli/common.obs_session); ``--program-store DIR`` the program
store (serve/program_store.py).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nonlocalheatequation_torch.cli.common import (
    add_obs_flags,
    add_platform_flags,
    add_program_store_flag,
    apply_program_store,
    bool_flag,
    check_same_input_state,
    cli_startup,
    guard_multihost_stdin,
    obs_session,
    publish_solve_metrics,
    validate_obs_args,
)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nlheat_unstructured", add_help=True)
    p.add_argument("--mesh", required=True, help="GMSH .msh file (nodes used)")
    p.add_argument("--test", action="store_true")
    p.add_argument("--results", action="store_true")
    bool_flag(p, "cmp", True, "print expected vs actual outputs")
    p.add_argument("--nt", type=int, default=30)
    p.add_argument("--eps", type=float, default=0.0,
                   help="absolute horizon radius (overrides --eps-h)")
    p.add_argument("--eps-h", type=float, default=3.0, dest="eps_h",
                   help="horizon as a multiple of the mean nearest spacing")
    p.add_argument("--k", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=0.0,
                   help="timestep; 0 = 80%% of the forward-Euler bound")
    p.add_argument("--devices", type=int, default=1,
                   help="shard over N devices of the platform (more than there are: "
                        "virtual devices)")
    p.add_argument("--halo", default="auto", choices=("auto", "export", "gather"))
    p.add_argument("--superstep", type=int, default=1, metavar="K",
                   help="sharded offsets layout only: exchange a K*pad-wide ring halo once "
                        "per K steps (communication-avoiding; refused where it cannot "
                        "engage)")
    p.add_argument("--layout", default="auto",
                   choices=("auto", "offsets", "windowed", "ell", "edges"),
                   help="operator layout (auto prefers the offsets/windowed paths on the "
                        "card)")
    p.add_argument("--vtu", default=None, metavar="FILE",
                   help="write the final field as a .vtu point cloud")
    bool_flag(p, "gang-order", True,
              "reorder nodes by the coarse-grid RCB parts (serve/meshes.py gang_order) "
              "before a --devices N shard, so each device's index-contiguous block is "
              "spatially compact")
    p.add_argument("--no-header", action="store_true", dest="no_header")
    add_platform_flags(p)
    add_obs_flags(p)
    add_program_store_flag(p)
    return p


def _refusal(args) -> str | None:
    """The message refusing these flags, or None."""
    if args.devices < 1:
        return f"--devices must be >= 1, got {args.devices}"
    return validate_obs_args(args)


def mesh_points(path: str) -> np.ndarray:
    """The mesh's node coordinates with degenerate axes dropped (the
    reference's meshes are planar, z == 0), so the moment-matched constant
    uses the true dimension."""
    from nonlocalheatequation_torch.utils.gmsh import read_msh

    coords = read_msh(path).coords
    live = [d for d in range(coords.shape[1]) if np.ptp(coords[:, d]) > 0]
    return coords[:, live] if live else coords[:, :1]


def mean_spacing(pts: np.ndarray) -> float:
    """Mean nearest-neighbour spacing of a 512-node sample (the unstructured
    dh analog), chunked over the node axis."""
    n = len(pts)
    sample = pts[np.random.default_rng(0).permutation(n)[: min(n, 512)]]
    best = np.full(len(sample), np.inf)
    for lo in range(0, n, 4096):
        blk = pts[lo:lo + 4096]
        d2 = ((sample[:, None, :] - blk[None, :, :]) ** 2).sum(-1)
        d2[d2 == 0] = np.inf
        best = np.minimum(best, d2.min(axis=1))
    return float(np.sqrt(best).mean())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    err = _refusal(args)
    if err:
        print(err, file=sys.stderr)
        return 1
    # the srun analog: every rank runs this same CLI, rank 0 owns the console
    try:
        multi, kw = cli_startup(args, "nlheat_unstructured")
    except RuntimeError as e:  # no card for --platform gpu
        print(f"error: {e}", file=sys.stderr)
        return 2
    apply_program_store(args)
    with obs_session(args):
        return _run(args, multi, kw)


def _run(args, multi: bool, kw: dict) -> int:
    devs = None
    if multi or args.devices > 1:
        from nonlocalheatequation_torch.parallel.mesh import device_list

        # --devices N: this rank's own; the list holds every rank's
        devs = device_list(kw["device"], args.devices)

    from nonlocalheatequation_torch.ops.unstructured import (
        ShardedUnstructuredOp,
        UnstructuredNonlocalOp,
        UnstructuredSolver,
    )

    pts = mesh_points(args.mesh)
    n = len(pts)
    dh = mean_spacing(pts)
    eps = args.eps if args.eps > 0 else args.eps_h * dh
    vol = dh ** pts.shape[1]
    # gang placement: the sharded operator splits by index into contiguous
    # blocks, so reorder the nodes by the coarse grid's RCB parts first; the
    # outputs below go back to the file's order
    inv = None
    if devs is not None and len(devs) > 1 and args.gang_order:
        from nonlocalheatequation_torch.serve.meshes import gang_order

        perm = gang_order(pts, len(devs))
        inv = np.argsort(perm)
        pts = pts[perm]
    op = UnstructuredNonlocalOp(pts, eps, k=args.k, dt=args.dt or 1.0, vol=vol,
                                device=kw["device"])
    if not args.dt:
        # forward-Euler stability: dt * max(c_i * wsum_i) <= 1, take 80%
        bound = float(np.max(op.c * op.wsum))
        op.dt = 0.8 / bound if bound > 0 else 1e-5
    the_op = op
    if devs is not None and len(devs) > 1:
        try:
            the_op = ShardedUnstructuredOp(op, devices=devs, halo=args.halo)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 1
        print(f"sharded over {len(devs)} devices, halo={the_op.halo_mode} "
              f"(comm ratio {the_op.halo_comm_ratio:.3f})")
        if args.layout != "auto":
            print("--layout is single-device only; the sharded operator "
                  "keeps its edge layout")
            args.layout = "auto"
    print(f"nodes {n} (dim {pts.shape[1]}), edges {len(op.tgt)}, "
          f"eps {eps:.5g} ({eps / dh:.2f} dh), dt {op.dt:.3e}")

    try:
        s = UnstructuredSolver(the_op, nt=args.nt, layout=args.layout, dtype=kw["dtype"],
                               superstep=args.superstep)
    except ValueError as e:
        # a --superstep that cannot engage (one device, the edges layout,
        # K*pad > block): the JAX CLI's one-line refusal
        print(e, file=sys.stderr)
        return 1
    if args.test:
        s.test_init()
    else:
        guard_multihost_stdin(multi)
        vals = np.array(sys.stdin.read().split(), dtype=np.float64)[:n]
        # stdin is in the file's order; the operator's nodes may be gang-ordered
        s.input_init(vals if inv is None else vals[np.argsort(inv)])
        check_same_input_state(multi, s.u0)

    t0 = time.perf_counter()
    s.do_work()
    elapsed = time.perf_counter() - t0
    publish_solve_metrics("unstructured", elapsed, n, args.nt,
                          error_l2=s.error_l2 if args.test else None)

    u_out = np.asarray(s.u) if inv is None else np.asarray(s.u)[inv]
    if args.test:
        err = s.error_l2 / n
        if args.cmp:
            print(f"error_l2/N {err:.6e} ({'<=' if err <= 1e-6 else '>'} 1e-6)")
        print(f"l2: {s.error_l2:g} linfinity: {s.error_linf:g}")
    if args.results:
        for v in u_out:
            print(f"{v:g}")
    if args.vtu:
        # the file is rank 0's alone (utils/vtu.py)
        from nonlocalheatequation_torch.utils.vtu import write_point_cloud_vtu

        write_point_cloud_vtu(args.vtu, pts if inv is None else pts[inv],
                              {"Temperature": u_out})
        print(f"wrote {args.vtu}")

    if not args.no_header:
        print("OS_Threads,Execution_Time_sec,Nodes,Time_Steps")
    print(f"{os.cpu_count() or 1},     {elapsed}, {n},"
          f"                   {args.nt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
