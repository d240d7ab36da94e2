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
on the card).  The JAX CLI's multi-device solve (``--devices N`` for N > 1,
``--halo``, ``--superstep K`` for K > 1), its observability flags and
``--program-store`` are refused by name: they are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from nonlocalheatequation_torch.cli.common import (
    add_platform_flags,
    bool_flag,
    platform_kwargs,
    version_banner,
)

#: the JAX CLI's flags that the port does not have yet -> what they select
NOT_PORTED = {
    "--halo": "the sharded operator's halo exchange",
    "--trace": "observability",
    "--metrics-out": "observability",
    "--metrics-port": "observability",
    "--flight-dir": "observability",
    "--program-store": "the AOT program store",
}


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
                   help="devices to shard over; only 1 is ported")
    p.add_argument("--superstep", type=int, default=1, metavar="K",
                   help="the sharded offsets layout's K-step schedule; only 1 is ported")
    p.add_argument("--layout", default="auto",
                   choices=("auto", "offsets", "windowed", "ell", "edges"),
                   help="operator layout (auto prefers the offsets/windowed paths on the "
                        "card)")
    p.add_argument("--vtu", default=None, metavar="FILE",
                   help="write the final field as a .vtu point cloud")
    bool_flag(p, "gang-order", True,
              "reorder nodes for a --devices N shard (no effect on one device)")
    p.add_argument("--no-header", action="store_true", dest="no_header")
    add_platform_flags(p)
    return p


def _refusal(args, rest) -> str | None:
    """The message refusing what the port does not have yet, or None."""
    for tok in rest:
        name = tok.split("=")[0]
        if name in NOT_PORTED:
            return f"{name} is not ported yet to nonlocalheatequation_torch ({NOT_PORTED[name]})"
    if args.devices > 1:
        return ("--devices > 1 is not ported yet to nonlocalheatequation_torch (the sharded "
                "unstructured operator and its gang order)")
    if args.devices < 1:
        return f"--devices must be >= 1, got {args.devices}"
    if args.superstep > 1:
        return ("--superstep > 1 is not ported yet to nonlocalheatequation_torch (the sharded "
                "offsets layout's K-step schedule)")
    return None


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
    p = build_parser()
    args, rest = p.parse_known_args(argv)
    err = _refusal(args, rest)
    if err:
        print(err, file=sys.stderr)
        return 1
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    version_banner("nlheat_unstructured")
    try:
        kw = platform_kwargs(args)
    except RuntimeError as e:  # no card for --platform gpu
        print(f"error: {e}", file=sys.stderr)
        return 2

    from nonlocalheatequation_torch.ops.unstructured import (
        UnstructuredNonlocalOp,
        UnstructuredSolver,
    )

    pts = mesh_points(args.mesh)
    n = len(pts)
    dh = mean_spacing(pts)
    eps = args.eps if args.eps > 0 else args.eps_h * dh
    vol = dh ** pts.shape[1]
    op = UnstructuredNonlocalOp(pts, eps, k=args.k, dt=args.dt or 1.0, vol=vol,
                                device=kw["device"])
    if not args.dt:
        # forward-Euler stability: dt * max(c_i * wsum_i) <= 1, take 80%
        bound = float(np.max(op.c * op.wsum))
        op.dt = 0.8 / bound if bound > 0 else 1e-5
    print(f"nodes {n} (dim {pts.shape[1]}), edges {len(op.tgt)}, "
          f"eps {eps:.5g} ({eps / dh:.2f} dh), dt {op.dt:.3e}")

    s = UnstructuredSolver(op, nt=args.nt, layout=args.layout, dtype=kw["dtype"])
    if args.test:
        s.test_init()
    else:
        s.input_init(np.array(sys.stdin.read().split(), dtype=np.float64)[:n])

    t0 = time.perf_counter()
    s.do_work()
    elapsed = time.perf_counter() - t0

    u_out = np.asarray(s.u)
    if args.test:
        err = s.error_l2 / n
        if args.cmp:
            print(f"error_l2/N {err:.6e} ({'<=' if err <= 1e-6 else '>'} 1e-6)")
        print(f"l2: {s.error_l2:g} linfinity: {s.error_linf:g}")
    if args.results:
        for v in u_out:
            print(f"{v:g}")
    if args.vtu:
        from nonlocalheatequation_torch.utils.vtu import write_point_cloud_vtu

        write_point_cloud_vtu(args.vtu, pts, {"Temperature": u_out})
        print(f"wrote {args.vtu}")

    if not args.no_header:
        print("OS_Threads,Execution_Time_sec,Nodes,Time_Steps")
    print(f"{os.cpu_count() or 1},     {elapsed}, {n},"
          f"                   {args.nt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
