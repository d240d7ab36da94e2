"""Domain-decomposition CLI, the reference's ``2d_domain_decomposition`` —
the port's copy of ``nonlocalheatequation_tpu/cli/decompose.py`` (same
output, same return codes).  Usage parity (src/domain_decomposition.cpp:55-58):

    python -m nonlocalheatequation_torch.cli.decompose mesh.msh out.txt N [--sx S] [--sy S]

The reference prompts for the coarse grain sizes on stdin
(domain_decomposition.cpp:138-156); ``--sx/--sy`` provide them
non-interactively (scripts, CI), and when omitted the tool prints the same
mesh-size information and reads the two values from stdin, so existing
pipelines keep working.  The output partition-map file format is identical
(write_mesh, domain_decomposition.cpp:31-50).
"""

from __future__ import annotations

import argparse
import sys

from nonlocalheatequation_torch.utils.decompose import decompose, infer_structured_grid
from nonlocalheatequation_torch.utils.gmsh import read_msh
from nonlocalheatequation_torch.utils.partition_map import write_partition_map


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="2d_domain_decomposition")
    p.add_argument("mesh", help="input GMSH .msh file (ASCII 4.1 or 2.2)")
    p.add_argument("out", help="output partition-map file")
    p.add_argument("nodes", type=int,
                   help="number of compute nodes/devices to partition for")
    p.add_argument("--sx", type=int, default=None,
                   help="coarse grain size along x (per-tile cells); must divide the mesh size")
    p.add_argument("--sy", type=int, default=None,
                   help="coarse grain size along y; must divide the mesh size")
    return p


def _stdin_int_reader():
    """cin->style token reader: each call prompts and consumes ONE
    whitespace-delimited integer from stdin (works at a TTY line-by-line and
    with piped "5 5" input).  Buffer state is per-reader, not global."""
    buf: list[str] = []

    def read(prompt: str) -> int | None:
        print(prompt, flush=True)
        while not buf:
            line = sys.stdin.readline()
            if not line:
                return None
            buf.extend(line.split())
        tok = buf.pop(0)
        try:
            return int(tok)
        except ValueError:
            print(f"invalid coarse grain size: {tok!r}", file=sys.stderr)
            return None

    return read


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    msh = read_msh(args.mesh)
    mx, my, dh = infer_structured_grid(msh)
    print("\nSize of mesh is as follows:")
    print(f"x dimension : {mx}\ny dimension : {my}")

    # flags fill what they can; anything missing is prompted for on stdin in
    # the reference's order (domain_decomposition.cpp:138-156)
    read_int = _stdin_int_reader()
    sx, sy = args.sx, args.sy
    if sx is None:
        sx = read_int("\nEnter coarse mesh size along x-dimension")
    if sy is None:
        sy = read_int("\nEnter coarse mesh size along y-dimension")
    if sx is None or sy is None:
        print("expected coarse grain sizes on stdin", file=sys.stderr)
        return 2

    try:
        pmap = decompose(msh, args.nodes, sx, sy)
    except ValueError as e:
        print(str(e))
        return 0  # the reference exits 0 on divisibility failure, message printed
    write_partition_map(args.out, pmap)
    print(f"wrote {args.out}: {pmap.npx}x{pmap.npy} tiles of "
          f"{pmap.nx}x{pmap.ny}, {args.nodes} owners")
    return 0


if __name__ == "__main__":
    sys.exit(main())
