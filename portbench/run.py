"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and the numbers the output check compared, each beside its limit, as the
last lines of standard error.  Exits non-zero, printing no result, where
the card is missing or the cell asks for more cards than there are, where
anything fails, and where ``jax``, ``jaxlib``, ``flax`` or the JAX package
is loaded in this process once the window has closed.  ``--control 1``
runs the check's control in the program's place (its lower-precision
path): a control run has to come out not correct.
"""

from __future__ import annotations

import time

T_FIRST_LINE = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# run as a script, this directory heads sys.path and its modules would
# shadow any library of the same name; the checkout's root replaces it
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)


def process_start() -> float:
    """When this process started (the epoch, in seconds): its start time
    from /proc, else the first line of this script."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return min(boot + ticks / os.sysconf("SC_CLK_TCK"), T_FIRST_LINE)
    except (OSError, ValueError, IndexError, StopIteration):
        return T_FIRST_LINE


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()

    import torch

    from portbench import harness

    cell = harness.Cell.load(args.workload)
    chips = int(cell.spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=t_start, control=bool(args.control))
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
