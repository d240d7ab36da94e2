"""PyTorch + CUDA port of the nonlocal heat-equation framework.

A second package beside ``nonlocalheatequation_tpu`` (the JAX reference),
written for one NVIDIA H100.  It mirrors the reference's layout so each
module has a counterpart there:

  ops/       stencil geometry, scaling constants, the nonlocal operator, the
             unstructured point-cloud operator and its layouts, and the
             hand-written CUDA kernels (csrc/) with their plain versions
  models/    the 1D/2D/3D solvers (oracle = NumPy f64, torch = the device path)
  serve/     the ensemble engine (many solves bucketed into batched programs)
             and the mesh registry its unstructured buckets resolve
  obs/       the counters and spans the ensemble engine reports through
  utils/     device resolution, timing reports, the variant autotuner, the
             GMSH reader and the .vtu writer
  cli/       the batch-test and unstructured command-line entry points
  convert.py carries solver state from the JAX package into the port

The package imports torch and numpy only: never jax, never the JAX package.
Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(or ``--platform cpu`` on the CLIs).
"""

__version__ = "0.1.0"
