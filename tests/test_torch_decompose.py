"""The port's decomposition toolchain (utils/partition_map.py,
utils/decompose.py, cli/decompose.py) against the JAX package's.

Partition maps are byte-identical files whichever package writes them and
read the same in both; the partitioner (RCB, the dual graph, the cut
refinement, the edge cut) gives the same integers on the same inputs, on the
shipped meshes and on the reference's documented 400x400 run; the CLI prints
the same lines and returns the same codes.  This host has no built
``native/`` library, so both packages run the NumPy partitioner here.
"""

import io
import sys

import numpy as np
import pytest

from nonlocalheatequation_torch.cli import decompose as tcli
from nonlocalheatequation_torch.utils import decompose as tdc
from nonlocalheatequation_torch.utils import gmsh as tgmsh
from nonlocalheatequation_torch.utils import partition_map as tpm
from nonlocalheatequation_tpu.cli import decompose as jcli
from nonlocalheatequation_tpu.utils import decompose as jdc
from nonlocalheatequation_tpu.utils import partition_map as jpm

MESHES = ("data/10x10.msh", "data/50x50.msh")


def test_partitioner_names_the_path_that_runs():
    assert tdc.PARTITIONER == ("numpy" if tdc._native_lib is None else "native")


@pytest.mark.parametrize("npx,npy,nl", [(5, 5, 2), (4, 6, 3), (20, 20, 4), (1, 7, 7)])
def test_maps_byte_identical_in_both_directions(tmp_path, npx, npy, nl):
    rng = np.random.default_rng(npx * 100 + npy)
    a = rng.integers(0, nl, size=(npx, npy)).astype(np.int64)
    assert np.array_equal(tpm.default_assignment(npx, npy, nl),
                          jpm.default_assignment(npx, npy, nl))
    ours, theirs = tmp_path / "torch.txt", tmp_path / "jax.txt"
    tpm.write_partition_map(str(ours), tpm.PartitionMap(20, 10, npx, npy, 0.0125, a))
    jpm.write_partition_map(str(theirs), jpm.PartitionMap(20, 10, npx, npy, 0.0125, a))
    assert ours.read_bytes() == theirs.read_bytes()
    for path in (ours, theirs):
        t, j = tpm.read_partition_map(str(path)), jpm.read_partition_map(str(path))
        assert (t.nx, t.ny, t.npx, t.npy, t.dh) == (j.nx, j.ny, j.npx, j.npy, j.dh)
        assert np.array_equal(t.assignment, j.assignment)
        assert t.num_owners == j.num_owners and t.tiles_of(0) == j.tiles_of(0)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("nparts,sx,sy", [(1, 5, 5), (2, 5, 5), (4, 5, 5), (3, 2, 5), (4, 10, 2)])
def test_decompose_equals_jax_on_shipped_meshes(mesh, nparts, sx, sy):
    ours = tdc.decompose(mesh, nparts, sx, sy)
    theirs = jdc.decompose(mesh, nparts, sx, sy)
    assert (ours.nx, ours.ny, ours.npx, ours.npy, ours.dh) == (
        theirs.nx, theirs.ny, theirs.npx, theirs.npy, theirs.dh)
    assert np.array_equal(ours.assignment, theirs.assignment)
    assert tdc.edge_cut(ours.assignment) == jdc.edge_cut(theirs.assignment)


@pytest.mark.parametrize("npx,npy,k", [(5, 5, 4), (4, 4, 2), (8, 8, 4), (6, 4, 3), (7, 5, 4)])
def test_dual_graph_rcb_refine_and_cut_equal_jax(npx, npy, k):
    txadj, tadj = tdc.dual_graph_csr(npx, npy)
    jxadj, jadj = jdc.dual_graph_csr(npx, npy)
    assert np.array_equal(txadj, jxadj) and np.array_equal(tadj, jadj)
    n = npx * npy
    ids = np.arange(n)
    xy = np.stack([(ids % npx) + 0.5, (ids // npx) + 0.5], 1).astype(np.float64)
    rcb = tdc.rcb_numpy(xy, k)
    assert np.array_equal(rcb, jdc.rcb_numpy(xy, k))
    stripes = (np.arange(n) % k).astype(np.int32)
    for start in (rcb, stripes):
        ours, theirs = start.copy(), start.copy()
        assert tdc.refine_cut_numpy(txadj, tadj, k, ours) == jdc.refine_cut_numpy(
            jxadj, jadj, k, theirs)
        assert np.array_equal(ours, theirs)
        assert tdc.edge_cut(ours.reshape(npy, npx)) == jdc.edge_cut(theirs.reshape(npy, npx))
    assert np.array_equal(tdc.partition_coarse_grid(npx, npy, k),
                          jdc.partition_coarse_grid(npx, npy, k))


def test_reference_400x400_run_config(tmp_path):
    """The reference's documented 4-node run: a binary 4.1 mesh of 400x400
    at dh=1/400 split into 20x20 tiles of 20^2 over 4 owners, no worse a
    cut than the quadrant map's, and the same map as the JAX package's."""
    path = str(tmp_path / "400x400.msh")
    tgmsh.write_structured_msh(path, 400, 400, 1.0 / 400, binary=True)
    msh = tgmsh.read_msh(path)
    assert tdc.infer_structured_grid(msh)[:2] == (400, 400)
    pmap = tdc.decompose(msh, 4, 20, 20)
    assert (pmap.nx, pmap.ny, pmap.npx, pmap.npy) == (20, 20, 20, 20)
    counts = np.bincount(pmap.assignment.ravel(), minlength=4)
    assert counts.max() - counts.min() <= 1
    quad = (np.arange(20)[:, None] // 10) * 2 + (np.arange(20)[None, :] // 10)
    assert tdc.edge_cut(pmap.assignment) <= tdc.edge_cut(quad)
    assert np.array_equal(pmap.assignment, jdc.decompose(path, 4, 20, 20).assignment)


def _cli(main, argv, stdin, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("flags,stdin", [
    (["--sx", "5", "--sy", "5"], ""),      # flag mode
    ([], "5 5\n"),                         # stdin mode, both sizes prompted
    (["--sx", "10"], "2\n"),               # one flag, the other prompted
    (["--sx", "3", "--sy", "5"], ""),      # a bad divisor: message, rc 0
    ([], ""),                              # nothing on stdin: rc 2
])
def test_cli_same_stdout_and_rc_as_jax(tmp_path, monkeypatch, capsys, flags, stdin):
    runs = []
    for name, main in (("torch", tcli.main), ("jax", jcli.main)):
        out = str(tmp_path / f"{name}.txt")
        rc, text, err = _cli(main, ["data/50x50.msh", out, "4", *flags], stdin, monkeypatch,
                             capsys)
        runs.append((rc, text.replace(out, "OUT"), err))
        if "wrote" in text:
            runs[-1] += (open(out, "rb").read(),)
    assert runs[0] == runs[1]
