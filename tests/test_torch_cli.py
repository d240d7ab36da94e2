"""The port's batch CLIs on the CPU: the reference's batch_tester protocol.

Every CASES_2D/CASES_1D row is held to the contract in test_torch_solver.py;
here a few rows go through the command-line surface (``--platform cpu``),
in process and once as ``python -m``.
"""

import io
import os
import subprocess
import sys

import pytest
import torch

from nonlocalheatequation_torch.cli import solve1d, solve2d
from nonlocalheatequation_torch.cli.common import parse_batch_cases
from tests.cases import CASES_1D, CASES_2D

# small grids: one intra-op thread keeps parallel test workers from
# oversubscribing the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _batch(rows) -> str:
    return f"{len(rows)}\n" + "".join(" ".join(map(str, r)) + "\n" for r in rows)


@pytest.mark.parametrize("x64", ["1", "0"])
def test_solve2d_batch_passes(monkeypatch, capsys, x64):
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch([CASES_2D[0], CASES_2D[7]])))
    assert solve2d.main(["--test_batch", "--platform", "cpu", "--x64", x64]) == 0
    assert "Tests Passed" in capsys.readouterr().out


def test_solve2d_batch_cuda_method_passes(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch([CASES_2D[5]])))
    assert solve2d.main(["--test_batch", "--platform", "cpu", "--method", "cuda"]) == 0
    assert "Tests Passed" in capsys.readouterr().out


def test_solve1d_batch_passes(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch([CASES_1D[0], CASES_1D[7]])))
    assert solve1d.main(["--test_batch", "--platform", "cpu"]) == 0
    assert "Tests Passed" in capsys.readouterr().out


def test_batch_fails_loudly(monkeypatch, capsys):
    # a diverging row (dt far past the Euler bound) fails the contract
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch([(30, 30, 50, 5, 1.0, 0.05, 0.02)])))
    assert solve2d.main(["--test_batch", "--platform", "cpu"]) == 1
    assert "Tests Failed" in capsys.readouterr().out
    monkeypatch.setattr(sys, "stdin", io.StringIO("2\n50 50 45 5 1.0 0.0005 0.02\n50 50"))
    with pytest.raises(SystemExit, match="batch case 1: truncated input"):
        solve2d.main(["--test_batch", "--platform", "cpu"])
    monkeypatch.setattr(sys, "stdin", io.StringIO("x\n"))
    with pytest.raises(SystemExit, match="not an integer test count"):
        solve1d.main(["--test_batch", "--platform", "cpu"])


def test_single_solve_and_timing_row(monkeypatch, capsys):
    assert solve2d.main(["--test", "--platform", "cpu", "--nx", "12", "--ny", "10",
                         "--nt", "4", "--eps", "3", "--cmp", "0"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[1].startswith("l2: ")
    assert "x dimension" in out and out.rstrip().endswith("4")
    monkeypatch.setattr(sys, "stdin", io.StringIO(" ".join(["1.0"] * 8)))
    assert solve1d.main(["--platform", "cpu", "--nx", "8", "--nt", "3", "--eps", "2",
                         "--results"]) == 0
    assert "S[7] = " in capsys.readouterr().out


@pytest.mark.parametrize("tokens,match", [
    ([], "batch input is empty"),
    (["-1"], "declares -1 tests"),
    (["1", "50", "x", "45", "5", "1", "0.0005", "0.02"], "batch case 0: malformed"),
    (["2", "50", "50", "45", "5", "1", "0.0005", "0.02"], "batch case 1: truncated"),
])
def test_parse_batch_cases_refuses(tokens, match):
    def read_case(toks, pos):
        return tuple(int(v) if i < 4 else float(v) for i, v in enumerate(toks[pos:pos + 7])), pos + 7

    with pytest.raises(SystemExit, match=match):
        parse_batch_cases(read_case, tokens, row_tokens=7)


def test_gpu_platform_without_card_refuses(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(_batch([CASES_2D[0]])))
    assert solve2d.main(["--test_batch"]) == 2
    assert "is_available() is false" in capsys.readouterr().err


def test_module_entry_point():
    r = subprocess.run([sys.executable, "-m", "nonlocalheatequation_torch.cli.solve2d",
                        "--test_batch", "--platform", "cpu"], input=_batch([CASES_2D[0]]),
                       capture_output=True, text=True, cwd=REPO, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "Tests Passed"
