"""On the card: one short run of every cell, as the driver runs it (a
subprocess from the checkout's root), correct and with its result line.
Marked ``cuda``; skips where the process sees no CUDA card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "h100_bench.run", "--workload", cell,
         "--seed", str(2 ** 31 + 101), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
