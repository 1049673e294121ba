"""The benchmark on the card: one short run of each one-card cell through
the command, its result line read back.  Skips without a CUDA card.

    python -m pytest -p no:cacheprovider -q brickbench/tests -m gpu
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from brickbench.cell import HERE

pytestmark = pytest.mark.gpu
SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]
                                  if w["chips"] == 1])
def test_cell_runs(cuda, name):
    out = subprocess.run(
        [sys.executable, "-m", "brickbench.run", "--workload", name,
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "1"],
        cwd=Path(HERE).parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], out.stderr[-4000:]
    assert line["device"]["busy_s"] > 0
    for m in SPEC["per_layer"]:
        if name in m.get("workloads", (name,)):
            assert m["name"] in line["metrics"], m["name"]
