"""Tiny cells of the benchmark's own configurations, written to a
temporary folder as a later change would add them: a benchmark file, the
configurations copied, one traffic file per cell."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from brickbench.cell import HERE, load_cell

TINY = {
    "t3": {"config": "weak3d-s7pt", "domain": [16, 16, 32], "fuse": 4,
           "mesh": [1, 1, 1], "chips": 1},
    "t3f1": {"config": "weak3d-s7pt", "domain": [16, 16, 32], "fuse": 1,
             "mesh": [1, 1, 1], "chips": 1},
    "t4": {"config": "weak4d-mpi9pt", "domain": [8, 16, 16, 32], "fuse": 2,
           "mesh": [1, 1, 1, 1], "chips": 1},
    "tm": {"config": "weak3d-s7pt", "domain": [16, 16, 32], "fuse": 4,
           "mesh": [2, 2, 1], "chips": 4},
}
RUN = {"problem_steps": 3, "fields": 2, "checked": 2, "trace_steps": 6,
       "host_batches": 2, "limit_rel_err": 1e-4, "why": "a test's cell"}


def write(root: Path) -> Path:
    """The tiny benchmark under ``root``; returns its benchmark file."""
    shutil.copytree(HERE / "configs", root / "configs")
    shutil.copytree(HERE / "stencils", root / "stencils")
    (root / "workloads").mkdir()
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["workloads"] = []
    for name, t in TINY.items():
        (root / "workloads" / f"{name}.json").write_text(
            json.dumps(dict(t, **RUN)))
        spec["workloads"].append({"name": name, "config": t["config"],
                                  "traffic": name, "chips": t["chips"],
                                  "why": RUN["why"]})
    bench = root / "BENCHMARK.json"
    bench.write_text(json.dumps(spec))
    return bench


def cell(root: Path, name: str):
    return load_cell(name, root / "BENCHMARK.json", root)
