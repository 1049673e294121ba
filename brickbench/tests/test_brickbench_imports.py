"""Nothing the benchmark's run imports, or loads while it runs a cell
and reads its metrics, has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``bricklib_tpu``, compared whole: the port's name
begins with the JAX package's."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

from brickbench import run

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import sys
import brickbench.run, brickbench.harness, brickbench.calibrate
from brickbench.cell import metric_reader, load_cell, HERE
import json
spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
from brickbench.harness import run_cell
from brickbench.tests import tiny
import tempfile, pathlib
with tempfile.TemporaryDirectory() as d:
    tiny.write(pathlib.Path(d))
    rec, _ = run_cell(tiny.cell(pathlib.Path(d), "t3"), 5, 0.1, True,
                      device="cpu", log=lambda m: None)
for m in spec["end_to_end"] + spec["per_layer"]:
    metric_reader(m["name"]).read(rec)
print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_the_run():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(out.stdout.strip().splitlines()[-1].split(","))
    assert "bricklib_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "bricklib_tpu"}


def test_forbidden_compares_whole_names():
    assert run.forbidden_modules(["bricklib_tpu_torch.drivers.weak",
                                  "jaxfoo", "numpy"]) == []
    assert run.forbidden_modules(["bricklib_tpu.core", "jaxlib.xla",
                                  "flax"]) == ["bricklib_tpu", "flax",
                                               "jaxlib"]


def test_harness_reads_no_jax_package_file():
    """The harness's sources name no file of the JAX package's benchmark."""
    for p in (ROOT / "brickbench").rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        for bad in ("import jax", "from jax", "bricklib_tpu.", "bench.py",
                    "tools/", "from bricklib_tpu ", "import bricklib_tpu\n"):
            assert bad not in text, (p, bad)
