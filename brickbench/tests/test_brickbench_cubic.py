"""A cubic strong cell through the harness on the CPU: a tiny copy of
``strong3d-s7pt`` (the configuration as it is, 8^3 bricks and a ghost
brick on every axis) and a cell of 32^3 in 16^3 subdomains, written to a
temporary folder as new files; the strong adapter builds the driver's
cubic step (i-bricked K1, the six-face exchange), which reads
``correct``; without its exchange, and under the other faults, it reads
far above the limit."""

from __future__ import annotations

import json
import math
import shutil

import pytest

from brickbench import calibrate, faults, program_trace
from brickbench.cell import HERE, build_system, load_cell, metric_reader
from brickbench.harness import run_cell

SEED = 2 ** 31 + 1703
SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())
LIMIT = 1e-4
TINY = {"config": "strong3d-s7pt", "global_domain": [32, 32, 32],
        "subdomain": [16, 16, 16], "fuse": 2, "mesh": [1, 1, 1],
        "chips": 1, "problem_steps": 3, "fields": 2, "checked": 2,
        "trace_steps": 4, "host_batches": 1, "limit_rel_err": LIMIT,
        "why": "a test's cubic cell"}


def _quiet(msg):
    pass


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cubic")
    root = tmp / "bench"
    for d in ("configs", "stencils", "metrics", "systems"):
        shutil.copytree(HERE / d, root / d)
    (root / "workloads").mkdir()
    (root / "workloads" / "tiny-cubic.json").write_text(json.dumps(TINY))
    spec = dict(SPEC, workloads=[{"name": "tiny-cubic",
                                  "config": "strong3d-s7pt",
                                  "traffic": "tiny-cubic", "chips": 1,
                                  "why": TINY["why"]}])
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return load_cell("tiny-cubic", tmp / "BENCHMARK.json", root)


def test_the_configuration_is_upstreams_cubic_study(cell):
    assert cell.driver == "strong" and cell.config["reduced"] == []
    assert cell.brick == cell.ghost == (8, 8, 8)
    assert cell.subdomains_per_rank == 8
    full = load_cell("strong-s7pt-512in128")
    assert full.config == cell.config
    assert full.global_domain == (512,) * 3 and full.subdomain == (128,) * 3
    assert full.subdomains_per_rank == 64 and full.chips == 1


def test_cubic_cell_reads_correct(cell):
    rec, chk = run_cell(cell, SEED, 0.3, False, device="cpu", log=_quiet)
    assert chk["ok"], chk
    assert chk["answers"] == min(2, rec.answers) >= 1
    assert chk["rel_err"][0] < 1e-5
    assert math.isfinite(metric_reader("gstencil_per_s").read(rec))


def test_cubic_slots_are_i_bricked(cell):
    """The adapter builds the cubic step: its sweeps read i-bricked
    tables and its exchange runs over all three axes."""
    system = build_system(cell, "cpu")
    assert system.plan.sdec.grid.ndim == 3
    assert all(s.plan.ibrick for s in system.step.sweeps)
    assert sorted({st.axis for st in system.step.exchange.stages}) == \
        [0, 1, 2]


def test_cubic_no_exchange_reads_far_above_the_limit(cell):
    with faults.no_exchange(cell):
        _rec, chk = run_cell(cell, SEED, 0.3, False, device="cpu",
                             log=_quiet)
    assert not chk["ok"], chk
    assert chk["rel_err"][0] > 100 * LIMIT


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_cubic_fault_is_caught(cell, fault):
    _rec, chk = run_cell(cell, SEED, 0.3, False, device="cpu",
                         wrap=faults.WRAPS[fault], log=_quiet)
    assert not chk["ok"], chk


def test_cubic_control_fails(cell):
    """The reference in bfloat16, in the program's place, reads far above
    the limit on the cubic subdomains' blocks."""
    assert calibrate.control_reading(cell, SEED, "cpu") > 10 * LIMIT


def test_cubic_traced_run_reads_spans_and_counters(cell):
    """One exchange span a step, ``st_iter / fuse`` sweep spans, the plan
    spans (the strong driver's set-up), and the exchange's bytes every
    subdomain's whole ghost shell, six faces with their edges and
    corners; the new per-layer metrics read None on the CPU."""
    rec, chk = run_cell(cell, 5, 0.1, True, device="cpu", log=_quiet)
    assert chk["ok"]
    p = program_trace.of(rec)
    nsweeps = int(cell.config["st_iter"]) // int(cell.traffic["fuse"])
    assert p.spans["bricklib.exchange"] == p.steps
    assert p.spans["bricklib.step"] == p.steps
    assert p.spans["bricklib.sweep"] == nsweeps * p.steps
    assert p.plan_s["bricklib.plan.domain"] > 0
    grown = math.prod((d + 2 * g) // b for d, g, b in
                      zip(cell.subdomain, cell.ghost, cell.brick))
    owned = math.prod(d // b for d, b in zip(cell.subdomain, cell.brick))
    assert metric_reader("exchange_mb_per_step").read(rec) == pytest.approx(
        8 * (grown - owned) * math.prod(cell.brick) * 4 / 1e6)
    for name in ("ibrick_sweep_ms", "ibrick_roofline", "strong_exchange_ms"):
        assert metric_reader(name).read(rec) is None
