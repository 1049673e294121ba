"""The strong-scaling driver through the harness: a configuration names
its driver, whose adapter ``systems/<driver>.py`` the harness finds by
name under the cell's folder; a tiny strong configuration and cell added
by files alone run on the CPU and read ``correct``; every fault makes
them read not correct; the bound counts every subdomain a card holds."""

from __future__ import annotations

import json
import math
import shutil

import numpy as np
import pytest
import torch

from brickbench import calibrate, faults, fields, program_trace, roofline
from brickbench.cell import HERE, build_system, load_cell, metric_reader
from brickbench.harness import bound_s, run_cell

from . import tiny

SEED = 2 ** 31 + 1201
SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def _quiet(msg):
    pass


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("bench")
    tiny.write(r)
    return r


def test_strong_cell_by_files_alone(tmp_path):
    """A strong configuration, a traffic file and an entry added as new
    files only: the harness finds the strong adapter by the driver the
    configuration names, runs the cell and reads ``correct``."""
    root = tmp_path / "bench"
    for d in ("configs", "stencils", "metrics", "systems"):
        shutil.copytree(HERE / d, root / d)
    (root / "configs" / "strong3d-s7pt.json").write_text(
        json.dumps(tiny.STRONG))
    (root / "workloads").mkdir()
    (root / "workloads" / "tiny-strong.json").write_text(json.dumps({
        "config": "strong3d-s7pt", "global_domain": [32, 32, 64],
        "subdomain": [16, 16, 64], "fuse": 2, "mesh": [1, 1, 1],
        "chips": 1, "problem_steps": 2, "fields": 1, "checked": 1,
        "trace_steps": 4, "host_batches": 1, "limit_rel_err": 1e-4,
        "why": "added by files alone"}))
    spec = dict(SPEC, workloads=[{
        "name": "tiny-strong", "config": "strong3d-s7pt",
        "traffic": "tiny-strong", "chips": 1,
        "why": "added by files alone"}])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = load_cell("tiny-strong", tmp_path / "BENCHMARK.json", root)
    assert c.driver == "strong" and c.subdomains_per_rank == 4
    assert c.root == root
    rec, chk = run_cell(c, SEED, 0.2, False, device="cpu", log=_quiet)
    assert chk["ok"] and chk["rel_err"][0] < 1e-5, chk
    assert math.isfinite(metric_reader("gstencil_per_s", root).read(rec))


def test_adapter_found_under_the_cells_root(tmp_path):
    """An adapter added as a new file in the cell's folder is the one
    that builds its step, as a new metric file is the one that reads."""
    root = tmp_path / "bench"
    root.mkdir()
    tiny.write(root)
    (root / "systems" / "weak2.py").write_text(
        (HERE / "systems" / "weak.py").read_text()
        + "\n\nclass System(System):\n    ADDED = True\n")
    path = root / "configs" / "weak3d-s7pt.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    driver="weak2")))
    cell = tiny.cell(root, "t3")
    assert cell.driver == "weak2"
    assert build_system(cell, "cpu").ADDED
    with faults.no_exchange(cell):
        _rec, chk = run_cell(cell, SEED, 0.2, False, device="cpu",
                             log=_quiet)
    assert not chk["ok"], chk


@pytest.mark.parametrize("name", ["ts", "tsm"])
def test_strong_matches_reference(root, name):
    cell = tiny.cell(root, name)
    rec, chk = run_cell(cell, SEED, 0.3, False, device="cpu", log=_quiet)
    assert chk["ok"], chk
    assert chk["answers"] == min(2, rec.answers) >= 1
    assert chk["rel_err"][0] < 1e-5


@pytest.mark.parametrize("name", ["ts", "tsm"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "no_exchange"])
def test_strong_fault_is_caught(root, name, fault):
    """With the strong step broken underneath, ``correct`` is false."""
    cell = tiny.cell(root, name)
    if fault == "no_exchange":
        with faults.no_exchange(cell):
            _rec, chk = run_cell(cell, SEED, 0.3, False, device="cpu",
                                 log=_quiet)
    else:
        _rec, chk = run_cell(cell, SEED, 0.3, False, device="cpu",
                             wrap=faults.WRAPS[fault], log=_quiet)
    assert not chk["ok"], chk


@pytest.mark.parametrize("name", ["ts", "tsm"])
def test_strong_control_fails(root, name):
    """The reference in bfloat16, in the program's place, reads far
    above the limit on the strong cell's subdomain blocks."""
    cell = tiny.cell(root, name)
    err = calibrate.control_reading(cell, SEED, "cpu")
    assert err > 10 * float(cell.traffic["limit_rel_err"])


@pytest.mark.parametrize("name", ["ts", "tsm"])
def test_strong_slots(root, name):
    """The slots cover the subdomain grid once, in the program's Z-Morton
    rows, and a field written into the state reads back block by
    block."""
    cell = tiny.cell(root, name)
    system = build_system(cell, "cpu")
    n = math.prod(cell.subdomain_grid)
    assert sorted(system.coords) == list(np.ndindex(*cell.subdomain_grid))
    assert len(system.places) == n == cell.ranks * cell.subdomains_per_rank
    rows = system.plan.nsub_local
    assert [c for c in system.coords[:rows]] == [
        tuple(int(x) for x in s) for s in system.plan.sub_order]
    f = fields.draw_field(cell.global_domain, SEED, 0, "cpu")
    cards = system.storage(f)
    assert [tuple(t.shape) for t in cards] == [
        tuple(t.shape) for t in system.cards(system.state)]
    for i, coords in enumerate(system.coords):
        assert torch.equal(system.block(cards, i),
                           fields.rank_block(f, coords, cell.subdomain))


@pytest.mark.parametrize("config", ["strong3d-s7pt", "weak3d-s7pt"])
@pytest.mark.parametrize("change", [{"driver": None}, {"driver": "nosuch"},
                                    {"driver": "../weak"}])
def test_driver_missing_or_unknown_raises(tmp_path, config, change):
    root = tmp_path / "bench"
    root.mkdir()
    tiny.write(root)
    path = root / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    if change["driver"] is None:
        del cfg["driver"]
    else:
        cfg["driver"] = change["driver"]
    path.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=f"{config}|driver"):
        tiny.cell(root, "ts" if config.startswith("strong") else "t3")


@pytest.mark.parametrize("name", ["ts", "tsm"])
def test_strong_bound_counts_subdomains(root, name):
    """``bound_s`` of a strong cell is one subdomain's work times the
    subdomains a card holds; the weak cells' bounds are as they were."""
    cell = tiny.cell(root, name)
    per_card = cell.ranks * cell.subdomains_per_rank // cell.chips
    assert per_card == math.prod(cell.subdomain_grid) // cell.chips > 1
    nbytes, flops = roofline.step_work(cell.subdomain, cell.ghost,
                                       len(cell.taps), 8)
    assert bound_s(cell) == roofline.bound(per_card * nbytes,
                                           per_card * flops)[0]
    assert bound_s(load_cell("s7pt-512-f4")) == pytest.approx(
        0.3307e-3, rel=1e-3)
    assert bound_s(load_cell("mpi9pt4d-f2")) == pytest.approx(
        0.2492e-3, rel=1e-3)


def test_strong_traffic_names_no_rank_domain(root):
    """A strong traffic states its decomposition in its own words: no
    weak ``domain``, so a harness that knows only ``domain`` stops."""
    cell = tiny.cell(root, "ts")
    assert "domain" not in cell.traffic
    assert cell.domain == cell.global_domain == (32, 32, 64)
    assert cell.subdomain == (16, 16, 64)
    assert cell.brick == (8, 8, 64)
    weak = load_cell("s7pt-512-f4")
    assert weak.subdomain == weak.domain and weak.subdomains_per_rank == 1


def test_strong_traced_run_reads_counters(root):
    """A tiny traced strong run: one exchange span a step, ``st_iter /
    fuse`` sweep spans, and the exchange's bytes every subdomain's ghost
    shell."""
    cell = tiny.cell(root, "ts")
    rec, chk = run_cell(cell, 5, 0.1, True, device="cpu", log=_quiet)
    assert chk["ok"]
    p = program_trace.of(rec)
    assert p.steps == int(cell.traffic["trace_steps"])
    nsweeps = int(cell.config["st_iter"]) // int(cell.traffic["fuse"])
    assert p.spans["bricklib.exchange"] == p.steps
    assert p.spans["bricklib.sweep"] == nsweeps * p.steps
    grown = math.prod((d + 2 * g) // b for d, g, b in
                      zip(cell.subdomain, cell.ghost, cell.brick))
    owned = math.prod(d // b for d, b in zip(cell.subdomain, cell.brick))
    assert metric_reader("exchange_mb_per_step").read(rec) == pytest.approx(
        4 * (grown - owned) * math.prod(cell.brick) * 4 / 1e6)
    assert metric_reader("plan_domain_s").read(rec) is None
