"""``BENCHMARK.json`` and the files it names: every name and unit in the
allowed characters, every cell resolving to its configuration and
traffic, every metric to a reader that states what the file states, and a
new cell, configuration and metric added by files alone."""

from __future__ import annotations

import json
import math
import re
import shutil

import pytest

from brickbench import cell as cellmod
from brickbench.cell import HERE, NAME, UNIT, load_cell, metric_reader
from brickbench.harness import run_cell

SPEC = json.loads((HERE.parent / "BENCHMARK.json").read_text())
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
TEXT = re.compile(r"[^\t\n\r]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")


def test_top_level():
    assert set(SPEC) == KEYS
    assert SPEC["command"][:2] == ["python3", "-m"]
    assert all(TEXT.fullmatch(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.fullmatch(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert TEXT.fullmatch(e[k]), (e["name"], k)
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"])


def test_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(entry):
    c = load_cell(entry["name"])
    assert c.config["name"] == entry["config"]
    assert c.traffic["why"] == entry["why"]
    assert c.chips == entry["chips"] == c.traffic["chips"]
    assert len(c.brick) == len(c.domain) == len(c.mesh) == len(c.ghost)
    assert all(d % b == 0 for d, b in zip(c.domain, c.brick))
    assert len(c.taps) > 0
    reported = {m["name"] for m in c.metrics(False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.metrics(True)


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    path = HERE.parent / entry["file"]
    assert path.is_relative_to(HERE)
    cfg = json.loads(path.read_text())
    assert cfg["name"] == entry["name"] and cfg["reduced"] == \
        entry["reduced"]
    assert cfg["source"] == entry["source"]
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader(entry):
    mod = metric_reader(entry["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
        entry["unit"], entry["better"], entry["source"])
    if entry in SPEC["per_layer"]:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
        assert entry["moves"] in {m["name"] for m in SPEC["end_to_end"]}


def test_roofline_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_new_cell_by_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries only: the harness loads and runs the cell and
    reads the metric."""
    root = tmp_path / "bench"
    for d in ("configs", "stencils", "metrics"):
        shutil.copytree(HERE / d, root / d)
    cfg = json.loads((HERE / "configs" / "weak3d-s7pt.json").read_text())
    cfg.update(name="weak3d-s7pt-st4", st_iter=4)
    (root / "configs" / "weak3d-s7pt-st4.json").write_text(json.dumps(cfg))
    (root / "workloads").mkdir()
    (root / "workloads" / "tiny-new.json").write_text(json.dumps({
        "config": "weak3d-s7pt-st4", "domain": [16, 16, 32], "fuse": 2,
        "mesh": [1, 1, 1], "chips": 1, "problem_steps": 2, "fields": 1,
        "checked": 1, "trace_steps": 4, "host_batches": 1,
        "limit_rel_err": 1e-4, "why": "added by files alone"}))
    (root / "metrics" / "steps_per_answer.py").write_text(
        'UNIT, BETTER, SOURCE = "1", "lower", "program_counter"\n'
        'LAYER, MOVES = "drivers", "gstencil_per_s"\n'
        "def read(rec):\n    return rec.steps / max(rec.answers, 1)\n")
    spec = dict(SPEC)
    spec["configs"] = SPEC["configs"] + [dict(
        SPEC["configs"][0], name="weak3d-s7pt-st4",
        file="bench/configs/weak3d-s7pt-st4.json")]
    spec["workloads"] = [{"name": "tiny-new", "config": "weak3d-s7pt-st4",
                          "traffic": "tiny-new", "chips": 1,
                          "why": "added by files alone"}]
    spec["per_layer"] = SPEC["per_layer"] + [{
        "name": "steps_per_answer", "unit": "1", "better": "lower",
        "source": "program_counter", "layer": "drivers",
        "moves": "gstencil_per_s"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    c = load_cell("tiny-new", tmp_path / "BENCHMARK.json", root)
    rec, chk = run_cell(c, 5, 0.2, True, device="cpu", log=lambda m: None)
    assert chk["ok"], chk
    names = [m["name"] for m in c.metrics(True)]
    assert "steps_per_answer" in names
    assert metric_reader("steps_per_answer", root).read(rec) >= 2
    assert math.isfinite(metric_reader("gstencil_per_s", root).read(rec))


def test_bad_names_refused():
    with pytest.raises(ValueError):
        cellmod.check_name("a b", "metric")
    with pytest.raises(ValueError):
        cellmod.check_name("../x", "config")
