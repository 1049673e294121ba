"""A cell of ``BENCHMARK.json`` and the files it names.

The harness finds every piece by name: the cell's entry in
``BENCHMARK.json`` names its configuration and traffic;
``configs/<config>.json`` and ``workloads/<traffic>.json`` hold them;
``stencils/<stencil>.py`` holds the taps; ``metrics/<metric>.py`` reads
each metric.  Nothing here knows a particular cell.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
from dataclasses import dataclass, field
from pathlib import Path

from . import stencils

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r} is not a benchmark name")
    return name


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell: its entry, configuration and traffic, with the metric
    entries of ``BENCHMARK.json`` that it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def domain(self) -> tuple[int, ...]:
        return tuple(int(d) for d in self.traffic["domain"])

    @property
    def mesh(self) -> tuple[int, ...]:
        return tuple(int(m) for m in self.traffic["mesh"])

    @property
    def brick(self) -> tuple[int, ...]:
        """Brick shape, 0 standing for the domain's extent on that axis."""
        return tuple(int(b) or d for b, d in
                     zip(self.config["brick"], self.domain))

    @property
    def ghost(self) -> tuple[int, ...]:
        return tuple(int(g) for g in self.config["ghost"])

    @property
    def global_domain(self) -> tuple[int, ...]:
        return tuple(m * d for m, d in zip(self.mesh, self.domain))

    @property
    def ranks(self) -> int:
        return math.prod(self.mesh)

    @property
    def taps(self):
        return stencils.taps(self.config["stencil"])

    @property
    def updates_per_step(self) -> int:
        """Element updates of one step over every rank."""
        return math.prod(self.global_domain) * int(self.config["st_iter"])

    def metrics(self, trace: bool) -> list[dict]:
        """The metric entries this cell reports: its end-to-end metrics
        without tracing, its per-layer metrics with it."""
        return self.per_layer if trace else self.end_to_end


def load_cell(name: str, bench: Path | None = None,
              root: Path | None = None) -> Cell:
    """The cell ``name`` of the benchmark file ``bench`` (default: the
    ``BENCHMARK.json`` beside this folder), its files under ``root``
    (default: this folder)."""
    root = Path(root or HERE)
    spec = _read_json(Path(bench or HERE.parent / "BENCHMARK.json"))
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in the benchmark")
    config = _read_json(root / "configs" /
                        f"{check_name(entry['config'], 'config')}.json")
    traffic = _read_json(root / "workloads" /
                         f"{check_name(entry['traffic'], 'traffic')}.json")
    if traffic["config"] != entry["config"]:
        raise ValueError(f"traffic {entry['traffic']!r} is for "
                         f"{traffic['config']!r}, not {entry['config']!r}")
    return Cell(name, int(entry["chips"]), config, traffic,
                spec["end_to_end"], spec["per_layer"])


def metric_reader(name: str, root: Path | None = None):
    """The module ``metrics/<name>.py`` of ``root`` (default: this
    folder), loaded from its file."""
    path = Path(root or HERE) / "metrics" / f"{check_name(name, 'metric')}.py"
    spec = importlib.util.spec_from_file_location(
        f"brickbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
