"""A cell of ``BENCHMARK.json`` and the files it names.

The harness finds every piece by name: the cell's entry in
``BENCHMARK.json`` names its configuration and traffic;
``configs/<config>.json`` and ``workloads/<traffic>.json`` hold them;
the configuration names its driver, whose adapter is
``systems/<driver>.py``; ``stencils/<stencil>.py`` holds the taps;
``metrics/<metric>.py`` reads each metric.  Nothing here knows a
particular cell.

A weak cell's traffic gives each rank's ``domain``; a strong cell's gives
the ``global_domain`` and the ``subdomain`` it is cut into, every rank
holding a block of subdomains.
"""

from __future__ import annotations

import functools
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
    entries of ``BENCHMARK.json`` that it reports, and the folder whose
    files it was loaded from (``root``: its adapter's too)."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    root: Path = HERE

    @functools.cached_property
    def adapter(self):
        """The adapter of the configuration's driver, ``systems/<driver>.py``
        under ``root``, loaded once (:func:`system_adapter`)."""
        return system_adapter(self.driver, self.root)

    @property
    def driver(self) -> str:
        """The name of the configuration's driver: its adapter is
        ``systems/<driver>.py``."""
        name = self.config.get("driver")
        if name is None:
            raise ValueError(f"configuration {self.config.get('name')!r} "
                             "names no driver")
        return check_name(name, "driver")

    @property
    def domain(self) -> tuple[int, ...]:
        """One rank's domain: the traffic's ``domain``, else the global
        domain over the mesh."""
        if "domain" in self.traffic:
            return tuple(int(d) for d in self.traffic["domain"])
        return _split(self.global_domain, self.mesh, "the mesh")

    @property
    def subdomain(self) -> tuple[int, ...]:
        """The block a slot of the program's state holds: the traffic's
        ``subdomain``, else the rank's domain."""
        if "subdomain" not in self.traffic:
            return self.domain
        return tuple(int(d) for d in self.traffic["subdomain"])

    @property
    def subdomains_per_rank(self) -> int:
        return math.prod(_split(self.domain, self.subdomain,
                                "the subdomain"))

    @property
    def subdomain_grid(self) -> tuple[int, ...]:
        """Subdomains per axis of the global domain."""
        return _split(self.global_domain, self.subdomain, "the subdomain")

    @property
    def mesh(self) -> tuple[int, ...]:
        return tuple(int(m) for m in self.traffic["mesh"])

    @property
    def brick(self) -> tuple[int, ...]:
        """Brick shape, 0 standing for the subdomain's extent on that
        axis."""
        return tuple(int(b) or d for b, d in
                     zip(self.config["brick"], self.subdomain))

    @property
    def ghost(self) -> tuple[int, ...]:
        return tuple(int(g) for g in self.config["ghost"])

    @property
    def global_domain(self) -> tuple[int, ...]:
        if "global_domain" in self.traffic:
            return tuple(int(d) for d in self.traffic["global_domain"])
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
        without tracing, its per-layer metrics with it; of a metric that
        lists its ``workloads``, only the cells listed."""
        return [m for m in (self.per_layer if trace else self.end_to_end)
                if self.name in m.get("workloads", (self.name,))]


def _split(whole, part, what: str) -> tuple[int, ...]:
    """``whole // part`` per axis; raises unless ``part`` divides it."""
    if len(whole) != len(part) or any(
            p <= 0 or w % p for w, p in zip(whole, part)):
        raise ValueError(f"{tuple(whole)} does not split by {what} "
                         f"{tuple(part)}")
    return tuple(w // p for w, p in zip(whole, part))


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
    cell = Cell(name, int(entry["chips"]), config, traffic,
                spec["end_to_end"], spec["per_layer"], root)
    if not (root / "systems" / f"{cell.driver}.py").is_file():
        raise ValueError(f"configuration {entry['config']!r} names the "
                         f"driver {cell.driver!r}, which has no adapter")
    cell.adapter  # loaded now: a run may outlast a temporary root
    return cell


def _load(kind: str, name: str, root: Path | None):
    """The module ``<kind>s/<name>.py`` of ``root`` (default: this
    folder), loaded from its file."""
    path = Path(root or HERE) / f"{kind}s" / f"{check_name(name, kind)}.py"
    spec = importlib.util.spec_from_file_location(
        f"brickbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path | None = None):
    """The module ``metrics/<name>.py`` of ``root`` (default: this
    folder), loaded from its file."""
    return _load("metric", name, root)


def system_adapter(driver: str, root: Path | None = None):
    """The module ``systems/<driver>.py`` of ``root`` (default: this
    folder): its ``System`` builds the program's step for a cell, its
    ``no_exchange()`` is the fault that builds it without its exchange."""
    return _load("system", driver, root)


def build_system(cell: Cell, device: str = "cuda"):
    """The program under test on ``cell``: the ``System`` of the adapter
    that the cell's configuration names."""
    return cell.adapter.System(cell, device)
