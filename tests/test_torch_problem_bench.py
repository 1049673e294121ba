"""``api.Problem`` as the benchmark drives it: the public step of a
caller's state (``Problem.advance``), its spans, and the 125-point cell's
files (adapter ``brickbench/systems/problem.py``, frozen taps
``brickbench/stencils/mpi125pt.py``, readers ``mxu_sweep_ms`` and
``mxu_roofline``) on a tiny cell, on the CPU, where ``backend="mxu"``
runs K8's plain version (``pencil_sweep_mxu_plain``).

The program is held against the benchmark's plain reference
(``brickbench/reference.py``: ``torch.roll`` taps over the global periodic
domain, float32) at :data:`TOL`.  Both compute the same 125 taps in
float32, the reference tap by tap in table order, the program in the
factorized form of ``ir.fold_linear`` (six k-profiles, their j sums, then
the i shifts): the sums run in different orders and differ by a few ulps
of the field a step.  The reference in bfloat16 reads over a hundred
times :data:`TOL`.
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from brickbench import calibrate, faults, fields, program_trace, reference
from brickbench import stencils as bench_stencils
from brickbench.cell import HERE, build_system, load_cell, metric_reader
from brickbench.harness import Record, run_cell
from bricklib_tpu_torch import trace
from bricklib_tpu_torch.api import Problem
from bricklib_tpu_torch.codegen.taps import params_from_reference
from bricklib_tpu_torch.stencils import bench_params

SEED = 2 ** 31 + 4093  # more than 32 signed bits hold
TOL = 1e-5
CELL = "tiny125"
DIMS = (16, 16, 64)
KW = dict(dims=DIMS, stencil="mpi125pt", st_iter=4, backend="mxu",
          device="cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark's configurations, taps, adapters and readers with one
    tiny traffic file of the 125-point configuration, as a later change
    would add a cell."""
    r = tmp_path_factory.mktemp("bench")
    for d in ("configs", "stencils", "systems", "metrics"):
        shutil.copytree(HERE / d, r / d)
    traffic = json.loads(
        (HERE / "workloads" / "mpi125pt-512-mxu.json").read_text())
    traffic.update(domain=list(DIMS), problem_steps=3, fields=2, checked=2,
                   trace_steps=6, host_batches=2, limit_rel_err=TOL,
                   why="a test's cell")
    (r / "workloads").mkdir()
    (r / "workloads" / f"{CELL}.json").write_text(json.dumps(traffic))
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": CELL, "config": traffic["config"],
                          "traffic": CELL, "chips": 1,
                          "why": traffic["why"]}]
    (r / "BENCHMARK.json").write_text(json.dumps(spec))
    return r


def _cell(root):
    return load_cell(CELL, root / "BENCHMARK.json", root)


def _quiet(msg):
    pass


def test_frozen_taps_are_the_full_cube_summing_to_one():
    taps = bench_stencils.taps("mpi125pt")
    offsets = {off for off, _c in taps}
    assert len(taps) == len(offsets) == 125
    assert offsets == {(k, j, i) for k in range(-2, 3) for j in range(-2, 3)
                       for i in range(-2, 3)}
    assert sum(c for _off, c in taps) == pytest.approx(1.0, abs=1e-12)
    assert len({c for _off, c in taps}) == 10


def test_frozen_taps_are_the_ports_mpi125pt():
    """The frozen table equals the port's ``mpi125pt`` expanded with
    ``bench_params()``, offset by offset (array-axis order both)."""
    port = params_from_reference(bench_params(), "mpi125pt")
    got = {tuple(int(o) for o in off): float(c)
           for off, c in zip(port.offsets, port.coeffs)}
    want = {off: float(np.float32(c))
            for off, c in bench_stencils.taps("mpi125pt")}
    assert got == want


def test_the_cell_is_upstreams_size():
    """The benchmark's cell: 512^3 on one card through K8, ST_ITER 4,
    nothing cut, and its two readers listing it alone."""
    c = load_cell("mpi125pt-512-mxu")
    assert (c.domain, c.brick, c.ghost, c.mesh, c.chips) == (
        (512,) * 3, (8, 8, 512), (8, 8, 0), (1, 1, 1), 1)
    assert (c.config["driver"], c.config["stencil"], c.config["st_iter"],
            c.config["reduced"]) == ("problem", "mpi125pt", 4, [])
    assert (c.traffic["backend"], c.traffic["fuse"],
            c.traffic["problem_steps"], c.traffic["fields"],
            c.traffic["checked"]) == ("mxu", 1, 16, 2, 3)
    for name in ("mxu_sweep_ms", "mxu_roofline"):
        entry = next(m for m in c.per_layer if m["name"] == name)
        assert entry["workloads"] == ["mpi125pt-512-mxu"]


def test_advance_is_step_one():
    """``advance`` gives the owned bricks ``step(1)`` leaves (K8 leaves the
    others undefined), leaving the problem's own state as it was."""
    p = Problem(**KW).init(seed=3)
    owned = torch.from_numpy(np.flatnonzero(p.dec.owned_mask()))

    def bricks(state):
        assert len(state) == len(state[0]) == 1
        return state[0][0][0].index_select(0, owned)

    s0 = p.state
    before = s0[0][0].clone()
    new = p.advance(s0)
    assert p.state is s0 and torch.equal(s0[0][0], before)
    p.step(1)
    assert torch.equal(bricks(new), bricks(p.state))
    again = p.advance(p.advance(s0))
    p.step(1)
    assert torch.equal(bricks(again), bricks(p.state))


def test_problem_opens_the_drivers_spans():
    """With tracing on, construction opens ``bricklib.plan`` around
    ``.decomp`` and ``.kernels``, ``init`` a ``bricklib.plan`` around
    ``.domain``, and each step one ``bricklib.step`` (its ordinal), each
    K8 sweep inside it; off, nothing is recorded."""
    trace.records()
    with trace.tracing():
        p = Problem(**KW)
        built = trace.records()
        p.init(seed=1)
        inited = trace.records()
        p.step(2)
        p.advance(p.state)
        stepped = trace.records()
    by_id = {s.id: s for s in built + inited + stepped}
    names = [s.name for s in built]
    assert names[0] == trace.PLAN and built[0].parent is None
    assert {trace.PLAN_DECOMP, trace.PLAN_KERNELS} <= set(names)
    assert all(by_id[s.parent].name == trace.PLAN for s in built[1:])
    assert [s.name for s in inited] == [trace.PLAN, trace.PLAN_DOMAIN]
    assert inited[1].parent == inited[0].id
    steps = [s for s in stepped if s.name == trace.STEP]
    assert [s.step for s in steps] == [1, 2, 3]
    sweeps = [s for s in stepped if s.name == trace.SWEEP]
    assert len(sweeps) == 3 * 4
    assert all(by_id[s.parent].name == trace.STEP for s in sweeps)
    assert all(s.end_ns is not None for s in built + inited + stepped)

    q = Problem(**KW).init(seed=1)
    q.step(1)
    assert trace.records() == []


def test_program_matches_reference_over_steps(root):
    """The adapter's step against the reference after each of several
    steps, from a field drawn from the seed."""
    cell = _cell(root)
    system = build_system(cell, "cpu")
    field = fields.draw_field(cell.global_domain, SEED, 0, "cpu")
    x = system.state
    for t, src in zip(system.cards(x), system.storage(field)):
        t.copy_(src)
    for n in range(1, 4):
        x = system.step(x)
        want = reference.iterate(field, cell.taps, 4 * n)
        err = reference.rel_err(system.block(system.cards(x), 0), want)
        assert err < TOL, (n, err)
        bf16 = reference.iterate(field, cell.taps, 4 * n,
                                 dtype=torch.bfloat16)
        assert reference.rel_err(bf16, want) > 100 * TOL


def test_run_is_correct(root):
    rec, chk = run_cell(_cell(root), SEED, 0.3, False, device="cpu",
                        log=_quiet)
    assert chk["ok"], chk
    assert chk["answers"] == min(2, rec.answers) >= 1
    assert chk["rel_err"][0] < TOL


def test_control_fails(root):
    """The reference in bfloat16, in the program's place, reads far above
    the limit."""
    cell = _cell(root)
    assert calibrate.control_reading(cell, SEED, "cpu") > 100 * TOL


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "no_exchange"])
def test_fault_is_caught(root, fault):
    """With the timed path broken underneath (for ``no_exchange``: the
    sweeps built on the decomposition's own table, its ghost bricks never
    refreshed), ``correct`` is false."""
    cell = _cell(root)
    if fault == "no_exchange":
        with faults.no_exchange(cell):
            _rec, chk = run_cell(cell, SEED, 0.3, False, device="cpu",
                                 log=_quiet)
    else:
        _rec, chk = run_cell(cell, SEED, 0.3, False, device="cpu",
                             wrap=faults.WRAPS[fault], log=_quiet)
    assert not chk["ok"], chk


def test_traced_run_on_the_cpu_reads_no_sweep_time(root):
    """A traced run on the CPU: the pass sees the program's spans and K8's
    plain version launches nothing, so both new readers give None and
    raise nothing."""
    rec, chk = run_cell(_cell(root), SEED, 0.2, True, device="cpu",
                        log=_quiet)
    assert chk["ok"], chk
    p = program_trace.of(rec)
    assert p is not None and not p.cuda
    assert p.spans[trace.STEP] == p.steps and p.spans[trace.SWEEP] == \
        4 * p.steps
    assert p.counters["K8"] == p.counters["k8_layout"] == 0
    for name in ("mxu_sweep_ms", "mxu_roofline"):
        assert metric_reader(name).read(rec) is None


def _traced(spans: int, layout: int | None):
    """A record whose program pass saw ``spans`` sweep spans over 2 steps
    on one card, 8 ms of device time under them, and ``k8_layout`` move by
    ``layout`` (None: the program has no such counter)."""
    rec = Record(cell=load_cell("mpi125pt-512-mxu"), setup_s=1.0, plan_s=0.5,
                 window_s=1.0, steps=2, step_s=[], answers=0, bound_s=1.0)
    p = program_trace.ProgramTrace(steps=2, cards=1, cuda=True, devices=[0])
    p.spans = {program_trace.SWEEP: spans, "bricklib.step": 2}
    p.device_s = {program_trace.SWEEP: 8e-3}
    p.counters = {"K8": spans} | ({} if layout is None
                                  else {"k8_layout": layout})
    vars(rec)["program_trace"] = p
    return rec


@pytest.mark.parametrize("spans,layout,want", [
    (8, 8, 4.0), (8, 7, None), (8, None, None), (0, 0, None)])
def test_mxu_sweep_ms_counts_only_compiled_layout_sweeps(spans, layout,
                                                         want):
    got = metric_reader("mxu_sweep_ms").read(_traced(spans, layout))
    assert got == (None if want is None else pytest.approx(want))


def test_mxu_roofline_counts_two_operations_a_distinct_coefficient():
    """The bound of the 512^3 cell: its bytes (one read of the 528 x 528 x
    512 storage, one write of the owned 512^3, 4 bytes each: 0.3307 ms)
    outweigh two operations per distinct coefficient (10), element and
    iteration (0.160 ms); 125 taps at two operations each would be 2.003
    ms, over K8's own work."""
    mod = metric_reader("mxu_roofline")
    cell = load_cell("mpi125pt-512-mxu")
    nbytes = 4 * (528 * 528 * 512 + 512 ** 3)
    assert mod.bound_s(cell) == pytest.approx(nbytes / 3.35e12)
    assert 2 * 10 * 512 ** 3 * 4 / 67e12 < mod.bound_s(cell)
    got = mod.read(_traced(8, 8))
    assert got == pytest.approx(nbytes / 3.35e12 * 1e3 / 4.0 * 100)
    assert 0 < got < 100
    assert mod.read(_traced(8, 7)) is None
