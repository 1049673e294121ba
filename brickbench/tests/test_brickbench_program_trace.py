"""The readers of the program's spans and counters
(``brickbench.program_trace``): the benchmark's own readers untouched by
program spans in a trace, the new readers' hand-computed values, a tiny
traced run on the CPU, and a program without a tracing module."""

from __future__ import annotations

import math
import sys

import pytest

from brickbench import program_trace, trace
from brickbench.cell import metric_reader
from brickbench.harness import Record, run_cell
from brickbench.tests import tiny
from brickbench.tests.test_brickbench_trace import _events, _x

NEW = ("exchange_span_ms", "sweep_launch_ms", "launches_per_step",
       "exchange_mb_per_step", "plan_domain_s")
OLD = ("exchange_ms", "sweep_ms", "sweep_roofline", "device_idle_pct")


def _with_spans():
    """The hand-written trace with the program's spans added: a
    ``bricklib.step`` inside each step mark, the K2 launch inside a
    ``bricklib.exchange``, the sweep's inside a ``bricklib.sweep``."""
    ev = _events()
    for t0 in (10, 50):
        ev += [_x("user_annotation", "bricklib.step", t0 + 0.5, 29),
               _x("user_annotation", "bricklib.exchange", t0 + 0.8, 1.5),
               _x("user_annotation", "bricklib.sweep", t0 + 2.5, 2)]
    return ev


def _record(t, **kw):
    return Record(cell=None, setup_s=1.0, plan_s=0.5, window_s=1.0, steps=2,
                  step_s=[], answers=0, bound_s=10e-6, trace=t, **kw)


def test_benchmark_readers_ignore_program_spans():
    plain, spanned = (trace.summarize(e) for e in (_events(), _with_spans()))
    assert (spanned.steps, spanned.devices, spanned.window_s) == (
        plain.steps, plain.devices, plain.window_s)
    assert spanned.busy_s() == plain.busy_s()
    assert spanned.top_ops() == plain.top_ops()
    assert sum(v for _k, v in spanned.idle_gaps()) == pytest.approx(
        sum(v for _k, v in plain.idle_gaps()))
    for name in OLD:
        reader = metric_reader(name)
        assert reader.read(_record(spanned)) == reader.read(_record(plain))


def test_attribution_by_innermost_span():
    out = program_trace.ProgramTrace(steps=2, cards=1, cuda=True, devices=[])
    program_trace._attribute(_with_spans(), out, ["K1 ghost", "K1 owned"])
    assert out.devices == [0]
    assert out.sweep_s == pytest.approx({"K1 ghost": 20e-6,
                                         "K1 owned": 20e-6})
    assert out.spans == {"bricklib.step": 2, "bricklib.exchange": 2,
                         "bricklib.sweep": 2}
    # per step K2 3 us under the exchange, the sweep 20 us; the refresh's
    # copy (4 us) under no span
    assert out.device_s == pytest.approx({
        "bricklib.exchange": 6e-6, "bricklib.sweep": 40e-6, "": 4e-6})


def _preset(**kw):
    rec = _record(trace.summarize(_with_spans()))
    p = program_trace.ProgramTrace(
        steps=4, cards=2, cuda=True, devices=[0, 1],
        spans={"bricklib.sweep": 16, "bricklib.exchange": 8},
        device_s={"bricklib.exchange": 8e-3, "bricklib.sweep": 32e-3},
        counters={"K1": 16, "K2": 8, "K3": 0, "rank_copies": 4,
                  "exchange_bytes": 80_000_000},
        plan_s={"bricklib.plan": 3.0, "bricklib.plan.domain": 2.5})
    for k, v in kw.items():
        setattr(p, k, v)
    vars(rec)["program_trace"] = p
    return rec


def test_new_readers_values():
    rec = _preset()
    read = {n: metric_reader(n).read(rec) for n in NEW}
    assert read == pytest.approx({
        "exchange_span_ms": 8e-3 / 4 / 2 * 1e3,
        "sweep_launch_ms": 32e-3 / 16 * 1e3,
        "launches_per_step": (16 + 8 + 4) / 4 / 2,
        "exchange_mb_per_step": 80e6 / 4 / 2 / 1e6,
        "plan_domain_s": 2.5})


def test_new_readers_on_the_cpu():
    """No device operation and no launch on the CPU: the device and
    launch readers give None, the byte counter and plan span read."""
    rec = _preset(cuda=False, devices=[], device_s={})
    read = {n: metric_reader(n).read(rec) for n in NEW}
    assert read["exchange_span_ms"] is None
    assert read["sweep_launch_ms"] is None
    assert read["launches_per_step"] is None
    assert read["exchange_mb_per_step"] == pytest.approx(10.0)
    assert read["plan_domain_s"] == 2.5


@pytest.mark.parametrize("name", ["t3", "t3f1", "t4"])
def test_tiny_traced_run_reads_them(tmp_path, name):
    tiny.write(tmp_path)
    cell = tiny.cell(tmp_path, name)
    rec, chk = run_cell(cell, 5, 0.1, True, device="cpu",
                        log=lambda m: None)
    assert chk["ok"]
    read = {n: metric_reader(n).read(rec) for n in NEW}
    assert read["exchange_span_ms"] is None
    assert read["sweep_launch_ms"] is None
    assert read["launches_per_step"] is None
    p = program_trace.of(rec)
    assert p.steps == int(cell.traffic["trace_steps"])
    nsweeps = int(cell.config["st_iter"]) // int(cell.traffic["fuse"])
    assert p.spans == {"bricklib.step": p.steps,
                       "bricklib.exchange": p.steps,
                       "bricklib.sweep": nsweeps * p.steps}
    # the ghost shell a step: every brick of the grown domain less the
    # owned ones, 4-byte elements
    grown = math.prod((d + 2 * g) // b for d, g, b in
                      zip(cell.domain, cell.ghost, cell.brick))
    owned = math.prod(d // b for d, b in zip(cell.domain, cell.brick))
    assert read["exchange_mb_per_step"] == pytest.approx(
        (grown - owned) * math.prod(cell.brick) * 4 / 1e6)
    assert 0 < read["plan_domain_s"] < p.plan_s["bricklib.plan"]
    assert "bricklib.plan.kernels" in p.plan_s
    assert p.sweep_s == {}


def test_no_tracing_module_reads_none(tmp_path, monkeypatch):
    """A program without ``bricklib_tpu_torch.trace`` (an older checkout):
    the pass is not made and every new reader gives None."""
    tiny.write(tmp_path)
    rec, _ = run_cell(tiny.cell(tmp_path, "t3"), 5, 0.1, True,
                      device="cpu", log=lambda m: None)
    import bricklib_tpu_torch

    monkeypatch.delattr(bricklib_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "bricklib_tpu_torch.trace", None)
    assert all(metric_reader(n).read(rec) is None for n in NEW)
    assert program_trace.of(rec) is None


def test_untraced_record_reads_none():
    rec = Record(cell=None, setup_s=1.0, plan_s=0.5, window_s=1.0, steps=2,
                 step_s=[], answers=0, bound_s=1.0)
    assert all(metric_reader(n).read(rec) is None for n in NEW)



def test_tracing_cost_turns_on_the_cpu(tmp_path):
    """``brickbench.tracing_cost`` alternates spans off and on (off, on,
    on, off) and leaves tracing off; no device, so no idle share."""
    from bricklib_tpu_torch import trace as program

    from brickbench import tracing_cost

    tiny.write(tmp_path)
    out = tracing_cost.measure(tiny.cell(tmp_path, "t3"), 4, device="cpu")
    for k in ("off", "on"):
        assert len(out[k]["host_step_ms"]) == 2
        assert all(v > 0 for v in out[k]["host_step_ms"])
        assert out[k]["device_idle_pct"] == [None, None]
    assert not program.enabled() and program.records() == []
