"""The reduction of a profiler trace to the per-layer metrics' input, on
a trace written by hand."""

from __future__ import annotations

import pytest

from brickbench import trace
from brickbench.cell import metric_reader
from brickbench.harness import Record


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def _events():
    ev = [_x("user_annotation", trace.WINDOW, 0, 100)]
    ev += [_x("user_annotation", trace.REFRESH, 0, 5),
           _x("cuda_runtime", "cudaMemcpyAsync", 1, 1, correlation=1),
           _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 2, 4,
              device=0, correlation=1)]
    for s, t0 in enumerate((10, 50)):  # two steps: K2 then a sweep
        ev += [_x("user_annotation", trace.STEP, t0, 30),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 1, 1,
                  correlation=10 + s),
               _x("kernel", "copy_pool_kernel", t0 + 2, 3, device=0,
                  correlation=10 + s),
               _x("cuda_runtime", "cudaLaunchKernel", t0 + 3, 1,
                  correlation=20 + s),
               _x("kernel", "pencil_sweep_kernel", t0 + 6, 20, device=0,
                  correlation=20 + s)]
    ev.append(_x("kernel", "outside", 150, 5, device=0, correlation=99))
    return ev


def test_summary():
    t = trace.summarize(_events())
    assert t.window_s == pytest.approx(100e-6)
    assert t.steps == 2 and t.devices == [0]
    assert t.busy_s() == pytest.approx((4 + 2 * 23) * 1e-6)
    assert t.busy_s(owner=trace.STEP) == pytest.approx(46e-6)
    ex = metric_reader("exchange_ms")
    assert t.op_seconds(ex.matches, owner=trace.STEP) == pytest.approx(6e-6)
    assert t.top_ops(1)[0][0] == "pencil_sweep_kernel"
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx((6 + 1 + 16 + 1) * 1e-6)
    assert all(k.startswith(("brickbench.", "host")) for k in gaps)


def test_readers_on_trace():
    t = trace.summarize(_events())
    rec = Record(cell=None, setup_s=1.0, plan_s=0.5, window_s=1.0, steps=2,
                 step_s=[], answers=0, bound_s=10e-6, trace=t)
    ex = metric_reader("exchange_ms").read(rec)
    sw = metric_reader("sweep_ms").read(rec)
    assert ex == pytest.approx(3e-3)
    assert sw == pytest.approx(23e-3 - 3e-3)
    assert metric_reader("sweep_roofline").read(rec) == pytest.approx(
        10e-3 / sw * 100)
    assert metric_reader("device_idle_pct").read(rec) == pytest.approx(50)


def test_no_window_mark():
    with pytest.raises(ValueError):
        trace.summarize([_x("kernel", "k", 0, 1, device=0)])


def test_readers_without_trace():
    rec = Record(cell=None, setup_s=1.0, plan_s=0.5, window_s=1.0, steps=2,
                 step_s=[], answers=0, bound_s=1.0)
    for name in ("exchange_ms", "sweep_ms", "sweep_roofline",
                 "device_idle_pct", "host_step_ms"):
        assert metric_reader(name).read(rec) is None
