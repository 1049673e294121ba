"""The port's tracing module (``bricklib_tpu_torch.trace``) on the CPU:
off, a span is one shared no-op that records nothing; on, spans nest with
their parent and step ordinal and appear as ranges in a ``torch.profiler``
trace; the weak step's spans and counters; each launch counter read from
its wrapper's attribute; the ghost bytes of one exchange; and one
``bricklib.sweep`` span per call of every sweep planner's callable."""

import json
import math
import tracemalloc

import numpy as np
import pytest
import torch

from bricklib_tpu_torch import st, trace
from bricklib_tpu_torch.codegen.dense_kernel import dense_stencil
from bricklib_tpu_torch.codegen.mxu_kernel import pencil_sweep_mxu
from bricklib_tpu_torch.codegen.pencil_kernel_2d import pencil_sweep_2d
from bricklib_tpu_torch.codegen.pencil_kernel_nd import pencil_sweep_nd
from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu_torch.comm.exchange import (put_exchange, shift_exchange,
                                              stage_copies, written_rows)
from bricklib_tpu_torch.comm.mesh import run_mesh
from bricklib_tpu_torch.core import init_grid, random_array
from bricklib_tpu_torch.drivers import weak
from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

from torch_2d_stencils import BUILDERS, PARAMS
from torch_nd_stencils import star_nd

STEP = dict(dims=(16, 16, 32), bdim=(8, 8, 32), stencil="s7pt", st_iter=8,
            table_periodic=False, device="cpu")
STEP4 = dict(dims=(8, 8, 8, 16), bdim=(4, 4, 4, 16), stencil="mpi9pt",
             st_iter=4, fuse=2, table_periodic=False, device="cpu")


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no records."""
    trace.disable()
    trace.records()
    yield
    trace.disable()
    trace.records()


def _shell_bytes(dec) -> int:
    return (dec.nbricks - dec.sep_pos[1]) * math.prod(dec.bdims) * 4


def test_off_span_is_one_shared_no_op():
    args = trace.sweep_args("K1", 4, ((0, 4), (1, 3)))
    spans = {id(trace.span(trace.STEP, step=3)), id(trace.span("x")),
             id(trace.span(trace.SWEEP, args))}
    assert spans == {id(trace.NULL)}
    with trace.span(trace.EXCHANGE) as s:
        assert s is trace.NULL
    # nothing allocated a call: 10,000 spans peak under 1 KiB
    tracemalloc.start()
    try:
        for _ in range(10_000):
            with trace.span(trace.SWEEP, args):
                pass
            with trace.span(trace.STEP, step=3):
                pass
        assert tracemalloc.get_traced_memory()[1] < 1024
    finally:
        tracemalloc.stop()
    step, x, _dec = weak.build_step(**STEP, fuse=4)
    step(x)
    assert trace.records() == []
    assert not trace.enabled()


def test_on_spans_nest_with_parent_and_step(tmp_path):
    args = {"kernel": "K1"}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.tracing():
            assert trace.enabled()
            with trace.span("bricklib.plan"):
                pass
            with trace.span(trace.STEP, step=7):
                with trace.span(trace.EXCHANGE):
                    pass
                with trace.span(trace.SWEEP, args) as inner:
                    assert inner.end_ns is None
    assert not trace.enabled()
    plan, step, ex, sw = trace.records()
    assert [s.name for s in (plan, step, ex, sw)] == [
        "bricklib.plan", trace.STEP, trace.EXCHANGE, trace.SWEEP]
    assert plan.parent is None and plan.step is None
    assert step.parent is None and step.step == 7
    assert ex.parent == sw.parent == step.id
    assert ex.step == sw.step == 7 and sw.args is args
    assert step.start_ns <= ex.start_ns <= ex.end_ns <= sw.start_ns \
        <= sw.end_ns <= step.end_ns
    assert trace.records() == []
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X"
             and e.get("cat", "").lower() == "user_annotation"]
    assert sorted(names) == sorted(["bricklib.plan", trace.STEP,
                                    trace.EXCHANGE, trace.SWEEP])
    times = trace.span_times(events)
    assert {k: v[0] for k, v in times.items()} == {
        "bricklib.plan": 1, trace.STEP: 1, trace.EXCHANGE: 1,
        trace.SWEEP: 1}


def test_tracing_restores_an_enabled_state():
    trace.enable()
    with trace.tracing():
        pass
    assert trace.enabled()


@pytest.mark.parametrize("name", sorted({**trace.KERNELS, **trace.BODIES}))
def test_each_counter_reads_its_wrappers_attribute(name):
    """A launch counter (a kernel's, or K1's register body's or i-bricked
    layout's) is the attribute of the wrapper its entry names: moving that
    attribute moves that counter and no other."""
    import importlib

    mod, fn, *attr = {**trace.KERNELS, **trace.BODIES}[name]
    w = getattr(importlib.import_module(f"bricklib_tpu_torch.{mod}"), fn)
    attr = attr[0] if attr else "launches"
    before = trace.counters()
    setattr(w, attr, getattr(w, attr) + 3)
    try:
        after = trace.counters()
    finally:
        setattr(w, attr, getattr(w, attr) - 3)
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} \
        == {name: 3}


def test_k1_ibrick_quads_is_a_counter():
    """``k1_ibrick_quads`` (K1's register body on an i-bricked table, every
    output quad of rows stored from one row offset) is among the program's
    counters."""
    assert "k1_ibrick_quads" in trace.counters()
    assert trace.BODIES["k1_ibrick_quads"] == (
        "codegen.pencil_kernel", "pencil_sweep_kernel", "quad_launches")


@pytest.mark.parametrize("layout", ["ibrick", "pencil"])
@pytest.mark.parametrize("fuse", [1, 2, 4])
def test_k1_ibrick_quads_moves_once_per_quad_storing_launch(
        monkeypatch, layout, fuse):
    """Each launch of K1's register-streaming body on an i-bricked table at
    ``fuse=4`` (bricks 4 deep in j: no quad of rows straddles a pencil)
    moves ``k1_ibrick_quads``, ``k1_ibrick``, ``k1_regstream`` and ``K1``
    by one; at ``fuse=2`` the body's quads straddle pencils and
    ``k1_ibrick_quads`` stays; the ring body on an i-bricked table
    (``fuse=1``) moves ``k1_ibrick`` and ``K1`` alone, and no pencil launch
    moves ``k1_ibrick_quads``.  The library is a stand-in here, so the
    wrapper's dispatch and counting run on the CPU."""
    from types import SimpleNamespace

    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.codegen import pencil_kernel as k1
    from bricklib_tpu_torch.comm import StrongDecomp

    calls = []
    lib = SimpleNamespace(
        bt_pencil_sweep=lambda *a: calls.append("stream") or 0,
        bt_pencil_sweep_regstream=lambda *a: calls.append("regstream") or 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(k1, "_check_k1_args", lambda *a: None)
    if layout == "ibrick":
        plan = StrongDecomp(dom=(32,) * 3, sdom=(16,) * 3,
                            mesh_shape=(1, 1, 1), bdims=(4, 4, 4),
                            ghost_depth=(4, 4, 4)).initialize(
            skinlist_by_name("good", 3))
        grid, nb = plan.sdec.grid, plan.sdec.nbricks
        fn = k1.pencil_sweep("s7pt", grid, (4, 4, 4), 2 * nb,
                             bench_params(), i_ghost=1, batch=2,
                             batch_stride=nb, fuse=fuse)
        x = torch.zeros((2 * nb, 4, 4, 4))
    else:
        dec = BrickDecomp(dims=(16, 16, 32), ghost_depth=(4, 4, 0),
                          bdims=(4, 4, 32)).initialize(
            skinlist_by_name("good", 3))
        fn = k1.pencil_sweep("s7pt", dec.grid, dec.bdims, dec.nbricks,
                             bench_params(), fuse=fuse)
        x = torch.zeros((dec.nbricks, 4, 4, 32))
    table = torch.from_numpy(fn.plan.table)
    before = trace.counters()
    k1.pencil_sweep_kernel(x, table, fn.plan)
    after = trace.counters()
    d = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    reg = int(fuse > 1)
    ib = int(layout == "ibrick")
    assert calls == ["regstream" if reg else "stream"]
    assert d == {k: v for k, v in (("K1", 1), ("k1_regstream", reg),
                                   ("k1_ibrick", ib),
                                   ("k1_ibrick_quads",
                                    ib * int(fuse == 4))) if v}


def test_k4_register_body_launches_count_as_k4(monkeypatch):
    """Each launch of K4's register-streaming body moves ``k4_regstream``
    and ``K4`` by one; K4's other launches (the star at ``fuse`` 1 and 4,
    generic taps) move ``K4`` alone.  Each launches ``k4_launch``'s body at
    its shared memory.  The library is a stand-in here, so the wrapper's
    dispatch and counting run on the CPU."""
    from types import SimpleNamespace

    from bricklib_tpu_torch import _build
    from bricklib_tpu_torch.bench.k4_regimes import mixed_radius
    from bricklib_tpu_torch.codegen import pencil_kernel_4d as k4
    from bricklib_tpu_torch.stencils import bench_params

    calls = []
    lib = SimpleNamespace(
        bt_pencil_sweep_4d=lambda *a: calls.append(("stream", a[-3])) or 0,
        bt_pencil_sweep_regstream_4d=lambda *a: calls.append(
            ("regstream", a[-2])) or 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(k4, "_check_k4_args", lambda *a: None)
    dims, bd = (8, 8, 8, 16), (4, 4, 4, 16)
    dec = BrickDecomp(dims=dims, ghost_depth=bd[:3] + (0,),
                      bdims=bd).initialize(skinlist_by_name("good", 4))
    x = torch.zeros((dec.nbricks,) + bd)
    table = torch.from_numpy(np.ascontiguousarray(dec.grid[..., 0],
                                                  np.int32))
    gen = BrickDecomp(dims=(4, 8, 8, 16), ghost_depth=(2, 4, 4, 0),
                      bdims=(2, 4, 4, 16)).initialize(
        skinlist_by_name("good", 4))
    for stencil, d, fuse, n in (("mpi9pt", dec, 2, 1), ("mpi9pt", dec, 4, 0),
                                ("mpi9pt", dec, 1, 0),
                                (mixed_radius(), gen, 2, 0)):
        prm = bench_params() if stencil == "mpi9pt" else {}
        fn = k4.pencil_sweep_4d(stencil, d.grid, d.bdims, d.nbricks, prm,
                                fuse=fuse)
        xs = x if d is dec else torch.zeros((gen.nbricks,) + gen.bdims)
        tb = table if d is dec else torch.from_numpy(fn.plan.table)
        before = trace.counters()
        k4.pencil_sweep_4d_kernel(xs, tb, fn.plan)
        after = trace.counters()
        assert after["K4"] - before["K4"] == 1
        assert after["k4_regstream"] - before["k4_regstream"] == n
        lp = k4.k4_launch(fn.plan)
        assert calls.pop() == (lp.body, lp.smem_bytes)
        assert (lp.body == "regstream") == bool(n)


@pytest.mark.parametrize("nd", [3, 4])
@pytest.mark.parametrize("kind", ["shift", "put"])
def test_exchange_bytes_are_the_ghost_shell(nd, kind):
    """One exchange on a rank of one card writes its ghost shell,
    ``(nbricks - sep_pos[1])`` bricks of 4-byte elements, each once."""
    dims, bd = ((16, 16, 32), (8, 8, 32)) if nd == 3 else \
        ((8, 8, 8, 16), (4, 4, 4, 16))
    dec = BrickDecomp(dims=dims, ghost_depth=bd[:-1] + (0,),
                      bdims=bd).initialize(skinlist_by_name("good", nd))
    make = shift_exchange if kind == "shift" else put_exchange
    ex = make(dec, (1,) * nd, table_axes=(nd - 1,))
    x = torch.from_numpy(random_array((dec.nbricks,) + bd, np.float32, 1))
    before = trace.counters()
    ex(x)
    ex(x)
    after = trace.counters()
    assert after["exchange_bytes"] - before["exchange_bytes"] == \
        2 * _shell_bytes(dec)
    assert after["rank_copies"] == before["rank_copies"]


def test_written_rows_counts_each_row_once():
    assert written_rows([(0, 2, 5), (0, 4, 7), (1, 0, 3), (0, 9, 10)]) == \
        5 + 1 + 3


@pytest.mark.parametrize("kind", ["shift", "put"])
def test_copies_between_ranks_are_counted(kind):
    """On a mesh of two ranks (both on the CPU) the exchange copies
    between ranks with one ``Tensor.copy_`` per copy of its plan; each is
    counted, and the ghost bytes are both ranks' shells."""
    dec = BrickDecomp(dims=(16, 16, 32), ghost_depth=(8, 8, 0),
                      bdims=(8, 8, 32)).initialize(
        skinlist_by_name("good", 3))
    mesh = run_mesh((2, 1, 1), "cpu")
    ex = weak.EXCHANGES[kind](dec, mesh, table_axes=(2,))
    if kind == "put":
        cross = [c for c in ex.copies if c[6]]
    else:
        cross = [c for st_ in ex.stages if st_.remote
                 for c in stage_copies(st_, (2, 1, 1))]
    state = [torch.zeros((2, dec.nbricks, 8, 8, 32))]
    before = trace.counters()
    ex(state)
    after = trace.counters()
    assert after["rank_copies"] - before["rank_copies"] == len(cross) > 0
    assert after["exchange_bytes"] - before["exchange_bytes"] == \
        2 * _shell_bytes(dec)


@pytest.mark.parametrize("kw,kernel,nsweeps", [
    (dict(STEP, fuse=4), "K1", 2), (dict(STEP, fuse=1), "K1", 8),
    (STEP4, "K4", 2)], ids=["3d-f4", "3d-f1", "4d-f2"])
def test_weak_step_spans(kw, kernel, nsweeps):
    """The weak step traced: the plan with its decomposition and domain,
    then per step one ``bricklib.step`` holding one exchange and the
    sweeps (ghost-inclusive but the last), the sweeps' plans made in the
    first step before its sweeps; the ghost shell's bytes counted once a
    step."""
    with trace.tracing():
        step, x, dec = weak.build_step(**kw)
        plan = trace.records()
        before = trace.counters()
        for _ in range(2):
            x = step(x)
        after = trace.counters()
    names = [s.name for s in plan]
    assert names == [trace.PLAN, trace.PLAN_DECOMP, trace.PLAN_DOMAIN]
    assert plan[1].parent == plan[2].parent == plan[0].id
    spans = trace.records()
    steps = [s for s in spans if s.name == trace.STEP]
    assert [s.step for s in steps] == [1, 2]
    for s in steps:
        kids = [c for c in spans if c.parent == s.id]
        want = [trace.EXCHANGE] + ([trace.PLAN_KERNELS] if s.step == 1
                                   else []) + [trace.SWEEP] * nsweeps
        assert [c.name for c in kids] == want
        sweeps = [c for c in kids if c.name == trace.SWEEP]
        assert [c.args["region"] for c in sweeps] == \
            ["ghost"] * (nsweeps - 1) + ["owned"]
        assert {c.args["kernel"] for c in sweeps} == {kernel}
        assert {c.args["fuse"] for c in sweeps} == {kw["fuse"]}
        assert all(c.step == s.step for c in kids)
    assert after["exchange_bytes"] - before["exchange_bytes"] == \
        2 * _shell_bytes(dec)
    # on the CPU the plain versions run: nothing launches
    assert all(after[k] == before[k] for k in trace.KERNELS)


def test_oracle_step_span():
    with trace.tracing():
        step, x, _dec = weak.build_step(dims=(16, 16, 16), bdim=(8, 8, 8),
                                        stencil="s7pt", st_iter=2,
                                        backend="jnp", device="cpu")
        trace.records()
        step(x)
    spans = trace.records()
    assert [s.name for s in spans if s.parent is None] == [trace.STEP]
    assert [s.name for s in spans[1:]] == [trace.EXCHANGE]


def _k6():
    fn = pencil_sweep_2d(BUILDERS["box9"](st), np.arange(6, dtype=np.int32),
                         (8, 64), 6, PARAMS, y_range=(0, 6))
    return fn, (torch.rand(6, 8, 64),)


def _k7():
    fn = dense_stencil(stencil_by_name("s7pt")[0], (11, 24, 256),
                       (1, 8, 64), bench_params())
    return fn, (torch.rand(11, 24, 256),)


def _k8():
    grid, info = init_grid((5, 4, 1))
    fn = pencil_sweep_mxu(stencil_by_name("s7pt")[0], np.asarray(grid),
                          (2, 2, 8), info.nbricks, bench_params())
    return fn, (torch.rand(info.nbricks, 2, 16),)


def _k12():
    bd = (2, 2, 4, 4, 16)
    dec = BrickDecomp(dims=(4, 4, 8, 8, 16), ghost_depth=bd[:-1] + (0,),
                      bdims=bd).initialize(skinlist_by_name("good", 5))
    fn = pencil_sweep_nd(star_nd(st, 5), dec.grid, bd, dec.nbricks, {})
    return fn, (torch.rand((dec.nbricks,) + bd),)


def _k11():
    step, state, _dec = weak.build_step(
        dims=(32, 16, 32), bdim=(8, 8, 32), stencil="s7pt", st_iter=2,
        fuse=1, table_periodic=False, mesh_shape=(2, 2, 1),
        exchange="fused", device="cpu")
    return step, (state,)


@pytest.mark.parametrize("make,args", [
    (_k6, dict(kernel="K6", fuse=1, region="ghost")),
    (_k7, dict(kernel="K7", fuse=1, region="owned")),
    (_k8, dict(kernel="K8", fuse=1, region="owned")),
    (_k12, dict(kernel="K12", fuse=1, region="owned")),
    (_k11, dict(kernel="K11", fuse=1, region="ghost", exchange="fused"))],
    ids=["K6", "K7", "K8", "K12", "K11"])
def test_every_sweep_callable_is_a_span(make, args):
    """One span per call, with the kernel's arguments; K11, both exchange
    and sweep (the first of the weak step's two), is one
    ``bricklib.sweep`` and counts the ghost bytes of its PUT copies."""
    fn, xs = make()
    before = trace.counters()["exchange_bytes"]
    with trace.tracing():
        fn(*xs)
    sweeps = [s for s in trace.records() if s.name == trace.SWEEP
              and s.args["kernel"] == args["kernel"]]
    assert [s.args for s in sweeps] == [args]
    moved = trace.counters()["exchange_bytes"] - before
    assert (moved > 0) == ("exchange" in args)


def test_span_times_ties_device_operations_to_the_innermost_span():
    def x(cat, name, ts, dur, **a):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": a}

    ev = [x("user_annotation", trace.STEP, 0, 100),
          x("user_annotation", trace.EXCHANGE, 5, 10),
          x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
          x("kernel", "copy_pool_kernel", 20, 3, correlation=1),
          x("user_annotation", trace.SWEEP, 30, 10),
          x("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=2),
          x("kernel", "pencil_sweep_kernel", 40, 50, correlation=2),
          x("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=3),
          x("kernel", "k", 95, 2, correlation=3),
          x("cuda_runtime", "cudaMemcpyAsync", 200, 1, correlation=4),
          x("gpu_memcpy", "Memcpy", 201, 4, correlation=4)]
    t = trace.span_times(ev)
    assert t[trace.EXCHANGE] == [1, pytest.approx(0.01),
                                 pytest.approx(0.003)]
    assert t[trace.SWEEP] == [1, pytest.approx(0.01), pytest.approx(0.05)]
    assert t[trace.STEP] == [1, pytest.approx(0.1), pytest.approx(0.002)]
    assert t[""] == [0, 0.0, pytest.approx(0.004)]
