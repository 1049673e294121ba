"""The launch planner of K4's register-streaming body
(``regstream_plan_4d``), on the CPU.

The 4-D star at ``fuse=2`` takes K4's second body
(``csrc/pencil_regstream_4d.cuh``): a plane of every level has level 0's
shape (its k rows in ``nq`` groups, each of ``8 + 2F`` j rows of a compiled
row width), and each thread owns a fixed (group, column) item.  These tests
hold the plan to the sweep's ranges and to the kernel's constants: its
blocks cover every output once, its shared memory is the layout's count
and fits a block, its items fit the threads, the weak 4-D step's sweeps
take it, and every other sweep (the star at fuse 1, 3 and 4 among them)
keeps the ring body.  The kernel runs only
on the card (``tests/test_torch_gpu.py``, ``test_regstream_4d_*``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bricklib_tpu_torch import trace
from bricklib_tpu_torch.bench.k4_regimes import mixed_radius
from bricklib_tpu_torch.codegen import pencil_kernel_4d
from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
    K4_SMEM_BUDGET, REGSTREAM4_FUSE, REGSTREAM4_ROW_WIDTHS, REGSTREAM4_ROWS_J,
    REGSTREAM4_ROWS_K, REGSTREAM4_THREADS, RegStream4Plan, Stream4Plan,
    k4_launch, regstream4_footprint, regstream4_smem, regstream_plan_4d,
    stream_plan_4d)
from bricklib_tpu_torch.stencils import bench_params

from test_torch_pencil_stream_4d import BD, BD_TINY, STEP, TINY, _dec, _sweep

SHAPES = (
    ("tiny-ghost", TINY, BD_TINY, "ghost", {}, (2, 3, 4)),
    ("tiny-owned", TINY, BD_TINY, "skip", {}, (2, 3, 4)),
    ("tiny-periodic", TINY, BD_TINY, "periodic", {}, (2, 3, 4)),
    ("tiny-ghost-batch-3", TINY, BD_TINY, "ghost", {"batch": 3}, (2, 3, 4)),
    ("tiny-owned-batch-3", TINY, BD_TINY, "skip", {"batch": 3}, (2, 3, 4)),
    ("tiny-low-edge", TINY, BD_TINY, "ghost", {"k_range": (0, 1)},
     (2, 3, 4)),
    ("tiny-high-edge", TINY, BD_TINY, "ghost", {"k_range": (3, 4)},
     (2, 3, 4)),
    ("bi-32-ghost", (12, 12, 8, 32), (4, 4, 4, 32), "ghost", {}, (2, 3)),
    ("step-ghost", STEP, BD, "ghost", {}, (2,)),
    ("step-owned", STEP, BD, "skip", {}, (2,)),
    ("step-periodic", STEP, BD, "periodic", {}, (2,)),
    ("ragged-w-and-k", (20, 24, 16, 32), (4, 8, 8, 32), "ghost",
     {"w_range": (1, 6), "k_range": (0, 3)}, (2,)))


def _cases(body: bool) -> dict:
    """The sweeps of SHAPES the register-streaming body takes (``body``:
    fuse 2), or the star's other fused depths there (the ring body's)."""
    return {f"{name}-f{f}": (lambda dims=dims, bd=bd, f=f, kind=kind, kw=kw:
                             _sweep(dims, bd, f, kind, **kw))
            for name, dims, bd, kind, kw, fuses in SHAPES
            for f in fuses if (f in REGSTREAM4_FUSE) == body}


CASES, RING_CASES = _cases(True), _cases(False)


@pytest.fixture(params=sorted(CASES))
def sweep(request):
    return CASES[request.param]()


def test_regstream_4d_blocks_cover_every_output_once(sweep):
    """The blocks, decoded as the kernel decodes them, cover every output
    (batch member, w brick, k brick, pencil, i lane) exactly once."""
    plan = sweep.plan
    rp = regstream_plan_4d(plan)
    assert isinstance(rp, RegStream4Plan)
    (W0, W1), (K0, K1), (J0, J1) = plan.ranges
    BI = plan.bdims[3]
    seen = np.zeros((plan.batch, W1 - W0, K1 - K0, J1 - J0, BI), np.int32)
    blocks = rp.blocks()
    assert len(blocks) == rp.nstream
    for sub, (w0, w1), (k0, k1), (j0, j1), (i0, i1), _edges in blocks:
        assert W0 <= w0 < w1 <= W1 and K0 <= k0 < k1 <= K1
        assert J0 <= j0 < j1 <= J1 and 0 <= i0 < i1 <= BI
        seen[sub, w0 - W0:w1 - W0, k0 - K0:k1 - K0, j0 - J0:j1 - J0,
             i0:i1] += 1
    assert (seen == 1).all()


def test_regstream_4d_footprint_fits_its_compiled_shape(sweep):
    """A block's shared memory is the layout's count and fits the H100's
    227 KB; level 1's k rows (the brick rows and F - 1 radii each side)
    fit its ``nq`` groups, its j rows the compiled ones, its lanes the
    compiled row width, and the columns level 1 needs in every group the
    threads' one item each."""
    plan = sweep.plan
    rp = regstream_plan_4d(plan)
    BW, BK, BJ, BI = plan.bdims
    F = plan.fuse
    assert 0 < rp.smem_bytes <= K4_SMEM_BUDGET == 232448
    assert rp.smem_bytes == regstream4_smem(plan.bdims, F, rp.wch, rp.pk,
                                            rp.pj, rp.rw, rp.nq, rp.d)
    assert rp.rw in REGSTREAM4_ROW_WIDTHS and rp.ti + 2 * rp.h <= rp.rw
    assert BI % rp.ti == 0 and rp.ti % rp.pw == 0 and rp.h % rp.pw == 0
    assert rp.h >= F and rp.d in (1, 2, 3) and rp.skew == 0
    assert rp.pj * BJ <= REGSTREAM4_ROWS_J
    assert rp.nq == -(-(rp.pk * BK + 2 * F - 2) // REGSTREAM4_ROWS_K)
    assert rp.items() == rp.nq * (rp.pj * BJ + 2 * F - 2) * (rp.ti + 2 * F
                                                             - 2)
    assert rp.items() <= REGSTREAM4_THREADS
    assert (rp.wch + 2) * BW + 3 * F < pencil_kernel_4d.PLANE_SPAN


def test_regstream_4d_edge_blocks_are_the_ring_bodys(sweep):
    """The blocks whose intermediate levels clamp at a k edge are the ones
    whose k rows reach outside the table, as in the ring body."""
    plan = sweep.plan
    rp = regstream_plan_4d(plan)
    BK, F = plan.bdims[1], plan.fuse
    GK = plan.table.shape[1]
    for _sub, _w, (k0, k1), _j, _i, edges in rp.blocks():
        assert ("low" in edges) == (k0 * BK - (F - 1) < 0)
        assert ("high" in edges) == (k1 * BK + (F - 1) > GK * BK)


def test_regstream4_smem_counts_the_layout():
    """F = 2, row width 40: a k row of (8 + 4) x 40 = 480 floats, groups of
    5 rows (pad 0: 4 x 480 is 0 modulo 32), 2 groups a plane between a
    leading and a trailing row: 5,760 floats; lookahead 3: 6 level-0
    planes and 2 of level 1; then a brick table of (6 + 2) x 3 x 3, three
    ints for each of 12 x 12 level-0 rows and two buffers of 64 output row
    addresses.  Bricks (4, 4, 4, 16), two k brick rows (10 rows of level 1:
    2 groups), lookahead 1: 4 level-0 planes and 2 of level 1, a brick
    table of 3 x 4 x 3, 12 x 8 level-0 rows, 32 output rows."""
    got = regstream4_smem((4, 8, 8, 512), 2, 6, 1, 1, 40, 2, 3)
    assert got == (4 * 8 * (480 + 2 * 2400 + 480) + 8 * 8 * 3 * 3
                   + 4 * 3 * 144 + 16 * 64)
    got = regstream4_smem((4, 4, 4, 16), 2, 1, 2, 1, 40, 2, 1)
    assert got == (4 * 6 * (480 + 2 * 2400 + 480) + 8 * 3 * 4 * 3
                   + 4 * 3 * 12 * 8 + 16 * 32)
    fn = _sweep(STEP, BD, 2, "ghost")
    assert regstream4_footprint(fn.plan, 6, 1, 1, 32, 40, 3).smem_bytes \
        == regstream4_smem((4, 8, 8, 512), 2, 6, 1, 1, 40, 2, 3)


@pytest.mark.parametrize("kind,wch", [("ghost", 6), ("skip", 4)])
def test_regstream_4d_takes_the_step_sweeps(kind, wch):
    """Both sweeps of the weak 4-D step (16x64x128x512 a rank, fuse 2)
    take the register-streaming body: the whole w range a chunk, one k
    brick row and one pencil a block, i tiles of 32 lanes in row width 40
    (level 1 computes 2 groups of 5 k rows of 10 x 34 columns: 680
    items), lookahead 3, 2,880 and 2,048 blocks."""
    fn = _sweep(STEP, BD, 2, kind)
    rp = regstream_plan_4d(fn.plan)
    assert isinstance(rp, RegStream4Plan)
    assert k4_launch(fn.plan) == rp and rp.body == "regstream"
    assert (rp.wch, rp.pk, rp.pj, rp.ti, rp.rw, rp.nq, rp.d) == (
        wch, 1, 1, 32, 40, 2, 3)
    assert rp.items() == 680
    assert rp.nstream == {"ghost": 2880, "skip": 2048}[kind]


def test_regstream_4d_tiles_are_a_warp_wide_unless_the_card_idles():
    """The planner takes i tiles of a warp's 32 lanes (or the whole brick
    row), narrower ones only where those would leave SMs without a block:
    the weak 4-D step's sweeps run 2,880 and 2,048 blocks of 32 lanes;
    the 4-D ``Problem``'s owned sweep at (8, 16, 16, 64) would run 16
    such blocks, and runs tiles of 4 lanes instead."""
    for kind in ("ghost", "skip"):
        assert regstream_plan_4d(_sweep(STEP, BD, 2, kind).plan).ti == 32
    fn = _sweep((8, 16, 16, 64), (4, 8, 8, 64), 2, "skip")
    wide = regstream4_footprint(fn.plan, 1, 1, 1, 32, 40, 3)
    assert wide.nstream == 16 < pencil_kernel_4d.SM_COUNT
    rp = regstream_plan_4d(fn.plan)
    assert rp.ti < 32 and rp.nstream > wide.nstream


@pytest.fixture(params=sorted(RING_CASES))
def ring_sweep(request):
    return RING_CASES[request.param]()


def test_regstream_4d_leaves_fuse_3_and_4_to_the_ring_body(ring_sweep):
    """The star at fuse 3 and 4, at the shapes where fuse 2 takes the
    register-streaming body, keeps the ring body, whose blocks cover
    every output once."""
    plan = ring_sweep.plan
    assert plan.fuse in (3, 4) and regstream_plan_4d(plan) is None
    sp = stream_plan_4d(plan)
    assert type(sp) is Stream4Plan
    (W0, W1), (K0, K1), (J0, J1) = plan.ranges
    seen = np.zeros((plan.batch, W1 - W0, K1 - K0, J1 - J0,
                     plan.bdims[3]), np.int32)
    for sub, (w0, w1), (k0, k1), (j0, j1), (i0, i1), _edges in sp.blocks():
        seen[sub, w0 - W0:w1 - W0, k0 - K0:k1 - K0, j0 - J0:j1 - J0,
             i0:i1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("name", ["fuse-1", "generic-taps", "fuse-5",
                                  "pencils-16-rows", "step-ghost-f3",
                                  "step-owned-f4"])
def test_regstream_4d_leaves_the_other_sweeps_on_the_ring_body(name):
    """``fuse=1``, a tap list other than the 4-D star, depths the body
    does not compile (the 4-D step's shape at fuse 3 and 4, fuse 5) and
    pencils more than 8 j rows wide keep the ring body and
    ``stream_plan_4d``."""
    fn = {"fuse-1": lambda: _sweep(STEP, BD, 1, "ghost"),
          "step-ghost-f3": lambda: _sweep(STEP, BD, 3, "ghost"),
          "step-owned-f4": lambda: _sweep(STEP, BD, 4, "skip"),
          "generic-taps": lambda: _sweep((4, 8, 8, 16), (2, 4, 4, 16), 2,
                                         "ghost", mixed_radius()),
          "fuse-5": lambda: _sweep((20, 20, 20, 16), (5, 5, 5, 16), 5,
                                   "skip"),
          "pencils-16-rows": lambda: _sweep((8, 16, 32, 64),
                                            (4, 8, 16, 64), 2, "skip")}[
        name]()
    assert regstream_plan_4d(fn.plan) is None
    assert type(stream_plan_4d(fn.plan)) is Stream4Plan
    lp = k4_launch(fn.plan)
    assert lp == stream_plan_4d(fn.plan) and lp.body == "stream"


@pytest.mark.parametrize("fuse", [1, 2])
def test_regstream_4d_describe_names_the_choosers_launch(fuse):
    """``Problem.describe()`` reports the body, i tile and shared memory
    of :func:`k4_launch`'s launch of the 4-D problem's owned sweep."""
    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=(8, 16, 16, 64), stencil="mpi9pt", st_iter=2,
                schedule={"fuse": fuse}, device="cpu")
    info = p.describe()["kernels"][0]
    fn = pencil_kernel_4d.pencil_sweep_4d(
        "mpi9pt", p.dec.periodic_grid((0, 1, 2, 3)), p.bdims, p.dec.nbricks,
        p.params, fuse=fuse)
    lp = k4_launch(fn.plan)
    assert (info["body"], info["tile_i"], info["smem_bytes"]) == (
        lp.body, lp.ti, lp.smem_bytes)
    assert info["body"] == ("regstream" if fuse == 2 else "stream")


def test_regstream_4d_needs_a_compiled_row_width(monkeypatch):
    """No compiled row width holds an i tile and its margins: the ring
    body."""
    fn = _sweep(TINY, BD_TINY, 2, "skip")
    assert regstream_plan_4d(fn.plan) is not None
    monkeypatch.setattr(pencil_kernel_4d, "REGSTREAM4_ROW_WIDTHS", (8,))
    pencil_kernel_4d._regstream_plan_4d.cache_clear()
    try:
        assert regstream_plan_4d(fn.plan) is None
    finally:
        monkeypatch.undo()
        pencil_kernel_4d._regstream_plan_4d.cache_clear()


def test_regstream_4d_needs_the_shared_memory(monkeypatch):
    """No footprint fits the shared memory: the ring body's planner
    decides (and raises where nothing fits it either)."""
    fn = _sweep(TINY, BD_TINY, 2, "skip")
    monkeypatch.setattr(pencil_kernel_4d, "K4_SMEM_BUDGET", 1024)
    assert regstream_plan_4d(fn.plan) is None


@pytest.mark.parametrize("fuse", [1, 2, 3, 4])
def test_regstream_4d_sweep_span_names_the_body(fuse):
    """A 4-D sweep's ``bricklib.sweep`` span names the body the card
    runs."""
    dec = _dec(TINY, BD_TINY)
    fn = pencil_kernel_4d.pencil_sweep_4d("mpi9pt", dec.grid, BD_TINY,
                                          dec.nbricks, bench_params(),
                                          fuse=fuse)
    with trace.tracing():
        trace.records()
        fn(torch.zeros((dec.nbricks,) + BD_TINY))
        (sp,) = [s for s in trace.records() if s.name == trace.SWEEP]
    assert sp.args["kernel"] == "K4" and sp.args["fuse"] == fuse
    assert sp.args["body"] == ("regstream" if fuse == 2 else "stream")


def test_regstream_4d_constants_are_the_kernels():
    """The planner's threads, j rows, k rows a group, fused depth and row
    width are the ones ``csrc/pencil_regstream_4d.cu[h]`` compiles in."""
    csrc = Path(pencil_kernel_4d.__file__).resolve().parents[1] / "csrc"
    head = (csrc / "pencil_regstream_4d.cuh").read_text()
    body = (csrc / "pencil_regstream_4d.cu").read_text()

    def define(text, name):
        return int(re.search(rf"#define {name} (\d+)", text)[1])

    assert define(head, "BT4_RS_THREADS") == REGSTREAM4_THREADS
    assert define(head, "BT4_RS_ROWS") == REGSTREAM4_ROWS_K
    assert define(head, "BT4_RS_WJ") == REGSTREAM4_ROWS_J
    assert REGSTREAM4_FUSE == (define(body, "BT4_RS_F"),)
    assert REGSTREAM4_ROW_WIDTHS == (define(body, "BT4_RS_RW"),)
