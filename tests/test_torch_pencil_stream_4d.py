"""The launch planner of kernel K4 (``stream_plan_4d``), on the CPU.

K4 streams chunks of w bricks through each block
(``csrc/pencil_stream_4d.cuh``), a plane being k rows x j rows x i lanes.
Streaming w, the intermediate levels' k clamp copies rows within the plane
being computed, so only the blocks whose k rows include a table edge apply
it.  The kernel decodes its blocks as :meth:`Stream4Plan.blocks` does;
these tests hold that decoding to the sweep's ranges: every output (batch
member, w brick, k brick, pencil, i lane) is covered exactly once, the
shared memory fits the H100's 227 KB per block, and the edge flags are set
exactly on the blocks where a level reaches outside the table.  They also
hold the tap layout K4 compiles in (``csrc/tap_layouts.cuh``,
``LayoutStar9``) to the corpus stencil it names, and count the loads the
planner expects under it.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``, ``test_sweep_4d_kernel_*``).
"""

import numpy as np
import pytest

from bricklib_tpu_torch.bench.k4_regimes import mixed_radius
from bricklib_tpu_torch.codegen import pencil_kernel, pencil_kernel_4d
from bricklib_tpu_torch.codegen.pencil_kernel import stream_loads
from bricklib_tpu_torch.codegen.pencil_kernel_4d import (K4_LAYOUTS,
                                                         K4_SMEM_BUDGET,
                                                         pencil_sweep_4d,
                                                         stream4_footprint,
                                                         stream4_smem,
                                                         stream_plan_4d)
from bricklib_tpu_torch.codegen.taps import params_from_reference
from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu_torch.stencils import bench_params

from test_torch_pencil_stream import _compiled_layouts


def _dec(dims, bd):
    return BrickDecomp(dims=dims, ghost_depth=bd[:3] + (0,),
                       bdims=bd).initialize(skinlist_by_name("good", 4))


def _sweep(dims, bd, fuse, kind, stencil="mpi9pt", batch=1, **ranges):
    """A K4 sweep: ``kind`` "periodic" (owned bricks, periodic table),
    "ghost" (every brick of the table) or "skip" (owned bricks)."""
    dec = _dec(dims, bd)
    grid = dec.periodic_grid((0, 1, 2, 3)) if kind == "periodic" \
        else dec.grid
    if kind == "ghost":
        G = grid.shape[:3]
        ranges = dict(dict(w_range=(0, G[0]), k_range=(0, G[1]),
                           j_range=(0, G[2])), **ranges)
    extra = (dict(batch=batch, batch_stride=dec.nbricks) if batch > 1
             else {})
    return pencil_sweep_4d(stencil, grid, bd, batch * dec.nbricks,
                           bench_params() if stencil == "mpi9pt" else {},
                           fuse=fuse, **ranges, **extra)


STEP, BD = (16, 64, 128, 512), (4, 8, 8, 512)
TINY, BD_TINY = (8, 8, 8, 16), (4, 4, 4, 16)
# every K4 regime of the weak 4-D step, at its shape
REGIMES = {
    "step-periodic-f1": lambda: _sweep(STEP, BD, 1, "periodic"),
    "step-ghost-f1": lambda: _sweep(STEP, BD, 1, "ghost"),
    "step-ghost-f2": lambda: _sweep(STEP, BD, 2, "ghost"),
    "step-skip-f2": lambda: _sweep(STEP, BD, 2, "skip"),
}
# small and ragged cases
SMALL = {
    "tiny-periodic-f1": lambda: _sweep(TINY, BD_TINY, 1, "periodic"),
    "tiny-ghost-f2": lambda: _sweep(TINY, BD_TINY, 2, "ghost"),
    "tiny-skip-f2-batch-3": lambda: _sweep(TINY, BD_TINY, 2, "skip",
                                           batch=3),
    "tiny-ghost-f2-batch-3": lambda: _sweep(TINY, BD_TINY, 2, "ghost",
                                            batch=3),
    "tiny-ghost-f3": lambda: _sweep(TINY, BD_TINY, 3, "ghost"),
    "tiny-low-edge-only-f2": lambda: _sweep(TINY, BD_TINY, 2, "ghost",
                                            k_range=(0, 1)),
    "tiny-high-edge-only-f3": lambda: _sweep(TINY, BD_TINY, 3, "ghost",
                                             k_range=(3, 4)),
    "mixed-radius-ghost-f2": lambda: _sweep((4, 8, 8, 16), (2, 4, 4, 16),
                                            2, "ghost", mixed_radius()),
    "problem-small-periodic-f2": lambda: _sweep((8, 16, 16, 64),
                                                (4, 8, 8, 64), 2,
                                                "periodic"),
    "ragged-w-and-k": lambda: _sweep((20, 24, 16, 32), (4, 8, 8, 32), 2,
                                     "ghost", w_range=(1, 6),
                                     k_range=(0, 3)),
}
CASES = {**REGIMES, **SMALL}


@pytest.fixture(params=sorted(CASES))
def sweep(request):
    return CASES[request.param]()


def test_blocks_cover_every_output_once(sweep):
    plan = sweep.plan
    sp = stream_plan_4d(plan)
    (W0, W1), (K0, K1), (J0, J1) = plan.ranges
    BI = plan.bdims[3]
    seen = np.zeros((plan.batch, W1 - W0, K1 - K0, J1 - J0, BI), np.int32)
    blocks = sp.blocks()
    assert len(blocks) == sp.nstream
    for sub, (w0, w1), (k0, k1), (j0, j1), (i0, i1), _edges in blocks:
        assert W0 <= w0 < w1 <= W1 and K0 <= k0 < k1 <= K1
        assert J0 <= j0 < j1 <= J1 and 0 <= i0 < i1 <= BI
        seen[sub, w0 - W0:w1 - W0, k0 - K0:k1 - K0, j0 - J0:j1 - J0,
             i0:i1] += 1
    assert (seen == 1).all()


def test_shared_memory_fits_and_tiles_divide(sweep):
    plan = sweep.plan
    sp = stream_plan_4d(plan)
    assert 0 < sp.smem_bytes <= K4_SMEM_BUDGET == 227 * 1024
    assert plan.bdims[3] % sp.ti == 0 and sp.ti % sp.pw == 0
    assert sp.h % sp.pw == 0 and sp.h >= plan.fuse * max(plan.lo[3],
                                                         plan.hi[3])
    assert sp.smem_bytes == stream4_smem(
        plan.bdims, plan.fuse, plan.lo, plan.hi, sp.wch, sp.pk, sp.pj,
        sp.ti, sp.h, sp.d, sp.skew)
    assert sp.skew & ~((1 << plan.fuse) - 2) == 0 and sp.d in (1, 2)
    # a chunk's planes stay below the kernel's division-free span
    rw = plan.lo[0] + plan.hi[0]
    assert ((sp.wch + 2) * plan.bdims[0] + plan.fuse * (rw + 1)
            < pencil_kernel.PLANE_SPAN)


def test_edge_blocks_are_where_a_level_leaves_the_table(sweep):
    """A block applies the intermediate levels' k clamp at an edge exactly
    where its level 1 (the widest intermediate level) reaches a k row
    outside [0, GK*BK)."""
    plan = sweep.plan
    sp = stream_plan_4d(plan)
    BK, F = plan.bdims[1], plan.fuse
    GK = plan.table.shape[1]
    klo, khi = plan.lo[1], plan.hi[1]
    for _sub, _w, (k0, k1), _j, _i, edges in sp.blocks():
        assert ("low" in edges) == (k0 * BK - (F - 1) * klo < 0)
        assert ("high" in edges) == (k1 * BK + (F - 1) * khi > GK * BK)


@pytest.mark.parametrize("name", sorted(REGIMES))
def test_main_path_regimes_fill_the_card(name):
    """At the 4-D step's shape every regime gives each of the 132 SMs at
    least a few blocks."""
    sp = stream_plan_4d(REGIMES[name]().plan)
    assert sp.nstream >= 4 * pencil_kernel.SM_COUNT


def test_stream4_smem_counts_the_layout():
    """The 4-D star at F = 2, one w chunk of 6 bricks, one k brick row and
    one pencil of bricks (4, 8, 8, 512), i tile 32, margin 4, lookahead 2,
    level 1 and 2 skewed: level-0 ring 5 planes of (8 + 4) x (8 + 4) rows
    of 40, level 1 4 planes of (8 + 2) x (8 + 2) rows of 40, 4 floats
    before and 4 + 40 after; then a brick table of 8 x 3 x 3, 144 rows of
    two ints and two buffers of 64 output row offsets.  Bricks 2 deep in
    k: two level-0 k rows (12 j rows of 40) more after the rings."""
    one, r = (1, 1, 1, 1), 40
    got = stream4_smem((4, 8, 8, 512), 2, one, one, 6, 1, 1, 32, 4, 2, 2)
    assert got == (4 * (4 + 5 * 144 * r + 4 * 100 * r + 44) + 8 * 72
                   + 8 * 144 + 16 * 64)
    got = stream4_smem((4, 2, 8, 512), 2, one, one, 6, 1, 1, 32, 4, 2, 0)
    assert got == (4 * (4 + 5 * 6 * 12 * r + 3 * 4 * 10 * r + 44
                        + 2 * 12 * r) + 8 * 72 + 8 * 72 + 16 * 16)


def test_footprint_counts_its_own_layout(sweep):
    """A launch at another footprint takes the shared memory of that
    footprint, whatever skewed boundaries it keeps."""
    plan = sweep.plan
    sp = stream_plan_4d(plan)
    for wch, pk, pj, ti in ((1, 1, 1, sp.ti), (sp.wch + 1, 2, 2, sp.pw)):
        for skew in {0, sp.skew}:
            v = stream4_footprint(plan, wch, pk, pj, ti, sp.d, skew)
            assert v.smem_bytes == stream4_smem(
                plan.bdims, plan.fuse, plan.lo, plan.hi, wch, pk, pj, ti,
                sp.h, sp.d, skew)
            assert (v.wch, v.pk, v.pj, v.ti, v.skew) == (wch, pk, pj, ti,
                                                         skew)


def test_compiled_layout_is_the_corpus_star():
    """K4's compiled tap layout holds exactly the offsets (dw, dk, dj, di),
    in tap order, of the corpus stencil the planner names (so the entry
    point picks it for the tap list the planner counts reuse for)."""
    got = _compiled_layouts("dw dk dj di")
    assert sorted(got) == ["LayoutStar9"] and K4_LAYOUTS == ("mpi9pt",)
    want = params_from_reference(bench_params(), "mpi9pt").offsets
    assert np.array_equal(got["LayoutStar9"], want)


@pytest.mark.parametrize("stencil,loads", [("mpi9pt", 7.5), (None, 4.0)])
def test_loads_per_output_under_the_layout(stencil, loads):
    """Four k rows of a column: the star's 9 taps read 30 distinct values
    (its centre and k taps share six rows); a tap list without a compiled
    layout loads once per tap and row."""
    sd = mixed_radius() if stencil is None else stencil
    fn = _sweep((4, 8, 8, 16), (2, 4, 4, 16), 1, "skip", sd)
    assert stream_loads(fn.plan.taps.offsets, K4_LAYOUTS) == loads


def test_planner_raises_when_nothing_fits(monkeypatch):
    monkeypatch.setattr(pencil_kernel_4d, "K4_SMEM_BUDGET", 1024)
    fn = _sweep(TINY, BD_TINY, 2, "skip")
    with pytest.raises(ValueError, match="no K4 w-streaming block"):
        stream_plan_4d(fn.plan)
