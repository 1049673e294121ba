"""The launch planner of kernel K6 (``Plan2D.stream``), on the CPU.

K6 streams chunks of brick rows in y through each block
(``csrc/row_stream.cuh``): a block owns an x tile and a chunk of brick
rows and walks them in groups of 8 rows as a wavefront over the fused
levels.  The kernel decodes its blocks as :meth:`RowStreamPlan.blocks`
does; these tests hold that decoding to the sweep's ranges (every output
brick row x column covered exactly once), the shared memory to the H100's
227 KB per block and to the layout ``row_stream.cuh`` counts, the tiles
to the width (dividing it, or whole warps with the last tile cut) and the
margins to the fused levels' reach, K6's compiled groups (``LayoutBox9``)
to what ``fold_linear_forms`` gives for the 2-D box, and the loads per
output to the counts in PERF.md.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from bricklib_tpu_torch import st
from bricklib_tpu_torch.codegen import pencil_kernel_2d
from bricklib_tpu_torch.codegen.ir import StencilIR
from bricklib_tpu_torch.codegen.pencil_kernel_2d import (K6_ROWS,
                                                         K6_SMEM_BUDGET,
                                                         ROW_LAYOUT_BOX9,
                                                         ROW_WIDTHS,
                                                         fold_linear_forms,
                                                         pencil_sweep_2d,
                                                         row_footprint,
                                                         row_smem)
from bricklib_tpu_torch.core import init_grid

from torch_2d_stencils import BUILDERS, PARAMS, box9


def _table(gy, periodic):
    grid, info = init_grid((gy, 1))
    t = np.asarray(grid)[:, 0].copy()
    if periodic:
        t[0], t[-1] = t[-2], t[1]
    return t, info.nbricks


def _sweep(name, fuse, by, X, gy, periodic=True, y_range=None):
    t, nb = _table(gy, periodic)
    return pencil_sweep_2d(BUILDERS[name](st), t, (by, X), nb, PARAMS,
                           y_range=y_range, fuse=fuse)


# the 2-D path's sweeps at 16384^2, and small and ragged ones
REGIMES = {
    "box9-16384-f4": lambda: _sweep("box9", 4, 32, 16384, 514),
    "box9-16384-f1": lambda: _sweep("box9", 1, 32, 16384, 514),
    "wave-16384-f1": lambda: _sweep("wave", 1, 32, 16384, 514),
}
SMALL = {
    "box9-f4": lambda: _sweep("box9", 4, 32, 256, 6),
    "lin5-f2-ghost": lambda: _sweep("lin5", 2, 8, 64, 6, False, (0, 6)),
    "asym9-f2-ghost": lambda: _sweep("asym9", 2, 4, 48, 6, False, (0, 6)),
    "asym9-f1": lambda: _sweep("asym9", 1, 8, 16, 6, False),
    "asym9-f4-by8": lambda: _sweep("asym9", 4, 8, 48, 9, False, (1, 8)),
    "wave-ghost": lambda: _sweep("wave", 1, 8, 128, 6, False, (0, 6)),
    "box9-f3-tall-table": lambda: _sweep("box9", 3, 4, 96, 40),
}
CASES = {**REGIMES, **SMALL}


@pytest.fixture(params=sorted(CASES))
def sweep(request):
    return CASES[request.param]()


def test_blocks_cover_every_output_once(sweep):
    plan = sweep.plan
    sp = plan.stream()
    Y0, Y1 = plan.y_range
    X = plan.bdims[1]
    seen = np.zeros((Y1 - Y0, X), np.int32)
    blocks = sp.blocks()
    assert len(blocks) == sp.nstream
    for (r0, r1), (x0, x1) in blocks:
        assert Y0 <= r0 < r1 <= Y1 and 0 <= x0 < x1 <= X
        seen[r0 - Y0:r1 - Y0, x0:x1] += 1
    assert (seen == 1).all()


def test_shared_memory_fits_and_tiles_divide(sweep):
    plan = sweep.plan
    sp = plan.stream()
    F = plan.fuse
    assert 0 < sp.smem_bytes <= K6_SMEM_BUDGET == 227 * 1024
    assert sp.smem_bytes == row_smem(plan.bdims, F, plan.lo, plan.hi,
                                     len(plan.fields), sp.ych, sp.tx, sp.h,
                                     sp.d, plan.rad(), sp.g)
    # an x tile divides the width, or its rows are whole warps of 32
    # columns (the last tile then ends past X)
    X = plan.bdims[1]
    assert X % sp.tx == 0 or (sp.tx + 2 * sp.h) % 32 == 0
    assert sp.tx % sp.pw == 0 and X % sp.pw == 0
    # level F's columns read level F-1's within the margin: F reaches
    assert sp.h % sp.pw == 0 and sp.h >= F * max(plan.lo[1], plan.hi[1])
    # a group's reads reach at most one group further
    ry = plan.lo[0] + plan.hi[0]
    assert sp.g % K6_ROWS == 0 and sp.g >= ry and sp.d in (1, 2, 3)
    assert ((sp.ych + 2) * plan.bdims[0] + F * ry + sp.g
            < pencil_kernel_2d.PLANE_SPAN)


@pytest.mark.parametrize("name", sorted(REGIMES))
def test_main_path_regimes_fill_the_card(name):
    sp = REGIMES[name]().plan.stream()
    assert sp.nstream >= pencil_kernel_2d.SM_COUNT


def test_footprint_counts_its_own_layout():
    plan = REGIMES["box9-16384-f4"]().plan
    for ych, tx, d, g in ((8, 128, 2, 8), (64, 512, 1, 8), (1, 1024, 1, 16)):
        v = row_footprint(plan, ych, tx, d, g)
        assert (v.ych, v.tx, v.d, v.g, v.h) == (ych, tx, d, g, 4)
        assert v.smem_bytes == row_smem(plan.bdims, 4, (1, 1), (1, 1), 1,
                                        ych, tx, 4, d, 1, g)


def test_tap_groups_are_the_folded_box():
    """K6's groups (one per (field, dx), a coefficient per dy) hold exactly
    the box's folded taps, ``fold_linear_forms``'s pairs."""
    sd = box9(st)
    folded = fold_linear_forms(StencilIR.from_def(sd), list(sd.inputs), {})
    plan = REGIMES["box9-16384-f4"]().plan
    assert plan.taps == (folded,)
    gbeg, gfield, gdx, coef = plan.groups()
    rad = plan.rad()
    coef = coef.reshape(-1, 2 * rad + 1)
    assert list(gbeg) == [0, 3] and sorted(gdx) == [-1, 0, 1]
    got = {(int(gfield[g]), d - rad, int(gdx[g])): float(coef[g, d])
           for g in range(3) for d in range(2 * rad + 1) if coef[g, d]}
    assert got == pytest.approx(dict(folded))


def test_compiled_groups_are_the_folded_box():
    """K6's compiled groups (``LayoutBox9`` in ``row_stream.cuh``) and the
    planner's description of them (:data:`ROW_LAYOUT_BOX9`) are the 2-D
    box's groups under ``fold_linear_forms``, so the entry point takes
    that body for the 2-D path; the row widths compiled in are the ones
    the planner counts."""
    header = (Path(pencil_kernel_2d.__file__).resolve().parents[1] / "csrc"
              / "row_stream.cuh").read_text()
    body = header[header.index("struct LayoutBox9 {"):]
    body = body[:body.index("\n};")]
    nums = dict(re.findall(r"(NG|RAD) = (\d+)", body))
    dx = [int(v) for v in re.findall(
        r"-?\d+", body[body.index("v[NG] = "):].split(";")[0])]
    assert (int(nums["RAD"]), tuple(dx)) == (ROW_LAYOUT_BOX9["rad"],
                                            ROW_LAYOUT_BOX9["dx"])
    assert len(dx) == int(nums["NG"])
    src = (Path(pencil_kernel_2d.__file__).resolve().parents[1] / "csrc"
           / "pencil_sweep_2d.cu").read_text()
    assert tuple(int(w) for w in re.findall(r"rw == (\d+)", src)) \
        == ROW_WIDTHS
    sd = box9(st)
    folded = fold_linear_forms(StencilIR.from_def(sd), list(sd.inputs), {})
    firsts = []
    for (_f, _dy, dxx), _c in folded:
        if dxx not in firsts:
            firsts.append(dxx)
    assert tuple(firsts) == ROW_LAYOUT_BOX9["dx"]
    assert REGIMES["box9-16384-f4"]().plan.layout()
    assert not REGIMES["wave-16384-f1"]().plan.layout()
    assert not SMALL["asym9-f1"]().plan.layout()


@pytest.mark.parametrize("name,fuse,shared", [
    ("box9-16384-f4", 4, 3.75), ("box9-16384-f1", 1, 3.75),
    ("wave-16384-f1", 1, 5.0)])
@pytest.mark.parametrize("fp", [(16, 128, 1, 8), (8, 256, 2, 16),
                                (32, 120, 1, 8)])
def test_loads_per_output(name, fuse, shared, fp):
    """Level 0 is loaded once per chunk with its margins: groups of g rows
    over tx + 2h columns and the chunk's F*(ylo + yhi) extra rows, every
    field; the intermediate levels compute whole 32-column warps over
    their groups, level F its tx columns in warps; x tiles that do not
    divide X compute a whole last tile (PERF.md).  Each evaluation loads
    8 + 2 rows of a column per (field, dx) group for 8 outputs."""
    plan = REGIMES[name]().plan
    ych, tx, d, g = fp
    sp = row_footprint(plan, ych, tx, d, g)
    got = plan.loads(sp)
    L, ry, X = ych * 32, 2, 16384
    nchunk, nxt = -(-512 // ych), -(-X // tx)
    rows = [-(-(L + (fuse - lv) * ry) // g) * g for lv in range(fuse + 1)]
    cols = (nxt * tx) / X
    rw = tx + 8
    assert got["level0"] == pytest.approx(
        len(plan.fields) * rows[0] / L * rw / tx * cols * 512
        / (nchunk * ych))
    want = (sum(rows[lv] * -(-rw // 32) * 32 for lv in range(1, fuse))
            + rows[fuse] * -(-tx // 32) * 32) / (L * tx) * cols * 512 \
        / (nchunk * ych)
    assert got["levels"] == pytest.approx(want)
    assert got["shared"] == shared


def test_planner_raises_when_nothing_fits():
    plan = REGIMES["box9-16384-f4"]().plan
    gbeg, _gf, _gdx, coef = plan.groups()
    with pytest.raises(ValueError, match="no K6 y-streaming block"):
        pencil_kernel_2d._row_stream_plan.__wrapped__(
            plan.bdims, plan.y_range, 4, plan.lo, plan.hi, 1, 1,
            int(gbeg[-1]), int(np.count_nonzero(coef)), 1, True, budget=1024)
