"""The launch planner of kernel K12 (``stream_plan_nd``, ``nd_slices``,
``nd_info``), on the CPU.

K12 streams chunks of k brick rows through each block
(``csrc/pencil_stream_nd.cuh``): a block owns one outer brick cell (every
outer position of it), a chunk of brick rows, pencils and an i tile; a
level-0 plane holds one slice per (input field, outer position) that the
cell's taps reach, in ring A (read at a k offset other than 0) or ring B.
The kernel decodes its blocks as :meth:`StreamNdPlan.blocks` does; these
tests hold that decoding to the sweep's ranges (every output brick covered
exactly once), the shared memory to the H100's 227 KB per block, the
slices to the taps' reach, the tap offsets to the slices' layout, and the
5-D star's compiled layout (``csrc/tap_layouts.cuh``, ``LayoutStar11``)
to the star the port's tests and ``chip_smoke.py`` run.  The kernel
itself runs only on the card (``tests/test_torch_gpu.py``,
``test_sweep_nd_kernel_*``).
"""

import re
from itertools import product
from pathlib import Path

import numpy as np
import pytest

from bricklib_tpu_torch import st
from bricklib_tpu_torch.codegen import pencil_kernel_nd as nd
from bricklib_tpu_torch.codegen.pencil_kernel_nd import (K12_SMEM_BUDGET,
                                                         K12_STAR11,
                                                         nd_info, nd_slices,
                                                         pencil_sweep_nd,
                                                         stream_nd_footprint,
                                                         stream_nd_smem,
                                                         stream_plan_nd)
from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name

from torch_nd_stencils import star_nd


def _sweep(dims, bd, ranges=None, **kw):
    n = len(dims)
    dec = BrickDecomp(dims=dims, ghost_depth=bd[:-1] + (0,),
                      bdims=bd).initialize(skinlist_by_name("good", n))
    if ranges == "all":
        ranges = tuple((0, g) for g in dec.grid.shape[:-1])
    return pencil_sweep_nd(star_nd(st, n, **kw), dec.grid, bd, dec.nbricks,
                           {}, ranges=ranges)


PATH, BD = (8, 8, 64, 64, 512), (2, 2, 8, 8, 512)
CASES = {
    "path-5d-star": lambda: _sweep(PATH, BD),
    "path-5d-star-all-bricks": lambda: _sweep(PATH, BD, "all"),
    "5d-two-input-corners": lambda: _sweep((4, 4, 16, 16, 256),
                                           (2, 2, 8, 8, 256), two=True,
                                           corner=True),
    "6d-star": lambda: _sweep((4, 4, 4, 8, 8, 128), (2, 2, 2, 4, 4, 128)),
    "5d-tiny": lambda: _sweep((4, 4, 8, 8, 16), (2, 2, 4, 4, 16)),
    "5d-ranges": lambda: _sweep((4, 4, 8, 8, 16), (2, 2, 4, 4, 16),
                                ((0, 3), (1, 4), (0, 4), (2, 3))),
    "6d-corners": lambda: _sweep((4, 2, 4, 4, 8, 16), (2, 1, 2, 2, 4, 16),
                                 corner=True),
    "5d-radius-2": lambda: _sweep((4, 4, 8, 8, 32), (2, 2, 4, 4, 32),
                                  radius=2),
    "7d-star": lambda: _sweep((2, 2, 2, 2, 4, 4, 16),
                              (1, 1, 1, 1, 2, 2, 16)),
}
# footprints other than the planner's, for the cases that take them
FOOTPRINTS = [(1, 1, 4, 2), (2, 2, 8, 1), (3, 1, 16, 2), (1, 3, 16, 1)]


@pytest.fixture(params=sorted(CASES))
def sweep(request):
    return CASES[request.param]()


def _covered(plan, sp):
    """Per output brick (outer cell, k, j), the i lanes the blocks
    cover, as a count per lane."""
    cover = {}
    for cell, (k0, k1), (j0, j1), (i0, i1) in sp.blocks():
        for k in range(k0, k1):
            for j in range(j0, j1):
                lanes = cover.setdefault(cell + (k, j),
                                         np.zeros(plan.bdims[-1], int))
                lanes[i0:i1] += 1
    return cover


def test_blocks_cover_every_output_once(sweep):
    plan = sweep.plan
    sp = stream_plan_nd(plan)
    cover = _covered(plan, sp)
    want = set(product(*(range(a, b) for a, b in plan.ranges)))
    assert set(cover) == want
    assert all((c == 1).all() for c in cover.values())
    assert len(sp.blocks()) == sp.nstream


@pytest.mark.parametrize("fp", FOOTPRINTS)
def test_footprints_cover_every_output_once(fp):
    plan = CASES["5d-ranges"]().plan
    sp = stream_nd_footprint(plan, *fp)
    cover = _covered(plan, sp)
    assert set(cover) == set(product(*(range(a, b)
                                        for a, b in plan.ranges)))
    assert all((c == 1).all() for c in cover.values())


def test_shared_memory_fits_and_tiles_divide(sweep):
    plan = sweep.plan
    sp = stream_plan_nd(plan)
    BI = plan.bdims[-1]
    assert 0 < sp.smem_bytes <= K12_SMEM_BUDGET == 227 * 1024
    assert BI % sp.ti == 0 and sp.ti % sp.pw == 0 and sp.h % sp.pw == 0
    assert sp.h >= max(plan.lo[-1], plan.hi[-1])
    assert sp.pw == (4 if BI % 4 == 0 else 1) and sp.d in (1, 2)
    assert 1 <= sp.pj <= nd.K12_MAX_PENCILS


def test_slices_are_the_taps_reach(sweep):
    """Each slice is a (field, outer position) some output of the cell
    reads, and every one it reads is a slice; its j reach is the taps'
    farthest dj into it; it is in ring A exactly when a tap reads it at a
    k offset other than 0, and ring A comes first."""
    plan = sweep.plan
    m = len(plan.bdims) - 3
    sl = nd_slices(plan)
    offs = plan.taps.offsets.tolist()
    fields = (plan.taps.inputs.tolist() if plan.taps.inputs is not None
              else [0] * len(offs))
    assert sl.positions == tuple(product(*(range(b)
                                           for b in plan.bdims[:m])))
    want = {}
    for x in sl.positions:
        for o, f in zip(offs, fields):
            key = (f, tuple(x[a] + o[a] for a in range(m)))
            lo, hi, k = want.get(key, (0, 0, False))
            want[key] = (max(lo, -o[m + 1]), max(hi, o[m + 1]),
                         k or o[m] != 0)
    got = {(f, pos): (lo, hi, ring == 0)
           for f, pos, lo, hi, ring in sl.slices}
    assert got == want
    rings = [s[4] for s in sl.slices]
    assert rings == sorted(rings)
    for p, x in enumerate(sl.positions):
        for t, (o, f) in enumerate(zip(offs, fields)):
            s = sl.slices[sl.slice_of[p][t]]
            assert (s[0], s[1]) == (f, tuple(x[a] + o[a] for a in range(m)))


def test_star_faces_are_ring_b():
    """The path's 5-D star at bricks (2, 2, ...): the cell's 4 positions
    in ring A with one j row of reach each side, the 8 face positions
    (two a side of two outer axes) in ring B with none."""
    sl = nd_slices(CASES["5d-tiny"]().plan)
    a = [s for s in sl.slices if s[4] == 0]
    b = [s for s in sl.slices if s[4] == 1]
    assert sorted(s[1] for s in a) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(s[2:4] == (1, 1) for s in a)
    assert sorted(s[1] for s in b) == [(-1, 0), (-1, 1), (0, -1), (0, 2),
                                       (1, -1), (1, 2), (2, 0), (2, 1)]
    assert all(s[2:4] == (0, 0) for s in b)


def test_tap_offsets_follow_the_slice_layout(sweep):
    """nd_info: each (position, tap) offset is its slice's base in its
    ring's plane, plus (j reach below + dj) rows of ti + 2h floats, plus
    di; its ring is its slice's; the level-0 rows list each slice's rows
    in order; the header's counts agree."""
    plan = sweep.plan
    sp = stream_plan_nd(plan)
    info, hdr = nd_info(plan, sp)
    sl = nd_slices(plan)
    m = len(plan.bdims) - 3
    rw, wjm = sp.ti + 2 * sp.h, sp.pj * plan.bdims[m + 1]
    npos, nt, ns = len(sl.positions), len(plan.taps.coeffs), len(sl.slices)
    rows = info[hdr["o_rows"]:hdr["o_pofs"]].reshape(-1, 2)
    assert len(rows) == hdr["NRA"] + hdr["NRB"]
    assert hdr["PSA"] == hdr["NRA"] * rw and hdr["PSB"] == hdr["NRB"] * rw
    base, ring_rows = {}, [0, 0]
    for s, (_f, _pos, lo, hi, ring) in enumerate(sl.slices):
        base[s] = ring_rows[ring] * rw
        first = ring_rows[ring] + (hdr["NRA"] if ring else 0)
        want = [(s, j) for j in range(-lo, wjm + hi)]
        assert rows[first:first + len(want)].tolist() == [list(r)
                                                          for r in want]
        ring_rows[ring] += len(want)
    assert ring_rows == [hdr["NRA"], hdr["NRB"]]
    toff = info[hdr["o_toff"]:hdr["o_tring"]].reshape(npos, nt)
    tring = info[hdr["o_tring"]:hdr["o_taps"]].reshape(npos, nt)
    offs = plan.taps.offsets
    for p in range(npos):
        for t in range(nt):
            s = sl.slice_of[p][t]
            assert toff[p, t] == (base[s] + (sl.slices[s][2]
                                             + offs[t][m + 1]) * rw
                                  + offs[t][m + 2])
            assert tring[p, t] == sl.slices[s][4]
    taps = info[hdr["o_taps"]:].reshape(nt, 2)
    assert taps[:, 0].tolist() == offs[:, m].tolist()
    assert np.array_equal(taps[:, 1].view(np.float32), plan.taps.coeffs)
    slices = info[hdr["o_slice"]:hdr["o_rows"]].reshape(ns, 2 + m)
    estride = [int(np.prod(plan.bdims[a + 1:])) for a in range(m)]
    for s, (f, pos, *_r) in enumerate(sl.slices):
        step = [p // b for p, b in zip(pos, plan.bdims[:m])]
        assert slices[s, 0] == f and slices[s, 2:].tolist() == step
        assert slices[s, 1] == sum((p - c * b) * e for p, c, b, e in
                                   zip(pos, step, plan.bdims[:m], estride))
    pofs = info[hdr["o_pofs"]:hdr["o_toff"]]
    assert pofs.tolist() == [sum(x * e for x, e in zip(pos, estride))
                             for pos in sl.positions]
    assert (hdr["klo"], hdr["khi"], hdr["jlo"]) == (plan.lo[m], plan.hi[m],
                                                    plan.lo[m + 1])


def test_stream_nd_smem_counts_the_layout():
    """By hand, the path's 5-D star at the planner's footprint: 4 slices
    in ring A of pj * 8 + 2 rows, 8 in ring B of pj * 8, rows of ti + 8
    floats; ring A keeps 3 + d planes, ring B 1 + d."""
    plan = CASES["path-5d-star"]().plan
    sp = stream_plan_nd(plan)
    rw = sp.ti + 2 * sp.h
    nra, nrb = 4 * (8 * sp.pj + 2), 8 * 8 * sp.pj
    n = (sp.h + (3 + sp.d) * nra * rw + (1 + sp.d) * nrb * rw + sp.h + 40
         + 4 * rw + 1) & ~1
    items = 4 * -(-8 * sp.pj // 4) * -(-sp.ti // 32)
    want = (4 * n + 8 * (sp.kch + 2) * 12 * (sp.pj + 2) + 8 * sp.kch * sp.pj
            + 16 * 8 * sp.pj + 8 * (nra + nrb) + 4 * 4 * 11 + 8 * 11 + 4 * 4
            + 4 * items)
    assert sp.smem_bytes == want == stream_nd_smem(
        nd_slices(plan), plan.bdims, plan.lo, plan.hi, sp.kch, sp.pj, sp.ti,
        sp.h, sp.d, 11)


def test_path_plan():
    """The path's 5-D star runs the compiled layout, one outer cell of 16
    per block and the cells fastest, enough blocks to fill 132 SMs."""
    plan = CASES["path-5d-star"]().plan
    sp = stream_plan_nd(plan)
    assert sp.layout and sp.ncell == 16
    assert sp.nstream >= 132
    first = sp.blocks()[:sp.ncell]
    assert len({b[0] for b in first}) == sp.ncell
    assert len({b[1:] for b in first}) == 1


@pytest.mark.parametrize("case,layout", [
    ("5d-tiny", True), ("5d-ranges", True), ("5d-two-input-corners", False),
    ("6d-star", False), ("5d-radius-2", False)])
def test_layout_only_for_the_5d_star(case, layout):
    assert stream_plan_nd(CASES[case]().plan).layout is layout


def test_compiled_layout_is_the_corpus_star():
    """LayoutStar11's offsets, parsed from ``csrc/tap_layouts.cuh``, are
    K12_STAR11 and the taps of the 5-D star the port's tests and
    ``chip_smoke.py`` build (numpy axis order, tap order)."""
    text = (Path(nd.__file__).resolve().parents[1] / "csrc"
            / "tap_layouts.cuh").read_text()
    body = re.search(r"struct LayoutStar11 \{(.*?)\n\};", text, re.S).group(1)
    table = re.search(r"constexpr int v\[N\]\[5\] = \{(.*?)\};", body,
                      re.S).group(1)
    got = [tuple(int(v) for v in row.split(","))
           for row in re.findall(r"\{([^{}]*)\}", table)]
    assert tuple(got) == K12_STAR11
    plan = CASES["5d-tiny"]().plan
    assert tuple(map(tuple, plan.taps.offsets.tolist())) == K12_STAR11


def test_planner_raises_when_nothing_fits(monkeypatch):
    monkeypatch.setattr(nd, "K12_SMEM_BUDGET", 1024)
    plan = CASES["5d-ranges"]().plan
    with pytest.raises(ValueError, match="no K12 k-streaming block"):
        stream_plan_nd(plan)
