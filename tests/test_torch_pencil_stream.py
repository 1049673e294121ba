"""The launch planner of kernel K1 (``SweepPlan.stream``), on the CPU.

K1 streams chunks of brick rows in k through each block
(``csrc/pencil_stream.cuh``).  Where a chunk's levels reach past the
table's k edges, an intermediate level's clamp reads a plane that a
k-increasing stream does not hold; the blocks of those edge chunks keep
the clamp's source planes in a stash in device memory (a pre-roll over the
first brick row computes the low edge's first).  The kernel decodes its
blocks as :meth:`StreamPlan.blocks` does; these tests hold that decoding
to the sweep's ranges: every output brick row x pencil x i lane of every
subdomain is covered exactly once, the shared memory fits the H100's 227
KB per block, the edge flags are set exactly on the chunks where a level
reaches outside the table, and each edge's stash is sized for its clamp
sources.  They also hold the tap layouts K1 compiles in
(``csrc/tap_layouts.cuh``) to the corpus stencils they name, and count the
loads the planner expects under them.

The star at ``fuse`` 2 to 4 takes K1's register-streaming body
(``csrc/pencil_regstream.cuh``, planned by ``SweepPlan.regstream``): the
same block decoding, its own footprint (compiled row widths, two items a
thread) and a stash of every thread's items.  The ``regstream`` tests hold
its planner to the same coverage, shared memory and edge rules, and its
dispatch to the star at those depths: every other sweep, K11's included,
keeps ``SweepPlan.stream``.  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``, ``test_stream_sweep_kernel_*`` and
``test_regstream_*``).
"""

import numpy as np
import pytest
import torch

from bricklib_tpu_torch.codegen import pencil_kernel
from bricklib_tpu_torch import trace
from bricklib_tpu_torch.codegen.pencil_kernel import (REGSTREAM_FUSE,
                                                      REGSTREAM_ITEMS,
                                                      REGSTREAM_ROW_WIDTHS,
                                                      REGSTREAM_THREADS,
                                                      STREAM_LAYOUTS,
                                                      STREAM_ROWS,
                                                      STREAM_SMEM_BUDGET,
                                                      RegStreamPlan,
                                                      StreamPlan,
                                                      _stream_footprint,
                                                      k1_launch,
                                                      pencil_sweep,
                                                      quad_stores,
                                                      regstream_smem,
                                                      regstream_stash_floats,
                                                      stash_floats,
                                                      stream_loads,
                                                      stream_smem)
from bricklib_tpu_torch.codegen.taps import params_from_reference
from bricklib_tpu_torch.comm import (BrickDecomp, StrongDecomp,
                                     skinlist_by_name)
from bricklib_tpu_torch.stencils import bench_params


def _dec(dims, bd, periodic=False):
    dec = BrickDecomp(dims=dims, ghost_depth=(bd[0], bd[1], 0),
                      bdims=bd).initialize(skinlist_by_name("good", 3))
    return dec, (dec.periodic_grid((0, 1, 2)) if periodic else dec.grid)


def _weak(stencil, fuse, ghost, periodic=False, n=512, bi=None):
    dec, grid = _dec((n, n, n), (8, 8, bi or n), periodic)
    GK, GJ = grid.shape[:2]
    s = 0 if ghost else 1
    return pencil_sweep(stencil, grid, dec.bdims, dec.nbricks,
                        bench_params(), k_range=(s, GK - s),
                        j_range=(s, GJ - s), fuse=fuse)


def _strong(ghost, dom=(512, 512, 512), sdom=(128, 128, 512),
            bd=(8, 8, 512)):
    plan = StrongDecomp(dom=dom, sdom=sdom, mesh_shape=(1, 1, 1), bdims=bd,
                        ghost_depth=(bd[0], bd[1], 0)).initialize(
        skinlist_by_name("good", 3))
    kg = plan.sdec.periodic_grid((2,))
    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    GK, GJ = kg.shape[:2]
    s = 0 if ghost else 1
    return pencil_sweep("s7pt", kg, bd, nsub * nb, bench_params(),
                        k_range=(s, GK - s), j_range=(s, GJ - s),
                        batch=nsub, batch_stride=nb, fuse=4)


def _ragged(kr, stencil="mpi13pt", fuse=2, bd=(4, 4, 32)):
    dec, grid = _dec((44, 20, bd[2]), bd)
    return pencil_sweep(stencil, grid, bd, dec.nbricks, bench_params(),
                        k_range=kr, j_range=(0, grid.shape[1]), fuse=fuse)


# every K1 regime of the main paths, at its shape
REGIMES = {
    "weak-ghost-f4": lambda: _weak("s7pt", 4, True),
    "weak-owned-f4": lambda: _weak("s7pt", 4, False),
    "periodic-s7pt-f4": lambda: _weak("s7pt", 4, False, True),
    "periodic-s7pt-f1": lambda: _weak("s7pt", 1, False, True),
    "strong-x16-ghost-f4": lambda: _strong(True),
    "strong-x16-owned-f4": lambda: _strong(False),
    "periodic-mpi125pt-f1": lambda: _weak("mpi125pt", 1, False, True),
    "periodic-mpi125pt-f2": lambda: _weak("mpi125pt", 2, False, True),
}
# ragged and small cases
RAGGED = {
    "k-extent-not-a-chunk-multiple": lambda: _ragged((1, 12)),
    "k-extent-one-row-low-edge": lambda: _ragged((0, 1)),
    "k-extent-one-row-high-edge": lambda: _ragged((12, 13)),
    "batch-16-ghost": lambda: _strong(True, (64, 64, 32), (16, 16, 32),
                                      (4, 4, 32)),
    "bi-32-ghost-f4": lambda: _weak("s7pt", 4, True, n=32, bi=32),
    "bi-32-owned-f4": lambda: _weak("s7pt", 4, False, n=32, bi=32),
    "distributed-weak-rank": lambda: _weak("mpi7pt", 4, True, n=32,
                                           bi=32),
}
CASES = {**REGIMES, **RAGGED}


@pytest.fixture(params=sorted(CASES))
def sweep(request):
    return CASES[request.param]()


def test_blocks_cover_every_output_once(sweep):
    plan = sweep.plan
    sp = plan.stream()
    (K0, K1), (J0, J1) = plan.ranges
    BI = plan.bdims[2]
    seen = np.zeros((plan.batch, K1 - K0, J1 - J0, BI), np.int32)
    blocks = sp.blocks()
    assert len(blocks) == sp.nstream
    for sub, (k0, k1), (j0, j1), (i0, i1), _edges in blocks:
        assert K0 <= k0 < k1 <= K1 and J0 <= j0 < j1 <= J1
        assert 0 <= i0 < i1 <= BI
        seen[sub, k0 - K0:k1 - K0, j0 - J0:j1 - J0, i0:i1] += 1
    assert (seen == 1).all()


def test_shared_memory_fits_and_tiles_divide(sweep):
    plan = sweep.plan
    sp = plan.stream()
    assert 0 < sp.smem_bytes <= STREAM_SMEM_BUDGET == 227 * 1024
    assert plan.bdims[2] % sp.ti == 0 and sp.ti % sp.pw == 0
    assert sp.h % sp.pw == 0 and sp.h >= plan.fuse * max(plan.lo[2],
                                                         plan.hi[2])
    assert sp.smem_bytes == stream_smem(
        plan.bdims, plan.fuse, plan.lo, plan.hi, sp.kch, sp.pj, sp.ti,
        sp.h, sp.d, sp.skew)
    assert sp.skew & ~((1 << plan.fuse) - 2) == 0


def test_edge_chunks_are_where_a_level_leaves_the_table(sweep):
    """A chunk is marked at a k edge exactly where one of its levels
    reaches a plane outside [0, GK*BK), and only there does a block keep a
    stash, sized for that edge's clamp sources."""
    plan = sweep.plan
    sp = plan.stream()
    BK, F = plan.bdims[0], plan.fuse
    GK = plan.table.shape[0]
    klo, khi = plan.lo[0], plan.hi[0]
    for _sub, (k0, k1), _j, _i, edges in sp.blocks():
        assert ("low" in edges) == (k0 * BK - F * klo < 0)
        assert ("high" in edges) == (k1 * BK + F * khi > GK * BK)
    lo, hi = stash_floats(plan.bdims, F, plan.lo, plan.hi, sp.pj, sp.ti,
                          sp.h)
    assert sp.stash_lo == (lo if sp.edge_lo else 0)
    assert sp.stash_hi == (hi if sp.edge_hi else 0)
    assert (sp.stash_lo > 0) == (sp.edge_lo and F > 1)
    assert (sp.stash_hi > 0) == (sp.edge_hi and F > 1)


@pytest.mark.parametrize("name", sorted(REGIMES))
def test_main_path_regimes_fill_the_card(name):
    """At the main paths' shapes the stream blocks alone give nearly every
    one of the 132 SMs a block."""
    sp = REGIMES[name]().plan.stream()
    assert sp.nstream >= 0.9 * pencil_kernel.SM_COUNT


def test_stream_smem_counts_the_layout():
    """s7pt at F = 2, one pencil of 4, i tile 32, margin 4, lookahead 2:
    level-0 ring 5 planes of (4 + 4) x 40, level 1 3 planes of (4 + 2) x
    40, 4 floats before and 4 + 40 after (a tap's reach and 32 lanes),
    then a brick table of (2 + 2) x (1 + 2), 8 rows of two ints and two
    buffers of 4 output row offsets; the stash per edge, level 1's one
    source plane.  Bricks 2 deep in j: two rows of 40 more after the
    rings (a quad of four rows over a block of two)."""
    got = stream_smem((4, 4, 32), 2, (1, 1, 1), (1, 1, 1), 2, 1, 32, 4, 2)
    assert got == (4 * (4 + 5 * 8 * 40 + 3 * 6 * 40 + 44) + 8 * 4 * 3
                   + 8 * 8 + 16 * 4)
    got = stream_smem((4, 2, 32), 2, (1, 1, 1), (1, 1, 1), 2, 1, 32, 4, 2)
    assert got == (4 * (4 + 5 * 6 * 40 + 3 * 4 * 40 + 44 + 80) + 8 * 4 * 3
                   + 8 * 6 + 16 * 2)
    assert stash_floats((4, 4, 32), 2, (1, 1, 1), (1, 1, 1), 1, 32,
                        4) == (6 * 40, 6 * 40)


def test_footprint_counts_its_own_layout(sweep):
    """A launch at another footprint takes the shared memory and stash of
    that footprint, whatever skewed boundaries it keeps."""
    plan = sweep.plan
    sp = plan.stream()
    for kch, pj, ti in ((1, 1, sp.ti), (sp.kch + 1, 2, plan.bdims[2])):
        for skew in {0, sp.skew}:
            v = _stream_footprint(plan, kch, pj, ti, sp.d, skew)
            assert v.smem_bytes == stream_smem(
                plan.bdims, plan.fuse, plan.lo, plan.hi, kch, pj, ti, sp.h,
                sp.d, skew)
            lo, hi = stash_floats(plan.bdims, plan.fuse, plan.lo, plan.hi,
                                  pj, ti, sp.h)
            assert (v.stash_lo, v.stash_hi) == (lo * sp.edge_lo,
                                                hi * sp.edge_hi)


def test_planner_takes_tall_bricks_and_tables():
    """The kernel counts a plane from its chunk's first brick row, so the
    planner takes bricks deeper than 64 that are not powers of two and
    tables of more than 2^20 planes in k, with chunks of fewer than 2^20
    planes."""
    for bdims, table_k in (((96, 4, 32), 5), ((8, 4, 32), (1 << 17) + 2)):
        sp = pencil_kernel._stream_plan.__wrapped__(
            bdims, ((0, table_k), (0, 4)), table_k, 4, (1, 1, 1),
            (1, 1, 1), 1, 7, 5.5)
        assert sp.smem_bytes <= STREAM_SMEM_BUDGET
        assert sp.edge_lo and sp.edge_hi and sp.nchunk >= 1
        assert (sp.kch + 2) * bdims[0] + 4 * 3 < 1 << 20


def _compiled_layouts(axes: str = "dk dj di") -> dict:
    """The layouts of ``csrc/tap_layouts.cuh`` with exactly the offset
    arrays ``axes`` (K1's: ``dk dj di``; K4's: ``dw dk dj di``), parsed:
    name -> offsets per tap."""
    import re
    from pathlib import Path

    text = (Path(pencil_kernel.__file__).resolve().parents[1] / "csrc"
            / "tap_layouts.cuh").read_text()
    out = {}
    for name, body in re.findall(r"struct (Layout\w+) \{(.*?)\n\};", text,
                                 re.S):
        arrs = {a: [int(v) for v in vals.replace("\n", " ").split(",")]
                for a, vals in re.findall(
                    r"int (dw|dk|dj|di)\(int t\) \{\s*constexpr int "
                    r"v\[N\] = \{([^}]*)\}", body)}
        if sorted(arrs) == sorted(axes.split()):
            out[name] = np.stack([arrs[a] for a in axes.split()], 1)
    return out


def test_compiled_layouts_are_the_corpus_stencils():
    """K1's compiled tap layouts hold exactly the offsets, in tap order, of
    the corpus stencils the planner names (so the kernel's entry point
    picks a layout for the tap lists the planner counts reuse for)."""
    got = _compiled_layouts()
    assert sorted(got) == ["LayoutCube125", "LayoutStar7"]
    for cls, name in zip(("LayoutStar7", "LayoutCube125"), STREAM_LAYOUTS):
        want = params_from_reference(bench_params(), name).offsets
        assert np.array_equal(got[cls], want)


@pytest.mark.parametrize("name,loads", [("s7pt", 5.5), ("mpi7pt", 5.5),
                                        ("mpi125pt", 50.0),
                                        ("mpi13pt", 13.0), ("s27pt", 27.0)])
def test_loads_per_output_under_the_layouts(name, loads):
    """Four rows of a column: the star's 7 taps read 22 distinct values
    (its centre column's three j taps share six rows), the cube's 125 read
    200 (each (dk, di) column's five j taps share eight rows); a tap list
    without a compiled layout loads once per tap and row."""
    assert STREAM_ROWS == 4
    offs = params_from_reference(bench_params(), name).offsets
    assert stream_loads(offs) == loads


def test_planner_refuses_a_k_clamp_on_one_brick_row():
    """The low edge's pre-roll needs a second brick row in the table."""
    fn = pencil_sweep("s7pt", np.arange(4).reshape(1, 4), (4, 4, 32), 4,
                      bench_params(), k_range=(0, 1), j_range=(0, 4),
                      fuse=2)
    with pytest.raises(ValueError, match="two brick rows"):
        fn.plan.stream()


def test_planner_raises_when_nothing_fits():
    fn = _weak("mpi125pt", 2, False, True, n=32, bi=32)
    with pytest.raises(ValueError, match="shared memory"):
        pencil_kernel._stream_plan.__wrapped__(
            (8, 8, 32), fn.plan.ranges, fn.plan.table.shape[0], 2,
            fn.plan.lo, fn.plan.hi, 1, 125, budget=1024)


# the sweeps K1's register-streaming body takes: the main paths' star at
# fuse 4 and the small cases, and the star at fuse 2 and 3
RS_CASES = {name: CASES[name] for name in (
    "weak-ghost-f4", "weak-owned-f4", "periodic-s7pt-f4",
    "strong-x16-ghost-f4", "strong-x16-owned-f4", "batch-16-ghost",
    "bi-32-ghost-f4", "bi-32-owned-f4", "distributed-weak-rank")}
RS_CASES.update({
    f"{kind}-f{f}": (lambda kind=kind, f=f: _weak(
        "s7pt", f, kind == "ghost", periodic=kind == "periodic"))
    for f in (2, 3) for kind in ("ghost", "owned", "periodic")})
RS_CASES.update({
    "two-brick-rows-f4": lambda: pencil_sweep(
        "s7pt", _dec((8, 16, 32), (4, 4, 32))[1], (4, 4, 32),
        _dec((8, 16, 32), (4, 4, 32))[0].nbricks, bench_params(),
        k_range=(0, 2), j_range=(0, 6), fuse=4),
    "ragged-k-low-edge-f3": lambda: _ragged((0, 7), "s7pt", 3),
    "bi-20-pieces-of-one-f2": lambda: pencil_sweep(
        "s7pt", _dec((16, 16, 20), (4, 4, 20))[1], (4, 4, 20),
        _dec((16, 16, 20), (4, 4, 20))[0].nbricks, bench_params(),
        k_range=(0, 6), j_range=(0, 6), fuse=2),
})


@pytest.fixture(params=sorted(RS_CASES))
def rs_sweep(request):
    return RS_CASES[request.param]()


def test_regstream_blocks_cover_every_output_once(rs_sweep):
    """The register-streaming launch's blocks, decoded as the kernel
    decodes them, cover every output brick row x pencil x i lane of every
    subdomain exactly once."""
    plan = rs_sweep.plan
    rp = plan.regstream()
    assert isinstance(rp, RegStreamPlan)
    (K0, K1), (J0, J1) = plan.ranges
    BI = plan.bdims[2]
    seen = np.zeros((plan.batch, K1 - K0, J1 - J0, BI), np.int32)
    blocks = rp.blocks()
    assert len(blocks) == rp.nstream
    for sub, (k0, k1), (j0, j1), (i0, i1), _edges in blocks:
        assert K0 <= k0 < k1 <= K1 and J0 <= j0 < j1 <= J1
        seen[sub, k0 - K0:k1 - K0, j0 - J0:j1 - J0, i0:i1] += 1
    assert (seen == 1).all()


def test_regstream_footprint_fits_its_compiled_shape(rs_sweep):
    """A block's shared memory fits the H100's 227 KB (one block an SM:
    its registers leave no room for a second) and is the layout's count;
    a plane's rows (the pencils and F radii each side, in quads) fit its
    ``nq`` quads, its columns (the i tile and its margins) the compiled
    row width, and its items the threads' two each."""
    plan = rs_sweep.plan
    rp = plan.regstream()
    BJ, BI = plan.bdims[1:]
    F = plan.fuse
    assert 0 < rp.smem_bytes <= STREAM_SMEM_BUDGET == 232448
    assert rp.smem_bytes == regstream_smem(plan.bdims, F, rp.kch, rp.pj,
                                           rp.rw, rp.nq, rp.d)
    assert rp.rw in REGSTREAM_ROW_WIDTHS and rp.ti + 2 * rp.h <= rp.rw
    assert BI % rp.ti == 0 and rp.ti % rp.pw == 0 and rp.h % rp.pw == 0
    assert rp.h >= F and rp.d in (1, 2) and rp.skew == 0
    assert rp.nq == -(-(rp.pj * BJ + 2 * F) // STREAM_ROWS)
    assert rp.nq * rp.rw <= REGSTREAM_THREADS * REGSTREAM_ITEMS


def test_regstream_edge_chunks_and_stash(rs_sweep):
    """Edge chunks are where a level leaves the table, as in the ring
    body; each edge's stash holds every thread's items at level f's F - f
    source planes."""
    plan = rs_sweep.plan
    rp = plan.regstream()
    BK, F = plan.bdims[0], plan.fuse
    GK = plan.table.shape[0]
    for _sub, (k0, k1), _j, _i, edges in rp.blocks():
        assert ("low" in edges) == (k0 * BK - F < 0)
        assert ("high" in edges) == (k1 * BK + F > GK * BK)
    per = sum(F - f for f in range(1, F)) * REGSTREAM_THREADS * \
        REGSTREAM_ITEMS * STREAM_ROWS
    assert regstream_stash_floats(F) == per
    assert rp.stash_lo == per * rp.edge_lo
    assert rp.stash_hi == per * rp.edge_hi
    assert rp.stash_total() == (plan.batch * rp.njg * rp.nit
                                * (rp.stash_lo + rp.stash_hi))


@pytest.mark.parametrize("name", sorted(RS_CASES))
def test_regstream_dispatch_takes_the_star_at_fuse_2_to_4(name):
    """Star taps at fuse 2 to 4 take the register-streaming body, which
    :func:`k1_launch` chooses."""
    fn = RS_CASES[name]()
    assert fn.plan.fuse in REGSTREAM_FUSE == (2, 3, 4)
    assert isinstance(fn.plan.regstream(), RegStreamPlan)
    lp = k1_launch(fn.plan)
    assert lp == fn.plan.regstream() and lp.body == "regstream"


@pytest.mark.parametrize("name", ["periodic-s7pt-f1", "periodic-mpi125pt-f1",
                                  "periodic-mpi125pt-f2",
                                  "k-extent-not-a-chunk-multiple",
                                  "k-extent-one-row-low-edge"])
def test_regstream_dispatch_leaves_the_other_sweeps_on_the_ring_body(name):
    """``fuse=1``, the cube and the generic taps (mpi13pt) keep the ring
    body and ``SweepPlan.stream``, which :func:`k1_launch` chooses."""
    fn = CASES[name]()
    assert fn.plan.regstream() is None
    assert type(fn.plan.stream()) is StreamPlan
    lp = k1_launch(fn.plan)
    assert lp == fn.plan.stream() and lp.body == "stream"


@pytest.mark.parametrize("fuse", [1, 2, 3, 4, 5])
def test_regstream_dispatch_launches_the_choosers_body(fuse, monkeypatch):
    """``pencil_sweep_kernel`` launches :func:`k1_launch`'s body at its
    shared memory: the register-streaming body at fuse 2 to 4, the ring
    body at fuse 1 and 5.  The library is a stand-in here, so the
    wrapper's dispatch runs on the CPU."""
    from types import SimpleNamespace

    from bricklib_tpu_torch import _build

    calls = []
    lib = SimpleNamespace(
        bt_pencil_sweep=lambda *a: calls.append(("stream", a[-3])) or 0,
        bt_pencil_sweep_regstream=lambda *a: calls.append(
            ("regstream", a[-2])) or 0)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(pencil_kernel, "_check_k1_args", lambda *a: None)
    monkeypatch.setattr(pencil_kernel, "_stash", lambda *a: None)
    dec, grid = _dec((40, 40, 32), (8, 8, 32))
    fn = pencil_sweep("s7pt", grid, dec.bdims, dec.nbricks, bench_params(),
                      fuse=fuse)
    pencil_kernel.pencil_sweep_kernel(
        torch.zeros((dec.nbricks,) + dec.bdims),
        torch.from_numpy(fn.plan.table), fn.plan)
    lp = k1_launch(fn.plan)
    assert calls == [(lp.body, lp.smem_bytes)]
    assert lp.body == ("regstream" if fuse in REGSTREAM_FUSE else "stream")


@pytest.mark.parametrize("fuse", [1, 2, 4])
def test_regstream_dispatch_describe_names_the_choosers_launch(fuse):
    """``Problem.describe()`` reports the body, i tile and shared memory
    of :func:`k1_launch`'s launch of the problem's owned sweep."""
    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=(32, 32, 64), stencil="s7pt", st_iter=4,
                schedule={"fuse": fuse}, device="cpu")
    info = p.describe()["kernels"][0]
    fn = pencil_sweep("s7pt", p.dec.periodic_grid((0, 1, 2)), p.bdims,
                      p.dec.nbricks, p.params, fuse=fuse)
    lp = k1_launch(fn.plan)
    assert (info["body"], info["tile_i"], info["smem_bytes"]) == (
        lp.body, lp.ti, lp.smem_bytes)
    assert info["body"] == ("stream" if fuse == 1 else "regstream")


@pytest.mark.parametrize("fuse", [1, 2, 3, 4])
def test_regstream_sweep_span_names_the_body(fuse):
    """A sweep's ``bricklib.sweep`` span names the body the card runs."""
    dec, grid = _dec((32, 32, 32), (8, 8, 32))
    fn = pencil_sweep("s7pt", grid, dec.bdims, dec.nbricks, bench_params(),
                      fuse=fuse)
    with trace.tracing():
        trace.records()
        fn(torch.zeros((dec.nbricks,) + tuple(dec.bdims)))
        (sp,) = [s for s in trace.records() if s.name == trace.SWEEP]
    assert sp.args["kernel"] == "K1" and sp.args["fuse"] == fuse
    assert sp.args["body"] == ("stream" if fuse == 1 else "regstream")


def test_regstream_dispatch_leaves_k11_on_the_ring_body():
    """K11's sweep blocks are K1's own ring plan at fuse 1, per card."""
    from bricklib_tpu_torch.codegen import fused_exchange as fx
    from bricklib_tpu_torch.comm import exchange as port_ex
    from bricklib_tpu_torch.comm.mesh import Mesh

    bd = (4, 4, 32)
    dec = BrickDecomp(dims=(24, 16, 32), ghost_depth=(4, 4, 0),
                      bdims=bd).initialize(skinlist_by_name("good", 3))
    plan = port_ex.put_plan(dec, (2, 2, 1), (2,))
    fn = fx.pencil_sweep_fusedx(
        "s7pt", dec.periodic_grid((2,)), bd, dec.nbricks, plan, (2, 2, 1),
        bench_params(), mesh=Mesh((2, 2, 1), ("z", "y", "x"), ["cpu"] * 4))
    assert fn.plan.fuse == 1 and fn.plan.regstream() is None
    assert fn.cards and all(type(cp.stream) is StreamPlan
                            for cp in fn.cards)


@pytest.mark.parametrize("fuse", [2, 3, 4])
def test_regstream_dispatch_refuses_other_taps_and_depths(fuse):
    """mpi7pt (the star's offsets, other coefficients) takes the body;
    the box, the 13-point star and the cube do not, nor fuse 5."""
    for stencil, want in (("mpi7pt", True), ("s27pt", False)):
        fn = _weak(stencil, fuse, False, n=32, bi=32)
        assert (fn.plan.regstream() is not None) == want, stencil
    assert _ragged((1, 12), "mpi13pt", 2).plan.regstream() is None
    assert _weak("mpi125pt", 2, False, True, n=32, bi=32).plan.regstream() \
        is None
    dec, grid = _dec((40, 40, 32), (8, 8, 32))
    fn = pencil_sweep("s7pt", grid, dec.bdims, dec.nbricks, bench_params(),
                      fuse=5)
    assert fn.plan.regstream() is None


def test_regstream_smem_counts_the_layout():
    """F = 2, one pencil of 4 rows, row width 40 (pad 8: a quad's stride
    168 is 40 modulo 32), 2 quads, lookahead 2: the row above quad 0 (48
    floats), 5 level-0 planes and 2 of level 1, each 2 x 168 floats, 40
    after, then a brick table of (2 + 2) x (1 + 2), 8 rows of two ints and
    two buffers of 4 output row offsets."""
    got = regstream_smem((4, 4, 32), 2, 2, 1, 40, 2, 2)
    assert got == (4 * (48 + 7 * 2 * 168 + 40) + 8 * 4 * 3 + 8 * 8
                   + 16 * 4)
    # row width 72: pad 8, a quad 296 floats (72 modulo 32)
    got = regstream_smem((8, 8, 512), 4, 22, 6, 72, 14, 2)
    assert got == (4 * (80 + 11 * 14 * 296 + 72) + 8 * 24 * 8 + 8 * 56
                   + 16 * 48)
    # i-bricked, bricks (4, 4, 4), i tile 8 and margin 4 (a level-0 row
    # spans 5 brick columns, an output row 3): the brick table per brick
    # column, (1 + 2) x (1 + 2) x 5 entries, the rows' ints, and the two
    # buffers of output row offsets per row and brick column, 4 x 3 each
    assert regstream_smem((4, 4, 4), 2, 1, 1, 40, 2, 2, (5, 3)) == (
        4 * (48 + 7 * 2 * 168 + 40) + 8 * 3 * 3 * 5 + 8 * 8 + 16 * 4 * 3)
    # the strong cell's ghost-inclusive sweep (bricks 8^3, chunks of 18
    # brick rows, 5 pencils, i tile 72 in row width 80, pad 16: 11 brick
    # columns a level-0 row, 10 an output row)
    assert regstream_smem((8, 8, 8), 4, 18, 5, 80, 12, 2, (11, 10)) == (
        4 * (96 + 11 * 12 * 336 + 80) + 8 * 20 * 7 * 11 + 8 * 48
        + 16 * 40 * 10) == 197216


def test_regstream_constants_are_the_kernels():
    """The planner's threads, items a thread and row widths are the ones
    ``csrc/pencil_regstream.cu[h]`` compiles in."""
    import re
    from pathlib import Path

    csrc = Path(pencil_kernel.__file__).resolve().parents[1] / "csrc"
    head = (csrc / "pencil_regstream.cuh").read_text()
    body = (csrc / "pencil_regstream.cu").read_text()
    assert int(re.search(r"#define BT_RS_THREADS (\d+)", head)[1]) == \
        REGSTREAM_THREADS
    assert int(re.search(r"#define BT_RS_ITEMS (\d+)", head)[1]) == \
        REGSTREAM_ITEMS
    widths = re.search(r"rs_row_width\(int RW\) \{\s*return ([^;]*);",
                       body)[1]
    assert tuple(int(w) for w in re.findall(r"RW == (\d+)", widths)) == \
        REGSTREAM_ROW_WIDTHS
    for rw in REGSTREAM_ROW_WIDTHS:
        assert f"launch_rw<{rw}>" in body


def test_regstream_planner_fills_the_card_at_the_main_paths():
    """A step's cost hardly grows with its items (a fixed part and one per
    level dominate: the planner's fitted costs), so it takes the widest pencil
    groups the threads' items allow at whole waves: the weak 512^3 sweeps
    at fuse 4 in two waves of 132 blocks (chunks of 22 brick rows, six
    pencils, i tiles of 64 lanes), the strong stack's in three."""
    for name in ("weak-ghost-f4", "weak-owned-f4", "periodic-s7pt-f4"):
        rp = REGIMES[name]().plan.regstream()
        assert rp.nstream == 2 * pencil_kernel.SM_COUNT, name
        assert (rp.kch, rp.pj, rp.ti, rp.rw) == (22, 6, 64, 72)
    for name in ("strong-x16-ghost-f4", "strong-x16-owned-f4"):
        rp = REGIMES[name]().plan.regstream()
        assert rp.nstream == 384 and (rp.pj, rp.ti, rp.rw) == (6, 64, 72)
    # the cubic strong stack (64 subdomains of 128^3 in 8^3 bricks, i
    # bricked): ghost-inclusive in 4 waves of 512 blocks, owned in 3 of
    # 384; every output quad of both stores from one row offset
    plan = StrongDecomp(dom=(512,) * 3, sdom=(128,) * 3,
                        mesh_shape=(1, 1, 1), bdims=(8, 8, 8),
                        ghost_depth=(8, 8, 8)).initialize(
        skinlist_by_name("good", 3))
    grid, nb = plan.sdec.grid, plan.sdec.nbricks
    GK, GJ, GI = grid.shape
    for kw, want in (
            (dict(k_range=(0, GK), j_range=(0, GJ), i_range=(0, GI)),
             (18, 5, 72, 80, 512, 197216)),
            ({}, (16, 6, 64, 72, 384, 201824))):
        fn = pencil_sweep("s7pt", grid, (8, 8, 8), 64 * nb, bench_params(),
                          i_ghost=1, batch=64, batch_stride=nb, fuse=4, **kw)
        rp = fn.plan.regstream()
        assert (rp.kch, rp.pj, rp.ti, rp.rw, rp.nstream,
                rp.smem_bytes) == want
        assert quad_stores(fn.plan)


@pytest.mark.parametrize("fuse", [2, 3, 4])
@pytest.mark.parametrize("bj", [4, 8, 6])
def test_quad_stores_where_no_quad_straddles_a_pencil(fuse, bj):
    """The register body stores a thread's quad of output rows from one
    row offset wherever the quads, from ``F`` rows above the block's
    first, fall whole in one pencil: on an i-bricked table with ``F`` and
    ``BJ`` multiples of 4, so at ``fuse=4`` on bricks 4 or 8 deep in j.
    Each item's rows checked as the kernel checks them; the pencil layout
    keeps an offset a row."""
    plan = StrongDecomp(dom=(48,) * 3, sdom=(24,) * 3,
                        mesh_shape=(1, 1, 1), bdims=(bj, bj, 4),
                        ghost_depth=(bj, bj, 4)).initialize(
        skinlist_by_name("good", 3))
    grid, nb = plan.sdec.grid, plan.sdec.nbricks
    fn = pencil_sweep("s7pt", grid, (bj, bj, 4), nb, bench_params(),
                      i_ghost=1, fuse=fuse)
    rp = fn.plan.regstream()
    assert rp is not None
    for _sub, _k, (j0, j1), _i, _e in rp.blocks():
        wj = (j1 - j0) * bj
        rows = [4 * q - fuse for q in range(-(-(wj + 2 * fuse) // 4))]
        out = [r for r in rows if r + 4 > 0 and r < wj]
        one = all(r >= 0 and r + 4 <= wj and r // bj == (r + 3) // bj
                  for r in out)
        assert one == quad_stores(fn.plan) == (fuse == 4 and bj % 4 == 0)
    assert not quad_stores(REGIMES["weak-ghost-f4"]().plan)
