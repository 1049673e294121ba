"""The launch planner of kernel K8 (``MxuPlan.stream``), on the CPU.

K8 streams chunks of brick rows in k through each block
(``csrc/mxu_stream.cuh``): a block owns a chunk, a group of pencils and an
i tile of ``nwc`` lane chunks, one warp per (strip of 8 j rows, lane
chunk).  The kernel decodes its blocks as :meth:`MxuStreamPlan.blocks`
does; these tests hold that decoding to the sweep's ranges (every output
brick row x pencil x i lane covered exactly once), the shared memory to
the H100's 227 KB per block and to the layout ``mxu_stream.cuh`` counts,
the tiles to the lane chunks, the compiled folded form (``LayoutMxu125``)
to what ``ir.fold_linear`` gives for ``mpi125pt``, and the loads per
output to the counts in PERF.md.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from bricklib_tpu_torch.codegen import mxu_kernel
from bricklib_tpu_torch.codegen.ir import fold_linear
from bricklib_tpu_torch.codegen.evaluate import resolve_const_from_params
from bricklib_tpu_torch.codegen.mxu_kernel import (K8_MAX_THREADS,
                                                   K8_SMEM_BUDGET, K8_STRIP,
                                                   MXU_LAYOUT_125,
                                                   mxu_footprint, mxu_smem,
                                                   pencil_sweep_mxu)
from bricklib_tpu_torch.codegen.taps import as_ir
from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu_torch.core import init_grid
from bricklib_tpu_torch.stencils import bench_params

HEADER = (Path(mxu_kernel.__file__).resolve().parents[1] / "csrc"
          / "mxu_stream.cuh")


def _big(stencil, kind):
    dec = BrickDecomp(dims=(512,) * 3, ghost_depth=(8, 8, 0),
                      bdims=(8, 8, 512)).initialize(
        skinlist_by_name("good", 3))
    if kind == "periodic":
        return pencil_sweep_mxu(stencil, dec.periodic_grid((0, 1, 2)),
                                dec.bdims, dec.nbricks, bench_params())
    GK, GJ = dec.grid.shape[:2]
    return pencil_sweep_mxu(stencil, dec.grid, dec.bdims, dec.nbricks,
                            bench_params(), k_range=(0, GK),
                            j_range=(0, GJ))


def _small(stencil, bd, ghost):
    grid, info = init_grid((5, 4, 1))
    kw = dict(k_range=(0, 5), j_range=(0, 4)) if ghost else {}
    return pencil_sweep_mxu(stencil, np.asarray(grid), bd, info.nbricks,
                            bench_params(), **kw)


# the 125-point leg's sweeps at 512^3, and chip_smoke.py's small ones
REGIMES = {
    "mpi125pt-periodic": lambda: _big("mpi125pt", "periodic"),
    "mpi125pt-ghost": lambda: _big("mpi125pt", "ghost"),
    "mpi25pt-periodic": lambda: _big("mpi25pt", "periodic"),
}
SMALL = {f"{n}-{bd}-{'ghost' if g else 'skip'}":
         (lambda n=n, bd=bd, g=g: _small(n, bd, g))
         for n, bd in (("s7pt", (2, 2, 8)), ("mpi125pt", (4, 4, 8)),
                       ("mpi25pt", (4, 8, 8)), ("mpi125pt", (8, 8, 256)),
                       ("s27pt", (5, 3, 24)), ("mpi13pt", (4, 4, 8)))
         for g in (False, True)}
CASES = {**REGIMES, **SMALL}


@pytest.fixture(params=sorted(CASES))
def sweep(request):
    return CASES[request.param]()


def test_blocks_cover_every_output_once(sweep):
    plan = sweep.plan
    sp = plan.stream()
    (K0, K1), (J0, J1) = plan.ranges
    BI = plan.bdims[2]
    seen = np.zeros((K1 - K0, J1 - J0, BI), np.int32)
    blocks = sp.blocks()
    assert len(blocks) == sp.nstream
    for (k0, k1), (j0, j1), (i0, i1) in blocks:
        assert K0 <= k0 < k1 <= K1 and J0 <= j0 < j1 <= J1
        assert 0 <= i0 < i1 <= BI and i1 - i0 <= sp.ti
        seen[k0 - K0:k1 - K0, j0 - J0:j1 - J0, i0:i1] += 1
    assert (seen == 1).all()


def test_shared_memory_fits_and_tiles_divide(sweep):
    plan = sweep.plan
    sp = plan.stream()
    lo, hi = (plan.klo, plan.jlo, plan.ilo), (plan.khi, plan.jhi, plan.ihi)
    assert 0 < sp.smem_bytes <= K8_SMEM_BUDGET == 227 * 1024
    assert sp.smem_bytes == mxu_smem(plan.bdims, lo, hi, sp.kch, sp.pj,
                                     sp.ti, sp.h, sp.d,
                                     0 if sp.layout else len(plan.wdefs))
    # a warp's 32 lanes hold its ow output lanes and the i reach
    assert sp.ow == 32 - plan.ilo - plan.ihi and sp.ti == sp.nwc * sp.ow
    assert sp.ti % sp.pw == 0 and plan.bdims[2] % sp.pw == 0
    assert sp.h % sp.pw == 0 and sp.h >= max(plan.ilo, plan.ihi)
    nstrip = -(-sp.pj * plan.bdims[1] // K8_STRIP)
    assert sp.threads == 32 * nstrip * sp.nwc <= K8_MAX_THREADS
    assert sp.d in (1, 2)
    assert (sp.kch + 2) * plan.bdims[0] + plan.klo + plan.khi + 1 \
        < mxu_kernel.PLANE_SPAN


@pytest.mark.parametrize("name", sorted(REGIMES))
def test_main_path_regimes_fill_the_card(name):
    sp = REGIMES[name]().plan.stream()
    assert sp.nstream >= mxu_kernel.SM_COUNT


def test_footprint_counts_its_own_layout():
    plan = _big("mpi125pt", "periodic").plan
    for kch, pj, nwc, d in ((4, 4, 1, 2), (16, 1, 5, 1), (8, 3, 2, 2)):
        v = mxu_footprint(plan, kch, pj, nwc, d)
        assert (v.kch, v.pj, v.nwc, v.d, v.ti) == (kch, pj, nwc, d, 28 * nwc)
        assert v.smem_bytes == mxu_smem(plan.bdims, (2, 2, 2), (2, 2, 2),
                                        kch, pj, 28 * nwc, 4, d, 0)


def _header_layout() -> dict:
    """LayoutMxu125 as mxu_stream.cuh spells it."""
    text = HEADER.read_text()
    body = text[text.index("struct LayoutMxu125 {"):]
    body = body[:body.index("\n};")]
    nums = {k: int(v) for k, v in re.findall(r"(\w+) = (-?\d+)", body)}
    tw = [int(v) for v in re.findall(
        r"-?\d+", body[body.index("v[NT][NQ] = "):].split(";")[0])]
    dtup = [int(v) for v in re.findall(
        r"-?\d+", body[body.index("v[NDI] = "):].split(";")[0])]
    nt, nq = nums["NT"], nums["NQ"]
    # tdj(t, q) = q - 2 and di(d) = d - 2 in the header
    assert "return q - 2;" in body and "return d - 2;" in body
    return {"nw": nums["NW"], "rk": nums["RK"],
            "jreach": (nums["JLO"], nums["JHI"]),
            "di": tuple(d - 2 for d in range(nums["NDI"])),
            "dtup": tuple(dtup),
            "tuples": tuple(tuple((q - 2, tw[t * nq + q]) for q in range(nq))
                            for t in range(nt))}


def test_compiled_layout_is_the_folded_cube():
    """K8's compiled folded form (``LayoutMxu125``) and the planner's
    description of it (:data:`MXU_LAYOUT_125`) are what ``ir.fold_linear``
    gives for mpi125pt, so the entry point takes the layout's body for the
    125-point leg."""
    assert _header_layout() == MXU_LAYOUT_125
    ir = as_ir("mpi125pt")
    wdefs, vmap, jneed = fold_linear(
        ir, resolve_const_from_params(bench_params()))
    assert len(wdefs) == MXU_LAYOUT_125["nw"]
    assert jneed == MXU_LAYOUT_125["jreach"]
    plan = _big("mpi125pt", "periodic").plan
    assert plan.folded() == MXU_LAYOUT_125 and plan.layout()
    for di, terms in sorted(vmap.items()):
        d = MXU_LAYOUT_125["di"].index(di)
        assert MXU_LAYOUT_125["tuples"][MXU_LAYOUT_125["dtup"][d]] == terms
    # every profile's five k taps non-zero
    assert np.count_nonzero(plan.coefficients()) == 6 * 5


@pytest.mark.parametrize("name", ["s7pt", "mpi25pt", "mpi13pt", "s27pt"])
def test_other_folded_stencils_take_the_generic_body(name):
    assert not _small(name, (4, 8, 8), False).plan.layout()


def test_a_zero_coefficient_leaves_the_layout():
    """The layout's body applies every k tap of every profile; a folded
    form with a zero among them (here the cube's corners, MPI_C9) runs the
    generic body, which skips zeros as the first design did."""
    params = dict(bench_params(), MPI_C9=0.0)
    grid, info = init_grid((5, 4, 1))
    fn = pencil_sweep_mxu("mpi125pt", np.asarray(grid), (4, 4, 8),
                          info.nbricks, params)
    assert not np.all(fn.plan.coefficients() != 0)
    assert not fn.plan.layout()


def test_a_profile_uneven_in_dk_leaves_the_layout():
    """The layout's body sums the planes at -dk and +dk once for every
    profile, so it takes only profiles even in dk, as the cube's are (its
    coefficients go by |dk|); one tap moved off that symmetry runs the
    generic body (``mxu_layout_matches`` checks the same on the card)."""
    plan = _big("mpi125pt", "periodic").plan
    c = plan.coefficients().reshape(6, 5)
    assert np.array_equal(c, c[:, ::-1])
    w0 = plan.wdefs[0] + ((0.5, ((1,),)),)
    uneven = dataclasses.replace(plan, wdefs=(w0,) + plan.wdefs[1:])
    assert uneven.folded() == MXU_LAYOUT_125
    assert np.all(uneven.coefficients() != 0)
    assert not uneven.layout()
    assert re.search(r"t\.c\[q\] != t\.c\[q - q % NK \+ NK - 1 - q % NK\]",
                     HEADER.read_text())


def test_loads_per_output_under_the_layout():
    """The compiled layout loads each strip row's 5 k taps once: 12 rows
    for 8 V rows, 7.5 loads per V row; over the warps' 32 lanes for 28
    outputs and the 19 lane chunks that cover a 512-lane brick row, 8.906
    per output at 512^3, whatever the footprint (PERF.md)."""
    plan = _big("mpi125pt", "periodic").plan
    got = plan.loads()
    assert got["per_row"] == 7.5
    assert got["shared"] == pytest.approx(7.5 * 32 / 28 * 19 * 28 / 512)
    v = mxu_footprint(plan, 8, 4, 1, 2)
    assert plan.loads(v)["level0"] == pytest.approx(
        (64 + 4) / 64 * (32 + 4) / 32 * (28 + 8) / 28 * 19 * 28 / 512)


def test_planner_raises_when_nothing_fits(monkeypatch):
    plan = _small("mpi125pt", (4, 4, 8), False).plan
    with pytest.raises(ValueError, match="no K8 k-streaming block"):
        mxu_kernel._mxu_stream_plan.__wrapped__(
            plan.bdims, plan.ranges, (2, 2, 2), (2, 2, 2), 6, 30, 15, 5,
            True, budget=1024)


def test_planner_refuses_an_i_reach_of_a_warp():
    with pytest.raises(ValueError, match="i reach"):
        mxu_kernel._mxu_stream_plan.__wrapped__(
            (4, 4, 64), ((1, 2), (1, 2)), (1, 1, 16), (1, 1, 16), 3, 3, 3,
            3, False)
