"""The port's fused 4-D pencil sweep
(``bricklib_tpu_torch.codegen.pencil_kernel_4d``) against the reference
``pallas_pencil_sweep_4d`` in interpret mode.

Both packages get the same numpy storage (random in every brick, ghosts
and brick 0 too) and the same coefficients; the sweeps are compared on the
bricks they write at abs-or-rel 5e-5 (the f32 tolerance of
``core/compare.py``: float32 sums in another order).  On the CPU the port
runs kernel K4's plain version; the kernel itself is held against that
plain version on the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu.codegen.pencil_kernel_4d import pallas_pencil_sweep_4d
from bricklib_tpu.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu.core import compare_arrays, random_array
from bricklib_tpu.stencils import bench_params, stencil_by_name
from bricklib_tpu import st as ref_st
from bricklib_tpu_torch import comm as port_comm
from bricklib_tpu_torch import st as port_st
from bricklib_tpu_torch import stencils as port_stencils
from bricklib_tpu_torch.codegen import pencil_kernel_4d
from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
    pencil_sweep_4d, pencil_sweep_4d_kernel, pencil_sweep_4d_plain, tile_4d)
from bricklib_tpu_torch.convert import storage_from_reference

BD = (2, 2, 4, 16)
TOL = 5e-5


def _dec(bd=BD, dims=(4, 6, 8, 16), pkg=None):
    """The test decomposition from the reference's ``comm``, or from
    ``pkg`` (the port's)."""
    bdec, skins = ((BrickDecomp, skinlist_by_name) if pkg is None
                   else (pkg.BrickDecomp, pkg.skinlist_by_name))
    return bdec(dims=dims, ghost_depth=bd[:3] + (0,),
                bdims=bd).initialize(skins("good", 4))


def _mixed_radius(st):
    """fuse=2 with asymmetric radii (w=1, k=2, j=2, i=1), as in the
    reference's ``test_pencil_4d_fused_mixed_radii``, built with the eDSL
    package ``st`` (the reference's or the port's)."""
    FloatLiteral, Grid, Index = st.FloatLiteral, st.Grid, st.Index
    load_stencil_module = st.load_stencil_module

    inp, out = Grid("in", 4), Grid("out", 4)
    i, j, k, w = Index(0), Index(1), Index(2), Index(3)
    out(i, j, k, w).assign(
        FloatLiteral(0.3) * inp(i, j, k, w)
        + FloatLiteral(0.11) * inp(i + 1, j, k - 2, w)
        + FloatLiteral(0.07) * inp(i - 1, j + 2, k, w - 1)
        + FloatLiteral(0.05) * inp(i, j - 1, k + 1, w + 1))
    return load_stencil_module({"STENCIL": [out]})[0]


def _ranges(kind, G):
    if kind == "ghost":
        return dict(w_range=(0, G[0]), k_range=(0, G[1]), j_range=(0, G[2]))
    if kind == "w-ghost":
        return dict(w_range=(0, G[0]))
    return {}


CASES = [("mpi9pt", 1, "periodic", "skip"),
         ("mpi9pt", 1, "grid", "ghost"),
         ("mpi9pt", 2, "periodic", "skip"),
         ("mpi9pt", 2, "grid", "ghost"),
         ("mpi9pt", 2, "grid", "skip"),
         ("mpi9pt", 2, "grid", "w-ghost"),
         ("mixed", 2, "grid", "ghost"),
         ("mixed", 2, "periodic", "skip")]


@pytest.mark.parametrize("name,fuse,grid_kind,ranges", CASES)
def test_sweep_4d_matches_reference(name, fuse, grid_kind, ranges):
    bd = (2, 4, 4, 16) if name == "mixed" else BD
    dims = (4, 8, 8, 16) if name == "mixed" else (4, 6, 8, 16)
    grids = []
    for dec in (_dec(bd, dims), _dec(bd, dims, port_comm)):
        grids.append(dec.grid if grid_kind == "grid"
                     else dec.periodic_grid((0, 1, 2, 3)))
    grid, pgrid = grids
    assert np.array_equal(grid, pgrid)
    if name == "mixed":
        sd, psd = _mixed_radius(ref_st), _mixed_radius(port_st)
    else:
        sd, psd = (stencil_by_name(name)[0],
                   port_stencils.stencil_by_name(name)[0])
    prm = {} if name == "mixed" else bench_params()
    kw = _ranges(ranges, grid.shape)
    x = random_array((dec.nbricks,) + bd, np.float32, 21)
    want = np.asarray(pallas_pencil_sweep_4d(
        sd, grid, bd, dec.nbricks, prm, fuse=fuse, interpret=True,
        **kw)(jnp.asarray(x)))
    fn = pencil_sweep_4d(psd, pgrid, bd, dec.nbricks, prm, fuse=fuse, **kw)
    before = pencil_sweep_4d_kernel.launches
    got = fn(storage_from_reference(x, "cpu")).numpy()
    assert pencil_sweep_4d_kernel.launches == before
    w = fn.plan.written_bricks()
    G = grid.shape
    nw, nk, nj = (r[1] - r[0] for r in fn.plan.ranges)
    assert len(w) == nw * nk * nj
    if ranges == "ghost":
        assert (nw, nk, nj) == G[:3]
    assert compare_arrays(got[w], want[w], TOL)


def test_plain_version_is_the_rank_generic_plain_sweep():
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain

    assert pencil_sweep_4d_plain is pencil_sweep_plain


def test_tile_of_the_4d_step():
    """At the 4-D step's shape (brick (4, 8, 8, 512), fuse 2, radius 1)
    the least-work tile that fits the budget is the whole w extent and
    8 i lanes; a budget too small for any tile raises."""
    dec = _dec((4, 8, 8, 512), (16, 64, 128, 512), port_comm)
    fn = pencil_sweep_4d("mpi9pt", dec.grid, dec.bdims, dec.nbricks,
                         bench_params(), fuse=2)
    assert dec.nbricks == 1081
    tw, ti, smem = tile_4d(fn.plan)
    assert (tw, ti) == (4, 8) and smem <= pencil_kernel_4d.K4_SMEM_BUDGET


def test_no_tile_raises(monkeypatch):
    monkeypatch.setattr(pencil_kernel_4d, "K4_SMEM_BUDGET", 1024)
    dec = _dec(pkg=port_comm)
    fn = pencil_sweep_4d("mpi9pt", dec.grid, BD, dec.nbricks,
                         bench_params(), fuse=2)
    with pytest.raises(ValueError, match="no K4 tile"):
        tile_4d(fn.plan)


def _bad(name="mpi9pt", bd=BD, grid_shape=(4, 5, 4), **kw):
    n = int(np.prod(grid_shape))
    grid = np.arange(n, dtype=np.int32).reshape(grid_shape)
    return (name, grid, bd, n, bench_params()), kw


def _ref_args(args):
    return (stencil_by_name(args[0])[0],) + args[1:]


def _port_args(args):
    return (port_stencils.stencil_by_name(args[0])[0],) + args[1:]


@pytest.mark.parametrize("args,kw", [
    _bad(fuse=0),
    _bad(bd=(1, 2, 4, 16), fuse=2),
    _bad(bd=(2, 1, 4, 16), fuse=2),
    _bad(bd=(2, 2, 1, 16), fuse=2),
    _bad(bd=(0, 2, 4, 16)),
    _bad(lookahead=0),
    _bad(tile_j=3),
    _bad(grid_shape=(4, 5, 4, 2)),
])
def test_invalid_arguments_raise_as_the_reference(args, kw):
    with pytest.raises(ValueError) as ref:
        pallas_pencil_sweep_4d(*_ref_args(args), interpret=True, **kw)
    with pytest.raises(ValueError) as port:
        pencil_sweep_4d(*_port_args(args), **kw)
    assert str(port.value) == str(ref.value)


def test_three_d_stencil_is_refused_as_the_reference():
    args, _ = _bad("s7pt")
    with pytest.raises(NotImplementedError) as ref:
        pallas_pencil_sweep_4d(*_ref_args(args), interpret=True)
    with pytest.raises(NotImplementedError) as port:
        pencil_sweep_4d(*_port_args(args))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kw", [dict(dtype=torch.bfloat16),
                                dict(compute_dtype=jnp.bfloat16)])
def test_unported_features_raise(kw):
    args, _ = _bad()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pencil_sweep_4d(*_port_args(args), **kw)


def test_range_outside_the_grid_raises():
    args, _ = _bad()
    with pytest.raises(ValueError, match="outside grid"):
        pencil_sweep_4d(*_port_args(args), w_range=(0, 5))


def test_kernel_refuses_cpu_tensors_and_storage_is_checked():
    fn = pencil_sweep_4d(*_port_args(_bad()[0]))
    x = torch.zeros((80,) + BD)
    before = pencil_sweep_4d_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        pencil_sweep_4d_kernel(x, torch.from_numpy(fn.plan.table), fn.plan)
    assert pencil_sweep_4d_kernel.launches == before
    with pytest.raises(ValueError, match="storage shape"):
        fn(torch.zeros((79,) + BD))
