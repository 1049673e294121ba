"""The port's fused pencil sweep (``bricklib_tpu_torch.codegen.pencil_kernel``)
against the reference ``pallas_pencil_sweep`` in interpret mode.

Both packages get the same numpy storage (random in every brick, ghosts
and brick 0 too) and the same ``bench_params()``; the sweeps are compared
on the bricks they write, at abs-or-rel 1e-5 (float32 sums in another
order).  On the CPU the port runs kernel K1's plain version; the kernel
itself is held against that plain version on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu.codegen.pencil_kernel import pallas_pencil_sweep
from bricklib_tpu.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu.core import compare_arrays, random_array
from bricklib_tpu.stencils import bench_params, stencil_by_name
from bricklib_tpu_torch import comm as port_comm
from bricklib_tpu_torch import stencils as port_stencils
from bricklib_tpu_torch.codegen.pencil_kernel import (pencil_stencil,
                                                      pencil_sweep,
                                                      pencil_sweep_kernel,
                                                      pencil_sweep_plain)
from bricklib_tpu_torch.convert import storage_from_reference

BD = (8, 8, 32)
TOL = 1e-5


def _dec(pkg=None):
    """The test decomposition, built by the reference's ``comm`` or by
    ``pkg`` (the port's)."""
    bd, skins = ((BrickDecomp, skinlist_by_name) if pkg is None
                 else (pkg.BrickDecomp, pkg.skinlist_by_name))
    return bd(dims=(32, 32, 32), ghost_depth=(8, 8, 0),
              bdims=BD).initialize(skins("good", 3))


def _port_sd(name):
    return port_stencils.stencil_by_name(name)[0]


def _case(dec, grid_kind, ranges):
    grid = dec.grid if grid_kind == "grid" else dec.periodic_grid((0, 1, 2))
    GK, GJ = grid.shape[:2]
    if ranges == "ghost":
        return grid, (0, GK), (0, GJ)
    return grid, (1, GK - 1), (1, GJ - 1)


CASES = [("s7pt", 1, "periodic", "skip"),
         ("s7pt", 1, "grid", "ghost"),
         ("s7pt", 2, "grid", "ghost"),
         ("s7pt", 4, "grid", "ghost"),
         ("s7pt", 4, "grid", "skip"),
         ("mpi13pt", 2, "grid", "ghost"),
         ("cond", 1, "grid", "ghost")]


@pytest.mark.parametrize("name,fuse,grid_kind,ranges", CASES)
def test_sweep_matches_reference(name, fuse, grid_kind, ranges):
    dec = _dec()
    grid, kr, jr = _case(dec, grid_kind, ranges)
    pgrid, pkr, pjr = _case(_dec(port_comm), grid_kind, ranges)
    assert np.array_equal(pgrid, grid) and (pkr, pjr) == (kr, jr)
    x = random_array((dec.nbricks,) + BD, np.float32, 5)
    prm = bench_params()
    want = np.asarray(pallas_pencil_sweep(
        stencil_by_name(name)[0], grid, BD, dec.nbricks, prm, k_range=kr,
        j_range=jr, fuse=fuse, interpret=True)(jnp.asarray(x)))
    fn = pencil_sweep(_port_sd(name), pgrid, BD, dec.nbricks,
                      port_stencils.bench_params(), k_range=kr, j_range=jr,
                      fuse=fuse)
    before = pencil_sweep_kernel.launches
    got = fn(storage_from_reference(x, "cpu")).numpy()
    assert pencil_sweep_kernel.launches == before
    w = fn.plan.written_bricks()
    assert len(w) == (kr[1] - kr[0]) * (jr[1] - jr[0])
    assert compare_arrays(got[w], want[w], TOL)


def test_pencil_stencil_is_the_skip_or_ghost_sweep():
    dec = _dec(port_comm)
    GK, GJ = dec.grid.shape[:2]
    x = storage_from_reference(
        random_array((dec.nbricks,) + BD, np.float32, 6), "cpu")
    sd = _port_sd("s7pt")
    for skip in (0, 1):
        a = pencil_stencil(sd, dec.grid, BD, (1, 1), dec.nbricks,
                           bench_params(), skip=skip, fuse=2)
        b = pencil_sweep(sd, dec.grid, BD, dec.nbricks, bench_params(),
                         k_range=(skip, GK - skip),
                         j_range=(skip, GJ - skip), fuse=2)
        w = b.plan.written_bricks()
        assert torch.equal(a(x)[w], b(x)[w])


def _bad(name, bd=BD, **kw):
    """(positional arguments with the stencil's name, keyword arguments)
    for an invalid sweep on a 6x6 table."""
    grid = np.arange(36, dtype=np.int32).reshape(6, 6)
    return (name, grid, bd, 36, bench_params()), kw


def _bad3(name, bd=BD, **kw):
    """As :func:`_bad`, on an i-bricked 6x6x4 table."""
    grid = np.arange(144, dtype=np.int32).reshape(6, 6, 4)
    return (name, grid, bd, 144, bench_params()), kw


def _port_args(args):
    return (_port_sd(args[0]),) + args[1:]


@pytest.mark.parametrize("args,kw", [
    _bad("s7pt", k_range=(0, 7)),
    _bad("s7pt", j_range=(3, 3)),
    _bad("mpi13pt", bd=(1, 8, 32)),
    _bad("s7pt", fuse=0),
    _bad("mpi13pt", bd=(8, 4, 32), fuse=3),
    _bad("mpi13pt", bd=(4, 8, 32), fuse=3),
    _bad("s7pt", lookahead=0),
    _bad("s7pt", j_shift="gather"),
    _bad("s7pt", tile_j=3),
    _bad("s7pt", i_range=(0, 2)),
    _bad("s7pt", batch=2),
    _bad3("s7pt"),
    _bad3("s7pt", i_ghost=1, i_range=(0, 5)),
    _bad3("s7pt", i_ghost=1, i_range=(2, 2)),
    _bad3("s7pt", bd=(8, 8, 2), i_ghost=1, fuse=3),
    _bad3("s7pt", bd=(8, 8, 2), i_ghost=1, i_range=(0, 4), fuse=3),
    _bad3("mpi13pt", bd=(8, 8, 1), i_ghost=1),
])
def test_invalid_arguments_raise_as_the_reference(args, kw):
    with pytest.raises(ValueError) as ref:
        pallas_pencil_sweep(stencil_by_name(args[0])[0], *args[1:],
                            interpret=True, **kw)
    with pytest.raises(ValueError) as port:
        pencil_sweep(*_port_args(args), **kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("kw", [
    dict(inplace=True),
    dict(dtype=torch.bfloat16),
    dict(dtype=jnp.bfloat16),
])
def test_unported_features_raise(kw):
    args, _ = _bad("s7pt")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pencil_sweep(*_port_args(args), **kw)


def test_unported_layouts_and_systems_raise():
    """i-bricked tables run (``tests/test_torch_strong_cubic.py``); one
    without a ring of i ghost bricks raises as the reference does.
    Stencil systems stay unported."""
    sd = _port_sd("s7pt")
    grid3 = np.arange(72, dtype=np.int32).reshape(6, 6, 2)
    with pytest.raises(ValueError, match="i_ghost >= 1"):
        pencil_sweep(sd, grid3, BD, 72, bench_params())
    assert pencil_sweep(sd, grid3, BD, 72, bench_params(), i_ghost=1,
                        i_range=(0, 2)).plan.ibrick
    grid = np.arange(36, dtype=np.int32).reshape(6, 6)
    with pytest.raises(NotImplementedError, match="systems"):
        pencil_sweep([sd, sd], grid, BD, 36, bench_params())


def test_sweep_checks_storage_shape():
    fn = pencil_sweep(*_port_args(_bad("s7pt")[0]))
    with pytest.raises(ValueError, match="storage shape"):
        fn(torch.zeros((35,) + BD))


def test_kernel_refuses_cpu_tensors():
    fn = pencil_sweep(*_port_args(_bad("s7pt")[0]))
    x = torch.zeros((36,) + BD)
    before = pencil_sweep_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        pencil_sweep_kernel(x, torch.from_numpy(fn.plan.table), fn.plan)
    assert pencil_sweep_kernel.launches == before



@pytest.mark.parametrize("name,fuse,i_range", [("s7pt", 2, (0, 4)),
                                               ("mpi13pt", 1, None)])
def test_ibrick_sweep_matches_reference(name, fuse, i_range):
    """An i-bricked table (GI = 4, one ghost brick column a side),
    batched over two subdomains: ghost-inclusive on every axis, and the
    default ranges (every ghost ring skipped), against the reference."""
    grid = (np.random.default_rng(3).permutation(64) + 1).reshape(
        4, 4, 4).astype(np.int32)
    bd, nb, batch = (4, 4, 4), 66, 2
    kw = dict(i_ghost=1, i_range=i_range, fuse=fuse, batch=batch,
              batch_stride=nb)
    if i_range is not None:
        kw.update(k_range=(0, 4), j_range=(0, 4))
    x = random_array((batch * nb,) + bd, np.float32, 8)
    want = np.asarray(pallas_pencil_sweep(
        stencil_by_name(name)[0], grid, bd, batch * nb, bench_params(),
        interpret=True, **kw)(jnp.asarray(x)))
    fn = pencil_sweep(_port_sd(name), grid, bd, batch * nb,
                      port_stencils.bench_params(), **kw)
    got = fn(storage_from_reference(x, "cpu")).numpy()
    w = fn.plan.written_bricks()
    assert fn.plan.ibrick and len(w) == batch * (
        64 if i_range is not None else 8)
    assert compare_arrays(got[w], want[w], TOL)
