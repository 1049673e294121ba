"""The port's flat-pencil sweep (``bricklib_tpu_torch.codegen.mxu_kernel``)
against the reference ``pallas_pencil_sweep_mxu`` in interpret mode.

Both packages get the same numpy storage (random in every brick, ghosts
and brick 0 too) and the same params; the sweeps are compared on the
bricks they write, at abs-or-rel 1e-5 (float32 sums in another order).
The ghost-inclusive ranges reach the table edge, where window rows and
pencils clamp.  On the CPU the port runs kernel K8's plain version; the
kernel itself is held against that plain version on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu.codegen import mxu_kernel as ref_mxu
from bricklib_tpu.codegen.evaluate import (
    resolve_const_from_params as ref_resolve)
from bricklib_tpu.codegen.ir import StencilIR as RefIR
from bricklib_tpu.codegen.ir import fold_linear as ref_fold
from bricklib_tpu.core import compare_arrays, init_grid, random_array
from bricklib_tpu.stencils import DEFAULT_PARAMS, stencil_by_name
from bricklib_tpu_torch import comm as port_comm
from bricklib_tpu_torch import stencils as port_stencils
from bricklib_tpu_torch.codegen.ir import StencilIR
from bricklib_tpu_torch.codegen.ir import fold_linear
from bricklib_tpu_torch.codegen.evaluate import resolve_const_from_params
from bricklib_tpu_torch.codegen.mxu_kernel import (_slot_matrices,
                                                   flatten_bricks,
                                                   pencil_sweep_mxu,
                                                   pencil_sweep_mxu_kernel,
                                                   unflatten_bricks)
from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep

TOL = 1e-5
PARAMS = dict(DEFAULT_PARAMS)
PARAMS["coeff"] = [0.03 * (c + 1) for c in range(27)]
# the cases of tests/test_mxu_kernel.py:43-46
CASES = [("s7pt", (2, 2, 8)), ("mpi13pt", (4, 4, 8)),
         ("mpi125pt", (4, 4, 8)), ("mpi25pt", (4, 8, 8))]


def _port_sd(name):
    return port_stencils.stencil_by_name(name)[0]


def _storage(bd, g, seed):
    """A (5, 4, 1) table of distinct bricks, random storage in every brick,
    flat-pencil: ``(table, nbricks, storage)``."""
    grid, info = init_grid(g)
    dat = random_array((info.nbricks,) + bd, np.float32, seed)
    return np.asarray(grid), info.nbricks, dat.reshape(info.nbricks, bd[0],
                                                      -1)


@pytest.mark.parametrize("name,bd", CASES)
@pytest.mark.parametrize("ranges", ["skip", "ghost"])
def test_mxu_sweep_matches_the_reference(name, bd, ranges):
    grid, nb, flat = _storage(bd, (5, 4, 1), 31)
    GK, GJ = grid.shape[:2]
    kw = ({} if ranges == "skip"
          else dict(k_range=(0, GK), j_range=(0, GJ)))
    ref = ref_mxu.pallas_pencil_sweep_mxu(stencil_by_name(name)[0], grid, bd,
                                          nb, PARAMS, interpret=True, **kw)
    want = np.asarray(ref(jnp.asarray(flat)))
    fn = pencil_sweep_mxu(_port_sd(name), grid, bd, nb, PARAMS, **kw)
    before = pencil_sweep_mxu_kernel.launches
    got = fn(torch.from_numpy(flat)).numpy()
    assert pencil_sweep_mxu_kernel.launches == before
    w = fn.plan.written_bricks()
    K0, K1 = kw.get("k_range", (1, GK - 1))
    J0, J1 = kw.get("j_range", (1, GJ - 1))
    assert np.array_equal(w, np.unique(grid[K0:K1, J0:J1]))
    assert compare_arrays(got[w], want[w], TOL)
    assert fn.n_wprofiles == ref.n_wprofiles


@pytest.mark.parametrize("name,bd", CASES + [("s27pt", (8, 8, 16))])
def test_slot_matrices_are_the_references(name, bd):
    ref_lin = ref_fold(RefIR.from_def(stencil_by_name(name)[0]),
                       ref_resolve(PARAMS))
    lin = fold_linear(StencilIR.from_def(_port_sd(name)),
                      resolve_const_from_params(PARAMS))
    assert lin == ref_lin
    lo, hi = StencilIR.from_def(_port_sd(name)).radius()
    want = ref_mxu._slot_matrices(ref_lin[0], bd[0], lo[0], hi[0])
    got = _slot_matrices(lin[0], bd[0], lo[0], hi[0])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_two_chained_sweeps_match_the_pencil_sweep():
    """Two chained flat-pencil sweeps against two of the port's fuse=1
    pencil sweeps (K1's plain version) on one periodic table."""
    bd = (4, 4, 8)
    dec = port_comm.BrickDecomp(dims=(12, 12, 8), ghost_depth=(4, 4, 0),
                                bdims=bd).initialize(
        port_comm.skinlist_by_name("good", 3))
    tgrid = dec.periodic_grid((0, 1, 2))
    sd = _port_sd("mpi125pt")
    dat = torch.from_numpy(random_array((dec.nbricks,) + bd, np.float32, 37))
    mx = pencil_sweep_mxu(sd, tgrid, bd, dec.nbricks, PARAMS)
    cl = pencil_sweep(sd, tgrid, bd, dec.nbricks, PARAMS)
    got = unflatten_bricks(mx(mx(flatten_bricks(dat))), bd).numpy()
    want = cl(cl(dat)).numpy()
    wids = np.unique(np.asarray(tgrid)[1:-1, 1:-1])
    assert compare_arrays(got[wids], want[wids], TOL)


def test_flatten_is_a_view():
    x = torch.arange(2 * 2 * 3 * 4, dtype=torch.float32).reshape(2, 2, 3, 4)
    f = flatten_bricks(x)
    assert f.shape == (2, 2, 12) and f.data_ptr() == x.data_ptr()
    u = unflatten_bricks(f, (2, 3, 4))
    assert torch.equal(u, x) and u.data_ptr() == x.data_ptr()


def _guard_cases():
    grid, _info = init_grid((5, 4, 1))
    grid = np.asarray(grid)
    return [
        (dict(stencil="mpi9pt", bd=(4, 4, 8)), NotImplementedError, "3-D"),
        (dict(stencil="cond"), NotImplementedError, "linear"),
        (dict(bd=(1, 4, 8)), ValueError, "k radius"),
        (dict(bd=(4, 1, 8)), ValueError, "j radius"),
        (dict(bd=(4, 4, 2)), ValueError, "i radius"),
        (dict(grid=np.stack([grid[:, :, 0]] * 2, axis=2)),
         NotImplementedError, "pencil-only"),
        (dict(k_range=(0, 9)), ValueError, "outside grid"),
        (dict(j_range=(2, 2)), ValueError, "outside grid"),
        (dict(lookahead=0), ValueError, "lookahead"),
        (dict(tile_j=3), ValueError, "must divide"),
        (dict(dtype=np.float64), NotImplementedError, "f32 or bf16"),
    ]


@pytest.mark.parametrize("case,exc,match", _guard_cases())
def test_argument_checks_raise_as_the_reference(case, exc, match):
    grid, info = init_grid((5, 4, 1))
    args = dict(stencil="mpi13pt", bd=(4, 4, 8), grid=np.asarray(grid))
    args.update(case)
    name, bd, grid = args.pop("stencil"), args.pop("bd"), args.pop("grid")
    with pytest.raises(exc, match=match) as ref:
        ref_mxu.pallas_pencil_sweep_mxu(stencil_by_name(name)[0], grid, bd,
                                        info.nbricks, PARAMS,
                                        interpret=True, **args)
    with pytest.raises(exc, match=match) as port:
        pencil_sweep_mxu(_port_sd(name), grid, bd, info.nbricks, PARAMS,
                         **args)
    assert str(port.value) == str(ref.value)


def test_bf16_storage_is_not_ported():
    grid, info = init_grid((5, 4, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pencil_sweep_mxu(_port_sd("mpi125pt"), np.asarray(grid), (4, 4, 8),
                         info.nbricks, PARAMS, dtype=torch.bfloat16)


def test_cuda_tensors_launch_the_kernel_or_raise():
    grid, nb, flat = _storage((4, 4, 8), (5, 4, 1), 3)
    fn = pencil_sweep_mxu(_port_sd("s7pt"), grid, (4, 4, 8), nb, PARAMS)
    with pytest.raises(ValueError, match="storage shape"):
        fn(torch.zeros(nb, 4, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        pencil_sweep_mxu_kernel(torch.from_numpy(flat),
                                torch.from_numpy(fn.plan.table), fn.plan)
