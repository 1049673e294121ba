"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card.
The file imports no JAX, so it also runs on a machine without JAX, where
``tests/conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

K1 is compared on the bricks it writes at abs-or-rel 1e-5 (FMA contraction
and summation order); K2 and K3 only copy, so they must be bit-exact.
"""

import numpy as np
import pytest
import torch

from bricklib_tpu_torch.bench.roofline import copy_storage, copy_storage_plain
from bricklib_tpu_torch.codegen.pencil_kernel import (pencil_sweep,
                                                      pencil_sweep_kernel,
                                                      pencil_sweep_plain)
from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu_torch.comm.exchange import (copy_intervals,
                                              copy_intervals_plain,
                                              shift_exchange)
from bricklib_tpu_torch.core import compare_arrays, random_storage
from bricklib_tpu_torch.drivers import weak
from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

pytestmark = pytest.mark.gpu

BD = (8, 8, 32)
STEP = dict(dims=(32, 32, 32), bdim=(8, 8, 32), stencil="s7pt", st_iter=8,
            fuse=4, table_periodic=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


def _dec():
    return BrickDecomp(dims=(32, 32, 32), ghost_depth=(8, 8, 0),
                       bdims=BD).initialize(skinlist_by_name("good", 3))


@pytest.mark.parametrize("name,fuse,periodic,skip", [
    ("s7pt", 1, True, 1), ("s7pt", 1, False, 0), ("s7pt", 2, False, 0),
    ("s7pt", 4, False, 0), ("s7pt", 4, False, 1), ("mpi13pt", 2, False, 0),
    ("s27pt", 2, False, 0)])
def test_sweep_kernel_matches_plain(cuda, name, fuse, periodic, skip):
    dec = _dec()
    grid = dec.periodic_grid((0, 1, 2)) if periodic else dec.grid
    GK, GJ = grid.shape[:2]
    x = random_storage(dec, seed=5, device=cuda)
    fn = pencil_sweep(stencil_by_name(name)[0], grid, BD, dec.nbricks,
                      bench_params(), k_range=(skip, GK - skip),
                      j_range=(skip, GJ - skip), fuse=fuse)
    before = pencil_sweep_kernel.launches
    got = fn(x)
    assert pencil_sweep_kernel.launches == before + 1
    want = pencil_sweep_plain(x, torch.from_numpy(fn.plan.table).to(cuda),
                              fn.plan)
    w = fn.plan.written_bricks()
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


def test_sweep_kernel_refuses_nonlinear_stencils(cuda):
    dec = _dec()
    fn = pencil_sweep(stencil_by_name("cond")[0], dec.grid, BD, dec.nbricks,
                      bench_params())
    with pytest.raises(NotImplementedError, match="nonlinear"):
        fn(random_storage(dec, seed=5, device=cuda))


@pytest.mark.parametrize("table_axes", [(2,), ()])
def test_exchange_kernel_matches_plain(cuda, table_axes):
    dec = _dec()
    a = random_storage(dec, seed=14, device=cuda)
    b = a.clone()
    ex = shift_exchange(dec, (1, 1, 1), table_axes)
    before = copy_intervals.launches
    ex(a)
    assert copy_intervals.launches == before + len(ex.stages)
    for ivs in ex.stages:
        copy_intervals_plain(b, ivs)
    assert torch.equal(a, b)


def test_copy_kernel_matches_plain(cuda):
    x = random_storage(_dec(), seed=3, device=cuda)
    before = copy_storage.launches
    y = copy_storage(x)
    assert copy_storage.launches == before + 1
    assert y.data_ptr() != x.data_ptr()
    assert torch.equal(y, copy_storage_plain(x))


def test_step_on_card_matches_cpu(cuda):
    step_c, st_c, dec = weak.build_step(**STEP, device=cuda)
    step_h, st_h, _ = weak.build_step(**STEP, device="cpu")
    got = step_c(st_c).cpu().numpy()
    want = step_h(st_h).numpy()
    own = dec.owned_mask()
    assert compare_arrays(got[own], want[own], 1e-5)
    assert np.isfinite(got[own]).all()
