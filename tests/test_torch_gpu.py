"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card.
The file imports no JAX, so it also runs on a machine without JAX, where
``tests/conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

K1 (also batched over a subdomain stack), K4 and K6 are compared on the
bricks they write at abs-or-rel 1e-5 (FMA contraction and summation
order); K2, K3 and K5 only copy, so they must be bit-exact.
"""

import numpy as np
import pytest
import torch

from bricklib_tpu_torch import st
from bricklib_tpu_torch.api import Problem
from bricklib_tpu_torch.bench.roofline import copy_storage, copy_storage_plain
from bricklib_tpu_torch.codegen.pencil_kernel import (pencil_sweep,
                                                      pencil_sweep_kernel,
                                                      pencil_sweep_plain)
from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
    pencil_sweep_2d, pencil_sweep_2d_kernel, pencil_sweep_2d_plain)
from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
    pencil_sweep_4d, pencil_sweep_4d_kernel)
from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu_torch.comm.exchange import (copy_intervals,
                                              copy_intervals_plain,
                                              shift_exchange)
from bricklib_tpu_torch.comm.strong import (StrongDecomp, stage_copy,
                                            stage_copy_plain, strong_stages)
from bricklib_tpu_torch.core import compare_arrays, random_storage
from bricklib_tpu_torch.drivers import strong, weak
from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

from torch_2d_stencils import BUILDERS, PARAMS

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


def _dec4():
    return BrickDecomp(dims=(8, 8, 8, 16), ghost_depth=(4, 4, 4, 0),
                       bdims=(4, 4, 4, 16)).initialize(
        skinlist_by_name("good", 4))


@pytest.mark.parametrize("fuse,periodic,skip", [
    (1, True, 1), (1, False, 0), (2, False, 0), (2, False, 1)])
def test_sweep_4d_kernel_matches_plain(cuda, fuse, periodic, skip):
    dec = _dec4()
    grid = dec.periodic_grid((0, 1, 2, 3)) if periodic else dec.grid
    G = grid.shape[:3]
    x = random_storage(dec, seed=6, device=cuda)
    fn = pencil_sweep_4d("mpi9pt", grid, dec.bdims, dec.nbricks,
                         bench_params(), fuse=fuse,
                         **{f"{a}_range": (skip, n - skip)
                            for a, n in zip("wkj", G)})
    before = pencil_sweep_4d_kernel.launches
    got = fn(x)
    assert pencil_sweep_4d_kernel.launches == before + 1
    want = pencil_sweep_plain(x, torch.from_numpy(fn.plan.table).to(cuda),
                              fn.plan)
    w = fn.plan.written_bricks()
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


def _strong_plan():
    return StrongDecomp(dom=(32, 32, 32), sdom=(16, 16, 32),
                        mesh_shape=(1, 1, 1), bdims=(4, 4, 32),
                        ghost_depth=(4, 4, 0)).initialize(
        skinlist_by_name("good", 3))


@pytest.mark.parametrize("fuse,skip", [(1, 1), (2, 0), (2, 1)])
def test_batched_sweep_kernel_matches_plain(cuda, fuse, skip):
    plan = _strong_plan()
    kg = plan.sdec.periodic_grid((2,))
    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    GK, GJ = kg.shape[:2]
    x = torch.rand((nsub * nb,) + plan.bdims,
                   generator=torch.Generator().manual_seed(7)).to(cuda)
    fn = pencil_sweep("s7pt", kg, plan.bdims, nsub * nb, bench_params(),
                      k_range=(skip, GK - skip), j_range=(skip, GJ - skip),
                      batch=nsub, batch_stride=nb, fuse=fuse)
    before = pencil_sweep_kernel.launches
    got = fn(x)
    assert pencil_sweep_kernel.launches == before + 1
    want = pencil_sweep_plain(x, torch.from_numpy(fn.plan.table).to(cuda),
                              fn.plan)
    w = fn.plan.written_bricks()
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


def test_stage_copy_kernel_matches_plain(cuda):
    plan = _strong_plan()
    nb = plan.sdec.nbricks
    x = torch.rand((plan.nsub_local * nb,) + plan.bdims,
                   generator=torch.Generator().manual_seed(8)).to(cuda)
    a, b = x.clone(), x.clone()
    steps = strong_stages(plan)
    before = stage_copy.launches
    for st in steps:
        g = torch.from_numpy(st.gather).to(cuda)
        stage_copy(a, st.local_ivs, a.index_select(0, g), st.recv_ivs)
        stage_copy_plain(b, st.local_ivs, b.index_select(0, g), st.recv_ivs)
    assert stage_copy.launches == before + len(steps)
    assert torch.equal(a, b) and not torch.equal(a, x)


def test_4d_step_on_card_matches_cpu(cuda):
    kw = dict(dims=(8, 8, 8, 16), bdim=(4, 4, 4, 16), stencil="mpi9pt",
              st_iter=4, fuse=2, table_periodic=False)
    step_c, st_c, dec = weak.build_step(**kw, device=cuda)
    step_h, st_h, _ = weak.build_step(**kw, device="cpu")
    got = step_c(st_c).cpu().numpy()
    want = step_h(st_h).numpy()
    own = dec.owned_mask()
    assert compare_arrays(got[own], want[own], 1e-5)


def test_strong_step_on_card_validates(cuda):
    kw = dict(dom=(32, 32, 32), sdom=(16, 16, 32), bdim=(4, 4, 32),
              stencil="s7pt", st_iter=4, fuse=2)
    step, storage, plan, g = strong.build_step(**kw, device=cuda)
    assert strong.validate_step(step, storage, plan, g, "s7pt", 4)


def _table_2d(gy, periodic):
    t = np.arange(gy, dtype=np.int32)
    if periodic:
        t[0], t[-1] = t[-2], t[1]
    return t


@pytest.mark.parametrize("name,fuse,by,X,periodic,y_range", [
    ("box9", 1, 32, 256, True, None), ("box9", 4, 32, 256, True, None),
    ("lin5", 2, 8, 64, False, (0, 6)), ("asym9", 2, 4, 48, False, (0, 6)),
    ("asym9", 1, 8, 16, False, None), ("wave", 1, 8, 128, False, (0, 6))])
def test_sweep_2d_kernel_matches_plain(cuda, name, fuse, by, X, periodic,
                                       y_range):
    table = _table_2d(6, periodic)
    fn = pencil_sweep_2d(BUILDERS[name](st), table, (by, X), 6, PARAMS,
                         y_range=y_range, fuse=fuse)
    nf = len(fn.plan.fields)
    xs = [torch.rand((6, by, X), generator=torch.Generator().manual_seed(
        20 + f)).to(cuda) for f in range(nf)]
    before = pencil_sweep_2d_kernel.launches
    got = fn(*xs)
    assert pencil_sweep_2d_kernel.launches == before + 1
    want = pencil_sweep_2d_plain(xs, torch.from_numpy(fn.plan.table).to(cuda),
                                 fn.plan)
    got = got if isinstance(got, tuple) else (got,)
    w = fn.plan.written_bricks()
    for g, wv in zip(got, want):
        assert compare_arrays(g.cpu().numpy()[w], wv.cpu().numpy()[w], 1e-5)


def test_sweep_2d_kernel_refuses_nonlinear_stencils(cuda):
    fn = pencil_sweep_2d(BUILDERS["nonlin"](st), np.arange(6), (4, 16), 6)
    with pytest.raises(NotImplementedError, match="nonlinear"):
        fn(torch.zeros((6, 4, 16), device=cuda))


@pytest.mark.parametrize("name,kw", [
    ("box9", dict(dims=(128, 64), st_iter=4)),
    ("wave", dict(dims=(64, 32), field=("p", "v"), st_iter=2)),
    ("s7pt", dict(dims=(16, 16, 32), st_iter=4)),
    ("mpi9pt", dict(dims=(4, 16, 16, 16), st_iter=2))])
def test_problem_on_card_matches_cpu(cuda, name, kw):
    sd = BUILDERS[name](st) if name in BUILDERS else name
    got = Problem(stencil=sd, device=cuda, **kw).init(seed=3).step(2)
    want = Problem(stencil=sd, device="cpu", **kw).init(seed=3).step(2)
    a, b = got.result(), want.result()
    for k in (a if isinstance(a, dict) else [None]):
        x, y = (a[k], b[k]) if k else (a, b)
        assert compare_arrays(x, y, 1e-5) and np.isfinite(x).all()
