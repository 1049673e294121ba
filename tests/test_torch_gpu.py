"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA card.
The file imports no JAX, so it also runs on a machine without JAX, where
``tests/conftest.py`` (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

K1 (also batched over a subdomain stack), K4 (also batched over the ranks
of a card, at the table's k edges, through its generic body and at other
footprints), K6 and K8 (also at other footprints of their streaming
blocks, K8 through its compiled layout and its generic body) are compared
on the bricks they write, K7 on the
whole padded array, at abs-or-rel 1e-5 (FMA contraction and summation
order); K2, K3, K5, K9 and K10 only copy, so they must be bit-exact.  The
remote-copy kernels run with four (K9) and two (K10) ranks on one card,
and across two cards where the machine has them.  K11 (the PUT exchange
fused into the sweep) must equal the PUT exchange followed by K1 bit for
bit, and its plain version at abs-or-rel 1e-5 (bit for bit on the
exchanged storage), on four ranks of one card and across two cards.
K1's register-streaming body (the star at fuse 2 to 4) must equal its
ring body and ``fuse`` single-level launches bit for bit.  On i-bricked
tables (cubic strong subdomains) K1 is compared with its plain version at
abs-or-rel 1e-5, and its two bodies with each other bit for bit; the
cubic strong step is validated against the global dense twin.  K4's
register-streaming body (the 4-D star at fuse 2) must equal its ring body
bit for bit, and its plain version at abs-or-rel 1e-5; the star at fuse 3
and 4 keeps the ring body.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bricklib_tpu_torch import st, trace
from bricklib_tpu_torch.api import Problem
from bricklib_tpu_torch.bench.k4_regimes import mixed_radius
from bricklib_tpu_torch.bench.roofline import copy_storage, copy_storage_plain
from bricklib_tpu_torch.codegen.fused_exchange import (
    brick_rows, fusedx_plain, pencil_sweep_fusedx, pencil_sweep_fusedx_kernel)
from bricklib_tpu_torch.codegen.dense_kernel import (dense_stencil,
                                                     dense_stencil_kernel,
                                                     dense_stencil_plain,
                                                     launch_dense)
from bricklib_tpu_torch.codegen.mxu_kernel import (launch_mxu,
                                                   mxu_footprint,
                                                   pencil_sweep_mxu,
                                                   pencil_sweep_mxu_kernel,
                                                   pencil_sweep_mxu_plain)
from bricklib_tpu_torch.codegen.pencil_kernel import (SweepPlan,
                                                      _launch_stream,
                                                      brick_cols,
                                                      launch_regstream,
                                                      pencil_sweep,
                                                      pencil_sweep_kernel,
                                                      pencil_sweep_plain,
                                                      quad_stores,
                                                      regstream_smem,
                                                      stream_smem)
from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
    launch_2d, pencil_sweep_2d, pencil_sweep_2d_kernel, pencil_sweep_2d_plain,
    row_footprint)
from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
    K4_SMEM_BUDGET, REGSTREAM4_ROW_WIDTHS, REGSTREAM4_THREADS, launch_4d,
    launch_regstream_4d, pencil_sweep_4d, pencil_sweep_4d_kernel,
    regstream4_footprint, regstream_plan_4d, stream4_footprint,
    stream_plan_4d)
from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu_torch.comm.exchange import (copy_intervals,
                                              copy_intervals_plain,
                                              copy_rows_plain, copy_stages,
                                              copy_stages_plain, pool_plan,
                                              put_exchange, put_plan,
                                              remote_copy, rows_table,
                                              shift_exchange,
                                              shift_remote_exchange)
from bricklib_tpu_torch.comm.mesh import make_domain_mesh, rank_views
from bricklib_tpu_torch.comm.strong import (StrongDecomp, stage_copy,
                                            stage_copy_plain,
                                            strong_remote_copy,
                                            strong_remote_exchange,
                                            strong_stages)
from bricklib_tpu_torch.core import (compare_arrays, init_grid, random_array,
                                     random_storage)
from bricklib_tpu_torch.drivers import strong, weak
from bricklib_tpu_torch.ooc import ooc_sweep
from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

from torch_2d_stencils import BUILDERS, PARAMS, two_inputs_3d
from torch_nd_stencils import star_nd

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
    # every stage is local: one group, one launch for all of them
    assert len(ex.groups) == 1
    assert copy_intervals.launches == before + 1
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


def _k4_check(cuda, fn, x, sp=None):
    """K4 (``sp``: a launch other than the planner's) against its plain
    version on the bricks it writes, at abs-or-rel 1e-5."""
    before = pencil_sweep_4d_kernel.launches
    table = torch.from_numpy(fn.plan.table).to(cuda)
    got = fn(x) if sp is None else launch_4d(x, table, fn.plan, sp)
    assert pencil_sweep_4d_kernel.launches == before + 1
    want = pencil_sweep_plain(x, table, fn.plan)
    torch.cuda.synchronize()
    w = fn.plan.written_bricks()
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


@pytest.mark.parametrize("fuse", [1, 2, 3])
@pytest.mark.parametrize("edges", ["low", "high", "both"])
def test_sweep_4d_kernel_at_table_edges(cuda, fuse, edges):
    """K4 with k ranges that start at 0 and end at GK on a non-periodic
    table (the blocks there store the intermediate levels' clamped rows),
    at F 1 to 3, ghost-inclusive in w and j."""
    dec = _dec4()
    G = dec.grid.shape[:3]
    kr = {"low": (0, 1), "high": (G[1] - 1, G[1]), "both": (0, G[1])}[edges]
    fn = pencil_sweep_4d("mpi9pt", dec.grid, dec.bdims, dec.nbricks,
                         bench_params(), fuse=fuse, w_range=(0, G[0]),
                         k_range=kr, j_range=(0, G[2]))
    _k4_check(cuda, fn, random_storage(dec, seed=30, device=cuda))


@pytest.mark.parametrize("fuse,periodic", [(1, False), (2, False),
                                           (2, True)])
def test_sweep_4d_kernel_generic_taps(cuda, fuse, periodic):
    """A tap list other than the 4-D star runs K4's generic body."""
    dec = BrickDecomp(dims=(4, 8, 8, 16), ghost_depth=(2, 4, 4, 0),
                      bdims=(2, 4, 4, 16)).initialize(
        skinlist_by_name("good", 4))
    G = dec.grid.shape[:3]
    kw = ({} if periodic else
          dict(w_range=(0, G[0]), k_range=(0, G[1]), j_range=(0, G[2])))
    grid = dec.periodic_grid((0, 1, 2, 3)) if periodic else dec.grid
    fn = pencil_sweep_4d(mixed_radius(), grid, dec.bdims, dec.nbricks, {},
                         fuse=fuse, **kw)
    _k4_check(cuda, fn, random_storage(dec, seed=31, device=cuda))


@pytest.mark.parametrize("wch,pk,pj,ti,d,skew", [
    (1, 1, 1, 4, 1, 0), (2, 2, 3, 8, 2, 2), (4, 1, 2, 16, 1, 6),
    (3, 2, 2, 16, 2, 0)])
def test_sweep_4d_kernel_footprints(cuda, wch, pk, pj, ti, d, skew):
    """K4 at footprints other than the planner's (w chunks, k brick rows
    and pencils per block, i tiles, lookahead, skewed levels), F = 3 over
    every brick of the table."""
    dec = _dec4()
    G = dec.grid.shape[:3]
    fn = pencil_sweep_4d("mpi9pt", dec.grid, dec.bdims, dec.nbricks,
                         bench_params(), fuse=3, w_range=(0, G[0]),
                         k_range=(0, G[1]), j_range=(0, G[2]))
    sp = stream4_footprint(fn.plan, wch, pk, pj, ti, d, skew)
    _k4_check(cuda, fn, random_storage(dec, seed=32, device=cuda), sp)


def test_sweep_4d_kernel_refuses_too_little_shared_memory(cuda,
                                                          monkeypatch):
    """The C entry point refuses a launch whose shared memory is smaller
    than its block's layout."""
    import dataclasses

    from bricklib_tpu_torch.codegen import pencil_kernel_4d

    dec = _dec4()
    fn = pencil_sweep_4d("mpi9pt", dec.periodic_grid((0, 1, 2, 3)),
                         dec.bdims, dec.nbricks, bench_params(), fuse=2)
    x = random_storage(dec, seed=33, device=cuda)
    sp = stream_plan_4d(fn.plan)
    short = dataclasses.replace(sp, smem_bytes=sp.smem_bytes - 8)
    monkeypatch.setattr(pencil_kernel_4d, "stream4_footprint",
                        lambda *a: short)
    table = torch.from_numpy(fn.plan.table).to(cuda)
    with pytest.raises(RuntimeError, match="pencil_sweep_4d"):
        launch_4d(x, table, fn.plan, sp)
    monkeypatch.undo()
    _k4_check(cuda, fn, x)


@pytest.mark.parametrize("dims", [(4, 16, 16, 16), (8, 16, 16, 64)])
def test_4d_problem_on_card_matches_cpu(cuda, dims):
    """``Problem`` at rank 4 (K4 on the card, its plain version on the
    CPU) at the tiny shape of ``tests/test_torch_problem.py`` and the small
    one of ``chip_smoke.py``, two steps."""
    g = random_array(dims, np.float32, 34)
    got = Problem(dims=dims, stencil="mpi9pt", st_iter=2,
                  device=cuda).init(array=g).step(2).result()
    want = Problem(dims=dims, stencil="mpi9pt", st_iter=2,
                   device="cpu").init(array=g).step(2).result()
    assert np.isfinite(got).all()
    assert compare_arrays(got, want, 1e-5)


def _rs4_check(cuda, fn, x, rp=None):
    """K4 through its register-streaming body (``rp``: another footprint
    than the planner's) counts one K4 launch and one ``k4_regstream``,
    and equals its ring body (``launch_4d`` at the ring planner's
    footprint) bit for bit and its plain version at abs-or-rel 1e-5 on
    every brick it writes."""
    plan = fn.plan
    table = torch.from_numpy(plan.table).to(cuda)
    if rp is None:
        assert regstream_plan_4d(plan) is not None
    before = trace.counters()
    got = fn(x) if rp is None else launch_regstream_4d(x, table, plan, rp)
    after = trace.counters()
    assert after["k4_regstream"] - before["k4_regstream"] == 1
    assert after["K4"] - before["K4"] == 1
    ring = launch_4d(x, table, plan, None)
    want = pencil_sweep_plain(x, table, plan)
    torch.cuda.synchronize()
    w = torch.from_numpy(plan.written_bricks()).to(cuda)
    assert torch.equal(got[w], ring[w])
    assert compare_arrays(got[w].cpu().numpy(), want[w].cpu().numpy(), 1e-5)


def _ring4_check(cuda, fn, x):
    """The 4-D star at a depth the register-streaming body does not
    compile: one K4 launch through the ring body (no ``k4_regstream``),
    ``launch_4d``'s output bit for bit and its plain version's at
    abs-or-rel 1e-5 on every brick it writes."""
    plan = fn.plan
    table = torch.from_numpy(plan.table).to(cuda)
    assert regstream_plan_4d(plan) is None
    before = trace.counters()
    got = fn(x)
    after = trace.counters()
    assert after["k4_regstream"] == before["k4_regstream"]
    assert after["K4"] - before["K4"] == 1
    ring = launch_4d(x, table, plan, None)
    want = pencil_sweep_plain(x, table, plan)
    torch.cuda.synchronize()
    w = torch.from_numpy(plan.written_bricks()).to(cuda)
    assert torch.equal(got[w], ring[w])
    assert compare_arrays(got[w].cpu().numpy(), want[w].cpu().numpy(), 1e-5)


def _rs4_sweep(region, fuse, dims=(8, 8, 8, 16), bd=(4, 4, 4, 16),
               batch=1):
    """The 4-D star at ``fuse`` over ``region`` of a table with a ghost
    brick a side: ``ghost`` (every brick: both k edges), ``owned``,
    ``periodic``, ``low-edge`` / ``high-edge`` (one k brick row at that
    edge, ghost-inclusive in w and j); ``batch`` ranks stacked."""
    dec = BrickDecomp(dims=dims, ghost_depth=bd[:3] + (0,),
                      bdims=bd).initialize(skinlist_by_name("good", 4))
    G = dec.grid.shape[:3]
    grid = dec.periodic_grid((0, 1, 2, 3)) if region == "periodic" \
        else dec.grid
    whole = dict(w_range=(0, G[0]), k_range=(0, G[1]), j_range=(0, G[2]))
    kw = {"ghost": whole, "owned": {}, "periodic": {},
          "low-edge": dict(whole, k_range=(0, 1)),
          "high-edge": dict(whole, k_range=(G[1] - 1, G[1]))}[region]
    if batch > 1:
        kw = dict(kw, batch=batch, batch_stride=dec.nbricks)
    fn = pencil_sweep_4d("mpi9pt", grid, bd, batch * dec.nbricks,
                         bench_params(), fuse=fuse, **kw)
    return dec, fn


@pytest.mark.parametrize("region", ["ghost", "owned", "periodic",
                                    "low-edge", "high-edge"])
def test_regstream_4d_kernel_is_the_ring_body_bit_for_bit(cuda, region):
    """K4's register-streaming body (fuse 2) against its ring body and its
    plain version at the tiny 4-D shape: ghost-inclusive (both k edges),
    owned, periodic and one k edge alone."""
    dec, fn = _rs4_sweep(region, 2)
    _rs4_check(cuda, fn, random_storage(dec, seed=52, device=cuda))


@pytest.mark.parametrize("region", ["ghost", "owned"])
def test_regstream_4d_kernel_batch_3(cuda, region):
    """The register-streaming body over three ranks stacked."""
    dec, fn = _rs4_sweep(region, 2, batch=3)
    x = torch.from_numpy(random_array((3 * dec.nbricks,) + dec.bdims,
                                      np.float32, 53)).to(cuda)
    _rs4_check(cuda, fn, x)


@pytest.mark.parametrize("fuse", [3, 4])
@pytest.mark.parametrize("region,batch", [
    ("ghost", 1), ("owned", 1), ("periodic", 1), ("low-edge", 1),
    ("high-edge", 1), ("ghost", 3)])
def test_4d_star_at_fuse_3_and_4_keeps_the_ring_body(cuda, region, batch,
                                                     fuse):
    """The 4-D star at fuse 3 and 4 runs the ring body's fused star
    (``LayoutStar9``), held against its plain version: ghost-inclusive,
    owned, periodic, each k edge alone, three ranks stacked."""
    dec, fn = _rs4_sweep(region, fuse, batch=batch)
    x = torch.from_numpy(random_array((batch * dec.nbricks,) + dec.bdims,
                                      np.float32, 50 + fuse)).to(cuda)
    _ring4_check(cuda, fn, x)


@pytest.mark.parametrize("fuse,region", [
    (2, "ghost"), (2, "owned"), (2, "periodic"), (3, "ghost"),
    (4, "owned")])
def test_regstream_4d_kernel_at_the_step_shape(cuda, fuse, region):
    """The weak 4-D step's shape (16x64x128x512, bricks (4, 8, 8,
    512)): the step's two sweeps (fuse 2) take the register-streaming
    body (i tiles of 32 lanes, row width 40); at fuse 3 and 4 the sweep
    keeps the ring body, held against its plain version."""
    dec, fn = _rs4_sweep(region, fuse, (16, 64, 128, 512), (4, 8, 8, 512))
    x = random_storage(dec, seed=54, device=cuda)
    if fuse == 2:
        rp = regstream_plan_4d(fn.plan)
        assert (rp.pk, rp.pj, rp.ti, rp.rw) == (1, 1, 32, 40)
        _rs4_check(cuda, fn, x)
    else:
        _ring4_check(cuda, fn, x)


def test_regstream_4d_kernel_ragged_footprints(cuda):
    """The register-streaming body at footprints other than the planner's:
    w chunks and k groups that do not divide the ranges, two pencils of
    bricks 4 wide, i tiles of 4 to 32 lanes in the compiled row width,
    lookahead 1 to 3, and storage that is not 16-byte aligned (pieces of
    one float)."""
    dec, fn = _rs4_sweep("ghost", 2, (12, 12, 8, 32), (4, 4, 4, 32))
    plan = fn.plan
    x = random_storage(dec, seed=55, device=cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    odd = flat[1:].view(x.shape)
    odd.copy_(x)
    assert odd.data_ptr() % 16 != 0
    n, rw = 0, REGSTREAM4_ROW_WIDTHS[0]
    for wch, pk, pj, ti, d, st in ((2, 2, 2, 4, 2, x), (3, 3, 1, 8, 1, x),
                                   (4, 1, 2, 16, 3, odd),
                                   (1, 2, 1, 32, 1, odd),
                                   (2, 1, 1, 8, 1, odd),
                                   (3, 1, 2, 8, 2, x)):
        v = regstream4_footprint(plan, wch, pk, pj, ti, rw, d)
        if (v.items() > REGSTREAM4_THREADS or ti + 2 * v.h > rw
                or v.smem_bytes > K4_SMEM_BUDGET):
            continue
        _rs4_check(cuda, fn, st, v)
        n += 1
    assert n >= 3


def test_regstream_4d_counter_moves_once_per_new_body_launch(cuda):
    """``k4_regstream`` moves by one for each launch of the new body and
    not for K4's other launches (fuse 1 and 4, generic taps), while ``K4``
    counts them all."""
    dec, _ = _rs4_sweep("owned", 2)
    x = random_storage(dec, seed=56, device=cuda)
    generic = BrickDecomp(dims=(4, 8, 8, 16), ghost_depth=(2, 4, 4, 0),
                          bdims=(2, 4, 4, 16)).initialize(
        skinlist_by_name("good", 4))
    xg = random_storage(generic, seed=57, device=cuda)
    for fuse, n in ((2, 1), (4, 0), (1, 0)):
        _, fn = _rs4_sweep("owned", fuse)
        before = trace.counters()
        fn(x)
        fn(x)
        after = trace.counters()
        assert after["k4_regstream"] - before["k4_regstream"] == 2 * n
        assert after["K4"] - before["K4"] == 2
    fn = pencil_sweep_4d(mixed_radius(), generic.grid, generic.bdims,
                         generic.nbricks, {}, fuse=2)
    before = trace.counters()
    fn(xg)
    after = trace.counters()
    assert after["k4_regstream"] == before["k4_regstream"]
    assert after["K4"] - before["K4"] == 1
    torch.cuda.synchronize()


def test_regstream_4d_kernel_refuses_too_little_shared_memory(cuda):
    """The register-streaming body's C entry point refuses a launch whose
    shared memory is smaller than its block's layout."""
    dec, fn = _rs4_sweep("periodic", 2)
    x = random_storage(dec, seed=58, device=cuda)
    rp = regstream_plan_4d(fn.plan)
    short = dataclasses.replace(rp, smem_bytes=rp.smem_bytes - 8)
    table = torch.from_numpy(fn.plan.table).to(cuda)
    with pytest.raises(RuntimeError, match="pencil_sweep_regstream_4d"):
        launch_regstream_4d(x, table, fn.plan, short)
    _rs4_check(cuda, fn, x)


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


@pytest.mark.parametrize("fuse,launches", [(4, 3), (1, 9)])
def test_step_launches_and_spans_on_card(cuda, fuse, launches, tmp_path):
    """One weak step launches K2 once and ``8 / fuse`` K1 sweeps (the
    program's counters), and in a profiled step every K1 and K2 kernel
    lies under a ``bricklib.sweep`` or ``bricklib.exchange`` span."""
    import json

    from bricklib_tpu_torch import trace

    step, x, _dec = weak.build_step(**dict(STEP, fuse=fuse), device=cuda)
    x = step(x)
    torch.cuda.synchronize()
    before = trace.counters()
    x = step(x)
    after = trace.counters()
    assert sum(after[k] - before[k] for k in trace.KERNELS) == launches
    assert after["K2"] - before["K2"] == 1
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof, trace.tracing():
        x = step(x)
        torch.cuda.synchronize()
    trace.records()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    times = trace.span_times(events)
    assert times["bricklib.sweep"][0] == launches - 1
    assert times["bricklib.exchange"][0] == 1
    xs = [e for e in events if e.get("ph") == "X"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                   if e.get("cat", "").lower() == "user_annotation"
                   and e["name"].startswith("bricklib."))
    launch = {e["args"]["correlation"]: e["ts"] for e in xs
              if e.get("cat", "").lower() in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    kernels = [e for e in xs if e.get("cat", "").lower() == "kernel"
               and ("pencil_sweep" in e["name"] or "copy_pool" in e["name"])]
    assert len(kernels) == launches
    for k in kernels:
        t = launch[k["args"]["correlation"]]
        under = trace.innermost(spans, [sp[0] for sp in spans], t)
        assert under == ("bricklib.exchange" if "copy_pool" in k["name"]
                         else "bricklib.sweep"), k["name"]


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


@pytest.mark.parametrize("name,fuse,by,X,gy,y_range", [
    ("box9", 4, 32, 512, 10, None), ("box9", 3, 4, 256, 40, (0, 40)),
    ("asym9", 2, 8, 128, 9, (0, 9)), ("wave", 1, 8, 128, 12, (0, 12))])
@pytest.mark.parametrize("fp", [(1, 32, 1, 8), (3, 64, 2, 8), (2, 32, 2, 16),
                                (8, 128, 1, 16), (2, 120, 1, 8),
                                (1, 248, 1, 16)])
def test_sweep_2d_kernel_footprints_match_plain(cuda, name, fuse, by, X, gy,
                                                y_range, fp):
    """K6's y-streaming body at other footprints (brick rows per chunk, x
    tile, lookahead, rows per group): chunks of several brick rows, groups
    across bricks, both table edges (ghost-inclusive y_range), the wave
    system's two level-0 rings, x tiles that end past X with the box's row
    widths compiled in (tiles 120 and 248: rows of 128 and 256); each
    equal to the plain version, and every footprint to every other bit for
    bit."""
    ych, tx, d, g = fp
    table = _table_2d(gy, y_range is None)
    fn = pencil_sweep_2d(BUILDERS[name](st), table, (by, X), gy, PARAMS,
                         y_range=y_range, fuse=fuse)
    plan = fn.plan
    xs = [torch.rand((gy, by, X), generator=torch.Generator().manual_seed(
        30 + f)).to(cuda) for f in range(len(plan.fields))]
    tab = torch.from_numpy(plan.table).to(cuda)
    got = launch_2d(xs, tab, plan, row_footprint(plan, ych, tx, d, g))
    ref = launch_2d(xs, tab, plan, None)
    want = pencil_sweep_2d_plain(xs, tab, plan)
    w = plan.written_bricks()
    for a, r, b in zip(got, ref, want):
        assert torch.equal(a[w], r[w])
        assert compare_arrays(a.cpu().numpy()[w], b.cpu().numpy()[w], 1e-5)


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


@pytest.mark.parametrize("name,bd", [
    ("s7pt", (2, 2, 8)), ("mpi13pt", (4, 4, 8)), ("mpi125pt", (4, 4, 8)),
    ("mpi25pt", (4, 8, 8)), ("mpi125pt", (8, 8, 256)), ("s27pt", (5, 3, 24))])
@pytest.mark.parametrize("ranges", ["skip", "ghost"])
def test_mxu_kernel_matches_plain(cuda, name, bd, ranges):
    grid, info = init_grid((5, 4, 1))
    grid = np.asarray(grid)
    kw = {} if ranges == "skip" else dict(k_range=(0, 5), j_range=(0, 4))
    fn = pencil_sweep_mxu(stencil_by_name(name)[0], grid, bd, info.nbricks,
                          bench_params(), **kw)
    x = torch.from_numpy(random_array(
        (info.nbricks, bd[0], bd[1] * bd[2]), np.float32, 9)).to(cuda)
    before = pencil_sweep_mxu_kernel.launches
    got = fn(x)
    assert pencil_sweep_mxu_kernel.launches == before + 1
    want = pencil_sweep_mxu_plain(
        x, torch.from_numpy(fn.plan.table).to(cuda), fn.plan)
    w = fn.plan.written_bricks()
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


@pytest.mark.parametrize("name,params", [
    ("mpi125pt", {}), ("mpi125pt", {"MPI_C9": 0.0}), ("mpi25pt", {}),
    ("s7pt", {})])
@pytest.mark.parametrize("fp", [(1, 1, 1, 2), (2, 3, 2, 1), (4, 2, 1, 2),
                                (3, 2, 3, 2)])
def test_mxu_kernel_footprints_match_plain(cuda, name, params, fp):
    """K8's k-streaming body at other footprints (brick rows per chunk,
    pencils, lane chunks, lookahead) over every brick of a 64^3 exchange
    table (both table edges clamp): the compiled layout (mpi125pt), the
    generic body (a zero coefficient, other folded forms); each equal to
    the plain version, and to the planner's footprint bit for bit."""
    dec = BrickDecomp(dims=(64, 64, 64), ghost_depth=(8, 8, 0),
                      bdims=(8, 8, 64)).initialize(skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    fn = pencil_sweep_mxu(name, dec.grid, dec.bdims, dec.nbricks,
                          dict(bench_params(), **params), k_range=(0, GK),
                          j_range=(0, GJ))
    plan = fn.plan
    assert plan.layout() == (name == "mpi125pt" and not params)
    x = torch.from_numpy(random_array((dec.nbricks, 8, 8 * 64), np.float32,
                                      11)).to(cuda)
    tab = torch.from_numpy(plan.table).to(cuda)
    kch, pj, nwc, d = fp
    # the lane chunks' output lanes a multiple of the 16-byte pieces
    nwc *= 1 + (nwc * plan.stream().ow) % 4 // 2
    got = launch_mxu(x, tab, plan, mxu_footprint(plan, kch, pj, nwc, d))
    ref = launch_mxu(x, tab, plan, None)
    want = pencil_sweep_mxu_plain(x, tab, plan)
    w = plan.written_bricks()
    assert torch.equal(got[w], ref[w])
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


def test_mxu_kernel_matches_the_pencil_sweep(cuda):
    dec = _dec()
    grid = dec.periodic_grid((0, 1, 2))
    x = random_storage(dec, seed=10, device=cuda)
    mx = pencil_sweep_mxu("mpi125pt", grid, BD, dec.nbricks, bench_params())
    cl = pencil_sweep("mpi125pt", grid, BD, dec.nbricks, bench_params())
    got = mx(x.view(dec.nbricks, BD[0], -1)).view_as(x)
    w = mx.plan.written_bricks()
    assert compare_arrays(got.cpu().numpy()[w], cl(x).cpu().numpy()[w], 1e-5)


@pytest.mark.parametrize("name,shape,pad", [
    ("mpi13pt", (24, 32, 128), (4, 8, 48)), ("two", (12, 24, 128), (2, 8, 48)),
    ("s27pt", (10, 24, 128), (1, 8, 40)), ("s7pt", (11, 24, 256), (1, 8, 64))])
def test_dense_kernel_matches_plain(cuda, name, shape, pad):
    sd = two_inputs_3d(st) if name == "two" else stencil_by_name(name)[0]
    fn = dense_stencil(sd, shape, pad, bench_params())
    arrs = [torch.from_numpy(random_array(shape, np.float32, 5 + f)).to(cuda)
            for f in range(len(fn.plan.fields))]
    before = dense_stencil_kernel.launches
    got = fn(*arrs)
    assert dense_stencil_kernel.launches == before + 1
    want = dense_stencil_plain(arrs, fn.plan)
    assert compare_arrays(got.cpu().numpy(), want.cpu().numpy(), 1e-5)


@pytest.mark.parametrize("name,shape,pad,foot", [
    # (k chunk, j rows, i lanes, planes ahead) of the streaming blocks
    ("s7pt", (14, 40, 256), (1, 8, 64), (4, 8, 64, 2)),
    ("s7pt", (14, 40, 256), (1, 8, 64), (12, 24, 256, 1)),
    ("s7pt", (14, 40, 128), (1, 8, 64), (5, 4, 128, 2)),    # one i tile
    ("mpi7pt", (3, 24, 128), (1, 8, 64), (1, 8, 32, 2)),    # NK < ring
    ("mpi13pt", (24, 32, 128), (4, 8, 48), (3, 12, 32, 1)),
    ("mpi13pt", (24, 32, 128), (4, 8, 48), (16, 16, 128, 2)),
    ("two", (12, 24, 128), (2, 8, 48), (2, 4, 64, 2)),
    ("s27pt", (10, 24, 128), (1, 8, 40), (3, 8, 128, 1))])
def test_dense_kernel_footprints(cuda, name, shape, pad, foot):
    """K7's streaming body (the compiled star for s7pt and mpi7pt, the
    generic body otherwise) at footprints other than the planner's."""
    sd = two_inputs_3d(st) if name == "two" else stencil_by_name(name)[0]
    fn = dense_stencil(sd, shape, pad, bench_params())
    kch, tj, ti, d = foot
    sp = dataclasses.replace(fn.plan.stream(), kch=kch, tj=tj, ti=ti, d=d)
    arrs = [torch.from_numpy(random_array(shape, np.float32, 9 + f)).to(cuda)
            for f in range(len(fn.plan.fields))]
    got = launch_dense(arrs, fn.plan, sp)
    want = dense_stencil_plain(arrs, fn.plan)
    assert compare_arrays(got.cpu().numpy(), want.cpu().numpy(), 1e-5)
    assert torch.equal(got, fn(*arrs))   # the same sums at any footprint


def test_exchange_pool_epochs_and_interleaved_plans(cuda):
    """K2 run again on one plan (its counters carry on from launch to
    launch) and two plans on one storage in turns, bit for bit against
    the plain version."""
    dec = BrickDecomp(dims=(16, 16, 32), ghost_depth=(4, 4, 8),
                      bdims=(4, 4, 8)).initialize(
        skinlist_by_name("good", 3))
    ex = shift_exchange(dec, (1, 1, 1))
    assert len(ex.stages) == 3 and len(ex.groups) == 1
    a = random_storage(dec, seed=21, device=cuda)
    b = a.clone()
    both = pool_plan(ex.stages, a)
    first = pool_plan(ex.stages[:1], a)
    before = copy_intervals.launches
    for _ in range(3):
        copy_stages(a, ex.stages, both)
        copy_stages(a, ex.stages[:1], first)
        copy_stages_plain(b, ex.stages)
        copy_stages_plain(b, ex.stages[:1])
        torch.cuda.synchronize()
        assert torch.equal(a, b)
    assert copy_intervals.launches == before + 6


@pytest.mark.parametrize("name,params,layout", [
    ("mpi125pt", {}, 1), ("mpi125pt", {"MPI_C9": 0.0}, 0),
    ("mpi25pt", {}, 0)])
def test_k8_layout_counter_moves_once_per_compiled_layout_launch(
        cuda, name, params, layout):
    """``k8_layout`` moves by one for each launch of K8 that runs the
    compiled 125-point layout (mpi125pt with ``bench_params()``), never for
    one of its generic body (a zero coefficient, another folded form),
    while ``K8`` counts them all."""
    dec = BrickDecomp(dims=(32, 32, 64), ghost_depth=(8, 8, 0),
                      bdims=(8, 8, 64)).initialize(skinlist_by_name("good", 3))
    fn = pencil_sweep_mxu(name, dec.periodic_grid((0, 1, 2)), dec.bdims,
                          dec.nbricks, dict(bench_params(), **params))
    x = torch.from_numpy(random_array((dec.nbricks, 8, 8 * 64), np.float32,
                                      13)).to(cuda)
    before = trace.counters()
    fn(fn(x))
    after = trace.counters()
    assert after["K8"] - before["K8"] == 2
    assert after["k8_layout"] - before["k8_layout"] == 2 * layout
    torch.cuda.synchronize()


def test_dense_kernel_refuses_nonlinear_stencils(cuda):
    fn = dense_stencil("cond", (10, 24, 128), (1, 8, 40), bench_params())
    with pytest.raises(NotImplementedError, match="nonlinear"):
        fn(torch.zeros((10, 24, 128), device=cuda))


def test_mxu_problem_on_card_matches_cpu(cuda):
    kw = dict(dims=(16, 16, 32), stencil="mpi125pt", bdims=(4, 4, 32),
              backend="mxu", st_iter=2)
    got = Problem(device=cuda, **kw).init(seed=3).step(2).result()
    want = Problem(device="cpu", **kw).init(seed=3).step(2).result()
    assert compare_arrays(got, want, 1e-5) and np.isfinite(got).all()


def test_ooc_sweep_on_card_matches_cpu(cuda):
    g = random_array((40, 16, 256), np.float32, 7)
    stats, cpu_stats = {}, {}
    before = dense_stencil_kernel.launches
    got = ooc_sweep(g, "mpi13pt", bench_params(), iters=2, slab_rows=12,
                    stats=stats, device=cuda)
    assert dense_stencil_kernel.launches == before + 2 * stats["slabs"]
    want = ooc_sweep(g, "mpi13pt", bench_params(), iters=2, slab_rows=12,
                     stats=cpu_stats, device="cpu")
    assert stats["slabs"] == 4
    for k in ("slabs", "h2d_bytes", "d2h_bytes"):
        assert stats[k] == cpu_stats[k]
    assert compare_arrays(got, want, 1e-5)
    np.testing.assert_array_equal(g, random_array((40, 16, 256), np.float32,
                                                  7))


@pytest.mark.parametrize("skip", [0, 1])
def test_batched_sweep_4d_kernel_matches_plain(cuda, skip):
    dec = _dec4()
    G = dec.grid.shape[:3]
    x = torch.rand((3 * dec.nbricks,) + dec.bdims,
                   generator=torch.Generator().manual_seed(9)).to(cuda)
    fn = pencil_sweep_4d("mpi9pt", dec.grid, dec.bdims, 3 * dec.nbricks,
                         bench_params(), fuse=2, batch=3,
                         batch_stride=dec.nbricks,
                         **{f"{a}_range": (skip, n - skip)
                            for a, n in zip("wkj", G)})
    got = fn(x)
    want = pencil_sweep_plain(x, torch.from_numpy(fn.plan.table).to(cuda),
                              fn.plan)
    w = fn.plan.written_bricks()
    assert len(w) == 3 * int(np.prod([n - 2 * skip for n in G]))
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


def _remote_cases(devices_weak, devices_strong):
    """The K9 exchange of a 32^3-per-rank weak mesh (2, 2, 1) and the K10
    exchange of a strong mesh (2, 1, 1), with random state."""
    dec = _dec()
    wmesh = make_domain_mesh((2, 2, 1), devices=devices_weak)
    plan = StrongDecomp(dom=(64, 32, 32), sdom=(16, 16, 32),
                        mesh_shape=(2, 1, 1), bdims=(4, 4, 32),
                        ghost_depth=(4, 4, 0)).initialize(
        skinlist_by_name("good", 3))
    smesh = make_domain_mesh((2, 1, 1), devices=devices_strong)
    gen = torch.Generator().manual_seed(11)

    def state(mesh, shape):
        return [torch.rand((len(mesh.ranks_on(c)),) + shape,
                           generator=gen).to(d)
                for c, d in enumerate(mesh.cards)]

    return [(remote_copy, shift_remote_exchange(dec, wmesh, table_axes=(2,)),
             state(wmesh, (dec.nbricks,) + BD)),
            (strong_remote_copy, strong_remote_exchange(plan, smesh),
             state(smesh, (plan.nsub_local, plan.sdec.nbricks)
                   + plan.bdims))]


def _check_remote(kernel, ex, state):
    a = [t.clone() for t in state]
    b = [t.clone() for t in state]
    before = kernel.launches
    ex(a)
    assert kernel.launches == before + sum(
        1 for per_card in ex.plan for rows in per_card if rows)
    flats = [t.view((-1,) + tuple(t.shape[-3:])) for t in b]
    for per_card in ex.plan:
        for rows in per_card:
            copy_rows_plain(flats, rows)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, state))


def test_remote_copy_kernels_match_plain(cuda):
    for kernel, ex, state in _remote_cases([cuda] * 4, [cuda] * 2):
        _check_remote(kernel, ex, state)


def test_remote_copy_table_checks_rows_for_other_storages(cuda):
    """A row table skips the per-row checks only on the storage sizes it
    was made for."""
    flats = [torch.zeros((10, 4, 4), device=cuda),
             torch.ones((6, 4, 4), device=cuda)]
    rows = [(0, 8, 1, 4, 2)]
    table = rows_table(rows, flats, 0)
    remote_copy(flats, 0, rows, table)
    torch.cuda.synchronize()
    assert flats[0][8:].eq(1).all() and flats[0][:8].eq(0).all()
    with pytest.raises(ValueError, match="invalid"):
        remote_copy([flats[0][:9], flats[1]], 0, rows, table)


def test_remote_copy_kernels_across_two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    for kernel, ex, state in _remote_cases(
            ["cuda:0", "cuda:0", "cuda:1", "cuda:1"], ["cuda:0", "cuda:1"]):
        assert len(ex.waits[0]) == 2       # each card waits on the other
        _check_remote(kernel, ex, state)


@pytest.mark.parametrize("exchange", ["shift", "put", "shift-remote"])
def test_mesh_step_on_card_matches_cpu(cuda, exchange):
    kw = dict(STEP, dims=(16, 16, 32), mesh_shape=(2, 2, 1),
              exchange=exchange)
    step_c, st_c, dec = weak.build_step(**kw, devices=[cuda] * 4)
    step_h, st_h, _ = weak.build_step(**kw, device="cpu")
    got = step_c(st_c)[0].cpu().numpy()
    want = step_h(st_h)[0].numpy()
    own = dec.owned_mask()
    assert compare_arrays(got[:, own], want[:, own], 1e-5)


@pytest.mark.parametrize("exchange", ["shift", "remote"])
def test_strong_mesh_step_on_card_validates(cuda, exchange):
    kw = dict(dom=(32, 32, 32), sdom=(8, 16, 32), bdim=(4, 4, 32),
              stencil="s7pt", st_iter=4, fuse=2, mesh_shape=(2, 1, 1),
              exchange=exchange)
    step, state, plan, g = strong.build_step(**kw, devices=[cuda] * 2)
    assert strong.validate_step(step, state, plan, g, "s7pt", 4, step.mesh)
    assert len(rank_views(step.mesh, state)) == 2


def _fused_case(devices, rings=1, ti_narrow=False, name=None):
    """A small (2, 2, 1) mesh for K11: (fused fn, PUT exchange, K1 sweep
    over each card's ranks, random state).  ``ti_narrow``: bricks 256
    wide, two i tiles of 128, and the 13-point star (taps not unrolled);
    ``name``: another stencil."""
    bd = (4, 4, 256) if ti_narrow else (4, 4, 32)
    gz = (4 * rings, 4 * rings, 0)
    dec = BrickDecomp(dims=(24, 16, bd[2]), ghost_depth=gz,
                      bdims=bd).initialize(skinlist_by_name("good", 3))
    mesh = make_domain_mesh((2, 2, 1), devices=devices)
    plan = put_plan(dec, (2, 2, 1), (2,))
    grid = dec.periodic_grid((2,))
    name = name or ("mpi13pt" if ti_narrow else "s7pt")
    fn = pencil_sweep_fusedx(name, grid, bd, dec.nbricks, plan, (2, 2, 1),
                             bench_params(), mesh=mesh)
    (kr, jr) = fn.plan.ranges
    sweeps = {p: pencil_sweep(name, grid, bd, p * dec.nbricks,
                              bench_params(), k_range=kr, j_range=jr,
                              batch=p, batch_stride=dec.nbricks)
              for p in {len(mesh.ranks_on(c)) for c in range(len(mesh.cards))}}
    gen = torch.Generator().manual_seed(12 + rings)
    state = [torch.rand((len(mesh.ranks_on(c)), dec.nbricks) + bd,
                        generator=gen).to(d)
             for c, d in enumerate(mesh.cards)]
    return fn, put_exchange(dec, mesh, (2,)), sweeps, state, dec


def _check_fused(fn, put, sweeps, state, dec):
    b = [t.clone() for t in state]
    c = [t.clone() for t in state]
    before = pencil_sweep_fusedx_kernel.launches
    for _ in range(2):                 # a second epoch reuses the counters
        a = [t.clone() for t in state]
        got, a2 = fn(a)
        assert a2 is a
    assert pencil_sweep_fusedx_kernel.launches == before + 2 * len(a)
    put(b)                             # PUT, then K1 over each card's ranks
    want = [sweeps[t.shape[0]](t.view((-1,) + t.shape[2:])).view(t.shape)
            for t in b]
    flats = [t.view((-1,) + t.shape[2:]) for t in c]
    plain = fusedx_plain(flats, brick_rows(fn.mesh, fn.copies, dec.nbricks),
                         fn.plan,
                         [torch.from_numpy(fn.plan.table).to(t.device)
                          for t in c], dec.nbricks)
    torch.cuda.synchronize()
    w = fn.plan.written_bricks()
    for x, y, z, p, q in zip(a, b, c, got, want):
        assert torch.equal(x, y) and torch.equal(x, z)    # the exchange
        assert torch.equal(p[:, w], q[:, w])              # K11 == PUT + K1
    for p, q in zip(got, plain):
        assert compare_arrays(p.view(q.shape).cpu().numpy()[w],
                              q.cpu().numpy()[w], 1e-5)


@pytest.mark.parametrize("rings,ti_narrow", [(1, False), (2, False),
                                             (1, True)],
                         ids=["rings1", "rings2", "narrow-i-tile"])
def test_fused_exchange_kernel_matches_put_and_k1(cuda, rings, ti_narrow):
    _check_fused(*_fused_case([cuda] * 4, rings, ti_narrow))


@pytest.mark.parametrize("name", ["mpi125pt", "s27pt"])
def test_fused_exchange_kernel_matches_put_and_k1_other_stencils(cuda,
                                                                 name):
    """K11 against the PUT exchange + K1, bit for bit, on the 125-point
    cube (K1's compiled layout: loads shared between taps and rows) and
    the 27-point box (K1's generic body)."""
    _check_fused(*_fused_case([cuda] * 4, name=name))


@pytest.mark.parametrize("kch,pj,ti", [(3, 2, 32), (4, 1, 16)])
def test_fused_exchange_kernel_ghost_rows_mid_stream(cuda, monkeypatch, kch,
                                                     pj, ti):
    """K11 with every stream plan at a footprint of several brick rows a
    chunk (ghosts two bricks deep, a table of 10 brick rows): the chunks
    that reach the khi ghost rows reach them mid-stream, after owned rows,
    and wait on that group all the same.  Bit for bit against the PUT
    exchange + K1 at the same footprint."""
    import dataclasses

    planned = SweepPlan.stream

    def stream(plan):
        sp = planned(plan)
        return dataclasses.replace(
            sp, kch=kch, pj=pj, ti=ti,
            smem_bytes=stream_smem(plan.bdims, plan.fuse, plan.lo, plan.hi,
                                   kch, pj, ti, sp.h, sp.d, sp.skew))

    monkeypatch.setattr(SweepPlan, "stream", stream)
    case = _fused_case([cuda] * 4, rings=2)
    sp = case[0].cards[0].stream
    assert (sp.kch, sp.pj, sp.ti) == (kch, pj, ti) and sp.nchunk > 1
    assert case[0].plan.table.shape[0] == 10
    _check_fused(*case)


def test_fused_exchange_kernel_across_two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    fn, put, sweeps, state, dec = _fused_case(
        ["cuda:0", "cuda:0", "cuda:1", "cuda:1"])
    assert fn.waits[0] == [(0, 1), (1, 0)]
    _check_fused(fn, put, sweeps, state, dec)


def test_fused_weak_step_and_problem_on_card_match_cpu(cuda):
    kw = dict(dims=(32, 16, 32), bdim=(8, 8, 32), stencil="s7pt", st_iter=4,
              fuse=1, table_periodic=False, mesh_shape=(2, 2, 1),
              exchange="fused")
    step_c, st_c, dec = weak.build_step(**kw, devices=[cuda] * 4)
    step_h, st_h, _ = weak.build_step(**kw, device="cpu")
    own = dec.owned_mask()
    assert compare_arrays(step_c(st_c)[0].cpu().numpy()[:, own],
                          step_h(st_h)[0].numpy()[:, own], 1e-5)
    pk = dict(dims=(32, 16, 32), stencil="mpi7pt", mesh=(2, 2, 1),
              st_iter=2)
    for ex in ("shift", "fused"):
        got = Problem(devices=[cuda] * 4, exchange=ex, **pk).init(
            seed=4).step(2).result()
        want = Problem(device="cpu", exchange=ex, **pk).init(
            seed=4).step(2).result()
        assert compare_arrays(got, want, 1e-5) and np.isfinite(got).all()


@pytest.mark.parametrize("dims,bd,kw,ranges", [
    ((4, 4, 8, 8, 16), (2, 2, 4, 4, 16), {}, None),
    ((4, 4, 8, 8, 32), (2, 2, 4, 4, 32), dict(two=True, corner=True), None),
    ((4, 4, 8, 8, 16), (2, 2, 4, 4, 16), {},
     ((0, 3), (1, 4), (0, 4), (2, 3))),
    ((4, 2, 4, 4, 8, 16), (2, 1, 2, 2, 4, 16), dict(corner=True), None),
], ids=["5d-star", "5d-two-input-corners", "5d-ranges", "6d-corners"])
def test_sweep_nd_kernel_matches_plain(cuda, dims, bd, kw, ranges):
    """K12 (the rank-5+ sweep) against its plain version on the bricks it
    writes, at abs-or-rel 1e-5."""
    from bricklib_tpu_torch.codegen.pencil_kernel_nd import (
        pencil_sweep_nd, pencil_sweep_nd_kernel)

    nd = len(dims)
    dec = BrickDecomp(dims=dims, ghost_depth=bd[:-1] + (0,),
                      bdims=bd).initialize(skinlist_by_name("good", nd))
    fn = pencil_sweep_nd(star_nd(st, nd, **kw), dec.grid, bd, dec.nbricks,
                         {}, ranges=ranges)
    xs = [torch.from_numpy(random_array((dec.nbricks,) + bd, np.float32,
                                        s)).to(cuda)
          for s in range(2 if kw.get("two") else 1)]
    before = pencil_sweep_nd_kernel.launches
    got = fn(*xs)
    assert pencil_sweep_nd_kernel.launches == before + 1
    want = pencil_sweep_plain(xs, torch.from_numpy(fn.plan.table).to(cuda),
                              fn.plan)
    torch.cuda.synchronize()
    w = fn.plan.written_bricks()
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


@pytest.mark.parametrize("fp", [(1, 1, 16, 2), (3, 1, 32, 1),
                                (2, 2, 64, 2)])
def test_sweep_nd_kernel_star_at_other_footprints(cuda, fp):
    """K12's compiled 5-D star at footprints of several blocks per outer
    cell (k chunks of 1 to 3 brick rows, one or two pencils, i tiles of 16
    to 64 lanes of 64), against its plain version at abs-or-rel 1e-5."""
    from bricklib_tpu_torch.codegen.pencil_kernel_nd import (
        nd_info, pencil_sweep_nd, pencil_sweep_nd_kernel,
        stream_nd_footprint)

    dims, bd = (4, 4, 16, 8, 64), (2, 2, 4, 4, 64)
    dec = BrickDecomp(dims=dims, ghost_depth=bd[:-1] + (0,),
                      bdims=bd).initialize(skinlist_by_name("good", 5))
    fn = pencil_sweep_nd(star_nd(st, 5), dec.grid, bd, dec.nbricks, {})
    sp = stream_nd_footprint(fn.plan, *fp)
    assert sp.layout and sp.nstream > sp.ncell
    x = torch.from_numpy(random_array((dec.nbricks,) + bd, np.float32,
                                      9)).to(cuda)
    table = torch.from_numpy(fn.plan.table).to(cuda)
    info = torch.from_numpy(nd_info(fn.plan, sp)[0]).to(cuda)
    got = pencil_sweep_nd_kernel([x], table, info, fn.plan, sp)
    want = pencil_sweep_plain([x], table, fn.plan)
    torch.cuda.synchronize()
    w = fn.plan.written_bricks()
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


def test_oracle_paths_on_card_match_cpu(cuda):
    """The torch oracle on the card: the weak step (overlap, a mesh on one
    card) and a 5-D Problem on a mesh whose i axis is distributed, against
    the same runs on the CPU."""
    kw = dict(dims=(16, 16, 32), bdim=(4, 4, 16), stencil="s7pt",
              st_iter=4, backend="jnp", overlap=True, mesh_shape=(2, 1, 1))
    step_c, st_c, dec = weak.build_step(**kw, devices=[cuda] * 2)
    step_h, st_h, _ = weak.build_step(**kw, device="cpu")
    own = dec.owned_mask()
    assert compare_arrays(step_c(st_c)[0].cpu().numpy()[:, own],
                          step_h(st_h)[0].numpy()[:, own], 1e-5)
    pk = dict(dims=(4, 4, 4, 4, 8), stencil=star_nd(st, 5),
              bdims=(2, 2, 2, 2, 4), mesh=(1, 1, 1, 1, 2), st_iter=2)
    got = Problem(devices=[cuda] * 2, **pk).init(seed=5).step(2)
    want = Problem(device="cpu", **pk).init(seed=5).step(2)
    assert got.backend == "jnp"
    assert compare_arrays(got.result(), want.result(), 1e-5)
    res = strong.run(dom=(32, 32, 32), sdom=(16, 16, 16), bdim=(4, 4, 8),
                     stencil="s7pt", st_iter=2, backend="jnp",
                     validate=True, iters=1, device=cuda)
    assert res["calls"]["step"] > 0


def _k1_check(cuda, fn, x, sp=None):
    """K1 (``sp``: a launch other than the planner's) against its plain
    version on the bricks it writes, at abs-or-rel 1e-5."""
    before = pencil_sweep_kernel.launches
    table = torch.from_numpy(fn.plan.table).to(cuda)
    got = fn(x) if sp is None else _launch_stream(x, table, fn.plan, sp)
    assert pencil_sweep_kernel.launches == before + 1
    want = pencil_sweep_plain(x, table, fn.plan)
    torch.cuda.synchronize()
    w = fn.plan.written_bricks()
    assert compare_arrays(got.cpu().numpy()[w], want.cpu().numpy()[w], 1e-5)


@pytest.mark.parametrize("fuse", [1, 2, 3, 4])
@pytest.mark.parametrize("edges", ["low", "high", "both"])
def test_stream_sweep_kernel_at_table_edges(cuda, fuse, edges):
    """K1 on a non-periodic table with k ranges that start at 0 and end at
    GK (the chunks there keep the clamp's source planes in a stash), at F
    1 to 4."""
    dec = BrickDecomp(dims=(32, 24, 32), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 32)).initialize(skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    kr = {"low": (0, GK - 1), "high": (1, GK), "both": (0, GK)}[edges]
    fn = pencil_sweep("s7pt", dec.grid, dec.bdims, dec.nbricks,
                      bench_params(), k_range=kr, j_range=(0, GJ),
                      fuse=fuse)
    sp = fn.plan.stream()
    assert sp.edge_lo == (kr[0] == 0) and sp.edge_hi == (kr[1] == GK)
    _k1_check(cuda, fn, random_storage(dec, seed=21, device=cuda))


@pytest.mark.parametrize("fuse", [1, 2])
def test_stream_sweep_kernel_radius_2(cuda, fuse):
    """K1 on mpi125pt (the 125 taps unrolled) at F 1 and 2, ghost-inclusive
    on a non-periodic table and owned-only on the periodic one."""
    dec = BrickDecomp(dims=(24, 24, 64), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 64)).initialize(skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    x = random_storage(dec, seed=22, device=cuda)
    for grid, kr, jr in ((dec.grid, (0, GK), (0, GJ)),
                         (dec.periodic_grid((0, 1, 2)), (1, GK - 1),
                          (1, GJ - 1))):
        _k1_check(cuda, pencil_sweep("mpi125pt", grid, dec.bdims,
                                     dec.nbricks, bench_params(),
                                     k_range=kr, j_range=jr, fuse=fuse), x)


def test_stream_sweep_kernel_short_and_ragged_footprints(cuda):
    """K1 with a k extent shorter than one chunk, and with chunks, pencil
    groups and an i tile that do not divide the ranges, at F = 2; the
    launch's shared memory and stash are counted from its footprint,
    skewed level boundaries included."""
    import dataclasses

    dec = BrickDecomp(dims=(40, 28, 64), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 64)).initialize(skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    x = random_storage(dec, seed=23, device=cuda)
    for kr, kch, pj, ti in (((2, 4), 8, 2, 64), ((0, GK), 3, 3, 16),
                            ((1, GK - 1), 4, 5, 32)):
        fn = pencil_sweep("mpi13pt", dec.grid, dec.bdims, dec.nbricks,
                          bench_params(), k_range=kr, j_range=(0, GJ),
                          fuse=2)
        for skew in (0, 2):
            _k1_check(cuda, fn, x, dataclasses.replace(
                fn.plan.stream(), kch=kch, pj=pj, ti=ti, d=2, skew=skew))
        _k1_check(cuda, fn, x)


@pytest.mark.parametrize("fuse", [1, 2])
def test_stream_sweep_kernel_on_the_box(cuda, fuse):
    """K1's generic body (the 27-point box: no compiled layout) at both
    table edges, F 1 and 2."""
    dec = BrickDecomp(dims=(24, 24, 64), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 64)).initialize(skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    fn = pencil_sweep("s27pt", dec.grid, dec.bdims, dec.nbricks,
                      bench_params(), k_range=(0, GK), j_range=(0, GJ),
                      fuse=fuse)
    _k1_check(cuda, fn, random_storage(dec, seed=27, device=cuda))


def test_stream_sweep_kernel_tall_bricks(cuda):
    """K1 with bricks 96 deep in k (more than 64, not a power of two) at
    both table edges, F = 3: ring slots and brick rows from float
    reciprocals, exact for any divisor below 2^20 planes."""
    dec = BrickDecomp(dims=(288, 16, 32), ghost_depth=(96, 4, 0),
                      bdims=(96, 4, 32)).initialize(
        skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    fn = pencil_sweep("s7pt", dec.grid, dec.bdims, dec.nbricks,
                      bench_params(), k_range=(0, GK), j_range=(0, GJ),
                      fuse=3)
    _k1_check(cuda, fn, random_storage(dec, seed=28, device=cuda))


def test_stream_sweep_kernel_refuses_too_little_shared_memory(cuda,
                                                               monkeypatch):
    """The C entry points refuse a launch whose shared memory is smaller
    than its block's layout: the ring body's and the register-streaming
    body's."""
    import dataclasses

    from bricklib_tpu_torch.codegen import pencil_kernel

    dec = BrickDecomp(dims=(16, 16, 32), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 32)).initialize(skinlist_by_name("good", 3))
    fn = pencil_sweep("s7pt", dec.periodic_grid((0, 1, 2)), dec.bdims,
                      dec.nbricks, bench_params(), fuse=2)
    x = random_storage(dec, seed=29, device=cuda)
    table = torch.from_numpy(fn.plan.table).to(cuda)
    sp, rp = fn.plan.stream(), fn.plan.regstream()
    short = dataclasses.replace(sp, smem_bytes=sp.smem_bytes - 8)
    monkeypatch.setattr(pencil_kernel.SweepPlan, "stream",
                        lambda self: short)
    monkeypatch.setattr(pencil_kernel.SweepPlan, "regstream",
                        lambda self: None)
    with pytest.raises(RuntimeError, match="pencil_sweep"):
        pencil_sweep_kernel(x, table, fn.plan)
    short = dataclasses.replace(rp, smem_bytes=rp.smem_bytes - 8)
    monkeypatch.setattr(pencil_kernel.SweepPlan, "regstream",
                        lambda self: short)
    with pytest.raises(RuntimeError, match="pencil_sweep_regstream"):
        pencil_sweep_kernel(x, table, fn.plan)
    monkeypatch.undo()
    _k1_check(cuda, fn, x)


@pytest.mark.parametrize("skip", [0, 1])
def test_stream_sweep_kernel_batch_16(cuda, skip):
    """Batched K1 over a stack of 16 subdomains at F = 4."""
    plan = StrongDecomp(dom=(64, 64, 32), sdom=(16, 16, 32),
                        mesh_shape=(1, 1, 1), bdims=(4, 4, 32),
                        ghost_depth=(4, 4, 0)).initialize(
        skinlist_by_name("good", 3))
    kg = plan.sdec.periodic_grid((2,))
    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    assert nsub == 16
    GK, GJ = kg.shape[:2]
    x = torch.from_numpy(random_array((nsub * nb,) + plan.bdims, np.float32,
                                      24)).to(cuda)
    _k1_check(cuda, pencil_sweep(
        "s7pt", kg, plan.bdims, nsub * nb, bench_params(),
        k_range=(skip, GK - skip), j_range=(skip, GJ - skip), batch=nsub,
        batch_stride=nb, fuse=4), x)


def _composed(cuda, fn, x):
    """``fn``'s sweep as ``fuse`` single-level K1 launches (the ring body)."""
    plan = fn.plan
    GK, GJ = plan.table.shape
    # over the whole table, or where cells of the table share a brick (a
    # periodic table), over the sweep's own ranges
    whole = len(np.unique(plan.table)) == plan.table.size
    one = dataclasses.replace(
        plan, fuse=1, ranges=((0, GK), (0, GJ)) if whole else plan.ranges)
    table = torch.from_numpy(plan.table).to(cuda)
    for _ in range(plan.fuse):
        x = pencil_sweep_kernel(x, table, one)
    return x


def _ids(cuda, plan, j0, j1):
    (K0, K1), _ = plan.ranges
    ids = plan.table[K0:K1, j0:j1].reshape(-1).astype(np.int64)
    ids = np.unique(np.concatenate([ids + s * plan.batch_stride
                                    for s in range(plan.batch)]))
    return torch.from_numpy(ids).to(cuda)


def _rs_check(cuda, fn, x, rp=None):
    """K1 through its register-streaming body (``rp``: another footprint
    than the planner's) counts one K1 launch and one ``k1_regstream``, and
    equals bit for bit its ring body (through ``_launch_stream``) on every
    brick it writes and ``fuse`` single-level launches on every brick whose
    levels read no j row beyond the table (the fused levels do not clamp
    in j, single levels do: the table's edge pencils differ)."""
    plan = fn.plan
    table = torch.from_numpy(plan.table).to(cuda)
    if rp is None:
        assert plan.regstream() is not None
    before = trace.counters()
    got = fn(x) if rp is None else launch_regstream(x, table, plan, rp)
    after = trace.counters()
    assert after["k1_regstream"] - before["k1_regstream"] == 1
    assert after["K1"] - before["K1"] == 1
    ring = _launch_stream(x, table, plan, None)
    torch.cuda.synchronize()
    (_, _), (J0, J1) = plan.ranges
    GJ = plan.table.shape[1]
    w = _ids(cuda, plan, J0, J1)
    assert torch.equal(got[w], ring[w])
    inner = _ids(cuda, plan, max(J0, 1), min(J1, GJ - 1))
    assert torch.equal(got[inner], _composed(cuda, fn, x)[inner])


def _rs_sweep(region, fuse):
    """The star at ``fuse`` on a 32 x 40 x 64 domain of (4, 4, 64) bricks,
    one ghost brick a side in k and j, over ``region``; with ``two-rows``
    a table of two brick rows, no ghost in k."""
    if region == "two-rows":
        dec = BrickDecomp(dims=(8, 24, 64), ghost_depth=(0, 4, 0),
                          bdims=(4, 4, 64)).initialize(
            skinlist_by_name("good", 3))
    else:
        dec = BrickDecomp(dims=(32, 40, 64), ghost_depth=(4, 4, 0),
                          bdims=(4, 4, 64)).initialize(
            skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    grid = dec.periodic_grid((0, 1, 2)) if region == "periodic" else dec.grid
    kr, jr = {"periodic": ((1, GK - 1), (1, GJ - 1)),
              "ghost": ((0, GK), (0, GJ)),
              "owned": ((1, GK - 1), (1, GJ - 1)),
              "low-edge": ((0, GK - 1), (1, GJ - 1)),
              "high-edge": ((1, GK), (0, GJ)),
              "two-rows": ((0, GK), (0, GJ))}[region]
    return dec, pencil_sweep("s7pt", grid, dec.bdims, dec.nbricks,
                             bench_params(), k_range=kr, j_range=jr,
                             fuse=fuse)


@pytest.mark.parametrize("fuse", [2, 3, 4])
@pytest.mark.parametrize("region", ["periodic", "ghost", "owned",
                                    "low-edge", "high-edge", "two-rows"])
def test_regstream_kernel_is_the_ring_body_bit_for_bit(cuda, region, fuse):
    """The register-streaming body against the ring body and single-level
    launches: periodic, ghost-inclusive (both k edges), owned-only, one k
    edge, and a table of two brick rows (the low edge's pre-roll reaches
    the high edge's sources)."""
    dec, fn = _rs_sweep(region, fuse)
    _rs_check(cuda, fn, random_storage(dec, seed=31 + fuse, device=cuda))


@pytest.mark.parametrize("fuse", [2, 3, 4])
@pytest.mark.parametrize("skip", [0, 1])
def test_regstream_kernel_batch_16(cuda, skip, fuse):
    """The register-streaming body over a stack of 16 subdomains."""
    plan = StrongDecomp(dom=(64, 64, 32), sdom=(16, 16, 32),
                        mesh_shape=(1, 1, 1), bdims=(4, 4, 32),
                        ghost_depth=(4, 4, 0)).initialize(
        skinlist_by_name("good", 3))
    kg = plan.sdec.periodic_grid((2,))
    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    assert nsub == 16
    GK, GJ = kg.shape[:2]
    x = torch.from_numpy(random_array((nsub * nb,) + plan.bdims, np.float32,
                                      25)).to(cuda)
    _rs_check(cuda, pencil_sweep(
        "s7pt", kg, plan.bdims, nsub * nb, bench_params(),
        k_range=(skip, GK - skip), j_range=(skip, GJ - skip), batch=nsub,
        batch_stride=nb, fuse=fuse), x)


@pytest.mark.parametrize("fuse", [2, 3, 4])
def test_regstream_kernel_ragged_footprints(cuda, fuse):
    """The register-streaming body at footprints whose chunks and pencil
    groups do not divide the ranges, at both row widths, lookahead 1 and
    2, and on storage that is not 16-byte aligned (pieces of one float)."""
    dec, fn = _rs_sweep("ghost", fuse)
    plan = fn.plan
    rp = plan.regstream()
    x = random_storage(dec, seed=41, device=cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    odd = flat[1:].view(x.shape)
    odd.copy_(x)
    assert odd.data_ptr() % 16 != 0
    BJ = plan.bdims[1]
    for kch, pj, rw, d, st in ((3, 3, 40, 2, x), (5, 4, 72, 1, x),
                               (2, 5, 72, 2, odd), (4, 3, 40, 1, odd)):
        nq = -(-(pj * BJ + 2 * fuse) // 4)
        ti = min(plan.bdims[2], rw - 2 * rp.h)
        v = dataclasses.replace(
            rp, kch=kch, pj=pj, ti=ti, rw=rw, nq=nq, d=d,
            smem_bytes=regstream_smem(plan.bdims, fuse, kch, pj, rw, nq, d))
        assert nq * rw <= 1024
        _rs_check(cuda, fn, st, v)


def test_regstream_counter_moves_once_per_new_body_launch(cuda):
    """``k1_regstream`` moves by one for each launch of the new body and
    not for K1's other launches (fuse 1, the cube), while ``K1`` counts
    them all."""
    dec = BrickDecomp(dims=(32, 32, 64), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 64)).initialize(skinlist_by_name("good", 3))
    x = random_storage(dec, seed=43, device=cuda)
    for stencil, fuse, n in (("s7pt", 4, 1), ("mpi7pt", 2, 1),
                             ("s7pt", 1, 0), ("mpi125pt", 2, 0)):
        fn = pencil_sweep(stencil, dec.periodic_grid((0, 1, 2)), dec.bdims,
                          dec.nbricks, bench_params(), fuse=fuse)
        before = trace.counters()
        fn(x)
        fn(x)
        after = trace.counters()
        assert after["k1_regstream"] - before["k1_regstream"] == 2 * n
        assert after["K1"] - before["K1"] == 2
    torch.cuda.synchronize()


def _ib_sweep(stencil, fuse, region, bd=(8, 8, 8), batch=3):
    """A batched K1 sweep on the i-bricked table of cubic strong
    subdomains (a 64^3 domain in 32^3 subdomains, a ghost brick a side on
    every axis): owned-only (the i ghost ring skipped) or ghost-inclusive
    on every axis (``i_range=(0, GI)``)."""
    plan = StrongDecomp(dom=(64, 64, 64), sdom=(32, 32, 32),
                        mesh_shape=(1, 1, 1), bdims=bd,
                        ghost_depth=bd).initialize(
        skinlist_by_name("good", 3))
    grid, nb = plan.sdec.grid, plan.sdec.nbricks
    GK, GJ, GI = grid.shape
    kw = (dict(k_range=(0, GK), j_range=(0, GJ), i_range=(0, GI))
          if region == "ghost" else {})
    fn = pencil_sweep(stencil, grid, bd, batch * nb, bench_params(),
                      i_ghost=1, batch=batch, batch_stride=nb, fuse=fuse,
                      **kw)
    x = torch.from_numpy(random_array((batch * nb,) + bd, np.float32,
                                      51 + fuse)).to("cuda")
    return fn, x


def _ib_check(cuda, fn, x, rp=None, sp=None):
    """K1 on an i-bricked table: the planner's launch (or ``rp`` through
    the register-streaming body, ``sp`` through the ring body) counts one
    K1 and one ``k1_ibrick`` launch (and, through the register body, one
    ``k1_regstream``, and one ``k1_ibrick_quads`` where its every output
    quad stores from one row offset) and matches the plain version
    on the bricks it writes at abs-or-rel 1e-5 (the card contracts multiply
    and add into FMAs, the plain version rounds each); where the
    register-streaming body takes the sweep it equals the ring body bit for
    bit (both keep each output's tap order)."""
    plan = fn.plan
    table = torch.from_numpy(plan.table).to(cuda)
    before = trace.counters()
    if rp is not None:
        got = launch_regstream(x, table, plan, rp)
    elif sp is not None:
        got = _launch_stream(x, table, plan, sp)
    else:
        got = fn(x)
    after = trace.counters()
    reg = int(rp is not None
              or (sp is None and plan.regstream() is not None))
    assert after["K1"] - before["K1"] == 1
    assert after["k1_ibrick"] - before["k1_ibrick"] == 1
    assert after["k1_regstream"] - before["k1_regstream"] == reg
    assert after["k1_ibrick_quads"] - before["k1_ibrick_quads"] == \
        reg * quad_stores(plan)
    want = pencil_sweep_plain(x, table, plan)
    torch.cuda.synchronize()
    w = torch.from_numpy(plan.written_bricks()).to(cuda)
    assert compare_arrays(got[w].cpu().numpy(), want[w].cpu().numpy(), 1e-5)
    if plan.regstream() is not None:
        ring = _launch_stream(x, table, plan, None)
        assert torch.equal(got[w], ring[w])


@pytest.mark.parametrize("region", ["owned", "ghost"])
@pytest.mark.parametrize("stencil,fuse", [
    ("s7pt", 1), ("s7pt", 2), ("s7pt", 3), ("s7pt", 4), ("mpi7pt", 4),
    ("s27pt", 1), ("s27pt", 2), ("mpi13pt", 2), ("mpi125pt", 1)])
def test_ibrick_sweep_kernel_matches_plain(cuda, stencil, fuse, region):
    """K1 on i-bricked tables through its compiled layouts (the star, the
    cube), its generic body (the box, the 13-point star) and, for the
    star at fuse 2 to 4, its register-streaming body; owned-only and
    ghost-inclusive on every axis; three subdomains in the batch."""
    fn, x = _ib_sweep(stencil, fuse, region)
    assert fn.plan.ibrick
    _ib_check(cuda, fn, x)


@pytest.mark.parametrize("bi", [4, 8])
@pytest.mark.parametrize("fuse", [2, 3, 4])
@pytest.mark.parametrize("region", ["owned", "ghost"])
def test_ibrick_regstream_ragged_footprints(cuda, region, fuse, bi):
    """Both bodies on an i-bricked table at footprints whose chunks,
    pencil groups and i tiles do not divide the ranges (the last i tile
    ends past the written lanes), at every compiled row width, lookahead 1
    and 2, and on storage that is not 16-byte aligned (pieces of one
    float).  With 8-lane bricks, and with 4-lane bricks on the unaligned
    storage (i tiles of 6 and 10 lanes), tiles start and end inside a
    brick, so a brick's k-plane holds the lanes of two tiles: each tile
    writes its own lanes alone.  A launch on NaN storage goes first, and
    each footprint runs three times: a store that reached a neighbour
    tile's lanes would leave there, in some block order, a value of its
    own tile or a NaN."""
    fn, x = _ib_sweep("s7pt", fuse, region, bd=(bi,) * 3, batch=2)
    plan = fn.plan
    rp = plan.regstream()
    table = torch.from_numpy(plan.table).to(cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    odd = flat[1:].view(x.shape)
    odd.copy_(x)
    assert odd.data_ptr() % 16 != 0
    BJ = plan.bdims[1]
    cases = {4: ((3, 3, 20, 2, x), (5, 4, 56, 1, x), (2, 5, 12, 2, odd),
                 (4, 2, 32, 1, odd), (4, 3, 72, 2, x), (3, 2, 6, 2, odd),
                 (2, 3, 10, 1, odd)),
             8: ((3, 3, 20, 2, x), (2, 2, 12, 1, x), (4, 2, 28, 2, odd),
                 (5, 1, 36, 1, x), (2, 3, 44, 2, odd), (3, 2, 64, 1, x))}[bi]
    for kch, pj, ti, d, st_ in cases:
        rw = min(w for w in (40, 72, 80) if w >= ti + 2 * rp.h)
        nq = -(-(pj * BJ + 2 * fuse) // 4)
        v = dataclasses.replace(
            rp, kch=kch, pj=pj, ti=ti, rw=rw, nq=nq, d=d,
            smem_bytes=regstream_smem(plan.bdims, fuse, kch, pj, rw, nq, d,
                                      brick_cols(plan.bdims, ti, rp.h,
                                                 True)))
        # NaN storage of the same alignment (the pieces' width follows it)
        nan = (torch.full_like(flat, float("nan"))[1:].view(x.shape)
               if st_ is odd else torch.full_like(x, float("nan")))
        launch_regstream(nan, table, plan, v)
        for _ in range(3):
            _ib_check(cuda, fn, st_, rp=v)
        sp = dataclasses.replace(
            plan.stream(), kch=kch, pj=pj, ti=ti, d=d, skew=0)
        _ib_check(cuda, fn, st_, sp=sp)


@pytest.mark.parametrize("region", ["owned", "ghost"])
def test_ibrick_regstream_at_the_strong_cells_footprints(cuda, region):
    """The strong cell's two sweeps (64 subdomains of 128^3 in 8^3 bricks,
    fuse 4, ghost-inclusive on every axis and owned-only) at the planner's
    footprints: against the plain version and the ring body
    (``_ib_check``), every output quad of both stored from one row
    offset."""
    plan = StrongDecomp(dom=(512,) * 3, sdom=(128,) * 3,
                        mesh_shape=(1, 1, 1), bdims=(8, 8, 8),
                        ghost_depth=(8, 8, 8)).initialize(
        skinlist_by_name("good", 3))
    grid, nb = plan.sdec.grid, plan.sdec.nbricks
    GK, GJ, GI = grid.shape
    kw = (dict(k_range=(0, GK), j_range=(0, GJ), i_range=(0, GI))
          if region == "ghost" else {})
    fn = pencil_sweep("s7pt", grid, (8, 8, 8), 64 * nb, bench_params(),
                      i_ghost=1, batch=64, batch_stride=nb, fuse=4, **kw)
    rp = fn.plan.regstream()
    assert (rp.kch, rp.pj, rp.ti, rp.rw) == {
        "ghost": (18, 5, 72, 80), "owned": (16, 6, 64, 72)}[region]
    assert quad_stores(fn.plan)
    g = torch.Generator(cuda).manual_seed(61)
    x = torch.rand((64 * nb, 8, 8, 8), device=cuda, generator=g)
    _ib_check(cuda, fn, x)


def test_quads_counter_moves_once_per_quad_storing_launch(cuda):
    """``k1_ibrick_quads`` moves by one for each launch of K1's register
    body on an i-bricked table at ``fuse=4`` (8^3 bricks: every output quad
    from one row offset), never at ``fuse=2`` there (quads straddle
    pencils), for its ring body there (``fuse=1``) nor for a pencil launch
    of either body, while ``K1`` counts them all."""
    dec = BrickDecomp(dims=(32, 32, 64), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 64)).initialize(skinlist_by_name("good", 3))
    x = random_storage(dec, seed=43, device=cuda)
    for fuse in (4, 1):
        fn = pencil_sweep("s7pt", dec.periodic_grid((0, 1, 2)), dec.bdims,
                          dec.nbricks, bench_params(), fuse=fuse)
        before = trace.counters()
        fn(x)
        after = trace.counters()
        assert after["k1_ibrick_quads"] == before["k1_ibrick_quads"]
        assert after["K1"] - before["K1"] == 1
    for fuse, n in ((4, 1), (2, 0), (1, 0)):
        fn, xi = _ib_sweep("s7pt", fuse, "ghost")
        before = trace.counters()
        fn(xi)
        fn(xi)
        after = trace.counters()
        assert after["k1_ibrick_quads"] - before["k1_ibrick_quads"] == 2 * n
        assert after["k1_ibrick"] - before["k1_ibrick"] == 2
        assert after["K1"] - before["K1"] == 2
    torch.cuda.synchronize()


def test_strong_cubic_step_on_card_validates(cuda):
    """The cubic strong step on the card (i-bricked K1, the six-face
    strong exchange) against the global dense twin, and its launches a
    step: ``st_iter / fuse`` K1 sweeps, each an i-bricked launch of the
    register-streaming body, and one K5 per (stage, sign)."""
    kw = dict(dom=(64, 64, 64), sdom=(32, 32, 32), bdim=(8, 8, 8),
              stencil="s7pt", st_iter=8, fuse=4)
    step, storage, plan, g = strong.build_step(**kw, device=cuda)
    assert strong.validate_step(step, storage, plan, g, "s7pt", 8)
    x = step(storage.clone())
    torch.cuda.synchronize()
    before = trace.counters()
    step(x)
    after = trace.counters()
    d = {k: after[k] - before[k] for k in after}
    assert d["K1"] == d["k1_ibrick"] == d["k1_regstream"] == 2
    assert d["k1_ibrick_quads"] == 2
    assert d["K5"] == len(step.exchange.stages) == 6


@pytest.mark.parametrize("exchange,mesh", [("shift", (2, 1, 1)),
                                           ("remote", (2, 1, 1)),
                                           ("remote", (1, 1, 2))])
def test_strong_cubic_mesh_step_on_card_validates(cuda, exchange, mesh):
    """Cubic subdomains over two ranks on one card, the i axis split too:
    the staged exchange (K5) and the remote one (K10) move the six faces
    between ranks, then the i-bricked sweeps."""
    kw = dict(dom=(32, 32, 32), sdom=(16, 16, 16), bdim=(4, 4, 4),
              stencil="s7pt", st_iter=4, fuse=2, mesh_shape=mesh,
              exchange=exchange)
    step, state, plan, g = strong.build_step(**kw, devices=[cuda] * 2)
    assert strong.validate_step(step, state, plan, g, "s7pt", 4, step.mesh)
    assert step.sweeps[0].plan.ibrick
