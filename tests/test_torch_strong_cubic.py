"""Cubic strong subdomains on the port's own path: K1's plain version on
i-bricked tables (``codegen.pencil_kernel``) and the cubic strong step
(``drivers.strong``, ``backend="pencil"``), on the CPU.

- The i-bricked sweep is held against the torch oracle: level 0 gathered
  densely from the same table, clamped a whole brick at a time at its
  edges on every axis, then ``dense_apply`` once per fused level (the k
  rows outside the table taking the clamped row after each intermediate
  level), compared on the bricks the sweep writes at abs-or-rel 1e-5:
  both sum the same taps in float32, in orders that differ, so they agree
  to a few ulps of each element's magnitude.
- The cubic strong step is held against the benchmark's plain reference
  (``brickbench/reference.py``: ``torch.roll`` taps over the global
  periodic domain, float32, no kernel of the port) over several steps:
  ``rel_err`` at most 1e-5.  Both add the seven taps in one order, so
  they differ only by the rounding of a multiply and add done apart or
  fused, a few ulps an iteration; a sweep that skips the i halo or an
  exchange that drops the i faces reads wrong values at every i face of
  every subdomain, a gap of the field's own size.

The kernels run only on the card (``tests/test_torch_gpu.py``,
``test_ibrick_*`` and ``test_strong_cubic_step_on_card_validates``).
"""

import numpy as np
import pytest
import torch

from brickbench import reference
from brickbench import stencils as bench_stencils
from bricklib_tpu_torch import trace
from bricklib_tpu_torch.codegen.jnp_backend import dense_apply
from bricklib_tpu_torch.codegen.pencil_kernel import (
    StreamPlan, brick_cols, pencil_sweep, pencil_sweep_kernel,
    regstream_smem, stream_smem)
from bricklib_tpu_torch.comm import StrongDecomp, skinlist_by_name
from bricklib_tpu_torch.comm import strong as strong_comm
from bricklib_tpu_torch.core.setup import from_bricks
from bricklib_tpu_torch.drivers import strong
from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

TOL = 1e-5


def _table(GK, GJ, GI, seed):
    """A ``[GK, GJ, GI]`` table of distinct brick ids in a random order,
    ids 1 and up (storage row 0 is never named), with ``nbricks``."""
    rng = np.random.default_rng(seed)
    n = GK * GJ * GI
    return (rng.permutation(n) + 1).reshape(GK, GJ, GI).astype(np.int32), \
        n + 3


def _oracle(stencil, x, grid, bd, ranges, fuse, batch, stride):
    """The sweep by the torch oracle, per subdomain: level 0 over the
    output ranges grown by ``fuse`` radii, each cell read through the
    table with its brick clamped to the table on every axis; ``fuse``
    levels of ``dense_apply``; the k rows outside the table replaced by
    the clamped row after each intermediate level.  Returns ``{brick id:
    brick}`` of the written bricks."""
    sd = stencil_by_name(stencil)[0]
    lo, hi = sd.radius()
    G = grid.shape
    xs = x.numpy()
    out = {}
    for s in range(batch):
        idx = []
        for a in range(3):
            c = np.arange(ranges[a][0] * bd[a] - fuse * lo[a],
                          ranges[a][1] * bd[a] + fuse * hi[a])
            idx.append((np.clip(c // bd[a], 0, G[a] - 1), c % bd[a]))
        (bk, ok), (bj, oj), (bi, oi) = idx
        ids = grid[np.ix_(bk, bj, bi)] + s * stride
        lvl = xs[ids, ok[:, None, None], oj[None, :, None],
                 oi[None, None, :]]
        k0 = ranges[0][0] * bd[0]
        for f in range(1, fuse + 1):
            lvl = dense_apply(sd, {next(iter(sd.inputs)): lvl},
                              bench_params(), xp=np)
            if f < fuse:
                base = k0 - (fuse - f) * lo[0]
                rows = np.arange(base, base + lvl.shape[0])
                rb = np.clip(rows // bd[0], 0, G[0] - 1)
                lvl = lvl[rb * bd[0] + rows % bd[0] - base]
        for kk in range(ranges[0][0], ranges[0][1]):
            for jj in range(ranges[1][0], ranges[1][1]):
                for ii in range(ranges[2][0], ranges[2][1]):
                    rk, rj, ri = (kk - ranges[0][0], jj - ranges[1][0],
                                  ii - ranges[2][0])
                    out[int(grid[kk, jj, ii]) + s * stride] = lvl[
                        rk * bd[0]:(rk + 1) * bd[0],
                        rj * bd[1]:(rj + 1) * bd[1],
                        ri * bd[2]:(ri + 1) * bd[2]]
    return out


# (GI, i_range): a table of GI brick columns, one ghost column a side;
# None is the default range (the i ghost ring skipped), (0, GI) the
# ghost-inclusive sweep
IB_CASES = [(2, (0, 2)), (3, None), (3, (0, 3)), (4, None), (4, (0, 4))]


@pytest.mark.parametrize("gi,i_range", IB_CASES)
@pytest.mark.parametrize("stencil,fuse", [("s7pt", 1), ("s7pt", 2),
                                          ("s7pt", 4), ("s27pt", 2),
                                          ("mpi13pt", 2)])
def test_ibrick_sweep_matches_the_oracle(stencil, fuse, gi, i_range):
    """K1's plain version on an i-bricked table, batched over three
    subdomains (each reading its own bricks), at the table's every edge
    where the range is ghost-inclusive; the star (K1's compiled layout
    and register body on the card), the box and the 13-point star (its
    generic body)."""
    bd = (4, 4, 4)
    grid, nb = _table(4, 5, gi, seed=gi)
    batch = 3
    kw = dict(k_range=(0, 4), j_range=(0, 5)) if i_range else {}
    fn = pencil_sweep(stencil, grid, bd, batch * nb, bench_params(),
                      i_ghost=1, i_range=i_range, batch=batch,
                      batch_stride=nb, fuse=fuse, **kw)
    plan = fn.plan
    assert plan.ibrick
    x = torch.from_numpy(np.random.default_rng(7).random(
        (batch * nb,) + bd, dtype=np.float64).astype(np.float32) * 2 - 1)
    k1 = pencil_sweep_kernel
    before = k1.launches, k1.ibrick_launches
    got = fn(x).numpy()
    assert (k1.launches, k1.ibrick_launches) == before
    want = _oracle(stencil, x, grid, bd, plan.ranges, fuse, batch, nb)
    written = plan.written_bricks()
    assert sorted(want) == written.tolist()
    scale = max(float(np.abs(v).max()) for v in want.values())
    for b, w in want.items():
        assert np.abs(got[b] - w).max() <= TOL * max(scale, 1.0), b


def test_ibrick_sweep_reads_the_i_halo_through_the_table():
    """Each written brick depends on its i neighbours' bricks, read
    through the table: changing one brick of the ghost column changes the
    ghost-adjacent owned bricks and nothing farther."""
    bd = (4, 4, 4)
    grid, nb = _table(3, 3, 4, seed=11)
    fn = pencil_sweep("s7pt", grid, bd, nb, bench_params(), i_ghost=1,
                      k_range=(0, 3), j_range=(0, 3), fuse=2)
    x = torch.rand((nb,) + bd, generator=torch.Generator().manual_seed(3))
    a = fn(x)
    y = x.clone()
    y[int(grid[1, 1, 0])] += 1.0                   # the low i ghost brick
    b = fn(y)
    changed = {int(i) for i in torch.nonzero(
        (a - b).abs().flatten(1).amax(1) > 0).flatten()}
    assert int(grid[1, 1, 1]) in changed
    assert int(grid[1, 1, 2]) not in changed


@pytest.mark.parametrize("args,match", [
    (dict(i_ghost=0), "i_ghost >= 1"),
    (dict(i_ghost=1, i_range=(0, 5)), "outside grid i extent"),
    (dict(i_ghost=1, fuse=3, bdims=(4, 4, 2)), "i window margin"),
    (dict(i_ghost=1, stencil="mpi13pt", bdims=(4, 4, 1)), "i-radius"),
])
def test_ibrick_arguments_checked(args, match):
    """What the reference refuses on i-bricked tables raises ValueError
    here too (``tests/test_torch_pencil_sweep.py`` holds the messages to
    the reference's)."""
    grid, nb = _table(4, 4, 4, seed=1)
    args = dict(args)
    stencil = args.pop("stencil", "s7pt")
    bd = args.pop("bdims", (4, 4, 4))
    with pytest.raises(ValueError, match=match):
        pencil_sweep(stencil, grid, bd, nb, bench_params(), **args)


@pytest.mark.parametrize("ghost", [False, True])
@pytest.mark.parametrize("fuse", [1, 2, 4])
def test_ibrick_plans_cover_every_output_once(ghost, fuse):
    """On the cell's shapes (64 subdomains of 128^3 in 8^3 bricks), K1's
    launches, decoded as the kernels decode them, cover every output
    brick row x pencil x i lane of every subdomain exactly once (i tiles
    start at the first written lane; the last may end past the written
    lanes and writes none of them), and their shared memory fits and is
    the layout's count, brick columns included."""
    plan = StrongDecomp(dom=(512,) * 3, sdom=(128,) * 3,
                        mesh_shape=(1, 1, 1), bdims=(8, 8, 8),
                        ghost_depth=(8, 8, 8)).initialize(
        skinlist_by_name("good", 3))
    grid, nb = plan.sdec.grid, plan.sdec.nbricks
    GK, GJ, GI = grid.shape
    kw = (dict(k_range=(0, GK), j_range=(0, GJ), i_range=(0, GI)) if ghost
          else {})
    fn = pencil_sweep("s7pt", grid, (8, 8, 8), 64 * nb, bench_params(),
                      i_ghost=1, batch=64, batch_stride=nb, fuse=fuse, **kw)
    (K0, K1), (J0, J1), (I0, I1) = fn.plan.ranges
    launches = [fn.plan.stream()]
    if fuse > 1:
        launches.append(fn.plan.regstream())
        assert launches[-1] is not None
    for sp in launches:
        seen = np.zeros((K1 - K0, J1 - J0, (I1 - I0) * 8), np.int32)
        for sub, (k0, k1), (j0, j1), (i0, i1), _e in sp.blocks():
            assert I0 * 8 <= i0 < i1 <= I1 * 8
            if sub == 0:
                seen[k0 - K0:k1 - K0, j0 - J0:j1 - J0,
                     i0 - I0 * 8:i1 - I0 * 8] += 1
        assert (seen == 1).all()
        assert sp.nstream == 64 * sp.nchunk * sp.njg * sp.nit
        assert sp.nit == -(-(I1 - I0) * 8 // sp.ti)
        assert 0 < sp.smem_bytes <= 232448
        cols = brick_cols((8, 8, 8), sp.ti, sp.h, True)
        if type(sp) is StreamPlan:
            assert sp.smem_bytes == stream_smem(
                (8, 8, 8), fuse, fn.plan.lo, fn.plan.hi, sp.kch, sp.pj,
                sp.ti, sp.h, sp.d, sp.skew, True)
        else:
            assert sp.smem_bytes == regstream_smem(
                (8, 8, 8), fuse, sp.kch, sp.pj, sp.rw, sp.nq, sp.d, cols)


def test_sweep_span_names_the_layout():
    """K1's ``bricklib.sweep`` span names its table's layout."""
    grid, nb = _table(4, 4, 4, seed=2)
    fns = {"ibrick": pencil_sweep("s7pt", grid, (4, 4, 4), nb,
                                  bench_params(), i_ghost=1, fuse=2),
           "pencil": pencil_sweep("s7pt", grid[:, :, 0], (4, 4, 4), nb,
                                  bench_params(), fuse=2)}
    for layout, fn in fns.items():
        with trace.tracing():
            trace.records()
            fn(torch.zeros((nb, 4, 4, 4)))
            (sp,) = [s for s in trace.records() if s.name == trace.SWEEP]
        assert sp.args["layout"] == layout
        assert sp.args["body"] == "regstream"


def _step_vs_reference(bdim, fuse, steps, st_iter=4, dom=(32,) * 3,
                       sdom=(16,) * 3):
    """``rel_err`` of the cubic strong step's owned blocks, after each of
    ``steps`` steps, against the plain reference from the same global
    field (the driver's own draw, seed 4)."""
    step, storage, plan, g = strong.build_step(
        dom=dom, sdom=sdom, bdim=bdim, stencil="s7pt", st_iter=st_iter,
        fuse=fuse, device="cpu")
    field = torch.from_numpy(g)
    taps = bench_stencils.taps("s7pt")
    errs, x = [], storage
    for n in range(1, steps + 1):
        x = step(x)
        want = reference.iterate(field, taps, n * st_iter)
        err = 0.0
        for row, c in enumerate(plan.sub_order):
            got = from_bricks(x[row].reshape(plan.sdec.nbricks, -1).numpy(),
                              plan.sdec.interior_grid(), plan.bdims)
            sl = tuple(slice(int(c[a]) * sdom[a], (int(c[a]) + 1) * sdom[a])
                       for a in range(3))
            err = max(err, reference.rel_err(torch.from_numpy(got),
                                             want[sl].contiguous()))
        errs.append(err)
    return step, errs


@pytest.mark.parametrize("bdim", [(4, 4, 4), (8, 8, 8)])
@pytest.mark.parametrize("fuse", [1, 2, 4])
def test_cubic_step_matches_the_plain_reference(bdim, fuse):
    """32^3 in 16^3 subdomains, the whole step (six-face exchange, then
    the i-bricked sweeps), over three steps."""
    step, errs = _step_vs_reference(bdim, fuse, 3)
    assert max(errs) <= TOL, errs
    assert step.sweeps[-1].plan.ibrick
    assert len(step.exchange.stages) == 6


def test_cubic_step_without_the_i_faces_is_wrong(monkeypatch):
    """The same step with the exchange's i stages taken out reads far
    from the reference: the check sees an exchange that drops i faces."""
    stages = strong_comm.strong_stages
    monkeypatch.setattr(strong_comm, "strong_stages", lambda *a, **k: [
        s for s in stages(*a, **k) if s.axis != 2])
    step, errs = _step_vs_reference((4, 4, 4), 2, 2)
    assert len(step.exchange.stages) == 4
    assert min(errs) > 1e-2, errs


def test_cubic_step_spans_and_counters():
    """The strong driver's set-up is one ``bricklib.plan`` span with its
    ``.decomp``, ``.domain`` and ``.kernels`` children; each step one
    ``bricklib.step`` (its ordinal) holding the exchange and ``8 / fuse``
    sweeps, which name the i-bricked layout; the exchange's bytes are
    every subdomain's whole ghost shell, its i faces included."""
    with trace.tracing():
        trace.records()
        step, x, plan, _g = strong.build_step(
            dom=(32,) * 3, sdom=(16,) * 3, bdim=(4, 4, 4), stencil="s7pt",
            st_iter=4, fuse=2, device="cpu")
        built = trace.records()
        before = trace.counters()
        x = step(step(x))
        after = trace.counters()
        spans = trace.records()
    names = [s.name for s in built]
    assert names[0] == trace.PLAN and {trace.PLAN_DECOMP, trace.PLAN_DOMAIN,
                                       trace.PLAN_KERNELS} <= set(names)
    steps = [s for s in spans if s.name == trace.STEP]
    assert [s.args for s in steps] == [None, None]
    assert [s.step for s in steps] == [1, 2]
    sweeps = [s for s in spans if s.name == trace.SWEEP]
    assert len(sweeps) == 4 and all(s.args["layout"] == "ibrick"
                                    for s in sweeps)
    assert sum(s.name == trace.EXCHANGE for s in spans) == 2
    grown = ((16 + 2 * 4) // 4) ** 3
    owned = (16 // 4) ** 3
    assert after["exchange_bytes"] - before["exchange_bytes"] == \
        2 * 8 * (grown - owned) * 4 ** 3 * 4
