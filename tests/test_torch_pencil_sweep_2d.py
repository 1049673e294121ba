"""The port's 2-D whole-row sweep (``codegen.pencil_kernel_2d``)
against the reference ``pallas_pencil_sweep_2d`` in interpret mode.

Both packages get the same numpy storage (random in every brick, ghosts
and brick 0 too) over the same row table; each stencil is built by the
same builder from each package's own eDSL.  The sweeps are compared on
the bricks they write at abs-or-rel 5e-5, the f32 tolerance of
``core/compare.py`` (float32 sums in another order: the reference's linear
path contracts y with matmuls).  On the CPU the port runs kernel K6's
plain version; the kernel itself is held against that plain version on
the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu import st as ref_st
from bricklib_tpu.codegen.pencil_kernel_2d import pallas_pencil_sweep_2d
from bricklib_tpu.core import compare_arrays, init_grid, random_array
from bricklib_tpu_torch import st as port_st
from bricklib_tpu_torch.codegen.ir import StencilIR
from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
    K6_SMEM_BUDGET, fold_linear_forms, pencil_sweep_2d, pencil_sweep_2d_kernel,
    pencil_sweep_2d_plain)
from bricklib_tpu_torch.convert import storage_from_reference

from torch_2d_stencils import (BUILDERS, PARAMS, asym9, box9, lin5, nonlin,
                               poly_system, varcoeff, wave)

TOL = 5e-5


def _table(kind, gy):
    grid, info = init_grid((gy, 1))
    t = np.asarray(grid)[:, 0].copy()
    if kind == "periodic":
        t[0], t[-1] = t[-2], t[1]
    return t, info.nbricks


CASES = [  # name, fuse, BY, table, y_range ("skip" or "ghost")
    ("lin5", 1, 4, "periodic", "skip"),
    ("box9", 1, 8, "grid", "skip"),
    ("asym9", 1, 4, "grid", "ghost"),
    ("nonlin", 1, 4, "grid", "skip"),
    ("lin5", 2, 8, "grid", "skip"),
    ("lin5", 4, 8, "periodic", "skip"),
    ("box9", 4, 32, "periodic", "skip"),
    ("box9", 4, 8, "grid", "ghost"),
    ("asym9", 2, 8, "grid", "ghost"),
    ("nonlin", 2, 8, "grid", "ghost"),
    ("varcoeff", 1, 4, "grid", "skip"),
    ("poly_system", 1, 4, "periodic", "skip"),
    ("wave", 1, 8, "grid", "ghost"),
]


@pytest.mark.parametrize("name,fuse,by,kind,ranges", CASES)
def test_sweep_2d_matches_reference(name, fuse, by, kind, ranges):
    X, gy = 16, 5
    table, nb = _table(kind, gy)
    yr = (0, gy) if ranges == "ghost" else (1, gy - 1)
    ref, port = BUILDERS[name](ref_st), BUILDERS[name](port_st)
    kw = dict(y_range=yr, fuse=fuse)
    want_fn = pallas_pencil_sweep_2d(ref, table, (by, X), nb, PARAMS,
                                     interpret=True, **kw)
    fn = pencil_sweep_2d(port, table, (by, X), nb, PARAMS, **kw)
    fields = getattr(fn, "fields", None)
    assert fields == getattr(want_fn, "fields", None)
    xs = [random_array((nb, by, X), np.float32, 30 + f)
          for f in range(len(fields or (0,)))]
    want = want_fn(*[jnp.asarray(x) for x in xs])
    before = pencil_sweep_2d_kernel.launches
    got = fn(*[storage_from_reference(x, "cpu") for x in xs])
    assert pencil_sweep_2d_kernel.launches == before
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    w = fn.plan.written_bricks()
    assert len(w) == yr[1] - yr[0] - (1 if kind == "periodic"
                                      and ranges == "ghost" else 0)
    for g, wv in zip(got, want):
        assert compare_arrays(g.numpy()[w], np.asarray(wv)[w], TOL)


def test_fused_equals_composed_sweeps():
    """On a periodic table ``fuse=4`` equals four ``fuse=1`` sweeps."""
    X, gy, by = 16, 6, 8
    table, nb = _table("periodic", gy)
    sd = box9(port_st)
    one = pencil_sweep_2d(sd, table, (by, X), nb)
    four = pencil_sweep_2d(sd, table, (by, X), nb, fuse=4)
    x = storage_from_reference(random_array((nb, by, X), np.float32, 40),
                               "cpu")
    want = x
    for _ in range(4):
        want = one(want)
        want[table[0]], want[table[-1]] = want[table[-2]], want[table[1]]
    w = four.plan.written_bricks()
    assert compare_arrays(four(x)[w].numpy(), want[w].numpy(), 1e-5)


def test_tap_folder_on_the_wave_system():
    sds = wave(port_st)
    fields = ("p", "v")
    got = [dict(fold_linear_forms(StencilIR.from_def(s), fields, {}))
           for s in sds]
    nbr = {(0, 1, 0): 0.2, (0, -1, 0): 0.2, (0, 0, 1): 0.2,
           (0, 0, -1): 0.2}
    want_p = {**nbr, (0, 0, 0): 0.2, (1, 0, 0): 1.0}
    want_v = {**nbr, (0, 0, 0): -0.8, (1, 0, 0): 1.0}
    for g, w in zip(got, (want_p, want_v)):
        assert set(g) == set(w)
        for k in w:
            assert abs(g[k] - w[k]) < 1e-12, k


def test_tap_folder_refuses_nonlinear_stencils():
    for sd in (nonlin(port_st), poly_system(port_st)[0]):
        assert fold_linear_forms(StencilIR.from_def(sd),
                              list(sd.inputs), {}) is None
    fn = pencil_sweep_2d(poly_system(port_st), np.arange(4), (4, 16), 4)
    assert fn.plan.taps is None


def test_k6_plan_at_the_full_2d_shape():
    """bench.py's 2-D leg: 16384^2 as (32, 16384) bricks, fuse 4.  K6
    streams chunks of brick rows in groups of 8 or 16 rows through x tiles
    that divide the width or whose rows (the tile and a margin of 4
    columns, fuse x radius) are whole warps of 32, in 227 KB of shared
    memory and enough blocks to fill the card's 132 SMs, runs the box's
    compiled groups and folds the box into three (field, dx) groups of
    three dy coefficients each."""
    table, nb = _table("periodic", 16384 // 32 + 2)
    assert nb == 514
    fn = pencil_sweep_2d(box9(port_st), table, (32, 16384), nb, fuse=4)
    sp = fn.plan.stream()
    assert 16384 % sp.tx == 0 or (sp.tx + 2 * sp.h) % 32 == 0
    assert sp.smem_bytes <= K6_SMEM_BUDGET and fn.plan.layout()
    assert sp.g in (8, 16) and (sp.h, sp.pw) == (4, 4)
    assert sp.nstream >= 132 and sp.nchunk * sp.ych >= 512
    gbeg, gfield, gdx, coef = fn.plan.groups()
    assert list(gbeg) == [0, 3] and sorted(gdx) == [-1, 0, 1]
    assert coef.shape == (9,) and abs(coef.sum() - 0.88) < 1e-6


def _bad(name="lin5", by=4, X=16, table=None, **kw):
    return (name, np.arange(6) if table is None else table, (by, X), 6,
            PARAMS), kw


@pytest.mark.parametrize("args,kw", [
    _bad("asym9", fuse=4),                       # 4 x 2 > BY 4
    _bad("asym9", by=8, fuse=5),
    _bad("varcoeff", fuse=2),
    _bad("poly_system", fuse=2),
    _bad(fuse=0),
    _bad(y_range=(0, 7)),
    _bad(y_range=(3, 3)),
    _bad("asym9", by=1),
    _bad("asym9", X=2),
    _bad(table=np.arange(12).reshape(6, 2)),
])
def test_invalid_arguments_raise_as_the_reference(args, kw):
    name, rest = args[0], args[1:]
    with pytest.raises(ValueError) as ref:
        pallas_pencil_sweep_2d(BUILDERS[name](ref_st), *rest,
                               interpret=True, **kw)
    with pytest.raises(ValueError) as port:
        pencil_sweep_2d(BUILDERS[name](port_st), *rest, **kw)
    assert str(port.value) == str(ref.value)


def test_three_d_stencil_and_bf16_raise():
    with pytest.raises(NotImplementedError, match="2-D"):
        pencil_sweep_2d("s7pt", np.arange(6), (4, 16), 6)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pencil_sweep_2d(lin5(port_st), np.arange(6), (4, 16), 6, PARAMS,
                        dtype=torch.bfloat16)


def test_views_are_checked_and_the_kernel_refuses_cpu_tensors():
    fn = pencil_sweep_2d(varcoeff(port_st), np.arange(6), (4, 16), 6)
    assert fn.fields == ("c", "in")      # first-seen order of the taps
    x = torch.zeros(6, 4, 16)
    with pytest.raises(TypeError, match="fn.fields"):
        fn(x)
    with pytest.raises(ValueError, match="storage shape"):
        fn(x, torch.zeros(5, 4, 16))
    before = pencil_sweep_2d_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        pencil_sweep_2d_kernel([x, x], torch.arange(6, dtype=torch.int32),
                               fn.plan)
    assert pencil_sweep_2d_kernel.launches == before
    with pytest.raises(ValueError, match="outside 5 bricks"):
        pencil_sweep_2d(lin5(port_st), np.arange(6), (4, 16), 5, PARAMS)


def test_plain_version_is_deterministic_on_the_table_rows():
    table, nb = _table("grid", 4)
    fn = pencil_sweep_2d(lin5(port_st), table, (4, 16), nb, PARAMS)
    x = storage_from_reference(random_array((nb, 4, 16), np.float32, 9),
                               "cpu")
    a = pencil_sweep_2d_plain([x], torch.from_numpy(fn.plan.table), fn.plan)
    w = fn.plan.written_bricks()
    assert torch.equal(a[0][w], fn(x)[w])
