"""The port's rank-5+ pencil sweep (``codegen.pencil_kernel_nd``, plain
version on the CPU) against the reference ``pallas_pencil_sweep_nd`` in
interpret mode, and its argument errors side by side with the
reference's.

The decomposition is 5-D, dims (4, 4, 8, 8, 16), bricks (2, 2, 4, 4, 16),
ghost (2, 2, 4, 4, 0): table (4, 4, 4, 4), 257 bricks.  The port adds the
taps in tap order, the reference its factorized form, so outputs are
compared at abs-or-rel 1e-5 on the bricks the sweep writes (every other
brick is undefined in both).  One interpret-mode call takes about 15 s,
so four cases call the reference: a single-input star, a two-input
stencil, a stencil with corner taps, and non-default ranges that reach
the table edges.  Kernel K12 itself is held against this plain version on
the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu import st as ref_st
from bricklib_tpu.codegen.pencil_kernel_nd import pallas_pencil_sweep_nd
from bricklib_tpu.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu.core import compare_arrays
from bricklib_tpu_torch import st as port_st
from bricklib_tpu_torch.codegen import pencil_kernel_nd as nd
from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain
from torch_nd_stencils import nd_twin, star_nd

DIMS, BD = (4, 4, 8, 8, 16), (2, 2, 4, 4, 16)
TOL = 1e-5


def stencil5(st, **kw):
    """The 11-point 5-D star of :func:`torch_nd_stencils.star_nd`."""
    return star_nd(st, 5, **kw)


@pytest.fixture(scope="module")
def dec():
    d = BrickDecomp(dims=DIMS, ghost_depth=BD[:-1] + (0,),
                    bdims=BD).initialize(skinlist_by_name("good", 5))
    assert d.grid.shape == (4, 4, 4, 4, 1) and d.nbricks == 257
    return d


def _inputs(dec, n):
    rng = np.random.default_rng(3)
    return [rng.random((dec.nbricks,) + BD, dtype=np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("kw,ranges", [
    (dict(), None),
    (dict(two=True), None),
    (dict(corner=True), None),
    (dict(), ((0, 3), (1, 4), (0, 4), (2, 3))),
], ids=["star", "two-input", "corner-taps", "ranges"])
def test_sweep_matches_reference_kernel(dec, kw, ranges):
    ref = pallas_pencil_sweep_nd(stencil5(ref_st, **kw), dec.grid, BD,
                                 dec.nbricks, {}, ranges=ranges,
                                 interpret=True)
    port = nd.pencil_sweep_nd(stencil5(port_st, **kw), dec.grid, BD,
                              dec.nbricks, {}, ranges=ranges)
    xs = _inputs(dec, 2 if kw.get("two") else 1)
    want = np.asarray(ref(*[jnp.asarray(x) for x in xs]))
    got = port(*[torch.from_numpy(x) for x in xs])
    if kw.get("two"):
        assert port.fields == ref.fields == ("in", "aux")
    w = port.plan.written_bricks()
    want_w = np.sort(dec.grid[..., 0][tuple(
        slice(a, b) for a, b in (ranges or ((1, 3),) * 4))].ravel())
    assert np.array_equal(w, want_w)
    err = float(np.abs(got.numpy()[w] - want[w]).max())
    assert compare_arrays(got.numpy()[w], want[w], TOL), err
    assert nd.pencil_sweep_nd_kernel.launches == 0          # the CPU


def _errors(sweep, st, kw):
    with pytest.raises(Exception) as e:
        sweep(**kw(st))
    return type(e.value), str(e.value)


def _g(shape):
    return np.arange(1, int(np.prod(shape)) + 1).reshape(shape)


ERRORS = {
    "rank-4": lambda st: dict(stencil=_star4(st), grid=_g((4, 4, 4)),
                              bdims=(2, 4, 4, 16), nbricks=65),
    "fuse": lambda st: dict(stencil=stencil5(st), grid=_g((4,) * 4),
                            bdims=BD, nbricks=257, fuse=2),
    "radius": lambda st: dict(stencil=stencil5(st, radius=3),
                              grid=_g((4,) * 4), bdims=BD, nbricks=257),
    "bdims": lambda st: dict(stencil=stencil5(st), grid=_g((4,) * 4),
                             bdims=BD[:4], nbricks=257),
    "grid-trailing": lambda st: dict(stencil=stencil5(st),
                                     grid=_g((4, 4, 4, 4, 2)), bdims=BD,
                                     nbricks=513),
    "grid-rank": lambda st: dict(stencil=stencil5(st), grid=_g((4, 4, 4)),
                                 bdims=BD, nbricks=65),
    "ranges": lambda st: dict(stencil=stencil5(st), grid=_g((4,) * 4),
                              bdims=BD, nbricks=257,
                              ranges=((1, 3),) * 3),
    "lookahead": lambda st: dict(stencil=stencil5(st), grid=_g((4,) * 4),
                                 bdims=BD, nbricks=257, lookahead=0),
    "tile_j": lambda st: dict(stencil=stencil5(st), grid=_g((4,) * 4),
                              bdims=BD, nbricks=257, tile_j=3),
}


def _star4(st):
    idx = [st.Index(a) for a in range(4)]
    g, o = st.Grid("in", 4), st.Grid("out", 4)
    o(*idx).assign(0.5 * g(*idx))
    return st.load_stencil_module({"STENCIL": [o]})[0]


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_argument_errors_match_reference(case):
    """Each refusal raises the reference's exception type and message
    (checked before the reference would build its kernel)."""
    ref = _errors(lambda **k: pallas_pencil_sweep_nd(interpret=True, **k),
                  ref_st, ERRORS[case])
    port = _errors(nd.pencil_sweep_nd, port_st, ERRORS[case])
    assert port == ref


def test_tpu_knobs_are_accepted(dec):
    """``tile_j``, ``lookahead``, ``vmem_limit_bytes`` and ``interpret``
    change nothing, nor does a BI that is no multiple of 128 (a Mosaic rule
    of the TPU)."""
    x = torch.from_numpy(_inputs(dec, 1)[0])
    base = nd.pencil_sweep_nd(stencil5(port_st), dec.grid, BD, dec.nbricks)
    knobs = nd.pencil_sweep_nd(stencil5(port_st), dec.grid, BD, dec.nbricks,
                               tile_j=1, lookahead=3, interpret=False,
                               vmem_limit_bytes=1 << 20)
    w = base.plan.written_bricks()
    assert torch.equal(base(x)[w], knobs(x)[w])


def test_kernel_caps_and_devices(dec):
    """What kernel K12 refuses, checked on the host before a launch: a rank
    above its cap (naming it), a nonlinear stencil (the port's rule for
    ``cond`` on a CUDA tensor), CPU tensors; the plain version takes
    them."""
    plan = nd.pencil_sweep_nd(stencil5(port_st), dec.grid, BD,
                              dec.nbricks).plan
    rows, nf = nd.k12_args(plan)
    assert rows.shape == (11, 7) and nf == 1
    assert np.array_equal(rows[:, 2:], plan.taps.offsets)
    assert np.array_equal(rows[:, 1].view(np.float32), plan.taps.coeffs)

    idx = [port_st.Index(a) for a in range(9)]
    g9, o9 = port_st.Grid("in", 9), port_st.Grid("out", 9)
    o9(*idx).assign(0.5 * g9(*idx))
    sd9 = port_st.load_stencil_module({"STENCIL": [o9]})[0]
    fn9 = nd.pencil_sweep_nd(sd9, np.ones((1,) * 8, np.int32), (1,) * 9, 2,
                             ranges=((0, 1),) * 8)
    with pytest.raises(ValueError, match="K12_MAX_RANK = 8"):
        nd.k12_args(fn9.plan)
    x9 = torch.ones((2,) + (1,) * 9)
    assert float(fn9(x9)[1].sum()) == 0.5          # the plain version

    idx = [port_st.Index(a) for a in range(5)]
    g, o = port_st.Grid("in", 5), port_st.Grid("out", 5)
    up = list(idx)
    up[3] = idx[3] + 1
    o(*idx).assign(port_st.Func("max", 2)(g(*idx), port_st.ConstRef("0.25"))
                   + 0.5 * g(*up))
    sdn = port_st.load_stencil_module({"STENCIL": [o]})[0]
    fnn = nd.pencil_sweep_nd(sdn, dec.grid, BD, dec.nbricks)
    assert fnn.plan.taps is None
    with pytest.raises(NotImplementedError, match="remaining pencil_sweep"):
        nd.k12_args(fnn.plan)
    x = torch.from_numpy(_inputs(dec, 1)[0])
    w = fnn.plan.written_bricks()
    assert torch.isfinite(fnn(x)[w]).all()

    table = torch.from_numpy(plan.table)
    with pytest.raises(ValueError, match="CUDA tensors"):
        nd.pencil_sweep_nd_kernel([x], table, torch.from_numpy(rows), plan)
    two = nd.pencil_sweep_nd(stencil5(port_st, two=True), dec.grid, BD,
                             dec.nbricks)
    with pytest.raises(TypeError, match="reads 2 grids"):
        two(x)
    with pytest.raises(ValueError, match="table ids span"):
        nd.pencil_sweep_nd(stencil5(port_st), dec.grid, BD, 100)


def test_plain_two_inputs_by_hand(dec):
    """The multi-input plain sweep against dense tensor code
    (:func:`torch_nd_stencils.nd_twin`): each input gathered to its dense
    block, one slice per tap, rolled along i."""
    from bricklib_tpu_torch.core.setup import from_bricks

    fn = nd.pencil_sweep_nd(stencil5(port_st, two=True, corner=True),
                            dec.grid, BD, dec.nbricks)
    xs = [torch.from_numpy(a) for a in _inputs(dec, 2)]
    got = fn(*xs)
    own = from_bricks(got.view(dec.nbricks, -1), dec.interior_grid(), BD)
    want = nd_twin(xs, fn.plan, dec)
    assert compare_arrays(own.numpy(), want.numpy(), TOL)
    plan = fn.plan
    direct = pencil_sweep_plain(xs, torch.from_numpy(plan.table), plan)
    w = plan.written_bricks()
    assert torch.equal(direct[w], got[w])
