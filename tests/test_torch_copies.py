"""The port's own copies of the JAX package's numpy modules (the eDSL, the
stencil corpus, the IR, the evaluator, the layout and decomposition
planner, ``utils``, the numpy executors) against their originals.

Each object is built by its own package from the same arguments and the
two are compared field by field; numeric results must be equal bit for
bit (the copies run the same numpy code).
"""

import numpy as np
import pytest
import torch

from bricklib_tpu import comm as ref_comm
from bricklib_tpu import core as ref_core
from bricklib_tpu import stencils as ref_stencils
from bricklib_tpu import utils as ref_utils
from bricklib_tpu.codegen import jnp_backend as ref_backend
from bricklib_tpu.codegen.ir import StencilIR as RefIR
from bricklib_tpu.utils.zmort import zmort_ids as ref_zmort_ids
from bricklib_tpu_torch import comm as port_comm
from bricklib_tpu_torch import core as port_core
from bricklib_tpu_torch import stencils as port_stencils
from bricklib_tpu_torch import utils as port_utils
from bricklib_tpu_torch.codegen import jnp_backend as port_backend
from bricklib_tpu_torch.codegen.ir import StencilIR as PortIR
from bricklib_tpu_torch.core import setup as port_setup
from bricklib_tpu_torch.utils.zmort import zmort_ids as port_zmort_ids

CORPUS = ref_stencils.CORPUS


def _expr(e):
    """An eDSL expression as a comparable nested tuple, whichever package:
    node class, its own fields, then its children."""
    own = []
    for attr in ("name", "val", "op", "offsets"):
        v = getattr(e, attr, None)
        if v is not None:
            own.append(getattr(v, "name", v) if attr == "op" else v)
    if hasattr(e, "grid"):
        own.append(e.grid.name)
    if hasattr(e, "callee"):
        own.append(e.callee.name)
    return (type(e).__name__, tuple(map(str, own)),
            tuple(_expr(c) for c in e.children))


def _linear(ir):
    if ir.linear is None:
        return None
    return [(key, _expr(c), [(s, g, tuple(o)) for s, g, o in taps])
            for key, c, taps in ir.linear]


def test_corpus_and_params_are_the_same():
    assert port_stencils.CORPUS == CORPUS
    assert port_stencils.DEFAULT_PARAMS == ref_stencils.DEFAULT_PARAMS
    assert port_stencils.bench_params() == ref_stencils.bench_params()


@pytest.mark.parametrize("name", CORPUS)
def test_stencil_matches_its_original(name):
    (ref,), (port,) = (ref_stencils.stencil_by_name(name),
                       port_stencils.stencil_by_name(name))
    assert type(port).__module__.startswith("bricklib_tpu_torch.")
    assert port.dims == ref.dims
    assert list(port.inputs) == list(ref.inputs)
    assert port.output.name == ref.output.name
    assert [(t.grid.name, tuple(t.offsets)) for t in port.taps] == \
        [(t.grid.name, tuple(t.offsets)) for t in ref.taps]
    assert port.radius() == ref.radius()
    assert port.tap_offsets_np() == ref.tap_offsets_np()
    assert _expr(port.rhs) == _expr(ref.rhs)
    assert _linear(PortIR.from_def(port)) == _linear(RefIR.from_def(ref))


DECOMPS = [((16, 16), (4, 0), (4, 16)),
           ((16, 16, 32), (8, 8, 0), (8, 8, 32)),
           ((16, 16, 16), (4, 4, 8), (4, 4, 8)),
           ((8, 8, 8, 16), (4, 4, 4, 0), (4, 4, 4, 16))]


@pytest.mark.parametrize("dims,ghost,bdims", DECOMPS)
def test_brick_decomp_matches_its_original(dims, ghost, bdims):
    nd = len(dims)
    ref = ref_comm.BrickDecomp(dims=dims, ghost_depth=ghost,
                               bdims=bdims).initialize(
        ref_comm.skinlist_by_name("good", nd))
    port = port_comm.BrickDecomp(dims=dims, ghost_depth=ghost,
                                 bdims=bdims).initialize(
        port_comm.skinlist_by_name("good", nd))
    assert type(port).__module__.startswith("bricklib_tpu_torch.")
    assert np.array_equal(port.grid, ref.grid)
    assert port.nbricks == ref.nbricks
    assert port.sep_pos == ref.sep_pos
    assert np.array_equal(port.info.adj, ref.info.adj)
    assert np.array_equal(port.owned_mask(), ref.owned_mask())
    assert np.array_equal(port.interior_grid(), ref.interior_grid())
    axes = tuple(range(nd))
    assert np.array_equal(port.periodic_grid(axes), ref.periodic_grid(axes))

    def runs(rs):
        return [(repr(r.neighbor), r.pos, r.len, r.skin_st, r.skin_ed)
                for r in rs]

    assert runs(port.ghost) == runs(ref.ghost)
    assert runs(port.skin) == runs(ref.skin)
    assert [(repr(s.owner), s.skin_idx, s.pos, s.len)
            for s in port.sections] == [(repr(s.owner), s.skin_idx, s.pos,
                                         s.len) for s in ref.sections]


@pytest.mark.parametrize("nd", [2, 3, 4])
def test_skins_and_utils_match_their_originals(nd):
    assert [repr(b) for b in port_comm.skinlist_by_name("good", nd)] == \
        [repr(b) for b in ref_comm.skinlist_by_name("good", nd)]
    shape = (4,) * nd
    assert np.array_equal(port_zmort_ids(shape), ref_zmort_ids(shape))
    assert repr(port_utils.BitSet({1, -2})) == repr(ref_utils.BitSet({1, -2}))


@pytest.mark.parametrize("name", CORPUS)
def test_dense_apply_matches_its_original_on_numpy(name):
    ref_sd = ref_stencils.stencil_by_name(name)[0]
    port_sd = port_stencils.stencil_by_name(name)[0]
    shape = (6, 6, 6, 10) if ref_sd.dims == 4 else (10, 10, 12)
    a = ref_core.random_array(shape, np.float32, 3)
    g = next(iter(ref_sd.inputs))
    prm = ref_stencils.bench_params()
    want = ref_backend.dense_apply(ref_sd, {g: a}, prm, xp=np)
    got = port_backend.dense_apply(port_sd, {g: a}, prm)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_brick_apply_and_brick_copies_match_their_originals():
    ref_dec = ref_comm.BrickDecomp(dims=(16, 16, 16), ghost_depth=(4, 4, 8),
                                   bdims=(4, 4, 8)).initialize(
        ref_comm.skinlist_by_name("good", 3))
    port_dec = port_comm.BrickDecomp(dims=(16, 16, 16),
                                     ghost_depth=(4, 4, 8),
                                     bdims=(4, 4, 8)).initialize(
        port_comm.skinlist_by_name("good", 3))
    dense = ref_core.random_array((24, 24, 32), np.float32, 5)
    want = ref_core.to_bricks(dense, ref_dec.grid, (4, 4, 8))
    got = port_setup.to_bricks(dense, port_dec.grid, (4, 4, 8))
    assert np.array_equal(got, want)
    assert np.array_equal(
        port_setup.from_bricks(got, port_dec.grid, (4, 4, 8)),
        ref_core.from_bricks(want, ref_dec.grid, (4, 4, 8)))
    view = want.reshape((-1, 4, 4, 8))
    prm = ref_stencils.bench_params()
    for name in ("s7pt", "cond"):
        w = ref_backend.brick_apply(ref_stencils.stencil_by_name(name)[0],
                                    {"bIn": view}, ref_dec.info.adj, prm,
                                    xp=np)
        g = port_backend.brick_apply(port_stencils.stencil_by_name(name)[0],
                                     {"bIn": view}, port_dec.info.adj, prm)
        assert np.array_equal(g, w), name
    # the torch paths of the layout copies give the numpy results
    t = port_setup.to_bricks(torch.from_numpy(dense), port_dec.grid,
                             (4, 4, 8))
    assert np.array_equal(t.numpy(), want)
    ext = port_setup.halo_extend(torch.from_numpy(view), port_dec.info.adj,
                                 (1, 1, 1), (1, 1, 1))
    assert np.array_equal(ext.numpy(), port_setup.halo_extend(
        view, port_dec.info.adj, (1, 1, 1), (1, 1, 1)))


def test_compare_and_random_arrays_match_their_originals():
    a = ref_core.random_array((5, 7), np.float32, 9)
    assert np.array_equal(port_core.random_array((5, 7), np.float32, 9), a)
    b = a + np.float32(3e-5)
    for tol in (None, 1e-5, 1e-4):
        assert port_core.compare_arrays(a, b, tol) == \
            ref_core.compare_arrays(a, b, tol)


REF_STYLE = ("from st.expr import Index, ConstRef\n"
             "from st.grid import Grid\n"
             "i, j, k = Index(0), Index(1), Index(2)\n"
             "inp, out = Grid('bIn', 3), Grid('bOut', 3)\n"
             "out(i, j, k).assign(ConstRef('MPI_ALPHA') * inp(i, j, k)\n"
             "                    + 0.25 * inp(i + 1, j, k))\n"
             "STENCIL = [out]\n")


@pytest.mark.parametrize("ref_alias_first", [True, False])
def test_reference_style_file_leaves_each_package_its_st_alias(
        tmp_path, monkeypatch, ref_alias_first):
    """A reference-style file (``from st.expr import ...``) loads through
    the port's loader into the port's classes, and the global ``st`` alias
    is the JAX package's before and after, whichever claims it first."""
    import sys

    import bricklib_tpu.st as ref_st_pkg
    from bricklib_tpu.st.loader import _alias_st as ref_alias_st
    from bricklib_tpu_torch.st import loader as port_loader

    for n in ("st", "st.expr", "st.grid", "st.func"):
        monkeypatch.delitem(sys.modules, n, raising=False)
    if ref_alias_first:
        ref_alias_st()
    path = tmp_path / "ref_style.py"
    path.write_text(REF_STYLE)
    (sd,) = port_loader.load_stencil_module(str(path))
    assert isinstance(sd, port_loader.StencilDef)
    assert len(sd.tap_offsets_np()) == 2 and list(sd.inputs) == ["bIn"]
    assert sys.modules.get("st") is (ref_st_pkg if ref_alias_first else None)
    ref_alias_st()
    assert sys.modules["st"] is ref_st_pkg
