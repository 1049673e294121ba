"""The port's dense padded-array stencil
(``bricklib_tpu_torch.codegen.dense_kernel``) against the reference
``pallas_dense_stencil`` in interpret mode.

Both packages get the same numpy arrays and params.  The output rows
between the k and j pads are compared over the whole padded i width (the
i taps wrap around the padded row in both), at abs-or-rel 1e-5 (float32
sums in another order); the port's pad rows must be zero.  On the CPU the
port runs kernel K7's plain version; the kernel itself is held against
that plain version on the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu import st as ref_st
from bricklib_tpu.codegen import pallas_backend as ref_pb
from bricklib_tpu.core import compare_arrays, random_array
from bricklib_tpu.stencils import DEFAULT_PARAMS, stencil_by_name
from bricklib_tpu_torch import st as port_st
from bricklib_tpu_torch import stencils as port_stencils
from bricklib_tpu_torch.codegen.dense_kernel import (brick_stencil,
                                                     choose_tile,
                                                     dense_stencil,
                                                     dense_stencil_kernel)

from torch_2d_stencils import two_inputs_3d

TOL = 1e-5
PARAMS = dict(DEFAULT_PARAMS)
PARAMS["coeff"] = [0.03 * (c + 1) for c in range(27)]


def _check(ref_fn, port_fn, arrs, pad):
    want = np.asarray(ref_fn(*[jnp.asarray(a) for a in arrs]))
    before = dense_stencil_kernel.launches
    got = port_fn(*[torch.from_numpy(a) for a in arrs]).numpy()
    assert dense_stencil_kernel.launches == before
    assert got.shape == want.shape == arrs[0].shape
    pk, pj, _pi = pad
    inner = (slice(pk, got.shape[0] - pk), slice(pj, got.shape[1] - pj))
    assert compare_arrays(got[inner], want[inner], TOL)
    mask = np.ones(got.shape, bool)
    mask[inner] = False
    assert not got[mask].any()


def test_dense_matches_the_reference():
    """The case of tests/test_pallas_backend.py:53-60."""
    arr = random_array((24, 32, 128), np.float32, 3)
    pad = (4, 8, 48)
    ref = ref_pb.pallas_dense_stencil(stencil_by_name("mpi13pt")[0],
                                      arr.shape, pad, PARAMS,
                                      tile_elems=(8, 8), interpret=True)
    fn = dense_stencil(port_stencils.stencil_by_name("mpi13pt")[0],
                       arr.shape, pad, PARAMS, tile_elems=(8, 8))
    _check(ref, fn, [arr], pad)


def test_dense_two_inputs_match_the_reference():
    arrs = [random_array((12, 24, 128), np.float32, s) for s in (4, 5)]
    pad = (2, 8, 48)
    ref = ref_pb.pallas_dense_stencil(two_inputs_3d(ref_st), arrs[0].shape,
                                      pad, {}, interpret=True)
    fn = dense_stencil(two_inputs_3d(port_st), arrs[0].shape, pad, {})
    assert fn.fields == ref.fields == ("u", "v")
    assert fn.plan.taps is not None and len(fn.plan.taps) == 4
    _check(ref, fn, arrs, pad)
    with pytest.raises(TypeError, match="reads 2 grids"):
        fn(torch.from_numpy(arrs[0]))


@pytest.mark.parametrize("name", ["cond", "s27pt"])
def test_dense_cond_and_box_match_the_reference(name):
    arr = random_array((10, 24, 128), np.float32, 6)
    pad = (1, 8, 40)
    ref = ref_pb.pallas_dense_stencil(stencil_by_name(name)[0], arr.shape,
                                      pad, PARAMS, interpret=True)
    fn = dense_stencil(port_stencils.stencil_by_name(name)[0], arr.shape,
                       pad, PARAMS)
    assert (fn.plan.taps is None) == (name == "cond")
    _check(ref, fn, [arr], pad)


@pytest.mark.parametrize("cells,bdims", [((32, 32), (8, 8)), ((3, 5), (4, 4)),
                                         ((12, 7, 9), (2, 1, 32)),
                                         ((64,), (1,))])
def test_choose_tile_is_the_references(cells, bdims):
    assert choose_tile(cells, bdims) == ref_pb.choose_tile(cells, bdims)
    assert choose_tile(cells, bdims, 8) == ref_pb.choose_tile(cells, bdims, 8)


@pytest.mark.parametrize("name,shape,pad,kw,exc", [
    ("mpi9pt", (8, 8, 8, 128), (1, 8, 8, 8), {}, NotImplementedError),
    ("mpi13pt", (24, 32, 128), (1, 8, 48), {}, ValueError),
    ("s7pt", (24, 32, 130), (1, 8, 1), {}, ValueError),
    ("s7pt", (24, 32, 128), (1, 8, 48), dict(tile_elems=(5, 8)), ValueError),
    ("s7pt", (24, 32, 128), (1, 8, 48), dict(tile_elems=(2, 4)), ValueError),
    ("mpi13pt", (24, 32, 128), (4, 4, 48), {}, ValueError),
])
def test_argument_checks_raise_as_the_reference(name, shape, pad, kw, exc):
    with pytest.raises(exc) as ref:
        ref_pb.pallas_dense_stencil(stencil_by_name(name)[0], shape, pad,
                                    PARAMS, interpret=True, **kw)
    with pytest.raises(exc) as port:
        dense_stencil(port_stencils.stencil_by_name(name)[0], shape, pad,
                      PARAMS, **kw)
    assert str(port.value) == str(ref.value)


def test_unported_and_card_only_calls_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        brick_stencil("s7pt", np.zeros((3, 3, 3), np.int32), (4, 4, 8),
                      (1, 1, 1), 27)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        dense_stencil("s7pt", (10, 24, 128), (1, 8, 48), PARAMS,
                      dtype=torch.bfloat16)
    fn = dense_stencil("s7pt", (10, 24, 128), (1, 8, 48), PARAMS)
    with pytest.raises(ValueError, match="array shape"):
        fn(torch.zeros(10, 24, 64))
    with pytest.raises(ValueError, match="CUDA"):
        dense_stencil_kernel([torch.zeros(10, 24, 128)], fn.plan)
