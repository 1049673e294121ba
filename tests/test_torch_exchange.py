"""The port's one-device SHIFT exchange (``bricklib_tpu_torch.comm.exchange``)
against the reference ``exchange_shift`` on a (1, 1, 1) mesh.

The same random storage goes to both; the exchange only copies, so the
results must be equal bit for bit.  On the CPU the port runs kernel K2's
plain version; the kernel itself is held against it on the card in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu.comm.exchange import exchange_shift as exchange_shift_ref
from bricklib_tpu.core import random_array
from bricklib_tpu_torch import comm as port_comm
from bricklib_tpu_torch.comm.exchange import (copy_intervals,
                                              copy_intervals_plain,
                                              exchange_shift, shift_exchange,
                                              shift_stages)
from bricklib_tpu_torch.convert import storage_from_reference

MESH = (1, 1, 1)


def _dec(dims=(32, 32, 32), bd=(8, 8, 32), gz=(8, 8, 0), skin="good",
         pkg=port_comm):
    """The test decomposition from ``pkg``'s ``comm``: the port's by
    default, the reference's with ``pkg=None``."""
    bdec, skins = ((BrickDecomp, skinlist_by_name) if pkg is None
                   else (pkg.BrickDecomp, pkg.skinlist_by_name))
    return bdec(dims=dims, ghost_depth=gz, bdims=bd).initialize(
        skins(skin, len(dims)))


@pytest.mark.parametrize("table_axes", [(2,), ()])
@pytest.mark.parametrize("skin", ["good", "lex"])
def test_exchange_matches_reference(table_axes, skin):
    dec = _dec(skin=skin)
    x = random_array((dec.nbricks,) + tuple(dec.bdims), np.float32, 11)
    want = np.asarray(exchange_shift_ref(
        jnp.asarray(x), _dec(skin=skin, pkg=None), ("x", "y", "z"), MESH,
        interpret=True,
        table_axes=table_axes))
    dat = storage_from_reference(x, "cpu")
    before = copy_intervals.launches
    got = exchange_shift(dat, dec, MESH, table_axes=table_axes)
    assert copy_intervals.launches == before
    assert got is dat            # in place, as input_output_aliases
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, x)     # the exchange moved bricks


def test_exchange_with_ghost_in_every_axis_matches_reference():
    cfg = dict(dims=(16, 16, 32), bd=(4, 4, 8), gz=(4, 4, 8))
    dec = _dec(**cfg)
    x = random_array((dec.nbricks,) + tuple(dec.bdims), np.float32, 12)
    want = np.asarray(exchange_shift_ref(
        jnp.asarray(x), _dec(**cfg, pkg=None), ("x", "y", "z"), MESH,
        interpret=True))
    got = exchange_shift(storage_from_reference(x, "cpu"), dec, MESH)
    assert len(shift_stages(dec, MESH)) == 3
    assert np.array_equal(got.numpy(), want)


def test_stages_skip_table_axes_and_do_not_overlap():
    dec = _dec()
    for table_axes, n in (((0, 1, 2), 0), ((1, 2), 1), ((2,), 2)):
        stages = shift_stages(dec, MESH, table_axes)
        assert len(stages) == n
        for ivs in stages:
            dst = sorted((d0, d1) for d0, d1, _, _ in ivs)
            assert all(a1 <= b0 for (_, a1), (b0, _) in zip(dst, dst[1:]))
            for d0, d1, _, _ in ivs:
                assert all(d1 <= s0 or s1 <= d0 for _, _, s0, s1 in ivs)


def test_plan_reused_across_calls():
    dec = _dec()
    x = random_array((dec.nbricks,) + tuple(dec.bdims), np.float32, 13)
    ex = shift_exchange(dec, MESH, (2,))
    a = storage_from_reference(x, "cpu")
    b = storage_from_reference(x, "cpu")
    ex(a)
    for ivs in ex.stages:
        copy_intervals_plain(b, ivs)
    assert torch.equal(a, b)
    assert torch.equal(ex(a.clone()), a)       # a second exchange is a no-op


def test_multi_device_mesh_raises():
    dec = _dec()
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        shift_stages(dec, (2, 1, 1))


def test_bad_intervals_and_storage_raise():
    dat = torch.zeros(10, 4, 4)
    with pytest.raises(ValueError, match="invalid"):
        copy_intervals(dat, [(8, 11, 0, 3)])
    with pytest.raises(ValueError, match="invalid"):
        copy_intervals(dat, [(0, 2, 4, 7)])
    with pytest.raises(ValueError, match="contiguous"):
        copy_intervals(dat.transpose(1, 2), [(0, 1, 2, 3)])
    dec = _dec()
    with pytest.raises(ValueError, match="brick rows"):
        shift_exchange(dec, MESH, (2,))(torch.zeros(dec.nbricks - 1, 8))



@pytest.mark.parametrize("table_axes", [(3,), ()])
def test_4d_exchange_matches_reference(table_axes):
    """The exchange plan is rank-generic: the 4-D step's SHIFT exchange
    (three staged axes with the i axis through the table) is bit-exact
    against the reference on a (1, 1, 1, 1) mesh."""
    cfg = dict(dims=(8, 8, 8, 16), gz=(4, 4, 4, 0), bd=(4, 4, 4, 16))
    dec = _dec(**cfg)
    x = random_array((dec.nbricks,) + tuple(dec.bdims), np.float32, 15)
    mesh = (1, 1, 1, 1)
    want = np.asarray(exchange_shift_ref(
        jnp.asarray(x), _dec(**cfg, pkg=None), ("w", "x", "y", "z"), mesh,
        interpret=True,
        table_axes=table_axes))
    got = exchange_shift(storage_from_reference(x, "cpu"), dec, mesh,
                         table_axes=table_axes)
    assert len(shift_stages(dec, mesh, table_axes)) == 3
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, x)
