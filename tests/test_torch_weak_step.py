"""The port's honest weak step (``bricklib_tpu_torch.drivers.weak``) against
the reference composition: one SHIFT exchange with ``table_axes=(2,)``,
then a ghost-inclusive and an owned-only ``fuse=4`` sweep (the form of
``bench.py``'s headline step), at 32^3 in interpret mode; and the 4-D
step (``weak/main-4d.cpp``): one SHIFT exchange with ``table_axes=(3,)``,
then a ghost-inclusive and an owned-only ``fuse=2`` 4-D sweep, at
8x8x8x16.

Compared on the owned bricks (``dec.owned_mask()``) at abs-or-rel 1e-5;
the driver's own validation against the dense numpy twin runs at 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu.codegen.pencil_kernel import pallas_pencil_sweep
from bricklib_tpu.codegen.pencil_kernel_4d import pallas_pencil_sweep_4d
from bricklib_tpu.comm.exchange import exchange_shift as exchange_shift_ref
from bricklib_tpu.core import compare_arrays
from bricklib_tpu.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu.stencils import bench_params, stencil_by_name
from bricklib_tpu_torch.drivers import weak

N = 32
STEP = dict(dims=(N, N, N), bdim=(8, 8, N), stencil="s7pt", st_iter=8,
            fuse=4, table_periodic=False)
STEP4 = dict(dims=(8, 8, 8, 16), bdim=(4, 4, 4, 16), stencil="mpi9pt",
             st_iter=4, fuse=2, table_periodic=False)


def _reference_dec(dec):
    """The reference's own ``BrickDecomp`` for the port's ``dec``: the
    same arguments, so the same grid table and storage order."""
    ref = BrickDecomp(dims=dec.dims, ghost_depth=dec.ghost_depth,
                      bdims=dec.bdims).initialize(
        skinlist_by_name("good", len(dec.dims)))
    assert np.array_equal(ref.grid, dec.grid)
    assert ref.nbricks == dec.nbricks
    return ref


def _reference_step(x, dec):
    dec = _reference_dec(dec)
    sd = stencil_by_name("s7pt")[0]
    GK, GJ = dec.grid.shape[:2]
    bd, nb, prm = tuple(dec.bdims), dec.nbricks, bench_params()
    g_skip = pallas_pencil_sweep(sd, dec.grid, bd, nb, prm, fuse=4,
                                 interpret=True)
    g_ghost = pallas_pencil_sweep(sd, dec.grid, bd, nb, prm,
                                  k_range=(0, GK), j_range=(0, GJ), fuse=4,
                                  interpret=True)
    d = exchange_shift_ref(jnp.asarray(x), dec, ("x", "y", "z"), (1, 1, 1),
                           interpret=True, table_axes=(2,))
    return np.asarray(g_skip(g_ghost(d)))


def test_step_matches_reference_composition():
    step, storage, dec = weak.build_step(**STEP, device="cpu")
    x = storage.numpy().copy()
    want = _reference_step(x, dec)
    got = step(storage).numpy()
    own = dec.owned_mask()
    assert own.sum() == (N // 8) ** 2
    assert compare_arrays(got[own], want[own], 1e-5)


def test_run_validates_against_dense_twin(capsys):
    res = weak.run(**STEP, backend="pencil", validate=True, iters=2,
                   device="cpu")
    out = capsys.readouterr().out
    assert "validated against array twin: OK" in out
    assert "GStencil/s" in out and "exchange share" in out
    assert res["device"] == "cpu"
    assert res["calls"] == {"step": 1 + 1 + 2 + 2, "step_noex": 1 + 2 + 2,
                            "copy": 1 + 2}
    assert res["step"] > 0 and res["copy"] > 0


def test_validation_catches_a_wrong_step():
    s = weak._make_step((N, N, N), (8, 8, N), "s7pt", 8, 4, False, "good",
                        "cpu", quiet=True)
    assert weak.validate_step(s, "s7pt", 8)
    sweeps_only = s.step_noex
    s.step = sweeps_only            # drop the exchange: ghosts stay zero
    assert not weak.validate_step(s, "s7pt", 8)


def test_cli_runs_the_step_on_cpu(capsys):
    weak.main(["-d", "32,32,32", "-b", "8,8,32", "-s", "s7pt", "-I", "8",
               "--fuse", "4", "--backend", "pencil", "--no-table-periodic",
               "--iters", "1", "--device", "cpu"])
    assert "validated against array twin: OK" in capsys.readouterr().out


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        weak.build_step(**STEP)
    with pytest.raises(RuntimeError, match="cuda"):
        weak.run(**STEP, backend="pencil", iters=1)


@pytest.mark.parametrize("kw,item", [
    (dict(backend="jnp"), "torch oracle"),
    (dict(exchange="put"), "multi-GPU"),
    (dict(exchange="shift-remote"), "kernel-level exchanges"),
    (dict(exchange="fused"), "kernel-level exchanges"),
    (dict(overlap=True), "pencil_sweep features"),
    (dict(profile_dir="trace"), "the rest"),
    (dict(f64_validate=True), "torch oracle"),
    (dict(mesh_shape=(2, 1, 1)), "multi-GPU"),
])
def test_unported_options_raise(kw, item):
    args = dict(STEP, backend="pencil", device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match=item):
        weak.run(**args)


def test_bad_step_arguments_raise():
    with pytest.raises(ValueError, match="multiple of fuse"):
        weak.build_step(**dict(STEP, fuse=3), device="cpu")
    with pytest.raises(ValueError, match="ghost depth"):
        weak.build_step(**dict(STEP, st_iter=16), device="cpu")



def _reference_step_4d(x, dec):
    dec = _reference_dec(dec)
    sd = stencil_by_name("mpi9pt")[0]
    G = dec.grid.shape[:3]
    bd, nb, prm = tuple(dec.bdims), dec.nbricks, bench_params()
    g_skip = pallas_pencil_sweep_4d(sd, dec.grid, bd, nb, prm, fuse=2,
                                    interpret=True)
    g_ghost = pallas_pencil_sweep_4d(sd, dec.grid, bd, nb, prm,
                                     w_range=(0, G[0]), k_range=(0, G[1]),
                                     j_range=(0, G[2]), fuse=2,
                                     interpret=True)
    d = exchange_shift_ref(jnp.asarray(x), dec, ("w", "x", "y", "z"),
                           (1, 1, 1, 1), interpret=True, table_axes=(3,))
    return np.asarray(g_skip(g_ghost(d)))


def test_step_4d_matches_reference_composition():
    step, storage, dec = weak.build_step(**STEP4, device="cpu")
    assert dec.grid.shape[:3] == (4, 4, 4)
    x = storage.numpy().copy()
    want = _reference_step_4d(x, dec)
    got = step(storage).numpy()
    own = dec.owned_mask()
    assert own.sum() == 2 * 2 * 2
    assert compare_arrays(got[own], want[own], 1e-5)


def test_run_4d_validates_against_dense_twin(capsys):
    res = weak.run(**STEP4, backend="pencil", validate=True, iters=2,
                   device="cpu")
    out = capsys.readouterr().out
    assert "validated against array twin: OK" in out
    assert "mesh (1, 1, 1, 1)" in out and "exchange share" in out
    assert res["calls"] == {"step": 1 + 1 + 2 + 2, "step_noex": 1 + 2 + 2,
                            "copy": 1 + 2}


def test_validation_catches_a_wrong_4d_step():
    s = weak._make_step(STEP4["dims"], STEP4["bdim"], "mpi9pt", 4, 2, False,
                        "good", "cpu", quiet=True)
    assert weak.validate_step(s, "mpi9pt", 4)
    s.step = s.step_noex            # drop the exchange: ghosts stay zero
    assert not weak.validate_step(s, "mpi9pt", 4)


def test_cli_runs_the_4d_step_on_cpu(capsys):
    weak.main(["-d", "8,8,8,16", "-b", "4,4,4,16", "-s", "mpi9pt", "-I",
               "4", "--fuse", "2", "--backend", "pencil",
               "--no-table-periodic", "--iters", "1", "--device", "cpu"])
    assert "validated against array twin: OK" in capsys.readouterr().out


@pytest.mark.parametrize("kw,err,match", [
    # the reference driver refuses 2-D domains too: they run through
    # api.Problem
    (dict(dims=(32, 32), bdim=(8, 32)), ValueError, "3-D or 4-D"),
    (dict(mesh_shape=(1, 1, 1)), NotImplementedError, "multi-GPU"),
], ids=["kw0-2-D", "kw1-multi-GPU"])
def test_unported_ranks_and_meshes_raise(kw, err, match):
    args = dict(STEP4, backend="pencil", device="cpu")
    args.update(kw)
    with pytest.raises(err, match=match):
        weak.run(**args)
