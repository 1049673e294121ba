"""The port's weak and strong steps on a mesh of ranks, on the CPU, against
the reference composition on its 8 virtual CPU devices.

- the weak mesh step (``drivers.weak`` with ``mesh_shape``): the
  reference's exchange under ``shard_map`` over one device per rank, then
  its interpret-mode ghost-inclusive and owned-only ``fuse`` sweeps over
  every rank, compared on each rank's owned bricks at abs-or-rel 5e-5
  (the f32 tolerance of ``core/compare.py``), 3-D on mesh (2, 2, 1) in all
  three exchange forms and 4-D on mesh (2, 1, 2, 1);
- ``run()`` and the CLIs of both drivers validate on the CPU against
  their dense twins (1e-4), every rank of the mesh on one CPU "card".
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from bricklib_tpu.codegen.pencil_kernel import pallas_pencil_sweep
from bricklib_tpu.codegen.pencil_kernel_4d import pallas_pencil_sweep_4d
from bricklib_tpu.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu.comm.exchange import exchange_shift
from bricklib_tpu.comm.mesh import make_domain_mesh, shard_map
from bricklib_tpu.core import compare_arrays
from bricklib_tpu.stencils import bench_params, stencil_by_name
from bricklib_tpu_torch.comm.exchange import remote_copy
from bricklib_tpu_torch.comm.mesh import rank_views
from bricklib_tpu_torch.drivers import strong, weak

TOL = 5e-5
STEP3 = dict(dims=(16, 16, 32), bdim=(8, 8, 32), stencil="s7pt", st_iter=4,
             fuse=2, table_periodic=False)
STEP4 = dict(dims=(8, 8, 8, 16), bdim=(4, 4, 4, 16), stencil="mpi9pt",
             st_iter=4, fuse=2, table_periodic=False)
STRONG = dict(dom=(32, 32, 32), sdom=(8, 16, 32), bdim=(4, 4, 32),
              stencil="s7pt", st_iter=4, fuse=2)


def _reference_exchange(stacked, dec, mesh_shape, table_axes):
    """The reference SHIFT exchange of every rank's storage (ravel order),
    each rank on its own virtual device."""
    mesh = make_domain_mesh(mesh_shape)
    names = mesh.axis_names
    lead = (0,) * len(mesh_shape)

    def step(d):
        return exchange_shift(d[lead], dec, names, mesh_shape,
                              table_axes=table_axes)[(None,) * len(lead)]

    spec = P(*names)
    out = jax.jit(shard_map(step, mesh, spec, spec))(jax.device_put(
        jnp.asarray(stacked.reshape(mesh_shape + stacked.shape[1:])),
        NamedSharding(mesh, spec)))
    return np.asarray(out).reshape(stacked.shape)


def _reference_step(stacked, port_dec, mesh_shape, stencil):
    """Exchange, then the ghost-inclusive and owned-only ``fuse=2`` sweeps
    of every rank in interpret mode (the 3-D sweep batched over the ranks,
    the 4-D one rank by rank)."""
    nd = len(mesh_shape)
    dec = BrickDecomp(dims=port_dec.dims, ghost_depth=port_dec.ghost_depth,
                      bdims=port_dec.bdims).initialize(
        skinlist_by_name("good", nd))
    assert np.array_equal(dec.grid, port_dec.grid)
    d = _reference_exchange(stacked, dec, mesh_shape, (nd - 1,))
    sd = stencil_by_name(stencil)[0]
    grid = dec.periodic_grid((nd - 1,))
    bd, nb, prm = tuple(dec.bdims), dec.nbricks, bench_params()
    G = grid.shape[:nd - 1]
    ghost = {f"{'wkj'[a + 4 - nd]}_range": (0, G[a]) for a in range(nd - 1)}
    if nd == 3:
        n = len(stacked)
        kw = dict(fuse=2, interpret=True, batch=n, batch_stride=nb)
        skip = pallas_pencil_sweep(sd, grid, bd, n * nb, prm, **kw)
        full = pallas_pencil_sweep(sd, grid, bd, n * nb, prm, **ghost, **kw)
        flat = jnp.asarray(d.reshape((n * nb,) + bd))
        return np.asarray(skip(full(flat))).reshape(stacked.shape)
    skip = pallas_pencil_sweep_4d(sd, grid, bd, nb, prm, fuse=2,
                                  interpret=True)
    full = pallas_pencil_sweep_4d(sd, grid, bd, nb, prm, fuse=2,
                                  interpret=True, **ghost)
    return np.stack([np.asarray(skip(full(jnp.asarray(x)))) for x in d])


@pytest.fixture(scope="module")
def weak_reference():
    """The 3-D weak mesh step's inputs (one array per rank, the same for
    every exchange form) and the reference composition's result."""
    s = weak._make_step(STEP3["dims"], STEP3["bdim"], "s7pt", 4, 2, False,
                        "good", "cpu", quiet=True, mesh_shape=(2, 2, 1))
    x = np.stack([v.numpy() for v in rank_views(s.mesh, s.state)])
    return x, _reference_step(x, s.dec, (2, 2, 1), "s7pt")


@pytest.mark.parametrize("exchange", ["shift", "put", "shift-remote"])
def test_weak_mesh_step_matches_reference_composition(exchange,
                                                      weak_reference):
    mesh_shape = (2, 2, 1)
    s = weak._make_step(STEP3["dims"], STEP3["bdim"], "s7pt", 4, 2, False,
                        "good", "cpu", quiet=True, mesh_shape=mesh_shape,
                        exchange=exchange)
    assert len(s.state) == 1 and s.state[0].shape[0] == 4   # one card
    x, want = weak_reference
    assert np.array_equal(
        x, np.stack([v.numpy() for v in rank_views(s.mesh, s.state)]))
    got = np.stack([v.numpy() for v in
                    rank_views(s.mesh, s.step(weak.clone_state(s.state)))])
    own = s.dec.owned_mask()
    for r in range(4):
        assert compare_arrays(got[r][own], want[r][own], TOL), (exchange, r)
    assert weak.validate_step(s, "s7pt", 4)


def test_weak_4d_mesh_step_matches_reference_composition():
    mesh_shape = (2, 1, 2, 1)
    s = weak._make_step(STEP4["dims"], STEP4["bdim"], "mpi9pt", 4, 2, False,
                        "good", "cpu", quiet=True, mesh_shape=mesh_shape,
                        exchange="shift-remote")
    x = np.stack([v.numpy() for v in rank_views(s.mesh, s.state)])
    want = _reference_step(x, s.dec, mesh_shape, "mpi9pt")
    got = np.stack([v.numpy() for v in
                    rank_views(s.mesh, s.step(weak.clone_state(s.state)))])
    own = s.dec.owned_mask()
    for r in range(4):
        assert compare_arrays(got[r][own], want[r][own], TOL), r


@pytest.mark.parametrize("exchange", ["shift", "put", "shift-remote"])
def test_weak_mesh_run_validates(exchange, capsys):
    before = remote_copy.launches
    res = weak.run(**STEP3, mesh_shape=(2, 2, 1), exchange=exchange,
                   backend="pencil", validate=True, iters=1, device="cpu")
    out = capsys.readouterr().out
    assert "validated against array twin: OK" in out
    assert "domain (32, 32, 32) mesh (2, 2, 1)" in out
    assert (res["ranks"], res["cards"]) == (4, 1)
    assert res["calls"]["copy"] == 1 + 1
    assert remote_copy.launches == before               # the CPU
    assert res["step"] > 0 and res["gstencil_s"] > 0


def test_weak_mesh_run_with_a_validation_function():
    seen = []

    def check(s):
        seen.append((s.mesh.size, len(s.state)))
        return True

    weak.run(**STEP3, mesh_shape=(1, 2, 1), validate=check, iters=1,
             devices=["cpu", "cpu"], device="cuda", backend="pencil")
    assert seen == [(2, 1)]
    with pytest.raises(RuntimeError, match="validation mismatch"):
        weak.run(**STEP3, mesh_shape=(2, 1, 1), validate=lambda s: False,
                 iters=1, device="cpu", backend="pencil")


def test_weak_validation_catches_a_wrong_mesh_step():
    s = weak._make_step(STEP3["dims"], STEP3["bdim"], "s7pt", 4, 2, False,
                        "good", "cpu", quiet=True, mesh_shape=(2, 1, 1))
    assert weak.validate_step(s, "s7pt", 4)
    # each rank exchanging with itself: the ghosts hold the wrong rank's
    # data on the distributed axis
    wrong = weak._make_step(STEP3["dims"], STEP3["bdim"], "s7pt", 4, 2,
                            False, "good", "cpu", quiet=True)

    def self_exchange(state):
        for v in rank_views(s.mesh, state):
            wrong.exchange([v.unsqueeze(0)])
        return s.step_noex(state)

    s.step = self_exchange
    assert not weak.validate_step(s, "s7pt", 4)


def test_weak_cli_runs_a_mesh_on_cpu(capsys):
    weak.main(["-d", "8,8,8,16", "-b", "4,4,4,16", "-s", "mpi9pt", "-I",
               "4", "--fuse", "2", "--no-table-periodic", "--mesh",
               "2,1,2,1", "--exchange", "put", "--backend", "pencil",
               "--iters", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "validated against array twin: OK" in out
    assert "mesh (2, 1, 2, 1)" in out


@pytest.mark.parametrize("exchange,mesh_shape", [
    ("shift", (2, 1, 1)), ("remote", (2, 1, 1)), ("remote", (2, 2, 1))])
def test_strong_mesh_run_validates(exchange, mesh_shape, capsys):
    res = strong.run(**STRONG, mesh_shape=mesh_shape, exchange=exchange,
                     validate=True, iters=1, device="cpu")
    assert "validated against global dense twin: OK" in \
        capsys.readouterr().out
    n = int(np.prod(mesh_shape))
    assert (res["ranks"], res["cards"]) == (n, 1)
    # shift: one K5 per (stage, sign); remote: one K10 per stage
    assert res["exchange_launches"] == (4 if exchange == "shift" else 2)


def test_strong_validation_catches_a_wrong_mesh_step():
    kw = dict(STRONG, mesh_shape=(2, 1, 1), exchange="remote")
    step, state, plan, g = strong.build_step(**kw, device="cpu")
    assert strong.validate_step(step, state, plan, g, "s7pt", 4, step.mesh)
    one = strong.build_step(**dict(kw, mesh_shape=(1, 1, 1),
                                   dom=(16, 32, 32)), device="cpu")[0]

    ghost, skip = step.sweeps

    def self_exchange(x):            # each rank periodic on its own
        for v in rank_views(step.mesh, x):
            one.exchange([v.unsqueeze(0)])
        return [skip(ghost(t.view((-1,) + plan.bdims))).view(t.shape)
                for t in x]

    assert not strong.validate_step(self_exchange, state, plan, g, "s7pt",
                                    4, step.mesh)


def test_strong_cli_runs_a_mesh_on_cpu(capsys):
    strong.main(["-d", "32,32,32", "-s", "8,16,32", "-b", "4,4,32",
                 "--stencil", "s7pt", "-I", "4", "--fuse", "2", "--mesh",
                 "2,1,1", "-v", "--iters", "1", "--device", "cpu",
                 "--exchange", "remote", "--devices", "cpu,cpu"])
    assert "validated against global dense twin: OK" in \
        capsys.readouterr().out
