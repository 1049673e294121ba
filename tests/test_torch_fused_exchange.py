"""The port's fused exchange (``bricklib_tpu_torch.codegen.fused_exchange``,
kernel K11's plain version) and its plan against the reference, on the
CPU.

- ``put_plan``, ``ghost_rings`` and ``put_send_ids`` equal the
  reference's entry for entry (the send ids against the reference's
  traced ids under ``shard_map`` on the 8 virtual CPU devices).
- The fused sweep against the reference's ``pallas_pencil_sweep_fusedx``
  in interpret mode and against the reference composition (SHIFT
  exchange, then the ghost-inclusive interpret sweep): the exchanged
  storage bit for bit, the output on the written bricks at abs-or-rel
  1e-5.  The port's plain sweep adds the taps in tap order where the
  reference adds its factorized form, so the outputs differ by rounding
  (3.6e-7 at most on these inputs); against the port's own composition
  (PUT exchange, then the same plain sweep) the output is bit-exact, as
  the reference's fused result is to its composition.
- The gating plan K11 runs, read on the CPU.
- The weak fused step (``drivers.weak`` with ``exchange="fused"``).

K11 itself runs only on the card: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold it against its plain version and against the PUT
exchange followed by K1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from bricklib_tpu.codegen.fused_exchange import pallas_pencil_sweep_fusedx
from bricklib_tpu.codegen.pencil_kernel import pallas_pencil_sweep
from bricklib_tpu.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu.comm import exchange as ref_ex
from bricklib_tpu.comm.mesh import make_domain_mesh as ref_domain_mesh
from bricklib_tpu.comm.mesh import shard_map
from bricklib_tpu.core import compare_arrays
from bricklib_tpu.stencils import DEFAULT_PARAMS, bench_params
from bricklib_tpu.stencils import stencil_by_name as ref_stencil
from bricklib_tpu_torch import comm as port_comm
from bricklib_tpu_torch.codegen import fused_exchange as fx
from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
from bricklib_tpu_torch.comm import exchange as port_ex
from bricklib_tpu_torch.comm.mesh import Mesh, make_domain_mesh, to_state
from bricklib_tpu_torch.drivers import weak

BD = (4, 4, 32)
DIMS = (24, 16, 32)
TABLE_AXES = (2,)
TOL = 1e-5
PARAMS = dict(DEFAULT_PARAMS, coeff=[0.03 * (c + 1) for c in range(27)])
MESHES = [(1, 1, 1), (2, 2, 1), (2, 1, 1), (1, 2, 1), (4, 2, 1)]


def _decs(rings=1, dims=DIMS, bd=BD):
    """(reference decomposition, port decomposition) with ghosts ``rings``
    bricks deep on k and j."""
    gz = tuple(rings * g for g in (bd[0], bd[1], 0))
    return (BrickDecomp(dims=dims, ghost_depth=gz, bdims=bd).initialize(
                skinlist_by_name("good", 3)),
            port_comm.BrickDecomp(dims=dims, ghost_depth=gz, bdims=bd)
            .initialize(port_comm.skinlist_by_name("good", 3)))


@pytest.mark.parametrize("rings", [1, 2])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_put_plan_matches_reference(mesh_shape, rings):
    ref, dec = _decs(rings)
    for table_axes in ((), TABLE_AXES):
        want = ref_ex.put_plan(ref, mesh_shape, table_axes)
        got = port_ex.put_plan(dec, mesh_shape, table_axes)
        assert list(got) == list(want)
        assert got.ghost_rings == want.ghost_rings == (rings, rings)
        # the senders' copies are the PUT exchange's copies
        assert sorted(c[:6] for c in port_ex.put_plan_copies(
            got, mesh_shape)) == sorted(c[:6] for c in port_ex.put_copies(
                dec, mesh_shape, table_axes))


@pytest.mark.parametrize("mesh_shape", [(2, 2, 1), (4, 2, 1), (2, 1, 1),
                                        (1, 2, 1)])
def test_put_send_ids_match_reference(mesh_shape):
    ref, dec = _decs()
    plan = port_ex.put_plan(dec, mesh_shape, TABLE_AXES)
    ref_plan = ref_ex.put_plan(ref, mesh_shape, TABLE_AXES)
    n = int(np.prod(mesh_shape))
    mesh = JaxMesh(np.asarray(jax.devices()[:n]), ("dev",))
    nrem = sum(1 for e in ref_plan if e[5])

    def ids(_x):
        return ref_ex.put_send_ids(ref_plan, mesh_shape, "dev")[None]

    want = np.asarray(jax.jit(shard_map(ids, mesh, P("dev"), P("dev")))(
        jnp.zeros((n,), jnp.float32))).reshape(n, nrem)
    for r in range(n):
        assert port_ex.put_send_ids(plan, mesh_shape, r) == want[r].tolist()


def _stacked(dec, n, seed=11):
    return np.random.default_rng(seed).standard_normal(
        (n, dec.nbricks) + BD).astype(np.float32)


def _port_fused(x, dec, mesh_shape, stencil, **kw):
    """The port's fused sweep of ``x`` (``[ranks, nbricks, ...]``), every
    rank on one CPU "card": (output, exchanged storage, built fn)."""
    n = len(x)
    mesh = make_domain_mesh(mesh_shape, devices=["cpu"] * n)
    plan = port_ex.put_plan(dec, mesh_shape, TABLE_AXES)
    fn = fx.pencil_sweep_fusedx(stencil, dec.periodic_grid(TABLE_AXES), BD,
                                dec.nbricks, plan, mesh_shape, PARAMS,
                                mesh=mesh, **kw)
    state = to_state(mesh, list(x))
    out, state2 = fn(state)
    assert state2 is state
    return out[0].numpy(), state[0].numpy(), fn


def _check_out(got, want, fn):
    w = fn.plan.written_bricks()
    for r in range(len(got)):
        assert compare_arrays(got[r][w], want[r][w], TOL), r


@pytest.mark.parametrize("rings", [1, 2])
def test_fused_sweep_matches_reference_kernel(rings):
    """``tests/test_fused_exchange.py:27-95`` on mesh (2, 2, 1), mpi7pt,
    ghosts one and two bricks deep."""
    mesh_shape = (2, 2, 1)
    ref, dec = _decs(rings)
    x = _stacked(dec, 4)
    got, state, fn = _port_fused(x, dec, mesh_shape, "mpi7pt")
    ref_plan = ref_ex.put_plan(ref, mesh_shape, TABLE_AXES)
    kern = pallas_pencil_sweep_fusedx(
        ref_stencil("mpi7pt")[0], ref.periodic_grid(TABLE_AXES), BD,
        ref.nbricks, ref_plan, mesh_shape, PARAMS,
        ghost_rings=(rings, rings), interpret=True)
    mesh = JaxMesh(np.asarray(jax.devices()[:4]), ("dev",))

    def step(d):
        return kern(d, ref_ex.put_send_ids(ref_plan, mesh_shape, "dev"))

    out, d2 = jax.jit(shard_map(step, mesh, P("dev"), (P("dev"), P("dev"))))(
        jax.device_put(jnp.asarray(x.reshape((-1,) + BD)),
                       NamedSharding(mesh, P("dev"))))
    np.testing.assert_array_equal(state, np.asarray(d2).reshape(x.shape))
    _check_out(got, np.asarray(out).reshape(x.shape), fn)


def _ref_composition(x, ref, mesh_shape, stencil, kr, jr):
    """The reference's SHIFT exchange, then its ghost-inclusive interpret
    sweep over every rank: (output, exchanged storage)."""
    mesh = ref_domain_mesh(mesh_shape)
    names = mesh.axis_names
    sweep = pallas_pencil_sweep(ref_stencil(stencil)[0],
                                ref.periodic_grid(TABLE_AXES), BD,
                                ref.nbricks, PARAMS, k_range=kr, j_range=jr,
                                interpret=True)

    def step(d):
        e = ref_ex.exchange_shift(d[0, 0, 0], ref, names, mesh_shape,
                                  table_axes=TABLE_AXES)
        return sweep(e)[None, None, None], e[None, None, None]

    spec = P(*names)
    out, e = jax.jit(shard_map(step, mesh, spec, (spec, spec)))(
        jax.device_put(jnp.asarray(x.reshape(mesh_shape + x.shape[1:])),
                       NamedSharding(mesh, spec)))
    return (np.asarray(out).reshape(x.shape), np.asarray(e).reshape(x.shape))


@pytest.mark.parametrize("mesh_shape,stencil,tile_j", [
    ((1, 1, 1), "mpi7pt", None), ((2, 2, 1), "mpi13pt", None),
    ((2, 2, 1), "mpi7pt", 1), ((4, 2, 1), "mpi7pt", None)])
def test_fused_sweep_matches_reference_composition(mesh_shape, stencil,
                                                   tile_j):
    ref, dec = _decs()
    n = int(np.prod(mesh_shape))
    x = _stacked(dec, n, seed=5)
    got, state, fn = _port_fused(x, dec, mesh_shape, stencil, tile_j=tile_j)
    (kr, jr) = fn.plan.ranges
    want, exchanged = _ref_composition(x, ref, mesh_shape, stencil, kr, jr)
    np.testing.assert_array_equal(state, exchanged)
    _check_out(got, want, fn)
    # bit for bit against the port's own composition: PUT, then K1's
    # plain version over the card's ranks
    mesh = make_domain_mesh(mesh_shape, devices=["cpu"] * n)
    st = to_state(mesh, list(x))
    port_ex.put_exchange(dec, mesh, TABLE_AXES)(st)
    sweep = pencil_sweep(stencil, dec.periodic_grid(TABLE_AXES), BD,
                         n * dec.nbricks, PARAMS, k_range=kr, j_range=jr,
                         batch=n, batch_stride=dec.nbricks)
    comp = sweep(st[0].view((-1,) + BD)).view(st[0].shape).numpy()
    w = fn.plan.written_bricks()
    np.testing.assert_array_equal(got[:, w], comp[:, w])
    assert fx.pencil_sweep_fusedx_kernel.launches == 0


def test_fused_sweep_one_rank_takes_one_tensor():
    _ref, dec = _decs()
    plan = port_ex.put_plan(dec, (1, 1, 1), TABLE_AXES)
    fn = fx.pencil_sweep_fusedx("mpi7pt", dec.periodic_grid(TABLE_AXES), BD,
                                dec.nbricks, plan, (1, 1, 1), PARAMS)
    x = torch.from_numpy(_stacked(dec, 1)[0])
    y = x.clone()
    out, dat = fn(x)
    assert dat is x and out.shape == x.shape
    many, _ = _port_fused(y[None].numpy(), dec, (1, 1, 1), "mpi7pt")[:2]
    w = fn.plan.written_bricks()
    np.testing.assert_array_equal(out.numpy()[w], many[0][w])
    np.testing.assert_array_equal(x.numpy(), _port_fused(
        y[None].numpy(), dec, (1, 1, 1), "mpi7pt")[1][0])


def _needed_groups(dec, fn, rank_copies):
    """Per (k, j) output tile, the gate groups of the copied bricks its
    level-0 tile reads, recomputed here from the table."""
    table = fn.plan.table
    GK, GJ = table.shape
    (K0, K1), (J0, J1) = fn.plan.ranges
    group_of = {}
    for _r, d0, d1, _q, _s0, _s1, g in rank_copies:
        for b in range(d0, d1):
            group_of[b] = fx.GROUPS.index(g)
    need = {}
    for k in range(K0, K1):
        for j in range(J0, J1):
            bits = 0
            for kk in (k - 1, k, k + 1):
                for jj in (j - 1, j, j + 1):
                    b = int(table[min(max(kk, 0), GK - 1),
                                  min(max(jj, 0), GJ - 1)])
                    if b in group_of:
                        bits |= 1 << group_of[b]
            need[k, j] = bits
    return need


@pytest.mark.parametrize("rings", [1, 2])
@pytest.mark.parametrize("devices", [
    ["cpu"] * 4, ["cuda:0", "cuda:0", "cuda:1", "cuda:1"]],
    ids=["one-card", "two-cards"])
def test_gating_plan(devices, rings):
    """Every stream block of K1's plan for the card's ranks appears once
    per rank; a block waits on the union of the groups that the output
    bricks of its chunk and pencils read (its i tile reads whole pencils)
    and on no other; each expected count is the number of chunks that land
    in that (rank, group); the blocks that wait come after every block
    that does not."""
    mesh_shape = (2, 2, 1)
    _ref, dec = _decs(rings)
    mesh = Mesh(mesh_shape, ("z", "y", "x"), devices)
    plan = port_ex.put_plan(dec, mesh_shape, TABLE_AXES)
    fn = fx.pencil_sweep_fusedx("mpi7pt", dec.periodic_grid(TABLE_AXES), BD,
                                dec.nbricks, plan, mesh_shape, PARAMS,
                                mesh=mesh)
    copies = fn.copies
    need = _needed_groups(dec, fn, [c for c in copies if c[0] == 0])
    vecs = 4 * int(np.prod(BD)) // 16
    chunks: dict = {}
    for r, d0, d1, _q, _s0, _s1, g in copies:
        key = (r, fx.GROUPS.index(g))
        chunks[key] = chunks.get(key, 0) + -(-(d1 - d0) * vecs
                                             // fx.CHUNK_VECS)
    for c, cp in enumerate(fn.cards):
        ranks = mesh.ranks_on(c)
        sp = cp.stream
        assert sp == dataclasses.replace(
            fn.plan, batch=len(ranks), batch_stride=dec.nbricks).stream()
        blocks = sp.blocks()
        nper = sp.nchunk * sp.njg * sp.nit
        items = cp.items
        assert len(items) == len(blocks) == len(ranks) * nper
        assert sorted(map(tuple, items[:, :2].tolist())) == [
            (s, b) for s in range(len(ranks)) for b in range(nper)]
        for slot, b, bits in items:
            sub, (k0, k1), (j0, j1), _i, _edges = blocks[slot * nper + b]
            assert sub == slot
            want = 0
            for k in range(k0, k1):
                for j in range(j0, j1):
                    want |= need[k, j]
            assert bits == want
        gated = items[:, 2] != 0
        assert gated.any() and not gated[:int((~gated).sum())].any()
        for slot, r in enumerate(ranks):
            for g in range(3):
                assert cp.expect[3 * slot + g] == chunks.get((r, g), 0)
        # a card's chunks: its own rows, each counted where it lands
        for dc, _do, sc, _so, n, counter in cp.rows:
            assert sc == c and 0 < n <= fx.CHUNK_VECS
            assert fn.cards[dc].expect[counter] > 0
    landed = {}
    for cp in fn.cards:
        for dc, _do, _sc, _so, _n, counter in cp.rows:
            landed[dc, counter] = landed.get((dc, counter), 0) + 1
    assert landed == {(c, k): int(e) for c, cp in enumerate(fn.cards)
                      for k, e in enumerate(cp.expect) if e}
    if len(mesh.cards) == 2:                # k crosses the cards
        assert fn.waits[0] == [(0, 1), (1, 0)]
    else:
        assert fn.waits == [[], []]


@pytest.mark.parametrize("stencil,dims,kw,exc", [
    ("mpi7pt", DIMS, dict(ghost_rings=(2, 2)), ValueError),
    ("mpi7pt", DIMS, dict(tile_j=5), ValueError),
    ("mpi7pt", (8, 8, 32), {}, ValueError),          # too shallow in k
    ("mpi9pt", DIMS, {}, NotImplementedError)],      # a 4-D stencil
    ids=["rings", "tile_j", "shallow", "4-D"])
def test_fused_sweep_refusals_match_reference(stencil, dims, kw, exc):
    ref, dec = _decs(dims=dims)
    with pytest.raises(exc) as want:
        pallas_pencil_sweep_fusedx(
            ref_stencil(stencil)[0], ref.periodic_grid(TABLE_AXES), BD,
            ref.nbricks, ref_ex.put_plan(ref, (2, 2, 1), TABLE_AXES),
            (2, 2, 1), PARAMS, interpret=True, **kw)
    with pytest.raises(exc) as got:
        fx.pencil_sweep_fusedx(
            stencil, dec.periodic_grid(TABLE_AXES), BD, dec.nbricks,
            port_ex.put_plan(dec, (2, 2, 1), TABLE_AXES), (2, 2, 1), PARAMS,
            mesh=make_domain_mesh((2, 2, 1), devices=["cpu"] * 4), **kw)
    assert str(got.value) == str(want.value)


# --- the weak fused step ---------------------------------------------------

STEP = dict(dims=(32, 16, 32), bdim=(8, 8, 32), stencil="s7pt", st_iter=4,
            fuse=1, table_periodic=False)


def _reference_step(x, port_dec, mesh_shape):
    """The reference composition of the weak fused step: SHIFT exchange,
    then three ghost-inclusive and one owned-only ``fuse=1`` sweep over
    every rank, interpret mode."""
    ref = BrickDecomp(dims=port_dec.dims, ghost_depth=port_dec.ghost_depth,
                      bdims=port_dec.bdims).initialize(
        skinlist_by_name("good", 3))
    mesh = ref_domain_mesh(mesh_shape)
    names = mesh.axis_names
    grid = ref.periodic_grid(TABLE_AXES)
    GK, GJ = grid.shape[:2]
    n, nb, bd = len(x), ref.nbricks, tuple(ref.bdims)
    sd = ref_stencil("s7pt")[0]
    kw = dict(interpret=True, batch=n, batch_stride=nb)
    skip = pallas_pencil_sweep(sd, grid, bd, n * nb, bench_params(), **kw)
    full = pallas_pencil_sweep(sd, grid, bd, n * nb, bench_params(),
                               k_range=(0, GK), j_range=(0, GJ), **kw)

    def ex(d):
        return ref_ex.exchange_shift(d[0, 0, 0], ref, names, mesh_shape,
                                     table_axes=TABLE_AXES)[None, None, None]

    spec = P(*names)
    e = np.asarray(jax.jit(shard_map(ex, mesh, spec, spec))(jax.device_put(
        jnp.asarray(x.reshape(mesh_shape + x.shape[1:])),
        NamedSharding(mesh, spec))))
    d = jnp.asarray(e.reshape((n * nb,) + bd))
    for _ in range(3):
        d = full(d)
    return np.asarray(skip(d)).reshape(x.shape)


def test_weak_fused_step_matches_reference_composition():
    step, state, dec = weak.build_step(**STEP, mesh_shape=(2, 2, 1),
                                       exchange="fused", device="cpu")
    x = np.stack([t.numpy() for t in state[0]])
    want = _reference_step(x, dec, (2, 2, 1))
    got = step(state)[0].numpy()
    own = dec.owned_mask()
    for r in range(4):
        assert compare_arrays(got[r][own], want[r][own], 5e-5), r


def test_weak_fused_equals_put_on_the_cpu():
    outs = {}
    for ex in ("put", "fused"):
        step, state, dec = weak.build_step(**STEP, mesh_shape=(2, 2, 1),
                                           exchange=ex, device="cpu")
        outs[ex] = step(state)[0].numpy()
    own = dec.owned_mask()
    np.testing.assert_array_equal(outs["fused"][:, own], outs["put"][:, own])


def test_weak_fused_run_and_cli_validate(capsys):
    res = weak.run(**STEP, mesh_shape=(2, 2, 1), exchange="fused",
                   backend="pencil", validate=True, iters=1, device="cpu")
    out = capsys.readouterr().out
    assert "validated against array twin: OK" in out
    assert "exchange fused" in out and "exchange share" in out
    assert (res["ranks"], res["cards"]) == (4, 1)
    assert fx.pencil_sweep_fusedx_kernel.launches == 0
    weak.main(["-d", "32,16,32", "-b", "8,8,32", "-s", "s7pt", "-I", "2",
               "--fuse", "1", "--no-table-periodic", "--mesh", "2,1,1",
               "--exchange", "fused", "--backend", "pencil", "--iters", "1",
               "--device", "cpu"])
    assert "validated against array twin: OK" in capsys.readouterr().out
    s = weak._make_step((32, 16, 32), (8, 8, 32), "s7pt", 2, 1, False,
                        "good", "cpu", quiet=True, mesh_shape=(2, 1, 1),
                        exchange="fused")
    assert weak.validate_step(s, "s7pt", 2)
    s.step = s.step_noex              # no exchange: the ghosts stay zero
    assert not weak.validate_step(s, "s7pt", 2)
