"""The port's mesh exchanges (``bricklib_tpu_torch.comm``) against the
reference's on its 8 virtual CPU devices.

The same seeded numpy storage goes to both.  The reference runs each rank
on its own device under ``shard_map`` (the remote-copy forms in interpret
mode over one flat device axis, as ``tests/test_exchange.py`` runs them);
the port runs every rank on one CPU "card" (``devices=["cpu"] * n``), the
ranks of a card stacked in one tensor, through the plain versions of
kernels K2, K5, K9 and K10.  An exchange only copies, so the results must
be equal bit for bit.  The kernels are held against their plain versions
on the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from bricklib_tpu.comm import BrickDecomp, skinlist_by_name
from bricklib_tpu.comm import exchange as ref_ex
from bricklib_tpu.comm.mesh import make_domain_mesh as ref_domain_mesh
from bricklib_tpu.comm.mesh import shard_map
from bricklib_tpu.comm.strong import StrongDecomp as StrongDecompRef
from bricklib_tpu.comm.strong import exchange_strong_shift as strong_ref
from bricklib_tpu.core import random_array, to_bricks
from bricklib_tpu_torch import _build
from bricklib_tpu_torch import comm as port_comm
from bricklib_tpu_torch.comm import exchange as port_ex
from bricklib_tpu_torch.comm.mesh import (Mesh, enable_peer_access,
                                          make_domain_mesh, make_flat_mesh,
                                          rank_views, to_state)
from bricklib_tpu_torch.comm.strong import (StrongDecomp,
                                            exchange_strong_remote,
                                            exchange_strong_shift,
                                            stage_copy,
                                            strong_remote_copy,
                                            strong_remote_exchange)

PORT_FNS = {"put": port_ex.exchange_put, "shift": port_ex.exchange_shift,
            "shift-remote": port_ex.exchange_shift_remote}


def _decs(dims, bd, gz, skin="good"):
    """(reference decomposition, port decomposition), each from its own
    package."""
    nd = len(dims)
    return (BrickDecomp(dims=dims, ghost_depth=gz, bdims=bd).initialize(
                skinlist_by_name(skin, nd)),
            port_comm.BrickDecomp(dims=dims, ghost_depth=gz, bdims=bd)
            .initialize(port_comm.skinlist_by_name(skin, nd)))


def _reference(which, stacked, dec, mesh_shape):
    """The reference exchange of ``stacked`` (``[ranks, nbricks, ...]``,
    ravel order), each rank on its own virtual device."""
    n = int(np.prod(mesh_shape))
    if which == "shift-remote":
        mesh = JaxMesh(np.asarray(jax.devices()[:n]), ("dev",))

        def step(d):
            return ref_ex.exchange_shift_remote(d[0], dec, ("dev",),
                                                mesh_shape)[None]

        spec, x = P("dev"), stacked
    else:
        mesh = ref_domain_mesh(mesh_shape)
        names = mesh.axis_names
        fn = ref_ex.exchange_put if which == "put" else ref_ex.exchange_shift
        lead = (0,) * len(mesh_shape)

        def step(d):
            return fn(d[lead], dec, names, mesh_shape)[
                (None,) * len(mesh_shape)]

        spec, x = P(*names), stacked.reshape(mesh_shape + stacked.shape[1:])
    out = jax.jit(shard_map(step, mesh, spec, spec))(
        jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec)))
    return np.asarray(out).reshape(stacked.shape)


def _port(which, stacked, dec, mesh_shape, **kw):
    """The port's exchange of ``stacked`` with every rank on the CPU."""
    mesh = make_domain_mesh(mesh_shape,
                            devices=["cpu"] * int(np.prod(mesh_shape)))
    state = to_state(mesh, list(stacked))
    assert PORT_FNS[which](state, dec, mesh, **kw) is state
    return np.stack([v.numpy() for v in rank_views(mesh, state)])


def _blocks(dims, gz, mesh_shape, seed):
    """Per rank (ravel order), its block with ghosts ``gz`` deep cut from
    the global periodic domain."""
    gshape = tuple(m * d for m, d in zip(mesh_shape, dims))
    g = random_array(gshape, np.float32, seed)
    blocks = []
    for c in np.ndindex(*mesh_shape):
        idx = [np.arange(c[a] * dims[a] - gz[a],
                         c[a] * dims[a] + dims[a] + gz[a]) % gshape[a]
               for a in range(len(dims))]
        blocks.append(g[np.ix_(*idx)])
    return blocks


def _storage(dec, blocks):
    """The ranks' brick storage, ghosts and brick 0 zeroed."""
    out = []
    for blk in blocks:
        dat = np.zeros((dec.nbricks, int(np.prod(dec.bdims))), np.float32)
        to_bricks(blk, dec.grid, dec.bdims, dat=dat)
        dat[dec.sep_pos[1]:] = 0.0
        dat[0] = 0.0
        out.append(dat.reshape((dec.nbricks,) + tuple(dec.bdims)))
    return np.stack(out)


@pytest.mark.parametrize("which", ["put", "shift", "shift-remote"])
def test_exchange_fills_ghost_like_reference(which):
    """``tests/test_exchange.py:67-109`` on mesh (2, 2, 2): the port fills
    every ghost brick with its neighbour's data, bit for bit as the
    reference."""
    dims, bd, mesh_shape = (8, 8, 16), (4, 4, 8), (2, 2, 2)
    ref, dec = _decs(dims, bd, bd)
    blocks = _blocks(dims, bd, mesh_shape, 0)
    stacked = _storage(dec, blocks)
    got = _port(which, stacked, dec, mesh_shape)
    np.testing.assert_array_equal(got, _reference(which, stacked, ref,
                                                  mesh_shape))
    from bricklib_tpu_torch.core.setup import from_bricks

    for r, blk in enumerate(blocks):
        assert np.array_equal(from_bricks(got[r].reshape(dec.nbricks, -1),
                                          dec.grid, bd), blk)


def test_remote_exchange_mixed_local_and_remote():
    """``tests/test_exchange.py:112-150``: on mesh (2, 2, 1) K9 carries
    remote copies (k, j) and self-copies (i) in one launch per stage; it
    equals the reference's SHIFT exchange and its remote form bit for
    bit, and the port's own SHIFT exchange."""
    mesh_shape = (2, 2, 1)
    ref, dec = _decs((8, 8, 16), (4, 4, 8), (4, 4, 8))
    rng = np.random.default_rng(7)
    stacked = rng.standard_normal((4, dec.nbricks, 4, 4, 8)).astype(
        np.float32)
    want = _reference("shift", stacked, ref, mesh_shape)
    np.testing.assert_array_equal(
        _reference("shift-remote", stacked, ref, mesh_shape), want)
    before = port_ex.remote_copy.launches
    np.testing.assert_array_equal(
        _port("shift-remote", stacked, dec, mesh_shape), want)
    np.testing.assert_array_equal(_port("shift", stacked, dec, mesh_shape),
                                  want)
    assert port_ex.remote_copy.launches == before     # CPU: plain version


def test_remote_exchange_4d():
    """``tests/test_exchange.py:221-260``: the 4-D decomposition on mesh
    (2, 1, 2, 1), lex skin."""
    mesh_shape, bd = (2, 1, 2, 1), (2, 2, 4, 16)
    ref, dec = _decs((4, 4, 8, 32), bd, bd, skin="lex")
    rng = np.random.default_rng(13)
    stacked = rng.standard_normal((4, dec.nbricks) + bd).astype(np.float32)
    want = _reference("shift", stacked, ref, mesh_shape)
    for which in ("shift-remote", "shift", "put"):
        got = _port(which, stacked, dec, mesh_shape)
        if which == "put":     # PUT fills the ghosts the SHIFT form fills
            want_put = _reference("put", stacked, ref, mesh_shape)
            np.testing.assert_array_equal(got, want_put)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh_shape,deep", [
    ((2, 2, 2), None), ((2, 2, 1), None), ((2, 1, 2), None),
    ((1, 2, 2), None), ((4, 2, 1), None), ((1, 1, 8), None),
    # 2-D meshes (Problem rank 2 on a mesh stands on them)
    ((2, 1), None), ((4, 1), None), ((2, 2), None), ((8, 1), None),
    # ghosts two bricks deep: (bricks, ghost depth)
    ((2, 2, 1), ((8, 8, 32), (16, 8, 0))),
    ((2, 2, 1), ((4, 4, 32), (8, 8, 0))),
    # rank 5, the oracle's whole-brick ghosts (tests/test_dim_generic.py's
    # mesh, and the innermost axis distributed)
    ((2, 1, 2, 1, 1), None), ((1, 1, 1, 1, 2), None)],
    ids=["mesh_shape0", "mesh_shape1", "mesh_shape2", "mesh_shape3",
         "mesh_shape4", "mesh_shape5", "2d-2x1", "2d-4x1", "2d-2x2",
         "2d-8x1", "deep-16x8x0", "deep-8x8x0", "5d-2x1x2x1x1",
         "5d-i-distributed"])
def test_exchange_geometry_fuzz(mesh_shape, deep):
    """``tests/test_exchange.py:285-337`` over each of its meshes (a
    size-4 and a size-8 axis among them), 2-D meshes, and 3-D ghosts two
    bricks deep: a seeded geometry (brick fold, skin ordering) in all
    three forms, bit-exact against the reference's PUT or SHIFT exchange
    and against the global-wrap ground truth."""
    from bricklib_tpu_torch.core.setup import from_bricks

    rng = np.random.default_rng(500 + sum(mesh_shape) * 7 + mesh_shape[0])
    if deep is not None:
        bd, gz = deep
        dims = (2 * gz[0], 2 * gz[1], bd[2])
    elif len(mesh_shape) == 5:       # the smallest rank-5 geometry
        bd = (2, 2, 2, 2, 4)
        dims = tuple(2 * b for b in bd)
        gz = bd
    else:
        bd = tuple(int(rng.choice([2, 4])) for _ in mesh_shape[:-1]) + (
            int(rng.choice([4, 8])),)
        dims = tuple(int(rng.integers(2, 4)) * b for b in bd)
        gz = bd
    # ranks other than 3 have the lexicographic order alone
    order = (str(rng.choice(["good", "normal", "bad"]))
             if len(mesh_shape) == 3 else "lex")
    ref, dec = _decs(dims, bd, gz, skin=order)
    blocks = _blocks(dims, gz, mesh_shape, int(rng.integers(100)))
    stacked = _storage(dec, blocks)
    for which in ("put", "shift", "shift-remote"):
        got = _port(which, stacked, dec, mesh_shape)
        if which != "shift-remote":
            np.testing.assert_array_equal(
                got, _reference(which, stacked, ref, mesh_shape))
        for r, blk in enumerate(blocks):
            assert np.array_equal(from_bricks(
                got[r].reshape(dec.nbricks, -1), dec.grid, bd), blk), (
                which, order, r)


def test_table_axes_skip_the_undistributed_axis():
    """With the i axis through the table (the weak step's form), the
    three forms agree with the reference's exchange given the same
    ``table_axes``."""
    mesh_shape = (2, 2, 1)
    ref, dec = _decs((16, 16, 32), (8, 8, 32), (8, 8, 0))
    rng = np.random.default_rng(3)
    stacked = rng.standard_normal((4, dec.nbricks, 8, 8, 32)).astype(
        np.float32)
    mesh = ref_domain_mesh(mesh_shape)
    names = mesh.axis_names
    for which, fn in (("shift", ref_ex.exchange_shift),
                      ("put", ref_ex.exchange_put)):
        def step(d):
            return fn(d[0, 0, 0], ref, names, mesh_shape,
                      table_axes=(2,))[None, None, None]

        spec = P(*names)
        want = np.asarray(jax.jit(shard_map(step, mesh, spec, spec))(
            jax.device_put(jnp.asarray(stacked.reshape(
                mesh_shape + stacked.shape[1:])), NamedSharding(mesh, spec)))
        ).reshape(stacked.shape)
        np.testing.assert_array_equal(
            _port(which, stacked, dec, mesh_shape, table_axes=(2,)), want)
        if which == "shift":
            np.testing.assert_array_equal(
                _port("shift-remote", stacked, dec, mesh_shape,
                      table_axes=(2,)), want)


STRONG = dict(dom=(64, 32, 32), sdom=(16, 16, 16), bdims=(4, 4, 8),
              ghost_depth=(4, 4, 8))
STRONG_PENCIL = dict(dom=(32, 32, 64), sdom=(8, 8, 64), bdims=(4, 4, 64),
                     ghost_depth=(4, 4, 0))


@pytest.mark.parametrize("cfg,mesh_shape", [(STRONG, (2, 1, 1)),
                                            (STRONG_PENCIL, (2, 2, 1)),
                                            (STRONG_PENCIL, (4, 1, 1))],
                         ids=["cubic-2x1x1", "pencil-2x2x1", "pencil-4x1x1"])
def test_strong_exchange_matches_reference(cfg, mesh_shape):
    """``tests/test_strong.py:67-119`` (and its (2, 2, 1) driver mesh):
    the strong exchange in ``shift`` and ``remote`` form equals the
    reference's staged exchange under ``shard_map`` bit for bit."""
    ref = StrongDecompRef(mesh_shape=mesh_shape, **cfg).initialize(
        skinlist_by_name("good", 3))
    plan = StrongDecomp(mesh_shape=mesh_shape, **cfg).initialize(
        port_comm.skinlist_by_name("good", 3))
    n = int(np.prod(mesh_shape))
    nsub, nb = plan.nsub_local, plan.sdec.nbricks
    x = random_array((n, nsub, nb) + tuple(cfg["bdims"]), np.float32, 17)
    mesh = ref_domain_mesh(mesh_shape)
    names = mesh.axis_names

    def step(b):
        return strong_ref(b[0, 0, 0], ref, names)[None, None, None]

    spec = P(*names)
    want = np.asarray(jax.jit(shard_map(step, mesh, spec, spec))(
        jax.device_put(jnp.asarray(x.reshape(mesh_shape + x.shape[1:])),
                       NamedSharding(mesh, spec)))).reshape(x.shape)
    assert not np.array_equal(want, x)
    pmesh = make_domain_mesh(mesh_shape, devices=["cpu"] * n)
    before = (stage_copy.launches, strong_remote_copy.launches)
    for fn in (exchange_strong_shift, exchange_strong_remote):
        state = to_state(pmesh, list(x))
        assert fn(state, plan, mesh=pmesh) is state
        np.testing.assert_array_equal(state[0].numpy(), want)
    assert (stage_copy.launches, strong_remote_copy.launches) == before
    ex = strong_remote_exchange(plan, pmesh)
    nstages = len({st.axis for st in ex.stages})
    assert nstages == (3 if cfg is STRONG else 2) == len(ex.plan)
    assert ex.waits == [[]] * (nstages + 1)                 # one card


def test_placement_and_geometry_helpers():
    """Ranks on cards in ravel order; the direction conventions equal the
    reference's on a size-4 axis (an error passes at size 2)."""
    m = Mesh((2, 2, 1), ("z", "y", "x"), ["cpu", "cpu", "cpu", "cpu"])
    assert m.cards == (torch.device("cpu"),) and m.place(3) == (0, 3)
    assert m.coords_of(2) == (1, 0, 0) and m.rank_of((1, 1, 0)) == 3
    m2 = Mesh((4,), ("dev",), ["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    assert [m2.place(r) for r in range(4)] == [(0, 0), (1, 0), (0, 1),
                                               (1, 1)]
    assert m2.ranks_on(1) == [1, 3]
    for size, sign in ((4, 1), (4, -1), (2, 1), (8, -1)):
        assert port_ex._shift_perm(size, sign) == ref_ex._shift_perm(size,
                                                                     sign)
    shape = (4, 2, 1)
    _r, dec = _decs((8, 8, 16), (4, 4, 8), (4, 4, 8))
    for gr in dec.ghost:
        assert port_ex.neighbor_perm(gr.neighbor, shape) == \
            ref_ex.neighbor_perm(gr.neighbor, shape)
    for q in range(8):
        lin, coords, strides = port_ex.mesh_self_coords(shape, q)
        for ax in range(3):
            for sign in (1, -1):
                t = port_ex.shift_send_id(lin, coords, strides, shape, ax,
                                          sign)
                # the sender's target receives from target + sign
                src = dict((d, s) for s, d in port_ex._shift_perm(
                    shape[ax], sign))
                tc = list(np.unravel_index(t, shape))
                assert src[tc[ax]] == coords[ax]
    assert make_flat_mesh((2, 2, 1), devices=["cpu"] * 4).shape == (4,)


def test_event_plan_orders_the_stages_across_cards():
    """On entry each card waits on the cards it writes into; between
    stages and after the last every card waits on every other; one card
    waits on nothing."""
    waits = port_ex.event_plan([{0, 1}, {1, 0}, {2}], 2)
    assert waits[0] == [(0, 1), (1, 0)]
    every = [(c, d) for c in range(3) for d in range(3) if c != d]
    assert waits[1] == every and waits[2] == every and len(waits) == 3
    assert port_ex.event_plan([{0}], 3) == [[], [], [], []]
    # four ranks over two cards: the K9 plan and its waits
    _r, dec = _decs((16, 16, 32), (8, 8, 32), (8, 8, 0))
    mesh = Mesh((2, 2, 1), ("z", "y", "x"), ["cuda:0", "cuda:0", "cuda:1",
                                              "cuda:1"])
    ex = port_ex.shift_remote_exchange(dec, mesh, table_axes=(2,))
    assert len(ex.plan) == 2 and len(ex.waits) == 3
    assert ex.waits[0] == [(0, 1), (1, 0)]          # k crosses the cards
    for per_card in ex.plan:
        for c, rows in enumerate(per_card):
            assert all(sc == c for _dc, _dr, sc, _sr, _n in rows)


def test_check_stage_rejects_overlaps_by_rank():
    check = port_ex.check_stage
    check([(0, 0, 4), (1, 0, 4)], [(0, 4, 8), (1, 4, 8)])   # two ranks
    with pytest.raises(ValueError, match="destinations overlap"):
        check([(1, 0, 4), (1, 2, 6)], [])
    with pytest.raises(ValueError, match="overlaps a source"):
        check([(2, 0, 4)], [(0, 0, 4), (2, 3, 9)])
    check([(2, 0, 4)], [(2, 1, 2), (2, 4, 9), (1, 0, 9)][::-1][:2])
    with pytest.raises(ValueError, match="overlaps a source"):
        check([(2, 5, 6)], [(2, 0, 9), (2, 1, 2)])     # a long source first
    # a rank's ghosts written by two neighbours (a size-2 axis, both signs
    # aimed at one rank's same rows) is refused
    copies = [(0, 10, 12, 1, 0, 2), (0, 10, 12, 1, 2, 4)]
    with pytest.raises(ValueError, match="overlap"):
        port_ex.check_copies(copies)


def test_mesh_refusals():
    """No fallback: too few cards, refused peer access, a one-tensor call
    on a mesh of several ranks, a state on the wrong card."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA devices"):
        make_domain_mesh((have + 1, 1, 1))
    _r, dec = _decs((8, 8, 16), (4, 4, 8), (4, 4, 8))
    with pytest.raises(ValueError, match="Mesh"):
        port_ex.exchange_shift(torch.zeros((dec.nbricks, 4, 4, 8)), dec,
                               (2, 1, 1))
    mesh = make_domain_mesh((2, 1, 1), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="brick rows"):
        port_ex.exchange_put([torch.zeros((2, dec.nbricks - 1, 4, 4, 8))],
                             dec, mesh)
    with pytest.raises(ValueError, match="cards"):
        port_ex.exchange_shift([], dec, mesh)


def test_refused_peer_access_raises(monkeypatch):
    class Lib:
        enabled = []

        def bt_can_access_peer(self, dev, peer, ok):
            ok._obj.value = int(peer != 2)
            return 0

        def bt_enable_peer_access(self, dev, peer):
            self.enabled.append((dev, peer))
            return 0

    lib = Lib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    enable_peer_access(["cuda:0", "cuda:1", "cuda:0"])
    assert sorted(lib.enabled) == [(0, 1), (1, 0)]
    with pytest.raises(RuntimeError, match="peer access from cuda:0 to "
                                           "cuda:2 refused"):
        enable_peer_access(["cuda:0", "cuda:2"])
    enable_peer_access(["cpu", "cuda:1"])                   # one card


def test_remote_copy_checks_its_rows():
    flats = [torch.zeros(10, 4, 4), torch.ones(6, 4, 4)]
    with pytest.raises(ValueError, match="invalid"):
        port_ex.remote_copy(flats, 0, [(0, 8, 1, 0, 3)])
    with pytest.raises(ValueError, match="invalid"):
        port_ex.remote_copy(flats, 0, [(2, 0, 1, 0, 1)])
    with pytest.raises(ValueError, match="one shape"):
        port_ex.remote_copy([flats[0], torch.ones(6, 4, 2)], 0,
                            [(0, 0, 1, 0, 1)])
    port_ex.remote_copy(flats, 1, [(0, 2, 1, 3, 2), (1, 0, 0, 0, 1)])
    want = torch.zeros(10, 4, 4)
    want[2:4] = 1
    assert torch.equal(flats[0], want) and flats[1][0].eq(0).all()
