"""The port's strong-scaling path (``bricklib_tpu_torch.comm.strong``,
``drivers.strong`` and the batched sweep) against the reference on one
device, in interpret mode.

- ``StrongDecomp`` must equal the reference's field by field;
- the strong exchange only copies, so it must be bit-exact against the
  reference's ``exchange_strong_shift`` run on one device outside
  ``shard_map`` (no ``ppermute`` runs on a mesh of single-device axes);
- the batched sweep and the step are compared on the bricks they write at
  abs-or-rel 5e-5 (the f32 tolerance of ``core/compare.py``); the driver's
  own validation against the global dense twin runs at 1e-4.

On the CPU the port runs the plain versions of kernels K1 and K5; the
kernels are held against them on the card in ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu.codegen.pencil_kernel import pallas_pencil_sweep
from bricklib_tpu.comm import skinlist_by_name
from bricklib_tpu.comm.strong import StrongDecomp as StrongDecompRef
from bricklib_tpu.comm.strong import exchange_strong_shift as strong_ref
from bricklib_tpu.core import compare_arrays, random_array
from bricklib_tpu.stencils import bench_params, stencil_by_name
from bricklib_tpu_torch import comm as port_comm
from bricklib_tpu_torch import stencils as port_stencils
from bricklib_tpu_torch.codegen.pencil_kernel import (pencil_sweep,
                                                      pencil_sweep_kernel)
from bricklib_tpu_torch.comm.exchange import check_stage
from bricklib_tpu_torch.comm.mesh import make_domain_mesh
from bricklib_tpu_torch.comm.strong import (StrongDecomp,
                                            exchange_strong_remote,
                                            exchange_strong_shift,
                                            stage_copy, stage_copy_plain,
                                            strong_exchange, strong_stages)
from bricklib_tpu_torch.convert import storage_from_reference
from bricklib_tpu_torch.drivers import strong

TOL = 5e-5
# pencil subdomains (the strong step's layout) and cubic ones with a
# ghost ring in every axis, both on one device
PENCIL = dict(dom=(32, 32, 32), sdom=(16, 16, 32), bdims=(4, 4, 32),
              ghost_depth=(4, 4, 0))
CUBIC = dict(dom=(32, 32, 32), sdom=(16, 16, 16), bdims=(4, 4, 8),
             ghost_depth=(4, 4, 8))
STEP = dict(dom=(32, 32, 32), sdom=(16, 16, 32), bdim=(4, 4, 32),
            stencil="s7pt", st_iter=4, fuse=2)


def _plans(cfg, mesh=(1, 1, 1)):
    """(reference plan, port plan), each with its own package's skin."""
    return (StrongDecompRef(mesh_shape=mesh, **cfg).initialize(
                skinlist_by_name("good", 3)),
            StrongDecomp(mesh_shape=mesh, **cfg).initialize(
                port_comm.skinlist_by_name("good", 3)))


@pytest.mark.parametrize("cfg,mesh", [(PENCIL, (1, 1, 1)),
                                      (CUBIC, (1, 1, 1)),
                                      (CUBIC, (2, 1, 1)),
                                      (dict(CUBIC, dom=(64, 32, 32)),
                                       (2, 1, 1))])
def test_plan_matches_reference_field_by_field(cfg, mesh):
    ref, port = _plans(cfg, mesh)
    for f in ("dom", "sdom", "mesh_shape", "bdims", "ghost_depth",
              "sub_grid", "local_block", "nsub_local"):
        assert getattr(port, f) == getattr(ref, f), f
    assert np.array_equal(port.sub_order, ref.sub_order)
    assert np.array_equal(port.coord_to_row, ref.coord_to_row)
    assert port.sdec.nbricks == ref.sdec.nbricks
    assert np.array_equal(port.sdec.grid, ref.sdec.grid)
    for axis in range(3):
        for sign in (+1, -1):
            for a, b in zip(port.neighbor_rows(axis, sign),
                            ref.neighbor_rows(axis, sign)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_plan_checks_as_the_reference():
    for bad in (dict(CUBIC, sdom=(12, 16, 16)),
                dict(CUBIC, dom=(48, 32, 32))):
        mesh = (2, 1, 1)
        with pytest.raises(ValueError) as ref:
            StrongDecompRef(mesh_shape=mesh, **bad).initialize(
                skinlist_by_name("good", 3))
        with pytest.raises(ValueError) as port:
            StrongDecomp(mesh_shape=mesh, **bad).initialize(
                port_comm.skinlist_by_name("good", 3))
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("cfg", [PENCIL, CUBIC], ids=["pencil", "cubic"])
def test_exchange_matches_reference_bit_exact(cfg):
    ref, port = _plans(cfg)
    nb = port.sdec.nbricks
    x = random_array((port.nsub_local, nb) + tuple(cfg["bdims"]),
                     np.float32, 17)
    want = np.asarray(strong_ref(jnp.asarray(x), ref, ("x", "y", "z")))
    dat = storage_from_reference(x, "cpu")
    before = stage_copy.launches
    got = exchange_strong_shift(dat, port)
    assert stage_copy.launches == before
    assert got is dat                      # in place
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, x)     # the exchange moved bricks
    again = exchange_strong_remote(storage_from_reference(x, "cpu"), port)
    assert np.array_equal(again.numpy(), want)


def test_stages_are_disjoint_and_planned_once():
    _ref, port = _plans(PENCIL)
    steps = strong_stages(port)
    assert [(s.axis, s.sign) for s in steps] == [(1, 1), (1, -1), (0, 1),
                                                 (0, -1)]
    for st in steps:
        check_stage([(d0, d1) for d0, d1, _, _ in st.local_ivs
                     + st.recv_ivs],
                    [(s0, s1) for _, _, s0, s1 in st.local_ivs])
        assert sum(r1 - r0 for _, _, r0, r1 in st.recv_ivs) == len(st.gather)
    ex = strong_exchange(port)
    x = storage_from_reference(random_array(
        (port.nsub_local, port.sdec.nbricks) + PENCIL["bdims"], np.float32,
        18), "cpu")
    a = ex(x.clone())
    assert torch.equal(ex(a.clone()), a)   # a second exchange is a no-op


def test_multi_device_mesh_raises():
    """A plan of several ranks takes a Mesh of its shape and the mesh's
    state (``tests/test_torch_mesh_exchange.py`` holds that against the
    reference); one bare stack, or a mesh of another shape, raises."""
    _ref, port = _plans(CUBIC, (2, 1, 1))
    x = torch.zeros((port.nsub_local, port.sdec.nbricks) + CUBIC["bdims"])
    for fn in (exchange_strong_shift, exchange_strong_remote):
        with pytest.raises(ValueError, match="Mesh"):
            fn(x, port)
        with pytest.raises(ValueError, match="not the plan"):
            fn([x[None]], port, mesh=make_domain_mesh((1, 1, 1),
                                                      devices=["cpu"]))


def test_stage_copy_checks_its_intervals():
    flat = torch.zeros(10, 4, 4)
    recv = torch.ones(3, 4, 4)
    with pytest.raises(ValueError, match="invalid"):
        stage_copy(flat, [(8, 11, 0, 3)], None, [])
    with pytest.raises(ValueError, match="invalid"):
        stage_copy(flat, [], recv, [(0, 2, 2, 4)])
    with pytest.raises(ValueError, match="receive buffer"):
        stage_copy(flat, [], recv.double(), [(0, 2, 0, 2)])
    with pytest.raises(ValueError, match="overlaps"):
        check_stage([(0, 2)], [(1, 3)])
    with pytest.raises(ValueError, match="overlap"):
        check_stage([(0, 2), (1, 3)], [])
    stage_copy(flat, [(0, 1, 9, 10)], recv, [(4, 6, 1, 3)])
    want = torch.zeros(10, 4, 4)
    stage_copy_plain(want, [(0, 1, 9, 10)], recv, [(4, 6, 1, 3)])
    assert torch.equal(flat, want) and flat[4:6].eq(1).all()


@pytest.mark.parametrize("fuse,ranges", [(1, "skip"), (2, "ghost"),
                                         (2, "skip")])
def test_batched_sweep_matches_reference(fuse, ranges):
    _ref, port = _plans(PENCIL)
    kg = port.sdec.periodic_grid((2,))
    nb, nsub = port.sdec.nbricks, port.nsub_local
    GK, GJ = kg.shape[:2]
    kw = dict(batch=nsub, batch_stride=nb, fuse=fuse)
    if ranges == "ghost":
        kw.update(k_range=(0, GK), j_range=(0, GJ))
    x = random_array((nsub * nb,) + PENCIL["bdims"], np.float32, 19)
    want = np.asarray(pallas_pencil_sweep(
        stencil_by_name("s7pt")[0], kg, PENCIL["bdims"], nsub * nb,
        bench_params(), interpret=True, **kw)(jnp.asarray(x)))
    fn = pencil_sweep(port_stencils.stencil_by_name("s7pt")[0], kg,
                      PENCIL["bdims"], nsub * nb, bench_params(), **kw)
    before = pencil_sweep_kernel.launches
    got = fn(storage_from_reference(x, "cpu")).numpy()
    assert pencil_sweep_kernel.launches == before
    w = fn.plan.written_bricks()
    per_sub = (GK if ranges == "ghost" else GK - 2) * (
        GJ if ranges == "ghost" else GJ - 2)
    assert len(w) == nsub * per_sub
    assert compare_arrays(got[w], want[w], TOL)


def test_batched_sweep_checks_its_table():
    grid = np.arange(36, dtype=np.int32).reshape(6, 6)
    with pytest.raises(ValueError, match="outside 36 bricks"):
        pencil_sweep("s7pt", grid, (8, 8, 32), 36, bench_params(), batch=2,
                     batch_stride=36)


def _reference_step(x, ref, sdom_bd):
    """The reference composition: ``exchange_strong_shift`` then a
    ghost-inclusive and an owned-only batched ``fuse=2`` sweep."""
    sd = stencil_by_name("s7pt")[0]
    kg = ref.sdec.periodic_grid((2,))
    nb, nsub = ref.sdec.nbricks, ref.nsub_local
    GK, GJ = kg.shape[:2]
    kw = dict(batch=nsub, batch_stride=nb, fuse=2, interpret=True)
    ghost = pallas_pencil_sweep(sd, kg, sdom_bd, nsub * nb, bench_params(),
                                k_range=(0, GK), j_range=(0, GJ), **kw)
    skip = pallas_pencil_sweep(sd, kg, sdom_bd, nsub * nb, bench_params(),
                               **kw)
    d = strong_ref(jnp.asarray(x), ref, ("x", "y", "z"))
    flat = d.reshape((nsub * nb,) + sdom_bd)
    return np.asarray(skip(ghost(flat))).reshape(x.shape)


def test_step_matches_reference_composition():
    step, storage, plan, _g = strong.build_step(**STEP, device="cpu")
    ref = StrongDecompRef(dom=STEP["dom"], sdom=STEP["sdom"],
                          mesh_shape=(1, 1, 1), bdims=STEP["bdim"],
                          ghost_depth=(4, 4, 0)).initialize(
        skinlist_by_name("good", 3))
    x = storage.numpy().copy()
    want = _reference_step(x, ref, STEP["bdim"])
    got = step(storage).numpy()
    own = plan.sdec.owned_mask()
    assert compare_arrays(got[:, own], want[:, own], TOL)


def test_run_validates_against_global_dense_twin(capsys):
    res = strong.run(**STEP, validate=True, iters=2, device="cpu")
    out = capsys.readouterr().out
    assert "validated against global dense twin: OK" in out
    assert "GStencil/s" in out and "copy roofline" in out
    assert res["device"] == "cpu" and res["exchange_steps"] == 4
    assert res["calls"] == {"step": 1 + 1 + 2 + 2, "copy": 1 + 2}
    assert res["step"] > 0 and res["copy"] > 0


def test_validation_catches_a_wrong_step():
    step, storage, plan, g = strong.build_step(**STEP, device="cpu")
    assert strong.validate_step(step, storage, plan, g, "s7pt", 4)
    sweeps = [f for f in step.sweeps if f is not None]

    def no_exchange(x):
        flat = x.view((-1,) + tuple(plan.bdims))
        for f in sweeps:
            flat = f(flat)
        return flat.view(x.shape)

    assert not strong.validate_step(no_exchange, storage, plan, g, "s7pt",
                                    4)


def test_cli_runs_the_step_on_cpu(capsys):
    strong.main(["-d", "32,32,32", "-s", "16,16,32", "-b", "4,4,32",
                 "--stencil", "s7pt", "-I", "4", "--fuse", "2", "--mesh",
                 "1,1,1", "-v", "--iters", "1", "--device", "cpu",
                 "--exchange", "remote"])
    assert "validated against global dense twin: OK" in \
        capsys.readouterr().out


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        strong.build_step(**STEP)
    with pytest.raises(RuntimeError, match="cuda"):
        strong.run(**STEP, iters=1)


@pytest.mark.parametrize("kw,err,match", [
    # the torch oracle runs since it was ported (err None): cubic
    # subdomains, validated against the global dense twin
    (dict(backend="jnp", sdom=(16, 16, 16), bdim=(4, 4, 8)), None, None),
    # a mesh of more ranks than cards, with no devices given
    (dict(mesh_shape=(16, 1, 1), device="cuda", dom=(512, 32, 32)),
     ValueError, "CUDA devices"),
    # cubic subdomains on the pencil backend run since K1 takes i-bricked
    # tables (err None; the id keeps its first name): validated against
    # the global dense twin
    (dict(sdom=(16, 16, 16), bdim=(4, 4, 4)), None, None),
    (dict(exchange="put"), ValueError, "exchange is"),
    (dict(st_iter=8), ValueError, "ghost depth"),
    (dict(fuse=3), ValueError, "multiple of fuse"),
], ids=["kw0-NotImplementedError-torch oracle",
        "kw1-NotImplementedError-multi-GPU",
        "kw2-NotImplementedError-i-bricked", "kw3-ValueError-exchange is",
        "kw4-ValueError-ghost depth", "kw5-ValueError-multiple of fuse"])
def test_unported_and_bad_options_raise(kw, err, match, capsys):
    args = dict(STEP, device="cpu")
    args.update(kw)
    if err is None:
        res = strong.run(**args, validate=True, iters=1)
        assert "validated against global dense twin: OK" in \
            capsys.readouterr().out
        assert res["exchange_steps"] == 6
        return
    with pytest.raises(err, match=match):
        strong.run(**args)
