"""The torch oracle (``bricklib_tpu_torch.codegen.jnp_backend``) against the
reference's ``jnp_backend`` on every corpus stencil, in dense and brick
form and on a brick subset (``rows``), the weak driver's oracle step
against the reference composition (SHIFT exchange, then ``brick_apply``
iterations), and the weak and strong drivers' oracle runs (``--backend
jnp``, ``--overlap``, ``--f64-validate``) validated against their dense
twins.

Inputs are made with numpy and handed to both packages; each builds its
own stencil and decomposition.  The reference runs on jax's CPU arrays,
the port on CPU tensors; results are compared at abs-or-rel 5e-5 (XLA may
reassociate the float32 sums), numpy forms bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bricklib_tpu import comm as ref_comm
from bricklib_tpu import stencils as ref_stencils
from bricklib_tpu.codegen import jnp_backend as ref_backend
from bricklib_tpu.comm.exchange import exchange_shift as ref_exchange_shift
from bricklib_tpu.core import compare_arrays, random_array
from bricklib_tpu_torch import comm as port_comm
from bricklib_tpu_torch import stencils as port_stencils
from bricklib_tpu_torch.codegen import jnp_backend as port_backend
from bricklib_tpu_torch.codegen.evaluate import TorchNS
from bricklib_tpu_torch.comm.exchange import copy_intervals
from bricklib_tpu_torch.drivers import strong, weak

CORPUS = ref_stencils.CORPUS
TOL = 5e-5


def _inputs(sd, shape, seed):
    return {n: random_array(shape, np.float32, seed + k)
            for k, n in enumerate(sd.inputs)}


@pytest.mark.parametrize("name", CORPUS)
def test_dense_apply_on_tensors_matches_reference(name):
    ref_sd = ref_stencils.stencil_by_name(name)[0]
    port_sd = port_stencils.stencil_by_name(name)[0]
    shape = (6, 6, 6, 10) if ref_sd.dims == 4 else (10, 10, 12)
    ins = _inputs(ref_sd, shape, 3)
    prm = ref_stencils.bench_params()
    want = np.asarray(ref_backend.dense_apply(
        ref_sd, {n: jnp.asarray(a) for n, a in ins.items()}, prm))
    got = port_backend.dense_apply(
        port_sd, {n: torch.from_numpy(a) for n, a in ins.items()}, prm)
    assert torch.is_tensor(got) and got.dtype == torch.float32
    assert got.shape == want.shape
    assert compare_arrays(got.numpy(), want, TOL)


def _decomps(nd):
    if nd == 4:
        kw = dict(dims=(8, 8, 8, 16), ghost_depth=(4, 4, 4, 8),
                  bdims=(4, 4, 4, 8))
    else:
        kw = dict(dims=(16, 16, 16), ghost_depth=(4, 4, 8), bdims=(4, 4, 8))
    ref = ref_comm.BrickDecomp(**kw).initialize(
        ref_comm.skinlist_by_name("good", nd))
    port = port_comm.BrickDecomp(**kw).initialize(
        port_comm.skinlist_by_name("good", nd))
    assert np.array_equal(ref.info.adj, port.info.adj)
    return ref, port


@pytest.mark.parametrize("rows", [False, True], ids=["all", "rows"])
@pytest.mark.parametrize("name", CORPUS)
def test_brick_apply_on_tensors_matches_reference(name, rows):
    """Brick form on every brick, and on the owned bricks only (``rows``,
    the drivers' last iteration), with ``adj`` and ``rows`` given as
    numpy arrays to the reference and as tensors to the port."""
    ref_sd = ref_stencils.stencil_by_name(name)[0]
    port_sd = port_stencils.stencil_by_name(name)[0]
    ref_dec, port_dec = _decomps(ref_sd.dims)
    bd = tuple(port_dec.bdims)
    ins = {n: random_array((port_dec.nbricks,) + bd, np.float32, 7 + k)
           for k, n in enumerate(ref_sd.inputs)}
    sel = np.arange(1, port_dec.sep_pos[1]) if rows else None
    prm = ref_stencils.bench_params()
    want = np.asarray(ref_backend.brick_apply(
        ref_sd, {n: jnp.asarray(a) for n, a in ins.items()},
        jnp.asarray(ref_dec.info.adj), prm,
        rows=None if sel is None else jnp.asarray(sel)))
    got = port_backend.brick_apply(
        port_sd, {n: torch.from_numpy(a) for n, a in ins.items()},
        torch.from_numpy(port_dec.info.adj),
        prm, rows=None if sel is None else torch.from_numpy(sel))
    assert got.shape == want.shape
    assert compare_arrays(got.numpy(), want, TOL)
    # the numpy form is the reference's numpy form bit for bit
    np_got = port_backend.brick_apply(port_sd, ins, port_dec.info.adj, prm,
                                      rows=sel)
    np_want = ref_backend.brick_apply(ref_sd, ins, ref_dec.info.adj, prm,
                                      xp=np, rows=sel)
    assert isinstance(np_got, np.ndarray)
    assert np.array_equal(np_got, np_want)


def test_cond_through_torch_with_xp_torch():
    """``cond`` calls ``max`` and ``min`` with a Python scalar: with
    ``xp=torch`` the evaluator takes :class:`TorchNS` (``torch.maximum``
    alone refuses the scalar with a ``TypeError``)."""
    sd = port_stencils.stencil_by_name("cond")[0]
    a = random_array((10, 10, 12), np.float32, 11) - np.float32(0.5)
    prm = port_stencils.bench_params()
    want = port_backend.dense_apply(sd, {"bIn": a}, prm, xp=np)
    got = port_backend.dense_apply(sd, {"bIn": torch.from_numpy(a)}, prm,
                                   xp=torch)
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        torch.maximum(torch.from_numpy(a), 0.5)


def test_torch_namespace_takes_scalars():
    t = torch.tensor([-1.0, 0.25, 2.0])
    assert TorchNS.maximum(0.0, t).tolist() == [0.0, 0.25, 2.0]
    assert TorchNS.minimum(t, 1.0).tolist() == [-1.0, 0.25, 1.0]
    assert TorchNS.maximum(t, torch.zeros(3)).tolist() == [0.0, 0.25, 2.0]
    assert TorchNS.abs(-2.0) == 2.0 and TorchNS.sqrt(4.0) == 2.0
    assert TorchNS.exp(0.0) == 1.0 and TorchNS.log(1.0) == 0.0


# --- the weak driver's oracle step --------------------------------------

WEAK = dict(dims=(16, 16, 32), bdim=(4, 4, 16), stencil="s7pt",
            st_iter=4)


def _reference_weak_step(x, dec, st_iter, sd_name="s7pt"):
    """The reference's jnp weak step on one device (weak.py:240-288):
    one SHIFT exchange over every axis, then ``st_iter`` brick_apply
    iterations, the last over the owned bricks only."""
    ref = ref_comm.BrickDecomp(dims=dec.dims, ghost_depth=dec.ghost_depth,
                               bdims=dec.bdims).initialize(
        ref_comm.skinlist_by_name("good", len(dec.dims)))
    assert np.array_equal(ref.grid, dec.grid)
    sd = ref_stencils.stencil_by_name(sd_name)[0]
    prm = ref_stencils.bench_params()
    adj = jnp.asarray(ref.info.adj)
    owned = jnp.asarray(np.arange(1, ref.sep_pos[1]))
    d = ref_exchange_shift(jnp.asarray(x), ref, ("x", "y", "z"), (1, 1, 1),
                           interpret=True)
    for it in range(st_iter):
        if it == st_iter - 1:
            out = ref_backend.brick_apply(sd, {"bIn": d}, adj, prm,
                                          rows=owned)
            d = d.at[owned].set(out)
        else:
            d = ref_backend.brick_apply(sd, {"bIn": d}, adj, prm)
    return np.asarray(d)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["plain", "overlap"])
def test_weak_oracle_step_matches_reference(overlap):
    step, storage, dec = weak.build_step(**WEAK, backend="jnp",
                                         overlap=overlap, device="cpu")
    x = storage.numpy().copy()
    want = _reference_weak_step(x, dec, WEAK["st_iter"])
    before = copy_intervals.launches
    got = step(storage).numpy()
    assert copy_intervals.launches == before       # the CPU: no kernel
    own = dec.owned_mask()
    assert compare_arrays(got[own], want[own], TOL)


@pytest.mark.parametrize("kw", [
    dict(mesh_shape=(2, 1, 2)),
    dict(mesh_shape=(2, 2, 1), overlap=True, exchange="put"),
    dict(mesh_shape=(1, 2, 1), exchange="shift-remote"),
    dict(f64_validate=True),
    dict(dims=(8, 8, 8, 16), bdim=(4, 4, 4, 8), stencil="mpi9pt",
         st_iter=2, mesh_shape=(1, 2, 1, 2)),
], ids=["mesh-i-distributed", "overlap-put", "shift-remote", "f64",
        "4-D"])
def test_weak_oracle_runs_validate(kw, capsys):
    args = dict(WEAK, validate=True, iters=1, device="cpu")
    args.update(kw)
    res = weak.run(**args)
    out = capsys.readouterr().out
    assert "validated against array twin: OK" in out
    assert "backend jnp" in out and "exchange share" in out
    if kw.get("f64_validate"):
        assert "validated in float64 at 1e-06: OK" in out
    assert res["ranks"] == int(np.prod(kw.get("mesh_shape", (1,))))


def test_weak_oracle_validation_catches_a_wrong_step():
    s = weak._make_step(WEAK["dims"], WEAK["bdim"], "s7pt", 4, 1, True,
                        "good", "cpu", quiet=True, backend="jnp")
    assert weak.validate_step(s, "s7pt", 4)
    s.step = s.step_noex              # no exchange: the ghosts stay zero
    assert not weak.validate_step(s, "s7pt", 4)


def test_weak_cli_defaults_to_the_oracle(capsys):
    weak.main(["--iters", "1", "--device", "cpu", "--f64-validate",
               "--overlap"])
    out = capsys.readouterr().out
    assert "backend jnp" in out and "overlap" in out
    assert "validated against array twin: OK" in out
    assert "validated in float64 at 1e-06: OK" in out


@pytest.mark.parametrize("kw,err,match", [
    (dict(exchange="fused"), ValueError, "runs on the pencil backend"),
    (dict(backend="pencil", overlap=True), NotImplementedError,
     "3\\(c\\)|inplace"),
    (dict(backend="dense"), ValueError, "unknown backend"),
], ids=["fused", "pencil-overlap", "unknown"])
def test_weak_oracle_refusals(kw, err, match):
    args = dict(WEAK, device="cpu", iters=1)
    args.update(kw)
    with pytest.raises(err, match=match):
        weak.run(**args)


# --- the strong driver's oracle step ------------------------------------

@pytest.mark.parametrize("kw", [
    dict(), dict(mesh_shape=(2, 1, 2)),
    dict(mesh_shape=(2, 1, 1), exchange="remote"),
], ids=["cubic", "mesh-i-distributed", "remote"])
def test_strong_oracle_runs_validate(kw, capsys):
    args = dict(dom=(32, 32, 32), sdom=(16, 16, 16), bdim=(4, 4, 8),
                stencil="s7pt", st_iter=2, backend="jnp", validate=True,
                iters=1, device="cpu")
    args.update(kw)
    res = strong.run(**args)
    out = capsys.readouterr().out
    assert "validated against global dense twin: OK" in out
    assert "backend jnp" in out
    assert res["exchange_steps"] == 6          # three axes, both signs


def test_strong_oracle_validation_catches_a_wrong_step():
    step, storage, plan, g = strong.build_step(
        dom=(32, 32, 32), sdom=(16, 16, 16), bdim=(4, 4, 8),
        stencil="s7pt", st_iter=2, device="cpu", backend="jnp")
    assert strong.validate_step(step, storage, plan, g, "s7pt", 2)
    storage[:, 1:2] = 0               # one owned brick of every subdomain
    assert not strong.validate_step(step, storage, plan, g, "s7pt", 2)
