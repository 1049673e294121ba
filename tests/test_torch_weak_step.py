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


@pytest.mark.parametrize("kw,err,item", [
    # the torch oracle runs since it was ported (err None): validated
    # against the dense twin and the reference composition
    (dict(backend="jnp", bdim=(8, 8, 16)), None, None),
    # a mesh of more ranks than cards, with no devices given
    (dict(exchange="put", mesh_shape=(64, 1, 1), device="cuda"), ValueError,
     "CUDA devices"),
    # the fused exchange runs (tests/test_torch_fused_exchange.py) at
    # fuse=1 on 3-D domains; the reference refuses it otherwise
    (dict(exchange="fused", mesh_shape=(2, 1, 1)), ValueError,
     "fuse=1, no --overlap"),
    (dict(exchange="fused", fuse=1, overlap=True), ValueError,
     "fuse=1, no --overlap"),
    (dict(overlap=True), NotImplementedError, "pencil_sweep features"),
    # --profile runs (err None): the trace of the profiled steps is written,
    # the program's spans nested in it
    (dict(profile_dir="trace"), None, None),
    (dict(f64_validate=True), None, None),
    (dict(mesh_shape=(16, 1, 1), device="cuda"), ValueError, "CUDA devices"),
], ids=["kw0-torch oracle", "kw1-multi-GPU", "kw2-kernel-level exchanges",
        "kw3-kernel-level exchanges", "kw4-pencil_sweep features",
        "kw5-the rest", "kw6-torch oracle", "kw7-multi-GPU"])
def test_unported_options_raise(kw, err, item, capsys, tmp_path):
    """What the weak driver still refuses: the options of later slices, a
    mesh of more ranks than cards when no devices are given, and the
    fused exchange where the reference refuses it (the PUT, mesh and
    fused cases of earlier slices now run, in
    ``tests/test_torch_mesh_steps.py`` and
    ``tests/test_torch_fused_exchange.py``; ``--profile`` runs since the
    port has its tracing module)."""
    args = dict(STEP, backend="pencil", device="cpu")
    args.update(kw)
    if "profile_dir" in kw:
        args["profile_dir"] = tmp_path / kw["profile_dir"]
    if err is None:
        res = weak.run(**args, iters=1)
        out = capsys.readouterr().out
        assert "validated against array twin: OK" in out
        if args.get("f64_validate"):
            assert "validated in float64 at 1e-06: OK" in out
        elif "profile_dir" in kw:
            _check_profile(args["profile_dir"] / "weak_trace.json", res)
        else:
            _check_oracle_step(args)
        return
    with pytest.raises(err, match=item):
        weak.run(**args)


def _check_profile(path, res):
    """``--profile``'s Chrome trace holds the profiled step (``iters=1``)
    as a ``bricklib.step`` range around one ``bricklib.exchange`` and the
    two ``fuse=4`` ``bricklib.sweep`` ranges, each after the last; the run
    returns the spans' times by name."""
    import json

    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("bricklib."))
    (s0, s1, name), *inner = spans
    assert name == "bricklib.step"
    assert [n for _a, _b, n in inner] == ["bricklib.exchange",
                                          "bricklib.sweep", "bricklib.sweep"]
    ends = [s0] + [b for _a, b, _n in inner]
    for (a, b, _n), prev in zip(inner, ends):
        assert prev <= a <= b <= s1
    assert {k: v[0] for k, v in res["spans"].items()} == {
        "bricklib.step": 1, "bricklib.exchange": 1, "bricklib.sweep": 2}


def _check_oracle_step(args):
    """The oracle step against the reference composition: one SHIFT
    exchange over every axis, then the brick_apply iterations, the last
    over the owned bricks only."""
    from bricklib_tpu.codegen.jnp_backend import brick_apply

    step, storage, dec = weak.build_step(
        dims=args["dims"], bdim=args["bdim"], stencil="s7pt",
        st_iter=args["st_iter"], backend="jnp", device="cpu")
    ref = _reference_dec(dec)
    d = exchange_shift_ref(jnp.asarray(storage.numpy().copy()), ref,
                           ("x", "y", "z"), (1, 1, 1), interpret=True)
    sd, prm = stencil_by_name("s7pt")[0], bench_params()
    adj = jnp.asarray(ref.info.adj)
    owned = jnp.asarray(np.arange(1, ref.sep_pos[1]))
    for it in range(args["st_iter"]):
        if it < args["st_iter"] - 1:
            d = brick_apply(sd, {"bIn": d}, adj, prm)
        else:
            d = d.at[owned].set(brick_apply(sd, {"bIn": d}, adj, prm,
                                            rows=owned))
    own = dec.owned_mask()
    assert compare_arrays(step(storage).numpy()[own], np.asarray(d)[own],
                          1e-5)


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
    # a mesh needs one entry per domain axis
    (dict(mesh_shape=(1, 1, 1)), ValueError, "one entry per axis"),
], ids=["kw0-2-D", "kw1-multi-GPU"])
def test_unported_ranks_and_meshes_raise(kw, err, match):
    args = dict(STEP4, backend="pencil", device="cpu")
    args.update(kw)
    with pytest.raises(err, match=match):
        weak.run(**args)


@pytest.mark.parametrize("n,exchanged,fused", [
    (n, ex, False) for n in (1, 2, 4) for ex in (True, False)] + [
    (n, True, True) for n in (0, 1, 3)])
def test_step_sweeps_runs_ghost_inclusive_sweeps_but_the_last(n, exchanged,
                                                              fused):
    """``StepSweeps`` runs ``n`` sweeps on each card of a state, every one
    but the last ghost-inclusive where more than one runs and some axis
    exchanges, and otherwise builds no ghost-inclusive sweep.  It makes
    each card's sweeps once per rank count, on first use, in one
    ``bricklib.plan.kernels`` span.  With the fused exchange (K11 is the
    first sweep) the step runs ``n = st_iter - 1`` sweeps and the step
    without its exchange ``n + 1`` of them, sharing the plans."""
    from types import SimpleNamespace

    from bricklib_tpu_torch import trace
    from bricklib_tpu_torch.codegen.schedule import StepSweeps

    made, ran = [], []

    def make(p, ghost):
        made.append((p, ghost))

        def fn(d):
            assert tuple(d.shape) == (p * 4, 2, 3)
            ran.append((p, ghost))
            return d + 1

        fn.plan = SimpleNamespace(bdims=(2, 3))
        return fn

    def want(p, m):
        if m > 1 and exchanged:
            return [(p, True)] * (m - 1) + [(p, False)]
        return [(p, False)] * m

    step = StepSweeps(make, n, exchanged)
    runs = [(step, n)] + ([(step.longer(1), n + 1)] if fused else [])
    state = [torch.zeros((2, 4, 2, 3)), torch.zeros((3, 4, 2, 3))]
    for sweeps, m in runs:
        for first in (True, False):
            made_before = len(made)
            ran.clear()
            with trace.tracing():
                trace.records()
                out = sweeps(state)
                spans = [s.name for s in trace.records()]
            assert [t.shape for t in out] == [t.shape for t in state]
            assert all(bool((t == m).all()) for t in out)
            assert ran == want(2, m) + want(3, m)
            new = made[made_before:]
            assert spans == [trace.PLAN_KERNELS] * len({p for p, _ in new})
            assert first or new == []
    top = max(m for _, m in runs)
    ghost = exchanged and top > 1
    assert sorted(made) == [(p, g) for p in (2, 3) for g in (False, True)
                            if top and (ghost or not g)]
    assert len(made) == len(set(made))
    assert all(made.index((p, False)) < made.index((p, True))
               for p, g in made if g)
