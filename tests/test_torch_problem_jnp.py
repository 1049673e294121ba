"""The port's ``Problem(backend="jnp")``, the torch oracle at any rank and on
any mesh, on the CPU against the reference ``Problem(backend="jnp")`` on
the same numpy inputs: ranks 2 to 5, meshes whose innermost axis is
distributed, a stencil system and an aux field at rank 3, and the
``"auto"`` dispatch.

Each stencil is built by the same function from each package's own eDSL.
Results are compared on the owned region at abs-or-rel 5e-5
(``core/compare.py``'s f32 tolerance: XLA may reassociate the sums).
"""

import numpy as np
import pytest

from bricklib_tpu import st as ref_st
from bricklib_tpu.api import Problem as RefProblem
from bricklib_tpu.core import compare_arrays
from bricklib_tpu_torch import st as port_st
from bricklib_tpu_torch.api import Problem
from bricklib_tpu_torch.comm.exchange import copy_intervals

from torch_2d_stencils import box9, varcoeff, wave

TOL = 5e-5


def sd5(st):
    """``tests/test_dim_generic.py``'s 5-D stencil."""
    idx = [st.Index(a) for a in range(5)]
    g, o = st.Grid("in", 5), st.Grid("out", 5)
    a1, a2, a3 = list(idx), list(idx), list(idx)
    a1[4] = idx[4] + 1
    a2[0] = idx[0] - 1
    a3[2] = idx[2] + 1
    o(*idx).assign(0.5 * g(*idx) + 0.25 * g(*a1) + 0.25 * g(*a2)
                   - 0.1 * g(*a3))
    return st.load_stencil_module({"STENCIL": [o]})[0]


def aux3(st):
    i, j, k = st.Index(0), st.Index(1), st.Index(2)
    g, c, o = st.Grid("in", 3), st.Grid("c", 3), st.Grid("out", 3)
    o(i, j, k).assign(0.5 * c(i, j, k) * g(i + 1, j, k)
                      + 0.25 * g(i, j, k - 1) + 0.25 * g(i, j - 1, k))
    return st.load_stencil_module({"STENCIL": [o]})[0]


def sys3(st):
    i, j, k = st.Index(0), st.Index(1), st.Index(2)
    u, v = st.Grid("u", 3), st.Grid("v", 3)
    ou, ov = st.Grid("ou", 3), st.Grid("ov", 3)
    ou(i, j, k).assign(u(i, j, k) + 0.5 * v(i + 1, j, k))
    ov(i, j, k).assign(v(i, j, k) - 0.5 * u(i, j + 1, k - 1))
    return st.load_stencil_module({"STENCIL": [ou, ov]})


def _pair(stencil, **kw):
    if callable(stencil):
        ref_sd, port_sd = stencil(ref_st), stencil(port_st)
    else:
        ref_sd = port_sd = stencil
    return (RefProblem(stencil=ref_sd, **kw),
            Problem(stencil=port_sd, device="cpu", **kw))


def _check_same(ref, port):
    a, b = ref.result(), port.result()
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert compare_arrays(b[k], a[k], TOL), k
    else:
        assert b.shape == a.shape
        assert compare_arrays(b, a, TOL)


def _global(p, seed):
    shape = tuple(m * d for m, d in zip(p.eff_mesh, p.dims))
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


CASES = [
    # tests/test_dim_generic.py's 5-D distributed problem
    (sd5, dict(dims=(4, 4, 4, 4, 8), bdims=(2, 2, 2, 2, 4),
               backend="jnp", mesh=(2, 1, 2, 1, 1))),
    # rank 5 on one rank, auto
    (sd5, dict(dims=(4, 4, 4, 4, 8), bdims=(2, 2, 2, 2, 4), st_iter=2)),
    # the innermost axis distributed (auto picks the oracle)
    ("mpi7pt", dict(dims=(16, 16, 32), bdims=(4, 4, 16), mesh=(1, 2, 2),
                    st_iter=2)),
    ("mpi9pt", dict(dims=(8, 8, 16, 32), bdims=(4, 4, 8, 16), st_iter=2,
                    backend="jnp")),
    # 2-D bricks that do not span the row (auto picks the oracle)
    (box9, dict(dims=(16, 32), bdims=(8, 16), mesh=(2, 1), st_iter=2)),
    ("cond", dict(dims=(16, 16, 32), bdims=(4, 4, 16), backend="jnp")),
]


@pytest.mark.parametrize("stencil,kw", CASES,
                         ids=["5d-mesh-dim-generic", "5d-auto", "3d-i-mesh",
                              "4d", "2d-mesh-auto", "3d-cond"])
def test_problem_jnp_matches_reference(stencil, kw):
    ref, port = _pair(stencil, **kw)
    assert port.backend == ref.backend == "jnp"
    x = _global(port, 0)
    ref.init(array=x).step(2)
    before = copy_intervals.launches
    port.init(array=x).step(2)
    assert copy_intervals.launches == before      # the CPU: no kernel
    _check_same(ref, port)


def test_problem_jnp_system_and_aux_at_rank_3():
    ref, port = _pair(sys3, dims=(16, 16, 32), bdims=(4, 4, 16),
                      backend="jnp", field=("u", "v"), st_iter=2)
    arrays = {f: _global(port, s) for s, f in enumerate(("u", "v"))}
    ref.init(array=arrays).step(2)
    port.init(array=arrays).step(2)
    _check_same(ref, port)
    ref, port = _pair(aux3, dims=(16, 16, 32), bdims=(4, 4, 16),
                      backend="jnp", field="in", mesh=(2, 1, 1))
    x, c = _global(port, 3), _global(port, 4)
    ref.init(array=x, aux={"c": c}).step(3)
    port.init(array=x, aux={"c": c}).step(3)
    _check_same(ref, port)


def test_problem_jnp_wave_and_varcoeff_at_rank_2():
    ref, port = _pair(wave, dims=(16, 32), bdims=(8, 16), field=("p", "v"),
                      backend="jnp")
    arrays = {f: _global(port, 5 + s) for s, f in enumerate(("p", "v"))}
    ref.init(array=arrays).step(2)
    port.init(array=arrays).step(2)
    _check_same(ref, port)
    ref, port = _pair(varcoeff, dims=(16, 32), bdims=(8, 16), field="in",
                      backend="jnp")
    x, k = _global(port, 7), _global(port, 8)
    aux = {n: k for n in ref.aux_names}
    ref.init(array=x, aux=aux).step(1)
    port.init(array=x, aux=aux).step(1)
    _check_same(ref, port)


AUTO = [
    dict(dims=(4, 4, 4, 4, 8), stencil=sd5, bdims=(2, 2, 2, 2, 4)),
    dict(dims=(16, 16, 32), stencil="mpi7pt", mesh=(1, 1, 2),
         bdims=(4, 4, 16)),
    dict(dims=(16, 32), stencil=box9, bdims=(8, 16)),
    dict(dims=(8, 8, 16, 32), stencil="mpi9pt", bdims=(4, 4, 8, 16)),
    dict(dims=(16, 32), stencil=box9),
    dict(dims=(16, 16, 32), stencil="s7pt"),
    dict(dims=(8, 16, 16, 32), stencil="mpi9pt", bdims=(2, 8, 8, 32)),
]


@pytest.mark.parametrize("kw", AUTO, ids=[
    "rank5", "i-distributed", "2d-short-row", "4d-short-row", "2d",
    "3d", "4d"])
def test_auto_resolves_as_the_reference(kw):
    kw = dict(kw)
    ref, port = _pair(kw.pop("stencil"), **kw)
    assert port.backend == ref.backend
    assert port.bdims == ref.bdims and port.ghost == ref.ghost
    if port.backend == "jnp":
        a, b = ref.describe(), port.describe()
        for key in ("backend", "fuse", "exchange", "kernels",
                    "exchange_axes", "bdims", "dims", "mesh", "st_iter"):
            assert a[key] == b[key], key


def test_jnp_defaults_and_rollout():
    """The oracle's default bricks (``min(8, d)`` per outer axis,
    ``min(128, d_i)`` on the row) with ghosts a whole brick deep;
    ``rollout(n)`` is ``step(n)``."""
    ref, port = _pair("s7pt", dims=(16, 16, 256), backend="jnp")
    assert port.bdims == ref.bdims == (8, 8, 128)
    assert port.ghost == ref.ghost == (8, 8, 128)
    x = _global(port, 9)
    ref.init(array=x).rollout(2)
    port.init(array=x).rollout(2)
    _check_same(ref, port)
    again = Problem(stencil="s7pt", dims=(16, 16, 256), backend="jnp",
                    device="cpu").init(array=x).step(2)
    assert np.array_equal(again.result(), port.result())


@pytest.mark.parametrize("kw,err,match", [
    (dict(dims=(16, 16, 32), bdims=(4, 4, 16), st_iter=5), ValueError,
     "exceeds ghost depth"),
    (dict(dims=(16, 16, 32), bdims=(4, 4, 16), schedule={"fuse": 1}),
     ValueError, "schedule= tunes"),
    (dict(dims=(16, 16, 32), bdims=(4, 4, 16), exchange="fused"),
     ValueError, "runs on the pencil"),
], ids=["ghost", "schedule", "fused"])
def test_jnp_refusals_match_reference(kw, err, match):
    with pytest.raises(err, match=match) as port:
        Problem(stencil="mpi7pt", backend="jnp", device="cpu", **kw)
    with pytest.raises(err) as ref:
        RefProblem(stencil="mpi7pt", backend="jnp", **kw)
    assert str(port.value) == str(ref.value)


def test_jnp_dtype_other_than_float32_raises():
    with pytest.raises(NotImplementedError, match="remaining pencil_sweep"):
        Problem(stencil="mpi7pt", dims=(16, 16, 32), bdims=(4, 4, 16),
                backend="jnp", dtype=np.float16, device="cpu")
