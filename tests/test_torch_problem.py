"""The port's ``Problem`` (``bricklib_tpu_torch.api``) on the CPU against the
reference ``Problem`` (CPU, Pallas in interpret mode), on the same numpy
inputs.

Each stencil is built by the same builder from each package's own eDSL.
Results are compared on the owned region at abs-or-rel 5e-5, the f32
tolerance of ``core/compare.py`` (float32 sums in another order).  On the
CPU the port runs the plain versions of kernels K6 (rank 2), K1 (rank 3),
K4 (rank 4) and K8 (``backend="mxu"``); the kernels are held against them
on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from bricklib_tpu import st as ref_st
from bricklib_tpu.api import Problem as RefProblem
from bricklib_tpu.core import compare_arrays, random_array
from bricklib_tpu_torch import st as port_st
from bricklib_tpu_torch.api import Problem
from bricklib_tpu_torch.codegen.mxu_kernel import pencil_sweep_mxu_kernel
from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_kernel
from bricklib_tpu_torch.codegen.pencil_kernel_2d import pencil_sweep_2d_kernel
from bricklib_tpu_torch.codegen.pencil_kernel_4d import pencil_sweep_4d_kernel

from torch_2d_stencils import box9, varcoeff, wave

TOL = 5e-5
PLAN_KEYS = ("backend", "fuse", "bdims", "exchange", "table_axes", "dims",
             "st_iter", "fields", "aux", "dtype")


def _pair(stencil, **kw):
    """(reference Problem, port Problem); ``stencil`` is a corpus name or a
    builder taking an eDSL package."""
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
        assert compare_arrays(b, a, TOL)


def _launches():
    return (pencil_sweep_kernel.launches, pencil_sweep_2d_kernel.launches,
            pencil_sweep_4d_kernel.launches)


def test_rank2_single_field_auto_fuse_4():
    ref, port = _pair(box9, dims=(128, 16), st_iter=4)
    assert port.backend == ref.backend == "pencil"
    assert port.bdims == ref.bdims == (32, 16)
    assert port.fuse == ref.fuse == 4
    assert port.dec.nbricks == ref.dec.nbricks
    g = random_array((128, 16), np.float32, 3)
    before = _launches()
    ref.init(array=g).step(2)
    port.init(array=g).step(2)
    assert _launches() == before
    _check_same(ref, port)


def test_rank2_aux_field():
    ref, port = _pair(varcoeff, dims=(16, 16), field="in", bdims=(4, 16))
    assert port.aux_names == ref.aux_names == ["c"]
    assert port.fuse == ref.fuse == 1
    g = random_array((16, 16), np.float32, 24)
    c = random_array((16, 16), np.float32, 25)
    ref.init(array=g, aux={"c": c}).step(2)
    port.init(array=g, aux={"c": c}).step(2)
    _check_same(ref, port)


def test_rank2_system():
    ref, port = _pair(wave, dims=(16, 16), field=("p", "v"))
    assert port.fields == ref.fields == ("p", "v")
    init = {"p": random_array((16, 16), np.float32, 5),
            "v": random_array((16, 16), np.float32, 6)}
    ref.init(array=init).step(3)
    port.init(array=init).step(3)
    _check_same(ref, port)
    assert compare_arrays(port.result("v"), ref.result("v"), TOL)


@pytest.mark.parametrize("name,dims,st_iter,fuse", [
    ("s7pt", (16, 16, 32), 4, 4),
    ("mpi9pt", (4, 16, 16, 16), 2, 2),
])
def test_rank3_and_rank4(name, dims, st_iter, fuse):
    ref, port = _pair(name, dims=dims, st_iter=st_iter)
    assert port.fuse == ref.fuse == fuse
    assert port.bdims == ref.bdims
    ref.init(seed=4).step(2)
    port.init(seed=4).step(2)
    _check_same(ref, port)


def test_rollout_is_step_and_save_load_round_trips(tmp_path):
    kw = dict(dims=(32, 16), stencil=box9(port_st), st_iter=2,
              device="cpu")
    p, q = Problem(**kw), Problem(**kw)
    p.init(seed=1).step(3)
    q.init(seed=1).rollout(3)
    assert np.array_equal(p.result(), q.result())
    path = str(tmp_path / "ck")
    p.save(path)
    r = Problem(**kw).load(path)
    assert np.array_equal(r.result(), p.result())
    assert np.array_equal(r.step(1).result(), p.step(1).result())
    with pytest.raises(ValueError, match="checkpoint dims"):
        Problem(**dict(kw, dims=(32, 32))).load(path)
    with pytest.raises(ValueError, match="rollout needs"):
        p.rollout(0)


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    ref, port = _pair(box9, dims=(32, 16), st_iter=2)
    g = random_array((32, 16), np.float32, 8)
    path = str(tmp_path / "ref")
    ref.init(array=g).step(1).save(path)
    port.load(path)
    assert np.array_equal(port.result(), ref.result())
    ref.step(1)
    port.step(1)
    _check_same(ref, port)


@pytest.mark.parametrize("stencil,kw", [
    (box9, dict(dims=(128, 16), st_iter=4)),
    (wave, dict(dims=(16, 16), field=("p", "v"))),
    ("s7pt", dict(dims=(16, 16, 32), st_iter=4)),
    ("mpi9pt", dict(dims=(4, 16, 16, 16), st_iter=2)),
])
def test_describe_agrees_with_the_reference(stencil, kw):
    ref, port = _pair(stencil, **kw)
    a, b = ref.describe(), port.describe()
    for k in PLAN_KEYS:
        assert a[k] == b[k], k
    assert set(a["exchange_axes"]) == set(b["exchange_axes"])
    assert set(b["exchange_axes"].values()) == {"table-periodic"}
    (info,) = b["kernels"]
    assert info["kernel"][:2] in ("K1", "K4", "K6")
    assert info["smem_bytes"] > 0 and all(n > 0 for n in info["taps"])
    assert b["device"] == "cpu"


def test_owned_mask_selects_the_owned_bricks():
    p = Problem(dims=(32, 16), stencil=box9(port_st), device="cpu")
    m = p.owned_mask()
    assert m.shape == (p.dec.nbricks, 1, 1)
    assert int(m.sum()) == 32 // p.bdims[0]


def _aux3(st):
    i, j, k = st.Index(0), st.Index(1), st.Index(2)
    g, c, o = st.Grid("in", 3), st.Grid("c", 3), st.Grid("out", 3)
    o(i, j, k).assign(c(i, j, k) * g(i + 1, j, k))
    return st.load_stencil_module({"STENCIL": [o]})[0]


def _sys3(st):
    i, j, k = st.Index(0), st.Index(1), st.Index(2)
    u, v = st.Grid("u", 3), st.Grid("v", 3)
    ou, ov = st.Grid("ou", 3), st.Grid("ov", 3)
    ou(i, j, k).assign(u(i, j, k) + 0.5 * v(i + 1, j, k))
    ov(i, j, k).assign(v(i, j, k) - 0.5 * u(i, j + 1, k))
    return st.load_stencil_module({"STENCIL": [ou, ov]})


@pytest.mark.parametrize("kw,err,item", [
    # the mesh, slices and fused cases of earlier slices now run (in
    # tests/test_torch_problem_mesh.py); these are the reference's refusals
    # of them
    (dict(dims=(16, 16), mesh=(2, 1), exchange="fused"), ValueError,
     "3-D pencil only"),
    (dict(dims=(16, 16, 32), stencil="s7pt", slices=2, exchange="fused"),
     ValueError, "multi-slice meshes use"),
    (dict(dims=(16, 16, 32), stencil="s7pt", exchange="fused",
          backend="mxu"), ValueError, "uses exchange='shift'"),
    # the torch oracle runs since it was ported: err None runs the case
    # against the reference
    (dict(dims=(16, 32), bdims=(8, 16), backend="jnp"), None, None),
    (dict(dims=(16, 16, 32), stencil="s7pt", backend="mxu", mesh=(2, 1, 1),
          st_iter=9), ValueError, "exceeds ghost depth"),
    (dict(dims=(16, 16, 32), stencil=_aux3(port_st), field="in"),
     NotImplementedError, "remaining pencil_sweep features"),
    (dict(dims=(16, 16, 32), stencil=_sys3(port_st), field=("u", "v")),
     NotImplementedError, "remaining pencil_sweep features"),
    (dict(dims=(16, 16), dtype=np.float16), NotImplementedError,
     "remaining pencil_sweep"),
], ids=["kw0-multi-GPU", "kw1-multi-GPU", "kw2-kernel-level exchanges",
        "kw3-torch oracle", "kw4-multi-GPU",
        "kw5-remaining pencil_sweep features",
        "kw6-remaining pencil_sweep features", "kw7-remaining pencil_sweep"])
def test_unported_options_raise_naming_their_item(kw, err, item):
    """What ``Problem`` refuses: the options of later slices name their
    ROADMAP item; the reference's own refusals raise its error, word for
    word.  A case whose option has been ported since (``err`` None) runs
    and matches the reference."""
    args = dict(stencil=box9(port_st), device="cpu")
    args.update(kw)
    if err is None:
        ref_args = dict(args, stencil=box9(ref_st))
        del ref_args["device"]
        ref, port = RefProblem(**ref_args), Problem(**args)
        x = random_array((16, 32), np.float32, 2)
        ref.init(array=x).step(2)
        port.init(array=x).step(2)
        assert port.describe()["backend"] == "jnp"
        assert compare_arrays(port.result(), ref.result(), TOL)
        return
    with pytest.raises(err, match=item) as port:
        Problem(**args)
    if err is ValueError:
        ref_args = dict(args, stencil=args["stencil"] if isinstance(
            args["stencil"], str) else box9(ref_st))
        del ref_args["device"]
        with pytest.raises(ValueError) as ref:
            RefProblem(**ref_args)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("method,item", [
    ("differentiable_step", "ranks 2/4"),
    ("differentiable_rollout", "ranks 2/4"),
    ("export_step", "the rest"),
])
def test_unported_methods_raise_naming_their_item(method, item):
    p = Problem(dims=(16, 16), stencil=box9(port_st), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        getattr(p, method)()
    q = Problem(dims=(16, 16, 32), stencil="s7pt", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        getattr(q, method)()


def test_bad_arguments_raise_as_the_reference():
    for kw in (dict(dims=(16, 16), mesh=(1, 1, 1, 1)),
               dict(dims=(16, 16), schedule={"tiles": 2}),
               dict(dims=(16, 16), schedule={"fuse": 3}, st_iter=4),
               dict(dims=(16, 16), exchange="put")):
        with pytest.raises(ValueError) as ref:
            RefProblem(stencil=box9(ref_st), **kw)
        with pytest.raises(ValueError) as port:
            Problem(stencil=box9(port_st), device="cpu", **kw)
        assert str(port.value) == str(ref.value)


MXU = dict(dims=(16, 16, 32), stencil="mpi125pt", bdims=(4, 4, 32),
           backend="mxu", st_iter=2)


def test_mxu_backend_matches_the_reference():
    """The case of tests/test_mxu_backend.py:25-32."""
    ref, port = _pair(**MXU)
    g = random_array((16, 16, 32), np.float32, 51)
    before = pencil_sweep_mxu_kernel.launches
    ref.init(array=g).step(1)
    port.init(array=g).step(1)
    assert pencil_sweep_mxu_kernel.launches == before
    assert tuple(port._dats[0].shape) == (port.dec.nbricks, 4, 4 * 32)
    _check_same(ref, port)
    ref.step(1)
    port.step(1)
    _check_same(ref, port)


def test_mxu_describe_agrees_with_the_reference():
    ref, port = _pair(**MXU)
    a, b = ref.describe(), port.describe()
    for k in PLAN_KEYS + ("exchange_axes", "mesh", "eff_mesh"):
        assert a[k] == b[k], k
    assert b["backend"] == "mxu" and b["fuse"] == 1
    assert set(b["exchange_axes"].values()) == {"local ghost copy"}
    (info,) = b["kernels"]
    assert info["kernel"].startswith("K8")
    assert info["w_profiles"] == 6 and info["taps"] == [30]
    # K8's i tile is whole warps of 28 output lanes (32 less the i reach)
    assert info["smem_bytes"] > 0 and info["tile_i"] % 28 == 0


def test_reference_mxu_checkpoint_loads_into_the_port(tmp_path):
    ref, port = _pair(**MXU)
    g = random_array((16, 16, 32), np.float32, 53)
    path = str(tmp_path / "ref_mxu")
    ref.init(array=g).step(1).save(path)
    port.load(path)
    assert tuple(port._dats[0].shape) == tuple(ref._dats[0].shape)
    assert np.array_equal(port.result(), ref.result())
    ref.step(1)
    port.step(1)
    _check_same(ref, port)
    q = Problem(**dict(MXU, device="cpu"))
    port.save(str(tmp_path / "port_mxu"))
    q.load(str(tmp_path / "port_mxu"))
    assert np.array_equal(q.result(), port.result())


def test_mxu_owned_mask_has_storage_rank_3():
    p = Problem(**dict(MXU, device="cpu"))
    m = p.owned_mask()
    assert m.shape == (p.dec.nbricks, 1, 1)
    assert int(m.sum()) == 4 * 4
    p.init(seed=2)
    assert (p._dats[0] * m).shape == p._dats[0].shape


def test_mxu_guards_raise_as_the_reference():
    def two(st):
        i, j, k = st.Index(0), st.Index(1), st.Index(2)
        u, c, o = st.Grid("u", 3), st.Grid("c", 3), st.Grid("out", 3)
        o(i, j, k).assign(c(i, j, k) * u(i + 1, j, k))
        return st.load_stencil_module({"STENCIL": [o]})[0]

    base = dict(dims=(8, 8, 32), backend="mxu", bdims=(4, 4, 32))
    for stencil, kw, exc in (
            (two, dict(field="u"), ValueError),
            ("cond", {}, NotImplementedError),
            ("s7pt", dict(exchange="fused"), ValueError),
            ("s7pt", dict(schedule={"fuse": 1}), ValueError)):
        with pytest.raises(exc) as ref:
            RefProblem(stencil=stencil(ref_st) if callable(stencil)
                       else stencil, **base, **kw)
        with pytest.raises(exc) as port:
            Problem(stencil=stencil(port_st) if callable(stencil)
                    else stencil, device="cpu", **base, **kw)
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="single-input"):
        Problem(stencil=two(port_st), field="u", device="cpu", **base)
    with pytest.raises(NotImplementedError, match="linear"):
        Problem(stencil="cond", device="cpu", **base)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        Problem(dims=(16, 16), stencil=box9(port_st))
