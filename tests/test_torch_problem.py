"""The port's ``Problem`` (``bricklib_tpu_torch.api``) on the CPU against the
reference ``Problem`` (CPU, Pallas in interpret mode), on the same numpy
inputs.

Each stencil is built by the same builder from each package's own eDSL.
Results are compared on the owned region at abs-or-rel 5e-5, the f32
tolerance of ``core/compare.py`` (float32 sums in another order).  On the
CPU the port runs the plain versions of kernels K6 (rank 2), K1 (rank 3)
and K4 (rank 4); the kernels are held against them on the card in
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


@pytest.mark.parametrize("kw,item", [
    (dict(dims=(16, 16), mesh=(2, 1)), "multi-GPU"),
    (dict(dims=(16, 16, 32), slices=2), "multi-GPU"),
    (dict(dims=(16, 16, 32), exchange="fused"), "kernel-level exchanges"),
    (dict(dims=(16, 16), backend="jnp"), "torch oracle"),
    (dict(dims=(16, 16, 32), backend="mxu"), "the rest"),
    (dict(dims=(16, 16, 32), stencil=_aux3(port_st), field="in"),
     "remaining pencil_sweep features"),
    (dict(dims=(16, 16, 32), stencil=_sys3(port_st), field=("u", "v")),
     "remaining pencil_sweep features"),
    (dict(dims=(16, 16), dtype=np.float16), "remaining pencil_sweep"),
])
def test_unported_options_raise_naming_their_item(kw, item):
    args = dict(stencil=box9(port_st), device="cpu")
    args.update(kw)
    with pytest.raises(NotImplementedError, match=item):
        Problem(**args)


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


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        Problem(dims=(16, 16), stencil=box9(port_st))
