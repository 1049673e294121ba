"""The port's ``Problem`` on a mesh of ranks (``bricklib_tpu_torch.api``), on
the CPU, against the reference ``Problem`` on its 8 virtual CPU devices
(Pallas in interpret mode), on the same numpy inputs.

Every rank of the port's mesh lies on one CPU "card" (``device="cpu"``),
so the kernels' plain versions run: K6 rank by rank (rank 2), K1 and K4
batched over the ranks (ranks 3 and 4), K8 rank by rank
(``backend="mxu"``) and K11 (``exchange="fused"``).  Results are compared
on the owned region at abs-or-rel 5e-5, the f32 tolerance of
``core/compare.py`` (float32 sums in another order).  The kernels are held
against their plain versions on the card in ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from bricklib_tpu import st as ref_st
from bricklib_tpu.api import Problem as RefProblem
from bricklib_tpu.core import compare_arrays, random_array
from bricklib_tpu_torch import st as port_st
from bricklib_tpu_torch.api import Problem
from bricklib_tpu_torch.codegen.fused_exchange import (
    pencil_sweep_fusedx_kernel)
from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_kernel

from torch_2d_stencils import box9

TOL = 5e-5
DESCRIBE_KEYS = ("backend", "fuse", "bdims", "exchange", "table_axes",
                 "dims", "st_iter", "fields", "aux", "dtype", "mesh",
                 "eff_mesh", "slices", "exchange_axes")

CASES = {
    "2d-2x1": (box9, dict(dims=(32, 16), mesh=(2, 1), st_iter=4)),
    "2d-4x1": (box9, dict(dims=(32, 16), mesh=(4, 1), st_iter=2)),
    "3d-shift": ("s7pt", dict(dims=(16, 16, 32), mesh=(2, 2, 1),
                              st_iter=4)),
    "3d-fused-1": ("mpi7pt", dict(dims=(40, 16, 32), mesh=(2, 2, 1),
                                  st_iter=1, exchange="fused")),
    "3d-fused-2": ("mpi7pt", dict(dims=(32, 16, 32), mesh=(2, 2, 1),
                                  st_iter=2, exchange="fused")),
    "4d": ("mpi9pt", dict(dims=(4, 8, 8, 16), bdims=(2, 4, 4, 16),
                          mesh=(2, 1, 2, 1), st_iter=2)),
    "mxu": ("mpi125pt", dict(dims=(16, 16, 32), bdims=(4, 4, 32),
                             mesh=(2, 1, 1), backend="mxu", st_iter=2)),
}


def _pair(stencil, **kw):
    """(reference Problem, port Problem) with every port rank on the CPU."""
    ref_sd, port_sd = ((stencil(ref_st), stencil(port_st)) if callable(stencil)
                       else (stencil, stencil))
    return (RefProblem(stencil=ref_sd, **kw),
            Problem(stencil=port_sd, device="cpu", **kw))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_problem_matches_reference(case):
    stencil, kw = CASES[case]
    ref, port = _pair(stencil, **kw)
    a, b = ref.describe(), port.describe()
    for k in DESCRIBE_KEYS:
        assert a[k] == b[k], k
    assert b["device"] == "cpu"
    gshape = tuple(m * d for m, d in zip(port.eff_mesh, port.dims))
    g = random_array(gshape, np.float32, 3)
    before = (pencil_sweep_kernel.launches,
              pencil_sweep_fusedx_kernel.launches)
    ref.init(array=g).step(2)
    port.init(array=g).step(2)
    assert (pencil_sweep_kernel.launches,
            pencil_sweep_fusedx_kernel.launches) == before
    got = port.result()
    assert got.shape == gshape
    assert compare_arrays(got, np.asarray(ref.result()), TOL)
    # the stacked storage of one card, the reference's layout
    assert tuple(port._dats[0].shape) == tuple(ref._dats[0].shape)


def test_fused_problem_runs_kernel_11_over_a_flat_mesh():
    stencil, kw = CASES["3d-fused-2"]
    _ref, port = _pair(stencil, **kw)
    assert port.mesh.shape == (4,) and port.describe()["exchange"] == "fused"
    assert port.describe()["kernels"][0]["fused_kernel"].startswith("K11")
    shift = Problem(stencil=stencil, device="cpu",
                    **dict(kw, exchange="shift"))
    assert shift.mesh.shape == (2, 2, 1)
    port.init(seed=5).step(2)
    shift.init(seed=5).step(2)
    assert compare_arrays(port.result(), shift.result(), TOL)


def test_slices_are_a_mesh_of_eff_mesh_ranks():
    kw = dict(dims=(16, 16, 32), stencil="s7pt", st_iter=4, device="cpu")
    two = Problem(mesh=(1, 1, 1), slices=2, **kw)
    flat = Problem(mesh=(2, 1, 1), **kw)
    assert two.eff_mesh == flat.eff_mesh == (2, 1, 1)
    assert two.mesh.shape == (2, 1, 1)
    a = two.init(seed=7).step(2).result()
    np.testing.assert_array_equal(a, flat.init(seed=7).step(2).result())
    ref = RefProblem(mesh=(1, 1, 1), slices=2,
                     **{k: v for k, v in kw.items() if k != "device"})
    assert two.describe()["exchange_axes"] == ref.describe()["exchange_axes"]
    assert "slice x ici" in two.describe()["exchange_axes"][0]
    ref.init(seed=7).step(2)
    assert compare_arrays(a, np.asarray(ref.result()), TOL)


@pytest.mark.parametrize("case", ["2d-2x1", "3d-shift", "mxu"])
def test_mesh_checkpoints_move_both_ways(case, tmp_path):
    stencil, kw = CASES[case]
    ref, port = _pair(stencil, **kw)
    gshape = tuple(m * d for m, d in zip(port.eff_mesh, port.dims))
    g = random_array(gshape, np.float32, 8)
    ref.init(array=g).step(1).save(str(tmp_path / "ref"))
    port.load(str(tmp_path / "ref"))
    np.testing.assert_array_equal(port.result(), np.asarray(ref.result()))
    port.step(1).save(str(tmp_path / "port"))
    # the port's checkpoint loads into the reference and into the port
    back = _pair(stencil, **kw)[0].load(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back.result()), port.result())
    again = _pair(stencil, **kw)[1].load(str(tmp_path / "port"))
    np.testing.assert_array_equal(again.result(), port.result())
    ref.step(1)
    assert compare_arrays(port.result(), np.asarray(ref.result()), TOL)
    with pytest.raises(ValueError, match="checkpoint mesh"):
        Problem(stencil=stencil(port_st) if callable(stencil) else stencil,
                device="cpu", **dict(kw, mesh=(1,) * len(kw["mesh"]))
                ).load(str(tmp_path / "port"))


def test_mesh_owned_mask_rollout_and_devices():
    stencil, kw = CASES["3d-shift"]
    ref, port = _pair(stencil, **kw)
    m = port.owned_mask()
    assert m.shape == (4 * port.dec.nbricks, 1, 1, 1)
    np.testing.assert_array_equal(m.numpy(), np.asarray(ref.owned_mask()))
    q = Problem(stencil=stencil, devices=["cpu"] * 4, **kw)
    assert q.device == torch.device("cpu") and len(q.mesh.cards) == 1
    port.init(seed=9).step(3)
    q.init(seed=9).rollout(3)
    np.testing.assert_array_equal(port.result(), q.result())
    with pytest.raises(ValueError, match="4 ranks, got 2 devices"):
        Problem(stencil=stencil, devices=["cpu"] * 2, **kw)


@pytest.mark.parametrize("kw,exc", [
    (dict(dims=(16, 16, 32), stencil="s7pt", mesh=(2, 1, 1), slices=2,
          exchange="fused"), ValueError),
    (dict(dims=(16, 16, 32), stencil="s7pt", mesh=(2, 2, 1), st_iter=9),
     ValueError),
    (dict(dims=(32, 16), mesh=(2, 1), st_iter=9), ValueError),
    (dict(dims=(32, 16), mesh=(2, 1), exchange="fused"), ValueError),
    (dict(dims=(16, 16, 32), stencil="s7pt", mesh=(1, 1, 2),
          backend="pencil"), ValueError),
    (dict(dims=(16, 16, 32), stencil="mpi7pt", mesh=(2, 2, 1),
          exchange="fused", schedule={"fuse": 2}, st_iter=2), ValueError),
], ids=["fused-slices", "deep-3d", "deep-2d", "fused-2d", "mesh-i",
        "fused-fuse"])
def test_mesh_refusals_match_reference(kw, exc):
    kw = dict(kw)
    stencil = kw.pop("stencil", box9)
    with pytest.raises(exc) as want:
        _pair(stencil, **kw)
    with pytest.raises(exc) as got:
        Problem(stencil=stencil(port_st) if callable(stencil) else stencil,
                device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_a_mesh_without_devices_needs_cards():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        Problem(dims=(32, 16), stencil=box9(port_st), mesh=(2, 1))
