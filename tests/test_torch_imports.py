"""The port stands without JAX: it never imports ``jax`` nor anything of the
JAX package ``bricklib_tpu``, a CPU run never launches a kernel, and the
kernel build raises instead of falling back."""

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from bricklib_tpu_torch import _build
from bricklib_tpu_torch.bench import roofline, timing
from bricklib_tpu_torch.bench.roofline import copy_storage
from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_kernel
from bricklib_tpu_torch.comm.exchange import copy_intervals
from bricklib_tpu_torch.convert import params_from_reference
from bricklib_tpu_torch.core import (from_bricks, random_storage,
                                     require_device, to_bricks)

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "bricklib_tpu_torch"

DRIVE = """
import sys
import bricklib_tpu_torch
from bricklib_tpu_torch.drivers import strong, weak
from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_kernel
from bricklib_tpu_torch.codegen.pencil_kernel_2d import pencil_sweep_2d_kernel
from bricklib_tpu_torch.codegen.pencil_kernel_4d import pencil_sweep_4d_kernel
from bricklib_tpu_torch.comm.exchange import copy_intervals
from bricklib_tpu_torch.comm.exchange import remote_copy
from bricklib_tpu_torch.comm.strong import stage_copy, strong_remote_copy
from bricklib_tpu_torch.bench.roofline import copy_storage
from bricklib_tpu_torch.api import Problem
from bricklib_tpu_torch.codegen.dense_kernel import dense_stencil_kernel
from bricklib_tpu_torch.codegen.mxu_kernel import pencil_sweep_mxu_kernel
from bricklib_tpu_torch.codegen.fused_exchange import (
    pencil_sweep_fusedx, pencil_sweep_fusedx_kernel)
from bricklib_tpu_torch.codegen.pencil_kernel_nd import (
    pencil_sweep_nd, pencil_sweep_nd_kernel)
from bricklib_tpu_torch.ooc import ooc_sweep
from bricklib_tpu_torch.st import ConstRef, Grid, Index, load_stencil_module
from bricklib_tpu_torch.stencils import bench_params
import numpy as np
import torch

res = weak.run(dims=(32, 32, 32), bdim=(8, 8, 32), stencil="s7pt",
               st_iter=8, fuse=4, table_periodic=False, backend="pencil",
               validate=True, iters=1, device="cpu")
assert res["calls"]["step"] > 0
res = weak.run(dims=(8, 8, 8, 16), bdim=(4, 4, 4, 16), stencil="mpi9pt",
               st_iter=4, fuse=2, table_periodic=False, backend="pencil",
               validate=True, iters=1, device="cpu")
assert res["calls"]["step"] > 0
res = strong.run(dom=(32, 32, 32), sdom=(16, 16, 32), bdim=(4, 4, 32),
                 stencil="s7pt", st_iter=4, fuse=2, validate=True, iters=1,
                 device="cpu")
assert res["calls"]["step"] > 0
for ex in ("shift", "put", "shift-remote"):
    res = weak.run(dims=(16, 16, 32), bdim=(8, 8, 32), stencil="s7pt",
                   st_iter=4, fuse=2, table_periodic=False, mesh_shape=(2, 2, 1),
                   exchange=ex, backend="pencil", validate=True, iters=1,
                   device="cpu")
    assert res["ranks"] == 4 and res["cards"] == 1
res = strong.run(dom=(32, 32, 32), sdom=(8, 16, 32), bdim=(4, 4, 32),
                 stencil="s7pt", st_iter=4, fuse=2, mesh_shape=(2, 1, 1),
                 exchange="remote", validate=True, iters=1, device="cpu")
assert res["ranks"] == 2
res = weak.run(dims=(32, 16, 32), bdim=(8, 8, 32), stencil="s7pt",
               st_iter=2, fuse=1, table_periodic=False, mesh_shape=(2, 2, 1),
               exchange="fused", backend="pencil", validate=True, iters=1,
               device="cpu")
assert res["ranks"] == 4
for ex in ("shift", "fused"):
    p = Problem(dims=(32, 16, 32), stencil="mpi7pt", mesh=(2, 2, 1),
                st_iter=2, exchange=ex, device="cpu")
    assert p.init(seed=1).step(1).result().shape == (64, 32, 32)
i, j = Index(0), Index(1)
g, o = Grid("in", 2), Grid("out", 2)
o(i, j).assign(ConstRef("0.6") * g(i, j)
               + ConstRef("0.1") * (g(i + 1, j) + g(i - 1, j)
                                    + g(i, j + 1) + g(i, j - 1)))
box = load_stencil_module({"STENCIL": [o]})[0]
for dims, sd, st_iter in (((128, 16), box, 4), ((16, 16, 32), "s7pt", 4),
                          ((4, 16, 16, 16), "mpi9pt", 2)):
    p = Problem(dims=dims, stencil=sd, st_iter=st_iter, device="cpu")
    assert p.init(seed=1).step(1).result().shape == dims
p = Problem(dims=(16, 16, 32), stencil="mpi125pt", bdims=(4, 4, 32),
            backend="mxu", st_iter=2, device="cpu")
assert p.init(seed=1).step(1).result().shape == (16, 16, 32)
g = np.random.default_rng(0).random((16, 16, 256), dtype=np.float32)
stats = {}
assert ooc_sweep(g, "s7pt", bench_params(), iters=2, slab_rows=6,
                 stats=stats, device="cpu").shape == g.shape
assert stats["slabs"] == 3
# the torch oracle: the weak driver's default backend (with --overlap and
# --f64-validate), the strong driver's on cubic subdomains, Problem at
# rank 5 on a mesh whose i axis is distributed (auto picks it)
res = weak.run(dims=(16, 16, 32), bdim=(4, 4, 16), stencil="s7pt",
               st_iter=4, mesh_shape=(2, 1, 1), overlap=True,
               f64_validate=True, validate=True, iters=1, device="cpu")
assert res["ranks"] == 2
res = strong.run(dom=(32, 32, 32), sdom=(16, 16, 16), bdim=(4, 4, 8),
                 stencil="s7pt", st_iter=2, backend="jnp", validate=True,
                 iters=1, device="cpu")
assert res["calls"]["step"] > 0
idx = [Index(a) for a in range(5)]
g5, o5 = Grid("in", 5), Grid("out", 5)
up = list(idx)
up[0] = idx[0] + 1
o5(*idx).assign(ConstRef("0.5") * g5(*idx) + ConstRef("0.5") * g5(*up))
sd5 = load_stencil_module({"STENCIL": [o5]})[0]
p = Problem(dims=(4, 4, 4, 4, 8), stencil=sd5, bdims=(2, 2, 2, 2, 4),
            mesh=(1, 1, 1, 1, 2), device="cpu")
assert p.backend == "jnp"
assert p.init(seed=1).step(1).result().shape == (4, 4, 4, 4, 16)
fn = pencil_sweep_nd(sd5, np.arange(1, 257, dtype=np.int32).reshape(
    (4,) * 4), (2, 2, 2, 2, 16), 257, {})
x = torch.ones((257, 2, 2, 2, 2, 16))
assert float(fn(x)[fn.plan.written_bricks()].min()) == 1.0
assert (pencil_sweep_kernel.launches, pencil_sweep_2d_kernel.launches,
        pencil_sweep_4d_kernel.launches, copy_intervals.launches,
        stage_copy.launches, copy_storage.launches,
        pencil_sweep_mxu_kernel.launches,
        dense_stencil_kernel.launches, remote_copy.launches,
        strong_remote_copy.launches,
        pencil_sweep_fusedx_kernel.launches,
        pencil_sweep_nd_kernel.launches) == (0,) * 12
jax_mods = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not jax_mods, jax_mods
ref_mods = sorted(m for m in sys.modules
                  if m == "bricklib_tpu" or m.startswith("bricklib_tpu."))
assert not ref_mods, ref_mods
print("NO_JAX_OK")
"""


def test_step_runs_without_importing_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", DRIVE], capture_output=True,
                       text=True, timeout=300, cwd=str(REPO), env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "NO_JAX_OK" in r.stdout


def test_no_source_file_imports_jax():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
    assert len(files) > 10
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")
                        ), f"{f.relative_to(REPO)}: {s}"
            assert not (s.startswith("from bricklib_tpu.")
                        or s.startswith("from bricklib_tpu import")
                        or s == "import bricklib_tpu"
                        or s.startswith("import bricklib_tpu ")
                        or s.startswith("import bricklib_tpu.")
                        ), f"{f.relative_to(REPO)}: {s}"


def test_cpu_paths_launch_no_kernel():
    before = (pencil_sweep_kernel.launches, copy_intervals.launches,
              copy_storage.launches)
    x = torch.arange(4 * 2 * 2 * 4, dtype=torch.float32).reshape(4, 2, 2, 4)
    y = roofline.make_dma_copy(4, (2, 2, 4))(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    copy_intervals(x, [(0, 1, 3, 4)])
    assert torch.equal(x[0], x[3])
    assert (pencil_sweep_kernel.launches, copy_intervals.launches,
            copy_storage.launches) == before


def test_require_device_never_falls_back():
    assert require_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        require_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            require_device("cuda")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert _build.source_digest() == _build.source_digest()
    assert {p.name for p in _build.sources()} == {
        "brick_copy.cu", "dense_stencil.cu", "pencil_sweep.cu",
        "pencil_sweep_2d.cu", "pencil_sweep_4d.cu", "pencil_sweep_mxu.cu",
        "remote_copy.cu", "fused_exchange.cu", "pencil_sweep_nd.cu",
        "pencil_regstream.cu", "pencil_regstream_4d.cu"}
    for name, argtypes in _build.SIGNATURES.items():
        assert name.startswith("bt_") and argtypes[-1] is ctypes.c_void_p


def test_source_digest_covers_the_headers(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert (csrc / "tap_layouts.cuh").exists()
    before = _build.source_digest()
    with open(csrc / "tap_layouts.cuh", "a") as f:
        f.write("\n")
    assert _build.source_digest() != before


def test_tap_table_from_reference_params():
    from bricklib_tpu_torch.stencils import bench_params

    taps = params_from_reference(bench_params(), "s7pt")
    assert taps.offsets.shape == (7, 3) and taps.coeffs.dtype == "float32"
    assert sorted(map(tuple, taps.offsets.tolist())) == sorted(
        [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
         (0, 0, 1), (0, 0, -1)])
    with pytest.raises(ValueError, match="linear"):
        params_from_reference(bench_params(), "cond")


def test_bricks_round_trip_and_random_storage():
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name

    dec = BrickDecomp(dims=(16, 16, 16), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 16)).initialize(skinlist_by_name("good",
                                                                    3))
    a = random_storage(dec, seed=1)
    b = random_storage(dec, seed=1)
    assert a.shape == (dec.nbricks, 4, 4, 16) and torch.equal(a, b)
    dense = torch.rand(24, 24, 16, generator=torch.Generator().manual_seed(0))
    bricks = to_bricks(dense, dec.grid, (4, 4, 16))
    assert torch.equal(from_bricks(bricks, dec.grid, (4, 4, 16)), dense)


def test_mpi_statistics_and_cpu_timing():
    st = timing.mpi_statistics([1.0, 2.0, 3.0])
    assert st["min"] == 1.0 and st["max"] == 3.0 and st["avg"] == 2.0
    assert abs(st["sigma"] - (2 / 3) ** 0.5) < 1e-12
    avg, samples = timing.time_mpi(lambda t: t + 1, torch.zeros(3), iters=3)
    assert avg >= 0 and len(samples) == 3
    t, out = roofline.chain(lambda t: t + 1, torch.zeros(3), 4)
    assert t >= 0 and torch.equal(out, torch.full((3,), 5.0))
    roofline.barrier()
