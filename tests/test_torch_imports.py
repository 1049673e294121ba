"""The port stands without JAX: it never imports ``jax`` nor anything of the
JAX package ``bricklib_tpu``, a CPU run never launches a kernel, and the
kernel build raises instead of falling back."""

import os
import pathlib
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
from bricklib_tpu_torch.comm.strong import stage_copy
from bricklib_tpu_torch.bench.roofline import copy_storage
from bricklib_tpu_torch.api import Problem
from bricklib_tpu_torch.st import ConstRef, Grid, Index, load_stencil_module

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
assert (pencil_sweep_kernel.launches, pencil_sweep_2d_kernel.launches,
        pencil_sweep_4d_kernel.launches, copy_intervals.launches,
        stage_copy.launches, copy_storage.launches) == (0,) * 6
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
        "brick_copy.cu", "pencil_sweep.cu", "pencil_sweep_2d.cu",
        "pencil_sweep_4d.cu"}


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
