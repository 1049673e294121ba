#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``bricklib_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. records the toolchain (card name and power limit, torch, CUDA, nvcc,
   whether ``triton`` imports);
2. builds the port's CUDA kernels from ``bricklib_tpu_torch/csrc`` with
   nvcc, one process per source;
3. holds each kernel against its plain PyTorch version on the card:
   K1 (fused pencil sweep, k-streaming blocks) at 32^3 and 512^3 in six
   configurations (the weak step's three s7pt forms; on the periodic table
   s7pt fuse=4 and mpi125pt fuse=1 and fuse=2), batched over the 16
   subdomains of the strong stack and, on i-bricked tables, over the 64
   cubic 128^3 subdomains of upstream's strong study (bricks 8^3, the
   ghost-inclusive sweep over the i ghost ring too, and the owned-only
   one), and where its launch differs most from
   a per-row sweep (both k edges of a non-periodic table at fuse 1 to 4,
   mpi125pt ghost-inclusive at fuse 1 and 2, s27pt through the generic
   body, two brick rows, bricks 96 deep, a batch of 16), K4 (fused 4-D
   sweep, w-streaming blocks) at a tiny and the full 4-D shape in four
   configurations, through its generic body, at both k edges of the
   table with fuse 1 to 3 and batched over three ranks, K6
   (2-D whole-row sweep, y-streaming blocks) at the full 16384^2 storage
   (9-point box at fuse=1, 2 and 4 through its compiled groups, the wave
   system's two fields), on a tiny radius-2 stencil through both edge
   clamps and on small bricks of a taller table at fuse=3, K8
   (flat-pencil sweep, k-streaming blocks) on tiny tables (small bricks,
   both edges, its compiled layout and its generic body) and at 512^3
   (mpi125pt on periodic and ghost-inclusive ranges, mpi25pt through the
   generic body), and against K1 at fuse=1 on the same table, K7 (dense
   padded-array stencil, k-streaming blocks) on small arrays through its
   generic body and its compiled star and on the first (147-row) and the
   last (142-row) slab of the 1024^3 out-of-core pass, all at
   abs-or-rel 1e-5 (FMA contraction and summation order); K2 (exchange
   interval copies, every local stage of an exchange in one launch), K3
   (storage copy), K5 (strong exchange stage, on
   every (stage, sign) of the full strong plan, pencil and cubic: the
   latter's i faces too), K9 and K10 (the
   remote-copy exchanges, on every stage of the full weak mesh plan with
   four ranks and the strong mesh plan with two, on cuda:0, and across
   two cards where the machine has them) bit-exact; K11 (the PUT exchange
   fused into a fuse=1 sweep) at the full weak mesh plan, with ghosts two
   bricks deep and with two i tiles per brick, bit-exact against the PUT
   exchange followed by K1 and against its plain version on the
   exchanged storage, its output at 1e-5 against the plain version (and
   across two cards where the machine has them); K12 (the rank-5+ pencil
   sweep) at 1e-5 against its plain version and at 1e-4 against a dense
   i-wrapped twin: the 5-D 11-point star at (8, 8, 64, 64, 512), 1.89 GB
   of storage, a two-input 5-D stencil with corner taps and a rank-6
   star;
4. drives the port's paths, each validated against a dense twin at 1e-4
   and timed: the honest 512^3 weak step (SHIFT exchange + two fuse=4
   s7pt sweeps, ``drivers.weak``), the 4-D weak step (16x64x128x512,
   mpi9pt, SHIFT exchange + two fuse=2 sweeps, ``drivers.weak``), the
   one-card strong step (512^3 as 16 subdomains of 128x128x512, s7pt,
   strong exchange + two batched fuse=4 sweeps, ``drivers.strong``), the
   same in upstream's cubic form (512^3 in 64 subdomains of 128^3, bricks
   8^3: the six-face strong exchange + two batched fuse=4 sweeps on
   i-bricked tables; the benchmark's cell ``strong-s7pt-512in128``), the
   weak step at 512^3 per rank on mesh (2, 2, 1), four ranks on cuda:0,
   in its three exchange forms (``shift``, ``put``, ``shift-remote`` over
   K9; validated against a ``torch.roll`` twin of the 1024x1024x512
   global domain on the card) and at fuse=1 in ``fused`` (K11 and seven
   K1 sweeps) and ``put`` form, the strong step on mesh (2, 1, 1), two
   ranks on cuda:0, in ``shift`` (K5) and ``remote`` (K10) form, and
   ``api.Problem``: 16384^2 with bench.py's 9-point box (one fuse=4 K6
   sweep per step), the same per rank on mesh (2, 1) with both ranks on
   cuda:0, ``examples/distributed_weak.py``'s problem on mesh (2, 2, 1)
   with the ``shift`` and the ``fused`` exchange (four ranks on cuda:0),
   the wave system of ``examples/wave_2d.py`` at
   16384^2, small 3-D and 4-D problems over K1 and K4, bench.py's
   125-point leg at 512^3 in three forms (``backend="mxu"`` over K8, the
   pencil backend over K1 at fuse=1 and fuse=2), the out-of-core pass
   (``ooc.ooc_sweep``, a host-resident 1024^3 array streamed through K7
   in 7 slabs of 147 rows), the torch oracle (``backend="jnp"``: the
   weak step at 512^3, four ranks of 256^3 on mesh (2, 2, 1) with
   ``--overlap``, the weak CLI's defaults with ``--f64-validate``, the
   strong step in cubic 32^3 subdomains of 256^3, a 5-D ``Problem`` on
   mesh (1, 1, 1, 1, 2) that ``auto`` must send to the oracle), and the
   5-D sweep K12 through its own entry point ``pencil_sweep_nd``;
5. checks from the launch counters, set to 0 just before each path and
   read just after, that each path ran through its kernels (and K1 on
   i-bricked tables, ``k1_ibrick``, only in the cubic strong path, once a
   K1 launch there, each storing every output quad of rows from one row
   offset, ``k1_ibrick_quads``; K4's register-streaming body,
   ``k4_regstream``, only in the 4-D paths, once a K4 launch there; K8
   on its compiled 125-point layout, ``k8_layout``, in ``Problem``'s
   ``backend="mxu"`` 125-point leg, once a K8 launch there);
6. times each kernel beside its plain version, the least time the card
   could take for the same work (bytes over 3.35 TB/s or f32 operations
   over 67 TFLOP/s, the larger) and, where one PyTorch call computes the
   same function, that call (K1 and K8: one ``nn.Conv3d`` with circular
   padding on the dense 512^3 domain; K7: one valid ``F.conv3d`` on the
   padded slab; K2, K5, K9, K10: indexed assignments of the same rows;
   K11 has none, and the composition it replaces is timed beside it; K12
   has none, PyTorch having no 5-D convolution); K1 also at bench.py's k7
   form (s7pt fuse=1 on the periodic table), and K2 against the indexed
   assignments in alternating pairs (median and spread of each).

Any failure exits non-zero.  Without a CUDA card, or outside a checkout of
the repository, it exits non-zero and prints no result.  The line before
the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_BIG = 512
BD_K, BD_J = 8, 8
ST_ITER, FUSE = 8, 4
K1_TOL = 1e-5
# the 4-D weak step: the JAX package's 4-D benchmark shape
# (tools/bench_4d.py:55-57), ST_ITER 4 as two fuse=2 sweeps
DIMS4, BD4, ST4, FUSE4 = (16, 64, 128, 512), (4, 8, 8, 512), 4, 2
DIMS4_TINY, BD4_TINY = (8, 8, 8, 16), (4, 4, 4, 16)
# the strong step: bench.py's strong leg, 512^3 as 16 x (128, 128, 512);
# and upstream's strong study (the benchmark's strong-s7pt-512in128), 512^3
# in 64 cubic 128^3 subdomains of 8^3 bricks, a brick of ghost on every
# axis, K1 on i-bricked tables
SDOM = (N_BIG // 4, N_BIG // 4, N_BIG)
SDOM_CUBIC, BD_CUBIC = (N_BIG // 4,) * 3, (8, 8, 8)
# the 2-D path: bench.py's 2-D leg (bench.py:316-334), 16384^2 as
# whole-row bricks (32, 16384), one fuse=4 sweep per step
N2, BY2, ST2, FUSE2 = 16384, 32, 4, 4
STEPS2, WAVE_STEPS = 25, 3
# the small Problem legs over K1 and K4
DIMS3_P, DIMS4_P = (64, 64, 512), (8, 16, 16, 64)
# bench.py's 125-point leg (bench.py:148-170): 512^3 mpi125pt, pencil
# bricks (8, 8, 512) on the periodic table, st_iter 8
ST125, STEPS125 = 8, 10
# the out-of-core pass: a host-resident 1024^3 s7pt array, the reference's
# default slab_bytes (2 GiB): 7 slabs of 147 rows
N_OOC, OOC_ITERS, OOC_SLABS, OOC_SLAB_BYTES = 1024, 2, 7, 2 * 2 ** 30
OOC_SLAB, OOC_PADS = (149, 1040, 1152), (1, 8, 64)   # the first slab, padded
OOC_LAST = (144, 1040, 1152)                         # the last, shorter one
# the mesh paths: the weak step at 512^3 per rank on mesh (2, 2, 1), four
# ranks on one card (the k and j stages cross ranks), and the strong step
# at 512^3 on mesh (2, 1, 1), two ranks of 8 subdomains on one card
MESH_WEAK, MESH_STRONG = (2, 2, 1), (2, 1, 1)
# Problem on a mesh, ranks on cuda:0: the 16384^2 box per rank on mesh
# (2, 1), and examples/distributed_weak.py:41-54's problem (32x32x128 per
# rank on mesh (2, 2, 1), mpi7pt, st_iter 4) with the SHIFT and the fused
# exchange
MESH_2D, DW_DIMS, DW_ST = (2, 1), (32, 32, 128), 4
# the rank-5+ sweep (K12; pallas_pencil_sweep_nd has no caller in Problem
# or the drivers, so its entry point is the path): a 5-D 11-point star at
# (8, 8, 64, 64, 512) per rank, bricks (2, 2, 8, 8, 512), ghost (2, 2, 8, 8,
# 0), good skin: table (6, 6, 10, 10), 3,601 bricks of 512 KiB (1.89 GB);
# and, smaller, a two-input 5-D stencil with corner taps and a rank-6 star
DIMS5, BD5 = (8, 8, 64, 64, 512), (2, 2, 8, 8, 512)
DIMS5_2IN, BD5_2IN = (4, 4, 16, 16, 256), (2, 2, 8, 8, 256)
DIMS6, BD6 = (4, 4, 4, 8, 8, 128), (2, 2, 2, 4, 4, 128)
K12_TIMED = 20
# K2 against one indexed assignment per stage: alternating pairs
K2_PAIRS = 12
# the torch oracle (backend "jnp", whole-brick ghosts): the weak step at
# bench.py's 512^3 with bricks (8, 8, 128), the same at 256^3 per rank on
# mesh (2, 2, 1) with --overlap, the weak CLI's defaults with
# --f64-validate, the strong step with cubic 32^3 subdomains of 256^3, and
# a 5-D Problem at (16, 16, 16, 16, 256) per rank on mesh (1, 1, 1, 1, 2)
ORACLE_BD, ORACLE_MESH_N, ORACLE_ITERS = (8, 8, 128), 256, 10
STRONG_ORACLE = ((256,) * 3, (32,) * 3, (8, 8, 8))
DIMS5_P, MESH5_P = (16, 16, 16, 16, 256), (1, 1, 1, 1, 2)
# H100 SXM published peaks (NVIDIA's data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores
def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def close(got, want, tol):
    """(abs-or-rel match at ``tol`` everywhere, max abs difference), on the
    card: the rule of the reference's ``compare_arrays``."""
    import torch

    diff = (got - want).abs()
    denom = torch.maximum(got.abs(), want.abs()).clamp_min(1e-300)
    ok = bool(((diff < tol) | (diff / denom < tol)).all())
    return ok, float(diff.max()) if diff.numel() else 0.0


def cuda_ms(fn, iters: int) -> float:
    """Milliseconds per call of ``fn()``, from CUDA events over ``iters``
    calls after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_toolchain() -> str:
    import torch

    card = card_line()
    from bricklib_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        tri = f"triton {triton.__version__} imports"
    except ImportError as e:
        tri = f"triton does not import ({e})"
    print(card)
    print(f"[1 toolchain] card {card}; torch {torch.__version__}; "
          f"torch.version.cuda {torch.version.cuda}; nvcc: {nvcc}; {tri}")
    return card


def phase_build() -> None:
    from bricklib_tpu_torch import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"[2 build] {dt:.1f} s -> {lib.relative_to(HERE)}")
    for line in (lib.parent / "nvcc.log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line:
            print(f"    ptxas: {line.strip()}")


def decomposition(n: int):
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name

    return BrickDecomp(dims=(n, n, n), ghost_depth=(BD_K, BD_J, 0),
                       bdims=(BD_K, BD_J, n)).initialize(
        skinlist_by_name("good", 3))


def sweep_cases(dec):
    """The three K1 configurations: bench.py's k7 form, and the honest
    step's ghost-inclusive and owned-only fused sweeps."""
    GK, GJ = dec.grid.shape[:2]
    return [("fuse=1 periodic skip", dec.periodic_grid((0, 1, 2)),
             (1, GK - 1), (1, GJ - 1), 1),
            ("fuse=4 ghost-inclusive", dec.grid, (0, GK), (0, GJ), FUSE),
            ("fuse=4 skip", dec.grid, (1, GK - 1), (1, GJ - 1), FUSE)]


def make_sweep(dec, grid, kr, jr, fuse):
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

    return pencil_sweep(stencil_by_name("s7pt")[0], grid, dec.bdims,
                        dec.nbricks, bench_params(), k_range=kr,
                        j_range=jr, fuse=fuse)


# K1 over the fully periodic table, owned bricks only: the 3-D Problem's
# s7pt fuse=4 sweep (the K1 record of the kernels line) and the 125-point
# leg's two forms; (times key, name, stencil, fuse)
PERIODIC_K1 = (("K1", "s7pt fuse=4", "s7pt", 4),
               ("K1 125", "mpi125pt fuse=1", "mpi125pt", 1),
               ("K1 125 f2", "mpi125pt fuse=2", "mpi125pt", 2))


def periodic_sweep(dec, stencil: str, fuse: int):
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.stencils import bench_params

    return pencil_sweep(stencil, dec.periodic_grid((0, 1, 2)), dec.bdims,
                        dec.nbricks, bench_params(), fuse=fuse)


def phase_kernels(sizes=(32, N_BIG)) -> dict:
    """Each kernel against its plain version; returns the largest abs
    error seen per kernel."""
    import torch

    from bricklib_tpu_torch.bench.roofline import (copy_storage,
                                                   copy_storage_plain)
    from bricklib_tpu_torch.comm.exchange import (copy_intervals_plain,
                                                  shift_exchange)
    from bricklib_tpu_torch.core import random_storage

    err = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    for n in sizes:
        dec = decomposition(n)
        x = random_storage(dec, seed=5, device="cuda")
        for name, grid, kr, jr, fuse in sweep_cases(dec):
            check_sweep(f"{n}^3 {name}", make_sweep(dec, grid, kr, jr, fuse),
                        x, err, "K1")
        for _key, name, stencil, fuse in PERIODIC_K1:
            check_sweep(f"{n}^3 periodic {name}",
                        periodic_sweep(dec, stencil, fuse), x, err, "K1")
        for table_axes in ((2,), ()):
            ex = shift_exchange(dec, (1, 1, 1), table_axes)
            a, b = x.clone(), x.clone()
            ex(a)
            for ivs in ex.stages:
                copy_intervals_plain(b, ivs)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            moved = sum(d1 - d0 for st in ex.stages for d0, d1, _, _ in st)
            print(f"[3 K2 {n}^3 table_axes={table_axes}] "
                  f"{len(ex.stages)} stages in {len(ex.groups)} launch, "
                  f"{moved} brick rows, "
                  f"{'bit-exact' if same else 'MISMATCH'}")
            if not same:
                fail(f"K2 {n}^3 disagrees with its plain version")
            del a, b
        y = copy_storage(x)
        same = torch.equal(y, copy_storage_plain(x))
        print(f"[3 K3 {n}^3] {x.numel() * 4 / 1e6:.1f} MB, "
              f"{'bit-exact' if same else 'MISMATCH'}")
        if not same:
            fail(f"K3 {n}^3 disagrees with its plain version")
        del x, y
        torch.cuda.empty_cache()
    return err


def decomposition_4d(dims, bd):
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name

    return BrickDecomp(dims=dims, ghost_depth=bd[:3] + (0,),
                       bdims=bd).initialize(skinlist_by_name("good", 4))


def sweep_cases_4d(dec):
    """The four K4 configurations: fuse 1 on the periodic table, and
    ghost-inclusive and owned-only sweeps at fuse 1 and 2."""
    G = dec.grid.shape[:3]
    ghost = dict(w_range=(0, G[0]), k_range=(0, G[1]), j_range=(0, G[2]))
    return [("fuse=1 periodic skip", dec.periodic_grid((0, 1, 2, 3)), {}, 1),
            ("fuse=1 ghost-inclusive", dec.grid, ghost, 1),
            ("fuse=2 ghost-inclusive", dec.grid, ghost, FUSE4),
            ("fuse=2 skip", dec.grid, {}, FUSE4)]


def make_sweep_4d(dec, grid, ranges, fuse):
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import pencil_sweep_4d
    from bricklib_tpu_torch.stencils import bench_params

    return pencil_sweep_4d("mpi9pt", grid, dec.bdims, dec.nbricks,
                           bench_params(), fuse=fuse, **ranges)


def check_sweep(name, fn, x, err, key):
    """One sweep (K1 or K4) against the plain version on the bricks it
    writes; records the largest abs error under ``key``."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain

    got = fn(x)
    want = pencil_sweep_plain(x, torch.from_numpy(fn.plan.table).cuda(),
                              fn.plan)
    torch.cuda.synchronize()
    w = torch.from_numpy(fn.plan.written_bricks()).cuda()
    ok, e = close(got[w], want[w], K1_TOL)
    err[key] = max(err.get(key, 0.0), e)
    print(f"[3 {key} {name}] max abs err {e:.3e} (abs-or-rel {K1_TOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{key} {name} disagrees with its plain version")


def phase_kernels_4d(err: dict) -> None:
    """K4 against its plain version at the tiny and the full 4-D shape,
    through the generic body (a stencil other than the star), the ring
    body's fused star (the star at fuse 2 through ``launch_4d``, and at
    fuse 3, which the register-streaming body does not take), at both k
    edges of the table with fuse 1 to 3, and batched over three ranks at
    the tiny shape."""
    import torch

    from bricklib_tpu_torch.bench.k4_regimes import mixed_radius
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
        k4_launch, launch_4d, pencil_sweep_4d, stream_plan_4d)
    from bricklib_tpu_torch.core import random_storage
    from bricklib_tpu_torch.stencils import bench_params

    def label(fn):
        sp = k4_launch(fn.plan)
        return (f"{sp.body} w{sp.wch} k{sp.pk} j{sp.pj} i{sp.ti} d{sp.d} "
                f"skew{sp.skew} {sp.smem_bytes} B")

    for dims, bd in ((DIMS4_TINY, BD4_TINY), (DIMS4, BD4)):
        dec = decomposition_4d(dims, bd)
        x = random_storage(dec, seed=6, device="cuda")
        G = dec.grid.shape[:3]
        ghost = dict(w_range=(0, G[0]), k_range=(0, G[1]),
                     j_range=(0, G[2]))
        for name, grid, ranges, fuse in sweep_cases_4d(dec):
            fn = make_sweep_4d(dec, grid, ranges, fuse)
            check_sweep(f"{dims} {name} {label(fn)}", fn, x, err, "K4")
        fn = pencil_sweep_4d(mixed_radius(), dec.grid, dec.bdims,
                             dec.nbricks, {}, fuse=FUSE4, **ghost)
        check_sweep(f"{dims} generic taps fuse=2 ghost-inclusive "
                    f"{label(fn)}", fn, x, err, "K4")
        # the ring body's fused star: fuse 2 by its own launch, fuse 3
        fn = make_sweep_4d(dec, dec.grid, ghost, FUSE4)
        table = torch.from_numpy(fn.plan.table).cuda()

        def ring(x, plan=fn.plan, table=table):
            return launch_4d(x, table, plan, None)

        ring.plan = fn.plan
        sp = stream_plan_4d(fn.plan)
        check_sweep(f"{dims} fuse=2 ghost-inclusive ring body w{sp.wch} "
                    f"k{sp.pk} j{sp.pj} i{sp.ti} d{sp.d} skew{sp.skew}",
                    ring, x, err, "K4")
        fn = make_sweep_4d(dec, dec.grid, ghost, 3)
        check_sweep(f"{dims} fuse=3 ghost-inclusive {label(fn)}", fn, x,
                    err, "K4")
        if dims == DIMS4_TINY:
            # the intermediate levels' k clamp at each table edge alone
            for fuse in (1, 2, 3):
                for kr in ((0, 1), (G[1] - 1, G[1])):
                    fn = make_sweep_4d(dec, dec.grid, dict(
                        ghost, k_range=kr), fuse)
                    check_sweep(f"{dims} fuse={fuse} k bricks {kr} "
                                f"{label(fn)}", fn, x, err, "K4")
        del x
        torch.cuda.empty_cache()
    # batched over the ranks of a card, as a 4-D mesh step sweeps them
    dec = decomposition_4d(DIMS4_TINY, BD4_TINY)
    x = rand_cuda((3 * dec.nbricks,) + tuple(dec.bdims), 7)
    G = dec.grid.shape[:3]
    for ranges in ({}, dict(w_range=(0, G[0]), k_range=(0, G[1]),
                            j_range=(0, G[2]))):
        fn = pencil_sweep_4d("mpi9pt", dec.grid, dec.bdims, 3 * dec.nbricks,
                             bench_params(), fuse=FUSE4, batch=3,
                             batch_stride=dec.nbricks, **ranges)
        check_sweep(f"{DIMS4_TINY} batched x3 fuse=2 "
                    f"{'ghost-inclusive' if ranges else 'skip'}", fn, x,
                    err, "K4")


def strong_plan(mesh_shape=(1, 1, 1), cubic: bool = False):
    """The strong step's plan: 16 pencil subdomains, or (``cubic``) 64
    cubic ones with a brick of ghost on every axis."""
    from bricklib_tpu_torch.comm import StrongDecomp, skinlist_by_name

    if cubic:
        sdom, bd, gz = SDOM_CUBIC, BD_CUBIC, BD_CUBIC
    else:
        sdom, bd, gz = SDOM, (BD_K, BD_J, N_BIG), (BD_K, BD_J, 0)
    return StrongDecomp(dom=(N_BIG,) * 3, sdom=sdom, mesh_shape=mesh_shape,
                        bdims=bd, ghost_depth=gz).initialize(
        skinlist_by_name("good", 3))


def strong_sweeps(plan):
    """The strong step's two batched K1 sweeps, fuse=4 over every
    subdomain: ghost-inclusive and owned-only.  Pencil subdomains sweep
    the table periodic in i; cubic ones their own i-bricked table with
    ``i_ghost=1``, the ghost-inclusive sweep over its i ghost ring too, as
    ``drivers.strong`` does."""
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.stencils import bench_params

    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    kw = dict(batch=nsub, batch_stride=nb, fuse=FUSE)
    if plan.ghost_depth[2]:
        grid, form = plan.sdec.grid, "i-bricked "
        owned = dict(i_ghost=1)
        ghost = dict(owned, i_range=(0, grid.shape[2]))
    else:
        grid, form = plan.sdec.periodic_grid((2,)), ""
        owned, ghost = {}, {}
    GK, GJ = grid.shape[:2]
    return [(f"{form}batched x{nsub} fuse=4 ghost-inclusive",
             pencil_sweep("s7pt", grid, plan.bdims, nsub * nb,
                          bench_params(), k_range=(0, GK), j_range=(0, GJ),
                          **ghost, **kw)),
            (f"{form}batched x{nsub} fuse=4 skip",
             pencil_sweep("s7pt", grid, plan.bdims, nsub * nb,
                          bench_params(), **owned, **kw))]


def phase_kernels_strong(err: dict) -> None:
    """Batched K1 at both strong shapes (16 pencil subdomains; 64 cubic
    ones, i-bricked), and K5 bit-exact on every (stage, sign) of each full
    strong plan (the cubic one's i faces too)."""
    import torch

    from bricklib_tpu_torch.comm.strong import (stage_copy,
                                                stage_copy_plain,
                                                strong_stages)
    from bricklib_tpu_torch.core import random_array

    for cubic in (False, True):
        plan = strong_plan(cubic=cubic)
        nb, nsub = plan.sdec.nbricks, plan.nsub_local
        form = "cubic" if cubic else "pencil"
        flat = torch.from_numpy(random_array(
            (nsub * nb,) + tuple(plan.bdims), "float32", 8)).cuda()
        for name, fn in strong_sweeps(plan):
            check_sweep(name, fn, flat, err, "K1")
        a, b = flat.clone(), flat.clone()
        for st in strong_stages(plan):
            gather = torch.from_numpy(st.gather).cuda()
            ra = a.index_select(0, gather) if st.recv_ivs else None
            rb = b.index_select(0, gather) if st.recv_ivs else None
            stage_copy(a, st.local_ivs, ra, st.recv_ivs)
            stage_copy_plain(b, st.local_ivs, rb, st.recv_ivs)
            torch.cuda.synchronize()
            same = torch.equal(a, b)
            rows = sum(d1 - d0
                       for d0, d1, _, _ in st.local_ivs + st.recv_ivs)
            print(f"[3 K5 strong {form} stage axis {st.axis} sign "
                  f"{st.sign:+d}] {len(st.local_ivs)} local + "
                  f"{len(st.recv_ivs)} received intervals, {rows} brick "
                  f"rows, {'bit-exact' if same else 'MISMATCH'}")
            if not same:
                fail(f"K5 {form} axis {st.axis} sign {st.sign} disagrees "
                     "with its plain version")
        if torch.equal(a, flat):
            fail(f"the {form} strong exchange moved nothing")
        del flat, a, b
        torch.cuda.empty_cache()
    err["K5"] = 0.0


def phase_kernels_stream(err: dict) -> None:
    """K1's k-streaming launch where it differs most from the per-row body:
    both k edges of a non-periodic table (the clamp's source planes
    stashed, the low ones by a pre-roll) at F = 1 to 4, mpi125pt (the
    cube's compiled tap layout) at F = 1 and 2, s27pt (the generic body:
    no compiled layout), a k extent of two brick rows, bricks 96 deep in
    k, and a batch of 16 subdomains."""
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.comm import (BrickDecomp, StrongDecomp,
                                         skinlist_by_name)
    from bricklib_tpu_torch.core import random_storage
    from bricklib_tpu_torch.stencils import bench_params

    dec = BrickDecomp(dims=(128, 96, 128), ghost_depth=(4, 4, 0),
                      bdims=(4, 4, 128)).initialize(
        skinlist_by_name("good", 3))
    GK, GJ = dec.grid.shape[:2]
    x = random_storage(dec, seed=25, device="cuda")
    cases = [(f"edges k(0, {GK}) s7pt fuse={f}", "s7pt", dec.grid,
              (0, GK), f) for f in (1, 2, 3, 4)]
    cases += [(f"mpi125pt ghost-inclusive fuse={f}", "mpi125pt", dec.grid,
               (0, GK), f) for f in (1, 2)]
    cases += [("k(3, 5) s7pt fuse=4, two brick rows", "s7pt",
               dec.grid, (3, 5), 4),
              ("s27pt ghost-inclusive fuse=2, generic body", "s27pt",
               dec.grid, (0, GK), 2)]
    for name, stencil, grid, kr, fuse in cases:
        fn = pencil_sweep(stencil, grid, dec.bdims, dec.nbricks,
                          bench_params(), k_range=kr, j_range=(0, GJ),
                          fuse=fuse)
        sp = fn.plan.stream()
        check_sweep(f"{name} (chunk {sp.kch}, {sp.pj} pencils, tile "
                    f"{sp.ti}, k edges {sp.edge_lo, sp.edge_hi})", fn, x, err,
                    "K1")
    del x
    tall = BrickDecomp(dims=(288, 32, 128), ghost_depth=(96, 4, 0),
                       bdims=(96, 4, 128)).initialize(
        skinlist_by_name("good", 3))
    GK, GJ = tall.grid.shape[:2]
    check_sweep("bricks 96 deep, k(0, 5) s7pt fuse=3",
                pencil_sweep("s7pt", tall.grid, tall.bdims, tall.nbricks,
                             bench_params(), k_range=(0, GK),
                             j_range=(0, GJ), fuse=3),
                random_storage(tall, seed=27, device="cuda"), err, "K1")
    plan = StrongDecomp(dom=(256, 256, 128), sdom=(64, 64, 128),
                        mesh_shape=(1, 1, 1), bdims=(8, 8, 128),
                        ghost_depth=(8, 8, 0)).initialize(
        skinlist_by_name("good", 3))
    kg = plan.sdec.periodic_grid((2,))
    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    flat = rand_cuda((nsub * nb,) + tuple(plan.bdims), 26)
    check_sweep(f"batched x{nsub} fuse=4 ghost-inclusive (64, 64, 128)",
                pencil_sweep("s7pt", kg, plan.bdims, nsub * nb,
                             bench_params(), k_range=(0, kg.shape[0]),
                             j_range=(0, kg.shape[1]), batch=nsub,
                             batch_stride=nb, fuse=4), flat, err, "K1")
    del flat


def mesh_exchanges(devices_weak, devices_strong):
    """The remote-copy exchanges of the two mesh paths: K9's over the
    weak mesh and K10's over the strong mesh, each with random state on
    its cards; ``[(key, exchange fn, state, rows per rank)]``."""
    from bricklib_tpu_torch.comm.exchange import shift_remote_exchange
    from bricklib_tpu_torch.comm.mesh import make_domain_mesh
    from bricklib_tpu_torch.comm.strong import strong_remote_exchange

    dec = decomposition(N_BIG)
    wmesh = make_domain_mesh(MESH_WEAK, devices=devices_weak)
    plan = strong_plan(MESH_STRONG)
    smesh = make_domain_mesh(MESH_STRONG, devices=devices_strong)
    nsub, nb = plan.nsub_local, plan.sdec.nbricks

    def state(mesh, rank_shape, seed):
        return [rand_cuda((len(mesh.ranks_on(c)),) + rank_shape, seed + c)
                .to(dev) for c, dev in enumerate(mesh.cards)]

    return [("K9", shift_remote_exchange(dec, wmesh, table_axes=(2,)),
             state(wmesh, (dec.nbricks,) + tuple(dec.bdims), 50),
             dec.nbricks),
            ("K10", strong_remote_exchange(plan, smesh),
             state(smesh, (nsub, nb) + tuple(plan.bdims), 60), nsub * nb)]


def check_remote(key, ex, state, where: str) -> None:
    """Every stage and card of a K9 or K10 plan against the plain version,
    bit-exact after each stage."""
    import torch

    from bricklib_tpu_torch.comm.exchange import (copy_rows_plain, on_card,
                                                  remote_copy)
    from bricklib_tpu_torch.comm.strong import strong_remote_copy

    launch = remote_copy if key == "K9" else strong_remote_copy
    a = [t.clone() for t in state]
    b = [t.clone() for t in state]
    fa = [t.view((-1,) + tuple(t.shape[-3:])) for t in a]
    fb = [t.view((-1,) + tuple(t.shape[-3:])) for t in b]
    for s_, per_card in enumerate(ex.plan):
        for c, rows in enumerate(per_card):
            if rows:
                with on_card(fa[c].device):
                    launch(fa, c, rows)
                copy_rows_plain(fb, rows)
        for t in a:
            torch.cuda.synchronize(t.device)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        nrows = sum(r[-1] for rows in per_card for r in rows)
        remote = sum(r[-1] for rows in per_card for r in rows
                     if r[0] != r[2])
        print(f"[3 {key} {where} stage {s_}] {sum(map(len, per_card))} "
              f"rows in {sum(1 for r in per_card if r)} launch(es), "
              f"{nrows} brick rows ({remote} into another card), "
              f"{'bit-exact' if same else 'MISMATCH'}")
        if not same:
            fail(f"{key} {where} stage {s_} disagrees with its plain version")
    if all(torch.equal(x, y) for x, y in zip(a, state)):
        fail(f"{key} {where}: the exchange moved nothing")


def phase_kernels_mesh(err: dict) -> None:
    """K9 and K10 bit-exact against their plain versions on every stage of
    the full weak plan (four ranks on cuda:0) and strong plan (two ranks
    on cuda:0); where the machine has two cards, the same plans across
    two cards (ranks 0, 1 | 2, 3 and 0 | 1)."""
    import torch

    for key, ex, state, _rows in mesh_exchanges(["cuda:0"] * 4,
                                                ["cuda:0"] * 2):
        check_remote(key, ex, state, "one card")
        err[key] = 0.0
        del state
    torch.cuda.empty_cache()
    if torch.cuda.device_count() < 2:
        print("[3 K9 K10 two cards] skipped: this machine has "
              f"{torch.cuda.device_count()} card; the NVLink leg is "
              "unverified")
        return
    for key, ex, state, _rows in mesh_exchanges(
            ["cuda:0", "cuda:0", "cuda:1", "cuda:1"], ["cuda:0", "cuda:1"]):
        check_remote(key, ex, state, "two cards")
        del state
    torch.cuda.empty_cache()


def fused_case(dims, bd, rings: int, stencil: str, devices, seed: int):
    """Kernel K11 on mesh (2, 2, 1) with the ranks on ``devices``: ``(fused
    fn, PUT exchange, K1 sweeps over a card's ranks by rank count, random
    state, decomposition)``; i goes through the table, as in the weak
    step."""
    from bricklib_tpu_torch.codegen.fused_exchange import pencil_sweep_fusedx
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.comm.exchange import put_exchange, put_plan
    from bricklib_tpu_torch.comm.mesh import make_domain_mesh
    from bricklib_tpu_torch.stencils import bench_params

    dec = BrickDecomp(dims=dims, ghost_depth=(rings * bd[0], rings * bd[1],
                                              0), bdims=bd).initialize(
        skinlist_by_name("good", 3))
    mesh = make_domain_mesh(MESH_WEAK, devices=devices)
    grid = dec.periodic_grid((2,))
    fn = pencil_sweep_fusedx(stencil, grid, bd, dec.nbricks,
                             put_plan(dec, MESH_WEAK, (2,)), MESH_WEAK,
                             bench_params(), mesh=mesh)
    kr, jr = fn.plan.ranges
    nb = dec.nbricks
    sweeps = {p: pencil_sweep(stencil, grid, bd, p * nb, bench_params(),
                              k_range=kr, j_range=jr, batch=p,
                              batch_stride=nb)
              for p in {len(mesh.ranks_on(c)) for c in range(len(mesh.cards))}}
    state = [rand_cuda((len(mesh.ranks_on(c)), nb) + tuple(bd), seed + c)
             .to(d) for c, d in enumerate(mesh.cards)]
    return fn, put_exchange(dec, mesh, (2,)), sweeps, state, dec


def composed(put, sweeps, state):
    """The PUT exchange in place, then K1 over each card's ranks: what K11
    must equal bit for bit."""
    put(state)
    return [sweeps[t.shape[0]](t.view((-1,) + t.shape[2:])).view(t.shape)
            for t in state]


def check_fused(name: str, case, err: dict) -> None:
    """K11 on one case against the PUT exchange followed by K1 (bit-exact,
    output and exchanged storage) and against its plain version (the
    exchanged storage bit-exact, the output at abs-or-rel K1_TOL: the
    plain sweep does not contract to FMAs)."""
    import torch

    from bricklib_tpu_torch.codegen.fused_exchange import (brick_rows,
                                                           fusedx_plain)

    fn, put, sweeps, state, dec = case
    nb = dec.nbricks
    a, b, c = ([t.clone() for t in state] for _ in range(3))
    got, _ = fn(a)
    want = composed(put, sweeps, b)
    flats = [t.view((-1,) + t.shape[2:]) for t in c]
    plain = fusedx_plain(flats, brick_rows(fn.mesh, fn.copies, nb), fn.plan,
                         [torch.from_numpy(fn.plan.table).to(t.device)
                          for t in c], nb)
    for t in a:
        torch.cuda.synchronize(t.device)
    w = torch.from_numpy(fn.plan.written_bricks()).to(a[0].device)
    moved = not all(torch.equal(x, y) for x, y in zip(a, state))
    same = all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(a, b, c))
    same_k1 = all(torch.equal(g[:, w.to(g.device)], q[:, w.to(g.device)])
                  for g, q in zip(got, want))
    e, ok = 0.0, True
    for g, q in zip(got, plain):
        wd = w.to(g.device)
        good, ee = close(g[:, wd], q.view(g.shape)[:, wd], K1_TOL)
        ok &= good
        e = max(e, ee)
    err["K11"] = max(err.get("K11", 0.0), e)
    rows = sum(len(cp.rows) for cp in fn.cards)
    gated = sum(int((cp.items[:, 2] != 0).sum()) for cp in fn.cards)
    sp = fn.cards[0].stream
    print(f"[3 K11 {name}] {rows} copy chunks, "
          f"{sum(len(cp.items) for cp in fn.cards)} stream blocks ({gated} "
          f"gated), K1's footprint {sp.kch} brick rows x {sp.pj} pencils x "
          f"{sp.ti} lanes; storage "
          f"{'bit-exact' if same else 'MISMATCH'} (PUT and plain), output "
          f"{'bit-exact' if same_k1 else 'MISMATCH'} against PUT + K1, max "
          f"abs err {e:.3e} against the plain version (abs-or-rel "
          f"{K1_TOL:g}) {'ok' if ok else 'MISMATCH'}")
    if not (moved and same and same_k1 and ok):
        fail(f"K11 {name} disagrees (moved {moved}, storage {same}, "
             f"against PUT + K1 {same_k1}, against plain {ok})")


def phase_kernels_fused(err: dict) -> None:
    """K11 at the full weak mesh plan (512^3 per rank, bricks (8, 8, 512),
    mesh (2, 2, 1), four ranks on cuda:0, s7pt), a small case with ghosts
    two bricks deep and a small case of two i tiles per brick (the
    13-point star, taps not unrolled); where the machine has two cards,
    the full plan across them."""
    import torch

    small = ((24, 16, 64), (4, 4, 64))
    for name, args in (
            (f"512^3 per rank mesh {MESH_WEAK} s7pt",
             ((N_BIG,) * 3, (BD_K, BD_J, N_BIG), 1, "s7pt")),
            (f"{small[0]} rings 2 s7pt", small + (2, "s7pt")),
            ("(24, 16, 256) two i tiles mpi13pt",
             ((24, 16, 256), (4, 4, 256), 1, "mpi13pt"))):
        check_fused(f"{name}, one card", fused_case(*args, ["cuda:0"] * 4,
                                                    70), err)
        torch.cuda.empty_cache()
    if torch.cuda.device_count() < 2:
        print("[3 K11 two cards] skipped: this machine has "
              f"{torch.cuda.device_count()} card; the NVLink leg is "
              "unverified")
        return
    check_fused("512^3 per rank, two cards", fused_case(
        (N_BIG,) * 3, (BD_K, BD_J, N_BIG), 1, "s7pt",
        ["cuda:0", "cuda:0", "cuda:1", "cuda:1"], 80), err)
    torch.cuda.empty_cache()


def stencil_2d(name: str):
    """A 2-D stencil of ``tests/torch_2d_stencils.py`` in the port's eDSL:
    ``box9`` (bench.py's 2-D stencil, bench.py:318-327), ``wave`` (the
    system of examples/wave_2d.py:48-59) or ``asym9`` (radius 2, asymmetric
    in both axes: it reaches the edge clamps)."""
    tests = str(HERE / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_2d_stencils import BUILDERS

    from bricklib_tpu_torch import st

    return BUILDERS[name](st)


def roll2(a, dy: int, dx: int):
    """``a[y + dy, x + dx]`` on the periodic domain."""
    import torch

    return torch.roll(a, shifts=(-dy, -dx), dims=(0, 1))


def box9_twin(a, n: int):
    """``n`` iterations of the 9-point box on a dense periodic array."""
    for _ in range(n):
        a = (0.4 * a
             + 0.1 * (roll2(a, 0, 1) + roll2(a, 0, -1) + roll2(a, 1, 0)
                      + roll2(a, -1, 0))
             + 0.02 * (roll2(a, 1, 1) + roll2(a, 1, -1) + roll2(a, -1, 1)
                       + roll2(a, -1, -1)))
    return a


def wave_twin(p, v, n: int):
    """``n`` steps of the wave system on dense periodic arrays."""
    for _ in range(n):
        lap = (roll2(p, 0, 1) + roll2(p, 0, -1) + roll2(p, 1, 0)
               + roll2(p, -1, 0) - 4.0 * p)
        p, v = p + v + 0.2 * lap, v + 0.2 * lap
    return p, v


def table_2d(gy: int, periodic: bool):
    """A 1-D row table of ``gy`` bricks, as bench.py builds it
    (bench.py:329-331): with ``periodic`` its two ghost rows point at the
    far owned rows."""
    import numpy as np

    from bricklib_tpu_torch.core import init_grid

    grid, info = init_grid((gy, 1))
    t = np.asarray(grid)[:, 0].copy()
    if periodic:
        t[0], t[-1] = t[-2], t[1]
    return t, info.nbricks


def rand_cuda(shape, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(shape, generator=gen, device="cuda")


def sweeps_2d():
    """K6's configurations: (name, fn, input shape), the first two at the
    2-D path's full storage (bench.py's 9-point box on the periodic
    table), then the wave system there (two fields in, two out), then a
    radius-2 stencil through the clamps of both edges of a non-periodic
    table (ghost-inclusive), the box at fuse=2 over the full storage, and
    small bricks of 4 rows on a taller table at fuse=3 (chunks of several
    brick rows, groups across bricks)."""
    from bricklib_tpu_torch.codegen.pencil_kernel_2d import pencil_sweep_2d

    t, nb = table_2d(N2 // BY2 + 2, True)
    tiny, nbt = table_2d(6, False)
    tall, nbl = table_2d(40, False)
    box9, wave, asym9 = (stencil_2d(n) for n in ("box9", "wave", "asym9"))
    full = (nb, BY2, N2)
    return [
        ("box9 16384^2 fuse=1", pencil_sweep_2d(box9, t, (BY2, N2), nb),
         full),
        ("box9 16384^2 fuse=4", pencil_sweep_2d(box9, t, (BY2, N2), nb,
                                                fuse=FUSE2), full),
        ("wave 16384^2 fuse=1", pencil_sweep_2d(wave, t, (BY2, N2), nb),
         full),
        ("radius-2 6x(8,256) y_range=(0,6) fuse=1",
         pencil_sweep_2d(asym9, tiny, (8, 256), nbt, y_range=(0, 6)),
         (nbt, 8, 256)),
        ("radius-2 6x(8,256) y_range=(0,6) fuse=2",
         pencil_sweep_2d(asym9, tiny, (8, 256), nbt, y_range=(0, 6),
                         fuse=2), (nbt, 8, 256)),
        ("box9 16384^2 fuse=2", pencil_sweep_2d(box9, t, (BY2, N2), nb,
                                                fuse=2), full),
        ("box9 40x(4,96) y_range=(0,40) fuse=3",
         pencil_sweep_2d(box9, tall, (4, 96), nbl, y_range=(0, 40),
                         fuse=3), (nbl, 4, 96)),
    ]


def phase_kernels_2d(err: dict) -> None:
    """K6 against its plain version on every configuration of
    :func:`sweeps_2d`, on the bricks it writes."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
        pencil_sweep_2d_plain)

    for name, fn, shape in sweeps_2d():
        xs = [rand_cuda(shape, 20 + f) for f in range(len(fn.plan.fields))]
        got = fn(*xs)
        got = got if isinstance(got, tuple) else (got,)
        want = pencil_sweep_2d_plain(
            xs, torch.from_numpy(fn.plan.table).cuda(), fn.plan)
        torch.cuda.synchronize()
        w = torch.from_numpy(fn.plan.written_bricks()).cuda()
        sp = fn.plan.stream()
        for o, (g, wv) in enumerate(zip(got, want)):
            ok, e = close(g[w], wv[w], K1_TOL)
            err["K6"] = max(err.get("K6", 0.0), e)
            print(f"[3 K6 {name} output {o}: chunks of {sp.ych} brick rows, "
                  f"{sp.tx} cols, {sp.g}-row groups, {sp.smem_bytes} B] max "
                  f"abs err {e:.3e} (abs-or-rel {K1_TOL:g}) "
                  f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                fail(f"K6 {name} output {o} disagrees with its plain version")
        del xs, got, want
        torch.cuda.empty_cache()


def phase_kernels_mxu(err: dict) -> None:
    """K8 against its plain version on tiny tables of distinct bricks
    (small bricks, both table edges; the compiled layout and the generic
    body, also mpi125pt with a zero coefficient, which takes the generic
    body) and at 512^3 (the 125-point leg's periodic sweep, a
    ghost-inclusive sweep on the exchange table, and mpi25pt periodic
    through the generic body), on the bricks it writes; then against K1 at
    fuse=1 on the periodic table."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.codegen.mxu_kernel import (
        pencil_sweep_mxu, pencil_sweep_mxu_plain)
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.core import init_grid
    from bricklib_tpu_torch.stencils import bench_params

    params = bench_params()
    grid, info = init_grid((5, 4, 1))
    grid = np.asarray(grid)
    cases = []
    for name, bd in (("s7pt", (2, 2, 8)), ("mpi125pt", (4, 4, 8)),
                     ("mpi25pt", (4, 8, 8)), ("mpi125pt", (8, 8, 256)),
                     ("s27pt", (5, 3, 24))):
        for kw in ({}, {"k_range": (0, 5), "j_range": (0, 4)}):
            cases.append((f"{name} {bd} {'ghost' if kw else 'skip'}",
                          pencil_sweep_mxu(name, grid, bd, info.nbricks,
                                           params, **kw), info.nbricks))
    cases.append(("mpi125pt (8, 8, 64) MPI_C9=0 ghost",
                  pencil_sweep_mxu("mpi125pt", grid, (8, 8, 64),
                                   info.nbricks, dict(params, MPI_C9=0.0),
                                   k_range=(0, 5), j_range=(0, 4)),
                  info.nbricks))
    dec = decomposition(N_BIG)
    GK, GJ = dec.grid.shape[:2]
    periodic = pencil_sweep_mxu("mpi125pt", dec.periodic_grid((0, 1, 2)),
                                dec.bdims, dec.nbricks, params)
    cases += [("512^3 mpi125pt periodic skip", periodic, dec.nbricks),
              ("512^3 mpi125pt ghost-inclusive",
               pencil_sweep_mxu("mpi125pt", dec.grid, dec.bdims, dec.nbricks,
                                params, k_range=(0, GK), j_range=(0, GJ)),
               dec.nbricks),
              ("512^3 mpi25pt periodic skip",
               pencil_sweep_mxu("mpi25pt", dec.periodic_grid((0, 1, 2)),
                                dec.bdims, dec.nbricks, params),
               dec.nbricks)]
    for name, fn, nb in cases:
        bk, bj, bi = fn.plan.bdims
        x = rand_cuda((nb, bk, bj * bi), 13)
        got = fn(x)
        want = pencil_sweep_mxu_plain(
            x, torch.from_numpy(fn.plan.table).cuda(), fn.plan)
        torch.cuda.synchronize()
        w = torch.from_numpy(fn.plan.written_bricks()).cuda()
        ok, e = close(got[w], want[w], K1_TOL)
        err["K8"] = max(err.get("K8", 0.0), e)
        sp = fn.plan.stream()
        print(f"[3 K8 {name}, {'layout' if sp.layout else 'generic'} body, "
              f"chunks of {sp.kch} brick rows, {sp.pj} pencils, {sp.ti} "
              f"lanes, {sp.smem_bytes} B] max abs err {e:.3e} (abs-or-rel "
              f"{K1_TOL:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K8 {name} disagrees with its plain version")
        del x, got, want
    x = rand_cuda((dec.nbricks,) + tuple(dec.bdims), 14)
    k1 = pencil_sweep("mpi125pt", periodic.plan.table, dec.bdims,
                      dec.nbricks, params)
    got = periodic(x.view(dec.nbricks, BD_K, -1)).view_as(x)
    want = k1(x)
    torch.cuda.synchronize()
    w = torch.from_numpy(periodic.plan.written_bricks()).cuda()
    ok, e = close(got[w], want[w], K1_TOL)
    print(f"[3 K8 512^3 mpi125pt against K1 fuse=1] max abs err {e:.3e} "
          f"(abs-or-rel {K1_TOL:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("K8 disagrees with K1 at fuse=1 on the same table")
    del x, got, want
    torch.cuda.empty_cache()


def phase_kernels_dense(err: dict) -> None:
    """K7 against its plain version over the whole padded array: small
    arrays through the generic body (radius 2, the 27-point box) and the
    compiled star (a padded row of two i tiles, mpi7pt on a slab of one
    output row), and the first and the last slab of the out-of-core
    pass."""
    import torch

    from bricklib_tpu_torch.codegen.dense_kernel import (dense_stencil,
                                                         dense_stencil_plain)
    from bricklib_tpu_torch.stencils import bench_params

    for name, shape, pad in (("mpi13pt", (24, 32, 128), (4, 8, 48)),
                             ("s27pt", (10, 24, 128), (1, 8, 40)),
                             ("s7pt", (11, 24, 256), (1, 8, 64)),
                             ("mpi7pt", (3, 24, 128), (1, 8, 64)),
                             ("s7pt", OOC_SLAB, OOC_PADS),
                             ("s7pt", OOC_LAST, OOC_PADS)):
        fn = dense_stencil(name, shape, pad, bench_params())
        x = rand_cuda(shape, 15)
        got = fn(x)
        want = dense_stencil_plain([x], fn.plan)
        torch.cuda.synchronize()
        ok, e = close(got, want, K1_TOL)
        err["K7"] = max(err.get("K7", 0.0), e)
        sp = fn.plan.stream()
        print(f"[3 K7 {name} {shape} pad {pad}] body "
              f"{fn.plan.layout() or 'generic'}, blocks of {sp.kch} k x "
              f"{sp.tj} j x {sp.ti} i rows ({sp.nblocks}, {sp.smem_bytes} "
              f"B): max abs err {e:.3e} (abs-or-rel {K1_TOL:g}) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"K7 {name} {shape} disagrees with its plain version")
        del x, got, want
    torch.cuda.empty_cache()


def counters():
    from bricklib_tpu_torch.bench.roofline import copy_storage
    from bricklib_tpu_torch.codegen.dense_kernel import dense_stencil_kernel
    from bricklib_tpu_torch.codegen.fused_exchange import (
        pencil_sweep_fusedx_kernel)
    from bricklib_tpu_torch.codegen.mxu_kernel import pencil_sweep_mxu_kernel
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_kernel
    from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
        pencil_sweep_2d_kernel)
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
        pencil_sweep_4d_kernel)
    from bricklib_tpu_torch.codegen.pencil_kernel_nd import (
        pencil_sweep_nd_kernel)
    from bricklib_tpu_torch.comm.exchange import copy_intervals, remote_copy
    from bricklib_tpu_torch.comm.strong import stage_copy, strong_remote_copy

    return {"K1": pencil_sweep_kernel, "K2": copy_intervals,
            "K3": copy_storage, "K4": pencil_sweep_4d_kernel,
            "K5": stage_copy, "K6": pencil_sweep_2d_kernel,
            "K7": dense_stencil_kernel, "K8": pencil_sweep_mxu_kernel,
            "K9": remote_copy, "K10": strong_remote_copy,
            "K11": pencil_sweep_fusedx_kernel, "K12": pencil_sweep_nd_kernel}


def drive(name: str, run, want_of):
    """Set every launch count to 0, drive one path, read the counts, and
    fail unless each kernel the path runs (``want_of(result)``: kernel ->
    expected launches, each above 0) launched exactly as expected and the
    others not at all, K1 on an i-bricked table (``k1_ibrick``), its
    output quads each stored from one row offset (``k1_ibrick_quads``), K4
    through its register-streaming body (``k4_regstream``) and K8 on its
    compiled 125-point layout (``k8_layout``) as often as expected (each 0
    unless the path gives it)."""
    from bricklib_tpu_torch.codegen.mxu_kernel import pencil_sweep_mxu_kernel
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_kernel
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import \
        launch_regstream_4d

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    pencil_sweep_kernel.ibrick_launches = 0
    pencil_sweep_kernel.quad_launches = 0
    launch_regstream_4d.launches = 0
    pencil_sweep_mxu_kernel.layout_launches = 0
    t0 = time.perf_counter()
    res = run()
    launches = {k: w.launches for k, w in wrappers.items()}
    bodies = {"k1_ibrick": pencil_sweep_kernel.ibrick_launches,
              "k1_ibrick_quads": pencil_sweep_kernel.quad_launches,
              "k4_regstream": launch_regstream_4d.launches,
              "k8_layout": pencil_sweep_mxu_kernel.layout_launches}
    path = want_of(res)
    want = {k: path.get(k, 0) for k in wrappers}
    want_bodies = {k: path.get(k, 0) for k in bodies}
    print(f"[4 {name}] validated in {time.perf_counter() - t0:.1f} s (host "
          f"clock, build to timing); calls {res['calls']}; launches "
          f"{launches}, {bodies}; expected {want}, {want_bodies}")
    for k in wrappers:
        if launches[k] != want[k] or path.get(k) == 0:
            fail(f"{name}: {k} launched {launches[k]} times, expected "
                 f"{want[k]}")
    for k, n in bodies.items():
        if n != want_bodies[k]:
            fail(f"{name}: {k} counted {n} launches, expected "
                 f"{want_bodies[k]}")
    return res, launches


def phase_paths(card: str) -> dict:
    """The port's paths at full size, each through its driver or
    ``Problem``; returns the launches per kernel summed over the runs.  On
    the weak mesh both staged axes cross ranks, so its ``shift`` and
    ``put`` forms move ghosts by ``Tensor.copy_`` alone (K2 none)."""
    from bricklib_tpu_torch.comm.exchange import shift_stages
    from bricklib_tpu_torch.drivers import strong, weak

    # K2 launches once per exchange (its stages are one group of local
    # stages); the i axis goes through the table
    n3, n4 = (local_groups(shift_stages(dec, (1,) * nd, (nd - 1,)))
              for dec, nd in ((decomposition(N_BIG), 3),
                              (decomposition_4d(DIMS4, BD4), 4)))
    paths = [
        ("weak 512^3", lambda: weak.run(
            dims=(N_BIG,) * 3, bdim=(BD_K, BD_J, N_BIG), stencil="s7pt",
            st_iter=ST_ITER, fuse=FUSE, table_periodic=False,
            backend="pencil", validate=True, device="cuda"),
         lambda r: {"K1": (ST_ITER // FUSE) * (r["calls"]["step"]
                                               + r["calls"]["step_noex"]),
                    "K2": n3 * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("weak 4-D", lambda: weak.run(
            dims=DIMS4, bdim=BD4, stencil="mpi9pt", st_iter=ST4,
            fuse=FUSE4, table_periodic=False, backend="pencil",
            validate=True, device="cuda"),
         lambda r: {"K4": (ST4 // FUSE4) * (r["calls"]["step"]
                                            + r["calls"]["step_noex"]),
                    "k4_regstream": (ST4 // FUSE4) * (
                        r["calls"]["step"] + r["calls"]["step_noex"]),
                    "K2": n4 * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("strong 512^3", lambda: strong.run(
            dom=(N_BIG,) * 3, sdom=SDOM, bdim=(BD_K, BD_J, N_BIG),
            stencil="s7pt", st_iter=ST_ITER, fuse=FUSE, validate=True,
            device="cuda"),
         lambda r: {"K1": (ST_ITER // FUSE) * r["calls"]["step"],
                    "K5": r["exchange_steps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        (f"strong 512^3 in cubic {SDOM_CUBIC[0]}^3", lambda: strong.run(
            dom=(N_BIG,) * 3, sdom=SDOM_CUBIC, bdim=BD_CUBIC,
            stencil="s7pt", st_iter=ST_ITER, fuse=FUSE, validate=True,
            backend="pencil", device="cuda"),
         lambda r: {"K1": (ST_ITER // FUSE) * r["calls"]["step"],
                    "k1_ibrick": (ST_ITER // FUSE) * r["calls"]["step"],
                    "k1_ibrick_quads": (ST_ITER // FUSE)
                    * r["calls"]["step"],
                    "K5": r["exchange_steps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
    ] + [
        (f"weak 512^3 per rank, mesh {MESH_WEAK}, 4 ranks on cuda:0, "
         f"{ex}", lambda ex=ex: weak_mesh_path(ex),
         lambda r, ex=ex: {
             "K1": (ST_ITER // FUSE) * (r["calls"]["step"]
                                        + r["calls"]["step_noex"]),
             **({"K9": len(weak_mesh_stages()) * r["calls"]["step"]}
                if ex == "shift-remote" else {}),
             "K3": r["calls"]["copy"]})
        for ex in ("shift", "put", "shift-remote")
    ] + [
        (f"weak 512^3 per rank, mesh {MESH_WEAK}, 4 ranks on cuda:0, "
         "fused fuse=1", lambda: weak_mesh_path("fused", 1),
         lambda r: {"K11": r["calls"]["step"],
                    "K1": (ST_ITER - 1) * r["calls"]["step"]
                    + ST_ITER * r["calls"]["step_noex"],
                    "K3": r["calls"]["copy"]}),
        (f"weak 512^3 per rank, mesh {MESH_WEAK}, 4 ranks on cuda:0, "
         "put fuse=1", lambda: weak_mesh_path("put", 1),
         lambda r: {"K1": ST_ITER * (r["calls"]["step"]
                                     + r["calls"]["step_noex"]),
                    "K3": r["calls"]["copy"]}),
    ] + [
        (f"strong 512^3, mesh {MESH_STRONG}, 2 ranks on cuda:0, {ex}",
         lambda ex=ex: strong.run(
             dom=(N_BIG,) * 3, sdom=SDOM, bdim=(BD_K, BD_J, N_BIG),
             stencil="s7pt", st_iter=ST_ITER, fuse=FUSE, validate=True,
             mesh_shape=MESH_STRONG, exchange=ex,
             devices=["cuda:0"] * 2),
         lambda r, ex=ex: {
             "K1": (ST_ITER // FUSE) * r["calls"]["step"],
             "K5" if ex == "shift" else "K10":
                 r["exchange_launches"] * r["calls"]["step"],
             "K3": r["calls"]["copy"]})
        for ex in ("shift", "remote")
    ] + [
        ("Problem 2-D 16384^2 box9", problem_box9,
         lambda r: {"K6": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 2-D 16384^2 wave system", problem_wave,
         lambda r: {"K6": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 3-D s7pt", lambda: problem_nd(DIMS3_P, "s7pt", 4, 4),
         lambda r: {"K1": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 4-D mpi9pt", lambda: problem_nd(DIMS4_P, "mpi9pt", 2, 2),
         lambda r: {"K4": r["sweeps"] * r["calls"]["step"],
                    "k4_regstream": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 512^3 mpi125pt mxu", lambda: problem_125("mxu", 1),
         lambda r: {"K8": r["sweeps"] * r["calls"]["step"],
                    "k8_layout": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 512^3 mpi125pt pencil fuse=1",
         lambda: problem_125("pencil", 1),
         lambda r: {"K1": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("Problem 512^3 mpi125pt pencil fuse=2",
         lambda: problem_125("pencil", 2),
         lambda r: {"K1": r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        (f"Problem 2-D 16384^2 per rank box9, mesh {MESH_2D}, 2 ranks on "
         "cuda:0", problem_box9_mesh,
         lambda r: {"K6": 2 * r["sweeps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
    ] + [
        (f"Problem distributed_weak {DW_DIMS} per rank, mesh {MESH_WEAK}, "
         f"4 ranks on cuda:0, {ex}", lambda ex=ex: problem_dw(ex),
         lambda r, ex=ex: {"K1": r["sweeps"] * r["calls"]["step"],
                           **({"K11": r["calls"]["step"]}
                              if ex == "fused" else {}),
                           "K3": r["calls"]["copy"]})
        for ex in ("shift", "fused")
    ] + [
        ("out-of-core 1024^3 s7pt", ooc_path,
         lambda r: {"K7": r["calls"]["slab"]}),
    ] + oracle_paths()
    total = dict.fromkeys(counters(), 0)
    for name, run, want_of in paths:
        res, launches = drive(name, run, want_of)
        (report_ooc if "ooc" in res else report_nd if "sweep_ms" in res
         else report)(card, name, res)
        for k in total:
            total[k] += launches[k]
    return total


def weak_mesh_stages():
    """The SHIFT stages of the weak mesh step (k and j; i goes through the
    table): K9 launches once per stage and card."""
    from bricklib_tpu_torch.comm.exchange import shift_stages

    return shift_stages(decomposition(N_BIG), MESH_WEAK, (2,))


def weak_mesh_path(exchange: str, fuse: int = FUSE) -> dict:
    """The weak step at 512^3 per rank on mesh (2, 2, 1), four ranks on
    cuda:0, through ``drivers.weak.run``, validated by
    :func:`roll_validate`."""
    from bricklib_tpu_torch.drivers import weak

    return weak.run(dims=(N_BIG,) * 3, bdim=(BD_K, BD_J, N_BIG),
                    stencil="s7pt", st_iter=ST_ITER, fuse=fuse,
                    table_periodic=False, backend="pencil",
                    mesh_shape=MESH_WEAK, exchange=exchange,
                    devices=["cuda:0"] * 4,
                    validate=roll_validate("s7pt", ST_ITER))


def roll_validate(stencil: str, st_iter: int):
    """A validation function for ``weak.run``: one step against a
    ``torch.roll`` twin of the global periodic domain on the card, each
    rank's owned block at abs-or-rel 1e-4 (the ghost depth covers
    ``st_iter`` radius-1 iterations, so the whole owned block is exact)."""

    def check(s) -> bool:
        import torch

        from bricklib_tpu_torch.comm.mesh import rank_views
        from bricklib_tpu_torch.core.setup import from_bricks
        from bricklib_tpu_torch.drivers import weak
        from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

        out = rank_views(s.mesh, s.step(weak.clone_state(s.state)))
        g = torch.from_numpy(s.g).cuda()
        twin = roll_twin(g, stencil_by_name(stencil)[0], bench_params(),
                         st_iter)
        del g
        dims, grid = s.dec.dims, s.dec.interior_grid()
        ok = bool(torch.isfinite(twin).all())
        for r, v in enumerate(out):
            c = s.mesh.coords_of(r)
            got = from_bricks(v.reshape(s.dec.nbricks, -1), grid, s.bdim)
            want = twin[tuple(slice(c[a] * d, (c[a] + 1) * d)
                              for a, d in enumerate(dims))]
            good, e = close(got, want, 1e-4)
            print(f"[4 weak rank {r} {c}] against the global roll twin: "
                  f"max abs err {e:.3e} (abs-or-rel 1e-4) "
                  f"{'ok' if good else 'MISMATCH'}")
            ok &= good
            del got
        del out, twin
        torch.cuda.empty_cache()
        return ok

    return check


def run_problem(p, init: dict, twin: dict, n_valid: int, n_timed: int):
    """Drive one ``Problem``: ``init``, ``n_valid`` steps held against
    ``twin`` (field -> the dense result on the card) at abs-or-rel 1e-4 on
    the owned region, a warm-up step and ``n_timed`` steps timed with CUDA
    events, then the copy speed of light of its state (K3, every field).
    Returns what :func:`report` prints and the calls made."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.bench.roofline import chain, copy_storage

    p.init(**init).step(n_valid)
    got = p.result()
    got = got if isinstance(got, dict) else {p.fields[0]: got}
    for f, want in twin.items():
        ok, e = close(torch.from_numpy(got[f]).cuda(), want, 1e-4)
        print(f"[4 Problem {p.dims} mesh {p.eff_mesh} field {f}] {n_valid} "
              f"step(s) against "
              f"the dense twin: max abs err {e:.3e} (abs-or-rel 1e-4) "
              f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"Problem {p.dims} field {f} disagrees with its dense twin")
        if not bool(torch.isfinite(want).all()):
            fail(f"Problem {p.dims} field {f}: the twin is not finite")
    del got
    p.step(1)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p.step(n_timed)
    end.record()
    end.synchronize()
    t_step = start.elapsed_time(end) / 1e3 / n_timed
    t_copy, _ = chain(lambda _x: [copy_storage(d) for d in p._dats][0],
                      p._dats[0], n_timed)
    nbytes = sum(d.numel() * d.element_size() for d in p._dats)
    elems = int(np.prod(p.dims)) * int(np.prod(p.eff_mesh))
    desc = p.describe()
    print(f"[4 Problem {p.dims}] describe: backend {desc['backend']}, "
          f"bdims {desc['bdims']}, fuse {desc['fuse']}, exchange "
          f"{desc['exchange']}, kernels {desc['kernels']}")
    return {"step": t_step, "gstencil_s": elems * p.st_iter / t_step / 1e9,
            "copy": t_copy, "copy_gbs": 2 * nbytes / t_copy / 1e9,
            "vs_copy_sol": p.st_iter * t_copy / t_step,
            # the fused exchange's kernel (K11) is the first sweep
            "sweeps": (p.st_iter - (desc["exchange"] == "fused")) // p.fuse,
            "calls": {"step": n_valid + 1 + n_timed,
                      "copy": len(p._dats) * (n_timed + 1)}}


def problem_box9():
    """The 2-D path: ``Problem`` at 16384^2 with bench.py's 9-point box,
    which must resolve to the pencil backend, bricks (32, 16384), fuse 4."""
    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=(N2, N2), stencil=stencil_2d("box9"), st_iter=ST2)
    if (p.backend, p.bdims, p.fuse) != ("pencil", (BY2, N2), FUSE2):
        fail(f"Problem 2-D resolved to {p.backend} {p.bdims} fuse {p.fuse}")
    g = rand_cuda((N2, N2), 31)
    twin = {"in": box9_twin(g, ST2)}
    return run_problem(p, {"array": g.cpu().numpy()}, twin, 1, STEPS2)


def problem_box9_mesh():
    """The 2-D path on a mesh: ``Problem`` at 16384^2 per rank with the
    9-point box on mesh (2, 1), both ranks on cuda:0 (one SHIFT exchange
    along y, then one fuse=4 K6 sweep per rank and step), one step held
    against the dense twin of the 32768 x 16384 global domain."""
    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=(N2, N2), stencil=stencil_2d("box9"), st_iter=ST2,
                mesh=MESH_2D, devices=["cuda:0"] * 2)
    if (p.backend, p.bdims, p.fuse) != ("pencil", (BY2, N2), FUSE2):
        fail(f"Problem 2-D mesh resolved to {p.backend} {p.bdims} fuse "
             f"{p.fuse}")
    g = rand_cuda((MESH_2D[0] * N2, N2), 36)
    twin = {"in": box9_twin(g, ST2)}
    return run_problem(p, {"array": g.cpu().numpy()}, twin, 1, STEPS2)


def problem_dw(exchange: str):
    """``examples/distributed_weak.py:41-54``'s problem as written (mpi7pt,
    32x32x128 per rank on mesh (2, 2, 1), bricks (8, 8, 128), st_iter 4,
    its seeded field), four ranks on cuda:0, with ``exchange``; one step
    held against a ``torch.roll`` twin of the global domain."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=DW_DIMS, mesh=MESH_WEAK, stencil="mpi7pt",
                bdims=(8, 8, DW_DIMS[2]), backend="pencil", st_iter=DW_ST,
                exchange=exchange, devices=["cuda:0"] * 4)
    if p.describe()["exchange"] != exchange:
        fail(f"distributed_weak resolved to {p.describe()['exchange']}")
    gshape = tuple(m * d for m, d in zip(MESH_WEAK, DW_DIMS))
    field = np.random.default_rng(1).random(gshape, dtype=np.float32)
    twin = {p.gname: roll_twin(torch.from_numpy(field).cuda(), p.sdef,
                               p.params, DW_ST)}
    return run_problem(p, {"array": field}, twin, 1, 25)


def problem_wave():
    """The wave system through ``Problem`` at 16384^2 (fuse 1, systems
    take no fusion), ``WAVE_STEPS`` validated steps."""
    from bricklib_tpu_torch.api import Problem

    p = Problem(dims=(N2, N2), stencil=stencil_2d("wave"), field=("p", "v"))
    pv = {"p": rand_cuda((N2, N2), 32), "v": rand_cuda((N2, N2), 33)}
    tp, tv = wave_twin(pv["p"], pv["v"], WAVE_STEPS)
    init = {"array": {k: a.cpu().numpy() for k, a in pv.items()}}
    del pv
    return run_problem(p, init, {"p": tp, "v": tv}, WAVE_STEPS, 10)


def problem_nd(dims, name: str, st_iter: int, fuse: int):
    """A small ``Problem`` over K1 (3-D) or K4 (4-D), validated against
    the port's dense numpy twin (``dense_apply`` on wrap-padded
    arrays)."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.api import Problem
    from bricklib_tpu_torch.codegen.jnp_backend import dense_apply
    from bricklib_tpu_torch.core import random_array
    from bricklib_tpu_torch.stencils import stencil_by_name

    p = Problem(dims=dims, stencil=name, st_iter=st_iter)
    if (p.backend, p.fuse) != ("pencil", fuse):
        fail(f"Problem {dims} resolved to {p.backend} fuse {p.fuse}")
    sd = stencil_by_name(name)[0]
    g = random_array(dims, np.float32, 12)
    lo, hi = sd.radius()
    want = g
    for _ in range(st_iter):
        padded = np.pad(want, list(zip(lo, hi)), mode="wrap")
        want = dense_apply(sd, {p.gname: padded}, p.params, xp=np)
    return run_problem(p, {"array": g}, {p.gname: torch.from_numpy(
        np.ascontiguousarray(want, np.float32)).cuda()}, 1, 25)


def problem_125(backend: str, fuse: int):
    """bench.py's 125-point leg: ``Problem`` at 512^3 with mpi125pt,
    ``st_iter`` 8, through K8 (``backend="mxu"``, which must resolve to
    fuse 1) or K1 (the pencil backend at ``fuse``), one step validated
    against a dense ``torch.roll`` twin on the card."""
    from bricklib_tpu_torch.api import Problem

    kw = ({} if backend == "mxu"
          else {"schedule": {"fuse": fuse}})
    p = Problem(dims=(N_BIG,) * 3, stencil="mpi125pt", st_iter=ST125,
                backend=backend, **kw)
    desc = p.describe()
    if (desc["backend"], p.fuse, p.bdims) != (backend, fuse,
                                              (BD_K, BD_J, N_BIG)):
        fail(f"Problem 125pt resolved to {desc['backend']} fuse {p.fuse} "
             f"bricks {p.bdims}")
    g = rand_cuda((N_BIG,) * 3, 34)
    twin = {p.gname: roll_twin(g, p.sdef, p.params, ST125)}
    return run_problem(p, {"array": g.cpu().numpy()}, twin, 1, STEPS125)


def roll_twin(a, sdef, params, n: int):
    """``n`` iterations of a linear stencil on a dense periodic array of
    any rank on the card: one ``torch.roll`` per folded tap."""
    import torch

    from bricklib_tpu_torch.codegen.taps import params_from_reference

    taps = params_from_reference(params, sdef)
    axes = tuple(range(a.dim()))
    for _ in range(n):
        acc = torch.zeros_like(a)
        for offs, c in zip(taps.offsets.tolist(), taps.coeffs.tolist()):
            acc.add_(torch.roll(a, shifts=tuple(-o for o in offs),
                                dims=axes), alpha=c)
        a = acc
    return a


def ooc_path():
    """The out-of-core pass: ``ooc_sweep`` on a host-resident 1024^3 s7pt
    array with the default slab budget, ``OOC_ITERS`` passes validated
    against a ``torch.roll`` twin of the whole array on the card, then one
    pass timed on the host clock, with the copy each way of one slab timed
    by CUDA events."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.ooc import ooc_sweep
    from bricklib_tpu_torch.stencils import bench_params, stencil_by_name

    sd = stencil_by_name("s7pt")[0]
    params = bench_params()
    g = rand_cuda((N_OOC,) * 3, 35)
    host = g.cpu().numpy()
    want = roll_twin(g, sd, params, OOC_ITERS)
    del g
    stats = {}
    got = ooc_sweep(host, sd, params, iters=OOC_ITERS,
                    slab_bytes=OOC_SLAB_BYTES, stats=stats)
    ok, e = close(torch.from_numpy(got).cuda(), want, 1e-4)
    print(f"[4 out-of-core {N_OOC}^3] {OOC_ITERS} passes of {stats['slabs']} "
          f"slabs against the dense twin: max abs err {e:.3e} (abs-or-rel "
          f"1e-4) {'ok' if ok else 'MISMATCH'}")
    if not ok or not bool(torch.isfinite(want).all()):
        fail("the out-of-core pass disagrees with its dense twin")
    if stats["slabs"] != OOC_SLABS:
        fail(f"the out-of-core pass took {stats['slabs']} slabs, not "
             f"{OOC_SLABS}")
    del got, want
    torch.cuda.empty_cache()
    timed = {}
    ooc_sweep(host, sd, params, slab_bytes=OOC_SLAB_BYTES, stats=timed)
    # one slab's copy each way, pinned memory, CUDA events
    pin = torch.empty(OOC_SLAB, pin_memory=True)
    dev = torch.empty(OOC_SLAB, device="cuda")
    h2d = cuda_ms(lambda: dev.copy_(pin, non_blocking=True), 3)
    d2h = cuda_ms(lambda: pin.copy_(dev, non_blocking=True), 3)
    nbytes = pin.numel() * 4
    del pin, dev
    slabs = stats["slabs"]
    return {"ooc": True, "slabs": slabs, "wall": timed["wall_s"],
            "pad": timed["pad_s"], "wait": timed["wait_s"],
            "copy_out": timed["copy_out_s"],
            "h2d_bytes": timed["h2d_bytes"], "d2h_bytes": timed["d2h_bytes"],
            "h2d_ms": h2d, "d2h_ms": d2h, "link_bytes": nbytes,
            "gstencil_s": float(np.prod(host.shape)) / timed["wall_s"] / 1e9,
            "calls": {"slab": slabs * (OOC_ITERS + 1)}}


def report_ooc(card: str, name: str, res: dict) -> None:
    print(f"[5 {name} pass] {card}: {res['wall']:.3f} s/pass, "
          f"{res['gstencil_s']:.3f} GStencil/s, {res['slabs']} slabs; host "
          f"padding {res['pad']:.3f} s, blocked on the card "
          f"{res['wait']:.3f} s, copying results out {res['copy_out']:.3f} s")
    for way, key in (("to the device", "h2d"), ("back", "d2h")):
        print(f"[5 {name} {key}] {card}: {res[key + '_bytes']} bytes "
              f"{way} per pass, {res[key + '_bytes'] / res['wall'] / 1e9:.3f}"
              f" GB/s over the pass; one slab ({res['link_bytes']} bytes, "
              f"pinned) {res[key + '_ms']:.3f} ms = "
              f"{res['link_bytes'] / res[key + '_ms'] / 1e6:.3f} GB/s")


def report(card: str, name: str, res: dict) -> None:
    extra = (f", exchange share {res['exchange'] / res['step'] * 100:.1f}%"
             if "exchange" in res else "")
    if "sweeps" in res:
        extra += (f", {res['step'] * 1e3 / res['sweeps']:.3f} ms per sweep "
                  f"({res['sweeps']} per step)")
    print(f"[5 {name} step] {card}: {res['step'] * 1e3:.3f} ms/step, "
          f"{res['gstencil_s']:.3f} GStencil/s{extra}")
    print(f"[5 {name} copy] {card}: K3 copy {res['copy'] * 1e3:.3f} ms, "
          f"{res['copy_gbs']:.1f} GB/s; step at {res['vs_copy_sol']:.4f} "
          f"of the copy speed of light per iteration")


def row(ms, plain_ms, nbytes, flops, library_ms) -> dict:
    from bricklib_tpu_torch.bench.roofline import bound

    b_ms, b_by = bound(nbytes, flops)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def phase_times(card: str) -> dict:
    """Per kernel: its ms beside its plain version's, its bound and, where
    one PyTorch call computes the same function, that call's ms; at the
    paths' shapes: K1 and K2 summed over the launches of one 512^3 step
    (two sweeps, two exchange stages; K2 in alternating pairs with the
    indexed assignments), K1 at fuse=1 on the periodic table apart, K3 per
    whole-storage copy."""
    import torch

    from bricklib_tpu_torch.bench.roofline import (copy_storage,
                                                   copy_storage_plain)
    from bricklib_tpu_torch.comm.exchange import (copy_intervals_plain,
                                                  shift_exchange)
    from bricklib_tpu_torch.core import random_storage

    dec = decomposition(N_BIG)
    x = random_storage(dec, seed=9, device="cuda")
    k7, *weak_cases = [(name, make_sweep(dec, grid, kr, jr, fuse))
                       for name, grid, kr, jr, fuse in sweep_cases(dec)]
    weak = time_sweeps(card, "K1", weak_cases, x)
    print_times(card, "K1", "weak 512^3 step, both sweeps", weak)
    # bench.py's k7 leg: one fuse=1 sweep on the periodic table
    out = {"K1 f1": time_sweeps(card, "K1", [k7], x)}
    ex = shift_exchange(dec, (1, 1, 1), (2,))
    ex(x)
    brick = x[0].numel() * x.element_size()

    def plain_ex():
        for ivs in ex.stages:
            copy_intervals_plain(x, ivs)

    lib = [(interval_rows(ivs, 0), interval_rows(ivs, 2))
           for ivs in ex.stages]

    def lib_ex():
        for d, s in lib:
            x[d] = x[s]

    moved = sum(d1 - d0 for ivs in ex.stages for d0, d1, _, _ in ivs)
    k2, lib2 = k2_pairs(card, lambda: ex(x), lib_ex)
    out["K2"] = row(k2, cuda_ms(plain_ex, 50), 2 * moved * brick, 0, lib2)
    y = torch.empty_like(x)
    out["K3"] = row(cuda_ms(lambda: copy_storage(x), 50),
                    cuda_ms(lambda: copy_storage_plain(x), 50),
                    2 * x.numel() * x.element_size(), 0,
                    cuda_ms(lambda: y.copy_(x), 50))
    for k in ("K2", "K3"):
        print_times(card, k, "", out[k])
    del x, y
    torch.cuda.empty_cache()
    out.update(phase_times_4d(card))
    out.update(phase_times_strong(card))
    out.update(phase_times_2d(card))
    out.update(phase_times_3d(card))
    out.update(phase_times_dense(card))
    out.update(phase_times_mesh(card))
    out.update(phase_times_nd(card))
    return out


def k2_pairs(card: str, kernel, library, pairs: int = K2_PAIRS):
    """K2 (``kernel``: one exchange) and one indexed assignment per stage
    (``library``) in ``pairs`` alternating pairs (kernel first in even
    pairs, library first in odd ones), 50 calls each; prints the median
    and spread (max - min) of each; returns the two medians."""
    import statistics

    ts = {"K2": [], "library": []}
    for p in range(pairs):
        order = ("K2", "library") if p % 2 == 0 else ("library", "K2")
        for who in order:
            ts[who].append(cuda_ms(kernel if who == "K2" else library, 50))
    med = {k: statistics.median(v) for k, v in ts.items()}
    spread = {k: max(v) - min(v) for k, v in ts.items()}
    print(f"[5 K2 pairs] {card}: {pairs} alternating pairs, K2 median "
          f"{med['K2']:.4f} ms (spread {spread['K2']:.4f}), one indexed "
          f"assignment per stage median {med['library']:.4f} ms (spread "
          f"{spread['library']:.4f}); K2 "
          f"{'slower' if med['K2'] > med['library'] else 'faster'} by "
          f"{abs(med['K2'] - med['library']):.4f} ms")
    return med["K2"], med["library"]


def interval_rows(ivs, k: int):
    """The rows ``[iv[k], iv[k + 1])`` of every copy interval, as one
    index tensor on the card: ``k`` 0 for destinations, 2 for sources."""
    import torch

    return torch.tensor([r for iv in ivs
                         for r in range(iv[k], iv[k + 1])]).cuda()


def print_times(card: str, key: str, name: str, r: dict) -> None:
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.3f} ms")
    print(f"[5 {key}{' ' + name if name else ''}] {card}: kernel "
          f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.3f} ms ({r['bound_by']}), library call {lib}")


def time_sweeps(card: str, key: str, cases, x) -> dict:
    """:func:`row` of sweeps (K1 or K4) summed over ``cases``; no single
    PyTorch call computes a fused sweep over brick storage."""
    from bricklib_tpu_torch.bench.roofline import sweep_work

    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain

    tot = [0.0, 0.0, 0, 0]
    for name, fn in cases:
        table = torch.from_numpy(fn.plan.table).cuda()
        nbytes, flops = sweep_work(fn.plan)
        r = row(cuda_ms(lambda: fn(x), 20),
                cuda_ms(lambda: pencil_sweep_plain(x, table, fn.plan), 3),
                nbytes, flops, None)
        print_times(card, key, name, r)
        tot = [tot[0] + r["ms"], tot[1] + r["plain_ms"], tot[2] + nbytes,
               tot[3] + flops]
    return row(*tot, None)


def phase_times_4d(card: str) -> dict:
    """K4 summed over the 4-D step's two sweeps."""
    import torch

    from bricklib_tpu_torch.core import random_storage

    dec = decomposition_4d(DIMS4, BD4)
    x = random_storage(dec, seed=10, device="cuda")
    cases = [(name, make_sweep_4d(dec, grid, ranges, fuse))
             for name, grid, ranges, fuse in sweep_cases_4d(dec)[2:]]
    out = {"K4": time_sweeps(card, "K4", cases, x)}
    del x
    torch.cuda.empty_cache()
    return out


def phase_times_strong(card: str) -> dict:
    """Batched K1 over the strong step's two sweeps, and K5 summed over
    the launches of one strong exchange (receive buffers gathered
    beforehand); K5's library call is an indexed assignment of the same
    rows per (stage, sign) and source (storage, receive buffer)."""
    import torch

    from bricklib_tpu_torch.comm.strong import (stage_copy,
                                                stage_copy_plain,
                                                stage_table, strong_stages)
    from bricklib_tpu_torch.core import random_array

    plan = strong_plan()
    nb, nsub = plan.sdec.nbricks, plan.nsub_local
    flat = torch.from_numpy(random_array(
        (nsub * nb,) + tuple(plan.bdims), "float32", 11)).cuda()
    out = {"K1 batched": time_sweeps(card, "K1", strong_sweeps(plan), flat)}
    steps, lib, nrows = [], [], 0
    for st in strong_stages(plan):
        recv = (flat.index_select(0, torch.from_numpy(st.gather).cuda())
                if st.recv_ivs else None)
        steps.append((st, recv, stage_table(st.local_ivs, st.recv_ivs,
                                            flat)))
        for ivs, src in ((st.local_ivs, flat), (st.recv_ivs, recv)):
            if ivs:
                lib.append((interval_rows(ivs, 0), src,
                            interval_rows(ivs, 2)))
                nrows += sum(d1 - d0 for d0, d1, _, _ in ivs)

    def kernel():
        for st, recv, table in steps:
            stage_copy(flat, st.local_ivs, recv, st.recv_ivs, table)

    def plain():
        for st, recv, _table in steps:
            stage_copy_plain(flat, st.local_ivs, recv, st.recv_ivs)

    def library():
        for d, src, s in lib:
            flat[d] = src[s]

    brick = flat[0].numel() * flat.element_size()
    out["K5"] = row(cuda_ms(kernel, 50), cuda_ms(plain, 50),
                    2 * nrows * brick, 0, cuda_ms(library, 50))
    print_times(card, "K5", f"per exchange, {len(steps)} launches",
                out["K5"])
    del flat, steps, lib
    torch.cuda.empty_cache()
    return out


def phase_times_mesh(card: str) -> dict:
    """K9 summed over the launches of one weak mesh exchange (two stages,
    four ranks on cuda:0) and K10 over one strong mesh exchange (two
    stages, two ranks): kernel, plain version (one ``Tensor.copy_`` per
    row), bound (every row read once and written once, device memory on
    one card) and, as the library call, one indexed assignment
    ``flat[dst] = flat[src]`` per stage (all ranks of the card are one
    tensor)."""
    import torch

    from bricklib_tpu_torch.comm.exchange import copy_rows_plain

    out = {}
    for key, ex, state, _rows in mesh_exchanges(["cuda:0"] * 4,
                                                ["cuda:0"] * 2):
        flats = [t.view((-1,) + tuple(t.shape[-3:])) for t in state]
        flat = flats[0]
        lib, nrows = [], 0
        for per_card in ex.plan:
            rows = per_card[0]
            d = torch.tensor([dr + i for _dc, dr, _sc, _sr, n in rows
                              for i in range(n)]).cuda()
            s_ = torch.tensor([sr + i for _dc, _dr, _sc, sr, n in rows
                               for i in range(n)]).cuda()
            lib.append((d, s_))
            nrows += len(d)

        def plain():
            for per_card in ex.plan:
                copy_rows_plain(flats, per_card[0])

        def library():
            for d, s_ in lib:
                flat[d] = flat[s_]

        brick = flat[0].numel() * flat.element_size()
        out[key] = row(cuda_ms(lambda: ex(state), 50), cuda_ms(plain, 10),
                       2 * nrows * brick, 0, cuda_ms(library, 50))
        print_times(card, key, f"per exchange, {len(ex.plan)} launches, "
                    f"{nrows} brick rows of {brick} B", out[key])
        del state, flats, flat, lib
        torch.cuda.empty_cache()
    out.update(phase_times_fused(card))
    return out


def phase_times_fused(card: str) -> dict:
    """K11 at the full weak mesh plan (four ranks of 512^3 on cuda:0): the
    kernel, its plain version, the bound (the sweep's bricks read once and
    written once, the copied rows read and written once; 2 operations per
    tap and output) and, where the library call would stand, the
    composition it replaces: the PUT exchange then the ghost-inclusive
    K1."""
    from bricklib_tpu_torch.bench.roofline import sweep_work

    import dataclasses

    import torch

    from bricklib_tpu_torch.codegen.fused_exchange import (brick_rows,
                                                           fusedx_plain)

    fn, put, sweeps, state, dec = fused_case(
        (N_BIG,) * 3, (BD_K, BD_J, N_BIG), 1, "s7pt", ["cuda:0"] * 4, 90)
    nb = dec.nbricks
    flats = [t.view((-1,) + t.shape[2:]) for t in state]
    rows = brick_rows(fn.mesh, fn.copies, nb)
    tables = [torch.from_numpy(fn.plan.table).cuda()]
    plan4 = dataclasses.replace(fn.plan, batch=4, batch_stride=nb)
    nbytes, flops = sweep_work(plan4)
    brick = flats[0][0].numel() * flats[0].element_size()
    moved = sum(r[-1] for r in rows)
    r = row(cuda_ms(lambda: fn(state), 20),
            cuda_ms(lambda: fusedx_plain(flats, rows, fn.plan, tables, nb),
                    3),
            nbytes + 2 * moved * brick, flops, None)
    r["composed_ms"] = cuda_ms(lambda: composed(put, sweeps, state), 20)
    print_times(card, "K11", f"one launch, 4 ranks of 512^3, {moved} brick "
                "rows copied (library call: none; the PUT exchange + K1 it "
                f"replaces {r['composed_ms']:.3f} ms)", r)
    del fn, state, flats
    torch.cuda.empty_cache()
    return {"K11": r}


def conv_of(plan, fuse: int):
    """``nn.Conv2d`` (circular padding, no bias) computing what one sweep
    of ``plan`` computes on a periodic domain: per output and input field,
    the ``fuse``-fold composition of the output's folded taps as
    weights."""
    import torch

    comps = []
    for taps in plan.taps:
        one = dict(taps)
        comp = dict(one)
        for _ in range(fuse - 1):
            nxt: dict = {}
            for (f, a, b), c in comp.items():
                for (_f, dy, dx), d in one.items():
                    k = (f, a + dy, b + dx)
                    nxt[k] = nxt.get(k, 0.0) + c * d
            comp = nxt
        comps.append(comp)
    R = max(max(abs(dy), abs(dx)) for comp in comps for _f, dy, dx in comp)
    w = torch.zeros(len(comps), len(plan.fields), 2 * R + 1, 2 * R + 1,
                    dtype=torch.float64)
    for o, comp in enumerate(comps):
        for (f, dy, dx), c in comp.items():
            w[o, f, dy + R, dx + R] = c
    conv = torch.nn.Conv2d(len(plan.fields), len(comps), 2 * R + 1,
                           padding=R, padding_mode="circular", bias=False,
                           device="cuda").requires_grad_(False)
    conv.weight.copy_(w.float())
    return conv


def conv3d_of(taps, fuse: int):
    """``nn.Conv3d`` (circular padding, no bias) computing ``fuse``
    iterations of a linear single-input stencil (its tap table) on a
    periodic domain, with the composed taps as weights."""
    import torch

    one = {tuple(o): c for o, c in zip(taps.offsets.tolist(),
                                       taps.coeffs.tolist())}
    comp = dict(one)
    for _ in range(fuse - 1):
        nxt: dict = {}
        for a, c in comp.items():
            for b, d in one.items():
                k = tuple(x + y for x, y in zip(a, b))
                nxt[k] = nxt.get(k, 0.0) + c * d
        comp = nxt
    R = max(abs(v) for k in comp for v in k)
    w = torch.zeros(1, 1, 2 * R + 1, 2 * R + 1, 2 * R + 1,
                    dtype=torch.float64)
    for (dk, dj, di), c in comp.items():
        w[0, 0, dk + R, dj + R, di + R] = c
    conv = torch.nn.Conv3d(1, 1, 2 * R + 1, padding=R,
                           padding_mode="circular", bias=False,
                           device="cuda").requires_grad_(False)
    conv.weight.copy_(w.float())
    return conv


def owned_dense(x, plan):
    """The bricks ``plan`` writes on the 512^3 periodic table, as the dense
    owned domain ``[512, 512, 512]``."""
    import torch

    (K0, K1), (J0, J1) = plan.ranges
    ids = torch.from_numpy(plan.table[K0:K1, J0:J1]).cuda().long()
    b = x.view((x.shape[0],) + tuple(plan.bdims))[ids]
    return b.permute(0, 2, 1, 3, 4).reshape((N_BIG,) * 3)


def library_conv(name: str, fn, x, taps, fuse: int, tol: float = 1e-4):
    """The ms of one ``nn.Conv3d`` computing what the sweep ``fn`` computes
    on the dense owned domain, after holding it against the sweep at
    ``tol``; None (said why) when it disagrees or fails."""
    import torch

    dense = owned_dense(x, fn.plan)[None, None]
    got = owned_dense(fn(x), fn.plan)
    try:
        with torch.no_grad():
            conv = conv3d_of(taps, fuse)
            ok, e = close(got, conv(dense)[0, 0], tol)
            if not ok:
                print(f"[5 {name}] nn.Conv3d disagrees with the kernel at "
                      f"{tol:g} (max abs {e:.3e}): no library time")
                return None
            return cuda_ms(lambda: conv(dense), 3)
    except RuntimeError as e:
        print(f"[5 {name}] nn.Conv3d failed ({e}): no library time")
        return None


def phase_times_3d(card: str) -> dict:
    """One sweep over the 512^3 periodic table, the owned domain: K1 at
    s7pt fuse=4 (the 3-D ``Problem`` and the weak step's owned-only form;
    the K1 record) and at mpi125pt fuse=1 and fuse=2, and K8 at mpi125pt;
    each with its plain version, its bound and one ``nn.Conv3d``
    (circular padding, composed weights, TF32 off).  The mpi125pt rows
    share the bound of the fewer operations, the factorized form's."""
    from bricklib_tpu_torch.bench.roofline import sweep_work

    import numpy as np
    import torch

    from bricklib_tpu_torch.codegen.mxu_kernel import (
        pencil_sweep_mxu, pencil_sweep_mxu_plain)
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain
    from bricklib_tpu_torch.codegen.taps import params_from_reference
    from bricklib_tpu_torch.stencils import bench_params

    dec = decomposition(N_BIG)
    tg = dec.periodic_grid((0, 1, 2))
    params = bench_params()
    x = rand_cuda((dec.nbricks,) + tuple(dec.bdims), 16)
    table = torch.from_numpy(np.ascontiguousarray(tg[:, :, 0],
                                                  np.int32)).cuda()
    out = {}
    mx = pencil_sweep_mxu("mpi125pt", tg, dec.bdims, dec.nbricks, params)
    outputs = len(mx.plan.written_bricks()) * int(np.prod(dec.bdims))
    flops125 = mx.plan.flops_per_output() * outputs
    for key, name, stencil, fuse in PERIODIC_K1:
        fn = periodic_sweep(dec, stencil, fuse)
        nbytes, flops = sweep_work(fn.plan)
        if stencil == "mpi125pt":
            flops = fuse * flops125
        r = row(cuda_ms(lambda: fn(x), 10),
                cuda_ms(lambda: pencil_sweep_plain(x, table, fn.plan), 2),
                nbytes, flops,
                library_conv(f"K1 {name}", fn, x,
                             params_from_reference(params, stencil), fuse))
        print_times(card, "K1", f"512^3 periodic {name}", r)
        out[key] = r
    xf = x.view(dec.nbricks, BD_K, -1)
    # on the periodic table every brick read is an owned brick it writes
    out["K8"] = row(
        cuda_ms(lambda: mx(xf), 10),
        cuda_ms(lambda: pencil_sweep_mxu_plain(xf, table, mx.plan), 2),
        2 * 4 * outputs, flops125,
        library_conv("K8 mpi125pt", mx, xf,
                     params_from_reference(params, "mpi125pt"), 1))
    print_times(card, "K8", f"512^3 periodic mpi125pt, {flops125} f32 "
                f"operations ({mx.plan.flops_per_output()} per output)",
                out["K8"])
    del x, xf
    torch.cuda.empty_cache()
    return out


def phase_times_dense(card: str) -> dict:
    """K7 on one slab of the out-of-core pass (s7pt, 149 x 1040 x 1152
    padded): kernel, plain version, bound (the input rows the taps reach
    read and the padded output written once) and one valid ``F.conv3d`` on
    the padded
    slab, which matches the kernel on the interior i columns only (the
    kernel's roll also defines the pad columns; checked at 1e-4 there)."""
    import torch
    import torch.nn.functional as F

    from bricklib_tpu_torch.codegen.dense_kernel import (dense_stencil,
                                                         dense_stencil_plain)
    from bricklib_tpu_torch.codegen.taps import params_from_reference
    from bricklib_tpu_torch.stencils import bench_params

    fn = dense_stencil("s7pt", OOC_SLAB, OOC_PADS, bench_params())
    x = rand_cuda(OOC_SLAB, 17)
    pk, pj, pi = OOC_PADS
    SK, SJ, SI = OOC_SLAB
    w = torch.zeros(1, 1, 3, 3, 3, device="cuda")
    taps = params_from_reference(bench_params(), "s7pt")
    for (dk, dj, di), c in zip(taps.offsets.tolist(), taps.coeffs.tolist()):
        w[0, 0, dk + 1, dj + 1, di + 1] = c
    xs = x[None, None]
    got = fn(x)[pk:SK - pk, pj:SJ - pj, pi:SI - pi]
    ref = F.conv3d(xs, w)[0, 0, pk - 1:SK - pk - 1, pj - 1:SJ - pj - 1,
                          pi - 1:SI - pi - 1]
    ok, e = close(got, ref, 1e-4)
    lib = cuda_ms(lambda: F.conv3d(xs, w), 5) if ok else None
    if not ok:
        print(f"[5 K7] F.conv3d disagrees with the kernel at 1e-4 (max abs "
              f"{e:.3e}): no library time")
    del got, ref
    rows = SK - 2 * pk
    # read: the k and j rows the taps reach from the interior, whole padded
    # i rows (the i taps wrap); written: the whole padded output
    (klo, jlo, _), (khi, jhi, _) = fn.plan.lo, fn.plan.hi
    nread = (rows + klo + khi) * (SJ - 2 * pj + jlo + jhi) * SI
    r = row(cuda_ms(lambda: fn(x), 10),
            cuda_ms(lambda: dense_stencil_plain([x], fn.plan), 3),
            4 * (nread + x.numel()),
            2 * len(fn.plan.taps) * rows * (SJ - 2 * pj) * SI, lib)
    print_times(card, "K7", f"one out-of-core slab {OOC_SLAB} s7pt "
                "(library call: valid conv3d, interior i columns)", r)
    del x
    torch.cuda.empty_cache()
    return {"K7": r}


def phase_times_2d(card: str) -> dict:
    """K6 on each 16384^2 configuration of :func:`sweeps_2d`: kernel,
    plain version, bound, and one ``nn.Conv2d`` call on the owned rows as
    a dense periodic array (checked against the kernel at 1e-4 before it
    is timed).  The ``fuse=4`` 9-point box, the 2-D path's sweep, is the
    kernel's record."""
    from bricklib_tpu_torch.bench.roofline import sweep_work

    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel_2d import (
        pencil_sweep_2d_plain)

    out = {}
    for name, fn, shape in sweeps_2d()[:3]:
        plan = fn.plan
        xs = [rand_cuda(shape, 40 + f) for f in range(len(plan.fields))]
        table = torch.from_numpy(plan.table).cuda()
        t_k = cuda_ms(lambda: fn(*xs), 20)
        t_p = cuda_ms(lambda: pencil_sweep_2d_plain(xs, table, plan), 3)
        ids = table[plan.y_range[0]:plan.y_range[1]].long()
        dense = torch.stack([x[ids].reshape(-1, N2) for x in xs])[None]
        got = fn(*xs)
        got = got if isinstance(got, tuple) else (got,)
        t_l = None
        try:
            with torch.no_grad():
                conv = conv_of(plan, plan.fuse)
                ref = conv(dense)[0]
                same = all(close(g[ids].reshape(-1, N2), r, 1e-4)[0]
                           for g, r in zip(got, ref))
                del ref
                if same:
                    t_l = cuda_ms(lambda: conv(dense), 5)
                else:
                    print(f"[5 K6 {name}] nn.Conv2d disagrees with the "
                          "kernel at 1e-4: no library time")
        except RuntimeError as e:
            print(f"[5 K6 {name}] nn.Conv2d failed ({e}): no library time")
        r = row(t_k, t_p, *sweep_work(plan), t_l)
        print_times(card, "K6", name, r)
        if name.startswith("box9") and plan.fuse == FUSE2:
            out["K6"] = r
        del xs, dense, got
        torch.cuda.empty_cache()
    return out


def star_nd(nd: int, two: bool = False, corner: bool = False):
    """A rank-``nd`` stencil in the port's eDSL: the ``2 nd + 1``-point
    star (radius 1 on every axis, distinct coefficients); ``two`` adds
    taps of a second input ``aux``; ``corner`` adds two taps that cross
    three axes at once (``bench/k12_regimes.py`` builds it)."""
    from bricklib_tpu_torch.bench.k12_regimes import star_nd as build

    return build(nd, two, corner)


def nd_case(dims, bd, sdef, seed: int):
    """(sweep, inputs, decomposition) of a rank-``nd`` pencil decomposition
    (ghost one brick on every outer axis, none in i, good skin): the sweep
    over the owned bricks and one random storage per input on the card."""
    from bricklib_tpu_torch.codegen.pencil_kernel_nd import pencil_sweep_nd
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name

    nd = len(dims)
    dec = BrickDecomp(dims=dims, ghost_depth=bd[:-1] + (0,),
                      bdims=bd).initialize(skinlist_by_name("good", nd))
    fn = pencil_sweep_nd(sdef, dec.grid, bd, dec.nbricks, {})
    xs = [rand_cuda((dec.nbricks,) + bd, seed + f)
          for f in range(len(getattr(fn, "fields", "x")))]
    return fn, xs, dec


def nd_twin(xs, fn, dec):
    """The owned region of one rank-``nd`` sweep as dense tensor code on
    the card: each input gathered to its dense block (ghosts included),
    one slice per folded tap, rolled along the i row."""
    import torch

    from bricklib_tpu_torch.core.setup import from_bricks

    plan = fn.plan
    nd = len(plan.bdims)
    gz = plan.bdims[:-1] + (0,)
    dense = [from_bricks(x.view(dec.nbricks, -1), dec.grid, plan.bdims)
             for x in xs]
    acc = None
    inputs = (plan.taps.inputs.tolist() if plan.taps.inputs is not None
              else [0] * len(plan.taps.coeffs))
    for offs, c, f in zip(plan.taps.offsets.tolist(),
                          plan.taps.coeffs.tolist(), inputs):
        v = dense[f][tuple(slice(gz[a] + offs[a], gz[a] + offs[a]
                                 + dec.dims[a]) for a in range(nd - 1))]
        v = c * torch.roll(v, -offs[-1], dims=nd - 1)
        acc = v if acc is None else acc + v
    return acc


def check_nd(name: str, fn, xs, dec, err: dict) -> None:
    """K12 against its plain version on the bricks it writes at
    abs-or-rel 1e-5, and its owned region against the dense i-wrapped
    twin at 1e-4."""
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain
    from bricklib_tpu_torch.codegen.pencil_kernel_nd import stream_plan_nd
    from bricklib_tpu_torch.core.setup import from_bricks

    got = fn(*xs)
    table = torch.from_numpy(fn.plan.table).cuda()
    want = pencil_sweep_plain(xs, table, fn.plan)
    w = torch.from_numpy(fn.plan.written_bricks()).cuda()
    ok, e = close(got[w], want[w], K1_TOL)
    del want
    err["K12"] = max(err.get("K12", 0.0), e)
    own = from_bricks(got.view(dec.nbricks, -1), dec.interior_grid(),
                      fn.plan.bdims)
    ok2, e2 = close(own, nd_twin(xs, fn, dec), 1e-4)
    sp = stream_plan_nd(fn.plan)
    print(f"[3 K12 {name}] {len(w)} bricks, {sp.nstream} blocks of "
          f"{sp.kch} brick rows x {sp.pj} pencils x {sp.ti} lanes, "
          f"{'the compiled star' if sp.layout else 'the generic body'}: "
          f"max abs err {e:.3e} against "
          f"the plain version (abs-or-rel {K1_TOL:g}) "
          f"{'ok' if ok else 'MISMATCH'}; {e2:.3e} against the dense "
          f"i-wrapped twin (1e-4) {'ok' if ok2 else 'MISMATCH'}")
    if not (ok and ok2):
        fail(f"K12 {name} disagrees")
    del got, own
    torch.cuda.empty_cache()


def phase_kernels_nd(err: dict) -> None:
    """K12 against its plain version: the 5-D star at the full
    decomposition, a two-input 5-D stencil with corner taps and a rank-6
    star at smaller sizes."""
    for name, dims, bd, sdef, seed in (
            (f"5-D star {DIMS5}", DIMS5, BD5, star_nd(5), 40),
            (f"5-D two-input corners {DIMS5_2IN}", DIMS5_2IN, BD5_2IN,
             star_nd(5, two=True, corner=True), 41),
            (f"6-D star {DIMS6}", DIMS6, BD6, star_nd(6), 43)):
        fn, xs, dec = nd_case(dims, bd, sdef, seed)
        check_nd(name, fn, xs, dec, err)
        del xs


def nd_path() -> dict:
    """The rank-5+ sweep's own entry point (``pencil_sweep_nd``, the
    counterpart of ``pallas_pencil_sweep_nd``) on the full 5-D
    decomposition: one sweep held against the dense twin, then
    ``K12_TIMED`` timed."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.core.setup import from_bricks

    fn, xs, dec = nd_case(DIMS5, BD5, star_nd(5), 44)
    got = from_bricks(fn(*xs).view(dec.nbricks, -1), dec.interior_grid(),
                      BD5)
    ok, e = close(got, nd_twin(xs, fn, dec), 1e-4)
    print(f"[4 K12 5-D sweep] against the dense i-wrapped twin: max abs err "
          f"{e:.3e} (abs-or-rel 1e-4) {'ok' if ok else 'MISMATCH'}")
    if not ok or not bool(torch.isfinite(got).all()):
        fail("the 5-D sweep disagrees with its dense twin")
    del got
    ms = cuda_ms(lambda: fn(*xs), K12_TIMED)
    del xs
    torch.cuda.empty_cache()
    return {"sweep_ms": ms,
            "gstencil_s": float(np.prod(DIMS5)) / ms / 1e6,
            "calls": {"sweep": 2 + K12_TIMED}}


def report_nd(card: str, name: str, res: dict) -> None:
    print(f"[5 {name} sweep] {card}: {res['sweep_ms']:.3f} ms/sweep, "
          f"{res['gstencil_s']:.3f} GStencil/s")


def local_groups(stages) -> int:
    """K2 launches per SHIFT exchange with every rank on one card: one per
    run of consecutive stages on axes of one rank."""
    from bricklib_tpu_torch.comm.exchange import stage_groups

    return sum(not stages[g[0]].remote for g in stage_groups(stages))


def oracle_k2(dims, bd, mesh) -> int:
    """K2 launches per oracle exchange with every rank on one card
    (whole-brick ghosts): :func:`local_groups`."""
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.comm.exchange import shift_stages

    nd = len(dims)
    dec = BrickDecomp(dims=dims, ghost_depth=bd, bdims=bd).initialize(
        skinlist_by_name("good", nd))
    return local_groups(shift_stages(dec, mesh))


def weak_oracle(dims, mesh=None, overlap=False) -> dict:
    """The weak step on the torch oracle (s7pt, bricks (8, 8, 128),
    ST_ITER 8), ranks on cuda:0, validated against the global roll
    twin."""
    import numpy as np

    from bricklib_tpu_torch.drivers import weak

    n = 1 if mesh is None else int(np.prod(mesh))
    return weak.run(dims=dims, bdim=ORACLE_BD, stencil="s7pt",
                    st_iter=ST_ITER, backend="jnp", mesh_shape=mesh,
                    overlap=overlap, devices=["cuda:0"] * n,
                    iters=ORACLE_ITERS,
                    validate=roll_validate("s7pt", ST_ITER))


def problem_5d() -> dict:
    """A 5-D ``Problem`` with the 11-point star at (16, 16, 16, 16, 256)
    per rank on mesh (1, 1, 1, 1, 2), two ranks on cuda:0: ``auto`` must
    resolve to the oracle (the i axis is distributed); one step held
    against a ``torch.roll`` twin of the global domain."""
    import torch

    from bricklib_tpu_torch.api import Problem

    sd = star_nd(5)
    p = Problem(dims=DIMS5_P, stencil=sd, mesh=MESH5_P,
                devices=["cuda:0"] * 2)
    if p.backend != "jnp" or p.describe()["kernels"] != []:
        fail(f"Problem 5-D resolved to {p.backend}")
    gshape = tuple(m * d for m, d in zip(MESH5_P, DIMS5_P))
    g = rand_cuda(gshape, 45)
    twin = {p.gname: roll_twin(g, sd, p.params, p.st_iter)}
    res = run_problem(p, {"array": g.cpu().numpy()}, twin, 1, ORACLE_ITERS)
    del g, twin
    res["k2"] = oracle_k2(p.dims, p.bdims, p.eff_mesh)
    del p
    torch.cuda.empty_cache()
    return res


def oracle_paths() -> list:
    """The oracle's paths for :func:`phase_paths`: (name, run, launches of
    the result)."""
    from bricklib_tpu_torch.drivers import strong, weak

    n1 = (N_BIG,) * 3
    nm = (ORACLE_MESH_N,) * 3
    sdom = STRONG_ORACLE
    return [
        (f"weak {N_BIG}^3 jnp", lambda: weak_oracle(n1),
         lambda r: {"K2": oracle_k2(n1, ORACLE_BD, (1, 1, 1))
                    * r["calls"]["step"], "K3": r["calls"]["copy"]}),
        (f"weak {ORACLE_MESH_N}^3 per rank jnp, mesh {MESH_WEAK}, 4 ranks "
         "on cuda:0, overlap", lambda: weak_oracle(nm, MESH_WEAK, True),
         lambda r: {"K2": oracle_k2(nm, ORACLE_BD, MESH_WEAK)
                    * r["calls"]["step"], "K3": r["calls"]["copy"]}),
        ("weak CLI defaults jnp --f64-validate", lambda: weak.run(
            dims=(64,) * 3, bdim=(8,) * 3, stencil="mpi7pt", st_iter=8,
            iters=ORACLE_ITERS, f64_validate=True, device="cuda"),
         lambda r: {"K2": oracle_k2((64,) * 3, (8,) * 3, (1, 1, 1))
                    * r["calls"]["step"], "K3": r["calls"]["copy"]}),
        (f"strong {sdom[0]} in cubic {sdom[1]} jnp", lambda: strong.run(
            dom=sdom[0], sdom=sdom[1], bdim=sdom[2], stencil="s7pt",
            st_iter=ST_ITER, backend="jnp", validate=True,
            iters=ORACLE_ITERS, device="cuda"),
         lambda r: {"K5": r["exchange_steps"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        (f"Problem 5-D {DIMS5_P} per rank, mesh {MESH5_P}, 2 ranks on "
         "cuda:0, auto -> jnp", problem_5d,
         lambda r: {"K2": r["k2"] * r["calls"]["step"],
                    "K3": r["calls"]["copy"]}),
        ("K12 5-D pencil sweep (pencil_sweep_nd)", nd_path,
         lambda r: {"K12": r["calls"]["sweep"]}),
    ]


def reach(region, offsets) -> int:
    """Cells of the union of a box of extents ``region`` shifted by each
    of ``offsets``: the input a stencil's taps reach from that box (a
    star's reach is the box and one face slab per axis and sign)."""
    import numpy as np

    offs = np.asarray(offsets, np.int64).reshape(len(offsets), -1)
    lo, hi = np.maximum(-offs.min(0), 0), np.maximum(offs.max(0), 0)
    mask = np.zeros([n + a + b for n, a, b in zip(region, lo, hi)], bool)
    for o in offs:
        mask[tuple(slice(a + d, a + d + n)
                   for a, d, n in zip(lo, o, region))] = True
    return int(mask.sum())


def phase_times_nd(card: str) -> dict:
    """K12 at the full 5-D decomposition beside its plain version and its
    bound: per input, the cells its taps reach from the computed region
    (whole i rows: i wraps inside the row) read once, and the region
    written once; 2 f32 operations per folded tap and output element.
    No single PyTorch call computes it (no 5-D convolution)."""
    import numpy as np
    import torch

    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep_plain

    fn, xs, dec = nd_case(DIMS5, BD5, star_nd(5), 46)
    plan = fn.plan
    table = torch.from_numpy(plan.table).cuda()
    counts = [b - a for a, b in plan.ranges]
    region = [c * b for c, b in zip(counts, plan.bdims)] + [plan.bdims[-1]]
    offs = plan.taps.offsets
    field = (plan.taps.inputs if plan.taps.inputs is not None
             else np.zeros(len(offs), np.int64))
    nread = region[-1] * sum(reach(region[:-1], offs[field == f, :-1])
                             for f in range(len(xs)))
    nout = float(np.prod(region))
    r = row(cuda_ms(lambda: fn(*xs), K12_TIMED),
            cuda_ms(lambda: pencil_sweep_plain(xs, table, plan), 2),
            4 * (nread + nout), 2 * len(plan.taps.coeffs) * nout, None)
    print_times(card, "K12", f"5-D star {DIMS5}, {nread} input elements "
                f"reached, {int(nout)} written", r)
    del xs
    torch.cuda.empty_cache()
    return {"K12": r}


def main() -> None:
    if not (HERE / "bricklib_tpu_torch" / "csrc").is_dir():
        fail(f"no bricklib_tpu_torch/ beside {Path(__file__).name}: run it "
             "from the root of a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_toolchain()
    phase_build()
    err = phase_kernels()
    phase_kernels_4d(err)
    phase_kernels_strong(err)
    phase_kernels_stream(err)
    phase_kernels_mesh(err)
    phase_kernels_fused(err)
    phase_kernels_2d(err)
    phase_kernels_mxu(err)
    phase_kernels_dense(err)
    phase_kernels_nd(err)
    launches = phase_paths(card)
    times = phase_times(card)
    if "jax" in sys.modules:
        fail("the port imported jax")
    ref_mods = sorted(m for m in sys.modules if m == "bricklib_tpu"
                      or m.startswith("bricklib_tpu."))
    if ref_mods:
        fail(f"the port imported the JAX package: {ref_mods}")
    src = "bricklib_tpu_torch/csrc/"
    kernels = [
        ("K1", {"name": "K1 pencil_sweep", "route": "cuda",
                "source": src + "pencil_sweep.cu",
                "replaces": "bricklib_tpu/codegen/pencil_kernel.py:296"}),
        ("K2", {"name": "K2 copy_intervals", "route": "cuda",
                "source": src + "brick_copy.cu",
                "replaces": "bricklib_tpu/comm/exchange.py:138"}),
        ("K3", {"name": "K3 copy_storage", "route": "cuda",
                "source": src + "brick_copy.cu",
                "replaces": "bricklib_tpu/bench/roofline.py:154"}),
        ("K4", {"name": "K4 pencil_sweep_4d", "route": "cuda",
                "source": src + "pencil_sweep_4d.cu",
                "replaces": "bricklib_tpu/codegen/pencil_kernel_4d.py:48"}),
        ("K5", {"name": "K5 copy_stage", "route": "cuda",
                "source": src + "brick_copy.cu",
                "replaces": "bricklib_tpu/comm/strong.py:133"}),
        ("K6", {"name": "K6 pencil_sweep_2d", "route": "cuda",
                "source": src + "pencil_sweep_2d.cu",
                "replaces": "bricklib_tpu/codegen/pencil_kernel_2d.py:42"}),
        ("K7", {"name": "K7 dense_stencil", "route": "cuda",
                "source": src + "dense_stencil.cu",
                "replaces": "bricklib_tpu/codegen/pallas_backend.py:128"}),
        ("K8", {"name": "K8 pencil_sweep_mxu", "route": "cuda",
                "source": src + "pencil_sweep_mxu.cu",
                "replaces": "bricklib_tpu/codegen/mxu_kernel.py:93"}),
        ("K9", {"name": "K9 remote_copy", "route": "cuda",
                "source": src + "remote_copy.cu",
                "replaces": "bricklib_tpu/comm/exchange.py:260"}),
        ("K10", {"name": "K10 strong_remote_copy", "route": "cuda",
                 "source": src + "remote_copy.cu",
                 "replaces": "bricklib_tpu/comm/strong.py:195"}),
        ("K11", {"name": "K11 pencil_sweep_fusedx", "route": "cuda",
                 "source": src + "fused_exchange.cu",
                 "replaces": "bricklib_tpu/codegen/fused_exchange.py:56"}),
        ("K12", {"name": "K12 pencil_sweep_nd", "route": "cuda",
                 "source": src + "pencil_sweep_nd.cu",
                 "replaces": "bricklib_tpu/codegen/pencil_kernel_nd.py:51"}),
    ]
    for k, entry in kernels:
        entry.update(launches=launches[k], max_abs_err=err[k],
                     **{f: times[k][f] for f in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")})
    print(json.dumps({"kernels": [e for _k, e in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
