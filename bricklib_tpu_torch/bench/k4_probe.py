"""What bounds kernel K4: its block bodies timed with parts taken out.

    python -m bricklib_tpu_torch.bench.k4_probe [--reps 2] [--rows 4]
                                                [--threads 512]
                                                [--body ring|regstream|both]
                                                [--sass]

Builds, into ``build/k4_probe/``, a standalone program around each of
K4's block bodies in the forms ``bench/k1_probe.py`` makes of K1's
(``full``; ``no-loads``: level 0 never loaded; ``no-barriers``: the ring
body without the barrier between two levels of a step, the
register-streaming body without its step's barrier; ``neither``; and for
the ring body ``generic``: ``full`` without the 4-D star's compiled
layout), and times each (CUDA events, 10 launches after one) on the weak
4-D step's ghost-inclusive ``fuse=2`` sweep (16x64x128x512 with its
ghosts, bricks (4, 8, 8, 512), every brick of a 6 x 10 x 18 table) at
each body's planner's footprint: the ring body (``csrc/pencil_stream_4d.cuh``,
``stream_plan_4d``) and the register-streaming body
(``csrc/pencil_regstream_4d.cuh``, ``regstream_plan_4d``).  Forms other
than ``full`` and ``generic`` give wrong results; the differences name
what each part costs.  ``--rows`` (the k rows a thread of the ring body
computes at once, ``BT4_UR``) and ``--threads`` (per block, the launch
bound with one block per SM) build the ring body's forms at another shape
of the body: fewer registers a thread against more warps.  ``--sass`` also
counts, with ``cuobjdump``, the instructions of each item loop of the
ring body's ``full`` form (a run between branches holding at least 32
FFMAs: one item, BT4_UR rows of 32 lanes) and of each step of the
register-streaming body's ``full`` form (a run between two barriers with
at least 32 FFMAs), by opcode.  The last line is one JSON object, with
the card's name and power limit.  Only a measurement: no path of the port
runs these forms.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
from collections import Counter
from pathlib import Path

from .k1_probe import ROOT, probe, step_ops

OUT = ROOT / "build" / "k4_probe"
DIMS, BD = (16, 64, 128, 512), (4, 8, 8, 512)

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.cuh"
template <class L>
__global__ void __launch_bounds__(THREADS, 1)
k(const float* x, float* out, const int* table, Stream4Geom g,
  Sweep4Taps taps) {
    extern __shared__ __align__(16) float smem[];
    stream4_block<L>(x, out, table, g, taps, blockIdx.x, smem);
}
template <class L>
float run(int blocks, int smem, const float* x, float* out, const int* tab,
          const Stream4Geom& g, const Sweep4Taps& taps) {
    cudaFuncSetAttribute(k<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    k<L><<<blocks, THREADS, smem>>>(x, out, tab, g, taps);
    cudaDeviceSynchronize();
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    for (int r = 0; r < 10; ++r)
        k<L><<<blocks, THREADS, smem>>>(x, out, tab, g, taps);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    return ms / 10;
}
int main(int argc, char** argv) {
    const int F = atoi(argv[1]), WCH = atoi(argv[2]), PK = atoi(argv[3]);
    const int PJ = atoi(argv[4]), TI = atoi(argv[5]), D = atoi(argv[6]);
    const int SMEM = atoi(argv[7]), SKEW = atoi(argv[8]), H = atoi(argv[9]);
    const int GW = atoi(argv[10]), GK = atoi(argv[11]), GJ = atoi(argv[12]);
    const int BW = 4, BK = 8, BJ = 8, BI = 512;
    const size_t nb = (size_t)GW * GK * GJ, n = nb * BW * BK * BJ * BI;
    float *x, *out;
    int* tab;
    cudaMalloc(&x, n * 4);
    cudaMalloc(&out, n * 4);
    cudaMalloc(&tab, nb * 4);
    std::vector<int> t(nb);
    for (size_t i = 0; i < nb; ++i) t[i] = (int)i;
    cudaMemcpy(tab, t.data(), nb * 4, cudaMemcpyHostToDevice);
    cudaMemset(x, 0, n * 4);
    Sweep4Taps taps;
    taps.n = 9;
    const int off[9][4] = {{0, 0, 0, 0}, {0, 0, 0, 1}, {0, 0, 0, -1},
                           {0, 0, 1, 0}, {0, 0, -1, 0}, {0, 1, 0, 0},
                           {0, -1, 0, 0}, {1, 0, 0, 0}, {-1, 0, 0, 0}};
    for (int u = 0; u < 9; ++u) {
        taps.dw[u] = off[u][0];
        taps.dk[u] = off[u][1];
        taps.dj[u] = off[u][2];
        taps.di[u] = off[u][3];
        taps.c[u] = u ? 0.1f : 0.2f;
    }
    const int nwch = (GW + WCH - 1) / WCH, nkg = (GK + PK - 1) / PK;
    const int njg = (GJ + PJ - 1) / PJ, nit = BI / TI;
    Stream4Geom g = {GW, GK, GJ, BW, BK, BJ, BI, 0, GW, WCH, nwch,
                     0, GK, PK, nkg, 0, GJ, PJ, njg, TI, nit, H, 4, D, F,
                     1, 1, 1, 1, 1, 1, 1, 1, 0, SKEW};
    const int blocks = nwch * nkg * njg * nit;
    const float ms = atoi(argv[13])
        ? run<LayoutRuntime>(blocks, SMEM, x, out, tab, g, taps)
        : run<LayoutStar9>(blocks, SMEM, x, out, tab, g, taps);
    printf("%.4f %s\n", ms, cudaGetErrorString(cudaGetLastError()));
    return 0;
}
"""


HARNESS_RS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.cuh"
__global__ void __launch_bounds__(BT4_RS_THREADS, 1)
k(const float* x, float* out, const int* table, Reg4Geom g,
  Star9Coeffs cf) {
    extern __shared__ __align__(16) float smem[];
    regstream4_block<PF, PRW>(x, out, table, g, cf, blockIdx.x, smem);
}
int main(int argc, char** argv) {
    const int F = atoi(argv[1]), WCH = atoi(argv[2]), PK = atoi(argv[3]);
    const int PJ = atoi(argv[4]), TI = atoi(argv[5]), D = atoi(argv[6]);
    const int SMEM = atoi(argv[7]), NQ = atoi(argv[8]), H = atoi(argv[9]);
    const int GW = atoi(argv[10]), GK = atoi(argv[11]), GJ = atoi(argv[12]);
    if (F != PF) return 1;
    const int BW = 4, BK = 8, BJ = 8, BI = 512;
    const size_t nb = (size_t)GW * GK * GJ, n = nb * BW * BK * BJ * BI;
    float *x, *out;
    int* tab;
    cudaMalloc(&x, n * 4);
    cudaMalloc(&out, n * 4);
    cudaMalloc(&tab, nb * 4);
    std::vector<int> t(nb);
    for (size_t i = 0; i < nb; ++i) t[i] = (int)i;
    cudaMemcpy(tab, t.data(), nb * 4, cudaMemcpyHostToDevice);
    cudaMemset(x, 0, n * 4);
    Star9Coeffs cf = {{0.2f, .1f, .1f, .1f, .1f, .1f, .1f, .1f, .1f}};
    const int nwch = (GW + WCH - 1) / WCH, nkg = (GK + PK - 1) / PK;
    const int njg = (GJ + PJ - 1) / PJ, nit = BI / TI;
    Reg4Geom g = {GW, GK, GJ, BW, BK, BJ, BI, 0, GW, WCH, nwch,
                  0, GK, PK, nkg, 0, GJ, PJ, njg, TI, nit, H, 4, D, NQ, 0};
    const int blocks = nwch * nkg * njg * nit;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM);
    k<<<blocks, BT4_RS_THREADS, SMEM>>>(x, out, tab, g, cf);
    cudaDeviceSynchronize();
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    for (int r = 0; r < 10; ++r)
        k<<<blocks, BT4_RS_THREADS, SMEM>>>(x, out, tab, g, cf);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    printf("%.4f %s\n", ms / 10, cudaGetErrorString(cudaGetLastError()));
    return 0;
}
"""


# The register-streaming body's output rows' addresses, set to the output
# before the block's first barrier: without the step's barrier (the
# no-barriers form) a row's address may be read before it is written.
RS_TABLE = "        rowinfo[3 * r + 2] = row_ofs(kr) + jr * RW;\n    }\n"


def rs_edit(text: str) -> str:
    if RS_TABLE not in text:
        raise RuntimeError("pencil_regstream_4d.cuh changed: no "
                           f"{RS_TABLE!r}")
    return text.replace(RS_TABLE, RS_TABLE + (
        "    for (int r = tid; r < 2 * g.PK * BK * g.PJ * BJ; r += NT)\n"
        "        rowofs[r] = out;\n"))


def item_loops(binary: Path) -> list:
    """Per item loop of the star body in ``binary`` (a run of
    instructions between two branches with at least 32 FFMAs), its
    instruction count by opcode."""
    from bricklib_tpu_torch import _build

    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(binary)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    funcs = sass.split("Function : ")
    kernel = next(f for f in funcs if f.startswith("_Z1kI11LayoutStar9"))
    ops = [m.group(1).split(".")[0] for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
        kernel)]
    runs, cur = [], Counter()
    for op in ops:
        cur[op] += 1
        if op in ("BRA", "EXIT", "BAR"):
            if cur["FFMA"] >= 32:
                runs.append(dict(cur.most_common()))
            cur = Counter()
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--rows", type=int, default=4)
    ap.add_argument("--threads", type=int, default=512)
    ap.add_argument("--body", choices=("ring", "regstream", "both"),
                    default="both")
    ap.add_argument("--sass", action="store_true")
    a = ap.parse_args()
    from bricklib_tpu_torch.bench.k1_regimes import card
    from bricklib_tpu_torch.codegen.pencil_kernel_4d import (
        pencil_sweep_4d, regstream_plan_4d, stream_plan_4d)
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.stencils import bench_params

    dec = BrickDecomp(dims=DIMS, ghost_depth=BD[:3] + (0,),
                      bdims=BD).initialize(skinlist_by_name("good", 4))
    G = dec.grid.shape[:3]
    fn = pencil_sweep_4d("mpi9pt", dec.grid, BD, dec.nbricks,
                         bench_params(), fuse=2, w_range=(0, G[0]),
                         k_range=(0, G[1]), j_range=(0, G[2]))
    res = {"card": card(), "fuse": 2}
    print(res["card"])
    if a.body in ("ring", "both"):
        sp = stream_plan_4d(fn.plan)
        args = [str(v) for v in (2, sp.wch, sp.pk, sp.pj, sp.ti, sp.d,
                                 sp.smem_bytes, sp.skew, sp.h, *G)]
        res.update(rows=a.rows, threads=a.threads,
                   footprint={"wch": sp.wch, "pk": sp.pk, "pj": sp.pj,
                              "ti": sp.ti, "d": sp.d, "skew": sp.skew})
        rows = "#define BT4_UR 4 "

        def edit(text):
            if rows not in text:
                raise RuntimeError("pencil_stream_4d.cuh changed: no "
                                   f"{rows!r}")
            return text.replace(rows, f"#define BT4_UR {a.rows} ")

        harness = f"#define THREADS {a.threads}\n" + HARNESS
        out = OUT / f"r{a.rows}t{a.threads}"
        res["ms"] = probe(f"k4 ghost fuse=2 rows {a.rows} threads "
                          f"{a.threads}", harness, "pencil_stream_4d.cuh",
                          args, out, a.reps, edit)
        if a.sass:
            res["item_loops"] = item_loops(out / "full" / "probe")
            for run in res["item_loops"]:
                print(f"[k4 probe sass] item loop of {sum(run.values())} "
                      f"instructions: {run}", flush=True)
    rp = regstream_plan_4d(fn.plan)
    if a.body in ("regstream", "both") and rp is not None:
        args = [str(v) for v in (2, rp.wch, rp.pk, rp.pj, rp.ti, rp.d,
                                 rp.smem_bytes, rp.nq, rp.h, *G)]
        res["regstream_footprint"] = {"wch": rp.wch, "pk": rp.pk,
                                      "pj": rp.pj, "ti": rp.ti, "rw": rp.rw,
                                      "nq": rp.nq, "d": rp.d}
        harness = f"#define PF 2\n#define PRW {rp.rw}\n" + HARNESS_RS
        out = OUT / "regstream_f2"
        res["regstream_ms"] = probe(
            "k4 regstream ghost fuse=2", harness, "pencil_regstream_4d.cuh",
            args, out, a.reps, rs_edit, generic=False)
        if a.sass:
            res["regstream_step_ops"] = step_ops(out / "full" / "probe")
            for run in res["regstream_step_ops"]:
                print(f"[k4 probe sass] step of {sum(run.values())} "
                      f"instructions: {run}", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
