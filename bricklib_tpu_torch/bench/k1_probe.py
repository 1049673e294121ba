"""What bounds kernel K1: its block bodies timed with parts taken out.

    python -m bricklib_tpu_torch.bench.k1_probe [--fuse 4] [--reps 2]
                                                [--body ring|regstream|both]
                                                [--sass]

Builds, into ``build/k1_probe/``, a standalone program around each of
K1's block bodies in four forms, and times each (CUDA events, 10 launches
after one) on the periodic 512^3 s7pt sweep at its planner's footprint.
The ring body (``csrc/pencil_stream.cuh``, ``SweepPlan.stream``) also runs
without its tap layout; the register-streaming body
(``csrc/pencil_regstream.cuh``, ``SweepPlan.regstream``: the star at fuse
2 to 4) has none to take out, and its one barrier a step is the one the
``no-barriers`` form drops.  The forms:

- ``full``: the body as K1 runs it;
- ``no-loads``: level 0 never loaded (the rings keep stale values, so the
  results are wrong; the work and the barriers stay);
- ``no-barriers``: the ring body without the barrier between two levels
  of a step, the register-streaming body without its step's barrier (a
  race: the results are wrong; the loads and the arithmetic stay);
- ``neither``: both taken out: the arithmetic, its shared-memory traffic
  and the output stores alone;
- ``generic``: the ring body's ``full`` form without its compiled tap
  layout (the taps' offsets read at run time, one load per tap and row,
  no value shared between taps): what register reuse saves.

The differences name what each part costs; ``neither`` against the
shared-memory accesses the arithmetic makes (ring body: under the star's
layout 5.5 loads and one store per element; register-streaming body: 2.5
loads and one store per element of an intermediate level, 32 lanes a
clock per SM at the card's clock) says how close the arithmetic runs to
that bound.  ``--sass`` counts, by opcode, the instructions of the
register-streaming body's step (the run between two barriers with the
most FMAs) in its ``full`` form.  The last line is one JSON object, with
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

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "bricklib_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k1_probe"

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.cuh"
template <class L>
__global__ void __launch_bounds__(512, 1)
k(const float* x, float* out, const int* table, StreamGeom g,
  SweepTaps taps) {
    extern __shared__ __align__(16) float smem[];
    stream_block<L>(x, out, table, g, taps, blockIdx.x, smem, nullptr);
}
template <class L>
float run(int blocks, int smem, const float* x, float* out, const int* tab,
          const StreamGeom& g, const SweepTaps& taps) {
    cudaFuncSetAttribute(k<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    k<L><<<blocks, 512, smem>>>(x, out, tab, g, taps);
    cudaDeviceSynchronize();
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    for (int r = 0; r < 10; ++r) k<L><<<blocks, 512, smem>>>(x, out, tab, g,
                                                             taps);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    return ms / 10;
}
int main(int argc, char** argv) {
    const int F = atoi(argv[1]), KCH = atoi(argv[2]), PJ = atoi(argv[3]);
    const int TI = atoi(argv[4]), D = atoi(argv[5]), SMEM = atoi(argv[6]);
    const int SKEW = atoi(argv[7]), H = atoi(argv[8]);
    const int BK = 8, BJ = 8, BI = 512, GK = 66, GJ = 66;
    const size_t nb = GK * GJ, n = nb * BK * BJ * BI;
    float *x, *out;
    int* tab;
    cudaMalloc(&x, n * 4);
    cudaMalloc(&out, n * 4);
    cudaMalloc(&tab, nb * 4);
    std::vector<int> t(nb);
    for (size_t i = 0; i < nb; ++i) t[i] = (int)i;
    cudaMemcpy(tab, t.data(), nb * 4, cudaMemcpyHostToDevice);
    cudaMemset(x, 0, n * 4);
    int offs[21] = {0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 1, 0, 0, -1, 0,
                    1, 0, 0, -1, 0, 0};
    float c[7] = {0.4f, .1f, .1f, .1f, .1f, .1f, .1f};
    const SweepTaps taps = sweep_taps(7, offs, c);
    const int K0 = 1, K1 = GK - 1, J0 = 1, J1 = GJ - 1;
    const int nchunk = (K1 - K0 + KCH - 1) / KCH;
    const int njg = (J1 - J0 + PJ - 1) / PJ, nit = BI / TI;
    StreamGeom g = {GK, GJ, BK, BJ, BI, K0, K1, KCH, nchunk, J0, J1, PJ,
                    njg, TI, nit, H, 4, D, F, 1, 1, 1, 1, 1, 1, 0, 0, 0,
                    0, 0, SKEW};
    const int blocks = nchunk * njg * nit;
    const float ms = atoi(argv[9])
        ? run<LayoutRuntime>(blocks, SMEM, x, out, tab, g, taps)
        : run<LayoutStar7>(blocks, SMEM, x, out, tab, g, taps);
    printf("%.4f %s\n", ms, cudaGetErrorString(cudaGetLastError()));
    return 0;
}
"""


HARNESS_RS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "body.cuh"
__global__ void __launch_bounds__(BT_RS_THREADS, 1)
k(const float* x, float* out, const int* table, RegGeom g, StarCoeffs cf) {
    extern __shared__ __align__(16) float smem[];
    regstream_block<PF, PRW>(x, out, table, g, cf, blockIdx.x, smem,
                             nullptr);
}
int main(int argc, char** argv) {
    const int F = atoi(argv[1]), KCH = atoi(argv[2]), PJ = atoi(argv[3]);
    const int TI = atoi(argv[4]), D = atoi(argv[5]), SMEM = atoi(argv[6]);
    const int NQ = atoi(argv[7]), H = atoi(argv[8]);
    if (F != PF) return 1;
    const int BK = 8, BJ = 8, BI = 512, GK = 66, GJ = 66;
    const size_t nb = GK * GJ, n = nb * BK * BJ * BI;
    float *x, *out;
    int* tab;
    cudaMalloc(&x, n * 4);
    cudaMalloc(&out, n * 4);
    cudaMalloc(&tab, nb * 4);
    std::vector<int> t(nb);
    for (size_t i = 0; i < nb; ++i) t[i] = (int)i;
    cudaMemcpy(tab, t.data(), nb * 4, cudaMemcpyHostToDevice);
    cudaMemset(x, 0, n * 4);
    StarCoeffs cf = {{0.4f, .1f, .1f, .1f, .1f, .1f, .1f}};
    const int K0 = 1, K1 = GK - 1, J0 = 1, J1 = GJ - 1;
    const int nchunk = (K1 - K0 + KCH - 1) / KCH;
    const int njg = (J1 - J0 + PJ - 1) / PJ, nit = BI / TI;
    RegGeom g = {GK, GJ, BK, BJ, BI, K0, K1, KCH, nchunk, J0, J1, PJ, njg,
                 TI, nit, H, 4, D, NQ, 0, 0, 0, 0, 0};
    const int blocks = nchunk * njg * nit;
    cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM);
    k<<<blocks, BT_RS_THREADS, SMEM>>>(x, out, tab, g, cf);
    cudaDeviceSynchronize();
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    for (int r = 0; r < 10; ++r)
        k<<<blocks, BT_RS_THREADS, SMEM>>>(x, out, tab, g, cf);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    printf("%.4f %s\n", ms / 10, cudaGetErrorString(cudaGetLastError()));
    return 0;
}
"""

# per body header: the line that starts level 0's issue, and the barrier
# the no-barriers form drops with what takes its place (the ring bodies':
# the one between two levels; the register-streaming bodies' (K1's and
# K4's): their step's)
ANCHORS = {
    header: ("    auto issue = [&](int q, int slot) {",
             f"        {wait}(g.D - 1);\n        __syncthreads();\n",
             f"        {wait}(g.D - 1);\n")
    for header, wait in (("pencil_regstream.cuh", "bt_cp_wait"),
                         ("pencil_regstream_4d.cuh", "rs4_cp_wait"))}
RING_ANCHORS = ("    auto issue = [&](int q, int qb) {",
                "                if (!((skw >> f) & 1)) __syncthreads();",
                "")


def variants(header: str = "pencil_stream.cuh") -> dict:
    """The four forms of a stream body (``header``: K1's two, or K4's
    ``pencil_stream_4d.cuh`` and ``pencil_regstream_4d.cuh``), each as the
    header's text."""
    base = re.sub(r'#include "(\w+\.cuh)"',
                  lambda m: f'#include "{CSRC / m.group(1)}"',
                  (CSRC / header).read_text())
    issue, barrier, instead = ANCHORS.get(header, RING_ANCHORS)
    for anchor in (issue, barrier):
        if anchor not in base:
            raise RuntimeError(f"{header} changed: no {anchor!r}")
    no_loads = issue + "\n        if (true) { bt_cp_commit(); return; }"
    return {"full": base,
            "no-loads": base.replace(issue, no_loads),
            "no-barriers": base.replace(barrier, instead),
            "neither": base.replace(issue, no_loads).replace(barrier,
                                                             instead)}


def probe(kernel: str, harness: str, header: str, args: list,
          out: Path, reps: int, edit=None, generic: bool = True) -> dict:
    """Build ``harness`` around each form of ``header``'s body (its text
    passed through ``edit`` where given), one nvcc each, all started
    together, into ``out``; run each form ``reps`` times with ``args``
    (and, with ``generic``, the ``full`` form without its tap layout); ms
    per launch of each run."""
    from bricklib_tpu_torch import _build

    out.mkdir(parents=True, exist_ok=True)
    (out / "harness.cu").write_text(harness)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in variants(header).items():
        d = out / name
        d.mkdir(exist_ok=True)
        (d / "body.cuh").write_text(edit(text) if edit else text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", f"-I{d}", "-o", str(d / "probe"), str(out / "harness.cu")],
            stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc {name}: {p.stderr.read()}")
    ms = {}
    forms = ([(name, name, "0") for name in procs]
             + [("generic", "full", "1")] * generic)
    for _ in range(reps):
        for name, prog, generic in forms:
            res = subprocess.run([str(out / prog / "probe"), *args, generic],
                                 capture_output=True, text=True, timeout=300,
                                 check=True).stdout.split()
            if res[1:] != ["no", "error"]:
                raise RuntimeError(f"{name}: {' '.join(res)}")
            ms.setdefault(name, []).append(float(res[0]))
            print(f"[{kernel} probe {name}] {res[0]} ms", flush=True)
    return ms


def step_ops(binary: Path) -> list:
    """Per run of the register-streaming body's instructions between two
    barriers with at least 32 FFMAs (its steps), the instruction count by
    opcode."""
    from bricklib_tpu_torch import _build

    sass = subprocess.run(
        [str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(binary)], capture_output=True, text=True, check=True,
        timeout=300).stdout
    kernel = next(f for f in sass.split("Function : ")
                  if f.startswith("_Z1k"))
    ops = [m.group(1).split(".")[0] for m in re.finditer(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
        kernel)]
    runs, cur = [], Counter()
    for op in ops:
        cur[op] += 1
        if op in ("BAR", "EXIT"):
            if cur["FFMA"] >= 32:
                runs.append(dict(cur.most_common()))
            cur = Counter()
    return runs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fuse", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--body", choices=("ring", "regstream", "both"),
                    default="both")
    ap.add_argument("--sass", action="store_true")
    a = ap.parse_args()
    from bricklib_tpu_torch.bench.k1_regimes import card
    from bricklib_tpu_torch.codegen.pencil_kernel import pencil_sweep
    from bricklib_tpu_torch.comm import BrickDecomp, skinlist_by_name
    from bricklib_tpu_torch.stencils import bench_params

    dec = BrickDecomp(dims=(512,) * 3, ghost_depth=(8, 8, 0),
                      bdims=(8, 8, 512)).initialize(
        skinlist_by_name("good", 3))
    fn = pencil_sweep("s7pt", dec.periodic_grid((0, 1, 2)), dec.bdims,
                      dec.nbricks, bench_params(), fuse=a.fuse)
    res = {"card": card(), "fuse": a.fuse}
    print(res["card"])
    if a.body in ("ring", "both"):
        sp = fn.plan.stream()
        args = [str(v) for v in (a.fuse, sp.kch, sp.pj, sp.ti, sp.d,
                                 sp.smem_bytes, sp.skew, sp.h)]
        res["footprint"] = {"kch": sp.kch, "pj": sp.pj, "ti": sp.ti,
                            "d": sp.d, "skew": sp.skew}
        res["ms"] = probe(f"k1 fuse={a.fuse}", HARNESS, "pencil_stream.cuh",
                          args, OUT, a.reps)
    rp = fn.plan.regstream()
    if a.body in ("regstream", "both") and rp is not None:
        args = [str(v) for v in (a.fuse, rp.kch, rp.pj, rp.ti, rp.d,
                                 rp.smem_bytes, rp.nq, rp.h)]
        res["regstream_footprint"] = {"kch": rp.kch, "pj": rp.pj,
                                      "ti": rp.ti, "rw": rp.rw, "nq": rp.nq,
                                      "d": rp.d}
        harness = f"#define PF {a.fuse}\n#define PRW {rp.rw}\n" + HARNESS_RS
        out = OUT / f"regstream_f{a.fuse}"
        res["regstream_ms"] = probe(
            f"k1 regstream fuse={a.fuse}", harness, "pencil_regstream.cuh",
            args, out, a.reps, generic=False)
        if a.sass:
            res["regstream_step_ops"] = step_ops(out / "full" / "probe")
            for run in res["regstream_step_ops"]:
                print(f"[k1 probe sass] step of {sum(run.values())} "
                      f"instructions: {run}", flush=True)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
