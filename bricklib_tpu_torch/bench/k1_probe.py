"""What bounds kernel K1: its stream body timed with parts taken out.

    python -m bricklib_tpu_torch.bench.k1_probe [--fuse 4] [--reps 2]

Builds, into ``build/k1_probe/``, a standalone program around K1's block
body (``csrc/pencil_stream.cuh``) in four forms, runs the first also
without its tap layout, and times each (CUDA events, 10 launches after
one) on the periodic 512^3 s7pt sweep at the planner's footprint:

- ``full``: the body as K1 runs it;
- ``no-loads``: level 0 never loaded (the rings keep stale values, so the
  results are wrong; the work and the barriers stay);
- ``no-barriers``: no barrier between two levels of a step (a race: the
  results are wrong; the loads and the arithmetic stay);
- ``neither``: both taken out: the arithmetic, its shared-memory traffic
  and the output stores alone;
- ``generic``: the ``full`` body without its compiled tap layout (the
  taps' offsets read at run time, one load per tap and row, no value
  shared between taps): what register reuse saves.

The differences name what each part costs; ``neither`` against the
shared-memory accesses the arithmetic makes (under the star's layout 5.5
loads and one store per element, 32 lanes a clock per SM at the card's
clock) says how close the arithmetic runs to that bound.  The last line is one JSON object, with
the card's name and power limit.  Only a measurement: no path of the port
runs these forms.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
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


def variants(header: str = "pencil_stream.cuh") -> dict:
    """The four forms of a stream body (``header``: K1's, or K4's
    ``pencil_stream_4d.cuh``), each as the header's text."""
    base = re.sub(r'#include "(\w+\.cuh)"',
                  lambda m: f'#include "{CSRC / m.group(1)}"',
                  (CSRC / header).read_text())
    issue = "    auto issue = [&](int q, int qb) {"
    barrier = "                if (!((skw >> f) & 1)) __syncthreads();"
    for anchor in (issue, barrier):
        if anchor not in base:
            raise RuntimeError(f"{header} changed: no {anchor!r}")
    no_loads = issue + "\n        if (true) { bt_cp_commit(); return; }"
    return {"full": base,
            "no-loads": base.replace(issue, no_loads),
            "no-barriers": base.replace(barrier, ""),
            "neither": base.replace(issue, no_loads).replace(barrier, "")}


def probe(kernel: str, harness: str, header: str, args: list,
          out: Path, reps: int, edit=None) -> dict:
    """Build ``harness`` around each form of ``header``'s body (its text
    passed through ``edit`` where given), one nvcc each, all started
    together, into ``out``; run each form ``reps`` times with ``args``
    (and the ``full`` form without its tap layout, as ``generic``); ms
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
    forms = [(name, name, "0") for name in procs] + [("generic", "full", "1")]
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fuse", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
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
    sp = fn.plan.stream()
    args = [str(v) for v in (a.fuse, sp.kch, sp.pj, sp.ti, sp.d,
                             sp.smem_bytes, sp.skew, sp.h)]
    res = {"card": card(), "fuse": a.fuse,
           "footprint": {"kch": sp.kch, "pj": sp.pj, "ti": sp.ti, "d": sp.d,
                         "skew": sp.skew}}
    print(res["card"])
    res["ms"] = probe(f"k1 fuse={a.fuse}", HARNESS, "pencil_stream.cuh",
                      args, OUT, a.reps)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
