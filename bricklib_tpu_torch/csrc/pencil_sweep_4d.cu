// K4: the fused 4-D pencil sweep, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/pencil_kernel_4d.py:
// pallas_pencil_sweep_4d (f32, one linear input).
//
// What it computes.  Storage X[nb, BW, BK, BJ, BI] is read through the grid
// table T[GW, GK, GJ] (one pencil brick per (w, k, j) cell).  The rules are
// K1's with w treated like j.  Level 0 at element (ww, kk, jj, i) is
// X[T[clip(ww/BW), clip(kk/BK), clip(jj/BJ)], ww%BW, kk%BK, jj%BJ, i]:
// beyond the table, whole bricks clamp to the edge brick in w, k and j
// (this includes the w-halo slices of the w+-1 bricks).  Level f
// (1 <= f <= F) is the stencil applied to level f-1, periodic in i modulo
// BI, with no clamp in w or j.  After each intermediate level, k rows
// outside [0, GK*BK) are replaced by the clamped row of the same level at
// the same in-brick offset.  Level F is written to the bricks
// T[W0:W1, K0:K1, J0:J1] only; every other brick of `out` is left as it
// was.
//
// With a batch of B ranks stacked along the brick axis (a card's ranks of
// a mesh), rank s reads and writes the bricks of the same table with
// s * stride added to every brick id.
//
// What bounds it on the card.  As for K1: device-memory bytes in the end
// (a 9-point f32 sweep does 18 flops per 8 bytes), inside the SM the
// shared-memory accesses of the taps.  The first design (one block per 4-D
// tile grown by F radii on all four axes, each level computed over a tile
// that shrinks by one radius) loaded 6.75 level-0 elements and computed
// about 3.9 stencil evaluations of 9 loads each per output at the 4-D
// step's shape, held to 64 registers for two blocks per SM, and ran at 8%
// to 13% of its bound (PERF.md).
//
// What this design does about it (pencil_stream_4d.cuh says how).  A block
// streams a chunk of w bricks as a wavefront over the fused levels, each
// level a ring of planes (k rows x j rows x i lanes) in shared memory, so
// the w halo is loaded and computed once per chunk; streaming w, the
// intermediate levels' k clamp is a store within the plane being computed
// (no stash in device memory, no pre-roll).  Level 0 arrives by 16-byte
// cp.async D planes ahead of use; threads take fixed elements of each
// plane with no division, four k rows of a column each, and under the 4-D
// star's layout compiled in (tap_layouts.cuh, LayoutStar9) a value that
// several taps and rows read is one load kept in a register.  The planner
// (codegen/pencil_kernel_4d.py, stream_plan_4d) picks the footprint: w
// bricks per chunk, k brick rows and pencils per block, i tile, lookahead
// and skewed level boundaries.  Each output's sum keeps its tap order, as
// in the first design, so the two agree bit for bit.

#include "pencil_stream_4d.cuh"

// One block of 512 threads per SM (shared memory allows no more at the
// planner's footprints), so a thread may hold 128 registers.
template <class L>
__global__ void __launch_bounds__(BT_STREAM_THREADS, 1)
pencil_sweep_4d_kernel(const float* __restrict__ x, float* __restrict__ out,
                       const int* __restrict__ table, Stream4Geom g,
                       Sweep4Taps taps) {
    extern __shared__ __align__(16) float smem[];
    stream4_block<L>(x, out, table, g, taps, blockIdx.x, smem);
}

template <class L>
static cudaError_t launch4(int blocks, int threads, int smem_bytes,
                           cudaStream_t stream, const float* x, float* out,
                           const int* table, const Stream4Geom& g,
                           const Sweep4Taps& taps) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_4d_kernel<L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_4d_kernel<L><<<blocks, threads, smem_bytes, stream>>>(
        x, out, table, g, taps);
    return cudaGetLastError();
}

// Launch arguments: output w bricks [W0, W1) in chunks of WCH, k brick
// rows [K0, K1) PK and pencils [J0, J1) PJ per block, TI lanes, level-0
// margin H, piece PW (4 or 1 floats), D planes ahead; bit f of skew (1 <=
// f < F): levels f and f+1 skewed by a plane.  smem_bytes must hold the
// block's layout (stream4_smem_bytes), F radii stay within a brick on w, k
// and j, and a chunk's planes stay below BT_PLANE_SPAN; the taps' offsets
// pick the body (the 4-D star's layout if they equal it, else the generic
// one).
extern "C" int bt_pencil_sweep_4d(const void* x, void* out, const void* table,
                                  int GW, int GK, int GJ,
                                  int BW, int BK, int BJ, int BI,
                                  int W0, int W1, int K0, int K1,
                                  int J0, int J1, int F,
                                  int wlo, int whi, int klo, int khi,
                                  int jlo, int jhi, int ilo, int ihi,
                                  int batch, int stride, int WCH, int PK,
                                  int PJ, int TI, int H, int PW, int D,
                                  int skew, int ntaps,
                                  const int* tap_offsets,
                                  const float* tap_coeffs, int smem_bytes,
                                  int threads, void* stream) {
    if (ntaps < 1 || ntaps > BT4_MAX_TAPS || F < 1 || F > 30 || batch < 1
        || W1 <= W0 || K1 <= K0 || J1 <= J0 || WCH < 1 || PK < 1 || PJ < 1
        || TI < 1 || BI % TI || (PW != 1 && PW != 4) || BI % PW || TI % PW
        || H % PW || H < F * (ilo > ihi ? ilo : ihi) || (D != 1 && D != 2)
        || (skew & ~((1 << F) - 2)) || F * wlo > BW || F * whi > BW
        || F * klo > BK || F * khi > BK || F * jlo > BJ || F * jhi > BJ
        || (long long)BW * BK * BJ * BI > 0x7fffffffLL
        || threads < 32 || threads > BT_STREAM_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const int nwch = (W1 - W0 + WCH - 1) / WCH;
    const int nkg = (K1 - K0 + PK - 1) / PK;
    const int njg = (J1 - J0 + PJ - 1) / PJ, nit = BI / TI;
    Stream4Geom g = {GW, GK, GJ, BW, BK, BJ, BI, W0, W1, WCH, nwch,
                     K0, K1, PK, nkg, J0, J1, PJ, njg, TI, nit, H, PW, D, F,
                     wlo, whi, klo, khi, jlo, jhi, ilo, ihi,
                     (long long)stride, skew};
    const long long blocks = (long long)batch * nwch * nkg * njg * nit;
    // a chunk's planes, counted from its first w brick, stay below
    // BT_PLANE_SPAN (stream4_block's division-free ring slots and bricks)
    const long long span = (long long)(WCH + 2) * BW
                           + (long long)F * (wlo + whi + 1);
    if (blocks > 0x7fffffffLL || stream4_smem_bytes(g) > smem_bytes
        || span >= BT_PLANE_SPAN)
        return (int)cudaErrorInvalidValue;
    Sweep4Taps taps;
    taps.n = ntaps;
    for (int t = 0; t < ntaps; ++t) {
        taps.dw[t] = tap_offsets[4 * t];
        taps.dk[t] = tap_offsets[4 * t + 1];
        taps.dj[t] = tap_offsets[4 * t + 2];
        taps.di[t] = tap_offsets[4 * t + 3];
        taps.c[t] = tap_coeffs[t];
    }
    cudaStream_t st = (cudaStream_t)stream;
    const float* xf = (const float*)x;
    const int* tb = (const int*)table;
    if (layout4_matches<LayoutStar9>(taps))
        return (int)launch4<LayoutStar9>((int)blocks, threads, smem_bytes,
                                         st, xf, (float*)out, tb, g, taps);
    return (int)launch4<LayoutRuntime>((int)blocks, threads, smem_bytes, st,
                                       xf, (float*)out, tb, g, taps);
}
