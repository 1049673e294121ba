// K1: the fused pencil sweep, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/pencil_kernel.py:
// pallas_pencil_sweep (pencil layout, GI == 1, f32, one linear input).
//
// What it computes.  Storage X[nb, BK, BJ, BI] is read through the grid
// table T[GK, GJ] (one pencil brick per (k, j) cell).  Level 0 at element
// (kk, jj, i) is X[T[clip(kk/BK), clip(jj/BJ)], kk%BK, jj%BJ, i]: out-of-
// table rows and pencils clamp to the edge brick, whole bricks at a time.
// Level f (1 <= f <= F) is the stencil applied to level f-1, periodic in i
// modulo BI, with no clamp in j.  After each intermediate level, rows
// outside [0, GK*BK) are replaced by the clamped row of the same level at
// the same in-brick offset.  Level F is written to the bricks
// T[K0:K1, J0:J1] only; every other brick of `out` is left untouched.
// With a batch of B subdomains (the strong-scaling stack), subdomain s
// reads and writes through the same table with s * stride added to every
// brick id: one more grid dimension, folded into blockIdx.z.
//
// What bounds it on the card.  Device-memory bytes, in the end: an f32
// 7-point sweep does 14 flops per 8 bytes moved, far below the ~20
// flops/byte at which the H100's f32 units would bound it, and F fused
// levels carry F stencil iterations per pass over device memory.  In this
// first design the recomputed halo and the shared-memory work per element
// bound it well before the bytes do (PERF.md).
//
// What the design does about it.  One block owns one output brick row,
// one output pencil and TI lanes of i, loads its level-0 tile once and
// computes every level in shared memory (pencil_sweep.cuh says how).  The
// price is the halo: neighbouring blocks load overlapping level-0 tiles
// (mostly from L2) and recompute the overlapping parts of each level.  A streaming k loop, TMA and register
// blocking are left for later work.

#include "pencil_sweep.cuh"

// One block per (subdomain and output brick row, output pencil, i tile):
// the body is sweep_block (pencil_sweep.cuh), which K11 shares.
template <int NT>
__global__ void pencil_sweep_kernel(const float* __restrict__ x,
                                    float* __restrict__ out,
                                    const int* __restrict__ table,
                                    SweepGeom g, SweepTaps taps) {
    extern __shared__ float smem[];
    const int sub = blockIdx.z / g.KC;
    const int kout = g.K0 + (blockIdx.z - sub * g.KC);
    sweep_block<NT, false>(x, out, table, g, taps, sub, kout,
                           g.J0 + blockIdx.y, blockIdx.x * g.TI, smem);
}

template <int NT>
static cudaError_t launch(dim3 grid, int threads, int smem_bytes,
                          cudaStream_t stream, const float* x, float* out,
                          const int* table, const SweepGeom& g,
                          const SweepTaps& taps) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_kernel<NT><<<grid, threads, smem_bytes, stream>>>(
        x, out, table, g, taps);
    return cudaGetLastError();
}

extern "C" int bt_pencil_sweep(const void* x, void* out, const void* table,
                               int GK, int GJ, int BK, int BJ, int BI,
                               int K0, int K1, int J0, int J1, int F,
                               int klo, int khi, int jlo, int jhi,
                               int ilo, int ihi, int TI,
                               int batch, int stride, int ntaps,
                               const int* tap_offsets,
                               const float* tap_coeffs, int smem_bytes,
                               int threads, void* stream) {
    if (ntaps < 1 || ntaps > BT_MAX_TAPS || F < 1 || TI < 1 || BI % TI
        || batch < 1 || batch * (K1 - K0) > 65535)
        return (int)cudaErrorInvalidValue;
    SweepGeom g = {GK, GJ, BK, BJ, BI, K0, J0, K1 - K0, (long long)stride,
                   F, klo, khi, jlo, jhi, ilo, ihi, TI};
    const SweepTaps taps = sweep_taps(ntaps, tap_offsets, tap_coeffs);
    dim3 grid(BI / TI, J1 - J0, batch * (K1 - K0));
    cudaStream_t st = (cudaStream_t)stream;
    const float* xf = (const float*)x;
    const int* tb = (const int*)table;
    if (ntaps == 7)
        return (int)launch<7>(grid, threads, smem_bytes, st, xf,
                              (float*)out, tb, g, taps);
    return (int)launch<0>(grid, threads, smem_bytes, st, xf, (float*)out,
                          tb, g, taps);
}
