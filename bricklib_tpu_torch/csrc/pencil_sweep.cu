// K1: the fused pencil sweep, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/pencil_kernel.py:
// pallas_pencil_sweep (f32, one linear input; the pencil layout, GI == 1,
// and i-bricked tables, GI > 1).
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
// brick id.
//
// An i-bricked table T[GK, GJ, GI] (cubic subdomains) has bricks of BI
// lanes in i too: level 0 at lane i reads brick column clip(i/BI) at lane
// i%BI, as in k and j; the levels shrink in i with no clamp, as in j, and
// nothing wraps; level F is written to the brick columns [I0, I1).  The
// block bodies take it as a compile-time choice (IB): a level-0 piece
// then reads the brick column of its lanes through the block's brick
// table, which keeps a row's brick columns per (brick row, pencil), and
// an output lane goes to its brick column's offset, one per output row
// and column; i tiles start at lane I0*BI, and the last may end past
// I1*BI (its lanes there are computed and not written).  The pencil
// layout compiles to the code it had.
//
// What bounds it on the card.  Device-memory bytes, in the end: an f32
// 7-point sweep does 14 flops per 8 bytes moved, far below the ~20
// flops/byte at which the H100's f32 units would bound it, and F fused
// levels carry F stencil iterations per pass over device memory.  Inside
// the SM the limit is shared memory: every tap of every level is one
// shared-memory load (7 per element at 7 points, 125 at 125), so what a
// design recomputes or reloads costs shared-memory cycles first.  The
// first design (one block per output brick row, the level-0 tile grown by
// F radii on every side, tiles shrinking per level) recomputed 2.2 times
// the useful work at fuse=4, half of it the k halo, and ran at 6.6% of its
// bound (PERF.md).
//
// What this design does about it (pencil_stream.cuh says how).  A block
// streams a chunk of brick rows in k as a wavefront over the fused levels,
// each level a ring of planes in shared memory, so the k halo is loaded and
// computed once per chunk; it takes several pencils in j and as wide an i
// tile as shared memory allows (up to 227 KB a block, 512 threads; the
// planner, SweepPlan.stream in codegen/pencil_kernel.py, trades the
// footprint against occupancy and the grid's fill of 132 SMs); level 0
// arrives by 16-byte cp.async D planes ahead of use; threads take fixed
// elements of each plane with no division, four rows of a column each,
// and under a tap layout compiled in (tap_layouts.cuh: the 7-point star,
// the 125-point cube; the coefficients stay parameters) a value that
// several taps and rows read is one load kept in a register: the star
// reads 22 values per 4 outputs instead of 28, the cube 200 instead of
// 500.  Each output's sum keeps its tap order.
//
// The table's k edges.  Where K0 == 0 (or K1 == GK), the intermediate
// levels' k clamp replaces a plane below (above) the table by the plane
// BK higher (lower): a k-increasing stream has not computed the first yet,
// and the second has left its ring.  The blocks whose chunk reaches an edge
// keep those source planes in a stash in device memory, a pre-roll over
// the first brick row computing the low ones first (pencil_stream.cuh).
// So every brick row streams.  K11 (fused_exchange.cu) runs the same
// block body at F = 1 for its sweep.

#include "pencil_stream.cuh"

// One block of 512 threads per SM at most (shared memory allows no more
// at the planner's footprints), so a thread may hold 128 registers.
template <class L, bool IB>
__global__ void __launch_bounds__(BT_STREAM_THREADS, 1)
pencil_sweep_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const int* __restrict__ table, float* stash,
                    StreamGeom g, SweepTaps taps, IBrickGeom ib) {
    extern __shared__ __align__(16) float smem[];
    stream_block<L, false, IB>(x, out, table, g, taps, blockIdx.x, smem,
                               stash, ib);
}

template <class L, bool IB>
static cudaError_t launch_ib(int blocks, int threads, int smem_bytes,
                             cudaStream_t stream, const float* x, float* out,
                             const int* table, float* stash,
                             const StreamGeom& g, const SweepTaps& taps,
                             const IBrickGeom& ib) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_kernel<L, IB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_kernel<L, IB><<<blocks, threads, smem_bytes, stream>>>(
        x, out, table, stash, g, taps, ib);
    return cudaGetLastError();
}

template <class L>
static cudaError_t launch(int blocks, int threads, int smem_bytes,
                          cudaStream_t stream, const float* x, float* out,
                          const int* table, float* stash,
                          const StreamGeom& g, const SweepTaps& taps,
                          const IBrickGeom& ib) {
    if (ib.GI > 0)
        return launch_ib<L, true>(blocks, threads, smem_bytes, stream, x,
                                  out, table, stash, g, taps, ib);
    return launch_ib<L, false>(blocks, threads, smem_bytes, stream, x, out,
                               table, stash, g, taps, ib);
}

// Launch arguments: output brick rows [K0, K1) in chunks of KCH, PJ
// pencils per block; GI > 0: the table is [GK, GJ, GI] and the output
// brick columns [I0, I1) (GI = 0: the pencil layout, table [GK, GJ]); TI
// lanes, level-0 margin H, piece PW (4 or 1 floats),
// D planes ahead; edge_lo / edge_hi: the first / last chunk reaches below
// / above the table, and each block keeps stash_lo / stash_hi floats of
// `stash` for it (batch x pencil groups x i tiles blocks' worth); bit f of
// skew (1 <= f < F): levels f and f+1 skewed by a plane.  smem_bytes must
// hold the block's layout (stream_smem_bytes), and a chunk's planes stay
// below BT_PLANE_SPAN; the taps' offsets pick the body (a compiled tap
// layout they equal, else the generic one).
extern "C" int bt_pencil_sweep(const void* x, void* out, const void* table,
                               void* stash, int GK, int GJ, int BK, int BJ,
                               int BI, int K0, int K1, int J0, int J1,
                               int GI, int I0, int I1, int F,
                               int klo, int khi, int jlo, int jhi,
                               int ilo, int ihi, int batch, int stride,
                               int KCH, int PJ, int TI, int H, int PW, int D,
                               int edge_lo, int edge_hi, int stash_lo,
                               int stash_hi, int skew, int ntaps,
                               const int* tap_offsets,
                               const float* tap_coeffs, int smem_bytes,
                               int threads, void* stream) {
    const int nrows = K1 - K0, npen = J1 - J0;
    if (GI < 0 || (GI > 0 && (I0 < 0 || I0 >= I1 || I1 > GI))
        || (GI == 0 && BI % TI))
        return (int)cudaErrorInvalidValue;
    if (ntaps < 1 || ntaps > BT_MAX_TAPS || F < 1 || batch < 1
        || npen < 1 || nrows < 1 || KCH < 1 || PJ < 1 || TI < 1
        || (PW != 1 && PW != 4) || BI % PW || TI % PW || H % PW
        || H < F * (ilo > ihi ? ilo : ihi)
        || (D != 1 && D != 2) || stash_lo < 0 || stash_hi < 0
        || F > 30 || (skew & ~((1 << F) - 2))
        || ((stash_lo || stash_hi) && stash == nullptr)
        || ((edge_lo || edge_hi) && F > 1 && GK < 2)
        || threads < 32 || threads > BT_STREAM_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const int nchunk = (nrows + KCH - 1) / KCH;
    const int lanes = GI > 0 ? (I1 - I0) * BI : BI;
    const int njg = (npen + PJ - 1) / PJ, nit = (lanes + TI - 1) / TI;
    StreamGeom g = {GK, GJ, BK, BJ, BI, K0, K1, KCH, nchunk, J0, J1,
                    PJ, njg, TI, nit, H, PW, D, F, klo, khi, jlo, jhi,
                    ilo, ihi, (long long)stride, edge_lo, edge_hi, stash_lo,
                    stash_hi, skew};
    const IBrickGeom ib = {GI, I0 * BI, I1 * BI};
    const long long blocks = (long long)batch * nchunk * njg * nit;
    // a chunk's planes, counted from its first brick row, stay below
    // BT_PLANE_SPAN (stream_block's division-free ring slots and rows)
    const long long span = (long long)(KCH + 2) * BK
                           + (long long)F * (klo + khi + 1);
    if (blocks > 0x7fffffffLL || stream_smem_bytes(g, ib) > smem_bytes
        || span >= BT_PLANE_SPAN)
        return (int)cudaErrorInvalidValue;
    const SweepTaps taps = sweep_taps(ntaps, tap_offsets, tap_coeffs);
    cudaStream_t st = (cudaStream_t)stream;
    const float* xf = (const float*)x;
    const int* tb = (const int*)table;
    float* sf = (float*)stash;
    if (layout_matches<LayoutStar7>(taps))
        return (int)launch<LayoutStar7>((int)blocks, threads, smem_bytes, st,
                                        xf, (float*)out, tb, sf, g, taps,
                                        ib);
    if (layout_matches<LayoutCube125>(taps))
        return (int)launch<LayoutCube125>((int)blocks, threads, smem_bytes,
                                          st, xf, (float*)out, tb, sf, g,
                                          taps, ib);
    return (int)launch<LayoutRuntime>((int)blocks, threads, smem_bytes, st,
                                      xf, (float*)out, tb, sf, g, taps, ib);
}
