// K4's register-streaming body: the fused 4-D pencil sweep of the 4-D
// 9-point star at F = 2 levels, written by hand for Hopper (sm_90a).
//
// It computes what pencil_sweep_4d.cu's kernel computes (the same
// semantics, bit for bit: pencil_sweep_4d.cu says what), for the launches
// the planner gives it (regstream_plan_4d in codegen/pencil_kernel_4d.py):
// the star's taps, F = 2, at most 8 output j rows a block and i tiles that
// fit the row width compiled in.  Every other launch keeps the ring body:
// at F = 3 and 4 the step's items fit the threads only in i tiles of 8 to
// 16 lanes, where this body ran 5% and 54% slower than the ring body
// (bench/k4_regimes.py), and no other shape of the port's paths needs
// them.
//
// Why a body of its own.  In the ring body (pencil_stream_4d.cuh) each
// fused level keeps a ring of planes in shared memory and every tap of
// every level is a shared load whose address is computed from run-time row
// widths: at the 4-D step's F = 2 an item of four k rows took 135 to 194
// instructions for 36 FMAs, and the loop was 89% of the sweep's time.
// Here (pencil_regstream_4d.cuh says how) the row widths are template
// arguments, so every in-plane tap is an immediate offset; a thread keeps
// its own column of every level in registers across the planes, so a
// level's w taps, centre and in-group k rows cost no load; each
// intermediate level keeps two shared planes and one barrier a step orders
// every level.  The two bodies want different data placement and
// footprints, so they share no loop and no planner.

#include "pencil_regstream_4d.cuh"

// One block of 768 threads an SM, a thread holding 80 registers: the
// planes of the block's footprint take most of an SM's shared memory; one
// item a thread and 24 warps ran the 4-D step's ghost-inclusive sweep 3%
// faster than 1,024 threads (64 registers) and 8% faster than 512 threads
// with two items each (bench/k4_probe.py).
template <int F, int RW>
__global__ void __launch_bounds__(BT4_RS_THREADS, 1)
pencil_sweep_regstream_4d_kernel(const float* __restrict__ x,
                                 float* __restrict__ out,
                                 const int* __restrict__ table, Reg4Geom g,
                                 Star9Coeffs cf) {
    extern __shared__ __align__(16) float smem[];
    regstream4_block<F, RW>(x, out, table, g, cf, blockIdx.x, smem);
}

// The depth and row width compiled in (RW: a plane's lanes, TI + 2H and
// up; codegen/pencil_kernel_4d.py's REGSTREAM4_FUSE and
// REGSTREAM4_ROW_WIDTHS).
#define BT4_RS_F 2
#define BT4_RS_RW 40

// Launch arguments as bt_pencil_sweep_4d's (pencil_sweep_4d.cu) without
// the radius (the star's, 1) and the skew (no barrier between levels); F:
// BT4_RS_F; RW: the compiled row width (TI + 2H <= RW), NQ: groups of k
// rows a plane holds (BT4_RS_ROWS NQ >= PK BK + 2F - 2); PJ BJ <=
// BT4_RS_WJ, and the items level 1 computes, NQ (PJ BJ + 2F - 2) (TI + 2F
// - 2), at most one a thread.  The taps must be the 4-D star's offsets, in
// its order.
extern "C" int bt_pencil_sweep_regstream_4d(
    const void* x, void* out, const void* table, int GW, int GK, int GJ,
    int BW, int BK, int BJ, int BI, int W0, int W1, int K0, int K1, int J0,
    int J1, int F, int batch, int stride, int WCH, int PK, int PJ, int TI,
    int RW, int NQ, int H, int PW, int D, int ntaps, const int* tap_offsets,
    const float* tap_coeffs, int smem_bytes, void* stream) {
    if (ntaps != LayoutStar9::N || F != BT4_RS_F || batch < 1 || W1 <= W0
        || K1 <= K0 || J1 <= J0 || WCH < 1 || PK < 1 || PJ < 1 || TI < 1
        || BI % TI || (PW != 1 && PW != 4) || BI % PW || TI % PW || H % PW
        || H < F || RW != BT4_RS_RW || TI + 2 * H > RW
        || PJ * BJ > BT4_RS_WJ || BT4_RS_ROWS * NQ < PK * BK + 2 * F - 2
        || (long long)NQ * (PJ * BJ + 2 * F - 2) * (TI + 2 * F - 2)
               > BT4_RS_THREADS
        || D < 1 || D > 3 || F > BW || F > BK || F > BJ
        || (long long)BW * BK * BJ * BI > 0x7fffffffLL)
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
    if (!layout4_matches<LayoutStar9>(taps))
        return (int)cudaErrorInvalidValue;
    Star9Coeffs cf;
    for (int t = 0; t < LayoutStar9::N; ++t) cf.c[t] = taps.c[t];
    const int nwch = (W1 - W0 + WCH - 1) / WCH;
    const int nkg = (K1 - K0 + PK - 1) / PK;
    const int njg = (J1 - J0 + PJ - 1) / PJ, nit = BI / TI;
    Reg4Geom g = {GW, GK, GJ, BW, BK, BJ, BI, W0, W1, WCH, nwch,
                  K0, K1, PK, nkg, J0, J1, PJ, njg, TI, nit, H, PW, D, NQ,
                  (long long)stride};
    const long long blocks = (long long)batch * nwch * nkg * njg * nit;
    // a chunk's planes, counted from its first w brick, stay below
    // BT_PLANE_SPAN (the division-free w bricks)
    const long long span = (long long)(WCH + 2) * BW + 3LL * F;
    if (blocks > 0x7fffffffLL || rs4_smem_bytes(g, F, RW) > smem_bytes
        || span >= BT_PLANE_SPAN)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_regstream_4d_kernel<BT4_RS_F, BT4_RS_RW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    cudaStream_t st = (cudaStream_t)stream;
    pencil_sweep_regstream_4d_kernel<BT4_RS_F, BT4_RS_RW>
        <<<(int)blocks, BT4_RS_THREADS, smem_bytes, st>>>(
            (const float*)x, (float*)out, (const int*)table, g, cf);
    return (int)cudaGetLastError();
}
