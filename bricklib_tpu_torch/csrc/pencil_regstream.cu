// K1's register-streaming body: the fused pencil sweep of the 7-point star
// at F = 2 to 4 levels, written by hand for Hopper (sm_90a).
//
// It computes what pencil_sweep.cu's kernel computes (the same semantics,
// bit for bit: pencil_sweep.cu says what), for the launches the planner
// gives it (SweepPlan.regstream in codegen/pencil_kernel.py): star taps
// and 2 <= F <= 4, on the pencil layout or an i-bricked table (a
// compile-time choice, as in the ring body).  Every other launch keeps
// the ring body.
//
// Why a body of its own.  In the ring body (pencil_stream.cuh) each fused
// level keeps a ring of planes in shared memory and every tap of every
// level is a shared load: at F = 4 the block's loop ran at about a third
// of its issue rate, latency-bound behind two barriers a step and the
// address arithmetic of a run-time row width, so a fused level cost about
// as much as a pass through device memory.  Here (pencil_regstream.cuh
// says how) a thread keeps its own column of every level in registers
// across the planes, so a level's k taps and its quad's own rows cost no
// load, each intermediate level keeps two shared planes, one barrier a
// step orders every level, and the row width is a template argument: every
// in-plane tap is an immediate offset.  The two bodies want different
// data placement and footprints, so they share no loop and no planner.

#include "pencil_regstream.cuh"

// One block of 512 threads an SM: the registers of every level's last two
// planes of two items a thread take more than 64 a thread.
template <int F, int RW, bool IB>
__global__ void __launch_bounds__(BT_RS_THREADS, 1)
pencil_sweep_regstream_kernel(const float* __restrict__ x,
                              float* __restrict__ out,
                              const int* __restrict__ table, float* stash,
                              RegGeom g, StarCoeffs cf, IBrickGeom ib) {
    extern __shared__ __align__(16) float smem[];
    regstream_block<F, RW, IB>(x, out, table, g, cf, blockIdx.x, smem,
                               stash, ib);
}

template <int F, int RW, bool IB>
static cudaError_t launch_rs_ib(int blocks, int smem_bytes,
                                cudaStream_t stream, const float* x,
                                float* out, const int* table, float* stash,
                                const RegGeom& g, const StarCoeffs& cf,
                                const IBrickGeom& ib) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_regstream_kernel<F, RW, IB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_regstream_kernel<F, RW, IB>
        <<<blocks, BT_RS_THREADS, smem_bytes, stream>>>(x, out, table, stash,
                                                        g, cf, ib);
    return cudaGetLastError();
}

template <int F, int RW>
static cudaError_t launch_rs(int blocks, int smem_bytes, cudaStream_t stream,
                             const float* x, float* out, const int* table,
                             float* stash, const RegGeom& g,
                             const StarCoeffs& cf, const IBrickGeom& ib) {
    if (ib.GI > 0)
        return launch_rs_ib<F, RW, true>(blocks, smem_bytes, stream, x, out,
                                         table, stash, g, cf, ib);
    return launch_rs_ib<F, RW, false>(blocks, smem_bytes, stream, x, out,
                                      table, stash, g, cf, ib);
}

template <int RW>
static cudaError_t launch_rw(int F, int blocks, int smem_bytes,
                             cudaStream_t st, const float* x, float* out,
                             const int* tb, float* sf, const RegGeom& g,
                             const StarCoeffs& cf, const IBrickGeom& ib) {
    if (F == 2)
        return launch_rs<2, RW>(blocks, smem_bytes, st, x, out, tb, sf, g,
                                cf, ib);
    if (F == 3)
        return launch_rs<3, RW>(blocks, smem_bytes, st, x, out, tb, sf, g,
                                cf, ib);
    return launch_rs<4, RW>(blocks, smem_bytes, st, x, out, tb, sf, g, cf,
                            ib);
}

// The row widths compiled in (RW: a level plane's columns, TI + 2H and
// up; codegen/pencil_kernel.py's REGSTREAM_ROW_WIDTHS).
static inline bool rs_row_width(int RW) {
    return RW == 40 || RW == 72 || RW == 80;
}

// Launch arguments as bt_pencil_sweep's (pencil_sweep.cu, the i-bricked
// table's GI, I0, I1 too), without the
// radius (the star's, 1) and the skew (no barrier between levels); RW: the
// compiled row width (TI + 2H <= RW), NQ: quads of rows a plane holds (4 NQ
// >= PJ BJ + 2F; NQ RW items at most, BT_RS_ITEMS a thread).  Each edge's
// stash must hold rs_stash_floats(F) floats a block; the taps must be the
// star's offsets, in its order.
extern "C" int bt_pencil_sweep_regstream(
    const void* x, void* out, const void* table, void* stash, int GK, int GJ,
    int BK, int BJ, int BI, int K0, int K1, int J0, int J1, int GI, int I0,
    int I1, int F, int batch,
    int stride, int KCH, int PJ, int TI, int RW, int NQ, int H, int PW, int D,
    int edge_lo, int edge_hi, int stash_lo, int stash_hi, int ntaps,
    const int* tap_offsets, const float* tap_coeffs, int smem_bytes,
    void* stream) {
    const int nrows = K1 - K0, npen = J1 - J0;
    if (GI < 0 || (GI > 0 && (I0 < 0 || I0 >= I1 || I1 > GI))
        || (GI == 0 && BI % TI))
        return (int)cudaErrorInvalidValue;
    if (ntaps != LayoutStar7::N || F < 2 || F > 4 || batch < 1 || npen < 1
        || nrows < 1 || KCH < 1 || PJ < 1 || TI < 1
        || (PW != 1 && PW != 4) || BI % PW || TI % PW || H % PW || H < F
        || !rs_row_width(RW) || TI + 2 * H > RW
        || 4 * NQ < PJ * BJ + 2 * F
        || NQ * RW > BT_RS_THREADS * BT_RS_ITEMS || (D != 1 && D != 2)
        || F > BK || F > BJ || ((edge_lo || edge_hi) && GK < 2)
        || (edge_lo && stash_lo < rs_stash_floats(F))
        || (edge_hi && stash_hi < rs_stash_floats(F))
        || stash_lo < 0 || stash_hi < 0
        || ((stash_lo || stash_hi) && stash == nullptr))
        return (int)cudaErrorInvalidValue;
    const SweepTaps taps = sweep_taps(ntaps, tap_offsets, tap_coeffs);
    if (!layout_matches<LayoutStar7>(taps))
        return (int)cudaErrorInvalidValue;
    StarCoeffs cf;
    for (int t = 0; t < LayoutStar7::N; ++t) cf.c[t] = taps.c[t];
    const int nchunk = (nrows + KCH - 1) / KCH;
    const int lanes = GI > 0 ? (I1 - I0) * BI : BI;
    const int njg = (npen + PJ - 1) / PJ, nit = (lanes + TI - 1) / TI;
    RegGeom g = {GK, GJ, BK, BJ, BI, K0, K1, KCH, nchunk, J0, J1,
                 PJ, njg, TI, nit, H, PW, D, NQ, (long long)stride,
                 edge_lo, edge_hi, stash_lo, stash_hi};
    const IBrickGeom ib = {GI, I0 * BI, I1 * BI};
    const long long blocks = (long long)batch * nchunk * njg * nit;
    // a chunk's planes, counted from its first brick row, stay below
    // BT_PLANE_SPAN (the division-free brick rows)
    const long long span = (long long)(KCH + 2) * BK + 3LL * F;
    if (blocks > 0x7fffffffLL || rs_smem_bytes(g, F, RW, ib) > smem_bytes
        || span >= BT_PLANE_SPAN)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float* xf = (const float*)x;
    const int* tb = (const int*)table;
    float* sf = (float*)stash;
    float* of = (float*)out;
    if (RW == 40)
        return (int)launch_rw<40>(F, (int)blocks, smem_bytes, st, xf, of, tb,
                                  sf, g, cf, ib);
    if (RW == 72)
        return (int)launch_rw<72>(F, (int)blocks, smem_bytes, st, xf, of, tb,
                                  sf, g, cf, ib);
    return (int)launch_rw<80>(F, (int)blocks, smem_bytes, st, xf, of, tb, sf,
                              g, cf, ib);
}
