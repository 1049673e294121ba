// K8: the flat-pencil factorized sweep, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/mxu_kernel.py:
// pallas_pencil_sweep_mxu (3-D, f32, one linear input, fuse 1, GI == 1).
//
// What it computes.  Storage X[nb, BK, BJ*BI] (flat pencils: each brick's
// (j, i) plane is one row of BJ*BI floats, the element order of [nb, BK,
// BJ, BI]) is read through the table T[GK, GJ].  Output brick (k, j) for k
// in [K0, K1), j in [J0, J1) reads the rows r + dk of brick rows k-1, k,
// k+1 and the j positions jj + dj of pencils j-1, j, j+1, each brick row
// and pencil clamped to the table edge (the TPU kernel's _clip), and i
// periodic within the brick's BI lanes.  The stencil comes folded as
// ir.fold_linear gives it:
//   W_w[r, jp, i] = sum_dk c_w[dk] * slab[r + dk, jp, i]   (nW k-profiles)
//   V_d[r, jj, i] = sum over terms (dj, w) of d: W_w[r, jj + dj, i]
//   out[r, jj, i] = sum over the distinct di: V_d[r, jj, (i + di) mod BI]
// which is the TPU kernel's A_prev/A_cur/A_next contraction (W), its lane
// slices at multiples of BI (V) and its roll pair per BI block (out).  The
// result equals kernel K1 at fuse 1 on the same table.  Every brick outside
// T[K0:K1, J0:J1] of `out` is left untouched.
//
// What bounds it on the card.  Device-memory bytes: each owned brick read
// once and written once.  The factorized form needs about 90 f32
// operations per output for the 125-point stencil (6 k-profiles of 30
// k-taps, then 25 V terms and 5 i terms), 12 GFLOP at 512^3 against 1.07
// GB moved: 0.18 ms of f32 work against 0.32 ms of bytes at 3.35 TB/s.
// Inside the SM the limit is instruction issue: the profiles over a j
// window wider than the output and the V and i sums take some 100
// instructions per output.
//
// What the design does about it (mxu_stream.cuh says how).  The TPU kernel
// spends the matrix unit on the W stage because the unit is otherwise idle
// there; on this card the contraction has 5 non-zero slot-matrix entries per
// row out of 24, so fp32-faithful tensor-core products (3xTF32) would do
// some 14 times the FMA work on units some 7 times faster: the W stage is
// FMAs over the non-zero entries.  The first design (one block per output
// brick, its whole slab staged as one 4-byte copy per element, W written
// to and V and i read back from shared memory, about 40 shared accesses
// per output) ran at 8% of its bound.  This one streams k: a block owns a
// chunk of brick rows, a group of pencils and a tile of i, and walks the
// chunk's k rows with level 0 in a ring of planes that 16-byte cp.async
// fills two planes ahead, so the k halo is loaded once per chunk.  Under
// the compiled layout of mpi125pt's folded form, a warp computes W and V
// in registers for a strip of 8 j rows and 32 lanes, and the i stage takes
// its neighbours' V by shuffles: a level-0 value is read once per k tap
// and row (7.5 shared loads per output), V never touches shared memory,
// and each step has one barrier; its profiles, even in dk, sum the planes
// at -dk and +dk once for all six.  Other folded stencils run the generic
// body (W through shared memory, the folded form read at run time), whose
// sums keep the first design's order, so its result is bit for bit the
// same; the compiled layout's differs from it in the rounding of W alone.

#include "mxu_stream.cuh"

template <class L>
__global__ void __launch_bounds__(MX_MAX_THREADS, 1)
pencil_sweep_mxu_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const int* __restrict__ table, MxuGeom g,
                        MxuTaps taps) {
    extern __shared__ __align__(16) float smem[];
    mxu_block<L>(x, out, table, g, taps, blockIdx.x, smem);
}

template <class L>
static cudaError_t k8_launch(int blocks, int threads, int smem_bytes,
                             cudaStream_t stream, const float* x, float* out,
                             const int* table, const MxuGeom& g,
                             const MxuTaps& t) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_mxu_kernel<L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_mxu_kernel<L><<<blocks, threads, smem_bytes, stream>>>(
        x, out, table, g, t);
    return cudaGetLastError();
}

// Launch arguments: output brick rows [K0, K1) in chunks of KCH, PJ pencils
// per block, nwc lane chunks (of 32 - ilo - ihi output lanes each) per
// strip of 8 j rows, level-0 margin H, piece PW (4 or 1 floats), D planes
// ahead.  coef: nW * (2*rk + 1) floats; di, dtup: ndi offsets and their
// tuples; tbeg: ntup + 1 term bounds; tdj, tw: per term.  smem_bytes must
// hold the block's layout (mxu_smem_bytes) and threads must be one warp
// per (strip, lane chunk); the folded form picks the body (the compiled
// layout it equals, else the generic one).
extern "C" int bt_pencil_sweep_mxu(
    const void* x, void* out, const void* table, int GK, int GJ, int BK,
    int BJ, int BI, int K0, int K1, int J0, int J1, int klo, int khi,
    int jlo, int jhi, int ilo, int ihi, int KCH, int PJ, int nwc, int H,
    int PW, int D, int rk, int nW, const float* coef, int ndi, const int* di,
    const int* dtup, int ntup, const int* tbeg, const int* tdj,
    const int* tw, int smem_bytes, int threads, void* stream) {
    const int OW = 32 - ilo - ihi, TI = nwc * OW;
    const int nrows = K1 - K0, npen = J1 - J0;
    if (nW < 1 || nW > K8_MAX_W || ndi < 1 || ndi > K8_MAX_DI || ntup < 1
        || ntup > ndi || rk < 1 || rk > K8_MAX_RK || klo > rk || khi > rk
        || klo > BK || khi > BK || jlo > BJ || jhi > BJ || OW < 1
        || ilo > H || ihi > H || nrows < 1 || npen < 1 || KCH < 1
        || PJ < 1 || nwc < 1 || (PW != 1 && PW != 4) || BI % PW || H % PW
        || TI % PW || (D != 1 && D != 2) || tbeg[0] != 0
        || tbeg[ntup] > K8_MAX_TERMS
        || threads > MX_MAX_THREADS)
        return (int)cudaErrorInvalidValue;
    MxuTaps t = {};
    t.nW = nW;
    t.ndi = ndi;
    t.ntup = ntup;
    for (int q = 0; q < nW * (2 * rk + 1); ++q) t.c[q] = coef[q];
    for (int d = 0; d < ndi; ++d) {
        if (dtup[d] < 0 || dtup[d] >= ntup || di[d] < -ilo || di[d] > ihi)
            return (int)cudaErrorInvalidValue;
        t.di[d] = di[d];
        t.dtup[d] = dtup[d];
    }
    for (int u = 0; u <= ntup; ++u) t.tbeg[u] = tbeg[u];
    for (int q = 0; q < tbeg[ntup]; ++q) {
        if (tw[q] < 0 || tw[q] >= nW || tdj[q] < -jlo || tdj[q] > jhi)
            return (int)cudaErrorInvalidValue;
        t.tdj[q] = tdj[q];
        t.tw[q] = tw[q];
    }
    // the generic body's W-buffer offset of each term (rows of RW floats,
    // planes of rows x RW)
    const int rw = TI + 2 * H, ps = (PJ * BJ + jlo + jhi) * rw;
    for (int q = 0; q < tbeg[ntup]; ++q)
        t.toff[q] = t.tw[q] * ps + (jlo + t.tdj[q]) * rw;
    const int nchunk = (nrows + KCH - 1) / KCH;
    const int njg = (npen + PJ - 1) / PJ, nit = (BI + TI - 1) / TI;
    MxuGeom g = {GK, GJ, BK, BJ, BI, K0, K1, KCH, nchunk, J0, J1, PJ, njg,
                 TI, nit, nwc, OW, H, PW, D, klo, khi, jlo, jhi, ilo, ihi};
    const long long blocks = (long long)nchunk * njg * nit;
    // a chunk's planes, counted from its first brick row, stay below
    // BT_PLANE_SPAN (the division-free ring slots and brick rows)
    const long long span = (long long)(KCH + 2) * BK + klo + khi + 1;
    const bool layout = mxu_layout_matches<LayoutMxu125>(t, rk, klo, khi,
                                                         jlo, jhi);
    if (blocks > 0x7fffffffLL || span >= BT_PLANE_SPAN
        || threads != mxu_threads(g)
        || mxu_smem_bytes(g, layout ? 0 : nW) > smem_bytes)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const float* xs = (const float*)x;
    float* os = (float*)out;
    const int* tb = (const int*)table;
    if (layout)
        return (int)k8_launch<LayoutMxu125>((int)blocks, threads, smem_bytes,
                                            st, xs, os, tb, g, t);
    switch (rk) {
        case 1: return (int)k8_launch<LayoutMxuRuntime<1>>((int)blocks, threads, smem_bytes, st, xs, os, tb, g, t);
        case 2: return (int)k8_launch<LayoutMxuRuntime<2>>((int)blocks, threads, smem_bytes, st, xs, os, tb, g, t);
        case 4: return (int)k8_launch<LayoutMxuRuntime<4>>((int)blocks, threads, smem_bytes, st, xs, os, tb, g, t);
        case 8: return (int)k8_launch<LayoutMxuRuntime<8>>((int)blocks, threads, smem_bytes, st, xs, os, tb, g, t);
        default: return (int)cudaErrorInvalidValue;
    }
}
