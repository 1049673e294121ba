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
// s * stride added to every brick id: one more grid dimension, folded
// into blockIdx.z with the w and k rows.
//
// What bounds it on the card.  As for K1: device-memory bytes in the end
// (a 9-point f32 sweep does 18 flops per 8 bytes), but in this first
// design the recomputed halo and the shared-memory work per element.  A
// fused tile grows by F*radius on both sides of four axes, so the 4-D
// halo costs more than the 3-D one: at brick (4, 8, 8, 512), F = 2 and
// radius 1, a whole-brick tile 16 lanes wide needs 92 KB for level 0
// alone.
//
// What the design does about it.  One block owns TW of the BW w-slices,
// the whole BK x BJ face and TI lanes of i of one output brick; the host
// picks (TW, TI) as the tile of least estimated work (level-0 loads plus
// stencil evaluations per output element) whose level-0 and level-1 tiles
// and row offsets fit the shared-memory budget it is given, and raises
// when none fits.  The block loads the level-0 tile once, through the table
// and with the clamps (row offsets computed once per tile row), computes
// each level in shared memory over a tile that shrinks by one radius per
// level, ping-ponging between two buffers, and writes level F to the
// output brick.  Intermediate levels never touch device memory; the taps
// of the 9-point star are unrolled with their byte offsets computed once
// per level.  Neighbouring blocks load overlapping level-0 tiles (mostly
// from L2) and recompute the overlap of each level.  Two blocks of 512
// threads share an SM (two tiles fit its shared memory), so the kernel is
// held to 64 registers a thread: at 69, one block per SM made the sweep
// about 45% slower.

#include <cuda_runtime.h>

#define BT4_MAX_TAPS 128
#define BT4_LOADS 4            // level-0 loads in flight per thread
#define BT4_THREADS 512        // threads per block (K4_THREADS)

struct Sweep4Taps {
    int n;
    int dw[BT4_MAX_TAPS];
    int dk[BT4_MAX_TAPS];
    int dj[BT4_MAX_TAPS];
    int di[BT4_MAX_TAPS];
    float c[BT4_MAX_TAPS];
};

struct Sweep4Geom {
    int GW, GK, GJ;                     // table shape
    int BW, BK, BJ, BI;                 // brick shape
    int W0, K0, J0;                     // first output brick per axis
    int WC, KC;                         // output bricks in w and k
    long long stride;                   // bricks between batch members
    int F;                              // fused levels
    int wlo, whi, klo, khi, jlo, jhi, ilo, ihi;   // radius per side
    int TW, TI;                         // w slices and i lanes per block
};

__device__ __forceinline__ int floor_div4(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int clamp4(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// floor(e / m) for 0 <= e < 2^20, from inv = 1.0f / m
__device__ __forceinline__ int div4(int e, float inv) {
    return (int)(((float)e + 0.5f) * inv);
}

// Shared memory: the level-0 tile, the level-1 tile (each later level
// reuses the older buffer), then the level-0 row offsets.  NT > 0 is the
// tap count known at compile time (taps unrolled); NT == 0 reads it from
// `taps`.
template <int NT>
__global__ void __launch_bounds__(BT4_THREADS, 2)
pencil_sweep_4d_kernel(const float* __restrict__ x, float* __restrict__ out,
                       const int* __restrict__ table, Sweep4Geom g,
                       Sweep4Taps taps) {
    extern __shared__ float smem[];
    const int F = g.F;
    const int nit = g.BI / g.TI;
    const int it = blockIdx.x % nit;
    const int w0 = (blockIdx.x / nit) * g.TW;   // first w slice in brick
    const int i0 = it * g.TI;
    const int sub = blockIdx.z / (g.WC * g.KC);
    const int wk = blockIdx.z - sub * (g.WC * g.KC);
    const int wc = wk / g.KC;
    const int wout = g.W0 + wc;
    const int kout = g.K0 + (wk - wc * g.KC);
    const int jout = g.J0 + blockIdx.y;
    const int rw = g.wlo + g.whi, rk = g.klo + g.khi;
    const int rj = g.jlo + g.jhi, ri = g.ilo + g.ihi;
    const long long brick = (long long)g.BW * g.BK * g.BJ * g.BI;
    // the batch member's storage starts sub * stride bricks in
    x += (long long)sub * g.stride * brick;
    out += (long long)sub * g.stride * brick;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int nt = NT > 0 ? NT : taps.n;

    int nw = g.TW + F * rw, nk = g.BK + F * rk;
    int nj = g.BJ + F * rj, ni = g.TI + F * ri;
    const int n0 = nw * nk * nj * ni;
    const int n1 = F > 1 ? (g.TW + (F - 1) * rw) * (g.BK + (F - 1) * rk)
                               * (g.BJ + (F - 1) * rj) * (g.TI + (F - 1) * ri)
                         : 0;
    float* buf_a = smem;
    float* buf_b = smem + n0;
    long long* rowoff = (long long*)(smem + ((n0 + n1 + 1) & ~1));

    // per row of the level-0 tile: where it starts in X (through the
    // table, with the brick clamps in w, k and j)
    const int wbase0 = wout * g.BW + w0 - F * g.wlo;
    const int kbase0 = kout * g.BK - F * g.klo;
    const int jbase0 = jout * g.BJ - F * g.jlo;
    for (int r = tid; r < nw * nk * nj; r += nthr) {
        const int tj = r % nj, q = r / nj;
        const int tk = q % nk, tw = q / nk;
        const int ww = wbase0 + tw, kk = kbase0 + tk, jj = jbase0 + tj;
        const int wb = floor_div4(ww, g.BW), kb = floor_div4(kk, g.BK);
        const int jb = floor_div4(jj, g.BJ);
        const long long b =
            table[(clamp4(wb, 0, g.GW - 1) * g.GK + clamp4(kb, 0, g.GK - 1))
                      * g.GJ + clamp4(jb, 0, g.GJ - 1)];
        rowoff[r] = b * brick
                    + ((((long long)(ww - wb * g.BW) * g.BK + (kk - kb * g.BK))
                        * g.BJ + (jj - jb * g.BJ)) * g.BI);
    }
    __syncthreads();

    // level 0: the output tile grown by F radii, loaded through the
    // table, BT4_LOADS loads in flight per thread
    {
        const int ibase = i0 - F * g.ilo;
        const float inv = 1.0f / ni;
        for (int e0 = tid; e0 < n0; e0 += nthr * BT4_LOADS) {
            float v[BT4_LOADS];
#pragma unroll
            for (int u = 0; u < BT4_LOADS; ++u) {
                const int e = e0 + u * nthr;
                if (e < n0) {
                    const int r = div4(e, inv);
                    int ii = ibase + (e - r * ni);
                    if (ii < 0 || ii >= g.BI)
                        ii = ((ii % g.BI) + g.BI) % g.BI;
                    v[u] = x[rowoff[r] + ii];
                }
            }
#pragma unroll
            for (int u = 0; u < BT4_LOADS; ++u) {
                const int e = e0 + u * nthr;
                if (e < n0) buf_a[e] = v[u];
            }
        }
    }
    __syncthreads();

    // levels 1..F: each from the level below; F goes to the output brick
    float* src = buf_a;
    float* dst = buf_b;
    for (int f = 1; f <= F; ++f) {
        const int mw = g.TW + (F - f) * rw;
        const int mk = g.BK + (F - f) * rk;
        const int mj = g.BJ + (F - f) * rj;
        const int mi = g.TI + (F - f) * ri;
        const int n = mw * mk * mj * mi;
        const float inv_i = 1.0f / mi, inv_j = 1.0f / mj, inv_k = 1.0f / mk;
        const long long ob =
            f == F ? table[(wout * g.GK + kout) * g.GJ + jout] : 0;
        // tap offsets into the level below, in bytes, once per level
        int boff[NT > 0 ? NT : 1];
#pragma unroll
        for (int t = 0; t < NT; ++t)
            boff[t] = 4 * (((taps.dw[t] * nk + taps.dk[t]) * nj + taps.dj[t])
                               * ni + taps.di[t]);
        for (int e = tid; e < n; e += nthr) {
            const int r = div4(e, inv_i);
            const int ti = e - r * mi;
            const int q = div4(r, inv_j);
            const int tj = r - q * mj;
            const int tw = div4(q, inv_k);
            const int tk = q - tw * mk;
            // the level below has its origin one radius further out
            const float* p = src + (((tw + g.wlo) * nk + (tk + g.klo)) * nj
                                    + (tj + g.jlo)) * ni + ti + g.ilo;
            float acc = 0.0f;
            if constexpr (NT > 0) {
                const char* pb = (const char*)p;
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    acc += taps.c[t] * *(const float*)(pb + boff[t]);
            } else {
                for (int t = 0; t < nt; ++t)
                    acc += taps.c[t]
                           * p[((taps.dw[t] * nk + taps.dk[t]) * nj
                                + taps.dj[t]) * ni + taps.di[t]];
            }
            if (f == F)
                out[ob * brick
                    + ((((long long)(w0 + tw) * g.BK + tk) * g.BJ + tj)
                       * g.BI) + i0 + ti] = acc;
            else
                dst[e] = acc;
        }
        if (f == F) break;
        __syncthreads();
        // k clamp: rows beyond the table take the clamped row's values
        const int kbase = kout * g.BK - (F - f) * g.klo;
        const int ktop = g.GK * g.BK;
        if (kbase < 0 || kbase + mk > ktop) {
            const int nrow = mj * mi;
            const float inv_r = 1.0f / nrow;
            for (int e = tid; e < n; e += nthr) {
                const int q = div4(e, inv_r);     // tw * mk + tk
                const int tk = q % mk;
                const int kk = kbase + tk;
                if (kk < 0 || kk >= ktop) {
                    const int kb = floor_div4(kk, g.BK);
                    const int ks = clamp4(kb, 0, g.GK - 1) * g.BK
                                   + (kk - kb * g.BK) - kbase;
                    dst[e] = dst[e + (ks - tk) * nrow];
                }
            }
            __syncthreads();
        }
        float* t = src;
        src = dst;
        dst = t;
        nw = mw;
        nk = mk;
        nj = mj;
        ni = mi;
    }
}

template <int NT>
static cudaError_t launch4(dim3 grid, int threads, int smem_bytes,
                           cudaStream_t stream, const float* x, float* out,
                           const int* table, const Sweep4Geom& g,
                           const Sweep4Taps& taps) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_4d_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_4d_kernel<NT><<<grid, threads, smem_bytes, stream>>>(
        x, out, table, g, taps);
    return cudaGetLastError();
}

extern "C" int bt_pencil_sweep_4d(const void* x, void* out, const void* table,
                                  int GW, int GK, int GJ,
                                  int BW, int BK, int BJ, int BI,
                                  int W0, int W1, int K0, int K1,
                                  int J0, int J1, int F,
                                  int wlo, int whi, int klo, int khi,
                                  int jlo, int jhi, int ilo, int ihi,
                                  int TW, int TI, int batch, int stride,
                                  int ntaps,
                                  const int* tap_offsets,
                                  const float* tap_coeffs, int smem_bytes,
                                  int threads, void* stream) {
    if (ntaps < 1 || ntaps > BT4_MAX_TAPS || F < 1 || TW < 1 || TI < 1
        || threads < 1 || threads > BT4_THREADS
        || BW % TW || BI % TI || batch < 1
        || (long long)batch * (W1 - W0) * (K1 - K0) > 65535
        || J1 - J0 > 65535)
        return (int)cudaErrorInvalidValue;
    Sweep4Geom g = {GW, GK, GJ, BW, BK, BJ, BI, W0, K0, J0, W1 - W0, K1 - K0,
                    (long long)stride, F, wlo, whi, klo, khi, jlo, jhi, ilo,
                    ihi, TW, TI};
    Sweep4Taps taps;
    taps.n = ntaps;
    for (int t = 0; t < ntaps; ++t) {
        taps.dw[t] = tap_offsets[4 * t];
        taps.dk[t] = tap_offsets[4 * t + 1];
        taps.dj[t] = tap_offsets[4 * t + 2];
        taps.di[t] = tap_offsets[4 * t + 3];
        taps.c[t] = tap_coeffs[t];
    }
    dim3 grid((BI / TI) * (BW / TW), J1 - J0, batch * (W1 - W0) * (K1 - K0));
    cudaStream_t st = (cudaStream_t)stream;
    const float* xf = (const float*)x;
    const int* tb = (const int*)table;
    if (ntaps == 9)
        return (int)launch4<9>(grid, threads, smem_bytes, st, xf,
                               (float*)out, tb, g, taps);
    return (int)launch4<0>(grid, threads, smem_bytes, st, xf, (float*)out,
                           tb, g, taps);
}
