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
// one output pencil and TI lanes of i.  It loads the level-0 tile (the
// output tile grown by F*radius in k, j and i, i wrapping) once, through
// the table and with the clamps, then computes each level in shared memory
// over a tile that shrinks by one radius per level, ping-ponging between
// two buffers; level F is written straight to the output brick.
// Intermediate levels never touch device memory.  To keep the per-element
// work small, the table lookups and clamps are done once per tile row
// (row offsets in shared memory), the tap offsets once per level, an
// element's (row, lane) comes from a float reciprocal instead of integer
// division (exact: tiles stay below 2^20 elements), and for the 7-point
// stencils the taps are unrolled with their coefficients read straight
// from the kernel parameters.  The price is the halo: neighbouring blocks
// load overlapping level-0 tiles (mostly from L2) and recompute the
// overlapping parts of each level.  A streaming k loop, TMA and register
// blocking are left for later work.

#include <cuda_runtime.h>

#define BT_MAX_TAPS 128
#define BT_LOADS 4             // level-0 loads in flight per thread

struct SweepTaps {
    int n;
    int dk[BT_MAX_TAPS];
    int dj[BT_MAX_TAPS];
    int di[BT_MAX_TAPS];
    float c[BT_MAX_TAPS];
};

struct SweepGeom {
    int GK, GJ;                         // table shape
    int BK, BJ, BI;                     // brick shape
    int K0, J0;                         // first output brick row / pencil
    int KC;                             // output brick rows per subdomain
    long long stride;                   // bricks per subdomain
    int F;                              // fused levels
    int klo, khi, jlo, jhi, ilo, ihi;   // stencil radius per side
    int TI;                             // i lanes per block
};

__device__ __forceinline__ int floor_div(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// floor(e / m) for 0 <= e < 2^20, from inv = 1.0f / m
__device__ __forceinline__ int div_by(int e, float inv) {
    return (int)(((float)e + 0.5f) * inv);
}

// Shared memory: two level buffers (the level-0 tile and the level-1
// tile; each later level reuses the older one), then the level-0 row
// offsets.  NT > 0 is the tap count known at compile time (taps unrolled);
// NT == 0 reads the count from `taps`.
template <int NT>
__global__ void pencil_sweep_kernel(const float* __restrict__ x,
                                    float* __restrict__ out,
                                    const int* __restrict__ table,
                                    SweepGeom g, SweepTaps taps) {
    extern __shared__ float smem[];
    const int F = g.F;
    const int sub = blockIdx.z / g.KC;
    const int kout = g.K0 + (blockIdx.z - sub * g.KC);
    const long long bofs = sub * g.stride;
    const int jout = g.J0 + blockIdx.y;
    const int i0 = blockIdx.x * g.TI;
    const int rk = g.klo + g.khi, rj = g.jlo + g.jhi, ri = g.ilo + g.ihi;
    const long long brick = (long long)g.BK * g.BJ * g.BI;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int nt = NT > 0 ? NT : taps.n;

    int nk = g.BK + F * rk, nj = g.BJ + F * rj, ni = g.TI + F * ri;
    const int n0 = nk * nj * ni;
    const int mk1 = g.BK + (F - 1) * rk, mj1 = g.BJ + (F - 1) * rj;
    const int n1 = F > 1 ? mk1 * mj1 * (g.TI + (F - 1) * ri) : 0;
    float* buf_a = smem;
    float* buf_b = smem + n0;
    long long* rowoff = (long long*)(smem + ((n0 + n1 + 1) & ~1));

    // per row of the level-0 tile: where it starts in X (through the
    // table, with the clamps)
    const int kbase0 = kout * g.BK - F * g.klo;
    const int jbase0 = jout * g.BJ - F * g.jlo;
    for (int r = tid; r < nk * nj; r += nthr) {
        const int kk = kbase0 + r / nj, jj = jbase0 + r % nj;
        const int kb = floor_div(kk, g.BK), jb = floor_div(jj, g.BJ);
        const long long b = bofs + table[clamp_int(kb, 0, g.GK - 1) * g.GJ
                                         + clamp_int(jb, 0, g.GJ - 1)];
        rowoff[r] = b * brick
                    + ((long long)(kk - kb * g.BK) * g.BJ + (jj - jb * g.BJ))
                      * g.BI;
    }
    __syncthreads();

    // level 0: the output tile grown by F radii, loaded through the
    // table, BT_LOADS loads in flight per thread
    {
        const int ibase = i0 - F * g.ilo;
        const float inv = 1.0f / ni;
        for (int e0 = tid; e0 < n0; e0 += nthr * BT_LOADS) {
            float v[BT_LOADS];
#pragma unroll
            for (int u = 0; u < BT_LOADS; ++u) {
                const int e = e0 + u * nthr;
                if (e < n0) {
                    const int r = div_by(e, inv);
                    int ii = ibase + (e - r * ni);
                    if (ii < 0 || ii >= g.BI)
                        ii = ((ii % g.BI) + g.BI) % g.BI;
                    v[u] = x[rowoff[r] + ii];
                }
            }
#pragma unroll
            for (int u = 0; u < BT_LOADS; ++u) {
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
        const int mk = g.BK + (F - f) * rk;
        const int mj = g.BJ + (F - f) * rj;
        const int mi = g.TI + (F - f) * ri;
        const int n = mk * mj * mi;
        const float inv_i = 1.0f / mi, inv_j = 1.0f / mj;
        const long long ob = f == F ? bofs + table[kout * g.GJ + jout] : 0;
        // tap offsets into the level below, in bytes, once per level
        int boff[NT > 0 ? NT : 1];
#pragma unroll
        for (int t = 0; t < NT; ++t)
            boff[t] = 4 * ((taps.dk[t] * nj + taps.dj[t]) * ni + taps.di[t]);
        for (int e = tid; e < n; e += nthr) {
            const int r = div_by(e, inv_i);
            const int ti = e - r * mi;
            const int tk = div_by(r, inv_j);
            const int tj = r - tk * mj;
            // the level below has its origin one radius further out
            const float* p = src + ((tk + g.klo) * nj + (tj + g.jlo)) * ni
                             + ti + g.ilo;
            float acc = 0.0f;
            if constexpr (NT > 0) {
                const char* pb = (const char*)p;
#pragma unroll
                for (int t = 0; t < NT; ++t)
                    acc += taps.c[t] * *(const float*)(pb + boff[t]);
            } else {
                for (int t = 0; t < nt; ++t)
                    acc += taps.c[t] * p[(taps.dk[t] * nj + taps.dj[t]) * ni
                                         + taps.di[t]];
            }
            if (f == F)
                out[ob * brick + ((long long)tk * g.BJ + tj) * g.BI + i0 + ti]
                    = acc;
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
                const int tk = div_by(e, inv_r);
                const int kk = kbase + tk;
                if (kk < 0 || kk >= ktop) {
                    const int kb = floor_div(kk, g.BK);
                    const int ks = clamp_int(kb, 0, g.GK - 1) * g.BK
                                   + (kk - kb * g.BK) - kbase;
                    dst[e] = dst[ks * nrow + (e - tk * nrow)];
                }
            }
            __syncthreads();
        }
        float* t = src;
        src = dst;
        dst = t;
        nk = mk;
        nj = mj;
        ni = mi;
    }
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
    SweepTaps taps;
    taps.n = ntaps;
    for (int t = 0; t < ntaps; ++t) {
        taps.dk[t] = tap_offsets[3 * t];
        taps.dj[t] = tap_offsets[3 * t + 1];
        taps.di[t] = tap_offsets[3 * t + 2];
        taps.c[t] = tap_coeffs[t];
    }
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
