// The per-brick-row block body of the fused pencil sweep: kernel K11's
// (fused_exchange.cu), and K1's first design.  K1 (pencil_sweep.cu) now
// streams chunks of brick rows through each block instead
// (pencil_stream.cuh), with the same arithmetic per output: the chain acc =
// 0; acc += c[t] * x[t] in tap order.  So K11's result still equals a PUT
// exchange followed by K1 bit for bit.  This header also holds the pieces
// both bodies use (SweepTaps, sweep_taps, floor_div, clamp_int).  Moving
// K11 onto the streaming body is later work.
//
// One block owns one output brick row `kout` of subdomain `sub`, one output
// pencil `jout` and TI lanes of i from `i0`.  It loads the level-0 tile (the
// output tile grown by F radii in k, j and i, i wrapping) once, through the
// table and with its clamps, then computes each level in shared memory over
// a tile that shrinks by one radius per level, ping-ponging between two
// buffers; level F is written straight to the output brick.  Intermediate
// levels never touch device memory.  To keep the per-element work small,
// the table lookups and clamps are done once per tile row (row offsets in
// shared memory), the tap offsets once per level, an element's (row, lane)
// comes from a float reciprocal instead of integer division (exact: tiles
// stay below 2^20 elements), and with NT > 0 the taps are unrolled with
// their coefficients read straight from the kernel parameters.
//
// COHERENT selects how level 0 is read: K1's input is read-only for its
// whole launch, so plain loads may take the non-coherent read-only path;
// K11 reads ghost bricks that other blocks of the same launch (or another
// card) have just written, so it reads through L2 (__ldcg), never a stale
// line.  The values, and so the results, are the same.
#pragma once

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

// Shared memory (`smem`): two level buffers (the level-0 tile and the
// level-1 tile; each later level reuses the older one), then the level-0
// row offsets.  NT > 0 is the tap count known at compile time (taps
// unrolled); NT == 0 reads the count from `taps`.
template <int NT, bool COHERENT>
__device__ __forceinline__ void sweep_block(const float* __restrict__ x,
                                            float* __restrict__ out,
                                            const int* __restrict__ table,
                                            const SweepGeom& g,
                                            const SweepTaps& taps, int sub,
                                            int kout, int jout, int i0,
                                            float* smem) {
    const int F = g.F;
    const long long bofs = sub * g.stride;
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
                    if constexpr (COHERENT)
                        v[u] = __ldcg(x + rowoff[r] + ii);
                    else
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

// SweepTaps from the flat host arrays of the C entry points: offsets
// (dk, dj, di) per tap, then the coefficients
static inline SweepTaps sweep_taps(int ntaps, const int* tap_offsets,
                                   const float* tap_coeffs) {
    SweepTaps taps;
    taps.n = ntaps;
    for (int t = 0; t < ntaps; ++t) {
        taps.dk[t] = tap_offsets[3 * t];
        taps.dj[t] = tap_offsets[3 * t + 1];
        taps.di[t] = tap_offsets[3 * t + 2];
        taps.c[t] = tap_coeffs[t];
    }
    return taps;
}
