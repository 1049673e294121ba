// K8: the flat-pencil factorized sweep, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/mxu_kernel.py:
// pallas_pencil_sweep_mxu (3-D, f32, one linear input, fuse 1, GI == 1).
//
// What it computes.  Storage X[nb, BK, BJ*BI] (flat pencils: each brick's
// (j, i) plane is one row of BJ*BI floats) is read through the table
// T[GK, GJ].  Output brick (k, j) for k in [K0, K0+KC), j in [J0, J0+JC)
// reads the slab of rows r + dk from brick rows k-1, k, k+1 and the j
// positions jj + dj from pencils j-1, j, j+1, each brick row and pencil
// clamped to the table edge (the TPU kernel's _clip), and i periodic
// within the brick's BI lanes.  The stencil comes folded as ir.fold_linear
// gives it:
//   W_w[r, jp, i] = sum_dk c_w[dk] * slab[r + dk, jp, i]   (nW k-profiles)
//   V_d[r, jj, i] = sum over terms (dj, w) of d: W_w[r, jj + dj, i]
//   out[r, jj, i] = sum over the distinct di: V_d[r, jj, (i + di) mod BI]
// which is the TPU kernel's A_prev/A_cur/A_next contraction (W), its lane
// slices at multiples of BI (V) and its roll pair per BI block (out).  The
// result equals kernel K1 at fuse 1 on the same table.  Every brick outside
// T[K0:K0+KC, J0:J0+JC] of `out` is left untouched.
//
// What bounds it on the card.  Device-memory bytes: each owned brick read
// once and written once.  The factorized form needs about 90 f32
// operations per output for the 125-point stencil (6 k-profiles of 30
// k-taps over a window 1.5x the output in j, then 25 V terms and 5 i
// terms), 12 GFLOP at 512^3 against 1.07 GB moved: 0.18 ms of f32 work
// against 0.32 ms of bytes at 3.35 TB/s.  This first design is bounded by
// shared-memory traffic instead (about 40 accesses per output).
//
// What the design does about it.  The TPU kernel spends the matrix unit on
// the W stage because the unit is otherwise idle there; on this card the
// contraction has 5 non-zero slot-matrix entries per row out of 24, so the
// W stage is FMAs over the non-zero entries: each k-profile's coefficient
// per dk in [-RK, RK], RK a compile-time radius, with the slab column held
// in registers.  One block owns one output brick and TI lanes of i.  It
// loads the slab (rows [-RK, BK+RK), pencil positions [-jlo, BJ+jhi), lanes
// [-ilo, TI+ihi) wrapping) once into shared memory through the table, as
// one cp.async copy per element, then walks the brick's rows in chunks of
// K8_R: the W stage writes every k-profile of the chunk to shared memory,
// and each output element sums its V terms and i terms from there and is
// written straight to the output brick.  Tensor cores (3xTF32 mma, to stay
// fp32-faithful) are left for later work; TF32 is not used.

#include <cuda_runtime.h>

#include "copy_async.cuh"

#define K8_R 4                  // output rows per chunk and per W strip
#define K8_MAX_W 24             // k-profiles
#define K8_MAX_RK 8             // k radius the kernel is compiled for, at most
#define K8_MAX_DI 17            // distinct i offsets
#define K8_MAX_TERMS 128        // V terms over all di

struct K8Taps {
    int nW;
    float c[K8_MAX_W * (2 * K8_MAX_RK + 1)];  // profile w, dk: c[w*(2RK+1) + dk + RK]
    int ndi;
    int di[K8_MAX_DI];
    int tbeg[K8_MAX_DI + 1];                   // terms of di index d: [tbeg[d], tbeg[d+1])
    int tdj[K8_MAX_TERMS];
    int tw[K8_MAX_TERMS];
};

struct K8Geom {
    int GK, GJ;                 // table shape
    int BK, BJ, BI;             // brick shape
    int K0, J0;                 // first output brick row / pencil
    int jlo, jhi, ilo, ihi;     // j and i reach of the folded stencil
    int TI;                     // i lanes per block
};

__device__ __forceinline__ int k8_floor_div(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int k8_clamp(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Shared memory: the slab S[SR][JPE][TIE] (SR = chunks * K8_R + 2*RK rows,
// row a holding slab row a - RK), the W buffer W[nW][K8_R][JPE][TIE], then
// the slab's row offsets in storage, one per (row, pencil position).
template <int RK>
__global__ void __launch_bounds__(256)
pencil_sweep_mxu_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const int* __restrict__ table, K8Geom g, K8Taps t) {
    extern __shared__ float smem[];
    const int JPE = g.BJ + g.jlo + g.jhi;
    const int TIE = g.TI + g.ilo + g.ihi;
    const int nchunk = (g.BK + K8_R - 1) / K8_R;
    const int SR = nchunk * K8_R + 2 * RK;
    const int plane = JPE * TIE;
    float* S = smem;
    float* W = S + SR * plane;
    long long* rowoff = (long long*)(smem + (((SR + t.nW * K8_R) * plane + 1) & ~1));
    const int LB = g.BJ * g.BI;
    const long long brick = (long long)g.BK * LB;
    const int kt = g.K0 + blockIdx.z;
    const int jt = g.J0 + blockIdx.y;
    const int i0 = blockIdx.x * g.TI;

    // where each (slab row, pencil position) starts in storage: through the
    // table, brick rows and pencils clamped to its edge
    for (int e = threadIdx.x; e < SR * JPE; e += blockDim.x) {
        const int a = e / JPE;
        const int jp = e - a * JPE;
        const int q = a - RK;
        const int kb = k8_floor_div(q, g.BK);
        const int jq = jp - g.jlo;
        const int jb = k8_floor_div(jq, g.BJ);
        const long long b = table[k8_clamp(kt + kb, 0, g.GK - 1) * g.GJ
                                  + k8_clamp(jt + jb, 0, g.GJ - 1)];
        rowoff[e] = b * brick + (long long)(q - kb * g.BK) * LB
                    + (long long)(jq - jb * g.BJ) * g.BI;
    }
    __syncthreads();

    // the slab: every element one asynchronous copy, i wrapping within BI,
    // all in flight before the one wait
    for (int e = threadIdx.x; e < SR * plane; e += blockDim.x) {
        const int row = e / TIE;
        const int ip = e - row * TIE;
        int i = i0 - g.ilo + ip;
        if (i < 0 || i >= g.BI) i = ((i % g.BI) + g.BI) % g.BI;
        bt_copy_async(S + e, x + rowoff[row] + i);
    }
    bt_copy_wait();
    __syncthreads();

    const long long obase = (long long)table[kt * g.GJ + jt] * brick + i0;
    const int nout = K8_R * g.BJ * g.TI;
    for (int c0 = 0; c0 < g.BK; c0 += K8_R) {
        // W stage: each thread one (pencil position, lane) column, its
        // K8_R + 2*RK slab rows in registers, every k-profile of the chunk
        for (int e = threadIdx.x; e < plane; e += blockDim.x) {
            float v[K8_R + 2 * RK];
#pragma unroll
            for (int m = 0; m < K8_R + 2 * RK; ++m)
                v[m] = S[(c0 + m) * plane + e];
            for (int w = 0; w < t.nW; ++w) {
                const float* cw = t.c + w * (2 * RK + 1);
                float acc[K8_R];
#pragma unroll
                for (int r = 0; r < K8_R; ++r) acc[r] = 0.0f;
#pragma unroll
                for (int d = 0; d < 2 * RK + 1; ++d) {
                    const float cd = cw[d];
                    if (cd != 0.0f) {
#pragma unroll
                        for (int r = 0; r < K8_R; ++r)
                            acc[r] = fmaf(cd, v[r + d], acc[r]);
                    }
                }
#pragma unroll
                for (int r = 0; r < K8_R; ++r)
                    W[(w * K8_R + r) * plane + e] = acc[r];
            }
        }
        __syncthreads();
        // V and i stages: each output element its V sums per distinct di,
        // read at the lane shifted by di, wrapped within the block's tile
        for (int e = threadIdx.x; e < nout; e += blockDim.x) {
            const int r = e / (g.BJ * g.TI);
            const int rem = e - r * (g.BJ * g.TI);
            const int jj = rem / g.TI;
            const int i = rem - jj * g.TI;
            if (c0 + r >= g.BK) continue;
            float acc = 0.0f;
            for (int d = 0; d < t.ndi; ++d) {
                const int col = jj + g.jlo;
                const int lane = i + g.ilo + t.di[d];
                float vsum = 0.0f;
                for (int q = t.tbeg[d]; q < t.tbeg[d + 1]; ++q)
                    vsum += W[(t.tw[q] * K8_R + r) * plane
                              + (col + t.tdj[q]) * TIE + lane];
                acc += vsum;
            }
            out[obase + (long long)(c0 + r) * LB + jj * g.BI + i] = acc;
        }
        __syncthreads();
    }
}

template <int RK>
static cudaError_t k8_launch(dim3 grid, int threads, int smem_bytes,
                             cudaStream_t stream, const float* x, float* out,
                             const int* table, const K8Geom& g,
                             const K8Taps& t) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_mxu_kernel<RK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_mxu_kernel<RK><<<grid, threads, smem_bytes, stream>>>(
        x, out, table, g, t);
    return cudaGetLastError();
}

// coef: nW * (2*rk + 1) floats.  di: ndi offsets; tbeg: ndi + 1 term bounds;
// tdj, tw: per term.
extern "C" int bt_pencil_sweep_mxu(const void* x, void* out, const void* table,
                                   int GK, int GJ, int BK, int BJ, int BI,
                                   int K0, int K1, int J0, int J1,
                                   int jlo, int jhi, int ilo, int ihi, int TI,
                                   int rk, int nW, const float* coef, int ndi,
                                   const int* di, const int* tbeg,
                                   const int* tdj, const int* tw,
                                   int smem_bytes, int threads, void* stream) {
    if (nW < 1 || nW > K8_MAX_W || ndi < 1 || ndi > K8_MAX_DI || TI < 1
        || BI % TI || K1 <= K0 || J1 <= J0 || K1 - K0 > 65535
        || J1 - J0 > 65535 || threads > 256 || jlo > BJ || jhi > BJ
        || ilo + ihi > BI || tbeg[0] != 0 || tbeg[ndi] > K8_MAX_TERMS)
        return (int)cudaErrorInvalidValue;
    K8Taps t = {};
    t.nW = nW;
    for (int q = 0; q < nW * (2 * rk + 1); ++q) t.c[q] = coef[q];
    t.ndi = ndi;
    for (int d = 0; d < ndi; ++d) t.di[d] = di[d];
    for (int d = 0; d <= ndi; ++d) t.tbeg[d] = tbeg[d];
    for (int q = 0; q < tbeg[ndi]; ++q) {
        t.tdj[q] = tdj[q];
        t.tw[q] = tw[q];
    }
    K8Geom g = {GK, GJ, BK, BJ, BI, K0, J0, jlo, jhi, ilo, ihi, TI};
    dim3 grid(BI / TI, J1 - J0, K1 - K0);
    cudaStream_t st = (cudaStream_t)stream;
    const float* xs = (const float*)x;
    float* os = (float*)out;
    const int* tb = (const int*)table;
    switch (rk) {
        case 1: return (int)k8_launch<1>(grid, threads, smem_bytes, st, xs, os, tb, g, t);
        case 2: return (int)k8_launch<2>(grid, threads, smem_bytes, st, xs, os, tb, g, t);
        case 4: return (int)k8_launch<4>(grid, threads, smem_bytes, st, xs, os, tb, g, t);
        case 8: return (int)k8_launch<8>(grid, threads, smem_bytes, st, xs, os, tb, g, t);
        default: return (int)cudaErrorInvalidValue;
    }
}
