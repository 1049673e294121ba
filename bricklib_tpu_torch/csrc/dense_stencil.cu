// K7: the dense padded-array stencil, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/pallas_backend.py:
// pallas_dense_stencil (3-D, f32, linear stencils of 1 to K7_MAX_FIELDS
// input arrays).
//
// What it computes.  Inputs A_f[SK, SJ, SI] (one padded array per field)
// and the output have one shape.  Output rows k in [pk, SK-pk), j in
// [pj, SJ-pj) are computed over the full padded i width:
//   out[k, j, i] = sum over taps (f, dk, dj, di) of c * A_f[k+dk, j+dj,
//                  (i+di) mod SI]
// i read circularly over the whole padded row, as the TPU kernel's roll at
// full row width does.  The k and j pad rows of the output are zero.
//
// What bounds it on the card.  Device-memory bytes: a 7-point sweep does
// 14 flops per 8 bytes moved.  One 147-row slab of the out-of-core path at
// 1024^3 (149 x 1040 x 1152 floats in and out) must move 1.43 GB, 0.43 ms
// at 3.35 TB/s.
//
// What the design does about it.  One block owns TK rows in k, K7_TJ rows
// in j and K7_TI columns in i of the output.
// It loads the input tile grown by the stencil's reach (k and j rows
// outside the array are not read; i wraps modulo SI) into shared memory,
// every element one cp.async copy, all in flight before one wait, then
// each thread computes its outputs from there, tap by tap.  Blocks cover
// the whole padded array, so the pad rows are written (as zeros) by the
// same launch.  Neighbouring blocks read overlapping tiles, mostly from
// L2.  A k-streaming loop with a register window is left for later work.

#include <cuda_runtime.h>

#include "copy_async.cuh"

#define K7_TJ 8
#define K7_TI 128
#define K7_MAX_FIELDS 8
#define K7_MAX_TAPS 128

struct K7Ptrs {
    const float* in[K7_MAX_FIELDS];
};

struct K7Taps {
    int n;
    int f[K7_MAX_TAPS];
    int dk[K7_MAX_TAPS];
    int dj[K7_MAX_TAPS];
    int di[K7_MAX_TAPS];
    float c[K7_MAX_TAPS];
};

struct K7Geom {
    int SK, SJ, SI;             // padded shape
    int pk, pj;                 // pads of k and j: rows computed in between
    int klo, khi, jlo, jhi, ilo, ihi;   // reach of the taps per side
    int nf;                     // input fields
    int TK;                     // k rows per block
};

// Shared memory: per field a tile [TK+klo+khi][K7_TJ+jlo+jhi][K7_TI+ilo+ihi].
__global__ void __launch_bounds__(256)
dense_stencil_kernel(K7Ptrs p, float* __restrict__ out, K7Geom g, K7Taps t) {
    extern __shared__ float smem[];
    const int EK = g.TK + g.klo + g.khi;
    const int EJ = K7_TJ + g.jlo + g.jhi;
    const int EI = K7_TI + g.ilo + g.ihi;
    const int tile = EK * EJ * EI;
    const int k0 = blockIdx.z * g.TK;
    const int j0 = blockIdx.y * K7_TJ;
    const int i0 = blockIdx.x * K7_TI;
    const long long plane = (long long)g.SJ * g.SI;

    for (int f = 0; f < g.nf; ++f) {
        const float* __restrict__ src = p.in[f];
        float* dst = smem + f * tile;
        for (int e = threadIdx.x; e < tile; e += blockDim.x) {
            const int a = e / (EJ * EI);
            const int rem = e - a * (EJ * EI);
            const int b = rem / EI;
            const int c = rem - b * EI;
            const int k = k0 - g.klo + a;
            const int j = j0 - g.jlo + b;
            int i = i0 - g.ilo + c;
            if (i < 0 || i >= g.SI) i = ((i % g.SI) + g.SI) % g.SI;
            if (k >= 0 && k < g.SK && j >= 0 && j < g.SJ)
                bt_copy_async(dst + e, src + k * plane + (long long)j * g.SI + i);
            else
                dst[e] = 0.0f;
        }
    }
    bt_copy_wait();
    __syncthreads();

    const int nout = g.TK * K7_TJ * K7_TI;
    for (int e = threadIdx.x; e < nout; e += blockDim.x) {
        const int kk = e / (K7_TJ * K7_TI);
        const int jj = (e / K7_TI) % K7_TJ;
        const int ii = e % K7_TI;
        const int k = k0 + kk, j = j0 + jj, i = i0 + ii;
        if (k >= g.SK || j >= g.SJ || i >= g.SI) continue;
        float acc = 0.0f;
        if (k >= g.pk && k < g.SK - g.pk && j >= g.pj && j < g.SJ - g.pj) {
            for (int q = 0; q < t.n; ++q) {
                const float* tl = smem + t.f[q] * tile;
                acc = fmaf(t.c[q],
                           tl[((kk + g.klo + t.dk[q]) * EJ + jj + g.jlo + t.dj[q])
                              * EI + ii + g.ilo + t.di[q]], acc);
            }
        }
        out[k * plane + (long long)j * g.SI + i] = acc;
    }
}

// ins: nf device pointers.  f, dk, dj, di, c: ntaps each.
extern "C" int bt_dense_stencil(const long long* ins, void* out, int nf,
                                int SK, int SJ, int SI, int pk, int pj,
                                int klo, int khi, int jlo, int jhi, int ilo,
                                int ihi, int TK, int ntaps, const int* f,
                                const int* dk, const int* dj, const int* di,
                                const float* c, int smem_bytes, int threads,
                                void* stream) {
    if (nf < 1 || nf > K7_MAX_FIELDS || ntaps < 1 || ntaps > K7_MAX_TAPS
        || TK < 1 || SK < 1 || SJ < 1 || SI < 1 || threads > 256
        || (SK + TK - 1) / TK > 65535 || (SJ + K7_TJ - 1) / K7_TJ > 65535)
        return (int)cudaErrorInvalidValue;
    K7Ptrs p = {};
    for (int q = 0; q < nf; ++q) p.in[q] = (const float*)ins[q];
    K7Taps t = {};
    t.n = ntaps;
    for (int q = 0; q < ntaps; ++q) {
        if (f[q] < 0 || f[q] >= nf || dk[q] < -klo || dk[q] > khi
            || dj[q] < -jlo || dj[q] > jhi || di[q] < -ilo || di[q] > ihi)
            return (int)cudaErrorInvalidValue;
        t.f[q] = f[q];
        t.dk[q] = dk[q];
        t.dj[q] = dj[q];
        t.di[q] = di[q];
        t.c[q] = c[q];
    }
    K7Geom g = {SK, SJ, SI, pk, pj, klo, khi, jlo, jhi, ilo, ihi, nf, TK};
    cudaError_t err = cudaFuncSetAttribute(
        dense_stencil_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return (int)err;
    }
    dim3 grid((SI + K7_TI - 1) / K7_TI, (SJ + K7_TJ - 1) / K7_TJ,
              (SK + TK - 1) / TK);
    dense_stencil_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
        p, (float*)out, g, t);
    return (int)cudaGetLastError();
}
