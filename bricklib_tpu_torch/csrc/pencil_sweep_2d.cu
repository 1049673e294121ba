// K6: the 2-D whole-row sweep, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/pencil_kernel_2d.py:
// pallas_pencil_sweep_2d (f32, linear stencils, any fuse; systems and
// multi-input stencils at fuse 1).
//
// What it computes.  Storage X_f[nb, BY, X] (one array per input field f)
// is read through the row table T[GY]: a brick is BY whole rows of the
// domain.  Output brick row r in [Y0, Y1) reads the slab of rows
// yy in [r*BY - F*ylo, (r+1)*BY + F*yhi), row yy taken from brick
// T[clip(floor(yy/BY), 0, GY-1)] at in-brick row yy mod BY: rows beyond
// the table clamp to the edge brick, whole bricks at a time.  x is periodic
// modulo X.  Level l (1..F) is the stencil applied to level l-1 over
// BY + (F-l)(ylo+yhi) rows, with no clamp between levels (the in-window
// trapezoid); level F goes to brick T[r] of every output.  Every other
// brick of an output is left untouched.  Each output o is a linear form
// of the inputs, folded on the host into groups: a group is one (field,
// dx) with a coefficient per dy in [-RAD, RAD].
//
// What bounds it on the card.  Device-memory bytes: at fuse F it reads and
// writes each element once per F stencil iterations.  The 9-point box at
// fuse 4 does 4 x 18 = 72 flops per 8 bytes moved, about 9 per byte, under
// the ~20 flops/byte at which the H100's f32 units would bound it: one
// fuse-4 sweep at 16384^2 must move 2.15 GB, 0.64 ms at 3.35 TB/s.  What
// the design must keep small is the latency of the level-0 load and the
// work per output in shared memory: the recomputed halo and the tap reads.
//
// What the design does about it.  Bricks are whole rows, so there is no
// j axis and no MXU form to carry over (the TPU kernel's banded matmuls
// have no counterpart here).  One block owns one output brick row and TX
// columns of x.  It loads the level-0 slab (BY + F(ylo+yhi) rows by
// TX + F(xlo+xhi) columns, x wrapping) once into shared memory, through the
// table with the clamps, as one asynchronous copy per element, all in
// flight before one wait (a loop of register loads took some ten round
// trips per block and set the time: 2.03 against 1.40 ms at fuse 1,
// 16384^2, H100 SXM at 700 W), then computes each level in shared memory,
// ping-ponging between two buffers; level F is written straight to the
// output brick.  Intermediate levels never touch device memory, and the
// trapezoid recomputes about (F-1)(ylo+yhi)/BY + (F-1)(xlo+xhi)/TX per
// level (1.12 stencils per output at BY 32, TX 128, F 4, radius 1, against
// K1's 2.2).  Each thread computes a strip of R rows in one column: per
// group it reads R + 2*RAD values of one column into registers and applies
// every dy of the group from there, so a 9-point box costs 3.75 shared
// reads per output instead of 9.  Loads of a warp hit 32 consecutive
// columns: no bank conflicts.  Buffers carry RAD rows of padding in front
// and R + RAD behind, so a strip never reads outside the allocation; rows
// it reads there only meet zero coefficients, which are skipped.

#include <cuda_runtime.h>

#define K6_R 8                 // output rows per thread strip
#define K6_MAX_FIELDS 8
#define K6_MAX_OUT 8
#define K6_MAX_GROUPS 64
#define K6_MAX_COEF 512

struct K6Ptrs {
    const float* in[K6_MAX_FIELDS];
    float* out[K6_MAX_OUT];
};

struct K6Taps {
    int nout;
    int gbeg[K6_MAX_OUT + 1];          // groups of output o: [gbeg[o], gbeg[o+1])
    int gfield[K6_MAX_GROUPS];
    int gdx[K6_MAX_GROUPS];
    float coef[K6_MAX_COEF];           // group g, dy: coef[g*(2*RAD+1) + dy + RAD]
};

struct K6Geom {
    int GY, BY, X;                      // table rows, brick rows, domain width
    int Y0;                             // first output brick row
    int F;                              // fused levels
    int ylo, yhi, xlo, xhi;             // stencil radius per side
    int TX;                             // x columns per block
    int nf;                             // input fields
};

__device__ __forceinline__ int k6_floor_div(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int k6_clamp(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// One float from device memory to shared memory without a register
// (cp.async, Ampere and later): a thread issues all its copies, then waits
// once.  The host pass of a C++ compiler sees a plain copy.
__device__ __forceinline__ void k6_copy_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void k6_copy_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Floats of one level buffer of h rows by w columns, padding included.
__device__ __forceinline__ int k6_buf_elems(int h, int w, int rad) {
    return (h + 2 * rad + K6_R) * w;
}

// One level over an h x w tile: output (s, c) = sum over the groups of
// output o of coef * src[field][s + ylo + dy][c + xlo + dx].  `src` points
// at the logical origin of field 0's level buffer; field f lies `fstride`
// floats further.  Level F (`dst_g` set) goes to the output brick, other
// levels to `dst` (width w).
template <int RAD>
__device__ __forceinline__ void k6_level(
        const K6Taps& t, int o, const float* src, int fstride, int wsrc,
        int h, int w, int ylo, int xlo, float* dst, float* dst_g,
        long long gstride) {
    const int nstrip = (h + K6_R - 1) / K6_R;
    const int total = nstrip * w;
    const int gb = t.gbeg[o], ge = t.gbeg[o + 1];
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int sy = e / w;
        const int c = e - sy * w;
        const int s0 = sy * K6_R;
        float acc[K6_R];
#pragma unroll
        for (int i = 0; i < K6_R; ++i) acc[i] = 0.0f;
        for (int g = gb; g < ge; ++g) {
            const float* col = src + t.gfield[g] * fstride
                               + (s0 + ylo - RAD) * wsrc + c + xlo + t.gdx[g];
            float v[K6_R + 2 * RAD];
#pragma unroll
            for (int j = 0; j < K6_R + 2 * RAD; ++j) v[j] = col[j * wsrc];
            const float* cf = t.coef + g * (2 * RAD + 1);
#pragma unroll
            for (int d = 0; d < 2 * RAD + 1; ++d) {
                const float cd = cf[d];
                if (cd != 0.0f) {
#pragma unroll
                    for (int i = 0; i < K6_R; ++i)
                        acc[i] = fmaf(cd, v[i + d], acc[i]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < K6_R; ++i) {
            const int s = s0 + i;
            if (s < h) {
                if (dst_g) dst_g[s * gstride + c] = acc[i];
                else dst[s * w + c] = acc[i];
            }
        }
    }
}

// Shared memory: the level-0 buffers (one per input field at fuse 1, one
// at fuse > 1), the level-1 buffer (fuse > 1; each later level reuses the
// older buffer, which is larger), then the level-0 row offsets.
template <int RAD>
__global__ void __launch_bounds__(256)
pencil_sweep_2d_kernel(K6Ptrs p, const int* __restrict__ table, K6Geom g,
                       K6Taps t) {
    extern __shared__ float smem[];
    const int F = g.F;
    const int r = g.Y0 + blockIdx.y;
    const int x0 = blockIdx.x * g.TX;
    const int ry = g.ylo + g.yhi, rx = g.xlo + g.xhi;
    const int h0 = g.BY + F * ry, w0 = g.TX + F * rx;
    const int h1 = g.BY + (F - 1) * ry, w1 = g.TX + (F - 1) * rx;
    const int nb0 = F > 1 ? 1 : g.nf;
    const int stride0 = k6_buf_elems(h0, w0, RAD);
    const int stride1 = F > 1 ? k6_buf_elems(h1, w1, RAD) : 0;
    float* buf0 = smem + RAD * w0;               // logical origin, field 0
    float* buf1 = smem + nb0 * stride0 + RAD * w1;
    long long* rowoff = (long long*)(smem
                                     + ((nb0 * stride0 + stride1 + 1) & ~1));
    const long long brick = (long long)g.BY * g.X;

    // where each level-0 row starts in storage (through the table, clamped)
    const int ybase = r * g.BY - F * g.ylo;
    for (int s = threadIdx.x; s < h0; s += blockDim.x) {
        const int yy = ybase + s;
        const int kb = k6_floor_div(yy, g.BY);
        const long long b = table[k6_clamp(kb, 0, g.GY - 1)];
        rowoff[s] = b * brick + (long long)(yy - kb * g.BY) * g.X;
    }
    __syncthreads();

    // level 0: every element of the slab one asynchronous copy, x wrapping,
    // all of them in flight before the one wait
    {
        const int xb = x0 - F * g.xlo;
        const int n0 = h0 * w0;
        for (int f = 0; f < nb0; ++f) {
            const float* __restrict__ src = p.in[f];
            float* dst = buf0 + f * stride0;
            for (int e = threadIdx.x; e < n0; e += blockDim.x) {
                const int s = e / w0;
                const int c = e - s * w0;
                int xg = xb + c;
                if (xg < 0 || xg >= g.X) xg = ((xg % g.X) + g.X) % g.X;
                k6_copy_async(dst + e, src + rowoff[s] + xg);
            }
        }
        k6_copy_wait();
    }
    __syncthreads();

    if (F == 1) {
        // one level from the level-0 slabs, every output
        for (int o = 0; o < t.nout; ++o)
            k6_level<RAD>(t, o, buf0, stride0, w0, g.BY, g.TX, g.ylo, g.xlo,
                          nullptr,
                          p.out[o] + (long long)table[r] * brick + x0, g.X);
        return;
    }
    // fused: levels 1..F of the one output, ping-pong in shared memory
    const float* src = buf0;
    int wsrc = w0;
    for (int l = 1; l <= F; ++l) {
        const int h = g.BY + (F - l) * ry, w = g.TX + (F - l) * rx;
        float* dst = (l & 1) ? buf1 : buf0;
        k6_level<RAD>(t, 0, src, 0, wsrc, h, w, g.ylo, g.xlo, dst,
                      l == F ? p.out[0] + (long long)table[r] * brick + x0
                             : nullptr,
                      g.X);
        if (l == F) break;
        __syncthreads();
        src = dst;
        wsrc = w;
    }
}

template <int RAD>
static cudaError_t k6_launch(dim3 grid, int threads, int smem_bytes,
                             cudaStream_t stream, const K6Ptrs& p,
                             const int* table, const K6Geom& g,
                             const K6Taps& t) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_2d_kernel<RAD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_2d_kernel<RAD><<<grid, threads, smem_bytes, stream>>>(
        p, table, g, t);
    return cudaGetLastError();
}

// ins/outs: arrays of nf/nout device pointers.  gbeg: nout + 1 group
// bounds; gfield, gdx: per group; coef: ngroups * (2*rad + 1) floats.
extern "C" int bt_pencil_sweep_2d(const long long* ins, const long long* outs,
                                  const void* table, int nf, int nout,
                                  int GY, int BY, int X, int Y0, int Y1,
                                  int F, int ylo, int yhi, int xlo, int xhi,
                                  int TX, int rad, int ngroups,
                                  const int* gbeg, const int* gfield,
                                  const int* gdx, const float* coef,
                                  int smem_bytes, int threads, void* stream) {
    if (nf < 1 || nf > K6_MAX_FIELDS || nout < 1 || nout > K6_MAX_OUT
        || ngroups < 1 || ngroups > K6_MAX_GROUPS
        || ngroups * (2 * rad + 1) > K6_MAX_COEF || F < 1 || TX < 1
        || X % TX || Y1 <= Y0 || Y1 - Y0 > 65535 || threads > 256
        || (F > 1 && (nf != 1 || nout != 1))
        || ylo > rad || yhi > rad || gbeg[0] != 0 || gbeg[nout] != ngroups)
        return (int)cudaErrorInvalidValue;
    K6Ptrs p = {};
    for (int f = 0; f < nf; ++f) p.in[f] = (const float*)ins[f];
    for (int o = 0; o < nout; ++o) p.out[o] = (float*)outs[o];
    K6Taps t = {};
    t.nout = nout;
    for (int o = 0; o <= nout; ++o) t.gbeg[o] = gbeg[o];
    for (int q = 0; q < ngroups; ++q) {
        t.gfield[q] = gfield[q];
        t.gdx[q] = gdx[q];
    }
    for (int q = 0; q < ngroups * (2 * rad + 1); ++q) t.coef[q] = coef[q];
    K6Geom g = {GY, BY, X, Y0, F, ylo, yhi, xlo, xhi, TX, nf};
    dim3 grid(X / TX, Y1 - Y0);
    cudaStream_t st = (cudaStream_t)stream;
    const int* tb = (const int*)table;
    switch (rad) {
        case 1: return (int)k6_launch<1>(grid, threads, smem_bytes, st, p, tb, g, t);
        case 2: return (int)k6_launch<2>(grid, threads, smem_bytes, st, p, tb, g, t);
        case 4: return (int)k6_launch<4>(grid, threads, smem_bytes, st, p, tb, g, t);
        case 8: return (int)k6_launch<8>(grid, threads, smem_bytes, st, p, tb, g, t);
        default: return (int)cudaErrorInvalidValue;
    }
}
