// K12: the rank-5+ pencil sweep, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/pencil_kernel_nd.py:
// pallas_pencil_sweep_nd (fuse = 1, f32, linear stencils, one or more
// input fields).
//
// What it computes.  Storage X_f[nb, B_0, ..., B_{nd-1}] (the last axis is
// the whole i row, BI = B_{nd-1}) is read through the grid table
// T[G_0, ..., G_{nd-2}], one brick per cell of the nd - 1 outer axes
// (w..., k, j).  The output bricks are T[R0_a : R0_a + RC_a] on every
// table axis a.  Output element x of output brick g is
//     sum over taps t of c_t * X_{f_t}[T[g'], x'],
// where, per table axis a, x_a + o_{t,a} leaving [0, B_a) moves to the
// neighbour brick g_a -+ 1, clamped to [0, G_a - 1] on that axis alone
// (corner taps cross several axes at once), and the i coordinate wraps
// modulo BI inside the row.  Taps add in tap order, as the plain version
// (pencil_sweep_plain) adds them.  Bricks outside the ranges are left as
// they were in `out`.
//
// What bounds it on the card.  Device-memory bytes: an 11-point f32 star
// does 22 flops per element against 8 bytes read and written, far below
// the card's 20 flops per byte.  The least traffic reads each element of
// the computed region grown by the radius once per field and writes the
// region once.
//
// What the design does about it.  This first version is the simple one:
// one thread per output element, consecutive threads on consecutive i
// lanes of one brick row, so every tap's loads and the store coalesce and
// the loads a brick row's neighbours share hit L1 and L2.  The tap table
// (field, coefficient, offset per axis) is copied to shared memory once
// per block and read as broadcasts.  Per tap only the axes with a nonzero
// offset do work: a compare against the brick edge, and for a crossing
// tap a clamped table step.  Index maths is 32-bit integer division (no
// float-reciprocal bound, unlike K4): in-brick element ids, table cells and
// output bricks are checked to fit 32 bits, brick offsets in device memory
// are 64-bit.  The rank is a template argument (5 to BTN_MAX_RANK) so the
// per-axis coordinates stay in registers; extents and field pointers live
// in a parameter block of fixed caps (BTN_MAX_RANK axes, BTN_MAX_FIELDS
// fields).  Register blocking along i, shared-memory tiles and k streaming
// are later work.

#include <cuda_runtime.h>

#define BTN_MAX_RANK 8
#define BTN_MAX_FIELDS 8
#define BTN_MAX_TAPS 512

struct NdGeom {
    int ntaps;
    int belems;                            // elements per brick
    int nout;                              // output bricks
    int B[BTN_MAX_RANK];                   // brick extent per axis
    int G[BTN_MAX_RANK];                   // table extent per table axis
    int R0[BTN_MAX_RANK];                  // first output brick per axis
    int RC[BTN_MAX_RANK];                  // output bricks per axis
    int tstride[BTN_MAX_RANK];             // table strides
    int estride[BTN_MAX_RANK];             // in-brick element strides
    const float* x[BTN_MAX_FIELDS];        // input storages
};

// One thread per output element: blockIdx.x * blockDim.x + threadIdx.x is
// the element of the brick, blockIdx.y + 65535 * blockIdx.z the output
// brick.  ND is a template argument so that the per-axis coordinates stay
// in registers (fully unrolled loops) and not in local memory.
template <int ND>
__global__ void __launch_bounds__(256)
pencil_sweep_nd_kernel(NdGeom g, const int* __restrict__ taps,
                       const int* __restrict__ table,
                       float* __restrict__ out) {
    extern __shared__ int s_taps[];
    const int row = ND + 2;
    for (int t = threadIdx.x; t < g.ntaps * row; t += blockDim.x)
        s_taps[t] = taps[t];
    __syncthreads();

    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    const int ob = blockIdx.z * 65535 + blockIdx.y;
    if (e >= g.belems || ob >= g.nout) return;

    int x[ND];
    int gb[ND - 1];
    int r = e;
#pragma unroll
    for (int a = ND - 1; a >= 0; --a) {
        x[a] = r % g.B[a];
        r /= g.B[a];
    }
    int q = ob;
    int tbase = 0;
#pragma unroll
    for (int a = ND - 2; a >= 0; --a) {
        gb[a] = g.R0[a] + q % g.RC[a];
        q /= g.RC[a];
        tbase += gb[a] * g.tstride[a];
    }

    const int BI = g.B[ND - 1];
    float acc = 0.0f;
    for (int t = 0; t < g.ntaps; ++t) {
        const int* tp = s_taps + t * row;
        int eo = e;
        int to = tbase;
#pragma unroll
        for (int a = 0; a < ND - 1; ++a) {
            const int o = tp[2 + a];
            if (!o) continue;
            int c = x[a] + o;
            const int d = c < 0 ? -1 : (c >= g.B[a] ? 1 : 0);
            c -= d * g.B[a];
            eo += (c - x[a]) * g.estride[a];
            if (d) {
                int nb = gb[a] + d;
                nb = nb < 0 ? 0 : (nb > g.G[a] - 1 ? g.G[a] - 1 : nb);
                to += (nb - gb[a]) * g.tstride[a];
            }
        }
        const int oi = tp[ND + 1];
        if (oi) {
            int c = (x[ND - 1] + oi) % BI;
            if (c < 0) c += BI;
            eo += c - x[ND - 1];
        }
        const long long id = __ldg(table + to);
        acc += __int_as_float(tp[1])
               * __ldg(g.x[tp[0]] + id * g.belems + eo);
    }
    out[(long long)__ldg(table + tbase) * g.belems + e] = acc;
}

template <int ND>
static cudaError_t launch_nd(const NdGeom& g, const int* taps,
                             const int* table, float* out, int threads,
                             cudaStream_t st) {
    dim3 grid((g.belems + threads - 1) / threads,
              g.nout < 65535 ? g.nout : 65535, (g.nout + 65534) / 65535);
    const size_t smem = (size_t)g.ntaps * (ND + 2) * sizeof(int);
    pencil_sweep_nd_kernel<ND><<<grid, threads, smem, st>>>(g, taps, table,
                                                            out);
    return cudaGetLastError();
}

extern "C" int bt_pencil_sweep_nd(const unsigned long long* ptrs, int nf,
                                  void* out, const void* table, int nd,
                                  const int* dims, const int* grid,
                                  const int* first, const int* count,
                                  const void* taps, int ntaps, int threads,
                                  void* stream) {
    if (nd < 5 || nd > BTN_MAX_RANK || nf < 1 || nf > BTN_MAX_FIELDS
        || ntaps < 1 || ntaps > BTN_MAX_TAPS || threads < 32
        || threads > 256)
        return (int)cudaErrorInvalidValue;
    NdGeom g = {};
    g.ntaps = ntaps;
    long long belems = 1;
    for (int a = nd - 1; a >= 0; --a) {
        if (dims[a] < 1) return (int)cudaErrorInvalidValue;
        g.B[a] = dims[a];
        g.estride[a] = (int)belems;
        belems *= dims[a];
    }
    long long nout = 1, ts = 1;
    for (int a = nd - 2; a >= 0; --a) {
        if (grid[a] < 1 || count[a] < 1 || first[a] < 0
            || first[a] + count[a] > grid[a])
            return (int)cudaErrorInvalidValue;
        g.G[a] = grid[a];
        g.R0[a] = first[a];
        g.RC[a] = count[a];
        g.tstride[a] = (int)ts;
        ts *= grid[a];
        nout *= count[a];
    }
    // in-brick element ids, table cells and output bricks are 32-bit
    if (belems > 0x7fffffffLL || ts > 0x7fffffffLL || nout > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    g.belems = (int)belems;
    g.nout = (int)nout;
    for (int f = 0; f < nf; ++f)
        g.x[f] = (const float*)ptrs[f];
    const int* tp = (const int*)taps;
    const int* tb = (const int*)table;
    float* o = (float*)out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (nd) {
    case 5: return (int)launch_nd<5>(g, tp, tb, o, threads, st);
    case 6: return (int)launch_nd<6>(g, tp, tb, o, threads, st);
    case 7: return (int)launch_nd<7>(g, tp, tb, o, threads, st);
    default: return (int)launch_nd<8>(g, tp, tb, o, threads, st);
    }
}
