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
// What the design does about it.  The first design (one thread per output
// element, each decoding its element with ND divisions and walking every
// tap through the table: 11 table loads and a clamp per axis per output)
// spent its time in integer work and reached 9.4% of its bound (PERF.md).
// This one streams k through each block, as the TPU kernel does and K1
// and K4 do (pencil_stream_nd.cuh says how): a block owns one outer brick
// cell, a chunk of brick rows, PJ pencils and TI lanes; level 0 arrives by
// 16-byte cp.async D planes ahead, every slice of outer positions its taps
// reach in a ring of planes in shared memory; the brick table, the clamps
// and the row offsets are resolved once per block; threads compute four
// rows of a column with no division, and under the 5-D star's layout
// compiled in (LayoutStar11) share the loads of its taps.  Blocks take
// the cells fastest, so the cells whose faces a block loads run beside it
// and those loads mostly hit L2.  The rank is a template argument (5 to
// BTN_MAX_RANK); extents and field pointers live in a parameter block of
// fixed caps (BTN_MAX_RANK axes, BTN_MAX_FIELDS fields), the plan's slice
// and tap tables in `info` (device memory), built by the host
// (codegen/pencil_kernel_nd.py).  Each output's sum keeps the first
// design's chain, so the two agree bit for bit.

#include <cstring>

#include "pencil_stream_nd.cuh"

// One block of 512 threads per SM at most (shared memory allows no more
// at the planner's footprints), so a thread may hold 128 registers.
template <int ND, class L>
__global__ void __launch_bounds__(BT_STREAM_THREADS, 1)
pencil_sweep_nd_kernel(NdGeom g, const int* __restrict__ info,
                       const int* __restrict__ table,
                       float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    stream_nd_block<ND, L>(g, info, table, out, blockIdx.x, smem);
}

template <int ND, class L>
static cudaError_t launch_nd(const NdGeom& g, const int* info,
                             const int* table, float* out, long long blocks,
                             int threads, int smem_bytes, cudaStream_t st) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_nd_kernel<ND, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_nd_kernel<ND, L><<<(unsigned)blocks, threads, smem_bytes,
                                    st>>>(g, info, table, out);
    return cudaGetLastError();
}

// The tap rows (field, coefficient bits, offset per axis) equal the 5-D
// star's layout.
static bool star11_matches(const int* rows, int ntaps) {
    if (ntaps != LayoutStar11::N) return false;
    for (int t = 0; t < ntaps; ++t) {
        if (rows[7 * t] != 0) return false;
        for (int a = 0; a < 5; ++a)
            if (rows[7 * t + 2 + a] != LayoutStar11::off(t, a)) return false;
    }
    return true;
}

// hdr: nd, bdims[8], grid[8], first[8], count[8] (table axes, padded),
// then the footprint and the plan's counts, in the order of
// K12_HEADER (codegen/pencil_kernel_nd.py).  tap_rows: ntaps x (nd + 2)
// host ints (field, coefficient bits, offset per axis); info: the plan's
// tables on the card.  layout: the host planned for the 5-D star's
// compiled body; the taps are checked against it here too.
#define BTN_HDR 56
extern "C" int bt_pencil_sweep_nd(const unsigned long long* ptrs, int nf,
                                  void* out, const void* table,
                                  const void* info, const int* hdr, int nhdr,
                                  const int* tap_rows, int ntaps,
                                  int smem_bytes, int threads, void* stream) {
    if (nhdr != BTN_HDR) return (int)cudaErrorInvalidValue;
    const int nd = hdr[0];
    if (nd < 5 || nd > BTN_MAX_RANK || nf < 1 || nf > BTN_MAX_FIELDS
        || ntaps < 1 || ntaps > BTN_MAX_TAPS || threads < 32
        || threads > BT_STREAM_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const int* dims = hdr + 1;
    const int* grid = hdr + 9;
    const int* first = hdr + 17;
    const int* count = hdr + 25;
    const int* f = hdr + 33;
    const int m = nd - 3;
    NdGeom g = {};
    long long belems = 1;
    for (int a = 0; a < nd; ++a) {
        if (dims[a] < 1) return (int)cudaErrorInvalidValue;
        belems *= dims[a];
    }
    long long ts = 1, ncell = 1;
    for (int a = nd - 2; a >= 0; --a) {
        if (grid[a] < 1 || count[a] < 1 || first[a] < 0
            || first[a] + count[a] > grid[a])
            return (int)cudaErrorInvalidValue;
        g.G[a] = grid[a];
        g.R0[a] = first[a];
        g.RC[a] = count[a];
        g.tstride[a] = (int)ts;
        ts *= grid[a];
        if (a < m) ncell *= count[a];
    }
    if (belems > 0x7fffffffLL || ts > 0x7fffffffLL || ncell > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    g.BK = dims[m];
    g.BJ = dims[m + 1];
    g.BI = dims[m + 2];
    g.belems = belems;
    g.KCH = f[0];
    g.PJ = f[1];
    g.TI = f[2];
    g.H = f[3];
    g.PW = f[4];
    g.D = f[5];
    g.PB = f[6];
    g.NS = f[7];
    g.NRA = f[8];
    g.NRB = f[9];
    g.PSA = f[10];
    g.PSB = f[11];
    g.nitems = f[12];
    g.o_slice = f[13];
    g.o_rows = f[14];
    g.o_pofs = f[15];
    g.o_toff = f[16];
    g.o_tring = f[17];
    g.o_taps = f[18];
    g.klo = f[19];
    g.khi = f[20];
    g.jlo = f[21];
    const int layout = f[22];
    g.NT = ntaps;
    g.RW = g.TI + 2 * g.H;
    g.RA = g.klo + g.khi + 1 + g.D;
    g.RB = 1 + g.D;
    g.ncell = (int)ncell;
    g.nchunk = (count[m] + g.KCH - 1) / (g.KCH > 0 ? g.KCH : 1);
    g.njg = (count[m + 1] + g.PJ - 1) / (g.PJ > 0 ? g.PJ : 1);
    g.nit = g.TI > 0 ? g.BI / g.TI : 0;
    int ri = 0;
    for (int t = 0; t < ntaps; ++t) {
        const int* r = tap_rows + t * (nd + 2);
        const int di = r[nd + 1] < 0 ? -r[nd + 1] : r[nd + 1];
        ri = di > ri ? di : ri;
        if (r[0] < 0 || r[0] >= nf || r[2 + m] < -g.klo || r[2 + m] > g.khi)
            return (int)cudaErrorInvalidValue;
        if (t < BTN_PARAM_TAPS) std::memcpy(&g.c[t], &r[1], sizeof(float));
    }
    const int cpr = (g.TI + 31) / 32;
    if (g.KCH < 1 || g.PJ < 1 || g.TI < 1 || g.BI % g.TI
        || (g.PW != 1 && g.PW != 4) || g.BI % g.PW || g.TI % g.PW
        || g.H % g.PW || g.H < ri || (g.D != 1 && g.D != 2) || g.PB < 1
        || g.PB >= 4096 || g.PJ * g.BJ >= 4096 || cpr >= 128 || g.NS < 1
        || g.NRA < 0 || g.NRB < 0 || g.klo < 0 || g.khi < 0
        || g.klo > g.BK || g.khi > g.BK
        || g.nitems < g.PB * ((g.PJ * g.BJ + BT_UR - 1) / BT_UR) * cpr
        || (long long)(g.KCH + 2) * g.BK + g.klo + g.khi + 1 >= BT_PLANE_SPAN
        || stream_nd_smem_bytes(g) > smem_bytes)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < nf; ++i)
        g.x[i] = (const float*)ptrs[i];
    const long long blocks = (long long)g.ncell * g.nit * g.njg * g.nchunk;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int* in = (const int*)info;
    const int* tb = (const int*)table;
    float* o = (float*)out;
    cudaStream_t st = (cudaStream_t)stream;
    if (layout && nd == 5 && star11_matches(tap_rows, ntaps))
        return (int)launch_nd<5, LayoutStar11>(g, in, tb, o, blocks, threads,
                                               smem_bytes, st);
    switch (nd) {
    case 5: return (int)launch_nd<5, LayoutRuntime>(g, in, tb, o, blocks,
                                                    threads, smem_bytes, st);
    case 6: return (int)launch_nd<6, LayoutRuntime>(g, in, tb, o, blocks,
                                                    threads, smem_bytes, st);
    case 7: return (int)launch_nd<7, LayoutRuntime>(g, in, tb, o, blocks,
                                                    threads, smem_bytes, st);
    default: return (int)launch_nd<8, LayoutRuntime>(g, in, tb, o, blocks,
                                                     threads, smem_bytes,
                                                     st);
    }
}
