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
// fuse-4 sweep at 16384^2 must move 2.15 GB, 0.64 ms at 3.35 TB/s.  Inside
// the SM, the levels' arithmetic (some 15 instructions per output and
// level) comes close to that too, so what a design recomputes costs time.
//
// What the design does about it (row_stream.cuh says how).  Bricks are
// whole rows, so there is no j axis and no MXU form to carry over (the TPU
// kernel's banded matmuls have no counterpart here).  The first design
// (one block per output brick row, its slab staged as one 4-byte copy per
// element, the levels ping-ponging over a trapezoid recomputed per brick
// row) ran the box at fuse 4 at 22% of its bound, its intermediate levels
// half the time.  This one streams y: a block owns TX columns and a chunk
// of brick rows, and walks the rows in groups of 8 as a wavefront over the
// levels, each level a ring of groups in shared memory, level 0 arriving
// by 16-byte cp.async two groups ahead.  Each level's rows are computed
// once per chunk, not once per brick row, and one barrier per step orders
// the levels (each runs two steps behind the one below).  A thread
// computes 8 rows of a column with the column's values in registers; the
// 9-point box's groups and its row widths (tiles whose rows are 128, 256
// or 512 floats) are compiled in (LayoutBox9), other folded forms and
// widths run the generic body.
// Each output's sum keeps the first design's order: bit for bit the same.

#include "row_stream.cuh"

template <int RAD, class L>
__global__ void __launch_bounds__(R6_THREADS)
pencil_sweep_2d_kernel(K6Ptrs p, const int* __restrict__ table, RowGeom g,
                       K6Taps t) {
    extern __shared__ __align__(16) float smem[];
    row_block<RAD, L>(p, table, g, t, blockIdx.x, smem);
}

template <int RAD, class L = LayoutRowsRuntime>
static cudaError_t k6_launch(int blocks, int threads, int smem_bytes,
                             cudaStream_t stream, const K6Ptrs& p,
                             const int* table, const RowGeom& g,
                             const K6Taps& t) {
    cudaError_t err = cudaFuncSetAttribute(
        pencil_sweep_2d_kernel<RAD, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    pencil_sweep_2d_kernel<RAD, L><<<blocks, threads, smem_bytes, stream>>>(
        p, table, g, t);
    return cudaGetLastError();
}

// The folded groups equal layout L's: one field, one output, L's dx in
// order, every coefficient over [-RAD, RAD] non-zero.
template <class L>
static bool row_layout_matches(const K6Taps& t, int nf, int rad,
                               int ngroups) {
    if (nf != 1 || t.nout != 1 || rad != L::RAD || ngroups != L::NG)
        return false;
    for (int q = 0; q < L::NG; ++q)
        if (t.gfield[q] != 0 || t.gdx[q] != L::dx(q))
            return false;
    for (int q = 0; q < L::NG * (2 * L::RAD + 1); ++q)
        if (t.coef[q] == 0.0f)
            return false;
    return true;
}

// ins/outs: arrays of nf/nout device pointers.  Output brick rows [Y0, Y1)
// in chunks of YCH, TX columns per block (the last tile cut at X), level-0
// margin H, piece PW (4 or 1 floats), D groups ahead, G rows per group.  gbeg: nout + 1 group
// bounds; gfield, gdx: per group; coef: ngroups * (2*rad + 1) floats.
// smem_bytes must hold the block's layout (row_smem_bytes).
extern "C" int bt_pencil_sweep_2d(const long long* ins, const long long* outs,
                                  const void* table, int nf, int nout,
                                  int GY, int BY, int X, int Y0, int Y1,
                                  int F, int ylo, int yhi, int xlo, int xhi,
                                  int YCH, int TX, int H, int PW, int D,
                                  int G, int rad, int ngroups,
                                  const int* gbeg, const int* gfield,
                                  const int* gdx, const float* coef,
                                  int smem_bytes, int threads, void* stream) {
    if (nf < 1 || nf > K6_MAX_FIELDS || nout < 1 || nout > K6_MAX_OUT
        || ngroups < 1 || ngroups > K6_MAX_GROUPS
        || ngroups * (2 * rad + 1) > K6_MAX_COEF || F < 1 || TX < 1
        || Y1 <= Y0 || YCH < 1 || threads != R6_THREADS
        || (F > 1 && (nf != 1 || nout != 1))
        || ylo > rad || yhi > rad || xlo > X || xhi > X
        || (PW != 1 && PW != 4) || X % PW || TX % PW || H % PW
        || H < F * (xlo > xhi ? xlo : xhi) || D < 1 || D > 3
        || G < ylo + yhi || G % R6_UR || gbeg[0] != 0
        || gbeg[nout] != ngroups)
        return (int)cudaErrorInvalidValue;
    K6Ptrs p = {};
    for (int f = 0; f < nf; ++f) p.in[f] = (const float*)ins[f];
    for (int o = 0; o < nout; ++o) p.out[o] = (float*)outs[o];
    K6Taps t = {};
    t.nout = nout;
    for (int o = 0; o <= nout; ++o) t.gbeg[o] = gbeg[o];
    for (int q = 0; q < ngroups; ++q) {
        if (gfield[q] < 0 || gfield[q] >= nf)
            return (int)cudaErrorInvalidValue;
        t.gfield[q] = gfield[q];
        t.gdx[q] = gdx[q];
    }
    for (int q = 0; q < ngroups * (2 * rad + 1); ++q) t.coef[q] = coef[q];
    const int nchunk = (Y1 - Y0 + YCH - 1) / YCH;
    const int nxt = (X + TX - 1) / TX;
    RowGeom g = {GY, BY, X, Y0, Y1, YCH, nchunk, TX, nxt, H, PW, D, G, F,
                 ylo, yhi, xlo, xhi, nf};
    const long long blocks = (long long)nchunk * nxt;
    // a chunk's rows, counted from its first brick row, stay below
    // BT_PLANE_SPAN (the division-free brick rows)
    const long long span = (long long)(YCH + 2) * BY
                           + (long long)F * (ylo + yhi) + G;
    if (blocks > 0x7fffffffLL || span >= BT_PLANE_SPAN
        || row_smem_bytes(g, rad) > smem_bytes)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int* tb = (const int*)table;
    // the box's compiled body at the row widths it is compiled for
    if (row_layout_matches<LayoutBox9<128>>(t, nf, rad, ngroups)) {
        const int rw = TX + 2 * H;
        if (rw == 128)
            return (int)k6_launch<1, LayoutBox9<128>>(
                (int)blocks, threads, smem_bytes, st, p, tb, g, t);
        if (rw == 256)
            return (int)k6_launch<1, LayoutBox9<256>>(
                (int)blocks, threads, smem_bytes, st, p, tb, g, t);
        if (rw == 512)
            return (int)k6_launch<1, LayoutBox9<512>>(
                (int)blocks, threads, smem_bytes, st, p, tb, g, t);
    }
    switch (rad) {
        case 1: return (int)k6_launch<1>((int)blocks, threads, smem_bytes, st, p, tb, g, t);
        case 2: return (int)k6_launch<2>((int)blocks, threads, smem_bytes, st, p, tb, g, t);
        case 4: return (int)k6_launch<4>((int)blocks, threads, smem_bytes, st, p, tb, g, t);
        case 8: return (int)k6_launch<8>((int)blocks, threads, smem_bytes, st, p, tb, g, t);
        default: return (int)cudaErrorInvalidValue;
    }
}
