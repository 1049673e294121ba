// The y-streaming block body of kernel K6 (pencil_sweep_2d.cu).
//
// One block owns TX columns of x from x0 (the last x tile may end past X:
// its columns there are computed from wrapped loads and not stored) and a
// chunk of output brick rows
// [r0, r1) (domain rows [P0, P1) = [r0*BY, r1*BY)).  It walks the chunk's
// rows in groups of G rows (G a multiple of R6_UR = 8, at least ylo + yhi)
// as a wavefront over the F fused levels.  Level l (0..F) starts at row
// S_l = P0 - (F - l)*ylo: level 0 is the slab's first row, level F the
// first output row.  Its group k is rows [S_l + k*G, S_l + (k+1)*G), and
// reads level l-1's groups k and k + 1 (the first ylo + yhi rows of the
// latter): S_l = S_{l-1} + ylo, so row S_l + k*G + u reads rows S_{l-1} +
// k*G + u + ylo + dy, dy in [-ylo, yhi].  Level 0's group k arrives at step
// k (loaded D groups ahead by cp.async); level 1 computes its group k at
// step k + 1, and level l >= 2 at step k + 2l - 1: two steps behind level
// l-1, so every group a level reads was finished a step earlier, and one
// barrier per step (after level 0's arrival) orders everything.  Level F
// goes straight to the output bricks.
//
// No clamp between levels.  K6 applies none (pencil_kernel_2d.py): level 0
// at row yy is row yy mod BY of brick T[clip(floor(yy / BY))], and level l
// at a row is a function of level l-1's rows alone.  So a level's rows
// computed in one chunk equal the same rows in the first design's
// per-brick trapezoid, and a chunk needs only to start level 0 F*ylo rows
// early (the pre-roll is the wavefront's fill).
//
// Rings.  Level 0 keeps D + 2 groups per input field, levels 1..F-1 three
// (the two read, the one written), each a run of rows of RW = TX + 2H
// floats: RAD rows of padding, the slots, then 2*RAD rows that continue
// slot N-1 into slot 0: whoever writes a row of slot 0 below ylo + yhi also
// writes it there, so a read running past the last slot finds the next
// group's first rows (the rest of those rows, and the front padding, meet
// zero coefficients only, which are skipped; H + 32 floats of padding
// around each ring take the column reach).  Every level keeps the same
// column coordinates (column H is x0); intermediate levels compute all RW
// columns, margins included (a needed column never reads a margin column
// whose sources were missing), level F the TX output columns.
//
// Threads.  A warp item is (level, strip of 8 rows of the level's group,
// NC runs of 32 columns); a step's items over its active levels are spread
// over the warps.  A thread computes 8 rows of a column: per (field, dx)
// group it reads the 8 + 2*RAD rows of its column into registers and
// applies every dy of the group from there (3.75 shared loads per output
// for the 9-point box), as the first design did; warps read 32 consecutive
// columns.  Under the box's compiled body (LayoutBox9: its groups, its
// coefficients as constant operands, the row width compiled in) an item
// takes two runs of columns, all 60 loads before the FMAs.  Each output's
// sum is the first design's: acc = 0, then acc = fmaf(c, x, acc) over the
// groups in order and dy in order, zero coefficients skipped; so the new
// K6 equals the old bit for bit.
//
// Level 0 comes in PW-float pieces (16-byte cp.async.cg where PW = 4),
// each piece wrapping modulo X as a whole; the block's brick table (the
// element offset of each brick row it touches, clamped to the table's
// edge) is made once per block.
#pragma once

#include <cuda_runtime.h>

#include "pencil_stream.cuh"

#define R6_UR 8                 // rows a thread computes at once
#define R6_THREADS 256
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

// The 9-point box folded as K6 folds it (Plan2D.groups, bench.py's box):
// one field, groups dx = 0, 1, -1 in that order, each with its three dy
// coefficients, all non-zero.  Under it the coefficients are compile-time
// indices into the kernel parameters (constant operands of the FMAs) and a
// column's rows are addressed once for the three groups; the row width RW_
// (tile and margins) is compiled in too, so the 30 loads of an item are
// immediate offsets from one address.
template <int RW_>
struct LayoutBox9 {
    // NC: 32-column chunks a warp's item takes (twice the independent
    // loads in flight)
    static constexpr int NG = 3, RAD = 1, RW = RW_, NC = 2;
    __host__ __device__ static constexpr int dx(int q) {
        constexpr int v[NG] = {0, 1, -1};
        return v[q];
    }
};

// the generic body: groups, fields and coefficients read at run time
struct LayoutRowsRuntime {
    static constexpr int NG = 0, RW = 0, NC = 1;
};

struct RowGeom {
    int GY, BY, X;                      // table rows, brick rows, width
    int Y0, Y1, YCH, nchunk;            // output brick rows, chunks
    int TX, nxt;                        // columns per block, x tiles
    int H, PW, D, G;                    // level-0 margin, piece, lookahead,
                                        // rows per group
    int F;                              // fused levels
    int ylo, yhi, xlo, xhi;             // stencil radius per side
    int nf;                             // input fields
};

// floats around each ring: a tap's column reach and level F's lanes past
// an x tile that is not a multiple of 32
__host__ __device__ __forceinline__ int row_pad(const RowGeom& g) {
    return g.H + 32;
}

// Floats of one ring of `slots` groups (padding included).
__host__ __device__ __forceinline__ int row_ring_floats(const RowGeom& g,
                                                        int rad, int slots) {
    return (3 * rad + slots * g.G) * (g.TX + 2 * g.H) + 2 * row_pad(g);
}

// Brick rows a block's level 0 touches at most.
__host__ __device__ __forceinline__ int row_bricks(const RowGeom& g) {
    return (g.YCH * g.BY + g.F * (g.ylo + g.yhi) + g.G - 1) / g.BY + 2;
}

// The rings' floats: level 0's (one per field), levels 1..F-1's, rounded
// up to even so that the 64-bit tables after them are aligned.
__host__ __device__ __forceinline__ int row_floats(const RowGeom& g,
                                                   int rad) {
    const int n = g.nf * row_ring_floats(g, rad, g.D + 2)
                  + (g.F - 1) * row_ring_floats(g, rad, 3);
    return (n + 1) & ~1;
}

// A block's whole dynamic shared memory: the rings, the brick table and
// two buffers of the output rows' offsets (one per step parity).
__host__ __device__ __forceinline__ long long row_smem_bytes(
    const RowGeom& g, int rad) {
    return 4LL * row_floats(g, rad) + 8LL * row_bricks(g) + 16LL * g.G;
}

// wait until at most `pending` (0 to 2) committed groups are in flight
__device__ __forceinline__ void r6_cp_wait(int pending) {
#ifdef __CUDA_ARCH__
    if (pending >= 2)
        asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    else if (pending == 1)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

template <int RAD, class LY>
__device__ __forceinline__ void row_block(const K6Ptrs& p,
                                          const int* __restrict__ table,
                                          const RowGeom& g,
                                          const K6Taps& taps, int b,
                                          float* smem) {
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int xt = b % g.nxt;
    const int ch = b / g.nxt;
    const int F = g.F, BY = g.BY, X = g.X, G = g.G, H = g.H;
    const int ylo = g.ylo, ry = g.ylo + g.yhi;
    const int rc0 = g.Y0 + ch * g.YCH;
    const int rc1 = min(rc0 + g.YCH, g.Y1);
    const int P0 = rc0 * BY, P1 = rc1 * BY, L = P1 - P0;
    const int x0 = xt * g.TX;
    const int RW = LY::RW > 0 ? LY::RW : g.TX + 2 * H;
    const int N0 = g.D + 2;
    const int PAD = row_pad(g);
    const int RING0 = row_ring_floats(g, RAD, N0);
    const int RING1 = row_ring_floats(g, RAD, 3);
    const long long brick = (long long)BY * X;

    // ring origins (slot 0, row 0, column 0) of level 0's field f and of
    // level l in 1..F-1
    auto ring0 = [&](int f) { return smem + f * RING0 + PAD + RAD * RW; };
    auto ring = [&](int l) {
        return smem + g.nf * RING0 + (l - 1) * RING1 + PAD + RAD * RW;
    };

    // the block's brick table: brick rows [kbf, kbf + NKB), each the
    // element offset of its (clamped) brick
    long long* bt = (long long*)(smem + row_floats(g, RAD));
    long long* rowofs = bt + row_bricks(g);
    const int S0 = P0 - F * ylo;
    const int kbf = floor_div(S0, BY);
    const int n0 = (L + F * ry + G - 1) / G;          // level 0's groups
    const int NKB = floor_div(S0 + n0 * G - 1, BY) - kbf + 1;
    for (int e = tid; e < NKB; e += nthr)
        bt[e] = (long long)table[clamp_int(kbf + e, 0, g.GY - 1)] * brick;
    __syncthreads();

    // level 0's group k into its slot (and the slot-0 rows below ry into
    // the run past the last slot), every field, in PW-float pieces
    const int PW = g.PW, NP = RW / PW;
    const float invBY = 1.0f / BY;
    const PlaneWalk w0(tid, nthr, NP);
    constexpr int R6_PIECES = 4;
    const int npc = (G * NP - tid + nthr - 1) / nthr;
    int pcr[R6_PIECES], pcc[R6_PIECES], pcx[R6_PIECES];
    {
        PlaneWalk w = w0;
#pragma unroll
        for (int q = 0; q < R6_PIECES; ++q) {
            int xx = x0 - H + w.c * PW;
            while (xx < 0) xx += X;
            while (xx >= X) xx -= X;
            pcr[q] = w.r;
            pcc[q] = w.c;
            pcx[q] = xx;
            w.next();
        }
    }
    const float* const in0 = p.in[0];
    auto piece = [&](int k, int slot, int r, int c, int xx) {
        const int y = S0 + k * G + r;                // its domain row
        const int kr = div_by(y - kbf * BY, invBY);
        const long long src = bt[kr] + (long long)(y - (kbf + kr) * BY) * X
                              + xx;
        for (int f = 0; f < g.nf; ++f) {
            float* dst = ring0(f) + (slot * G + r) * RW + c * PW;
            const float* s = (f ? p.in[f] : in0) + src;
            if (PW == 4)
                bt_cp_async16(dst, s);
            else
                bt_cp_async4(dst, s);
            if (slot == 0 && r < ry) {
                float* m = dst + N0 * G * RW;
                if (PW == 4)
                    bt_cp_async16(m, s);
                else
                    bt_cp_async4(m, s);
            }
        }
    };
    auto issue = [&](int k) {
        const int slot = (int)((unsigned)k % (unsigned)N0);
        if (npc <= R6_PIECES) {
#pragma unroll
            for (int q = 0; q < R6_PIECES; ++q) {
                if (q >= npc) break;
                piece(k, slot, pcr[q], pcc[q], pcx[q]);
            }
        } else {
            PlaneWalk w = w0;
            for (int e = tid; e < G * NP; e += nthr) {
                int xx = x0 - H + w.c * PW;
                while (xx < 0) xx += X;
                while (xx >= X) xx -= X;
                piece(k, slot, w.r, w.c, xx);
                w.next();
            }
        }
        bt_cp_commit();
    };

    // level l's groups, and the step at which it computes its group k
    // (divisions by float reciprocals: exact below 2^20)
    const float invG = 1.0f / G;
    auto ngroups = [&](int l) {
        return div_by(L + (F - l) * ry + G - 1, invG);
    };
    auto lag = [&](int l) { return l == 1 ? 1 : 2 * l - 1; };
    const int nF = ngroups(F);
    const int nsteps = nF + lag(F);
    const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
    const int nstrip = G / R6_UR;
    // a step's items, level F's first, then levels 1..F-1's, each level
    // nstrip strips of cmid (cout at level F) runs of NC 32-column chunks;
    // items of a level with no group this step (the wavefront's fill and
    // drain) are skipped
    constexpr int NC = LY::NC;
    const int cmid = (((RW + 31) >> 5) + NC - 1) / NC;
    const int cout = (((g.TX + 31) >> 5) + NC - 1) / NC;
    const int PERF = nstrip * cout, PER = nstrip * cmid;
    const int nitems = PERF + (F - 1) * PER;
    const float invPER = 1.0f / PER, invCM = 1.0f / cmid;
    const float invN0 = 1.0f / N0;
    const float invCO = 1.0f / cout;
    float* const out0 = p.out[0];

    for (int d = 0; d < g.D; ++d) {
        if (d < n0)
            issue(d);
        else
            bt_cp_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
        // the output rows' offsets of level F's group this step
        const int kF = s - lag(F);
        long long* ro = rowofs + (s & 1) * G;
        if (kF >= 0 && kF < nF)
            for (int r = tid; r < G; r += nthr) {
                const int y = P0 + kF * G + r;
                if (y < P1) {
                    // its brick row, from the block's brick table (no clamp
                    // applies to an output row)
                    const int kr = div_by(y - kbf * BY, invBY);
                    ro[r] = bt[kr] + (long long)(y - (kbf + kr) * BY) * X
                            + x0;
                }
            }
        r6_cp_wait(g.D - 1);
        __syncthreads();
        if (s + g.D < n0)
            issue(s + g.D);
        else
            bt_cp_commit();
        for (int item = warp; item < nitems; item += nwarp) {
            int l = F, rest = item;
            if (item >= PERF) {
                rest = item - PERF;
                l = div_by(rest, invPER);
                rest -= l * PER;
                ++l;
            }
            const int k = s - lag(l);
            if (k < 0 || k >= ngroups(l)) continue;
            const bool last = l == F;
            const int strip = div_by(rest, last ? invCO : invCM);
            const int col = 32 * NC * (rest - strip * (last ? cout : cmid))
                            + lane;
            const int u0 = strip * R6_UR;          // first row in the group
            // level l-1's rows of group k from row u0 + ylo - RAD on,
            // column col (+ H at level F: its columns are the outputs')
            const int sk = l == 1 ? mod_by(k, N0, invN0)
                                  : (int)((unsigned)k % 3u);
            const float* src = (l == 1 ? ring0(0) : ring(l - 1))
                               + (sk * G + u0 + ylo - RAD) * RW
                               + (last ? H + col : col);
            // the item's results of column c: to the output bricks (level
            // F) or to level l's ring
            auto store = [&](int o, int c, const float* acc) {
                if (last) {
                    if (c < g.TX && x0 + c < X) {
                        float* dst = o ? p.out[o] : out0;
                        const int nrow = P1 - P0 - k * G - u0;
#pragma unroll
                        for (int i = 0; i < R6_UR; ++i)
                            if (i < nrow) dst[ro[u0 + i] + c] = acc[i];
                    }
                } else if (c < RW) {
                    const int slot = (int)((unsigned)k % 3u);
                    float* dst = ring(l) + (slot * G + u0) * RW + c;
#pragma unroll
                    for (int i = 0; i < R6_UR; ++i) dst[i * RW] = acc[i];
                    if (slot == 0 && u0 < ry) {
#pragma unroll
                        for (int i = 0; i < R6_UR; ++i)
                            if (u0 + i < ry) dst[(3 * G + i) * RW] = acc[i];
                    }
                }
            };
            if constexpr (LY::NG > 0) {
                // the compiled groups over NC chunks: every row of each
                // column read once for every group (the dx as immediate
                // offsets), all loads before the FMAs, the coefficients
                // constant operands; each sum in the groups' order
                float v[NC][LY::NG][R6_UR + 2 * RAD];
                const float* r = src;
#pragma unroll
                for (int j = 0; j < R6_UR + 2 * RAD; ++j) {
#pragma unroll
                    for (int h = 0; h < NC; ++h)
#pragma unroll
                        for (int q = 0; q < LY::NG; ++q)
                            v[h][q][j] = r[32 * h + LY::dx(q)];
                    r += RW;
                }
#pragma unroll
                for (int h = 0; h < NC; ++h) {
                    float acc[R6_UR];
#pragma unroll
                    for (int i = 0; i < R6_UR; ++i) acc[i] = 0.0f;
#pragma unroll
                    for (int q = 0; q < LY::NG; ++q)
#pragma unroll
                        for (int d = 0; d < 2 * RAD + 1; ++d) {
                            const float cd = taps.coef[q * (2 * RAD + 1) + d];
#pragma unroll
                            for (int i = 0; i < R6_UR; ++i)
                                acc[i] = fmaf(cd, v[h][q][i + d], acc[i]);
                        }
                    store(0, col + 32 * h, acc);
                }
            } else {
                for (int o = 0; o < (last ? taps.nout : 1); ++o) {
                    float acc[R6_UR];
#pragma unroll
                    for (int i = 0; i < R6_UR; ++i) acc[i] = 0.0f;
                    for (int q = taps.gbeg[o]; q < taps.gbeg[o + 1]; ++q) {
                        const float* cp = src + taps.gfield[q] * RING0
                                          + taps.gdx[q];
                        float v[R6_UR + 2 * RAD];
#pragma unroll
                        for (int j = 0; j < R6_UR + 2 * RAD; ++j)
                            v[j] = cp[j * RW];
                        const float* cf = taps.coef + q * (2 * RAD + 1);
#pragma unroll
                        for (int d = 0; d < 2 * RAD + 1; ++d) {
                            const float cd = cf[d];
                            if (cd != 0.0f) {
#pragma unroll
                                for (int i = 0; i < R6_UR; ++i)
                                    acc[i] = fmaf(cd, v[i + d], acc[i]);
                            }
                        }
                    }
                    store(o, col, acc);
                }
            }
        }
    }
    // drain the (empty) trailing groups before the block ends
    bt_cp_wait(0);
}
