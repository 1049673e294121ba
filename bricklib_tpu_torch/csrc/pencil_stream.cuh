// The k-streaming block body of kernel K1 (pencil_sweep.cu).
//
// One block owns a chunk of output brick rows [kc0, kc1) of one subdomain,
// a group of output pencils [jp0, jp1) and TI lanes of i from i0.  It walks
// the chunk's planes in increasing k as a wavefront over the F fused
// levels: at step s, level-0 plane a = P0 - F*klo + s has arrived, and
// level f (1..F) computes its plane a - f*khi - (the skewed boundaries
// below f), which needs level f-1's planes up to a - (f-1)*khi - ...: the
// one just computed, with a barrier between the two levels, or, where the
// boundary f-1 -> f is skewed, the one computed a step earlier, with no
// barrier.  Each intermediate level keeps a ring of rk + 1 planes (rk =
// klo + khi), one more below a skewed boundary; level 0 keeps rk + 1 + D,
// D planes being loaded ahead with cp.async while the block computes.
// Level F goes straight to the output bricks.  So the k halo of a chunk is
// loaded and computed once per chunk, not once per brick row; only j and i
// keep a halo, F radii deep at level 0 and one radius less per level.  The
// planner picks the skewed boundaries (a barrier saved against a plane of
// shared memory, so a narrower footprint).
//
// Shared memory, in floats: H floats, the level-0 ring, the rings of
// levels 1 to F-1 (every plane a [rows][RW] array, RW = TI + 2H, the same
// i coordinates at every level: column H is lane i0), stream_slack floats,
// then the block's brick table (one 64-bit element offset per (brick row,
// pencil) the block touches, clamps applied), per level-0 row its pencil
// index in that table and its in-brick j offset times BI, and two buffers
// of the output rows' offsets in X (one per step parity).  The table
// lookups and the j and k clamps of level 0 are done there once per block;
// a level-0 row's start in X is then one shared load and two adds per
// plane, an output row's one shared load.
//
// Threads take fixed elements of each plane, with no division, and reuse
// what they load in registers.  A thread computes BT_UR = 4 rows of one
// column at once (lanes on consecutive columns, so every warp access of
// shared and device memory is one contiguous run).  Levels 1 to F-1
// compute whole rows of RW columns, margins included (a needed column
// never reads a margin column, so their values do not matter), as a run of
// (quads of rows x RW columns); level F computes the output lanes only,
// items (quad, 32 lanes) spread evenly over the warps.  Register reuse
// along j: under a tap layout compiled in (tap_layouts.cuh: the 7-point
// star, the 125-point cube) every tap's offset is a compile-time constant,
// so the compiler loads each (plane, row, lane) that several taps and rows
// read once: the star's 7 taps over 4 rows read 22 values, not 28 (its
// centre column's 3 j taps share 6 rows); the cube's 125 read 200, not 500
// (each (dk, di) column's 5 j taps share 8 rows).  Other tap lists take
// the generic body: offsets read at run time, one load per tap and row.
// Each output's sum is the chain acc = 0; acc += c[t] * x[t] in tap order,
// whatever the footprint, body or kernel (K1, and K11's sweep blocks), so
// one level computed by any of them is the same bit for bit: reuse changes
// which value is loaded when, never the order of a sum.
//
// Level 0 comes in PW-float pieces (PW = 4: 16-byte cp.async.cg, straight
// to shared memory without registers), each piece of a row wrapping modulo
// BI as a whole (BI and H are multiples of PW), so the i wrap costs nothing
// inside the block: the H-wide margins hold the wrapped lanes (on an
// i-bricked table, IB, a piece reads the brick column of its lanes through
// the block's brick table instead, the margins the neighbouring columns',
// and an output lane goes to its brick column's offset: pencil_sweep.cu
// says what such a table means).  A 16-byte
// piece is read through L2 (.cg), never a line of the SM's L1; a 4-byte
// piece (PW = 1) takes cp.async.ca, through L1, unless CG is set: then it
// is an __ldcg load and a shared store.  K11 sets CG, since it reads ghost
// bricks that other blocks of its launch (or another card) have just
// written.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "pencil_sweep.cuh"
#include "tap_layouts.cuh"

#define BT_STREAM_THREADS 512
#define BT_UR 4                 // output rows a thread computes at once

struct StreamGeom {
    int GK, GJ, BK, BJ, BI;             // table and brick shape
    int K0, K1;                         // output brick rows
    int KCH, nchunk;                    // brick rows per chunk, chunks
    int J0, J1;                         // output pencils
    int PJ, njg;                        // pencils per block, pencil groups
    int TI, nit;                        // i lanes per block, i tiles
    int H, PW, D;                       // level-0 i margin, piece, lookahead
    int F;                              // fused levels
    int klo, khi, jlo, jhi, ilo, ihi;   // stencil radius per side
    long long stride;                   // bricks per subdomain
    int edge_lo, edge_hi;               // chunk 0 / the last chunk reach
                                        // below / above the table
    int stash_lo, stash_hi;             // stash floats per block and edge
    int skew;                           // bit f: levels f, f+1 skewed
};

// An i-bricked table (GI > 0): its bricks in i and the output lanes [IL0,
// IL1); all zero on the pencil layout.  The kernels take it as a last
// argument of its own, so the pencil layout's parameters keep their
// places.
struct IBrickGeom {
    int GI, IL0, IL1;
};

// Brick columns a run of w lanes may touch on an i-bricked table, starting
// anywhere in a brick of BI lanes (the host's ib_cols).
__host__ __device__ __forceinline__ int ib_cols(int w, int BI) {
    return (w + BI - 1) / BI + 1;
}

// An i-bricked block's brick table, filled by threads tid, tid + nthr, ...:
// brick rows [kbf, kbf + NKB), pencils [jbf, jbf + NJB) (NJBM entries a
// brick row) and brick columns [ibf, ibf + NIBM), each entry the element
// offset of its (clamped) brick in X, the sub-table of sub at bofs.
__device__ __forceinline__ void ib_fill_table(
    long long* bt, const int* __restrict__ table, int tid, int nthr, int NKB,
    int NJBM, int NJB, int NIBM, int kbf, int jbf, int ibf, int GK, int GJ,
    int GI, long long bofs, long long brick) {
    for (int e = tid; e < NKB * NJBM * NIBM; e += nthr) {
        const int ac = e / NIBM, d = e - ac * NIBM;
        const int a = ac / NJBM, c = ac - a * NJBM;
        if (c < NJB)
            bt[e] = (bofs + table[(clamp_int(kbf + a, 0, GK - 1) * GJ
                                   + clamp_int(jbf + c, 0, GJ - 1)) * GI
                                  + clamp_int(ibf + d, 0, GI - 1)])
                    * brick;
    }
}

// Level-0 lane ii (from the block's first brick column ibf's lane 0 at
// ibf * BI) of level-0 row r, on an i-bricked table: its (pencil, brick
// column) index in the brick table and its offset in X within the brick
// row; rowinfo holds each row's pencil and in-brick j offset.
__device__ __forceinline__ void ib_piece(const int* rowinfo, int r, int ii,
                                         int BI, int NIBM, int ibf, int& pb,
                                         int& po) {
    const int ib = floor_div(ii, BI);
    pb = rowinfo[2 * r] * NIBM + ib - ibf;
    po = rowinfo[2 * r + 1] + ii - ib * BI;
}

// An i-bricked block's output rows' offsets in X, filled by threads tid,
// tid + nthr, ...: one per output row r < WJ (level-0 row r + rl) and
// brick column [obf, obf + NOB), at the column's lane 0, plus kofs; btrow
// is the brick row's part of the brick table.
__device__ __forceinline__ void ib_fill_rowofs(
    long long* ro, const long long* btrow, const int* rowinfo, int tid,
    int nthr, int WJ, int NOB, int rl, int NIBM, int obf, int ibf,
    long long kofs) {
    for (int e = tid; e < WJ * NOB; e += nthr) {
        const int r = e / NOB, ob = e - r * NOB;
        const int r0 = r + rl;
        ro[e] = btrow[rowinfo[2 * r0] * NIBM + min(obf + ob - ibf, NIBM - 1)]
                + kofs + rowinfo[2 * r0 + 1];
    }
}

__device__ __forceinline__ void bt_cp_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
#else
    for (int u = 0; u < 4; ++u) dst[u] = src[u];
#endif
}

__device__ __forceinline__ void bt_cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void bt_cp_commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most `pending` (0 or 1) committed groups are in flight
__device__ __forceinline__ void bt_cp_wait(int pending) {
#ifdef __CUDA_ARCH__
    if (pending > 0)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// q mod m for 0 <= q < 2^20, from inv = 1.0f / m (correctly rounded): the
// float quotient is then within 0.5/m of (q + 0.5)/m, so it truncates to
// floor(q/m), whatever m
__device__ __forceinline__ int mod_by(int q, int m, float inv) {
    return q - m * div_by(q, inv);
}

// Planes stay below 2^20 once counted from a phase's first plane or from
// the block's first brick row (bt_pencil_sweep refuses longer chunks).
#define BT_PLANE_SPAN (1 << 20)

// Floats a level may read past its source plane: a tap's reach ihi <= H
// and level F's lanes past an i tile that is not a multiple of 32 (up to
// 31); with bricks less than BT_UR deep in j a block may hold fewer rows
// than a quad, whose last rows read up to BT_UR - BJ rows beyond.
__host__ __device__ __forceinline__ int stream_slack(int RW, int H,
                                                     int BJ) {
    return H + 40 + (BJ < BT_UR ? (BT_UR - BJ) * RW : 0);
}

// Floats of the rings, H floats before them (a tap may read up to ilo <= H
// floats before a plane) and the slack after, rounded up to an even count
// so that the 64-bit brick table after them is aligned; the host's
// stream_smem counts the same.
__host__ __device__ __forceinline__ int stream_ring_floats(
    const StreamGeom& g) {
    const int rk = g.klo + g.khi, rj = g.jlo + g.jhi;
    const int RW = g.TI + 2 * g.H, WJM = g.PJ * g.BJ;
    int n = (rk + 1 + g.D) * (WJM + g.F * rj) * RW;
    for (int f = 1; f < g.F; ++f)
        n += (rk + 1 + ((g.skew >> f) & 1)) * (WJM + (g.F - f) * rj)
             * RW;
    return (g.H + n + stream_slack(RW, g.H, g.BJ) + 1) & ~1;
}

// A block's whole dynamic shared memory: the rings, the brick table, two
// ints per level-0 row and two buffers of the output rows' offsets; on an
// i-bricked table the brick table keeps a level-0 row's brick columns per
// (brick row, pencil), and each output row an offset per brick column.
__host__ __device__ __forceinline__ long long stream_smem_bytes(
    const StreamGeom& g, const IBrickGeom ib = IBrickGeom{}) {
    const int WJM = g.PJ * g.BJ, rj = g.jlo + g.jhi;
    const int NIBM = ib.GI ? ib_cols(g.TI + 2 * g.H, g.BI) : 1;
    const int NOB = ib.GI ? ib_cols(g.TI, g.BI) : 1;
    return 4LL * stream_ring_floats(g)
           + 8LL * (g.KCH + 2) * (g.PJ + 2) * NIBM
           + 8LL * (WJM + g.F * rj) + 16LL * WJM * NOB;
}

// The walk over a (rows x width) plane: element e = tid + nthr*m at (r, c).
struct PlaneWalk {
    int r, c, dr, dc, width;
    __device__ __forceinline__ PlaneWalk(int tid, int nthr, int w)
        : r(tid / w), c(tid % w), dr(nthr / w), dc(nthr % w), width(w) {}
    __device__ __forceinline__ void next() {
        c += dc;
        r += dr;
        if (c >= width) {
            c -= width;
            ++r;
        }
    }
};

// L: the tap layout (tap_layouts.cuh), LayoutRuntime for the generic body;
// CG: level 0 always through L2 (K11); IB: the table is i-bricked (ibg),
// else one pencil brick per (k, j) cell
template <class L, bool CG = false, bool IB = false>
__device__ __forceinline__ void stream_block(const float* __restrict__ x,
                                             float* __restrict__ out,
                                             const int* __restrict__ table,
                                             const StreamGeom& g,
                                             const SweepTaps& taps, int b,
                                             float* smem, float* stash,
                                             const IBrickGeom ibg =
                                                 IBrickGeom{}) {
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int it = b % g.nit;
    b /= g.nit;
    const int jg = b % g.njg;
    b /= g.njg;
    const int ch = b % g.nchunk;
    const int sub = b / g.nchunk;

    const int F = g.F, BK = g.BK, BJ = g.BJ, BI = g.BI;
    const int klo = g.klo, khi = g.khi, jlo = g.jlo;
    const int rk = klo + khi, rj = jlo + g.jhi;
    const int kc0 = g.K0 + ch * g.KCH;
    const int kc1 = min(kc0 + g.KCH, g.K1);
    const int P0 = kc0 * BK, P1 = kc1 * BK;
    const int jp0 = g.J0 + jg * g.PJ, jp1 = min(jp0 + g.PJ, g.J1);
    const int jo0 = jp0 * BJ, WJ = (jp1 - jp0) * BJ;
    const int i0 = IB ? ibg.IL0 + it * g.TI : it * g.TI;
    const int RW = g.TI + 2 * g.H;
    const int WJM = g.PJ * BJ;
    const int NJ0 = WJ + F * rj;
    const int R0 = rk + 1 + g.D;
    const int PS0 = (WJM + F * rj) * RW;
    const long long brick = (long long)BK * BJ * BI;
    // i-bricked: a level-0 row's brick columns [ibf, ibf + NIBM), an
    // output row's [obf, obf + NOB); one each on the pencil layout
    const int NIBM = IB ? ib_cols(RW, BI) : 1;
    const int NOB = IB ? ib_cols(g.TI, BI) : 1;
    const int ibf = IB ? floor_div(i0 - g.H, BI) : 0;
    const int obf = IB ? i0 / BI : 0;

    // the block's brick table: brick rows [kbf, kbf + NKB), pencils
    // [jbf, jbf + NJB) (and brick columns [ibf, ibf + NIBM)), each entry
    // the element offset of its (clamped) brick in X; then per level-0 row
    // its pencil and in-brick j offset; then the output rows' offsets in X
    // (per brick column), one buffer per step parity
    const int NJBM = g.PJ + 2;
    long long* bt = (long long*)(smem + stream_ring_floats(g));
    int* rowinfo = (int*)(bt + (g.KCH + 2) * NJBM * NIBM);
    long long* rowofs = (long long*)(rowinfo + 2 * (WJM + F * rj));
    const int kbf = floor_div(P0 - F * klo, BK);
    const int NKB = floor_div(P1 + F * khi - 1, BK) - kbf + 1;
    const int jbf = floor_div(jo0 - F * jlo, BJ);
    const int NJB = floor_div(jo0 + WJ + F * g.jhi - 1, BJ) - jbf + 1;
    const long long bofs = sub * g.stride;
    if constexpr (IB) {
        ib_fill_table(bt, table, tid, nthr, NKB, NJBM, NJB, NIBM, kbf, jbf,
                      ibf, g.GK, g.GJ, ibg.GI, bofs, brick);
    } else {
        for (int e = tid; e < NKB * NJBM; e += nthr) {
            const int a = e / NJBM, c = e - a * NJBM;
            if (c < NJB)
                bt[e] = (bofs + table[clamp_int(kbf + a, 0, g.GK - 1) * g.GJ
                                      + clamp_int(jbf + c, 0, g.GJ - 1)])
                        * brick;
        }
    }
    for (int r = tid; r < NJ0; r += nthr) {
        const int j = jo0 - F * jlo + r;
        const int jb = floor_div(j, BJ);
        rowinfo[2 * r] = jb - jbf;
        rowinfo[2 * r + 1] = (j - jb * BJ) * BI;
    }
    __syncthreads();

    const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

    // level-0 plane q into its ring slot, in PW-float pieces, one group;
    // planes beyond the table read the clamped brick row (the table)
    const int PW = g.PW;
    const int NP = RW / PW;
    const int ibase = i0 - g.H;
    const PlaneWalk w0(tid, nthr, NP);
    // this thread's pieces of every plane (at most BT_PIECES; more take
    // the walk): (pencil, brick column) index in the brick table, offset
    // in X within the brick row, offset in the ring slot.  On the pencil
    // layout a piece wraps modulo BI; on an i-bricked table it lies in the
    // brick column of its first lane (BI is a multiple of PW)
    constexpr int BT_PIECES = 3;
    const int npc = (NJ0 * NP - tid + nthr - 1) / nthr;
    int pcb[BT_PIECES], pco[BT_PIECES], pcs[BT_PIECES];
    {
        PlaneWalk w = w0;
#pragma unroll
        for (int p = 0; p < BT_PIECES; ++p) {
            const int r = p < npc ? w.r : 0, c = p < npc ? w.c : 0;
            if constexpr (IB) {
                ib_piece(rowinfo, r, ibase + c * PW, BI, NIBM, ibf, pcb[p],
                         pco[p]);
            } else {
                int ii = ibase + c * PW;
                while (ii < 0) ii += BI;
                while (ii >= BI) ii -= BI;
                pcb[p] = rowinfo[2 * r];
                pco[p] = rowinfo[2 * r + 1] + ii;
            }
            pcs[p] = r * RW + c * PW;
            w.next();
        }
    }
    // Ring slots and brick rows without a division: a ring slot counts a
    // plane from its phase's first plane qb, a brick row from the block's
    // first, kbf (both below 2^20 planes back)
    const float inv0 = 1.0f / R0, invA = 1.0f / (rk + 1);
    const float invB = 1.0f / (rk + 2), invBK = 1.0f / BK;
    auto brick_row = [&](int q) {      // the brick row of plane q, - kbf
        return div_by(q - kbf * BK, invBK);
    };
    auto issue = [&](int q, int qb) {
        const int kr = brick_row(q);
        const long long* btrow = bt + kr * NJBM * NIBM;
        const long long kofs = (long long)(q - (kbf + kr) * BK) * BJ * BI;
        float* dst = smem + g.H + mod_by(q - qb, R0, inv0) * PS0;
        if (npc <= BT_PIECES) {
#pragma unroll
            for (int p = 0; p < BT_PIECES; ++p) {
                if (p >= npc) break;
                const float* src = x + btrow[pcb[p]] + kofs + pco[p];
                if (PW == 4)
                    bt_cp_async16(dst + pcs[p], src);
                else if constexpr (CG)
                    dst[pcs[p]] = __ldcg(src);
                else
                    bt_cp_async4(dst + pcs[p], src);
            }
            bt_cp_commit();
            return;
        }
        PlaneWalk w = w0;
        for (int e = tid; e < NJ0 * NP; e += nthr) {
            const float* src;
            if constexpr (IB) {
                int pb, po;
                ib_piece(rowinfo, w.r, ibase + w.c * PW, BI, NIBM, ibf, pb,
                         po);
                src = x + btrow[pb] + kofs + po;
            } else {
                int ii = ibase + w.c * PW;
                while (ii < 0) ii += BI;
                while (ii >= BI) ii -= BI;
                src = x + btrow[rowinfo[2 * w.r]] + kofs
                      + rowinfo[2 * w.r + 1] + ii;
            }
            float* d = dst + w.r * RW + w.c * PW;
            if (PW == 4)
                bt_cp_async16(d, src);
            else if constexpr (CG)
                *d = __ldcg(src);
            else
                bt_cp_async4(d, src);
            w.next();
        }
        bt_cp_commit();
    };

    // The walks over a level's quads of BT_UR rows: levels 1 to F-1 as one
    // run of (quads x RW columns), margins included, warp w taking the
    // 32-column chunks w, w + nwarp, ...; level F as items (quad, 32 output
    // lanes), warp w taking the items w, w + nwarp, ...
    const int cpr = (g.TI + 31) >> 5;
    const PlaneWalk wf(warp, nwarp, cpr);

    // The k clamp of the intermediate levels.  Level f's planes below the
    // table, [-(F-f)*klo, 0), are its planes [BK - (F-f)*klo, BK); those
    // above, [KT, KT + (F-f)*khi) with KT = GK*BK, its planes [KT - BK,
    // KT - BK + (F-f)*khi).  A block whose chunk reaches an edge stashes
    // those source planes in device memory (its own slice of `stash`, per
    // edge, level and plane) after the barrier that follows them, and
    // copies them back into the ring in place of computing the planes
    // beyond the table.  At the top the stream computes the sources BK
    // steps before it needs them; at the bottom it needs them first, so the
    // block first runs a pre-roll: the same stream over the empty chunk
    // [BK, BK), which computes level f's planes [BK - (F-f)*klo, BK +
    // (F-f)*khi) and stashes the sources (the table has at least two brick
    // rows).
    const int KT = g.GK * BK;
    const bool lo_edge = g.edge_lo && ch == 0;
    const bool hi_edge = g.edge_hi && ch == g.nchunk - 1;
    float* st_blk = stash + (((long long)sub * g.njg + jg) * g.nit + it)
                            * (g.stash_lo + g.stash_hi);
    // plane x of level f's stash of one edge (kr: that edge's radius)
    auto stash_plane = [&](int f, int x, int kr, bool hi) {
        long long o = hi ? g.stash_lo : 0;
        for (int f2 = 1; f2 < f; ++f2)
            o += (long long)(F - f2) * kr * (WJM + (F - f2) * rj) * RW;
        return st_blk + o + (long long)x * (WJM + (F - f) * rj) * RW;
    };

    // One stream per phase over the output planes [p0, p1), level-0 planes
    // [p0 - F*klo, p1 + F*khi), one per step: phase 0 is the pre-roll
    // (chunks at the low edge only), phase 1 the chunk.  EDGE: the block's
    // chunk reaches a k edge (the clamp's code is compiled in only then,
    // out of the other blocks' loop).
    auto stream = [&](auto edge) {
    constexpr bool EDGE = decltype(edge)::value;
    // the skewed level boundaries (none in the edge chunks, whose stash
    // copies a level's plane after the barrier that follows it)
    const int skw = EDGE ? 0 : g.skew;
    const int lagF = F * khi + __popc(skw & ((1 << F) - 2));
    for (int ph = EDGE && lo_edge && F > 1 ? 0 : 1; ph < 2; ++ph) {
    const bool pre = ph == 0;
    const int p0 = pre ? BK : P0, p1 = pre ? BK : P1;
    // level 0 has n0 planes; each skewed boundary delays the levels above
    // it by one step
    const int n0 = (p1 - p0) + F * rk;
    const int nsteps = n0 + __popc(skw & ((1 << F) - 2));
    const int q00 = p0 - F * klo;
    for (int d = 0; d < g.D; ++d) {
        if (d < n0)
            issue(q00 + d, q00);
        else
            bt_cp_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
        // this step's output rows' offsets in X (the other buffer may still
        // be read by the previous step's level F); on an i-bricked table
        // one per output row and brick column, at the column's lane 0
        long long* ro = rowofs + (s & 1) * WJM * NOB;
        const int qF = q00 + s - lagF;
        if (qF >= p0 && qF < p1) {
            const int kr = brick_row(qF);
            const long long* btrow = bt + kr * NJBM * NIBM;
            const long long kofs = (long long)(qF - (kbf + kr) * BK) * BJ * BI
                                   + (IB ? 0 : i0);
            if constexpr (IB) {
                // output row r is level-0 row r + F*jlo
                ib_fill_rowofs(ro, btrow, rowinfo, tid, nthr, WJ, NOB,
                               F * jlo, NIBM, obf, ibf, kofs);
            } else {
                for (int r = tid; r < WJ; r += nthr) {
                    // output row r is level-0 row r + F*jlo
                    const int r0 = r + F * jlo;
                    ro[r] = btrow[rowinfo[2 * r0]] + kofs
                            + rowinfo[2 * r0 + 1];
                }
            }
        }
        bt_cp_wait(g.D - 1);
        __syncthreads();
        if (s + g.D < n0)
            issue(q00 + s + g.D, q00);
        else
            bt_cp_commit();
        const int q0 = q00 + s;
        // level f-1's ring and level f's, as offsets into smem
        int src = g.H, srcR = R0, srcPS = PS0, ring = g.H + R0 * PS0;
        float invs = inv0;
        for (int f = 1; f <= F; ++f) {
            const int qf = q0 - f * khi - __popc(skw & ((1 << f) - 2));
            const int PSf = (WJM + (F - f) * rj) * RW;
            const int n = (WJ + (F - f) * rj) * RW;
            const int Rf = rk + 1 + ((g.skew >> f) & 1);
            const float invf = (g.skew >> f) & 1 ? invB : invA;
            const int dst = ring + mod_by(qf - q00, Rf, invf) * PSf;
            if (qf < p0 - (F - f) * klo || qf >= p1 + (F - f) * khi) {
                // not a plane of this level in this stream
            } else if (EDGE && f < F && (qf < 0 || qf >= KT)) {
                // beyond the table: the stashed source plane
                const float* sp = qf < 0
                    ? stash_plane(f, qf + (F - f) * klo, klo, false)
                    : stash_plane(f, qf - KT, khi, true);
                for (int e = tid; e < n; e += nthr)
                    smem[dst + e] = __ldcg(sp + e);
            } else {
                // plane qf + dk of level f-1 sits in slot qnk + dk (mod
                // srcR): the newest, qf + khi, in slot qnk + khi
                const int qnk = mod_by(qf + khi - q00, srcR, invs) - khi;
                // BT_UR outputs of one column from element e of level f (in
                // the buffers' (row, column) coordinates, row stride RW),
                // rows e, e + RW, ...; store(u, value) takes each result.
                // Each output's sum is acc = 0; acc += c[t] * x[t] in tap
                // order.
                auto rows = [&](int e, auto&& store) {
                    float acc[BT_UR];
#pragma unroll
                    for (int u = 0; u < BT_UR; ++u) acc[u] = 0.0f;
                    if constexpr (L::N > 0) {
                        // the layout's offsets are compile-time constants: a
                        // value that several taps and rows read, (plane,
                        // row, lane), is one load kept in a register
                        const float* pl[2 * L::R + 1];
#pragma unroll
                        for (int d = 0; d <= 2 * L::R; ++d) {
                            int sl = qnk + d - L::R;
                            if (sl < 0) sl += srcR;
                            pl[d] = smem + src + sl * srcPS + e;
                        }
#pragma unroll
                        for (int t = 0; t < L::N; ++t) {
                            const float ct = taps.c[t];
#pragma unroll
                            for (int u = 0; u < BT_UR; ++u)
                                acc[u] += ct * pl[L::dk(t) + L::R]
                                    [(L::R + L::dj(t) + u) * RW + L::di(t)];
                        }
                    } else {
                        for (int t = 0; t < taps.n; ++t) {
                            int sl = qnk + taps.dk[t];
                            if (sl < 0) sl += srcR;
                            const float* p = smem + (src + sl * srcPS
                                                     + (jlo + taps.dj[t]) * RW
                                                     + taps.di[t] + e);
                            const float ct = taps.c[t];
#pragma unroll
                            for (int u = 0; u < BT_UR; ++u)
                                acc[u] += ct * p[RW * u];
                        }
                    }
#pragma unroll
                    for (int u = 0; u < BT_UR; ++u) store(u, acc[u]);
                };
                const int NJf = WJ + (F - f) * rj;
                if (f < F) {
                    // every column of the level's rows, margins included
                    // (their values are never read by a needed column), by
                    // quads of BT_UR rows, the last one moved up to end at
                    // the level's last row (its rows in the quad before are
                    // stored twice, the same values); a lane past the run
                    // computes quad 0 and stores nothing
                    const int nq = (NJf + BT_UR - 1) / BT_UR;
                    const int nch = (nq * RW + 31) >> 5;
                    const int rlast = max(NJf - BT_UR, 0);
                    PlaneWalk w(32 * warp + lane, 32 * nwarp, RW);
                    for (int c = warp; c < nch; c += nwarp) {
                        const bool in = w.r < nq;
                        const int r0 = in ? min(BT_UR * w.r, rlast) : 0;
                        const int e = r0 * RW + w.c;
                        rows(e, [&](int u, float v) {
                            if (in && r0 + u < NJf)
                                smem[dst + e + RW * u] = v;
                        });
                        w.next();
                    }
                } else {
                    // the output lanes only, items (quad, 32 lanes), the
                    // last quad moved up as above
                    const int nq = (WJ + BT_UR - 1) / BT_UR;
                    const int rlast = max(WJ - BT_UR, 0);
                    PlaneWalk w = wf;
                    for (int itm = warp; itm < nq * cpr; itm += nwarp) {
                        const int r0 = min(BT_UR * w.r, rlast);
                        const int col = 32 * w.c + lane;
                        if constexpr (IB) {
                            // lane i0 + col: its brick column and lane
                            // there; a tile may end past the output lanes
                            const int gl = i0 + col, ob = gl / BI;
                            const int oc = ob - obf, ol = gl - ob * BI;
                            const bool in = col < g.TI && gl < ibg.IL1;
                            rows(r0 * RW + g.H + col, [&](int u, float v) {
                                if (in && r0 + u < WJ)
                                    out[ro[(r0 + u) * NOB + oc] + ol] = v;
                            });
                        } else {
                            rows(r0 * RW + g.H + col, [&](int u, float v) {
                                if (col < g.TI && r0 + u < WJ)
                                    out[ro[r0 + u] + col] = v;
                            });
                        }
                        w.next();
                    }
                }
            }
            if (f < F) {
                if (!((skw >> f) & 1)) __syncthreads();
                if constexpr (EDGE) {
                    // a source plane of the k clamp: stash it
                    float* sp = nullptr;
                    if (pre && qf >= BK - (F - f) * klo && qf < BK)
                        sp = stash_plane(f, qf - BK + (F - f) * klo, klo,
                                         false);
                    else if (hi_edge && qf >= KT - BK
                             && qf < KT - BK + (F - f) * khi)
                        sp = stash_plane(f, qf - KT + BK, khi, true);
                    if (sp)
                        for (int e = tid; e < n; e += nthr)
                            sp[e] = smem[dst + e];
                }
                src = ring;
                srcR = Rf;
                srcPS = PSf;
                invs = invf;
                ring += Rf * PSf;
            }
        }
    }
    // drain the (empty) trailing groups before the rings are reused
    bt_cp_wait(0);
    __syncthreads();
    }
    };
    if (lo_edge || hi_edge)
        stream(std::true_type());
    else
        stream(std::false_type());
}
