// The register-streaming block body of kernel K1 for the 7-point star at F
// = 2 to 4 fused levels (pencil_regstream.cu's
// pencil_sweep_regstream_kernel).
//
// A block owns what a block of the ring body (pencil_stream.cuh) owns: a
// chunk of output brick rows [kc0, kc1) of one subdomain, a group of
// output pencils and TI lanes of i, and it streams the chunk's planes in
// increasing k.  What differs is where a level keeps its values.
//
// Fixed ownership.  Every level runs over level 0's rows and columns,
// margins included: a plane is NJ0 = WJ + 2F rows (in quads of four) x RW
// columns, RW = TI + 2H and up, compiled in.  A thread owns the same
// items, (quad, column) pairs, at every level and plane: item e = tid +
// 512 m (m < BT_RS_ITEMS) is quad e / RW, column e % RW.  So a thread
// always holds its own column of every level.
//
// Timing.  At step s level-0 plane a arrives and level f (1..F) computes
// plane a - f.  Its k taps read level f-1 at planes a-f-1, a-f and a-f+1
// in the thread's own column: for f >= 2 the values it computed two steps
// ago, one step ago and earlier in this step, all in registers.  Only the
// in-plane neighbours of level f-1 at plane a-f (the rows just outside the
// quad and the i +-1 lanes) come through shared memory, written in step
// s-1.  So each intermediate level keeps two shared planes, one read in a
// step and one written, and one barrier a step orders every level.  Level
// 0 keeps a ring of D + 3 planes: a-2, a-1 and a, which level 1 reads
// whole (its k taps too: level 0 needs no registers across steps), and D
// planes loaded ahead by cp.async.  Level F goes straight to the output
// bricks.
//
// Shared memory, in floats: LEAD floats (the row above quad 0), the
// level-0 ring, two planes of each of levels 1 to F-1, RW floats (the row
// below the last quad), then the block's brick table, two ints per
// level-0 row and two buffers of the output rows' offsets (as in the ring
// body).  A quad's stride QS = 4 RW + PAD is RW modulo 32, so a warp whose
// 32 columns run from the end of one quad into the next touches 32
// distinct banks; every in-plane tap is then a compile-time offset from
// one address per item and level: +-1 (i), +-RW within the quad, -LEAD
// and +QS for the rows above and below it.  The star reads 10 values of
// shared memory per quad and level (2 rows and 8 i neighbours) at levels 2
// to F, 22 at level 1, where the ring body reads 22 at every level.
//
// The table's k edges.  As in the ring body, the intermediate levels' k
// clamp takes a plane beyond the table from the plane BK nearer; a block
// whose chunk reaches an edge keeps those source planes in its slice of
// `stash`, each thread its own items (one float per item and row, NT
// apart), and at a plane beyond the table takes its column's values from
// there in place of the ones it computed.  The low edge's sources are
// computed first by a pre-roll over the empty chunk [BK, BK).  Every stash
// value is written and read by the thread that owns it, so the edge chunks
// run the same one-barrier loop, and the clamp's code only in the steps
// that reach such a plane (the pre-roll, a chunk's first 2F steps at the
// low edge, F - 1 steps around plane KT - BK and its last F - 1 at the
// high edge).
//
// i-bricked tables (IB, cubic strong subdomains; pencil_sweep.cu says what
// they mean).  Level 0's pieces and the output lanes reach their brick
// columns through the block's brick table, as in the ring body; two
// things differ for speed.  The pieces are dealt brick column by brick
// column (a column's rows in order), so a warp's pieces lie in a few runs
// of a brick's k-plane, whole rows one after another in X.  And the output
// rows' offsets, one per row and brick column, are made once a brick row
// (the in-brick k offset added at the store), in a buffer of the brick
// row's parity, where per step they would cost a step's fixed part more.
// An item whose four rows are output rows of one pencil (every output
// item where F and BJ are multiples of 4, as at fuse 4 on 8^3 bricks)
// reads one of them, its first row's, and adds BI floats a row: a brick's
// k-plane holds its rows BI floats apart.  A 64-bit offset read and add a
// row was the store's cost; the 32-byte pieces a warp's store breaks into
// (32 / BI bricks) were not.
//
// Each output's sum is acc = 0; acc += c[t] * x[t] in the star's tap
// order, as in the ring body: a value read from a register has the bits
// it has in shared memory, so the two bodies agree bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "pencil_stream.cuh"
#include "tap_layouts.cuh"

#define BT_RS_THREADS 512
#define BT_RS_ITEMS 2           // (quad, column) items a thread owns
#define BT_RS_PIECES 2          // level-0 pieces a thread keeps the address of

struct RegGeom {
    int GK, GJ, BK, BJ, BI;             // table and brick shape
    int K0, K1;                         // output brick rows
    int KCH, nchunk;                    // brick rows per chunk, chunks
    int J0, J1;                         // output pencils
    int PJ, njg;                        // pencils per block, pencil groups
    int TI, nit;                        // i lanes per block, i tiles
    int H, PW, D;                       // level-0 i margin, piece, lookahead
    int NQ;                             // quads of rows in a plane
    long long stride;                   // bricks per subdomain
    int edge_lo, edge_hi;               // chunk 0 / the last chunk reach
                                        // below / above the table
    int stash_lo, stash_hi;             // stash floats per block and edge
};

// the star's coefficients, in its tap order
struct StarCoeffs {
    float c[LayoutStar7::N];
};

// floats after each quad of rows: QS = 4 RW + PAD is RW modulo 32
__host__ __device__ constexpr int rs_pad(int rw) {
    return (32 - (3 * rw) % 32) % 32;
}

// Floats of the planes, LEAD = RW + PAD before them and RW after, rounded
// up to an even count (the 64-bit brick table follows); the host's
// regstream_smem counts the same.
__host__ __device__ __forceinline__ int rs_ring_floats(const RegGeom& g,
                                                       int F, int RW) {
    const int QS = 4 * RW + rs_pad(RW);
    const int planes = g.D + 3 + 2 * (F - 1);
    return (RW + rs_pad(RW) + planes * g.NQ * QS + RW + 1) & ~1;
}

// A block's whole dynamic shared memory: the planes, the brick table, two
// ints per level-0 row and two buffers of the output rows' offsets (on an
// i-bricked table per brick column, as in the ring body).
__host__ __device__ __forceinline__ long long rs_smem_bytes(
    const RegGeom& g, int F, int RW, const IBrickGeom ib = IBrickGeom{}) {
    const int WJM = g.PJ * g.BJ;
    const int NIBM = ib.GI ? ib_cols(g.TI + 2 * g.H, g.BI) : 1;
    const int NOB = ib.GI ? ib_cols(g.TI, g.BI) : 1;
    return 4LL * rs_ring_floats(g, F, RW)
           + 8LL * (g.KCH + 2) * (g.PJ + 2) * NIBM
           + 8LL * (WJM + 2 * F) + 16LL * WJM * NOB;
}

// Stash floats a block keeps per k edge: level f's (F - f) source planes,
// one float per thread, item and row each.
__host__ __device__ __forceinline__ long long rs_stash_floats(int F) {
    return (long long)F * (F - 1) / 2 * BT_RS_THREADS * BT_RS_ITEMS * BT_UR;
}

// IB: the table is i-bricked (ibg; pencil_stream.cuh's stream_block says
// how level 0 and the output reach the brick columns)
template <int F, int RW, bool IB>
__device__ __forceinline__ void regstream_block(const float* __restrict__ x,
                                                float* __restrict__ out,
                                                const int* __restrict__ table,
                                                const RegGeom& g,
                                                const StarCoeffs& cf, int b,
                                                float* smem, float* stash,
                                                const IBrickGeom ibg) {
    using L = LayoutStar7;
    static_assert(L::R == 1, "the body keeps three planes of a level");
    constexpr int NT = BT_RS_THREADS, M = BT_RS_ITEMS, UR = BT_UR;
    constexpr int PAD = rs_pad(RW), QS = 4 * RW + PAD, LEAD = RW + PAD;
    const int tid = threadIdx.x;
    const int it = b % g.nit;
    b /= g.nit;
    const int jg = b % g.njg;
    b /= g.njg;
    const int ch = b % g.nchunk;
    const int sub = b / g.nchunk;

    const int BK = g.BK, BJ = g.BJ, BI = g.BI;
    const int kc0 = g.K0 + ch * g.KCH;
    const int kc1 = min(kc0 + g.KCH, g.K1);
    const int P0 = kc0 * BK, P1 = kc1 * BK;
    const int jp0 = g.J0 + jg * g.PJ, jp1 = min(jp0 + g.PJ, g.J1);
    const int jo0 = jp0 * BJ, WJ = (jp1 - jp0) * BJ;
    const int i0 = IB ? ibg.IL0 + it * g.TI : it * g.TI;
    const int WJM = g.PJ * BJ;
    const int NJ0 = WJ + 2 * F;         // level-0 rows: F radii each side
    const int nq = (NJ0 + UR - 1) / UR;
    const int PS = g.NQ * QS;           // floats a plane
    const int R0 = g.D + 3;
    const long long brick = (long long)BK * BJ * BI;
    // i-bricked: a level-0 row's brick columns [ibf, ibf + NIBM), an
    // output row's [obf, obf + NOB); one each on the pencil layout
    const int NIBM = IB ? ib_cols(g.TI + 2 * g.H, BI) : 1;
    const int NOB = IB ? ib_cols(g.TI, BI) : 1;
    const int ibf = IB ? floor_div(i0 - g.H, BI) : 0;
    const int obf = IB ? i0 / BI : 0;

    // the brick table of brick rows [kbf, kbf + NKB) and pencils [jbf, jbf
    // + NJB) (and brick columns [ibf, ibf + NIBM)), clamps applied; per
    // level-0 row its pencil and in-brick j offset; the output rows'
    // offsets, one buffer per step parity (on an i-bricked table per brick
    // column, a buffer per brick row's parity)
    const int NJBM = g.PJ + 2;
    long long* bt = (long long*)(smem + rs_ring_floats(g, F, RW));
    int* rowinfo = (int*)(bt + (g.KCH + 2) * NJBM * NIBM);
    long long* rowofs = (long long*)(rowinfo + 2 * (WJM + 2 * F));
    const int kbf = floor_div(P0 - F, BK);
    const int NKB = floor_div(P1 + F - 1, BK) - kbf + 1;
    const int jbf = floor_div(jo0 - F, BJ);
    const int NJB = floor_div(jo0 + WJ + F - 1, BJ) - jbf + 1;
    const long long bofs = sub * g.stride;
    if constexpr (IB) {
        ib_fill_table(bt, table, tid, NT, NKB, NJBM, NJB, NIBM, kbf, jbf, ibf,
                      g.GK, g.GJ, ibg.GI, bofs, brick);
    } else {
        for (int e = tid; e < NKB * NJBM; e += NT) {
            const int a = e / NJBM, c = e - a * NJBM;
            if (c < NJB)
                bt[e] = (bofs + table[clamp_int(kbf + a, 0, g.GK - 1) * g.GJ
                                      + clamp_int(jbf + c, 0, g.GJ - 1)])
                        * brick;
        }
    }
    for (int r = tid; r < NJ0; r += NT) {
        const int j = jo0 - F + r;
        const int jb = floor_div(j, BJ);
        rowinfo[2 * r] = jb - jbf;
        rowinfo[2 * r + 1] = (j - jb * BJ) * BI;
    }
    __syncthreads();

    // plane k of the level-0 ring, and level f's plane of step parity p
    float* const planes = smem + LEAD;
    auto level_plane = [&](int f, int p) {
        return planes + (R0 + 2 * (f - 1) + p) * PS;
    };

    // level-0 plane q into ring slot `slot`, in PW-float pieces, one
    // group: row r, piece c at (r / 4) QS + (r % 4) RW + c PW; planes
    // beyond the table read the clamped brick row (the table)
    const int PW = g.PW;
    const int NP = (g.TI + 2 * g.H) / PW;
    const int ibase = i0 - g.H;
    const PlaneWalk w0(tid, NT, NP);
    const int npc = (NJ0 * NP - tid + NT - 1) / NT;
    // On an i-bricked table the plane's pieces are taken brick column by
    // brick column, a column's rows in order and a row's pieces fastest:
    // a brick's k-plane is its rows one after another in X, so a warp's
    // pieces lie in a few runs of whole rows (full cache lines), where
    // row by row they would touch every brick column of two rows.  The
    // first column holds n0 pieces of a row (the plane starts inside a
    // brick), the others PPB, the last what is left.
    const int PPB = BI / PW;
    const int n0 = IB ? min(PPB - (ibase - ibf * BI) / PW, NP) : 0;
    auto rc_of = [&](int e, int& r, int& c) {
        if (e < NJ0 * n0) {
            r = e / n0;
            c = e - r * n0;
            return;
        }
        e -= NJ0 * n0;
        const int G = e / (NJ0 * PPB);
        const int c0 = n0 + G * PPB, wdt = min(PPB, NP - c0);
        const int within = e - G * NJ0 * PPB;
        r = within / wdt;
        c = c0 + within - r * wdt;
    };
    int pcb[BT_RS_PIECES], pco[BT_RS_PIECES], pcs[BT_RS_PIECES];
    {
        PlaneWalk w = w0;
#pragma unroll
        for (int p = 0; p < BT_RS_PIECES; ++p) {
            if constexpr (IB) {
                int r = 0, c = 0;
                if (p < npc) rc_of(tid + NT * p, r, c);
                ib_piece(rowinfo, r, ibase + c * PW, BI, NIBM, ibf, pcb[p],
                         pco[p]);
                pcs[p] = (r >> 2) * QS + (r & 3) * RW + c * PW;
            } else {
                const int r = p < npc ? w.r : 0, c = p < npc ? w.c : 0;
                int ii = ibase + c * PW;
                while (ii < 0) ii += BI;
                while (ii >= BI) ii -= BI;
                pcb[p] = rowinfo[2 * r];
                pco[p] = rowinfo[2 * r + 1] + ii;
                pcs[p] = (r >> 2) * QS + (r & 3) * RW + c * PW;
            }
            w.next();
        }
    }
    const float invBK = 1.0f / BK;
    auto brick_row = [&](int q) {      // the brick row of plane q, - kbf
        return div_by(q - kbf * BK, invBK);
    };
    auto issue = [&](int q, int slot) {
        const int kr = brick_row(q);
        const long long* btrow = bt + kr * NJBM * NIBM;
        const long long kofs = (long long)(q - (kbf + kr) * BK) * BJ * BI;
        float* dst = planes + slot * PS;
        if (npc <= BT_RS_PIECES) {
#pragma unroll
            for (int p = 0; p < BT_RS_PIECES; ++p) {
                if (p >= npc) break;
                const float* src = x + btrow[pcb[p]] + kofs + pco[p];
                if (PW == 4)
                    bt_cp_async16(dst + pcs[p], src);
                else
                    bt_cp_async4(dst + pcs[p], src);
            }
            bt_cp_commit();
            return;
        }
        PlaneWalk w = w0;
        for (int e = tid; e < NJ0 * NP; e += NT) {
            const float* src;
            float* d;
            if constexpr (IB) {
                int pb, po, r, c;
                rc_of(e, r, c);
                ib_piece(rowinfo, r, ibase + c * PW, BI, NIBM, ibf, pb, po);
                src = x + btrow[pb] + kofs + po;
                d = dst + (r >> 2) * QS + (r & 3) * RW + c * PW;
            } else {
                int ii = ibase + w.c * PW;
                while (ii < 0) ii += BI;
                while (ii >= BI) ii -= BI;
                src = x + btrow[rowinfo[2 * w.r]] + kofs
                      + rowinfo[2 * w.r + 1] + ii;
                d = dst + (w.r >> 2) * QS + (w.r & 3) * RW + w.c * PW;
            }
            if (PW == 4)
                bt_cp_async16(d, src);
            else
                bt_cp_async4(d, src);
            w.next();
        }
        bt_cp_commit();
    };

    // this thread's items: in-plane offset, whether its quad is in the
    // block's rows, and whether it holds an output (level F's lanes and
    // rows); its first row as an output row, its column as an output lane
    // (on an i-bricked table: the output lane's brick column, from obf,
    // and its lane there, and bit 16 set where the quad's rows are all
    // output rows of one pencil; a tile may end past the output lanes)
    int ofs[M], orow[M], col[M];
    bool act[M], outp[M];
#pragma unroll
    for (int m = 0; m < M; ++m) {
        const int e = tid + NT * m;
        const int q = e / RW, c = e - q * RW;
        act[m] = q < nq;
        ofs[m] = act[m] ? q * QS + c : 0;
        orow[m] = UR * q - F;
        col[m] = c - g.H;
        outp[m] = act[m] && col[m] >= 0 && col[m] < g.TI
                  && orow[m] + UR > 0 && orow[m] < WJ;
        if constexpr (IB) {
            const int gl = i0 + col[m], ob = outp[m] ? gl / BI : obf;
            outp[m] = outp[m] && gl < ibg.IL1;
            const bool one = orow[m] >= 0 && orow[m] + UR <= WJ
                             && orow[m] / BJ == (orow[m] + UR - 1) / BJ;
            orow[m] = orow[m] * NOB + ob - obf;
            col[m] = (gl - ob * BI) | (one ? 1 << 16 : 0);
        }
    }

    const int KT = g.GK * BK;
    const bool lo_edge = g.edge_lo && ch == 0;
    const bool hi_edge = g.edge_hi && ch == g.nchunk - 1;
    float* st_blk = stash + (((long long)sub * g.njg + jg) * g.nit + it)
                            * (g.stash_lo + g.stash_hi);
    // this thread's float of plane x of level f's stash at one edge, for
    // item 0 and row 0 (item m, row u: + (m * UR + u) * NT)
    auto stash_at = [&](int f, int x, bool hi) {
        const int before = (f - 1) * F - (f - 1) * f / 2;
        return st_blk + (hi ? g.stash_lo : 0)
               + (long long)(before + x) * (M * UR * NT) + tid;
    };

    // One stream per phase over the output planes [p0, p1), level-0
    // planes [p0 - F, p1 + F), one per step: phase 0 is the pre-roll
    // (chunks at the low edge only), phase 1 the chunk.
    for (int ph = lo_edge ? 0 : 1; ph < 2; ++ph) {
    const bool pre = ph == 0;
    const int p0 = pre ? BK : P0, p1 = pre ? BK : P1;
    const int nsteps = (p1 - p0) + 2 * F;
    const int q00 = p0 - F;
    // own columns of levels 1 to F-1 at the two planes before the newest
    // (index f: level f; level 0's stay in its ring)
    float lo[F][M][UR], mid[F][M][UR];
#pragma unroll
    for (int f = 1; f < F; ++f)
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int u = 0; u < UR; ++u) lo[f][m][u] = mid[f][m][u] = 0.0f;
    for (int d = 0; d < g.D; ++d) issue(q00 + d, d);
    // the steps in which a level computes a plane beyond the table or a
    // source plane of the clamp (level f computes plane q00 + s - f): the
    // pre-roll's, the first 2F at the low edge, and at the high edge those
    // from level 1's plane KT - BK to level F-1's and from level 1's plane
    // KT on
    const int hi1 = KT - BK - q00 + 1, hi2 = hi1 + F - 1;
    const int hi3 = KT - q00 + 1;
    auto edge_step = [&](int s) {
        return pre || (lo_edge && s < 2 * F)
               || (hi_edge && ((s >= hi1 && s < hi2) || s >= hi3));
    };
    int sa = 0;                         // ring slot of plane q00 + s
    // One step; EDGE: the clamp's code compiled in
    auto step = [&](int s, auto edge) {
        constexpr bool EDGE = decltype(edge)::value;
        // this step's output rows' offsets in X (the other buffer may still
        // be read by the previous step's level F).  On an i-bricked table
        // one per output row and brick column, at the column's lane 0 of
        // the brick row's first plane, its buffer that brick row's parity:
        // it is made once a brick row (the in-brick k offset is added at
        // the store), and read by the BK steps that output that row's
        // planes, which end a step before the other row's are made.
        long long* ro = rowofs + (s & 1) * WJM * NOB;
        const int qF = q00 + s - F;
        if constexpr (IB) {
            const int kr = qF >= p0 && qF < p1 ? brick_row(qF) : 0;
            ro = rowofs + (kr & 1) * WJM * NOB;
            if (qF >= p0 && qF < p1
                && (qF == p0 || qF == (kbf + kr) * BK)) {
                ib_fill_rowofs(ro, bt + kr * NJBM * NIBM, rowinfo, tid, NT,
                               WJ, NOB, F, NIBM, obf, ibf, 0);
            }
        } else if (qF >= p0 && qF < p1) {
            const int kr = brick_row(qF);
            const long long* btrow = bt + kr * NJBM;
            const long long kofs = (long long)(qF - (kbf + kr) * BK) * BJ * BI
                                   + i0;
            for (int r = tid; r < WJ; r += NT) {
                const int r0 = r + F;   // output row r is level-0 row r + F
                ro[r] = btrow[rowinfo[2 * r0]] + kofs + rowinfo[2 * r0 + 1];
            }
        }
        bt_cp_wait(g.D - 1);
        __syncthreads();
        {
            int sd = sa + g.D;
            if (sd >= R0) sd -= R0;
            if (s + g.D < nsteps)
                issue(q00 + s + g.D, sd);
            else
                bt_cp_commit();
        }
        // level 0's planes a, a-1 and a-2 in the ring
        const float* pa = planes + sa * PS;
        const float* pm = planes + (sa >= 1 ? sa - 1 : sa - 1 + R0) * PS;
        const float* pl = planes + (sa >= 2 ? sa - 2 : sa - 2 + R0) * PS;
        // level f-1's plane a - f (its in-plane neighbours, and level 0's
        // own column): level 0's slot before sa, level f's plane of the
        // other parity
        const float* src = pm;
        float nw[M][UR];                // level f-1's newest, f >= 2
#pragma unroll
        for (int f = 1; f <= F; ++f) {
            const int q = q00 + s - f;
            const bool valid = f < F ? q >= p0 - (F - f) && q < p1 + (F - f)
                                     : q >= p0 && q < p1;
            float nx[M][UR];
            if (valid) {
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    if (f == F && !outp[m]) continue;
                    // the star on level f-1: its k taps and the quad's own
                    // rows from registers (level 0's from its ring), the
                    // rows above and below and the i neighbours from
                    // shared memory
                    const float* p = src + ofs[m];
                    const float jm = p[-LEAD], jp = p[QS];
#pragma unroll
                    for (int u = 0; u < UR; ++u) {
                        float acc = 0.0f;
#pragma unroll
                        for (int t = 0; t < L::N; ++t) {
                            float v;
                            if (L::dk(t) > 0) {
                                v = f == 1 ? pa[ofs[m] + u * RW] : nw[m][u];
                            } else if (L::dk(t) < 0) {
                                v = f == 1 ? pl[ofs[m] + u * RW]
                                           : lo[f - 1][m][u];
                            } else if (L::di(t) != 0) {
                                v = p[u * RW + L::di(t)];
                            } else {
                                const int r = u + L::dj(t);
                                const int rc = r < 0 ? 0
                                               : r >= UR ? UR - 1 : r;
                                v = r < 0 ? jm
                                    : r >= UR ? jp
                                    : f == 1 ? p[rc * RW]
                                             : mid[f - 1][m][rc];
                            }
                            acc += cf.c[t] * v;
                        }
                        nx[m][u] = acc;
                    }
                }
                if (EDGE && f < F && (q < 0 || q >= KT)) {
                    // beyond the table: the stashed source plane's values
                    const float* sp = q < 0 ? stash_at(f, q + (F - f), false)
                                            : stash_at(f, q - KT, true);
#pragma unroll
                    for (int m = 0; m < M; ++m)
#pragma unroll
                        for (int u = 0; u < UR; ++u)
                            nx[m][u] = sp[(m * UR + u) * NT];
                }
            } else {
#pragma unroll
                for (int m = 0; m < M; ++m)
#pragma unroll
                    for (int u = 0; u < UR; ++u) nx[m][u] = 0.0f;
            }
            if (f < F) {
                float* dst = level_plane(f, s & 1);
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    if (!act[m]) continue;
#pragma unroll
                    for (int u = 0; u < UR; ++u)
                        dst[ofs[m] + u * RW] = nx[m][u];
                }
                if constexpr (EDGE) {
                    // a source plane of the k clamp: stash it
                    float* sp = nullptr;
                    if (!valid) {
                    } else if (pre && q >= BK - (F - f) && q < BK) {
                        sp = stash_at(f, q - BK + (F - f), false);
                    } else if (hi_edge && q >= KT - BK
                               && q < KT - BK + (F - f)) {
                        sp = stash_at(f, q - KT + BK, true);
                    }
                    if (sp) {
#pragma unroll
                        for (int m = 0; m < M; ++m)
#pragma unroll
                            for (int u = 0; u < UR; ++u)
                                sp[(m * UR + u) * NT] = nx[m][u];
                    }
                }
                src = level_plane(f, (s + 1) & 1);
            } else if (valid) {
                // the output plane's in-brick k offset (i-bricked tables)
                const int kofs = IB ? (q - (kbf + brick_row(q)) * BK) * BJ * BI
                                    : 0;
#pragma unroll
                for (int m = 0; m < M; ++m) {
                    if (!outp[m]) continue;
#pragma unroll
                    for (int u = 0; u < UR; ++u) {
                        if constexpr (IB) {
                            // orow: (first row) * NOB + brick column; a
                            // quad in one pencil from its first row's offset
                            const int lane = col[m] & 0xffff;
                            if (col[m] >> 16) {
                                out[ro[orow[m]] + (kofs + lane + u * BI)] =
                                    nx[m][u];
                                continue;
                            }
                            const int r = orow[m] + u * NOB;
                            if (r >= 0 && r < WJ * NOB)
                                out[ro[r] + (kofs + lane)] = nx[m][u];
                        } else {
                            if (orow[m] + u >= 0 && orow[m] + u < WJ)
                                out[ro[orow[m] + u] + col[m]] = nx[m][u];
                        }
                    }
                }
            }
            // level f-1's planes move down one (level 0's ring moves by
            // itself); level f's newest is nx
#pragma unroll
            for (int m = 0; m < M; ++m)
#pragma unroll
                for (int u = 0; u < UR; ++u) {
                    if (f >= 2) {
                        lo[f - 1][m][u] = mid[f - 1][m][u];
                        mid[f - 1][m][u] = nw[m][u];
                    }
                    if (f < F) nw[m][u] = nx[m][u];
                }
        }
    };
    // (a block at no edge runs a loop without the clamp's code: 1 to 3%
    // faster than one that tests each step)
    if (lo_edge || hi_edge) {
        for (int s = 0; s < nsteps; ++s) {
            if (edge_step(s))
                step(s, std::true_type());
            else
                step(s, std::false_type());
            sa = sa + 1 == R0 ? 0 : sa + 1;
        }
    } else {
        for (int s = 0; s < nsteps; ++s) {
            step(s, std::false_type());
            sa = sa + 1 == R0 ? 0 : sa + 1;
        }
    }
    // drain the (empty) trailing groups before the planes are reused
    bt_cp_wait(0);
    __syncthreads();
    }
}
