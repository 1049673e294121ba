// The register-streaming block body of kernel K4 for the 4-D 9-point star
// at F fused levels (pencil_regstream_4d.cu's
// pencil_sweep_regstream_4d_kernel, which compiles it at F = 2).
//
// A block owns what a block of the ring body (pencil_stream_4d.cuh) owns:
// a chunk of output w bricks [wb0, wb1) of one batch member, PK k brick
// rows, PJ pencils and TI lanes of i, and it streams the chunk's w planes
// in increasing w.  What differs is where a level keeps its values.
//
// The plane.  Every level's plane has level 0's shape: NK0 = KT + 2F k
// rows of NJ = BT4_RS_WJ + 2F j rows of RW lanes, NJ and RW compiled in
// (RW >= TI + 2H; the block's j rows, PJ BJ + 2F, are at most NJ).  A k
// row is WS = NJ RW floats.  Level 1 computes k rows 1 to NK0 - 2, in NQ
// groups of UR = BT4_RS_ROWS rows (5: at F = 2 one brick row of 8 and its
// margins are two whole groups); k row 0 leads the groups and the next row
// after them trails.  A group's stride QS = UR WS + PAD is WS
// modulo 32 (the warp whose items run from one group into the next
// touches 32 distinct banks).  So every in-plane tap is an immediate
// offset from one address per item and level: +-1 (i), +-RW (j), +-WS (k
// within the group), -LEAD and +QS (the k rows above and below the group).
//
// Fixed ownership.  A thread owns the same item, a (group of k rows,
// column) pair with a column one j row and one lane, at every level and
// plane: item e = tid of the onion order below.
// So a thread always holds its own column of every level.  The onion
// order lists the output columns (WJ x TI) of every group, then the ring
// of columns one radius around them of every group, and so on out to the
// columns level 1 needs: level f needs the rings up to F - f, so its items
// are a prefix of the order (NQ (WJ + 2(F - f)) (TI + 2(F - f)) items),
// whole warps skip the columns it does not need, and level F computes the
// output columns only (all the rows of a group: skipping a group's rows
// that are not output rows costs more in branches than it saves).  The
// level-0 columns no level computes have no owner.
//
// Timing.  At step s level-0 plane a arrives and level f (1..F) computes
// plane a - f.  Its w taps read level f-1 at planes a-f-1, a-f and a-f+1
// in the thread's own column: for f >= 2 the values it computed two steps
// ago, one step ago and earlier in this step, all in registers, as are
// its centre and the group's own k rows.  Only the rows just outside the
// group, the j +-1 rows and the i +-1 lanes of level f-1 at plane a-f come
// through shared memory, written in step s-1.  So each intermediate level
// keeps two shared planes, one read in a step and one written, and one
// barrier a step orders every level.  Level 0 keeps a ring of D + 3
// planes: a-2, a-1 and a, which level 1 reads whole, and D planes loaded
// ahead by cp.async (D up to 3).  Level F goes straight to the output
// bricks.  At F = 2 the star reads 22 values of shared memory per group of
// 5 rows at level 2 and 37 at level 1, where the ring body reads 30 a quad
// of 4 at every level.
//
// The table's k edges.  As in the ring body, the intermediate levels' k
// rows beyond the table take the values of their clamped rows, the rows
// BK nearer in the same plane: the thread that computes a source row
// stores its value into the clamped row too, in the same pass, and a row
// beyond the table is never stored otherwise.  A thread's own registers
// keep its computed (unclamped) values of such rows, which only rows
// beyond the table read again; so in the blocks whose k rows reach an
// edge (a loop of their own) the in-group k taps of levels 2 to F come
// from shared memory, where the clamped values are.
//
// Shared memory, in floats: the planes of the level-0 ring and two planes
// of each of levels 1 to F-1, each its leading row, NQ groups and its
// trailing row, the count rounded up to even; then the block's brick table
// (one 64-bit element offset per (w brick, k brick, pencil) it touches,
// clamps applied), three ints per level-0 row (its (k brick, pencil)
// index, in-brick offset and offset in a plane), the count rounded up to
// even, and two buffers of the output rows' addresses (one per step
// parity).
//
// Each output's sum is acc = 0; acc += c[t] * x[t] in the star's tap
// order, as in the ring body: a value read from a register has the bits
// it has in shared memory, so the two bodies agree bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "pencil_stream_4d.cuh"

#define BT4_RS_THREADS 768      // and (group, column) items, one a thread
#define BT4_RS_ROWS 5           // k rows a group
#define BT4_RS_PIECES 2         // level-0 pieces a thread keeps the address of
#define BT4_RS_WJ 8             // output j rows a plane holds (PJ BJ <= 8)

struct Reg4Geom {
    int GW, GK, GJ;                     // table shape
    int BW, BK, BJ, BI;                 // brick shape
    int W0, W1, WCH, nwch;              // output w bricks, per chunk, chunks
    int K0, K1, PK, nkg;                // output k bricks, per block, groups
    int J0, J1, PJ, njg;                // output pencils, per block, groups
    int TI, nit;                        // i lanes per block, i tiles
    int H, PW, D;                       // level-0 i margin, piece, lookahead
    int NQ;                             // groups of k rows a plane holds
    long long stride;                   // bricks between batch members
};

// the 4-D star's coefficients, in its tap order
struct Star9Coeffs {
    float c[LayoutStar9::N];
};

// floats after each group of ur k rows of ws floats: QS = ur ws + PAD is ws
// modulo 32
__host__ __device__ constexpr int rs4_pad(int ws, int ur) {
    return (32 - ((ur - 1) * ws) % 32) % 32;
}

// Floats of a plane: its leading row (LEAD = WS + PAD floats), NQ groups
// and its trailing row (WS floats).
__host__ __device__ __forceinline__ long long rs4_plane_floats(
    const Reg4Geom& g, int F, int RW) {
    const int WS = (BT4_RS_WJ + 2 * F) * RW, UR = BT4_RS_ROWS;
    const int PAD = rs4_pad(WS, UR);
    return WS + PAD + (long long)g.NQ * (UR * WS + PAD) + WS;
}

// Floats of the planes, rounded up to an even count (the 64-bit brick
// table follows); the host's regstream4_smem counts the same.
__host__ __device__ __forceinline__ long long rs4_ring_floats(
    const Reg4Geom& g, int F, int RW) {
    const int planes = g.D + 3 + 2 * (F - 1);
    return (planes * rs4_plane_floats(g, F, RW) + 1) & ~1LL;
}

// Ints of the level-0 rows' table, three a row, rounded up to even.
__host__ __device__ __forceinline__ long long rs4_rowinfo_ints(
    const Reg4Geom& g, int F) {
    const long long rows0 = (long long)(g.PK * g.BK + 2 * F)
                            * (g.PJ * g.BJ + 2 * F);
    return (3 * rows0 + 1) & ~1LL;
}

// A block's whole dynamic shared memory: the planes, the brick table, the
// level-0 rows' table and two buffers of the output rows' addresses.
__host__ __device__ __forceinline__ long long rs4_smem_bytes(
    const Reg4Geom& g, int F, int RW) {
    return 4 * rs4_ring_floats(g, F, RW)
           + 8LL * (g.WCH + 2) * (g.PK + 2) * (g.PJ + 2)
           + 4 * rs4_rowinfo_ints(g, F)
           + 16LL * g.PK * g.BK * g.PJ * g.BJ;
}

// Columns level f needs of a block with WJ output j rows and TI lanes.
__host__ __device__ __forceinline__ int rs4_columns(int WJ, int TI, int F,
                                                    int f) {
    return (WJ + 2 * (F - f)) * (TI + 2 * (F - f));
}

// wait until at most `pending` (0 to 2) committed groups are in flight
__device__ __forceinline__ void rs4_cp_wait(int pending) {
#ifdef __CUDA_ARCH__
    if (pending >= 2)
        asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    else if (pending == 1)
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Item e of the onion order: the output's WJ x TI columns of every group
// (group by group, a group's row by row), then ring d = 1, 2, ... around
// them of every group (a group's ring: its top and bottom j rows, TI + 2d
// lanes each, then its sides, a left and a right lane a j row).  Its
// group, j row and lane from the output's first, and its ring.
__device__ __forceinline__ void rs4_item(int e, int nq, int WJ, int TI,
                                         int& q, int& j, int& l, int& d) {
    d = 0;
    if (e < nq * WJ * TI) {
        q = e / (WJ * TI);
        const int k = e - q * WJ * TI;
        j = k / TI;
        l = k - j * TI;
        return;
    }
    e -= nq * WJ * TI;
    for (d = 1;; ++d) {
        const int w = TI + 2 * d, h = WJ + 2 * d - 2, n = 2 * w + 2 * h;
        if (e < nq * n) {
            q = e / n;
            int k = e - q * n;
            if (k < 2 * w) {
                j = k < w ? -d : WJ - 1 + d;
                l = (k < w ? k : k - w) - d;
            } else {
                k -= 2 * w;
                j = 1 - d + (k >> 1);
                l = (k & 1) ? TI - 1 + d : -d;
            }
            return;
        }
        e -= nq * n;
    }
}

// One block: F fused levels, RW the compiled row width.  A block whose k
// rows reach a table edge runs a loop of its own, with the clamp's code
// compiled in (EDGE).
template <int F, int RW>
__device__ __forceinline__ void regstream4_block(const float* __restrict__ x,
                                                 float* __restrict__ out,
                                                 const int* __restrict__ table,
                                                 const Reg4Geom& g,
                                                 const Star9Coeffs& cf, int b,
                                                 float* smem) {
    using L = LayoutStar9;
    static_assert(L::R == 1, "the body keeps three planes of a level");
    constexpr int NT = BT4_RS_THREADS, UR = BT4_RS_ROWS;
    constexpr int NJ = BT4_RS_WJ + 2 * F, WS = NJ * RW;
    constexpr int PAD = rs4_pad(WS, UR), QS = UR * WS + PAD, LEAD = WS + PAD;
    // level-0 row R of a plane: row 0 leads, rows 1 to UR NQ are the
    // groups', the next one trails
    auto row_ofs = [](int R) {
        return R == 0 ? -LEAD : (R - 1) / UR * QS + (R - 1) % UR * WS;
    };
    const int tid = threadIdx.x;
    const int it = b % g.nit;
    b /= g.nit;
    const int jg = b % g.njg;
    b /= g.njg;
    const int kg = b % g.nkg;
    b /= g.nkg;
    const int wc = b % g.nwch;
    const int sub = b / g.nwch;

    const int BW = g.BW, BK = g.BK, BJ = g.BJ, BI = g.BI;
    const int wb0 = g.W0 + wc * g.WCH, wb1 = min(wb0 + g.WCH, g.W1);
    const int P0 = wb0 * BW, P1 = wb1 * BW;
    const int kb0 = g.K0 + kg * g.PK, kb1 = min(kb0 + g.PK, g.K1);
    const int ko0 = kb0 * BK, KT = (kb1 - kb0) * BK;
    const int jp0 = g.J0 + jg * g.PJ, jp1 = min(jp0 + g.PJ, g.J1);
    const int jo0 = jp0 * BJ, WJ = (jp1 - jp0) * BJ;
    const int i0 = it * g.TI;
    const int NK0 = KT + 2 * F, NJ0 = WJ + 2 * F;
    const int nq = (NK0 - 2 + UR - 1) / UR;   // groups of level 1's rows
    const int PS = (int)rs4_plane_floats(g, F, RW);
    const int R0 = g.D + 3;
    const long long brick = (long long)BW * BK * BJ * BI;
    const long long wslice = (long long)BK * BJ * BI;

    // the block's brick table: w bricks [wbf, wbf + NWB), k bricks [kbf,
    // kbf + NKB), pencils [jbf, jbf + NJB); per level-0 row (k row, j row)
    // its (k brick, pencil) index, in-brick offset and offset in a plane;
    // the output rows' addresses, one buffer per step parity
    const int NKBM = g.PK + 2, NJBM = g.PJ + 2, NKJ = NKBM * NJBM;
    long long* bt = (long long*)(smem + rs4_ring_floats(g, F, RW));
    int* rowinfo = (int*)(bt + (g.WCH + 2) * NKJ);
    float** rowofs = (float**)(rowinfo + rs4_rowinfo_ints(g, F));
    const int wbf = floor_div(P0 - F, BW);
    const int NWB = floor_div(P1 + F - 1, BW) - wbf + 1;
    const int kbf = floor_div(ko0 - F, BK);
    const int NKB = floor_div(ko0 + KT + F - 1, BK) - kbf + 1;
    const int jbf = floor_div(jo0 - F, BJ);
    const int NJB = floor_div(jo0 + WJ + F - 1, BJ) - jbf + 1;
    const long long bofs = sub * g.stride;
    for (int e = tid; e < NWB * NKJ; e += NT) {
        const int a = e / NKJ, r = e - a * NKJ;
        const int kb = r / NJBM, jb = r - kb * NJBM;
        if (kb < NKB && jb < NJB)
            bt[e] = (bofs
                     + table[(clamp_int(wbf + a, 0, g.GW - 1) * g.GK
                              + clamp_int(kbf + kb, 0, g.GK - 1)) * g.GJ
                             + clamp_int(jbf + jb, 0, g.GJ - 1)])
                    * brick;
    }
    for (int r = tid; r < NK0 * NJ0; r += NT) {
        const int kr = r / NJ0, jr = r - kr * NJ0;
        const int k = ko0 - F + kr, j = jo0 - F + jr;
        const int kb = floor_div(k, BK), jb = floor_div(j, BJ);
        rowinfo[3 * r] = (kb - kbf) * NJBM + (jb - jbf);
        rowinfo[3 * r + 1] = ((k - kb * BK) * BJ + (j - jb * BJ)) * BI;
        rowinfo[3 * r + 2] = row_ofs(kr) + jr * RW;
    }
    __syncthreads();

    // plane slot `slot` of the level-0 ring, and level f's plane of step
    // parity p
    float* const planes = smem + LEAD;
    auto level_plane = [&](int f, int p) {
        return planes + (R0 + 2 * (f - 1) + p) * PS;
    };

    // level-0 plane q into ring slot `slot`, in PW-float pieces, one group;
    // planes beyond the table read the clamped w brick (the table)
    const int PW = g.PW;
    const int NP = (g.TI + 2 * g.H) / PW;
    const int ibase = i0 - g.H;
    const PlaneWalk w0(tid, NT, NP);
    const int npc = (NK0 * NJ0 * NP - tid + NT - 1) / NT;
    int pcb[BT4_RS_PIECES], pco[BT4_RS_PIECES], pcs[BT4_RS_PIECES];
    {
        PlaneWalk w = w0;
#pragma unroll
        for (int p = 0; p < BT4_RS_PIECES; ++p) {
            const int r = p < npc ? w.r : 0, c = p < npc ? w.c : 0;
            int ii = ibase + c * PW;
            while (ii < 0) ii += BI;
            while (ii >= BI) ii -= BI;
            pcb[p] = rowinfo[3 * r];
            pco[p] = rowinfo[3 * r + 1] + ii;
            pcs[p] = rowinfo[3 * r + 2] + c * PW;
            w.next();
        }
    }
    // w bricks without a division: a plane counted from the block's first
    // w brick wbf (below 2^20 planes)
    const float invBW = 1.0f / BW;
    auto wbrick = [&](int q) {          // the w brick of plane q, - wbf
        return div_by(q - wbf * BW, invBW);
    };
    auto issue = [&](int q, int slot) {
        const int wi = wbrick(q);
        const long long* btw = bt + wi * NKJ;
        const long long wofs = (q - (wbf + wi) * BW) * wslice;
        float* dst = planes + slot * PS;
        if (npc <= BT4_RS_PIECES) {
#pragma unroll
            for (int p = 0; p < BT4_RS_PIECES; ++p) {
                if (p >= npc) break;
                const float* src = x + btw[pcb[p]] + wofs + pco[p];
                if (PW == 4)
                    bt_cp_async16(dst + pcs[p], src);
                else
                    bt_cp_async4(dst + pcs[p], src);
            }
            bt_cp_commit();
            return;
        }
        PlaneWalk w = w0;
        for (int e = tid; e < NK0 * NJ0 * NP; e += NT) {
            int ii = ibase + w.c * PW;
            while (ii < 0) ii += BI;
            while (ii >= BI) ii -= BI;
            const float* src = x + btw[rowinfo[3 * w.r]] + wofs
                               + rowinfo[3 * w.r + 1] + ii;
            float* d = dst + rowinfo[3 * w.r + 2] + w.c * PW;
            if (PW == 4)
                bt_cp_async16(d, src);
            else
                bt_cp_async4(d, src);
            w.next();
        }
        bt_cp_commit();
    };

    // this thread's item: the offset of its first row in a plane, its
    // column's offset in a k row, its first row (level-0 row 1 + UR q), the
    // deepest level that needs it (0: none), and, for an output, its first
    // output row and its lane
    const int items = nq * rs4_columns(WJ, g.TI, F, 1);
    int ofs = 0, cofs = 0, r0, top = 0, orow, col;
    {
        int q = 0, j = 0, l = 0, d = 0;
        if (tid < items) {
            rs4_item(tid, nq, WJ, g.TI, q, j, l, d);
            cofs = (j + F) * RW + l + g.H;
            ofs = q * QS + cofs;
            top = F - d;
        }
        r0 = 1 + UR * q;
        orow = (r0 - F) * WJ + j;
        col = l;
    }

    const int KTT = g.GK * BK;
    const int kf0 = ko0 - F;            // the k row of level-0 row 0
    const bool lo_edge = kb0 == 0, hi_edge = kb1 == g.GK;
    const int nsteps = (P1 - P0) + 2 * F;
    const int q00 = P0 - F;
    // own column of levels 1 to F-1 at the two planes before the newest
    // (index f: level f; level 0's stay in its ring)
    float lo[F][UR], mid[F][UR];
#pragma unroll
    for (int f = 1; f < F; ++f)
#pragma unroll
        for (int u = 0; u < UR; ++u) lo[f][u] = mid[f][u] = 0.0f;
    for (int d = 0; d < g.D; ++d) issue(q00 + d, d);
    int sa = 0;                         // ring slot of plane q00 + s
    // One step; EDGE: the clamp's code compiled in
    auto step = [&](int s, auto edge) {
        constexpr bool EDGE = decltype(edge)::value;
        // this step's output rows' addresses (the other buffer may still be
        // read by the previous step's level F)
        float** ro = rowofs + (s & 1) * (g.PK * BK * g.PJ * BJ);
        const int qF = q00 + s - F;
        if (qF >= P0 && qF < P1) {
            const int wi = wbrick(qF);
            const long long* btw = bt + wi * NKJ;
            const long long wofs = (qF - (wbf + wi) * BW) * wslice + i0;
            for (int r = tid; r < KT * WJ; r += NT) {
                // output row (kr, jr) is level-0 row (kr + F, jr + F)
                const int kr = r / WJ, jr = r - kr * WJ;
                const int rr = (kr + F) * NJ0 + jr + F;
                ro[r] = out + (btw[rowinfo[3 * rr]] + wofs
                               + rowinfo[3 * rr + 1]);
            }
        }
        rs4_cp_wait(g.D - 1);
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
        // level f-1's plane a - f (its in-plane neighbours): level 0's slot
        // before sa, level f's plane of the other parity
        const float* src = pm;
        float nw[UR];                   // level f-1's newest, f >= 2
#pragma unroll
        for (int f = 1; f <= F; ++f) {
            const int q = q00 + s - f;
            const bool valid = f < F ? q >= P0 - (F - f) && q < P1 + (F - f)
                                     : q >= P0 && q < P1;
            float nx[UR];
#pragma unroll
            for (int u = 0; u < UR; ++u) nx[u] = 0.0f;
            if (valid && top >= f) {
                // the star on level f-1: its w taps, centre and the group's
                // own k rows from registers (level 0's from its ring; at an
                // edge the k rows from shared memory), the rows above and
                // below, the j and i neighbours from shared memory
                const float* p = src + ofs;
                const float km = p[-LEAD], kp = p[QS];
#pragma unroll
                for (int u = 0; u < UR; ++u) {
                    float acc = 0.0f;
#pragma unroll
                    for (int t = 0; t < L::N; ++t) {
                        float v;
                        if (L::dw(t) > 0) {
                            v = f == 1 ? pa[ofs + u * WS] : nw[u];
                        } else if (L::dw(t) < 0) {
                            v = f == 1 ? pl[ofs + u * WS] : lo[f - 1][u];
                        } else if (L::di(t) != 0) {
                            v = p[u * WS + L::di(t)];
                        } else if (L::dj(t) != 0) {
                            v = p[u * WS + L::dj(t) * RW];
                        } else {
                            const int r = u + L::dk(t);
                            const int rc = r < 0 ? 0 : r >= UR ? UR - 1 : r;
                            v = r < 0 ? km
                                : r >= UR ? kp
                                : (f == 1 || (EDGE && r != u))
                                    ? p[rc * WS]
                                    : mid[f - 1][rc];
                        }
                        acc += cf.c[t] * v;
                    }
                    nx[u] = acc;
                }
            }
            if (f < F) {
                if (valid && top >= f) {
                    float* dst = level_plane(f, s & 1);
#pragma unroll
                    for (int u = 0; u < UR; ++u) {
                        const float v = nx[u];
                        if constexpr (EDGE) {
                            // rows beyond the table take the values of
                            // their clamped rows, stored from there
                            const int R = r0 + u, k = kf0 + R;
                            if (k < 0 || k >= KTT) continue;
                            if (lo_edge && k >= BK - (F - f) && k < BK) {
                                dst[row_ofs(R - BK) + cofs] = v;
                            }
                            if (hi_edge && k >= KTT - BK
                                && k < KTT - BK + (F - f)) {
                                dst[row_ofs(R + BK) + cofs] = v;
                            }
                        }
                        dst[ofs + u * WS] = v;
                    }
                }
                src = level_plane(f, (s + 1) & 1);
            } else if (valid && top >= F) {
#pragma unroll
                for (int u = 0; u < UR; ++u) {
                    const int kr = r0 + u - F;
                    if (kr >= 0 && kr < KT) ro[orow + u * WJ][col] = nx[u];
                }
            }
            // level f-1's planes move down one (level 0's ring moves by
            // itself); level f's newest is nx
#pragma unroll
            for (int u = 0; u < UR; ++u) {
                if (f >= 2) {
                    lo[f - 1][u] = mid[f - 1][u];
                    mid[f - 1][u] = nw[u];
                }
                if (f < F) nw[u] = nx[u];
            }
        }
    };
    // (a block at no edge runs a loop without the clamp's code)
    if (lo_edge || hi_edge) {
        for (int s = 0; s < nsteps; ++s) {
            step(s, std::true_type());
            sa = sa + 1 == R0 ? 0 : sa + 1;
        }
    } else {
        for (int s = 0; s < nsteps; ++s) {
            step(s, std::false_type());
            sa = sa + 1 == R0 ? 0 : sa + 1;
        }
    }
    // drain the (empty) trailing groups
    rs4_cp_wait(0);
}
