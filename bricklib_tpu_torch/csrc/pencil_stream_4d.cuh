// The w-streaming block body of kernel K4 (pencil_sweep_4d.cu).
//
// One block owns a chunk of output w bricks [wb0, wb1) of one batch member,
// PK output brick rows in k [kb0, kb1), PJ output pencils [jp0, jp1) and TI
// lanes of i from i0.  It walks the chunk's w planes in increasing w as a
// wavefront over the F fused levels, as K1's body walks k planes
// (pencil_stream.cuh): at step s, level-0 plane a = P0 - F*wlo + s has
// arrived, and level f (1..F) computes its plane a - f*whi - (the skewed
// boundaries below f) from level f-1's ring, with a barrier between two
// levels unless the planner skewed their boundary.  Each intermediate
// level keeps a ring of rw + 1 planes (rw = wlo + whi), one more below a
// skewed boundary; level 0 keeps rw + 1 + D, D planes being loaded ahead
// with cp.async while the block computes.  Level F goes straight to the
// output bricks.  So the w halo of a chunk is loaded and computed once per
// chunk; only k, j and i keep a halo, F radii deep at level 0 and one
// radius less per level.
//
// A plane of level f is (KT + (F-f)*rk) k rows, each of (WJ + (F-f)*rj) j
// rows of RW = TI + 2H floats (the same i coordinates at every level:
// column H is lane i0), stored k row after k row: a k row is one run of Wf
// = NJf * RW floats.  A j tap is then RW floats away, a k tap Wf.
//
// The intermediate levels' k clamp.  Level f's k rows below the table,
// [-(F-f)*klo, 0), take its rows [BK - (F-f)*klo, BK); those above, [KT,
// KT + (F-f)*khi) with KT = GK*BK, its rows [KT - BK, KT - BK +
// (F-f)*khi).  Streaming w, both sources are rows of the same plane of the
// same level, computed by this block (its k rows include the edge brick
// row), so a thread that computes a source row stores its value into the
// clamped row too, in the same pass, and rows beyond the table are never
// stored otherwise.  No stash, no pre-roll, no extra barrier: the clamp
// code is compiled into the bodies of the blocks whose k rows reach an
// edge only.
//
// Shared memory, in floats: H floats, the level-0 ring, the rings of
// levels 1 to F-1, stream4_slack floats, then the block's brick table (one
// 64-bit element offset per (w brick, k brick, pencil) the block touches,
// clamps applied), per level-0 row (k row, j row) its (k brick, pencil)
// index in that table and its in-brick offset, and two buffers of the
// output rows' offsets in X (one per step parity).
//
// Threads take fixed elements of each plane, with no division: a thread
// computes BT4_UR = 4 consecutive k rows of one column (lanes on
// consecutive columns, so every warp access is one contiguous run).
// Levels 1 to F-1 compute whole k rows of Wf floats, margins included (a
// needed column never reads a margin column), as a run of (quads of k
// rows x Wf columns): a warp's 32 columns are one contiguous run, free of
// bank conflicts (computing only the needed columns of each j row was 4%
// slower: a run of them straddles j rows 2H floats apart).  Level F
// computes the output lanes only, items (quad, j row, 32 lanes) spread
// over the warps.  Under the 4-D star's layout compiled in
// (tap_layouts.cuh, LayoutStar9) every tap's offset is a compile-time
// expression of the row widths, so a value that several taps and rows
// read is one load kept in a register: the star's 9 taps over 4
// rows read 30 values, not 36 (its centre and k taps share six rows).  Any
// other tap list takes the generic body (offsets read at run time).  Each
// output's sum is the chain acc = 0; acc += c[t] * x[t] in tap order.
//
// Level 0 comes in PW-float pieces (PW = 4: 16-byte cp.async.cg), each
// piece of a row wrapping modulo BI as a whole, so the H-wide margins hold
// the wrapped lanes.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "pencil_stream.cuh"
#include "tap_layouts.cuh"

#define BT4_MAX_TAPS 128
#define BT4_UR 4                // k rows a thread computes at once

struct Sweep4Taps {
    int n;
    int dw[BT4_MAX_TAPS];
    int dk[BT4_MAX_TAPS];
    int dj[BT4_MAX_TAPS];
    int di[BT4_MAX_TAPS];
    float c[BT4_MAX_TAPS];
};

struct Stream4Geom {
    int GW, GK, GJ;                     // table shape
    int BW, BK, BJ, BI;                 // brick shape
    int W0, W1, WCH, nwch;              // output w bricks, per chunk, chunks
    int K0, K1, PK, nkg;                // output k bricks, per block, groups
    int J0, J1, PJ, njg;                // output pencils, per block, groups
    int TI, nit;                        // i lanes per block, i tiles
    int H, PW, D, F;                    // i margin, piece, lookahead, levels
    int wlo, whi, klo, khi, jlo, jhi, ilo, ihi;   // radius per side
    long long stride;                   // bricks between batch members
    int skew;                           // bit f: levels f, f+1 skewed
};

// Floats a level may read past its source plane: a tap's reach (up to H)
// and level F's lanes past an i tile that is not a multiple of 32 (up to
// 31); with bricks less than BT4_UR deep in k a block may hold fewer k rows
// than a quad, whose last rows read up to BT4_UR - BK rows beyond.
__host__ __device__ __forceinline__ long long stream4_slack(
    const Stream4Geom& g) {
    const long long W0M = (long long)(g.PJ * g.BJ + g.F * (g.jlo + g.jhi))
                          * (g.TI + 2 * g.H);
    return g.H + 40 + (g.BK < BT4_UR ? (BT4_UR - g.BK) * W0M : 0);
}

// Floats of one plane of level f at the block's largest footprint.
__host__ __device__ __forceinline__ long long stream4_plane(
    const Stream4Geom& g, int f) {
    const int d = g.F - f;
    return (long long)(g.PK * g.BK + d * (g.klo + g.khi))
           * (g.PJ * g.BJ + d * (g.jlo + g.jhi)) * (g.TI + 2 * g.H);
}

// Floats of the rings, H floats before them (a tap may read up to ilo <= H
// floats before a plane) and the slack after, rounded up to an even count
// so that the 64-bit brick table after them is aligned; the host's
// stream4_smem counts the same.
__host__ __device__ __forceinline__ long long stream4_ring_floats(
    const Stream4Geom& g) {
    const int rw = g.wlo + g.whi;
    long long n = (rw + 1 + g.D) * stream4_plane(g, 0);
    for (int f = 1; f < g.F; ++f)
        n += (rw + 1 + ((g.skew >> f) & 1)) * stream4_plane(g, f);
    return (g.H + n + stream4_slack(g) + 1) & ~1LL;
}

// A block's whole dynamic shared memory: the rings, the brick table, two
// ints per level-0 row and two buffers of the output rows' offsets.
__host__ __device__ __forceinline__ long long stream4_smem_bytes(
    const Stream4Geom& g) {
    const long long rows0 = (long long)(g.PK * g.BK + g.F * (g.klo + g.khi))
                            * (g.PJ * g.BJ + g.F * (g.jlo + g.jhi));
    return 4 * stream4_ring_floats(g)
           + 8LL * (g.WCH + 2) * (g.PK + 2) * (g.PJ + 2) + 8 * rows0
           + 16LL * g.PK * g.BK * g.PJ * g.BJ;
}

// The runtime taps equal layout L's offsets (L::N == 0: never).
template <class L>
static inline bool layout4_matches(const Sweep4Taps& taps) {
    if constexpr (L::N == 0) {
        return false;
    } else {
        if (taps.n != L::N)
            return false;
        for (int t = 0; t < L::N; ++t)
            if (taps.dw[t] != L::dw(t) || taps.dk[t] != L::dk(t)
                || taps.dj[t] != L::dj(t) || taps.di[t] != L::di(t))
                return false;
        return true;
    }
}

// L: the tap layout (tap_layouts.cuh), LayoutRuntime for the generic body
template <class L>
__device__ __forceinline__ void stream4_block(const float* __restrict__ x,
                                              float* __restrict__ out,
                                              const int* __restrict__ table,
                                              const Stream4Geom& g,
                                              const Sweep4Taps& taps, int b,
                                              float* smem) {
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int it = b % g.nit;
    b /= g.nit;
    const int jg = b % g.njg;
    b /= g.njg;
    const int kg = b % g.nkg;
    b /= g.nkg;
    const int wc = b % g.nwch;
    const int sub = b / g.nwch;

    const int F = g.F, BW = g.BW, BK = g.BK, BJ = g.BJ, BI = g.BI;
    const int wlo = g.wlo, whi = g.whi, klo = g.klo, khi = g.khi;
    const int jlo = g.jlo;
    const int rw = wlo + whi, rk = klo + khi, rj = jlo + g.jhi;
    const int wb0 = g.W0 + wc * g.WCH, wb1 = min(wb0 + g.WCH, g.W1);
    const int P0 = wb0 * BW, P1 = wb1 * BW;
    const int kb0 = g.K0 + kg * g.PK, kb1 = min(kb0 + g.PK, g.K1);
    const int ko0 = kb0 * BK, KT = (kb1 - kb0) * BK;
    const int jp0 = g.J0 + jg * g.PJ, jp1 = min(jp0 + g.PJ, g.J1);
    const int jo0 = jp0 * BJ, WJ = (jp1 - jp0) * BJ;
    const int i0 = it * g.TI;
    const int RW = g.TI + 2 * g.H;
    const int NK0 = KT + F * rk, NJ0 = WJ + F * rj;
    const int R0 = rw + 1 + g.D;
    const int PS0 = (int)stream4_plane(g, 0);
    const long long brick = (long long)BW * BK * BJ * BI;
    const long long wslice = (long long)BK * BJ * BI;

    // the block's brick table: w bricks [wbf, wbf + NWB), k bricks [kbf,
    // kbf + NKB), pencils [jbf, jbf + NJB), each entry the element offset
    // of its (clamped) brick in X; then per level-0 row (k row, j row) its
    // (k brick, pencil) index and in-brick offset; then the output rows'
    // offsets in X, one buffer per step parity
    const int NKBM = g.PK + 2, NJBM = g.PJ + 2, NKJ = NKBM * NJBM;
    long long* bt = (long long*)(smem + stream4_ring_floats(g));
    int* rowinfo = (int*)(bt + (g.WCH + 2) * NKJ);
    long long* rowofs = (long long*)(
        rowinfo + 2 * (g.PK * BK + F * rk) * (g.PJ * BJ + F * rj));
    const int wbf = floor_div(P0 - F * wlo, BW);
    const int NWB = floor_div(P1 + F * whi - 1, BW) - wbf + 1;
    const int kbf = floor_div(ko0 - F * klo, BK);
    const int NKB = floor_div(ko0 + KT + F * khi - 1, BK) - kbf + 1;
    const int jbf = floor_div(jo0 - F * jlo, BJ);
    const int NJB = floor_div(jo0 + WJ + F * g.jhi - 1, BJ) - jbf + 1;
    const long long bofs = sub * g.stride;
    for (int e = tid; e < NWB * NKJ; e += nthr) {
        const int a = e / NKJ, r = e - a * NKJ;
        const int kb = r / NJBM, jb = r - kb * NJBM;
        if (kb < NKB && jb < NJB)
            bt[e] = (bofs
                     + table[(clamp_int(wbf + a, 0, g.GW - 1) * g.GK
                              + clamp_int(kbf + kb, 0, g.GK - 1)) * g.GJ
                             + clamp_int(jbf + jb, 0, g.GJ - 1)])
                    * brick;
    }
    for (int r = tid; r < NK0 * NJ0; r += nthr) {
        const int kr = r / NJ0, jr = r - kr * NJ0;
        const int k = ko0 - F * klo + kr, j = jo0 - F * jlo + jr;
        const int kb = floor_div(k, BK), jb = floor_div(j, BJ);
        rowinfo[2 * r] = (kb - kbf) * NJBM + (jb - jbf);
        rowinfo[2 * r + 1] = ((k - kb * BK) * BJ + (j - jb * BJ)) * BI;
    }
    __syncthreads();

    const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

    // level-0 plane q into its ring slot, in PW-float pieces, one group;
    // planes beyond the table read the clamped w brick (the table)
    const int PW = g.PW;
    const int NP = RW / PW;
    const int ibase = i0 - g.H;
    const PlaneWalk w0(tid, nthr, NP);
    // this thread's pieces of every plane (at most BT4_PIECES; more take
    // the walk): (k brick, pencil) index, offset in X within the w slice,
    // offset in the ring slot
    constexpr int BT4_PIECES = 3;
    const int npc = (NK0 * NJ0 * NP - tid + nthr - 1) / nthr;
    int pcb[BT4_PIECES], pco[BT4_PIECES], pcs[BT4_PIECES];
    {
        PlaneWalk w = w0;
#pragma unroll
        for (int p = 0; p < BT4_PIECES; ++p) {
            const int r = p < npc ? w.r : 0, c = p < npc ? w.c : 0;
            int ii = ibase + c * PW;
            while (ii < 0) ii += BI;
            while (ii >= BI) ii -= BI;
            pcb[p] = rowinfo[2 * r];
            pco[p] = rowinfo[2 * r + 1] + ii;
            pcs[p] = r * RW + c * PW;
            w.next();
        }
    }
    // ring slots and w bricks without a division: a ring slot counts a
    // plane from the stream's first plane q00, a w brick from the block's
    // first, wbf (both below 2^20 planes back)
    const float inv0 = 1.0f / R0, invA = 1.0f / (rw + 1);
    const float invB = 1.0f / (rw + 2), invBW = 1.0f / BW;
    auto wbrick = [&](int q) {          // the w brick of plane q, - wbf
        return div_by(q - wbf * BW, invBW);
    };
    auto issue = [&](int q, int qb) {
        const int wi = wbrick(q);
        const long long* btw = bt + wi * NKJ;
        const long long wofs = (q - (wbf + wi) * BW) * wslice;
        float* dst = smem + g.H + mod_by(q - qb, R0, inv0) * PS0;
        if (npc <= BT4_PIECES) {
#pragma unroll
            for (int p = 0; p < BT4_PIECES; ++p) {
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
        for (int e = tid; e < NK0 * NJ0 * NP; e += nthr) {
            int ii = ibase + w.c * PW;
            while (ii < 0) ii += BI;
            while (ii >= BI) ii -= BI;
            const float* src = x + btw[rowinfo[2 * w.r]] + wofs
                               + rowinfo[2 * w.r + 1] + ii;
            float* d = dst + w.r * RW + w.c * PW;
            if (PW == 4)
                bt_cp_async16(d, src);
            else
                bt_cp_async4(d, src);
            w.next();
        }
        bt_cp_commit();
    };

    // level F's items (quad of k rows, j row, 32 output lanes), warp w
    // taking the items w, w + nwarp, ...
    const int cpr = (g.TI + 31) >> 5;
    const PlaneWalk wf(warp, nwarp, WJ * cpr);

    // the k clamp of the intermediate levels: this block's k rows reach
    // below (above) the table
    const int KTT = g.GK * BK;
    const bool lo_edge = F > 1 && klo > 0 && kb0 == 0;
    const bool hi_edge = F > 1 && khi > 0 && kb1 == g.GK;

    // EDGE: the block's k rows reach a table edge (the clamp's code is
    // compiled in only then, out of the other blocks' loop)
    auto stream = [&](auto edge) {
    constexpr bool EDGE = decltype(edge)::value;
    const int skw = g.skew;
    const int lagF = F * whi + __popc(skw & ((1 << F) - 2));
    // level 0 has n0 planes; each skewed boundary delays the levels above
    // it by one step
    const int n0 = (P1 - P0) + F * rw;
    const int nsteps = n0 + __popc(skw & ((1 << F) - 2));
    const int q00 = P0 - F * wlo;
    for (int d = 0; d < g.D; ++d) {
        if (d < n0)
            issue(q00 + d, q00);
        else
            bt_cp_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
        // this step's output rows' offsets in X (the other buffer may still
        // be read by the previous step's level F)
        long long* ro = rowofs + (s & 1) * (g.PK * BK * g.PJ * BJ);
        const int qF = q00 + s - lagF;
        if (qF >= P0 && qF < P1) {
            const int wi = wbrick(qF);
            const long long* btw = bt + wi * NKJ;
            const long long wofs = (qF - (wbf + wi) * BW) * wslice + i0;
            for (int r = tid; r < KT * WJ; r += nthr) {
                // output row (kr, jr) is level-0 row (kr + F*klo, jr +
                // F*jlo)
                const int kr = r / WJ, jr = r - kr * WJ;
                const int r0 = (kr + F * klo) * NJ0 + jr + F * jlo;
                ro[r] = btw[rowinfo[2 * r0]] + wofs + rowinfo[2 * r0 + 1];
            }
        }
        bt_cp_wait(g.D - 1);
        __syncthreads();
        if (s + g.D < n0)
            issue(q00 + s + g.D, q00);
        else
            bt_cp_commit();
        const int q0 = q00 + s;
        // level f-1's ring and level f's, as offsets into smem; Ws: a k
        // row of level f-1, in floats
        int src = g.H, srcR = R0, srcPS = PS0, ring = g.H + R0 * PS0;
        int Ws = NJ0 * RW;
        float invs = inv0;
        for (int f = 1; f <= F; ++f) {
            const int qf = q0 - f * whi - __popc(skw & ((1 << f) - 2));
            const int NKf = KT + (F - f) * rk;
            const int Wf = (WJ + (F - f) * rj) * RW;
            const int PSf = (int)stream4_plane(g, f);
            const int Rf = rw + 1 + ((skw >> f) & 1);
            const float invf = (skw >> f) & 1 ? invB : invA;
            const int dst = ring + mod_by(qf - q00, Rf, invf) * PSf;
            if (qf >= P0 - (F - f) * wlo && qf < P1 + (F - f) * whi) {
                // plane qf + dw of level f-1 sits in slot qnk + dw (mod
                // srcR): the newest, qf + whi, in slot qnk + whi
                const int qnk = mod_by(qf + whi - q00, srcR, invs) - whi;
                // BT4_UR outputs of one column from element e of level f-1
                // (the centre of the first), k rows e, e + Ws, ...;
                // store(u, value) takes each result.  Each output's sum is
                // acc = 0; acc += c[t] * x[t] in tap order.
                auto rows = [&](int e, auto&& store) {
                    float acc[BT4_UR];
#pragma unroll
                    for (int u = 0; u < BT4_UR; ++u) acc[u] = 0.0f;
                    if constexpr (L::N > 0) {
                        // the layout's offsets are compile-time constants
                        // times the row widths: a value that several taps
                        // and rows read, (plane, k row, j row, lane), is
                        // one load kept in a register
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
                            for (int u = 0; u < BT4_UR; ++u)
                                acc[u] += ct * pl[L::dw(t) + L::R]
                                    [(L::dk(t) + u) * Ws + L::dj(t) * RW
                                     + L::di(t)];
                        }
                    } else {
                        for (int t = 0; t < taps.n; ++t) {
                            int sl = qnk + taps.dw[t];
                            if (sl < 0) sl += srcR;
                            const float* p = smem + (src + sl * srcPS + e
                                                     + taps.dk[t] * Ws
                                                     + taps.dj[t] * RW
                                                     + taps.di[t]);
                            const float ct = taps.c[t];
#pragma unroll
                            for (int u = 0; u < BT4_UR; ++u)
                                acc[u] += ct * p[Ws * u];
                        }
                    }
#pragma unroll
                    for (int u = 0; u < BT4_UR; ++u) store(u, acc[u]);
                };
                if (f < F) {
                    // every column of the level's k rows, margins included,
                    // by quads of BT4_UR rows, the last one moved up to end
                    // at the level's last row (its rows in the quad before
                    // are stored twice, the same values), warp w taking the
                    // 32-column chunks w, w + nwarp, ... of the run; a lane
                    // past the run computes quad 0 and stores nothing
                    const int nq = (NKf + BT4_UR - 1) / BT4_UR;
                    const int nch = (nq * Wf + 31) >> 5;
                    const int rlast = max(NKf - BT4_UR, 0);
                    // level f's k row r is k row kf0 + r of the table
                    const int kf0 = ko0 - (F - f) * klo;
                    PlaneWalk w(32 * warp + lane, 32 * nwarp, Wf);
                    for (int c = warp; c < nch; c += nwarp) {
                        const bool in = w.r < nq;
                        const int r0 = in ? min(BT4_UR * w.r, rlast) : 0;
                        const int col = w.c;
                        rows((r0 + klo) * Ws + jlo * RW + col,
                             [&](int u, float v) {
                            const int r = r0 + u;
                            if (!in || r >= NKf) return;
                            if constexpr (EDGE) {
                                // rows beyond the table take the values of
                                // their clamped rows, stored from there
                                const int k = kf0 + r;
                                if (k < 0 || k >= KTT) return;
                                if (lo_edge && k >= BK - (F - f) * klo
                                    && k < BK)
                                    smem[dst + (r - BK) * Wf + col] = v;
                                if (hi_edge && k >= KTT - BK
                                    && k < KTT - BK + (F - f) * khi)
                                    smem[dst + (r + BK) * Wf + col] = v;
                            }
                            smem[dst + r * Wf + col] = v;
                        });
                        w.next();
                    }
                } else {
                    // the output lanes only, items (quad, j row, 32 lanes),
                    // the last quad moved up as above
                    const int nq = (KT + BT4_UR - 1) / BT4_UR;
                    const int rlast = max(KT - BT4_UR, 0);
                    PlaneWalk w = wf;
                    for (int itm = warp; itm < nq * WJ * cpr;
                         itm += nwarp) {
                        const int r0 = min(BT4_UR * w.r, rlast);
                        const int jr = cpr == 1 ? w.c : w.c / cpr;
                        const int col = 32 * (w.c - jr * cpr) + lane;
                        rows((r0 + klo) * Ws + (jr + jlo) * RW + g.H + col,
                             [&](int u, float v) {
                            if (col < g.TI && r0 + u < KT)
                                out[ro[(r0 + u) * WJ + jr] + col] = v;
                        });
                        w.next();
                    }
                }
            }
            if (f < F) {
                if (!((skw >> f) & 1)) __syncthreads();
                src = ring;
                srcR = Rf;
                srcPS = PSf;
                invs = invf;
                ring += Rf * PSf;
                Ws = Wf;
            }
        }
    }
    // drain the (empty) trailing groups
    bt_cp_wait(0);
    };
    if (lo_edge || hi_edge)
        stream(std::true_type());
    else
        stream(std::false_type());
}
