// The k-streaming block body of kernel K12 (pencil_sweep_nd.cu), the
// rank-ND sweep (ND = 5 to 8, m = ND - 3 outer axes, fuse = 1).
//
// One block owns one outer brick cell c (all PB = B_0 * ... * B_{m-1}
// outer positions p of it), a chunk of output brick rows [kc0, kc1) in k,
// PJ output pencils [jp0, jp1) and TI lanes of i from i0.  It walks the
// chunk's k planes in increasing k, as the TPU kernel and K1 do: at step
// s the level-0 planes up to P0 - klo + s have arrived, and the block
// computes output plane qF = P0 + s - (klo + khi).  So the k halo of a
// chunk is loaded once per chunk; j and i keep a halo.
//
// What a plane holds.  The taps of an output at outer position p read
// outer positions p + o_t, o_t the outer part of tap t's offset: the cell's
// own positions, and, beyond its faces (corners for corner taps), the
// positions of neighbouring cells.  Each distinct (input field, outer
// position relative to the cell) that some output of the cell reads is a
// slice: (PJ * BJ + its j reach) rows of RW = TI + 2H floats, the j reach
// being the rows its taps reach below and above (none for a face slice of
// the star).  A slice that some tap reads at a k offset other than 0 lives
// in ring A, which keeps klo + khi + 1 + D planes; every other slice (the
// star's faces) lives in ring B, which keeps 1 + D planes: the plane of
// qF and the D being loaded.  Each plane of a ring is its slices' rows one
// after another.  The host (codegen/pencil_kernel_nd.py) lays the slices
// out and lists, per level-0 row of each ring, its slice and j offset, and
// per (position p, tap t) the tap's offset in floats from the start of its
// ring's plane (slice base, j row, i lane) and its ring: the tables of
// `info`.
//
// Level 0 comes in PW-float pieces (PW = 4: 16-byte cp.async.cg) D planes
// ahead of use, one commit group a step holding ring A's newest plane and
// ring B's plane of step s + D; each piece of a row wraps modulo BI as a
// whole, so the H-wide margins hold the wrapped lanes.  The block's brick
// table (per k brick row, slice and pencil: the address of the clamped
// brick of the slice's field, plus the slice's in-brick outer offset; every
// table axis clamps on its own) and per level-0 row its table index and
// in-brick j offset are resolved once per block into shared memory, with
// every division there; a level-0 piece is then a shared load and two adds
// per plane, an output row one shared load a step.
//
// Threads compute BT_UR = 4 rows of one column of one outer position
// (items (p, quad of rows, 32 lanes), warp w taking the items w, w +
// nwarp, ...).  Under the 5-D star's layout compiled in (tap_layouts.cuh,
// LayoutStar11) every tap but the four outer ones reads the position's own
// slice at compile-time offsets, so a value that several taps and rows
// read is one load kept in a register: 22 values per 4 outputs for those 7
// taps, and one per outer tap and row (from another position's slice in
// ring A, or a neighbouring cell's in ring B), 38 in all instead of 44.
// Every other tap list (several fields, corner taps, rank 6 to 8) takes
// the generic body: each tap's offset and ring read from shared memory.
// Each output's sum is the chain acc = 0; acc += c[t] * x[t] in tap
// order, as in K12's first design, so the two are equal bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "pencil_stream.cuh"
#include "tap_layouts.cuh"

#define BTN_MAX_RANK 8
#define BTN_MAX_FIELDS 8
#define BTN_MAX_TAPS 512
#define BTN_PARAM_TAPS 32       // coefficients passed as kernel parameters

struct NdGeom {
    int G[BTN_MAX_RANK];                // table extent per table axis
    int R0[BTN_MAX_RANK];               // first output brick per table axis
    int RC[BTN_MAX_RANK];               // output bricks per table axis
    int tstride[BTN_MAX_RANK];          // table strides
    int BK, BJ, BI;                     // brick extent in k, j, i
    int klo, khi, jlo;                  // k radius, j radius below
    long long belems;                   // elements per brick
    int KCH, nchunk, PJ, njg, TI, nit;  // footprint and counts
    int H, PW, D, RW;                   // i margin, piece, lookahead, row
    int ncell, PB, NS, NT;              // cells, positions, slices, taps
    int NRA, NRB, PSA, PSB, RA, RB;     // rows, plane floats and slots
    int nitems;                         // output items per step, at most
    // offsets (ints) into `info` of: per slice (field, in-brick outer
    // offset, cell step per outer axis); per level-0 row of ring A then B
    // (slice, j offset from the block's first output row); per position
    // its in-brick outer offset; per (position, tap) the tap's offset in
    // floats from its ring's plane and its ring (0: A, 1: B); per tap its
    // k offset and coefficient bits
    int o_slice, o_rows, o_pofs, o_toff, o_tring, o_taps;
    const float* x[BTN_MAX_FIELDS];     // input storages
    float c[BTN_PARAM_TAPS];            // coefficients (compiled layout)
};

// Floats a level may read past the rings: a tap's reach (up to H) and
// lanes past an i tile that is not a multiple of 32 (up to 31), and with
// fewer than BT_UR output rows, BT_UR rows beyond.
__host__ __device__ __forceinline__ int stream_nd_slack(const NdGeom& g) {
    return g.H + 40 + BT_UR * g.RW;
}

// Floats of the rings (H floats before them, the slack after), rounded up
// to an even count so that the 64-bit tables after them are aligned.
__host__ __device__ __forceinline__ long long stream_nd_ring_floats(
    const NdGeom& g) {
    return (g.H + (long long)g.RA * g.PSA + (long long)g.RB * g.PSB
            + stream_nd_slack(g) + 1) & ~1LL;
}

// A block's whole dynamic shared memory: the rings; the brick table
// ((KCH + 2) x NS x (PJ + 2) addresses); the output bricks (KCH x PJ) and
// two buffers of the output rows' offsets (PJ * BJ each); per level-0 row
// two ints; per (position, tap) its offset and ring in one int; per tap its
// k offset and coefficient; per position its in-brick offset; per item one
// int.
// The host's stream_nd_smem counts the same.
__host__ __device__ __forceinline__ long long stream_nd_smem_bytes(
    const NdGeom& g) {
    return 4LL * stream_nd_ring_floats(g)
           + 8LL * (g.KCH + 2) * g.NS * (g.PJ + 2)
           + 8LL * g.KCH * g.PJ + 16LL * g.PJ * g.BJ
           + 8LL * (g.NRA + g.NRB) + 4LL * g.PB * g.NT + 8LL * g.NT
           + 4LL * g.PB + 4LL * g.nitems;
}

// A thread's level-0 pieces of one ring's planes (at most BTN_PIECES; a
// thread with more takes the walk): table index within a k brick row,
// offset in X within that row, offset in the ring's plane
#define BTN_PIECES 6
struct NdPieces {
    int n;
    int b[BTN_PIECES], o[BTN_PIECES], s[BTN_PIECES];
};

// L: the tap layout (tap_layouts.cuh), LayoutRuntime for the generic body
template <int ND, class L>
__device__ __forceinline__ void stream_nd_block(const NdGeom& g,
                                                const int* __restrict__ info,
                                                const int* __restrict__ table,
                                                float* __restrict__ out,
                                                int b, float* smem) {
    constexpr int M = ND - 3;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int cell = b % g.ncell;
    b /= g.ncell;
    const int it = b % g.nit;
    b /= g.nit;
    const int jg = b % g.njg;
    const int ch = b / g.njg;

    const int BK = g.BK, BJ = g.BJ, BI = g.BI, klo = g.klo;
    const int rk = klo + g.khi;
    const int K0 = g.R0[M], J0 = g.R0[M + 1];
    const int kc0 = K0 + ch * g.KCH;
    const int kc1 = min(kc0 + g.KCH, K0 + g.RC[M]);
    const int P0 = kc0 * BK, P1 = kc1 * BK;
    const int jp0 = J0 + jg * g.PJ;
    const int jp1 = min(jp0 + g.PJ, J0 + g.RC[M + 1]);
    const int jo0 = jp0 * BJ, WJ = (jp1 - jp0) * BJ;
    const int i0 = it * g.TI;
    const int RW = g.RW, NS = g.NS, NT = g.NT, PB = g.PB;
    const int NJBM = g.PJ + 2, NKB = g.KCH + 2;
    const int NRA = g.NRA, NR = g.NRA + g.NRB;

    // shared memory after the rings
    const float** bt = (const float**)(smem + stream_nd_ring_floats(g));
    long long* obt = (long long*)(bt + NKB * NS * NJBM);
    long long* rowofs = obt + g.KCH * g.PJ;
    int* rowinfo = (int*)(rowofs + 2 * g.PJ * BJ);
    int* s_toff = rowinfo + 2 * NR;
    int* s_tdk = s_toff + PB * NT;
    float* s_tc = (float*)(s_tdk + NT);
    int* s_pofs = (int*)(s_tc + NT);
    int* s_items = s_pofs + PB;

    // the cell's outer brick coordinates and its table offset
    int cc[M];
    int ocell = 0;
    {
        int q = cell;
#pragma unroll
        for (int a = M - 1; a >= 0; --a) {
            cc[a] = g.R0[a] + q % g.RC[a];
            q /= g.RC[a];
            ocell += cc[a] * g.tstride[a];
        }
    }
    const int GK = g.G[M], GJ = g.G[M + 1];
    const int tsk = g.tstride[M];
    const int kbf = floor_div(P0 - klo, BK);
    const int jbf = floor_div(jo0 - g.jlo, BJ);

    // the brick table: per k brick row kbf + kr, slice s and pencil jbf +
    // jr, the address of the slice's (clamped) brick in its field's
    // storage plus the slice's in-brick outer offset
    const int* sl = info + g.o_slice;
    for (int e = tid; e < NKB * NS * NJBM; e += nthr) {
        const int jr = e % NJBM, r2 = e / NJBM;
        const int s = r2 % NS, kr = r2 / NS;
        const int* si = sl + s * (2 + M);
        int to = clamp_int(kbf + kr, 0, GK - 1) * tsk
                 + clamp_int(jbf + jr, 0, GJ - 1);
#pragma unroll
        for (int a = 0; a < M; ++a)
            to += clamp_int(cc[a] + si[2 + a], 0, g.G[a] - 1) * g.tstride[a];
        bt[e] = g.x[si[0]] + (long long)table[to] * g.belems + si[1];
    }
    // the output bricks: brick row kc0 + kr, pencil jp0 + jr
    for (int e = tid; e < (kc1 - kc0) * g.PJ; e += nthr) {
        const int kr = e / g.PJ, jr = e - kr * g.PJ;
        if (jp0 + jr < jp1)
            obt[e] = (long long)table[ocell + (kc0 + kr) * tsk + jp0 + jr]
                     * g.belems;
    }
    // per level-0 row: its table index within a k brick row, its in-brick
    // j offset
    const int* rows = info + g.o_rows;
    for (int r = tid; r < NR; r += nthr) {
        const int j = jo0 + rows[2 * r + 1];
        const int jb = floor_div(j, BJ);
        rowinfo[2 * r] = rows[2 * r] * NJBM + (jb - jbf);
        rowinfo[2 * r + 1] = (j - jb * BJ) * BI;
    }
    // (position, tap): twice the offset, plus 1 in ring B
    for (int e = tid; e < PB * NT; e += nthr)
        s_toff[e] = 2 * info[g.o_toff + e] + info[g.o_tring + e];
    for (int t = tid; t < NT; t += nthr) {
        s_tdk[t] = info[g.o_taps + 2 * t];
        s_tc[t] = __int_as_float(info[g.o_taps + 2 * t + 1]);
    }
    for (int p = tid; p < PB; p += nthr) s_pofs[p] = info[g.o_pofs + p];
    // the output items (position, quad of rows, 32 lanes), packed; the
    // last quad moved up to end at the last row (its rows in the quad
    // before are stored twice, the same values)
    const int nq = (WJ + BT_UR - 1) / BT_UR, cpr = (g.TI + 31) >> 5;
    const int nitm = PB * nq * cpr;
    for (int i = tid; i < nitm; i += nthr) {
        const int p = i / (nq * cpr), rest = i - p * (nq * cpr);
        const int q = rest / cpr, c = rest - q * cpr;
        const int r0 = WJ >= BT_UR ? min(BT_UR * q, WJ - BT_UR) : 0;
        s_items[i] = p | (r0 << 12) | (c << 24);
    }
    __syncthreads();

    const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;

    // level-0 planes: ring A holds rows [0, NRA) of the row list, ring B
    // rows [NRA, NR)
    const int PW = g.PW, NP = RW / PW, ibase = i0 - g.H;
    const int baseA = g.H, baseB = g.H + g.RA * g.PSA;
    auto pieces = [&](int r0, int nrows) {
        NdPieces pc;
        pc.n = (nrows * NP - tid + nthr - 1) / nthr;
        PlaneWalk w(tid, nthr, NP);
#pragma unroll
        for (int p = 0; p < BTN_PIECES; ++p) {
            const int r = p < pc.n ? w.r : 0, c = p < pc.n ? w.c : 0;
            int ii = ibase + c * PW;
            while (ii < 0) ii += BI;
            while (ii >= BI) ii -= BI;
            pc.b[p] = rowinfo[2 * (r0 + r)];
            pc.o[p] = rowinfo[2 * (r0 + r) + 1] + ii;
            pc.s[p] = r * RW + c * PW;
            w.next();
        }
        return pc;
    };
    const NdPieces pcA = pieces(0, NRA), pcB = pieces(NRA, g.NRB);
    const float invBK = 1.0f / BK;
    // plane q of the ring whose rows start at row r0 of the list (nrows
    // rows, the thread's pieces pc), into dst
    auto issue = [&](int q, float* dst, int r0, int nrows,
                     const NdPieces& pc) {
        const int kr = div_by(q - kbf * BK, invBK);
        const float* const* btk = bt + kr * NS * NJBM;
        const long long kofs = (long long)(q - (kbf + kr) * BK) * BJ * BI;
        if (pc.n <= BTN_PIECES) {
#pragma unroll
            for (int p = 0; p < BTN_PIECES; ++p) {
                if (p >= pc.n) break;
                const float* src = btk[pc.b[p]] + kofs + pc.o[p];
                if (PW == 4)
                    bt_cp_async16(dst + pc.s[p], src);
                else
                    bt_cp_async4(dst + pc.s[p], src);
            }
            return;
        }
        PlaneWalk w(tid, nthr, NP);
        for (int e = tid; e < nrows * NP; e += nthr) {
            int ii = ibase + w.c * PW;
            while (ii < 0) ii += BI;
            while (ii >= BI) ii -= BI;
            const int r = r0 + w.r;
            const float* src = btk[rowinfo[2 * r]] + kofs
                               + rowinfo[2 * r + 1] + ii;
            float* d = dst + w.r * RW + w.c * PW;
            if (PW == 4)
                bt_cp_async16(d, src);
            else
                bt_cp_async4(d, src);
            w.next();
        }
    };

    // One step a plane: ring A's plane q00 + s arrives at step s, in slot
    // s mod RA; output plane qF = P0 + s - rk is computed at step s from
    // ring A's planes qF - klo .. qF + khi and ring B's plane qF, in slot
    // (qF - P0) mod RB.  The group of step s is issued D steps ahead.
    const int nA = (P1 - P0) + rk;
    const int q00 = P0 - klo;
    const float invA = 1.0f / g.RA, invB = 1.0f / g.RB;
    auto issue_step = [&](int s) {
        if (s < nA)
            issue(q00 + s, smem + baseA + mod_by(s, g.RA, invA) * g.PSA, 0,
                  NRA, pcA);
        const int qb = P0 + s - rk;
        if (g.NRB > 0 && qb >= P0 && qb < P1)
            issue(qb, smem + baseB + mod_by(qb - P0, g.RB, invB) * g.PSB,
                  NRA, g.NRB, pcB);
        bt_cp_commit();
    };
    for (int d = 0; d < g.D; ++d) issue_step(d);
    for (int s = 0; s < nA; ++s) {
        const int qF = P0 + s - rk;
        const bool live = qF >= P0;
        long long* ro = rowofs + (s & 1) * g.PJ * BJ;
        if (live) {
            // this step's output rows' offsets in `out` (the other buffer
            // may still be read by the previous step's items)
            const int kb = qF / BK;
            const long long kofs = (long long)(qF - kb * BK) * BJ * BI + i0;
            for (int r = tid; r < WJ; r += nthr) {
                const int jr = r / BJ;
                ro[r] = obt[(kb - kc0) * g.PJ + jr] + kofs
                        + (r - jr * BJ) * BI;
            }
        }
        bt_cp_wait(g.D - 1);
        __syncthreads();
        issue_step(s + g.D);
        if (!live) continue;
        // plane qF + dk of ring A sits in slot qnk + dk (mod RA)
        const int qnk = mod_by(s, g.RA, invA) - g.khi;
        const float* pB = smem + baseB + mod_by(s - rk, g.RB, invB) * g.PSB;
        for (int i = warp; i < nitm; i += nwarp) {
            const int pk = s_items[i];
            const int p = pk & 4095, r0 = (pk >> 12) & 4095;
            const int col = 32 * (pk >> 24) + lane;
            const int e = r0 * RW + g.H + col;
            const int* toff = s_toff + p * NT;
            float acc[BT_UR];
#pragma unroll
            for (int u = 0; u < BT_UR; ++u) acc[u] = 0.0f;
            if constexpr (L::N > 0) {
                // every tap but the outer ones reads the position's own
                // slice (tap 0, the centre, gives its offset) at
                // compile-time offsets: a value that several taps and rows
                // read is one load kept in a register; an outer tap reads
                // another position of the cell (ring A, k offset 0) or of
                // a neighbouring cell (ring B)
                const float* pl[2 * L::R + 1];
#pragma unroll
                for (int d = 0; d <= 2 * L::R; ++d) {
                    int slt = qnk + d - L::R;
                    if (slt < 0) slt += g.RA;
                    pl[d] = smem + baseA + slt * g.PSA + (toff[0] >> 1) + e;
                }
#pragma unroll
                for (int t = 0; t < L::N; ++t) {
                    const float ct = g.c[t];
                    if (L::outer(t)) {
                        // pl[R] - toff[0] / 2: ring A's plane qF at
                        // element e
                        const int o = toff[t];
                        const float* q = (o & 1 ? pB + e
                                                : pl[L::R] - (toff[0] >> 1))
                                         + (o >> 1);
#pragma unroll
                        for (int u = 0; u < BT_UR; ++u)
                            acc[u] += ct * q[RW * u];
                    } else {
#pragma unroll
                        for (int u = 0; u < BT_UR; ++u)
                            acc[u] += ct * pl[L::dk(t) + L::R]
                                [(L::dj(t) + u) * RW + L::di(t)];
                    }
                }
            } else {
                for (int t = 0; t < NT; ++t) {
                    const int o = toff[t];
                    const float* q;
                    if (o & 1) {
                        q = pB + (o >> 1) + e;
                    } else {
                        int slt = qnk + s_tdk[t];
                        if (slt < 0) slt += g.RA;
                        q = smem + baseA + slt * g.PSA + (o >> 1) + e;
                    }
                    const float ct = s_tc[t];
#pragma unroll
                    for (int u = 0; u < BT_UR; ++u) acc[u] += ct * q[RW * u];
                }
            }
            const long long po = s_pofs[p] + col;
#pragma unroll
            for (int u = 0; u < BT_UR; ++u)
                if (col < g.TI && r0 + u < WJ) out[ro[r0 + u] + po] = acc[u];
        }
    }
    // drain the (empty) trailing groups
    bt_cp_wait(0);
}
