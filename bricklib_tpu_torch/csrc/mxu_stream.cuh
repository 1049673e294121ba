// The k-streaming block body of kernel K8 (pencil_sweep_mxu.cu).
//
// One block owns a chunk of output brick rows [kc0, kc1), a group of output
// pencils [jp0, jp1) and TI lanes of i from i0.  It walks the chunk's k rows
// (planes) in increasing k: at step s, level-0 plane q00 + s has arrived
// (q00 = kc0*BK - klo), and the block computes output plane p = q00 + s -
// khi, which reads level-0 planes p - klo .. p + khi.  Level 0 keeps a ring
// of klo + khi + 1 + D planes, D of them loaded ahead with cp.async while the
// block computes; nothing else persists between steps, because K8 is one
// level: an output plane is a function of its level-0 planes alone.  So the
// k halo of a chunk is loaded once per chunk, not once per brick row, and
// the factorized form's stages run once per (k row, j row, lane):
//   W_w[p, jp, i] = sum over dk of c_w[dk] * L0[p + dk, jp, i]   (nW profiles)
//   V_t[p, jj, i] = sum over the terms (dj, w) of tuple t: W_w[p, jj + dj, i]
//   out[p, jj, i] = sum over the distinct di: V_t(di)[p, jj, i + di]
// A tuple is one distinct list of V terms: ir.fold_linear gives the same
// terms to di and -di of a symmetric stencil, so the 125-point cube has 5
// di but 3 tuples.
//
// Warps and lanes.  A warp owns a strip of MX_UR = 8 output j rows (the
// block's j rows, PJ*BJ of them, in strips, the last strip moved up to end
// at the last row) and 32 consecutive lanes, of which the OW = 32 - ilo -
// ihi in the middle are output lanes: lane l of chunk wc holds column
// wc*OW - ilo + l of the tile.  Its V values for all 32 lanes stay in
// registers, and the i stage takes the neighbours' by __shfl_sync, so V
// never touches shared memory and needs no barrier.  A block has one warp
// per (strip, lane chunk): TI = nwc*OW lanes, PJ*BJ/8 strips (rounded up).
//
// The compiled layout (LayoutMxu125, mpi125pt's folded form: 6 k-profiles
// of 5 k taps, 3 tuples of 5 terms, dj -2..2, di -2..2).  A thread walks
// the MX_UR + jlo + jhi level-0 rows of its strip once: per row it loads
// the row's 2*RK + 1 plane values (one per k tap), computes every profile
// from them in registers and adds each profile to the V sums that take it
// (the rows jj = jp - jlo - dj of each tuple); a V sum is complete after
// its last term, so the 3 x 8 sums never all live at once.  The layout's
// profiles are even in dk (the stencil's symmetry), so the planes at -dk
// and +dk are summed once a row and each profile takes RK + 1 products:
// 20 operations a row where the taps one by one took 30.  Each value is
// one shared-memory load per k tap and row: 5 x 12 loads for 8 rows, 7.5
// per output row, where the first design read about 40 shared values per
// output.  Any other folded stencil runs the generic body: the W stage over
// the plane's rows into a W buffer in shared memory (the coefficients' k
// radius a template argument, the profiles read at run time, four elements
// a thread), then, one step later, V and the i stage from there for the
// strip's 8 rows at once, the terms read at run time.
//
// The sums' order: the generic body's W is the chain acc = 0; acc =
// fmaf(c, x, acc) over dk in order, the first design's; the compiled
// layout's is c[0] * x[0], then fmaf(c[r], x[-r] + x[r], acc) for r = 1 ..
// RK.  Each V sum is its terms in order, each output V_t(di)[i + di] over
// di in order.  So the generic body equals the first design bit for bit,
// and the compiled layout differs from it by the rounding of its W sums
// only; either computes a value once for every footprint, by the same
// operations in the same order.
//
// Level 0 comes in PW-float pieces (16-byte cp.async.cg where PW = 4),
// each piece of a row wrapping modulo BI as a whole; the block's brick
// table (one 64-bit element offset per (brick row, pencil) it touches,
// clamped to the table's edge) and each level-0 row's pencil and in-brick
// offset are made once per block, as in pencil_stream.cuh.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "pencil_stream.cuh"

#define MX_UR 8                 // output j rows of a warp's strip
#define MX_GW 4                 // generic W stage: elements a thread at once
#define MX_MAX_THREADS 512
#define K8_MAX_W 24             // k-profiles
#define K8_MAX_RK 8             // k radius
#define K8_MAX_DI 17            // distinct i offsets
#define K8_MAX_TERMS 128        // V terms over all tuples

struct MxuTaps {
    int nW, ndi, ntup;
    float c[K8_MAX_W * (2 * K8_MAX_RK + 1)];  // profile w, dk: c[w*(2RK+1) + dk + RK]
    int di[K8_MAX_DI];
    int dtup[K8_MAX_DI];                       // the tuple of di index d
    int tbeg[K8_MAX_DI + 1];                   // terms of tuple t: [tbeg[t], tbeg[t+1])
    int tdj[K8_MAX_TERMS];
    int tw[K8_MAX_TERMS];
    // the generic body's: each term's offset in a W buffer (its profile's
    // plane and its row, for output row 0)
    int toff[K8_MAX_TERMS];
};

struct MxuGeom {
    int GK, GJ, BK, BJ, BI;             // table and brick shape
    int K0, K1, KCH, nchunk;            // output brick rows, chunks
    int J0, J1, PJ, njg;                // output pencils, pencil groups
    int TI, nit, nwc, OW;               // i lanes per block, i tiles, lane
                                        // chunks (warps) per strip, output
                                        // lanes per chunk
    int H, PW, D;                       // level-0 i margin, piece, lookahead
    int klo, khi, jlo, jhi, ilo, ihi;   // stencil radius per side
};

// mpi125pt folded by ir.fold_linear (bench_params): profile w's k taps are
// dk -2..2, all non-zero; tuple t's terms are dj -2..2 in order with the
// profiles tw(t, q); di -2..2 take the tuples 0, 1, 2, 1, 0.
struct LayoutMxu125 {
    static constexpr int NW = 6, RK = 2, JLO = 2, JHI = 2, NT = 3, NQ = 5;
    static constexpr int NDI = 5;
    __host__ __device__ static constexpr int tw(int t, int q) {
        constexpr int v[NT][NQ] = {{0, 1, 2, 1, 0}, {1, 3, 4, 3, 1},
                                   {2, 4, 5, 4, 2}};
        return v[t][q];
    }
    __host__ __device__ static constexpr int tdj(int, int q) {
        return q - 2;
    }
    __host__ __device__ static constexpr int di(int d) { return d - 2; }
    __host__ __device__ static constexpr int dtup(int d) {
        constexpr int v[NDI] = {0, 1, 2, 1, 0};
        return v[d];
    }
};

// the generic body: the folded form read at run time, the coefficients'
// k radius RK compiled in
template <int RK_>
struct LayoutMxuRuntime {
    static constexpr int NW = 0, RK = RK_;
};

// The runtime folded form equals layout L's: every profile's k taps
// non-zero over [-RK, RK] (rk is the coefficients' radius) and even in dk,
// the tuples' terms and the di's tuples the same.
template <class L>
static inline bool mxu_layout_matches(const MxuTaps& t, int rk, int klo,
                                      int khi, int jlo, int jhi) {
    if constexpr (L::NW == 0) {
        return false;
    } else {
        if (t.nW != L::NW || rk != L::RK || klo != L::RK || khi != L::RK
            || jlo != L::JLO || jhi != L::JHI || t.ntup != L::NT
            || t.ndi != L::NDI)
            return false;
        constexpr int NK = 2 * L::RK + 1;
        for (int q = 0; q < L::NW * NK; ++q)
            if (t.c[q] == 0.0f || t.c[q] != t.c[q - q % NK + NK - 1 - q % NK])
                return false;
        for (int d = 0; d < L::NDI; ++d)
            if (t.di[d] != L::di(d) || t.dtup[d] != L::dtup(d))
                return false;
        for (int u = 0; u < L::NT; ++u) {
            if (t.tbeg[u + 1] - t.tbeg[u] != L::NQ)
                return false;
            for (int q = 0; q < L::NQ; ++q)
                if (t.tdj[t.tbeg[u] + q] != L::tdj(u, q)
                    || t.tw[t.tbeg[u] + q] != L::tw(u, q))
                    return false;
        }
        return true;
    }
}

// j rows and lanes of a block's planes
__host__ __device__ __forceinline__ int mxu_rows(const MxuGeom& g) {
    return g.PJ * g.BJ + g.jlo + g.jhi;
}

__host__ __device__ __forceinline__ int mxu_rw(const MxuGeom& g) {
    return g.TI + 2 * g.H;
}

// One warp per (strip, lane chunk).
__host__ __device__ __forceinline__ int mxu_threads(const MxuGeom& g) {
    return 32 * g.nwc * ((g.PJ * g.BJ + MX_UR - 1) / MX_UR);
}

// Floats of the level-0 ring, then (generic body, nW > 0) two W buffers of
// nW planes, then what a thread may read past them (a strip's rows in a
// block with fewer j rows than a strip; the generic W stage's last
// elements), rounded up to even so that the 64-bit tables after them are
// aligned; the host's mxu_smem counts the same.
__host__ __device__ __forceinline__ int mxu_ring_floats(const MxuGeom& g,
                                                        int nW) {
    const int ps = mxu_rows(g) * mxu_rw(g);
    const int wjm = g.PJ * g.BJ;
    int n = (g.klo + g.khi + 1 + g.D) * ps + 2 * nW * ps;
    n += (wjm < MX_UR ? MX_UR - wjm : 0) * mxu_rw(g);
    n += nW ? (MX_GW - 1) * mxu_threads(g) : 0;
    return (n + 1) & ~1;
}

// A block's whole dynamic shared memory: the ring (and W buffers), the
// brick table, two ints per level-0 row, two buffers of the output rows'
// offsets.  nW: 0 for a compiled layout.
__host__ __device__ __forceinline__ long long mxu_smem_bytes(
    const MxuGeom& g, int nW) {
    return 4LL * mxu_ring_floats(g, nW) + 8LL * (g.KCH + 2) * (g.PJ + 2)
           + 8LL * mxu_rows(g) + 16LL * g.PJ * g.BJ;
}

template <class L>
__device__ __forceinline__ void mxu_block(const float* __restrict__ x,
                                          float* __restrict__ out,
                                          const int* __restrict__ table,
                                          const MxuGeom& g,
                                          const MxuTaps& taps, int b,
                                          float* smem) {
    constexpr bool LAYOUT = L::NW > 0;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int it = b % g.nit;
    b /= g.nit;
    const int jg = b % g.njg;
    const int ch = b / g.njg;

    const int BK = g.BK, BJ = g.BJ, BI = g.BI;
    const int klo = g.klo, khi = g.khi, jlo = g.jlo;
    const int rk = klo + khi, rj = jlo + g.jhi;
    const int kc0 = g.K0 + ch * g.KCH;
    const int kc1 = min(kc0 + g.KCH, g.K1);
    const int P0 = kc0 * BK, P1 = kc1 * BK;
    const int jp0 = g.J0 + jg * g.PJ, jp1 = min(jp0 + g.PJ, g.J1);
    const int jo0 = jp0 * BJ, WJ = (jp1 - jp0) * BJ;
    const int i0 = it * g.TI;
    const int RW = mxu_rw(g);
    const int WJM = g.PJ * BJ;
    const int NJ0 = WJ + rj;                   // level-0 rows of this block
    const int R0 = rk + 1 + g.D;
    const int PS0 = mxu_rows(g) * RW;
    const int nW = LAYOUT ? 0 : taps.nW;
    const long long brick = (long long)BK * BJ * BI;

    // the brick table, per level-0 row its pencil and in-brick offset, the
    // output rows' offsets (pencil_stream.cuh's layout, one subdomain)
    const int NJBM = g.PJ + 2;
    long long* bt = (long long*)(smem + mxu_ring_floats(g, nW));
    int* rowinfo = (int*)(bt + (g.KCH + 2) * NJBM);
    long long* rowofs = (long long*)(rowinfo + 2 * mxu_rows(g));
    const int kbf = floor_div(P0 - klo, BK);
    const int NKB = floor_div(P1 + khi - 1, BK) - kbf + 1;
    const int jbf = floor_div(jo0 - jlo, BJ);
    const int NJB = floor_div(jo0 + WJ + g.jhi - 1, BJ) - jbf + 1;
    for (int e = tid; e < NKB * NJBM; e += nthr) {
        const int a = e / NJBM, c = e - a * NJBM;
        if (c < NJB)
            bt[e] = (long long)table[clamp_int(kbf + a, 0, g.GK - 1) * g.GJ
                                     + clamp_int(jbf + c, 0, g.GJ - 1)]
                    * brick;
    }
    for (int r = tid; r < NJ0; r += nthr) {
        const int j = jo0 - jlo + r;
        const int jb = floor_div(j, BJ);
        rowinfo[2 * r] = jb - jbf;
        rowinfo[2 * r + 1] = (j - jb * BJ) * BI;
    }
    __syncthreads();

    // level-0 plane q into its ring slot, in PW-float pieces, one group
    const int PW = g.PW;
    const int NP = RW / PW;
    const int ibase = i0 - g.H;
    const PlaneWalk w0(tid, nthr, NP);
    constexpr int MX_PIECES = 3;
    const int npc = (NJ0 * NP - tid + nthr - 1) / nthr;
    int pcb[MX_PIECES], pco[MX_PIECES], pcs[MX_PIECES];
    {
        PlaneWalk w = w0;
#pragma unroll
        for (int p = 0; p < MX_PIECES; ++p) {
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
    const int q00 = P0 - klo;
    const float inv0 = 1.0f / R0, invBK = 1.0f / BK;
    auto brick_row = [&](int q) {      // the brick row of plane q, - kbf
        return div_by(q - kbf * BK, invBK);
    };
    auto slot = [&](int q) {           // plane q's ring slot
        return smem + mod_by(q - q00, R0, inv0) * PS0;
    };
    auto issue = [&](int q) {
        const int kr = brick_row(q);
        const long long* btrow = bt + kr * NJBM;
        const long long kofs = (long long)(q - (kbf + kr) * BK) * BJ * BI;
        float* dst = slot(q);
        if (npc <= MX_PIECES) {
#pragma unroll
            for (int p = 0; p < MX_PIECES; ++p) {
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
        for (int e = tid; e < NJ0 * NP; e += nthr) {
            int ii = ibase + w.c * PW;
            while (ii < 0) ii += BI;
            while (ii >= BI) ii -= BI;
            const float* src = x + btrow[rowinfo[2 * w.r]] + kofs
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

    // this warp's strip (first j row r0) and lane chunk: lane l holds tile
    // column wc*OW - ilo + l, ring column cl; it stores lanes [ilo, 32 -
    // ihi) that fall inside the tile and the brick row
    const int lane = tid & 31, warp = tid >> 5;
    const int wc = warp % g.nwc;
    const int r0 = min(MX_UR * (warp / g.nwc), max(WJ - MX_UR, 0));
    const int cl = g.H + wc * g.OW - g.ilo + lane;
    const int oi = wc * g.OW - g.ilo + lane;        // output lane - i0
    const bool lane_out = lane >= g.ilo && lane < 32 - g.ihi && oi < g.TI
                          && i0 + oi < BI;
    // a chunk wholly past the brick row (the last i tile) skips its work
    const bool warp_live = i0 + wc * g.OW < BI;
    float* wbuf = smem + R0 * PS0;              // generic: W of two planes

    const int n0 = (P1 - P0) + rk;              // level-0 planes
    const int lag = LAYOUT ? 0 : 1;             // generic: W one step ahead
    const int nsteps = n0 + lag;
    for (int d = 0; d < g.D; ++d) {
        if (d < n0)
            issue(q00 + d);
        else
            bt_cp_commit();
    }
    for (int s = 0; s < nsteps; ++s) {
        // the plane whose outputs this step stores
        const int pC = q00 + s - lag - khi;
        long long* ro = rowofs + (s & 1) * WJM;
        if (pC >= P0 && pC < P1) {
            const int kr = brick_row(pC);
            const long long* btrow = bt + kr * NJBM;
            const long long kofs = (long long)(pC - (kbf + kr) * BK) * BJ * BI
                                   + i0;
            for (int r = tid; r < WJ; r += nthr) {
                const int r0_ = r + jlo;           // its level-0 row
                ro[r] = btrow[rowinfo[2 * r0_]] + kofs + rowinfo[2 * r0_ + 1];
            }
        }
        bt_cp_wait(g.D - 1);
        __syncthreads();
        if (s + g.D < n0)
            issue(q00 + s + g.D);
        else
            bt_cp_commit();

        if constexpr (LAYOUT) {
            // W and V of plane pC in registers, then the i stage
            if (pC >= P0 && pC < P1 && warp_live) {
                constexpr int NK = 2 * L::RK + 1;
                constexpr int NR = MX_UR + L::JLO + L::JHI;
                const float* pl[NK];
#pragma unroll
                for (int d = 0; d < NK; ++d)
                    pl[d] = slot(pC - L::RK + d) + r0 * RW + cl;
                float V[L::NT][MX_UR];
#pragma unroll
                for (int jp = 0; jp < NR; ++jp) {
                    float v[NK];
#pragma unroll
                    for (int d = 0; d < NK; ++d) v[d] = pl[d][jp * RW];
                    // every profile is even in dk (mxu_layout_matches): the
                    // planes at -dk and +dk are summed once for all of them
                    float e[L::RK + 1];
                    e[0] = v[L::RK];
#pragma unroll
                    for (int r = 1; r <= L::RK; ++r)
                        e[r] = v[L::RK - r] + v[L::RK + r];
                    float W[L::NW];
#pragma unroll
                    for (int w = 0; w < L::NW; ++w) {
                        float a = taps.c[w * NK + L::RK] * e[0];
#pragma unroll
                        for (int r = 1; r <= L::RK; ++r)
                            a = fmaf(taps.c[w * NK + L::RK + r], e[r], a);
                        W[w] = a;
                    }
                    // level-0 row jp is term dj of output row jp - jlo - dj;
                    // a V sum starts at its first term (q = 0, row u)
#pragma unroll
                    for (int t = 0; t < L::NT; ++t)
#pragma unroll
                        for (int q = 0; q < L::NQ; ++q) {
                            const int u = jp - L::JLO - L::tdj(t, q);
                            if (u >= 0 && u < MX_UR) {
                                if (q == 0)
                                    V[t][u] = W[L::tw(t, q)];
                                else
                                    V[t][u] += W[L::tw(t, q)];
                            }
                        }
                }
#pragma unroll
                for (int u = 0; u < MX_UR; ++u) {
                    float acc;
#pragma unroll
                    for (int d = 0; d < L::NDI; ++d) {
                        const float vt = V[L::dtup(d)][u];
                        const float s = L::di(d) == 0
                            ? vt : __shfl_sync(0xffffffffu, vt,
                                               lane + L::di(d));
                        acc = d == 0 ? s : acc + s;
                    }
                    if (lane_out && r0 + u < WJ) out[ro[r0 + u] + oi] = acc;
                }
            }
        } else {
            // the W stage of plane pA, one step ahead: every profile at
            // every (row, lane) of the plane, into W buffer (pA - P0) & 1,
            // each profile over its non-zero k taps only
            const int pA = q00 + s - khi;
            if (pA >= P0 && pA < P1) {
                float* wd = wbuf + ((pA - P0) & 1) * nW * PS0;
                // the planes of the coefficients' dk in [-RK, RK] (those
                // past the stencil's reach have zero coefficients only:
                // they read plane pA)
                constexpr int NK = 2 * L::RK + 1;
                const float* pl[NK];
#pragma unroll
                for (int d = 0; d < NK; ++d) {
                    const int dk = d - L::RK;
                    pl[d] = slot(dk < -klo || dk > khi ? pA : pA + dk);
                }
                // MX_GW elements a thread at once (independent chains); an
                // element past the plane reads the next one and stores
                // nothing
                for (int e0 = tid; e0 < NJ0 * RW; e0 += MX_GW * nthr) {
                    float v[MX_GW][NK];
#pragma unroll
                    for (int u = 0; u < MX_GW; ++u)
#pragma unroll
                        for (int d = 0; d < NK; ++d)
                            v[u][d] = pl[d][e0 + u * nthr];
                    for (int w = 0; w < nW; ++w) {
                        const float* cw = taps.c + w * NK;
                        float a[MX_GW];
#pragma unroll
                        for (int u = 0; u < MX_GW; ++u) a[u] = 0.0f;
#pragma unroll
                        for (int d = 0; d < NK; ++d) {
                            const float c = cw[d];
                            if (c != 0.0f) {
#pragma unroll
                                for (int u = 0; u < MX_GW; ++u)
                                    a[u] = fmaf(c, v[u][d], a[u]);
                            }
                        }
#pragma unroll
                        for (int u = 0; u < MX_GW; ++u)
                            if (e0 + u * nthr < NJ0 * RW)
                                wd[w * PS0 + e0 + u * nthr] = a[u];
                    }
                }
            }
            // V and the i stage of plane pC from W buffer (pC - P0) & 1,
            // the strip's rows at once, the terms read at run time
            if (pC >= P0 && pC < P1 && warp_live) {
                const float* ws = wbuf + ((pC - P0) & 1) * nW * PS0 + cl
                                  + r0 * RW;
                float acc[MX_UR];
#pragma unroll
                for (int u = 0; u < MX_UR; ++u) acc[u] = 0.0f;
                for (int d = 0; d < taps.ndi; ++d) {
                    const int t = taps.dtup[d];
                    float vs[MX_UR];
#pragma unroll
                    for (int u = 0; u < MX_UR; ++u) vs[u] = 0.0f;
                    for (int q = taps.tbeg[t]; q < taps.tbeg[t + 1]; ++q) {
                        const float* wr = ws + taps.toff[q];
#pragma unroll
                        for (int u = 0; u < MX_UR; ++u) vs[u] += wr[u * RW];
                    }
                    const int src = lane + taps.di[d];
#pragma unroll
                    for (int u = 0; u < MX_UR; ++u)
                        acc[u] += __shfl_sync(0xffffffffu, vs[u], src);
                }
#pragma unroll
                for (int u = 0; u < MX_UR; ++u)
                    if (lane_out && r0 + u < WJ) out[ro[r0 + u] + oi] = acc[u];
            }
        }
    }
    bt_cp_wait(0);
    __syncthreads();
}
