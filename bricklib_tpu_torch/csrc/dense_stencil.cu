// K7: the dense padded-array stencil, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/pallas_backend.py:
// pallas_dense_stencil (3-D, f32, linear stencils of 1 to K7_MAX_FIELDS
// input arrays).
//
// What it computes.  Inputs A_f[SK, SJ, SI] (one padded array per field)
// and the output have one shape.  Output rows k in [pk, SK-pk), j in
// [pj, SJ-pj) are computed over the full padded i width:
//   out[k, j, i] = sum over taps (f, dk, dj, di) of c * A_f[k+dk, j+dj,
//                  (i+di) mod SI]
// i read circularly over the whole padded row, as the TPU kernel's roll at
// full row width does.  The k and j pad rows of the output are zero.  Each
// output's sum is the chain acc = 0; acc = fmaf(c[t], x[t], acc) in tap
// order (the host's folded order), whatever the body or the footprint.
//
// What bounds it on the card.  Device-memory bytes: a 7-point sweep does
// 14 flops per 8 bytes moved.  One 147-row slab of the out-of-core path at
// 1024^3 (149 x 1040 x 1152 floats in and out) must move 1.42 GB, 0.42 ms
// at 3.35 TB/s.
//
// What the design does about it.  A block owns a column of the output:
// a chunk of KCH output rows in k, TJ rows in j and TI lanes in i, and
// walks its chunk in increasing k.  Input planes pass through a ring of
// klo + khi + 1 + D planes per field in shared memory, each plane (TJ +
// jlo + jhi) rows of TI + 2H floats (column H is lane i0), loaded once
// per chunk with cp.async in PW-float pieces (16 bytes where the inputs
// allow) D planes ahead of the plane being computed; one barrier a plane.
// So the k halo is loaded once per chunk, not once per output plane.  The
// i wrap costs nothing in the loop: a thread's pieces are the same in
// every plane, their offsets in the plane (wrapped modulo SI where the
// block is an edge tile of its row; SI and H are multiples of PW, so a
// piece never straddles the wrap) computed once per block.  Threads take
// fixed items with no division in the loop: a warp computes BT_UR = 4
// rows of 32 consecutive lanes at once, so every warp access of shared and
// device memory is one contiguous run.  Under a tap layout compiled in
// (tap_layouts.cuh: the 7-point star of s7pt and mpi7pt, in their folded
// order) every tap's offset is a compile-time constant and a value that
// several taps and rows read is one shared-memory load kept in a register
// (the star's 7 taps over 4 rows read 22 values, not 28); any other tap
// list (other offsets, other orders, several fields) takes the generic
// body, which streams the same way and reads each tap's offsets at run
// time.  Blocks of the first and last chunk and j group also write the
// zero pad rows of their i tile, so the launch writes the whole array.
// The blocks take i fastest, then j, then the chunks, so the blocks in
// flight share their planes' neighbours through L2.

#include "pencil_stream.cuh"

#define K7_MAX_FIELDS 8
#define K7_MAX_TAPS 128
#define K7_PIECES 6             // pieces of a plane a thread keeps offsets of

struct K7Ptrs {
    const float* in[K7_MAX_FIELDS];
};

struct K7Taps {
    int n;
    int f[K7_MAX_TAPS];
    int dk[K7_MAX_TAPS];
    int dj[K7_MAX_TAPS];
    int di[K7_MAX_TAPS];
    float c[K7_MAX_TAPS];
};

struct K7Geom {
    int SK, SJ, SI;             // padded shape
    int pk, pj;                 // pads of k and j: rows computed in between
    int klo, khi, jlo, jhi;     // reach of the taps per side in k and j
    int nf;                     // input fields
    int KCH, nchunk;            // output k rows per chunk, chunks
    int TJ, njg;                // output j rows per block, j groups
    int TI, nit;                // i lanes per block, i tiles
    int H, PW, D;               // i margin, piece floats, planes ahead
};

// Floats of one plane slot, and of the whole ring (every field's).
__host__ __device__ __forceinline__ int k7_slot_floats(const K7Geom& g) {
    return (g.TJ + g.jlo + g.jhi) * (g.TI + 2 * g.H);
}

__host__ __device__ __forceinline__ long long k7_smem_bytes(
    const K7Geom& g) {
    return 4LL * g.nf * (g.klo + g.khi + 1 + g.D) * k7_slot_floats(g);
}

// L: the tap layout (tap_layouts.cuh), LayoutRuntime for the generic body.
template <class L>
__global__ void __launch_bounds__(BT_STREAM_THREADS)
dense_stencil_kernel(K7Ptrs p, float* __restrict__ out, K7Geom g,
                     K7Taps t) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x, nthr = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
    int b = blockIdx.x;
    const int it = b % g.nit;
    b /= g.nit;
    const int jg = b % g.njg;
    const int ch = b / g.njg;
    const int kc0 = g.pk + ch * g.KCH;
    const int kc1 = min(kc0 + g.KCH, g.SK - g.pk);
    const int j0 = g.pj + jg * g.TJ;
    const int WJ = min(g.TJ, g.SJ - g.pj - j0);
    const int i0 = it * g.TI;
    const int rk = g.klo + g.khi;
    const int RW = g.TI + 2 * g.H;
    const int NJ0 = WJ + g.jlo + g.jhi;
    const int PS = k7_slot_floats(g);
    const int R0 = rk + 1 + g.D;
    const long long plane = (long long)g.SJ * g.SI;

    // the pad rows of this block's i tile: zeros
    {
        const int kz0 = ch == 0 ? 0 : kc0;
        const int kz1 = ch == g.nchunk - 1 ? g.SK : kc1;
        const int jz0 = jg == 0 ? 0 : j0;
        const int jz1 = jg == g.njg - 1 ? g.SJ : j0 + WJ;
        if (kz0 < kc0 || kz1 > kc1 || jz0 < j0 || jz1 > j0 + WJ) {
            const int nj = jz1 - jz0, nrow = (kz1 - kz0) * nj;
            for (int r = warp; r < nrow; r += nwarp) {
                const int k = kz0 + r / nj, j = jz0 + r % nj;
                if (k >= kc0 && k < kc1 && j >= j0 && j < j0 + WJ)
                    continue;
                float* o = out + k * plane + (long long)j * g.SI + i0;
                for (int v = lane; v < g.TI; v += 32)
                    o[v] = 0.0f;
            }
        }
    }

    // this thread's pieces of every plane: offset in the input plane (the
    // i wrap applied) and in the ring slot
    const int PW = g.PW;
    const int NP = RW / PW;
    const int ibase = i0 - g.H;
    const int rbase = j0 - g.jlo;
    const PlaneWalk w0(tid, nthr, NP);
    const int npc = (NJ0 * NP - tid + nthr - 1) / nthr;
    int pso[K7_PIECES], pss[K7_PIECES];
    {
        PlaneWalk w = w0;
#pragma unroll
        for (int q = 0; q < K7_PIECES; ++q) {
            const int r = q < npc ? w.r : 0, c = q < npc ? w.c : 0;
            int ii = ibase + c * PW;
            if (ii < 0) ii += g.SI;
            if (ii >= g.SI) ii -= g.SI;
            pso[q] = (rbase + r) * g.SI + ii;
            pss[q] = r * RW + c * PW;
            w.next();
        }
    }
    // level-0 plane q of every field into ring slot sl, one group
    auto issue = [&](int q, int sl) {
        for (int f = 0; f < g.nf; ++f) {
            // one field under a layout: no run-time index into p.in (a
            // local-memory copy of the parameter)
            const float* src = (L::N > 0 ? p.in[0] : p.in[f]) + q * plane;
            float* dst = smem + (f * R0 + sl) * PS;
            if (npc <= K7_PIECES) {
#pragma unroll
                for (int u = 0; u < K7_PIECES; ++u) {
                    if (u >= npc) break;
                    if (PW == 4)
                        bt_cp_async16(dst + pss[u], src + pso[u]);
                    else
                        bt_cp_async4(dst + pss[u], src + pso[u]);
                }
                continue;
            }
            PlaneWalk w = w0;
            for (int e = tid; e < NJ0 * NP; e += nthr) {
                int ii = ibase + w.c * PW;
                if (ii < 0) ii += g.SI;
                if (ii >= g.SI) ii -= g.SI;
                const float* s = src + (rbase + w.r) * g.SI + ii;
                float* d = dst + w.r * RW + w.c * PW;
                if (PW == 4)
                    bt_cp_async16(d, s);
                else
                    bt_cp_async4(d, s);
                w.next();
            }
        }
        bt_cp_commit();
    };

    // the walk over a plane's items (quad of BT_UR rows, 32 lanes), warp w
    // taking items w, w + nwarp, ...
    const int cpr = g.TI >> 5;
    const int nitems = (WJ / BT_UR) * cpr;
    const PlaneWalk wf(warp, nwarp, cpr);

    // one plane per step: at step s plane q00 + s has arrived, in ring slot
    // cs, and output plane q00 + s - khi (needing the planes up to it) is
    // computed once s >= klo + khi
    const int q00 = kc0 - g.klo;
    const int n0 = (kc1 - kc0) + rk;
    int ls = 0;                 // the slot of the next plane issued
    for (int d = 0; d < g.D; ++d) {
        if (d < n0) {
            issue(q00 + d, ls);
            if (++ls == R0) ls = 0;
        } else {
            bt_cp_commit();
        }
    }
    int cs = 0;
    for (int s = 0; s < n0; ++s) {
        bt_cp_wait(g.D - 1);
        __syncthreads();
        if (s + g.D < n0) {
            issue(q00 + s + g.D, ls);
            if (++ls == R0) ls = 0;
        } else {
            bt_cp_commit();
        }
        if (s >= rk) {
            const long long obase =
                (q00 + s - g.khi) * plane + (long long)j0 * g.SI + i0;
            PlaneWalk w = wf;
            for (int itm = warp; itm < nitems; itm += nwarp) {
                const int r0 = BT_UR * w.r;
                const int col = 32 * w.c + lane;
                // row r0 of the outputs is level-0 row r0 + jlo
                const int e = r0 * RW + g.H + col;
                float acc[BT_UR];
#pragma unroll
                for (int u = 0; u < BT_UR; ++u) acc[u] = 0.0f;
                if constexpr (L::N > 0) {
                    // one field; the layout's reach is R on every side
                    const float* pl[2 * L::R + 1];
#pragma unroll
                    for (int d = 0; d <= 2 * L::R; ++d) {
                        int sl = cs - 2 * L::R + d;
                        if (sl < 0) sl += R0;
                        pl[d] = smem + sl * PS + e;
                    }
#pragma unroll
                    for (int q = 0; q < L::N; ++q) {
                        const float ct = t.c[q];
#pragma unroll
                        for (int u = 0; u < BT_UR; ++u)
                            acc[u] = fmaf(
                                ct, pl[L::dk(q) + L::R]
                                      [(L::R + L::dj(q) + u) * RW + L::di(q)],
                                acc[u]);
                    }
                } else {
                    for (int q = 0; q < t.n; ++q) {
                        int sl = cs - g.khi + t.dk[q];
                        if (sl < 0) sl += R0;
                        const float* x = smem + (t.f[q] * R0 + sl) * PS
                                         + (g.jlo + t.dj[q]) * RW + t.di[q]
                                         + e;
                        const float ct = t.c[q];
#pragma unroll
                        for (int u = 0; u < BT_UR; ++u)
                            acc[u] = fmaf(ct, x[RW * u], acc[u]);
                    }
                }
                float* o = out + obase + (long long)r0 * g.SI + col;
#pragma unroll
                for (int u = 0; u < BT_UR; ++u) o[(long long)u * g.SI] = acc[u];
                w.next();
            }
        }
        if (++cs == R0) cs = 0;
    }
    // drain the (empty) trailing groups before the block exits
    bt_cp_wait(0);
}

// The taps equal layout L's offsets, in L's order, all of field 0, and
// reach exactly L::R on every side of k and j.
template <class L>
static bool layout_matches_dense(const K7Taps& t, const K7Geom& g) {
    if (t.n != L::N || g.nf != 1 || g.klo != L::R || g.khi != L::R
        || g.jlo != L::R || g.jhi != L::R)
        return false;
    for (int q = 0; q < L::N; ++q)
        if (t.f[q] != 0 || t.dk[q] != L::dk(q) || t.dj[q] != L::dj(q)
            || t.di[q] != L::di(q))
            return false;
    return true;
}

template <class L>
static cudaError_t launch(long long nblocks, int threads, int smem_bytes,
                          cudaStream_t stream, const K7Ptrs& p, float* out,
                          const K7Geom& g, const K7Taps& t) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_stencil_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    dense_stencil_kernel<L><<<(unsigned)nblocks, threads, smem_bytes,
                              stream>>>(p, out, g, t);
    return cudaGetLastError();
}

// ins: nf device pointers.  f, dk, dj, di, c: ntaps each, in the host's
// folded order.  Output k rows [pk, SK-pk) stream in chunks of KCH, TJ
// j rows and TI i lanes a block, level 0 with an i margin of H floats per
// side in PW-float pieces, D planes ahead.
extern "C" int bt_dense_stencil(const long long* ins, void* out, int nf,
                                int SK, int SJ, int SI, int pk, int pj,
                                int klo, int khi, int jlo, int jhi, int ilo,
                                int ihi, int KCH, int TJ, int TI, int H,
                                int PW, int D, int ntaps, const int* f,
                                const int* dk, const int* dj, const int* di,
                                const float* c, int smem_bytes, int threads,
                                void* stream) {
    const int NK = SK - 2 * pk, NJ = SJ - 2 * pj;
    if (nf < 1 || nf > K7_MAX_FIELDS || ntaps < 1 || ntaps > K7_MAX_TAPS
        || NK < 1 || NJ < BT_UR || NJ % BT_UR || SI < 1 || pk < klo
        || pk < khi || pj < jlo || pj < jhi || KCH < 1 || TJ < BT_UR
        || TJ % BT_UR || TI < 32 || TI % 32 || SI % TI
        || (PW != 1 && PW != 4) || SI % PW || H % PW
        || H < (ilo > ihi ? ilo : ihi) || (D != 1 && D != 2)
        || threads < 32 || threads > BT_STREAM_THREADS || threads % 32
        || (long long)SK * SJ * SI >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    K7Ptrs p = {};
    for (int q = 0; q < nf; ++q) p.in[q] = (const float*)ins[q];
    K7Taps t = {};
    t.n = ntaps;
    for (int q = 0; q < ntaps; ++q) {
        if (f[q] < 0 || f[q] >= nf || dk[q] < -klo || dk[q] > khi
            || dj[q] < -jlo || dj[q] > jhi || di[q] < -ilo || di[q] > ihi)
            return (int)cudaErrorInvalidValue;
        t.f[q] = f[q];
        t.dk[q] = dk[q];
        t.dj[q] = dj[q];
        t.di[q] = di[q];
        t.c[q] = c[q];
    }
    const int nchunk = (NK + KCH - 1) / KCH, njg = (NJ + TJ - 1) / TJ;
    const K7Geom g = {SK, SJ, SI, pk, pj, klo, khi, jlo, jhi, nf, KCH,
                      nchunk, TJ, njg, TI, SI / TI, H, PW, D};
    const long long nblocks = (long long)nchunk * njg * g.nit;
    if (nblocks > 0x7fffffffLL || k7_smem_bytes(g) > smem_bytes)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (layout_matches_dense<LayoutStar7>(t, g))
        return (int)launch<LayoutStar7>(nblocks, threads, smem_bytes, st, p,
                                        (float*)out, g, t);
    return (int)launch<LayoutRuntime>(nblocks, threads, smem_bytes, st, p,
                                      (float*)out, g, t);
}
