// K11: the PUT exchange fused into a fuse=1 pencil sweep, written by hand
// for Hopper (sm_90a).
//
// Replaces the TPU kernel bricklib_tpu/codegen/fused_exchange.py:
// pallas_pencil_sweep_fusedx (3-D pencil layout, GI == 1, f32, one linear
// input, fuse == 1).  That kernel starts one remote DMA per PUT message at
// its first grid step, streams the interior while they fly, waits on each
// ghost region's receive once, at its first reader, and updates the input's
// ghosts in place (an aliased second output).  Its result equals the PUT
// exchange followed by the ghost-inclusive sweep, bit for bit.
//
// What it computes.  One launch per card and step, for every rank the card
// holds (K1's batch: rank slot s adds s * stride to every brick id).  It
// (1) copies every PUT row the card's ranks send, each from a skin (owned)
// run of the sending rank into a ghost run of the receiving rank, which may
// lie on another card, so the input storage's ghosts are updated in place;
// and (2) runs the sweep of K1 at F = 1 into a fresh output: its blocks are
// those of the stream plan K1 itself runs for the batched ghost-inclusive
// sweep of the card's ranks (SweepPlan.stream() in codegen/pencil_kernel.py),
// and each runs K1's block body (stream_block of pencil_stream.cuh, with
// the same tap layout), so each output is the same chain of FMAs as in K1.
// Copy sources are never copy destinations (the host checks it,
// check_copies), so the result is that of the copies first and the sweep
// after.
//
// How the copies and the sweep are ordered inside one launch.  The launch
// has one block per stream block, block w running item w of the card's
// plan (the items that read no copied brick first, the TPU kernel's
// interior-first order; otherwise K1's order, which places the blocks on
// the SMs as K1 does).  The copy chunks (at most CHUNK_VECS 16-byte vectors
// of one row, codegen/fused_exchange.py) form a pool: every block first
// draws chunks from a 64-bit counter of the card and copies them until the
// pool is empty (the counter is never reset: each launch draws nchunks +
// nblocks times, so launch e, the epoch from 1, starts at (e-1) times
// that).  For each chunk the block's threads fence their stores (system
// scope when the destination is another card's), meet at a barrier, and
// one thread adds 1 to the arrival counter of (destination rank, gate
// group): the k faces low and high, and the j faces with every corner.
// Then a block that reads copied bricks (its gate bits: the union, over
// its chunk of brick rows, its pencils and its i tile, of the groups whose
// ghost bricks it reads) has one thread spin, with acquire loads, until
// each of its groups' counters reaches epoch x (chunks into that rank and
// group), and a barrier follows; then the block reads level 0 through L2
// (16-byte cp.async.cg, or __ldcg for 4-byte pieces), never a stale line.
// A block waits only once the pool is empty, when every chunk is held by a
// block that has started and waits on nothing until its copy is done, so
// the launch cannot deadlock whatever the residency.  Across cards the
// host orders the launches with CUDA events (entry: a card waits on the
// cards it writes into; exit: every card on every other), so a card never
// writes ghosts that a neighbour's previous step may still read.
//
// What bounds it on the card.  Bytes: the sweep reads and writes its bricks
// once, the copies read and write their rows once; a 7-point f32 sweep does
// 14 flops per 8 bytes.  The sweep blocks are K1's (k streamed through the
// block, the k halo loaded once per chunk), so K11 should take about K1's
// time plus the copies (at the weak mesh plan every chunk of K1's plan
// holds both k ghost rows, so no block sweeps before its copies land).  A
// block has its SM alone (the plan's shared memory), so it moves a chunk
// with all 512 threads, every load issued before the first store
// (BT_FX_DEEP 16-byte vectors a thread in flight: a whole 128 KiB chunk).

#include "pencil_stream.cuh"

#define BT_FX_MAX_CARDS 8
#define BT_FX_GROUPS 3         // gate groups: k low, k high, j and corners
#define BT_FX_DEEP 16          // 16-byte vectors a copy thread has in flight

// dst[e] = src[e] for e < n, the block's threads on consecutive vectors,
// BT_FX_DEEP loads of each thread issued before its first store
static __device__ __forceinline__ void copy_chunk(uint4* dst,
                                                  const uint4* src,
                                                  long long n) {
    const long long step = (long long)BT_FX_DEEP * blockDim.x;
    for (long long e0 = threadIdx.x; e0 < n; e0 += step) {
        uint4 v[BT_FX_DEEP];
#pragma unroll
        for (int u = 0; u < BT_FX_DEEP; ++u) {
            const long long e = e0 + (long long)u * blockDim.x;
            if (e < n) v[u] = src[e];
        }
#pragma unroll
        for (int u = 0; u < BT_FX_DEEP; ++u) {
            const long long e = e0 + (long long)u * blockDim.x;
            if (e < n) dst[e] = v[u];
        }
    }
}

struct FxCards {
    uint4* storage[BT_FX_MAX_CARDS];            // each card's brick rows
    unsigned long long* arrive[BT_FX_MAX_CARDS];  // each card's counters
};

// a[i] by a run of selects: indexing a kernel parameter's array at run
// time would copy the array to local memory (a stack frame the sweep
// blocks then carry)
template <class T>
static __device__ __forceinline__ T pick(T const (&a)[BT_FX_MAX_CARDS],
                                         long long i) {
    T v = a[0];
#pragma unroll
    for (int c = 1; c < BT_FX_MAX_CARDS; ++c)
        if (c == i) v = a[c];
    return v;
}

static __device__ __forceinline__ unsigned long long load_acquire(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

// rows[6*c]: (dst card, dst offset, src card, src offset, length, counter)
// in 16-byte vectors, counter = dst slot * BT_FX_GROUPS + group;
// items[3*w]: (slot, stream block of one rank, gate bits); a rank's
// stream blocks number nper, so the block of K1's batched plan is slot *
// nper + stream block.  Block w of the launch runs item w.
template <class L>
__global__ void __launch_bounds__(BT_STREAM_THREADS, 1)
fused_exchange_kernel(FxCards cards, int card,
                      const long long* __restrict__ rows, long long nchunks,
                      const int* __restrict__ items,
                      const long long* __restrict__ expect,
                      unsigned long long* pool, long long epoch,
                      long long nitems, int nper, float* __restrict__ out,
                      const int* __restrict__ table, StreamGeom g,
                      SweepTaps taps) {
    extern __shared__ __align__(16) float smem[];
    __shared__ long long my_chunk;
    // The copies: the block takes chunks from the card's pool until it is
    // empty.  Each block makes exactly one draw past the end, so launch e
    // starts at (e-1) * (nchunks + nitems) draws.
    const unsigned long long base =
        (unsigned long long)(epoch - 1) * (nchunks + nitems);
    for (;;) {
        if (threadIdx.x == 0)
            my_chunk = (long long)(atomicAdd(pool, 1ULL) - base);
        __syncthreads();
        const long long ch = my_chunk;
        if (ch >= nchunks) break;
        const long long* r = rows + 6 * ch;
        const bool remote = r[0] != card;
        copy_chunk(pick(cards.storage, r[0]) + r[1],
                   pick(cards.storage, r[2]) + r[3], r[4]);
        if (remote)
            __threadfence_system();
        else
            __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) {
            unsigned long long* c = pick(cards.arrive, r[0]) + r[5];
            if (remote) {
                __threadfence_system();
                atomicAdd_system(c, 1ULL);
            } else {
                __threadfence();
                atomicAdd(c, 1ULL);
            }
        }
    }
    const int* it = items + 3 * blockIdx.x;
    const int slot = it[0], gates = it[2];
    if (gates) {
        if (threadIdx.x == 0) {
            for (int grp = 0; grp < BT_FX_GROUPS; ++grp) {
                if (!(gates & (1 << grp))) continue;
                const int k = slot * BT_FX_GROUPS + grp;
                const unsigned long long want =
                    (unsigned long long)epoch * expect[k];
                while (load_acquire(pick(cards.arrive, card) + k) < want)
                    __nanosleep(64);
            }
        }
        __syncthreads();
    }
    stream_block<L, true>((const float*)pick(cards.storage, card), out,
                          table, g, taps, slot * nper + it[1], smem, nullptr);
}

template <class L>
static cudaError_t launch(long long nblocks, int threads, int smem_bytes,
                          cudaStream_t stream, const FxCards& cards, int card,
                          const long long* rows, long long nchunks,
                          const int* items, const long long* expect,
                          unsigned long long* pool, long long epoch,
                          int nper, float* out, const int* table,
                          const StreamGeom& g, const SweepTaps& taps) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_exchange_kernel<L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    fused_exchange_kernel<L><<<(unsigned)nblocks, threads, smem_bytes,
                               stream>>>(
        cards, card, rows, nchunks, items, expect, pool, epoch, nblocks,
        nper, out, table, g, taps);
    return cudaGetLastError();
}

// The sweep's launch arguments are K1's (bt_pencil_sweep) at F = 1 over
// the card's ranks (batch, stride): output brick rows [K0, K1) in chunks
// of KCH, PJ pencils per block, TI lanes, level-0 margin H, piece PW, D
// planes ahead; edge_lo / edge_hi: the first / last chunk reaches below /
// above the table.  `items` lists every stream block of the plan once
// (nitems = batch x nper).
extern "C" int bt_fused_exchange(const void* const* storages,
                                 const void* const* counters, int ncards,
                                 int card, const void* rows, long long nchunks,
                                 const void* items, long long nitems,
                                 const void* expect, void* pool,
                                 long long epoch, void* out,
                                 const void* table, int GK, int GJ, int BK,
                                 int BJ, int BI, int K0, int K1, int J0,
                                 int J1, int klo, int khi, int jlo, int jhi,
                                 int ilo, int ihi, int batch, int stride,
                                 int KCH, int PJ, int TI, int H, int PW,
                                 int D, int edge_lo, int edge_hi, int ntaps,
                                 const int* tap_offsets,
                                 const float* tap_coeffs, int smem_bytes,
                                 int threads, void* stream) {
    const long long nblocks = nitems;
    const int nrows = K1 - K0, npen = J1 - J0;
    if (ncards < 1 || ncards > BT_FX_MAX_CARDS || card < 0 || card >= ncards
        || nchunks < 0 || nitems < 1 || nblocks > 0x7fffffffLL || epoch < 1
        || ntaps < 1 || ntaps > BT_MAX_TAPS || batch < 1 || nrows < 1
        || npen < 1 || KCH < 1 || PJ < 1 || TI < 1 || BI % TI
        || (PW != 1 && PW != 4) || BI % PW || TI % PW || H % PW
        || H < (ilo > ihi ? ilo : ihi) || (D != 1 && D != 2)
        || threads < 32 || threads > BT_STREAM_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const int nchunk = (nrows + KCH - 1) / KCH;
    const int njg = (npen + PJ - 1) / PJ, nit = BI / TI;
    const long long nper = (long long)nchunk * njg * nit;
    // F = 1: no intermediate level, so no stash and no skewed boundary
    StreamGeom g = {GK, GJ, BK, BJ, BI, K0, K1, KCH, nchunk, J0, J1,
                    PJ, njg, TI, nit, H, PW, D, 1, klo, khi, jlo, jhi,
                    ilo, ihi, (long long)stride, edge_lo, edge_hi, 0, 0, 0};
    const long long span = (long long)(KCH + 2) * BK + (klo + khi + 1);
    if (nitems != batch * nper || stream_smem_bytes(g) > smem_bytes
        || span >= BT_PLANE_SPAN)
        return (int)cudaErrorInvalidValue;
    FxCards cards;
    for (int c = 0; c < BT_FX_MAX_CARDS; ++c) {
        cards.storage[c] = c < ncards ? (uint4*)storages[c] : nullptr;
        cards.arrive[c] =
            c < ncards ? (unsigned long long*)counters[c] : nullptr;
    }
    const SweepTaps taps = sweep_taps(ntaps, tap_offsets, tap_coeffs);
    cudaStream_t st = (cudaStream_t)stream;
    const long long* rw = (const long long*)rows;
    const int* itm = (const int*)items;
    const long long* exp_ = (const long long*)expect;
    unsigned long long* pl = (unsigned long long*)pool;
    const int* tb = (const int*)table;
    float* o = (float*)out;
    if (layout_matches<LayoutStar7>(taps))
        return (int)launch<LayoutStar7>(nblocks, threads, smem_bytes, st,
                                        cards, card, rw, nchunks, itm,
                                        exp_, pl, epoch, (int)nper, o, tb, g,
                                        taps);
    if (layout_matches<LayoutCube125>(taps))
        return (int)launch<LayoutCube125>(nblocks, threads, smem_bytes, st,
                                          cards, card, rw, nchunks, itm,
                                          exp_, pl, epoch, (int)nper, o, tb,
                                          g, taps);
    return (int)launch<LayoutRuntime>(nblocks, threads, smem_bytes, st, cards,
                                      card, rw, nchunks, itm, exp_, pl,
                                      epoch, (int)nper, o, tb, g, taps);
}
