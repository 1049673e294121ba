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
// and (2) runs the sweep of K1 at F = 1 (sweep_block of pencil_sweep.cuh,
// the same arithmetic) into a fresh output.  Copy sources are never copy
// destinations (the host checks it, check_copies), so the result is that
// of the copies first and the sweep after.
//
// How the copies and the sweep are ordered inside one launch.  A block
// takes a ticket from a 64-bit counter of the card instead of its blockIdx,
// so tickets follow the order in which blocks start; the counter is never
// reset: launch e (epoch, from 1) takes tickets [(e-1) * nblocks, e *
// nblocks).  Tickets [0, C) copy one chunk each (at most BT_FX_CHUNK
// vectors of one row); then come the output tiles that read no copied
// brick, then those that do (the TPU kernel's interior-first order).  A
// copy block's threads fence their stores (system scope when the
// destination is another card's), meet at a barrier, and one thread adds 1
// to the arrival counter of (destination rank, gate group): the k faces
// low and high, and the j faces with every corner.  A tile that reads
// copied bricks has one thread spin, with acquire loads, until each of its
// groups' counters reaches epoch x (chunks into that rank and group); then
// the block reads level 0 through L2 (__ldcg), never a stale line.  A
// waiting block waits only on copies with lower tickets, whose blocks have
// started and wait on nothing, so the launch cannot deadlock whatever the
// residency.  Across cards the host orders the launches with CUDA events
// (entry: a card waits on the cards it writes into; exit: every card on
// every other), so a card never writes ghosts that a neighbour's previous
// step may still read.
//
// What bounds it on the card.  Bytes: the sweep reads and writes its bricks
// once, the copies read and write their rows once; a 7-point f32 sweep does
// 14 flops per 8 bytes.  This first design keeps K1's block body (bound by
// the recomputed halo and shared-memory work, PERF.md), adds one atomic per
// block for its ticket, and lets interior tiles run while the copies land.

#include "copy_rows.cuh"
#include "pencil_sweep.cuh"

#define BT_FX_MAX_CARDS 8
#define BT_FX_GROUPS 3         // gate groups: k low, k high, j and corners

struct FxCards {
    uint4* storage[BT_FX_MAX_CARDS];            // each card's brick rows
    unsigned long long* arrive[BT_FX_MAX_CARDS];  // each card's counters
};

static __device__ __forceinline__ unsigned long long load_acquire(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

// rows[6*c]: (dst card, dst offset, src card, src offset, length, counter)
// in 16-byte vectors, counter = dst slot * BT_FX_GROUPS + group;
// items[5*t]: (slot, output brick row, output pencil, i tile, gate bits)
template <int NT>
__global__ void fused_exchange_kernel(FxCards cards, int card,
                                      const long long* __restrict__ rows,
                                      long long nchunks,
                                      const int* __restrict__ items,
                                      const long long* __restrict__ expect,
                                      unsigned long long* ticket,
                                      long long epoch, long long nblocks,
                                      float* __restrict__ out,
                                      const int* __restrict__ table,
                                      SweepGeom g, SweepTaps taps) {
    extern __shared__ float smem[];
    __shared__ long long my_ticket;
    if (threadIdx.x == 0)
        my_ticket = (long long)(atomicAdd(ticket, 1ULL)
                                - (unsigned long long)(epoch - 1) * nblocks);
    __syncthreads();
    const long long t = my_ticket;
    if (t < nchunks) {
        const long long* r = rows + 6 * t;
        const bool remote = r[0] != card;
        copy_part(cards.storage[r[0]] + r[1], cards.storage[r[2]] + r[3],
                  r[4], 0, 1);
        if (remote)
            __threadfence_system();
        else
            __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) {
            unsigned long long* c = cards.arrive[r[0]] + r[5];
            if (remote) {
                __threadfence_system();
                atomicAdd_system(c, 1ULL);
            } else {
                __threadfence();
                atomicAdd(c, 1ULL);
            }
        }
        return;
    }
    const int* it = items + 5 * (t - nchunks);
    const int slot = it[0], gates = it[4];
    if (gates) {
        if (threadIdx.x == 0) {
            for (int grp = 0; grp < BT_FX_GROUPS; ++grp) {
                if (!(gates & (1 << grp))) continue;
                const int k = slot * BT_FX_GROUPS + grp;
                const unsigned long long want =
                    (unsigned long long)epoch * expect[k];
                while (load_acquire(cards.arrive[card] + k) < want)
                    __nanosleep(64);
            }
        }
        __syncthreads();
    }
    sweep_block<NT, true>((const float*)cards.storage[card], out, table, g,
                          taps, slot, it[1], it[2], it[3] * g.TI, smem);
}

template <int NT>
static cudaError_t launch(long long nblocks, int threads, int smem_bytes,
                          cudaStream_t stream, const FxCards& cards, int card,
                          const long long* rows, long long nchunks,
                          const int* items, const long long* expect,
                          unsigned long long* ticket, long long epoch,
                          float* out, const int* table, const SweepGeom& g,
                          const SweepTaps& taps) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_exchange_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    fused_exchange_kernel<NT><<<(unsigned)nblocks, threads, smem_bytes,
                                stream>>>(
        cards, card, rows, nchunks, items, expect, ticket, epoch, nblocks,
        out, table, g, taps);
    return cudaGetLastError();
}

extern "C" int bt_fused_exchange(const void* const* storages,
                                 const void* const* counters, int ncards,
                                 int card, const void* rows, long long nchunks,
                                 const void* items, long long nitems,
                                 const void* expect, void* ticket,
                                 long long epoch, void* out,
                                 const void* table, int GK, int GJ, int BK,
                                 int BJ, int BI, int klo, int khi, int jlo,
                                 int jhi, int ilo, int ihi, int TI,
                                 int stride, int ntaps,
                                 const int* tap_offsets,
                                 const float* tap_coeffs, int smem_bytes,
                                 int threads, void* stream) {
    const long long nblocks = nchunks + nitems;
    if (ncards < 1 || ncards > BT_FX_MAX_CARDS || card < 0 || card >= ncards
        || nchunks < 0 || nitems < 1 || nblocks > 0x7fffffffLL || epoch < 1
        || ntaps < 1 || ntaps > BT_MAX_TAPS || TI < 1 || BI % TI)
        return (int)cudaErrorInvalidValue;
    FxCards cards;
    for (int c = 0; c < BT_FX_MAX_CARDS; ++c) {
        cards.storage[c] = c < ncards ? (uint4*)storages[c] : nullptr;
        cards.arrive[c] =
            c < ncards ? (unsigned long long*)counters[c] : nullptr;
    }
    // F = 1; K0, J0 and KC are not read: each tile names its own row
    SweepGeom g = {GK, GJ, BK, BJ, BI, 0, 0, 1, (long long)stride,
                   1, klo, khi, jlo, jhi, ilo, ihi, TI};
    const SweepTaps taps = sweep_taps(ntaps, tap_offsets, tap_coeffs);
    cudaStream_t st = (cudaStream_t)stream;
    const long long* rw = (const long long*)rows;
    const int* itm = (const int*)items;
    const long long* exp_ = (const long long*)expect;
    unsigned long long* tk = (unsigned long long*)ticket;
    if (ntaps == 7)
        return (int)launch<7>(nblocks, threads, smem_bytes, st, cards, card,
                              rw, nchunks, itm, exp_, tk, epoch,
                              (float*)out, (const int*)table, g, taps);
    return (int)launch<0>(nblocks, threads, smem_bytes, st, cards, card, rw,
                          nchunks, itm, exp_, tk, epoch, (float*)out,
                          (const int*)table, g, taps);
}
