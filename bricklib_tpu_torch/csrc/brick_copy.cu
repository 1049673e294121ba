// K2, K3 and K5: brick-row copies, written by hand for Hopper (sm_90a).
//
// K2 copy_pool replaces the TPU kernel
// bricklib_tpu/comm/exchange.py:_local_copy_kernel: a group of consecutive
// stages of the in-place ghost <- skin (or ghost <- ghost, for corners)
// copies of the multi-stage SHIFT exchange (or the one stage of the PUT
// exchange's self-copies), for every rank a card holds, in ONE launch, as
// the TPU kernel runs every pending local stage in one pallas_call with a
// DMA barrier between stages.  Each copy moves whole brick rows inside one
// storage buffer.  Within a stage no destination overlaps another
// destination or any source; a later stage of a group writes no row an
// earlier one reads or writes; a later stage may read rows an earlier one
// wrote (the corners).  The host checks all three when it plans.
//
// The pool.  The host cuts every stage's copies into chunks of at most one
// brick row and lists them in stage order (comm/exchange.py, pool_plan).
// A grid of one block per SM draws chunks from a 64-bit counter of the
// plan and copies them until the pool is empty.  The counter is never
// reset: every launch of a plan draws exactly P = nchunks + nblocks
// tickets (each block one past the end), so ticket t is chunk t mod P of
// launch t / P (the epoch, from 0), and a plan's launches on one stream
// never interleave.  A row that a later stage reads has an arrival
// counter; each chunk of it (a row longer than 128 KiB comes in pieces)
// adds 1 once its part is stored and fenced.  A chunk whose source row an
// earlier stage of the group writes (its gates: one counter per such
// stage) first has one thread spin with acquire loads until each gate's
// counter reaches (epoch + 1) times the pieces of a row, then reads its
// rows through L2.
//
// Why it cannot deadlock, at any residency.  A block waits only for the
// chunk it holds, and only on rows of earlier stages, whose chunks were
// all drawn before it (stage order).  A drawn chunk is held by a block
// that is running, and a block holds one chunk at a time.  So, in drawing
// order, the earliest chunk not yet copied waits on nothing left undone:
// it is copied, and so is the next.
//
// K3 copy_storage replaces the TPU kernel
// bricklib_tpu/bench/roofline.py:make_dma_copy: a whole-storage copy, the
// copy roofline that the step's rate is judged against.
//
// K5 copy_stage replaces the TPU kernel
// bricklib_tpu/comm/strong.py:_stage_copy: one (stage, sign) of the
// strong-scaling exchange, in place on the flat [nsub * nbricks] brick rows
// of the subdomain stack.  One launch does both halves: the interval
// copies between subdomains of the stack, and the scatter of the receive
// buffer (the face rows gathered before the launch) into ghost rows.  Each
// interval names its source buffer.  The host guarantees that no
// destination overlaps another destination or any in-storage source, so
// the blocks of one launch may run in any order.
//
// What bounds them on the card.  Device-memory bytes only: each byte is
// read once and written once and nothing is computed.
//
// What the designs do about it.  K2: a block has its SM alone and moves a
// chunk with all its threads, every load (BT_POOL_DEEP 16-byte vectors a
// thread, a whole 128 KiB brick row at 512 threads) issued before the
// first store, so the SMs keep the memory system busy with one block each.
// K3 and K5: the row copy of copy_rows.cuh: 16-byte vectors, coalesced,
// several loads in flight per thread.  Rows are 16-byte multiples (the
// wrapper checks), so no tail handling inside a row is needed.

#include "copy_rows.cuh"

#define BT_POOL_THREADS 512
#define BT_POOL_DEEP 16         // 16-byte vectors a copy thread has in flight

// dst[e] = src[e] for e < n, the block's threads on consecutive vectors,
// BT_POOL_DEEP loads of each thread (through L2: the rows may have been
// written by another SM in this launch) issued before its first store
static __device__ __forceinline__ void copy_chunk(uint4* dst,
                                                  const uint4* src,
                                                  long long n) {
    const long long step = (long long)BT_POOL_DEEP * blockDim.x;
    for (long long e0 = threadIdx.x; e0 < n; e0 += step) {
        uint4 v[BT_POOL_DEEP];
#pragma unroll
        for (int u = 0; u < BT_POOL_DEEP; ++u) {
            const long long e = e0 + (long long)u * blockDim.x;
            if (e < n) v[u] = __ldcg(src + e);
        }
#pragma unroll
        for (int u = 0; u < BT_POOL_DEEP; ++u) {
            const long long e = e0 + (long long)u * blockDim.x;
            if (e < n) dst[e] = v[u];
        }
    }
}

static __device__ __forceinline__ unsigned long long load_acquire(
        const unsigned long long* p) {
#ifdef __CUDA_ARCH__
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
#else
    return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}

// chunks[6*c] = (dst, src, len, arrival counter or -1, gates begin, gates
// end) of chunk c, offsets and length in 16-byte vectors; gates[g]: an
// arrival counter, which counts `pieces` chunks a launch; state[0]: the
// ticket counter, state[1 + k]: arrival counter k.
__global__ void __launch_bounds__(BT_POOL_THREADS, 1)
copy_pool_kernel(uint4* base, const long long* __restrict__ chunks,
                 long long nchunks, const int* __restrict__ gates,
                 int pieces, unsigned long long* state) {
    extern __shared__ unsigned long long ticket[];
    const unsigned long long P = (unsigned long long)nchunks + gridDim.x;
    unsigned long long* arrive = state + 1;
    for (;;) {
        if (threadIdx.x == 0) ticket[0] = atomicAdd(state, 1ULL);
        __syncthreads();
        const unsigned long long tk = ticket[0];
        const long long ch = (long long)(tk % P);
        if (ch >= nchunks) break;
        const long long* r = chunks + 6 * ch;
        if (r[4] < r[5]) {
            if (threadIdx.x == 0) {
                const unsigned long long want =
                    (tk / P + 1) * (unsigned long long)pieces;
                for (long long g = r[4]; g < r[5]; ++g)
                    while (load_acquire(arrive + gates[g]) < want)
                        __nanosleep(32);
            }
            __syncthreads();
        }
        copy_chunk(base + r[0], base + r[1], r[2]);
        if (r[3] >= 0) __threadfence();
        // every thread is done with ticket[0] and with its stores
        __syncthreads();
        if (r[3] >= 0 && threadIdx.x == 0) {
            __threadfence();
            atomicAdd(arrive + r[3], 1ULL);
        }
    }
}

// ivs[4*b] = (dst, src, len, source) of interval b, in uint4 units; the
// source is the storage itself (0) or the receive buffer (1)
__global__ void copy_stage_kernel(uint4* base, const uint4* recv,
                                  const long long* ivs) {
    const long long* iv = ivs + 4 * blockIdx.y;
    copy_run(base + iv[0], (iv[3] ? recv : base) + iv[1], iv[2]);
}

__global__ void copy_storage_kernel(const uint4* __restrict__ src,
                                    uint4* __restrict__ dst, long long n) {
    const long long e0 = (long long)blockIdx.x * blockDim.x * BT_COPY_UNROLL
                         + threadIdx.x;
    uint4 v[BT_COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < BT_COPY_UNROLL; ++u) {
        const long long e = e0 + (long long)u * blockDim.x;
        if (e < n) v[u] = src[e];
    }
#pragma unroll
    for (int u = 0; u < BT_COPY_UNROLL; ++u) {
        const long long e = e0 + (long long)u * blockDim.x;
        if (e < n) dst[e] = v[u];
    }
}

extern "C" int bt_copy_pool(void* base, const void* chunks, long long nchunks,
                            const void* gates, int pieces, void* state,
                            int nblocks, int threads, void* stream) {
    if (nchunks < 1 || pieces < 1 || nblocks < 1 || threads < 32
        || threads > BT_POOL_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    copy_pool_kernel<<<nblocks, threads, sizeof(unsigned long long),
                       (cudaStream_t)stream>>>(
        (uint4*)base, (const long long*)chunks, nchunks, (const int*)gates,
        pieces, (unsigned long long*)state);
    return (int)cudaGetLastError();
}

extern "C" int bt_copy_stage(void* base, const void* recv, const void* ivs,
                             int nivs, long long max_len, void* stream) {
    if (nivs < 1 || nivs > 65535 || max_len < 1)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)copy_blocks(max_len), (unsigned)nivs);
    copy_stage_kernel<<<grid, BT_COPY_THREADS, 0, (cudaStream_t)stream>>>(
        (uint4*)base, (const uint4*)recv, (const long long*)ivs);
    return (int)cudaGetLastError();
}

extern "C" int bt_copy_storage(const void* src, void* dst, long long nvec,
                               void* stream) {
    if (nvec < 1) return (int)cudaErrorInvalidValue;
    const long long per_block = (long long)BT_COPY_THREADS * BT_COPY_UNROLL;
    const long long blocks = (nvec + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    copy_storage_kernel<<<(unsigned)blocks, BT_COPY_THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const uint4*)src, (uint4*)dst, nvec);
    return (int)cudaGetLastError();
}

extern "C" const char* bt_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
