// K2 and K3: brick-row copies, written by hand for Hopper (sm_90a).
//
// K2 copy_intervals replaces the TPU kernel
// bricklib_tpu/comm/exchange.py:_local_copy_kernel: one stage of the
// in-place ghost <- skin (or ghost <- ghost, for corners) copies of the
// multi-stage SHIFT exchange on a one-device mesh.  Each interval moves a
// run of whole brick rows inside one storage buffer.  One launch is one
// stage; launches on one stream run in order, which is the barrier between
// stages that the TPU kernel's DMA waits gave (stage 2 forwards corners out
// of ghosts written in stage 1).  The host guarantees that within a stage
// no destination overlaps another destination or any source.
//
// K3 copy_storage replaces the TPU kernel
// bricklib_tpu/bench/roofline.py:make_dma_copy: a whole-storage copy, the
// copy roofline that the step's rate is judged against.
//
// What bounds them on the card.  Device-memory bytes only: each byte is
// read once and written once and nothing is computed.
//
// What the design does about it.  Every thread moves 16-byte vectors
// (uint4), neighbouring threads on neighbouring addresses, several loads
// in flight per thread before their stores, so that the memory system sees
// full, coalesced transactions.  Rows are 16-byte multiples (the wrapper
// checks), so no tail handling inside a row is needed.

#include <cuda_runtime.h>

#define BT_COPY_THREADS 256
#define BT_COPY_UNROLL 4

// ivs[3*b] = (dst, src, len) of interval b, in uint4 units
__global__ void copy_intervals_kernel(uint4* base, const long long* ivs) {
    const long long d0 = ivs[3 * blockIdx.y];
    const long long s0 = ivs[3 * blockIdx.y + 1];
    const long long n = ivs[3 * blockIdx.y + 2];
    const long long step = (long long)gridDim.x * blockDim.x * BT_COPY_UNROLL;
    for (long long e0 = (long long)blockIdx.x * blockDim.x * BT_COPY_UNROLL
                        + threadIdx.x;
         e0 < n; e0 += step) {
        uint4 v[BT_COPY_UNROLL];
#pragma unroll
        for (int u = 0; u < BT_COPY_UNROLL; ++u) {
            const long long e = e0 + (long long)u * blockDim.x;
            if (e < n) v[u] = base[s0 + e];
        }
#pragma unroll
        for (int u = 0; u < BT_COPY_UNROLL; ++u) {
            const long long e = e0 + (long long)u * blockDim.x;
            if (e < n) base[d0 + e] = v[u];
        }
    }
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

extern "C" int bt_copy_intervals(void* base, const void* ivs, int nivs,
                                 long long max_len, void* stream) {
    if (nivs < 1 || nivs > 65535 || max_len < 1)
        return (int)cudaErrorInvalidValue;
    const long long per_block = (long long)BT_COPY_THREADS * BT_COPY_UNROLL;
    long long bx = (max_len + per_block - 1) / per_block;
    if (bx > 1024) bx = 1024;
    dim3 grid((unsigned)bx, (unsigned)nivs);
    copy_intervals_kernel<<<grid, BT_COPY_THREADS, 0, (cudaStream_t)stream>>>(
        (uint4*)base, (const long long*)ivs);
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
