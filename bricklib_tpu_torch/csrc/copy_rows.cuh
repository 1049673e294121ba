// The row copy that kernels K2, K5, K9 and K10 share: one run of n
// 16-byte vectors, dst[e] = src[e], spread over the x blocks of the
// launch (the y block picks the run).  Every thread moves 16-byte vectors
// (uint4), neighbouring threads on neighbouring addresses, several loads
// in flight per thread before their stores, so that the memory system
// sees full, coalesced transactions; the destination may lie in another
// card's memory (K9, K10), reached through its unified address.
#pragma once

#include <cuda_runtime.h>

#define BT_COPY_THREADS 256
#define BT_COPY_UNROLL 4

// Part `part` of `nparts` of the run: the threads of one block take
// 16-byte vectors BT_COPY_UNROLL at a time, the parts interleaved
static __device__ __forceinline__ void copy_part(uint4* dst, const uint4* src,
                                                 long long n, long long part,
                                                 long long nparts) {
    const long long step = nparts * blockDim.x * BT_COPY_UNROLL;
    for (long long e0 = part * blockDim.x * BT_COPY_UNROLL + threadIdx.x;
         e0 < n; e0 += step) {
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
}

// The run spread over the x blocks of the launch
static __device__ __forceinline__ void copy_run(uint4* dst, const uint4* src,
                                                long long n) {
    copy_part(dst, src, n, blockIdx.x, gridDim.x);
}

// x blocks for runs of at most max_len vectors: enough to cover the
// longest run once, at most 1024
static long long copy_blocks(long long max_len) {
    const long long per_block = (long long)BT_COPY_THREADS * BT_COPY_UNROLL;
    const long long bx = (max_len + per_block - 1) / per_block;
    return bx > 1024 ? 1024 : bx;
}
