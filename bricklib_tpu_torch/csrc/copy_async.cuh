// One float from device memory to shared memory without a register
// (cp.async, Ampere and later): a thread issues all its copies, then waits
// once with bt_copy_wait.  The host pass of a C++ compiler sees a plain
// copy.  Included by the kernel that stages its tiles this way (K7).

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ void bt_copy_async(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void bt_copy_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}
