// K9 and K10: the remote-copy exchanges, written by hand for Hopper (sm_90a).
//
// K9 remote_copy replaces the TPU kernel
// bricklib_tpu/comm/exchange.py:exchange_shift_remote: the multi-stage SHIFT
// exchange as copies straight from each rank's skin (or forwarded ghosts)
// into its neighbour's ghost storage, with no staging.  K10
// strong_remote_copy replaces bricklib_tpu/comm/strong.py:
// exchange_strong_remote, the strong-scaling exchange in the same form: the
// links between subdomains of one rank and the face subdomains' rows pushed
// into the neighbouring rank's ghost rows.  Both do the same thing on the
// card, so both run the row copy of copy_rows.cuh; each keeps its own entry
// point, so that its launches are its own.
//
// One launch is one stage on one card: every copy that card issues in that
// stage, for all the ranks it holds.  A row is (destination storage,
// offset, source storage, offset, length), offsets and length in 16-byte
// vectors, 64-bit (a 512^3 rank is 571 MB).  The storages are the mesh's
// per-card tensors; their base addresses come by value with the launch,
// so a table outlives the tensors it was built for (every step's sweeps
// return new storage) and a step copies nothing from the host.  A
// destination on another card is written through its unified address,
// after cudaDeviceEnablePeerAccess (bt_enable_peer_access below).  The
// TPU kernel's stage barrier (all DMAs of stage s complete before stage s+1
// issues) is the end of the launch on the card's stream, and across cards
// the CUDA events the host records between stages.  The host guarantees
// that within a stage no destination overlaps another destination or any
// source, of any rank, so the blocks of a launch may run in any order.
//
// What bounds them on the card.  Bytes: each byte is read once and written
// once; on one card both are device-memory traffic (3.35 TB/s on the H100),
// across cards the remote writes cross NVLink (450 GB/s each way).
//
// What the design does about it.  The row copy is coalesced 16-byte
// vectors with several loads in flight per thread; a destination on a peer
// card gets whole 16-byte stores, which NVLink carries as full packets.
// Pushing (remote writes) rather than pulling keeps the reads local.

#include "copy_rows.cuh"

#define BT_MAX_STORAGES 8

struct Storages {
    uint4* p[BT_MAX_STORAGES];
};

// rows[5*b] = (dst storage, dst offset, src storage, src offset, len)
static __device__ __forceinline__ void copy_row(const Storages& st,
                                                const long long* rows) {
    const long long* r = rows + 5 * blockIdx.y;
    copy_run(st.p[r[0]] + r[1], st.p[r[2]] + r[3], r[4]);
}

__global__ void remote_copy_kernel(Storages st, const long long* rows) {
    copy_row(st, rows);
}

__global__ void strong_remote_copy_kernel(Storages st,
                                          const long long* rows) {
    copy_row(st, rows);
}

static int launch_rows(bool strong, const void* const* bases, int nbases,
                       const void* rows, int nrows, long long max_len,
                       void* stream) {
    if (nbases < 1 || nbases > BT_MAX_STORAGES || nrows < 1 || nrows > 65535
        || max_len < 1)
        return (int)cudaErrorInvalidValue;
    Storages st;
    for (int i = 0; i < BT_MAX_STORAGES; ++i)
        st.p[i] = i < nbases ? (uint4*)bases[i] : nullptr;
    dim3 grid((unsigned)copy_blocks(max_len), (unsigned)nrows);
    cudaStream_t s = (cudaStream_t)stream;
    if (strong)
        strong_remote_copy_kernel<<<grid, BT_COPY_THREADS, 0, s>>>(
            st, (const long long*)rows);
    else
        remote_copy_kernel<<<grid, BT_COPY_THREADS, 0, s>>>(
            st, (const long long*)rows);
    return (int)cudaGetLastError();
}

extern "C" int bt_remote_copy(const void* const* bases, int nbases,
                              const void* rows, int nrows, long long max_len,
                              void* stream) {
    return launch_rows(false, bases, nbases, rows, nrows, max_len, stream);
}

extern "C" int bt_strong_remote_copy(const void* const* bases, int nbases,
                                     const void* rows, int nrows,
                                     long long max_len, void* stream) {
    return launch_rows(true, bases, nbases, rows, nrows, max_len, stream);
}

extern "C" int bt_can_access_peer(int dev, int peer, int* ok) {
    return (int)cudaDeviceCanAccessPeer(ok, dev, peer);
}

// Let `dev` address `peer`'s memory; enabling it twice is not an error.
// The calling thread's current device is restored.
extern "C" int bt_enable_peer_access(int dev, int peer) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err != cudaSuccess) return (int)err;
    err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();
        err = cudaSuccess;
    }
    cudaError_t back = cudaSetDevice(prev);
    return (int)(err != cudaSuccess ? err : back);
}
