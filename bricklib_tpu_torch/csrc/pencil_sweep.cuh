// The pieces the streaming sweep bodies share (pencil_stream.cuh,
// pencil_stream_4d.cuh, mxu_stream.cuh, row_stream.cuh): the tap table of
// the 3-D sweeps (SweepTaps, sweep_taps) and the integer helpers
// (floor_div, clamp_int, div_by).
#pragma once

#include <cuda_runtime.h>

#define BT_MAX_TAPS 128

struct SweepTaps {
    int n;
    int dk[BT_MAX_TAPS];
    int dj[BT_MAX_TAPS];
    int di[BT_MAX_TAPS];
    float c[BT_MAX_TAPS];
};

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
    return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// floor(e / m) for 0 <= e < 2^20, from inv = 1.0f / m
__device__ __forceinline__ int div_by(int e, float inv) {
    return (int)(((float)e + 0.5f) * inv);
}

// SweepTaps from the flat host arrays of the C entry points: offsets
// (dk, dj, di) per tap, then the coefficients
static inline SweepTaps sweep_taps(int ntaps, const int* tap_offsets,
                                   const float* tap_coeffs) {
    SweepTaps taps;
    taps.n = ntaps;
    for (int t = 0; t < ntaps; ++t) {
        taps.dk[t] = tap_offsets[3 * t];
        taps.dj[t] = tap_offsets[3 * t + 1];
        taps.di[t] = tap_offsets[3 * t + 2];
        taps.c[t] = tap_coeffs[t];
    }
    return taps;
}
