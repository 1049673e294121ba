// The tap layouts kernels K1, K4 and K12 compile in (pencil_stream.cuh,
// stream_block; pencil_stream_4d.cuh, stream4_block; pencil_stream_nd.cuh,
// stream_nd_block).
//
// A layout is the offsets (dk, dj, di) of a linear stencil's taps, (dw,
// dk, dj, di) for K4, in tap order, known at compile time.  Under a
// layout each thread computes BT_UR output rows of a column at once, and
// the compiler sees which (plane, row, lane) each tap of each row reads: a
// value that several taps and rows read is one shared-memory load, kept in
// a register.  The taps' coefficients stay kernel parameters, so one
// layout serves every stencil with those offsets (s7pt and mpi7pt share
// the star's); the entry points (bt_pencil_sweep, bt_pencil_sweep_4d)
// compare the runtime offsets with each layout and launch the body of the
// one they equal, or the generic body (the offsets read at run time, one
// load per tap and row) for any other tap list.  The orders are the
// corpus's (codegen/taps.py merges taps in first-seen order), which each
// output's sum keeps.
#pragma once

#include "pencil_sweep.cuh"

// the 7-point star: centre, +i, -i, +j, -j, +k, -k
struct LayoutStar7 {
    static constexpr int N = 7, R = 1;
    __host__ __device__ static constexpr int dk(int t) {
        constexpr int v[N] = {
            0, 0, 0, 0, 0, 1, -1};
        return v[t];
    }
    __host__ __device__ static constexpr int dj(int t) {
        constexpr int v[N] = {
            0, 0, 0, 1, -1, 0, 0};
        return v[t];
    }
    __host__ __device__ static constexpr int di(int t) {
        constexpr int v[N] = {
            0, 1, -1, 0, 0, 0, 0};
        return v[t];
    }
};

// the 125-point cube, radius 2, in mpi125pt's order (by symmetry class)
struct LayoutCube125 {
    static constexpr int N = 125, R = 2;
    __host__ __device__ static constexpr int dk(int t) {
        constexpr int v[N] = {
            -2, -2, -2, -2, 2, 2, 2, 2, -2, -2, -2, -2, -2, -2, -2, -2, -1,
            -1, -1, -1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, -2, -2, -2, -2,
            0, 0, 0, 0, 2, 2, 2, 2, -2, -2, -2, -2, -1, -1, -1, -1, -1, -1,
            -1, -1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, -2, -2, -2, -2, -1,
            -1, -1, -1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, -2,
            0, 0, 0, 0, 2, -1, -1, -1, -1, 1, 1, 1, 1, -1, -1, -1, -1, 0, 0,
            0, 0, 1, 1, 1, 1, -1, 0, 0, 0, 0, 1, 0};
        return v[t];
    }
    __host__ __device__ static constexpr int dj(int t) {
        constexpr int v[N] = {
            -2, -2, 2, 2, -2, -2, 2, 2, -2, -2, -1, -1, 1, 1, 2, 2, -2, -2,
            2, 2, -2, -2, 2, 2, -2, -2, -1, -1, 1, 1, 2, 2, -2, 0, 0, 2, -2,
            -2, 2, 2, -2, 0, 0, 2, -1, -1, 1, 1, -2, -2, -1, -1, 1, 1, 2, 2,
            -2, -2, -1, -1, 1, 1, 2, 2, -1, -1, 1, 1, -1, 0, 0, 1, -2, 0, 0,
            2, -2, -2, -1, -1, 1, 1, 2, 2, -2, 0, 0, 2, -1, 0, 0, 1, 0, -2,
            0, 0, 2, 0, -1, -1, 1, 1, -1, -1, 1, 1, -1, 0, 0, 1, -1, -1, 1,
            1, -1, 0, 0, 1, 0, -1, 0, 0, 1, 0, 0};
        return v[t];
    }
    __host__ __device__ static constexpr int di(int t) {
        constexpr int v[N] = {
            -2, 2, -2, 2, -2, 2, -2, 2, -1, 1, -2, 2, -2, 2, -1, 1, -2, 2,
            -2, 2, -2, 2, -2, 2, -1, 1, -2, 2, -2, 2, -1, 1, 0, -2, 2, 0,
            -2, 2, -2, 2, 0, -2, 2, 0, -1, 1, -1, 1, -1, 1, -2, 2, -2, 2,
            -1, 1, -1, 1, -2, 2, -2, 2, -1, 1, -1, 1, -1, 1, 0, -1, 1, 0, 0,
            -2, 2, 0, -1, 1, -2, 2, -2, 2, -1, 1, 0, -2, 2, 0, 0, -1, 1, 0,
            0, 0, -2, 2, 0, 0, -1, 1, -1, 1, -1, 1, -1, 1, 0, -1, 1, 0, -1,
            1, -1, 1, 0, -1, 1, 0, 0, 0, -1, 1, 0, 0, 0};
        return v[t];
    }
};

// the 4-D 9-point star (K4): centre, +i, -i, +j, -j, +k, -k, +w, -w
struct LayoutStar9 {
    static constexpr int N = 9, R = 1;
    __host__ __device__ static constexpr int dw(int t) {
        constexpr int v[N] = {
            0, 0, 0, 0, 0, 0, 0, 1, -1};
        return v[t];
    }
    __host__ __device__ static constexpr int dk(int t) {
        constexpr int v[N] = {
            0, 0, 0, 0, 0, 1, -1, 0, 0};
        return v[t];
    }
    __host__ __device__ static constexpr int dj(int t) {
        constexpr int v[N] = {
            0, 0, 0, 1, -1, 0, 0, 0, 0};
        return v[t];
    }
    __host__ __device__ static constexpr int di(int t) {
        constexpr int v[N] = {
            0, 1, -1, 0, 0, 0, 0, 0, 0};
        return v[t];
    }
};

// the 5-D 11-point star (K12): per tap its offsets in numpy axis order
// (outer axes 0 and 1, k, j, i), centre, +i, -i, +j, -j, +k, -k, +o1,
// -o1, +o0, -o0.  outer(t): the tap reads another outer position (its dk,
// dj and di are 0).
struct LayoutStar11 {
    static constexpr int N = 11, R = 1;
    __host__ __device__ static constexpr int off(int t, int a) {
        constexpr int v[N][5] = {
            {0, 0, 0, 0, 0}, {0, 0, 0, 0, 1}, {0, 0, 0, 0, -1},
            {0, 0, 0, 1, 0}, {0, 0, 0, -1, 0}, {0, 0, 1, 0, 0},
            {0, 0, -1, 0, 0}, {0, 1, 0, 0, 0}, {0, -1, 0, 0, 0},
            {1, 0, 0, 0, 0}, {-1, 0, 0, 0, 0}};
        return v[t][a];
    }
    __host__ __device__ static constexpr int dk(int t) { return off(t, 2); }
    __host__ __device__ static constexpr int dj(int t) { return off(t, 3); }
    __host__ __device__ static constexpr int di(int t) { return off(t, 4); }
    __host__ __device__ static constexpr bool outer(int t) {
        return off(t, 0) != 0 || off(t, 1) != 0;
    }
};

// the generic body (K1, K4 and K12): the taps' offsets read at run time
struct LayoutRuntime {
    static constexpr int N = 0, R = 0;
};

// The runtime taps equal layout L's offsets.
template <class L>
static inline bool layout_matches(const SweepTaps& taps) {
    if constexpr (L::N == 0) {
        return false;
    } else {
        if (taps.n != L::N)
            return false;
        for (int t = 0; t < L::N; ++t)
            if (taps.dk[t] != L::dk(t) || taps.dj[t] != L::dj(t)
                || taps.di[t] != L::di(t))
                return false;
        return true;
    }
}
