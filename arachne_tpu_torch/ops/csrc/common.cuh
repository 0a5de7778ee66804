// Shared pieces of the DP kernels.
//
// extend.cu, local.cu and global.cu run one warp per problem,
// ARACHNE_WARPS problems per block: lane l owns the strip of S consecutive
// query columns [l*S, l*S + S), with H and E in registers, so a row needs
// no barrier: the column before a strip comes from the left lane by one
// shuffle.  In extend.cu and local.cu the 32 lanes work on one row: F
// crosses lanes by a warp scan, the row's scalars are warp reductions, and
// the target codes are fetched 32 rows at a time, one per lane, and
// broadcast by shuffle.  In global.cu, which has no per-row scalars, lane l
// works one row behind lane l - 1, and F and the row's target code come
// from the left lane too.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define ARACHNE_FULL_MASK 0xffffffffu

// Score of an out-of-band / unreachable global-DP cell (ksw.c MINUS_INF).
#define ARACHNE_MINUS_INF (-0x40000000)

// Load the 5x5 scoring matrix (row = target code, column = query code)
// into shared memory; the caller's next __syncthreads() publishes it.
__device__ __forceinline__ void load_matrix(const int* __restrict__ mat_g, int* mat) {
    if (threadIdx.x < 25) mat[threadIdx.x] = mat_g[threadIdx.x];
}

// The code of target row i (4, the code of N, at and past tlen).  The warp
// keeps 32 target codes, one per lane in `tcodes`, refetched when i reaches
// a multiple of 32, and broadcasts row i's by shuffle.  Every lane of the
// warp must call it, with i rising by one from 0.
__device__ __forceinline__ int target_code(
    const int8_t* __restrict__ trow, int i, int tlen, int& tcodes)
{
    if ((i & 31) == 0) {
        const int r = i + (threadIdx.x & 31);
        tcodes = r < tlen ? (int)trow[r] : 4;
    }
    return __shfl_sync(ARACHNE_FULL_MASK, tcodes, i & 31);
}

// The scoring-matrix row of target row i.
__device__ __forceinline__ const int* target_matrix_row(
    const int8_t* __restrict__ trow, int i, int tlen, const int* mat, int& tcodes)
{
    return mat + 5 * target_code(trow, i, tlen, tcodes);
}

// Exclusive prefix max across the warp: lane l gets max(x of lanes < l),
// lane 0 gets `ident`.  Every lane of the warp must call it.
__device__ __forceinline__ int warp_excl_prefix_max(int x, int ident) {
    const int lane = threadIdx.x & 31;
    int v = __shfl_up_sync(ARACHNE_FULL_MASK, x, 1);
    if (lane == 0) v = ident;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(ARACHNE_FULL_MASK, v, d);
        if (lane >= d) v = max(v, y);
    }
    return v;
}

// Problems (warps) per block of the warp-per-problem kernels.  A row costs
// a warp a chain of dependent shuffles and reductions, so a launch lasts
// about as long as its longest problem; small blocks spread the problems
// over the SMs most evenly.
#define ARACHNE_WARPS 2

// Shared memory one block may use on sm_90 (227 KB), less a margin for the
// kernels' static arrays.
#define ARACHNE_MAX_DYN_SMEM (232448 - 256)

// Strip widths the warp-per-problem kernels are built for:
// ARACHNE_STRIP_DISPATCH(S, fn, args...) returns fn<S>(args...).
#define ARACHNE_STRIP_DISPATCH(S, FN, ...)              \
    switch (S) {                                        \
    case 2: return FN<2>(__VA_ARGS__);                  \
    case 4: return FN<4>(__VA_ARGS__);                  \
    case 6: return FN<6>(__VA_ARGS__);                  \
    case 8: return FN<8>(__VA_ARGS__);                  \
    case 12: return FN<12>(__VA_ARGS__);                \
    case 16: return FN<16>(__VA_ARGS__);                \
    case 24: return FN<24>(__VA_ARGS__);                \
    case 32: return FN<32>(__VA_ARGS__);                \
    default: return (int)cudaErrorInvalidValue;         \
    }

// The narrowest strip that covers qmax columns with 32 lanes; 0 when qmax
// is above 1024.
static inline int arachne_strip(int qmax) {
    const int need = ((qmax > 0 ? qmax : 1) + 31) / 32;
    const int widths[] = {2, 4, 6, 8, 12, 16, 24, 32};
    for (int s : widths)
        if (s >= need) return s;
    return 0;
}
