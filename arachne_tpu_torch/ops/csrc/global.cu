// K3: banded global alignment, ksw_global2 (ksw.c:504-607), score-only
// and with direction bytes; K4: the per-problem backtrack over them
// (ksw.c:588-602).
//
// K3 replaces the TPU kernel arachne_tpu/ops/pallas_global.py::
// _global_kernel_body (via _score_kernel and _z_kernel); K4 replaces the
// XLA device walk arachne_tpu/ops/sw_global.py::traceback_device.  The
// plain PyTorch versions are arachne_tpu_torch/ops/sw_global.py::
// global_batch_torch and traceback_torch.
//
// What bounds them on an H100: the least time for K3's work is set by
// integer instructions, at least 5 per cell of the band with DPX, for the
// score-only variant (bytes moved are O((qmax + tmax) * B)), and by the
// tmax * qmax direction bytes per problem that the z variant writes.  The
// least time for K4 is that of its bytes: one z byte per step of a walk,
// max_steps ops and two int32 per problem.  What bounds this design is
// the instructions one warp can issue: a problem is one warp, a chunk of
// 128 problems leaves three quarters of the card's 528 schedulers idle,
// and a lone warp issues an integer instruction every two to three cycles
// (an SM partition has 16 int32 lanes), so a launch lasts about (steps of
// the longest problem) x (instructions per step), ~145 at S = 6 for the
// score and ~240 with direction bytes (PERF.md); every lane runs the
// whole step whether its strip lies in the band or not.  A K4 step is one
// shared-memory load and the few instructions that turn the byte into the
// next address, a window is one round trip to global memory, and walks run
// in order too.
//
// Design of K3: one warp per problem, ARACHNE_WARPS problems per block, no
// barrier and no scan in the loop.  Lane l owns the strip of S consecutive
// query columns from l*S (S a template constant, the narrowest of
// common.cuh's widths covering qmax) with H and E in registers, and the
// lanes work as a wave: at step t lane l computes row t - l of its strip,
// so what it needs of that row from the lane to its left was computed one
// step earlier and costs one shuffle each:
//   - H(i-1, j0-1) for the strip's first column is the left lane's last H
//     as it stood a step ago, kept from the previous step's shuffle (lane
//     0 takes the first-column boundary; before a lane's first row the
//     left lane still holds row -1);
//   - F, the gap in the query, is max_{k<j, k in band} (M(k) - oe_ins) -
//     (j-1-k)*e_ins, the recurrence F(j+1) = max(F(j) - e_ins, M(j) -
//     oe_ins) over the band's columns and F(j+1) = F(j) - e_ins outside it:
//     a lane takes F(i, j0) from the left lane and hands on F(i, j0 + S).
//     Lane 0 starts at MINUS_INF + e_ins, so the first column of the band
//     gets MINUS_INF - (j-1)*e_ins and column 0 itself MINUS_INF, as the
//     plain version's masked prefix maximum gives them.  Keeping the lanes
//     on one row and crossing them with a shuffle scan of each strip's
//     maximum, as K1 and K2 must for their per-row scalars and early
//     stops, costs six more dependent shuffles and a second pass over the
//     strip per row; K3 has neither, so the wave is exact for it;
//   - a strip wholly outside [i - w, i + w] and [0, qlen) does no DP on
//     that row: its H and E are MINUS_INF, as masking makes them, its F
//     falls by S*e_ins, and it writes no z (the caller passes zeroed
//     memory);
//   - every cell of the band has an in-band or boundary H(i-1, j-1), so M
//     is never derived from MINUS_INF there, and the direction bits come
//     out as from the plain version's unmasked values; E enters the band's
//     right edge as MINUS_INF;
//   - a lane stores its strip's direction bytes of a row with the widest
//     store that the strip's offset allows (2 to 16 bytes);
//   - the target codes are fetched 32 rows at a time, one per lane, and
//     lane 0 takes each row's by shuffle; the code then travels down the
//     wave with the row, one more shuffle, so no lane waits for a load.
//     A lane fetches its next row's S scores from the matrix in shared
//     memory (any MemOptions matrix works) a step ahead; the max-plus
//     steps are DPX instructions on int32 state; a warp runs tlen + (the
//     last lane holding a query column) steps.
//
// Design of K4: one warp per problem.  A walk moves at most one row up and
// one column left per step, so 32 steps from (i, k) stay inside rows
// i-31..i and columns k-31..k: the warp loads that 32 x 32-byte window of z
// into shared memory in one round of 32 independent loads (one row each,
// a lane per column, clamped at row 0 and column 0), every lane then walks
// 32 steps in the window at shared-memory latency, lane s keeps the op of
// step s, and the 32 ops are stored together.  After the walk's end the
// warp fills the rest of the problem's op column with 3, 32 steps per
// instruction.  The op stream is the reference's (0 = M, 2 = D, 1 = I, 3 =
// done) in (max_steps, B) layout plus the final (i, k); the raw 2-bit
// `which` state, 3 included, carries to the next read exactly as the host
// walk keeps it.  The walk is the reference's scalar ksw.global2's, which
// stores an insertion's continuation at bit 4 where ksw.c (and K3, its
// plain version and the TPU walk) store it at bit 5: in the insertion
// state a set continuation bit reads as 1, so the walk turns to a
// deletion instead of staying in the insertion.  z keeps the port's own
// layout (B, tmax, qmax).
#include "common.cuh"

namespace {

// The widest store, in bytes, that every strip of S direction bytes can
// take when a row's bytes start at a multiple of it.
template <int S>
constexpr int Z_STORE_BYTES = S % 16 == 0 ? 16 : S % 8 == 0 ? 8 : S % 4 == 0 ? 4 : 2;

// Store one strip's direction bytes, packed four to a word in `zw`, at p.
// `wide`: p is a multiple of Z_STORE_BYTES<S> and all S bytes lie inside
// the row; else only the first n bytes do, and they go out one by one.
template <int S>
__device__ __forceinline__ void store_strip(
    uint8_t* p, const unsigned (&zw)[(S + 3) / 4], bool wide, int n)
{
    constexpr int V = Z_STORE_BYTES<S>;
    if (wide) {
        if constexpr (V == 16) {
#pragma unroll
            for (int v = 0; v < S / 16; ++v)
                reinterpret_cast<uint4*>(p)[v] =
                    make_uint4(zw[4 * v], zw[4 * v + 1], zw[4 * v + 2], zw[4 * v + 3]);
        } else if constexpr (V == 8) {
#pragma unroll
            for (int v = 0; v < S / 8; ++v)
                reinterpret_cast<uint2*>(p)[v] = make_uint2(zw[2 * v], zw[2 * v + 1]);
        } else if constexpr (V == 4) {
#pragma unroll
            for (int v = 0; v < S / 4; ++v) reinterpret_cast<unsigned*>(p)[v] = zw[v];
        } else {
#pragma unroll
            for (int v = 0; v < S / 2; ++v)
                reinterpret_cast<unsigned short*>(p)[v] =
                    (unsigned short)(zw[v >> 1] >> (16 * (v & 1)));
        }
    } else {
#pragma unroll
        for (int k = 0; k < S; ++k)
            if (k < n) p[k] = (uint8_t)(zw[k >> 2] >> (8 * (k & 3)));
    }
}

// sc[k] = mat[tcode][qc[k]]: a target code's scores against a strip's
// query codes.
template <int S>
__device__ __forceinline__ void load_scores(
    const int* mat, int tcode, const int (&qc)[S], int (&sc)[S])
{
    const int* mrow = mat + 5 * tcode;
#pragma unroll
    for (int k = 0; k < S; ++k) sc[k] = mrow[qc[k]];
}

template <int S, bool WANT_Z>
__global__ void __launch_bounds__(ARACHNE_WARPS * 32) global_kernel(
    const int8_t* __restrict__ qs, const int8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ ws, const int* __restrict__ mat_g,
    int B, int qmax, int tmax, int o_del, int e_del, int o_ins, int e_ins,
    int* __restrict__ score, uint8_t* __restrict__ z, bool z_wide)
{
    __shared__ int mat[25];
    load_matrix(mat_g, mat);
    __syncthreads();
    const int b = blockIdx.x * ARACHNE_WARPS + (threadIdx.x >> 5);
    if (b >= B) return;
    const int lane = threadIdx.x & 31;
    const int j0 = lane * S;
    const int qlen = min(qlens[b], qmax), tlen = min(tlens[b], tmax), w = ws[b];
    const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    const int NEG = ARACHNE_MINUS_INF;

    // first row: H(-1, j) = -(o_ins + e_ins*(j+1)) within the band, E = -inf
    int qc[S], H[S], E[S], sc[S];
    const int8_t* qrow = qs + (size_t)b * qmax;
    const int8_t* trow = ts + (size_t)b * tmax;
#pragma unroll
    for (int k = 0; k < S; ++k) {
        const int j = j0 + k;
        qc[k] = j < qmax ? (int)qrow[j] : 4;
        H[k] = (j + 1 <= w && j < qlen) ? -(o_ins + e_ins * (j + 1)) : NEG;
        E[k] = NEG;
    }
    uint8_t* zstrip = WANT_Z ? z + (size_t)b * tmax * qmax + j0 : nullptr;
    const bool wide = z_wide && j0 + S <= qmax;
    // the wave: at step t lane l works on row t - l
    const int last = qlen > 0 ? (qlen - 1) / S : 0;
    const int steps = tlen > 0 ? tlen + last : 0;
    int diag = NEG, Fout = NEG;
    // tc: the target code of this lane's row (N before row 0 and past the
    // target).  Lane 0 takes row t's from the warp's 32 fetched codes, the
    // others the left lane's of a step ago; a row's scores are fetched
    // during the step before it, lane 0's first row here.
    int tcodes = 4;
    int tc = target_code(trow, 0, tlen, tcodes);
    if (lane != 0) tc = 4;
    load_scores<S>(mat, tc, qc, sc);
    for (int t = 0; t < steps; ++t) {
        const int i = t - lane;
        const bool valid = i >= 0 && i < tlen;
        // the left lane worked on row i a step ago: its last H is H(i,
        // j0-1), the diagonal of this lane's NEXT row, its F is F(i, j0),
        // and its target code is the next row's
        const int hl = __shfl_up_sync(ARACHNE_FULL_MASK, H[S - 1], 1);
        const int fl = __shfl_up_sync(ARACHNE_FULL_MASK, Fout, 1);
        const int tl = __shfl_up_sync(ARACHNE_FULL_MASK, tc, 1);
        const int t0 = target_code(trow, t + 1, tlen, tcodes);
        if (valid) {
            const int lo = max(i - w, 0), hi = min(i + w + 1, qlen);
            const int bound_prev = i == 0 ? 0 : ((i - 1) <= w ? -(o_del + e_del * i) : NEG);
            const bool active = max(j0, lo) < min(j0 + S, hi);
            int F = lane == 0 ? NEG + e_ins : fl;
            if (active) {
                const int kb = lo - j0, ke = hi - j0;
                int Hd = lane == 0 ? bound_prev : diag;
                unsigned zw[(S + 3) / 4] = {};
#pragma unroll
                for (int k = 0; k < S; ++k) {
                    const bool in_band = k >= kb && k < ke;
                    const int M = Hd + sc[k];
                    const int Fk = (k == 0 && lane == 0) ? NEG : F;
                    const int Hn = __vimax3_s32(M, E[k], Fk);
                    if (WANT_Z) {
                        unsigned d = M >= E[k] ? 0u : 1u;
                        d = max(M, E[k]) >= Fk ? d : 2u;
                        d |= ((E[k] - e_del) > (M - oe_del)) ? 4u : 0u;
                        d |= ((Fk - e_ins) > (M - oe_ins)) ? 32u : 0u;
                        zw[k >> 2] |= (in_band ? d : 0u) << (8 * (k & 3));
                    }
                    const int En = __viaddmax_s32(E[k], -e_del, M - oe_del);
                    // outside the band F only falls: INT_MIN never wins
                    F = __viaddmax_s32(F, -e_ins, in_band ? M - oe_ins : INT_MIN);
                    Hd = H[k];
                    H[k] = in_band ? Hn : NEG;
                    E[k] = in_band ? En : NEG;
                }
                if (WANT_Z) store_strip<S>(zstrip + (size_t)i * qmax, zw, wide, qmax - j0);
            } else {
#pragma unroll
                for (int k = 0; k < S; ++k) {
                    H[k] = NEG;
                    E[k] = NEG;
                }
                F -= S * e_ins;
            }
            Fout = F;
        }
        diag = hl;
        tc = lane == 0 ? t0 : tl;
        load_scores<S>(mat, tc, qc, sc);
    }

    // the score: H at (tlen-1, qlen-1) after masking, from the lane that
    // owns the column; MINUS_INF when no row ran or the cell is outside
    // the band
    int s = NEG;
    if (tlen > 0) {
#pragma unroll
        for (int k = 0; k < S; ++k)
            if (j0 + k == qlen - 1) s = H[k];
    }
    s = __reduce_max_sync(ARACHNE_FULL_MASK, s);
    if (lane == 0) score[b] = s;
}

__global__ void __launch_bounds__(ARACHNE_WARPS * 32) traceback_kernel(
    const uint8_t* __restrict__ z, const int* __restrict__ qlens,
    const int* __restrict__ tlens, const int* __restrict__ ws,
    int B, int qmax, int tmax, int max_steps,
    int8_t* __restrict__ ops, int* __restrict__ fi, int* __restrict__ fk)
{
    __shared__ uint8_t win_all[ARACHNE_WARPS][32 * 32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * ARACHNE_WARPS + warp;
    if (b >= B) return;
    uint8_t* win = win_all[warp];
    int i = tlens[b] - 1;
    int k = min(i + ws[b] + 1, qlens[b]) - 1;
    int which = 0;
    const uint8_t* zb = z + (size_t)b * tmax * qmax;
    int s0 = 0;
    for (; s0 < max_steps && i >= 0 && k >= 0; s0 += 32) {
        // the window: row i - r of z at win[32 * r], columns k-31..k
        const int col = min(max(k - 31 + lane, 0), qmax - 1);
        uint8_t zr[32];
#pragma unroll
        for (int r = 0; r < 32; ++r)
            zr[r] = zb[(size_t)min(max(i - r, 0), tmax - 1) * qmax + col];
#pragma unroll
        for (int r = 0; r < 32; ++r) win[32 * r + lane] = zr[r];
        __syncwarp();
        // every lane walks the same 32 steps; lane s keeps the op of step s
        const int n = min(32, max_steps - s0);
        int pos = 31, op_mine = 3;
        for (int s = 0; s < n && i >= 0 && k >= 0; ++s) {
            int nw = ((int)win[pos] >> (which << 1)) & 3;
            if (which == 2 && nw == 2) nw = 1;  // ksw.global2's turn: see above
            if (lane == s) op_mine = nw == 0 ? 0 : (nw == 1 ? 2 : 1);
            if (nw <= 1) {
                --i;
                pos += 32;
            }
            if (nw != 1) {
                --k;
                --pos;
            }
            which = nw;
        }
        if (lane < n) ops[(size_t)(s0 + lane) * B + b] = (int8_t)op_mine;
        __syncwarp();
    }
    for (int s = s0 + lane; s < max_steps; s += 32) ops[(size_t)s * B + b] = 3;
    if (lane == 0) {
        fi[b] = i;
        fk[b] = k;
    }
}

template <int S>
int launch_global(
    const void* qs, const void* ts, const void* qlens, const void* tlens,
    const void* ws, const void* mat, int B, int qmax, int tmax,
    int o_del, int e_del, int o_ins, int e_ins, void* score, void* z, cudaStream_t stream)
{
    const int blocks = (B + ARACHNE_WARPS - 1) / ARACHNE_WARPS;
    if (z == nullptr) {
        global_kernel<S, false><<<blocks, ARACHNE_WARPS * 32, 0, stream>>>(
            (const int8_t*)qs, (const int8_t*)ts, (const int*)qlens, (const int*)tlens,
            (const int*)ws, (const int*)mat, B, qmax, tmax, o_del, e_del, o_ins, e_ins,
            (int*)score, nullptr, false);
    } else {
        // every strip of every row starts at a multiple of the store width
        constexpr int V = Z_STORE_BYTES<S>;
        const bool z_wide = qmax % V == 0 && (uintptr_t)z % V == 0;
        global_kernel<S, true><<<blocks, ARACHNE_WARPS * 32, 0, stream>>>(
            (const int8_t*)qs, (const int8_t*)ts, (const int*)qlens, (const int*)tlens,
            (const int*)ws, (const int*)mat, B, qmax, tmax, o_del, e_del, o_ins, e_ins,
            (int*)score, (uint8_t*)z, z_wide);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// z == NULL: score only (the TPU's _score_kernel); else also the direction
// bytes (B, tmax, qmax) (the TPU's _z_kernel).  Bytes outside a row's band
// and rows at or past a problem's tlen are not written: the caller passes
// zeroed memory.
extern "C" int arachne_global(
    const void* qs, const void* ts, const void* qlens, const void* tlens,
    const void* ws, const void* mat, int B, int qmax, int tmax,
    int o_del, int e_del, int o_ins, int e_ins, void* score, void* z, void* stream)
{
    if (B <= 0) return 0;
    ARACHNE_STRIP_DISPATCH(arachne_strip(qmax), launch_global,
                           qs, ts, qlens, tlens, ws, mat, B, qmax, tmax,
                           o_del, e_del, o_ins, e_ins, score, z, (cudaStream_t)stream);
}

extern "C" int arachne_traceback(
    const void* z, const void* qlens, const void* tlens, const void* ws,
    int B, int qmax, int tmax, int max_steps, void* ops, void* fi, void* fk,
    void* stream)
{
    if (B <= 0) return 0;
    const int blocks = (B + ARACHNE_WARPS - 1) / ARACHNE_WARPS;
    traceback_kernel<<<blocks, ARACHNE_WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)z, (const int*)qlens, (const int*)tlens, (const int*)ws,
        B, qmax, tmax, max_steps, (int8_t*)ops, (int*)fi, (int*)fk);
    return (int)cudaGetLastError();
}
