// K1: banded affine-gap seed extension, ksw_extend2 (ksw.c:380-479).
//
// Replaces the TPU kernel arachne_tpu/ops/pallas_extend.py::_extend_kernel
// (and its XLA twin sw_extend.py::extend_batch_kernel, whose arithmetic it
// follows step for step; the plain PyTorch version is
// arachne_tpu_torch/ops/sw_extend.py::extend_batch_torch).
//
// What bounds it on an H100: the least time for its work is set by
// integer instructions, at least 5 per DP cell the recurrence reaches
// (rows before the problem dies or ends, times the band width in each),
// with DPX fusing an add into a max; bytes moved are O((qmax + tmax) * B):
// the sequences in, six int32 per problem out.  What bounds this design
// is latency: each row is a chain of dependent shuffles and warp
// reductions, rows run in order, so a launch lasts about as long as its
// longest problem while the SMs' schedulers mostly wait (at 4096 x 192 x
// 512 it runs ~34x above that bound; PERF.md).  The first design (one block per problem, thread j =
// column j) paid two __syncthreads() and a cross-warp scan per row on top.
//
// Design: one warp per problem, ARACHNE_WARPS problems per block, no
// barrier in the row loop.  Lane l owns the strip of S consecutive query
// columns from l*S (S a template constant, the narrowest of common.cuh's
// widths covering qmax), with H, E, M and u of its columns in registers:
//   - H(i-1, j0-1) for the strip's first column is the left lane's last H,
//     one shuffle (lane 0 takes the first-column boundary);
//   - F, the gap in the query, is max_{k<j} u(k) - (j-1-k)*e_ins with
//     u = max(M - oe_ins, 0): along the strip the recurrence F(j+1) =
//     max(F(j) - e_ins, u(j)); across lanes a shuffle scan (6 steps) of
//     each strip's max of u(k) + k*e_ins gives the F entering the strip.
//     u >= 0, so 0 is an exact identity;
//   - the row's scalars are warp reductions (redux.sync): the max H and
//     the LARGEST j attaining it (ties to the later j, ksw.c:437), the
//     last nonzero slot for the adaptive end, and H at qlen-1 by a shuffle
//     from the lane that owns it.  Every lane keeps an identical copy of
//     the problem's scalars (maxv, max_i, ...);
//   - a strip wholly outside [i - w, end_used) does no DP: its H and E are
//     0, as the masked recurrence makes them, and its scan input is 0.
//     Left of the band every u is 0 (H(i-1, j-1) is 0 there, the M-zero
//     quirk), except u(0) on row w+1, whose strip always holds column 1;
//   - the max-plus steps are DPX instructions (__vimax3_s32,
//     __viaddmax_s32, __vimax_s32_relu) on int32 state.
// The target codes are fetched 32 rows at a time, one per lane, and
// broadcast by shuffle; the scoring matrix sits in shared memory, so any
// MemOptions matrix works.  Each warp stops at its own death (zero row /
// z-drop) or its own tlen.
//
// extend16_kernel is the same kernel with its DP state in int16, the
// reference's ``sdt=jnp.int16`` (pallas_extend.py:326, wide_state=False),
// for inputs whose range sw_extend.int16_state_fits proves: a lane's strip
// of S columns is S/2 registers of packed s16x2 pairs (even column in the
// low half, odd in the high), and the max-plus steps are the s16x2 forms of
// the DPX instructions (__vimax3_s16x2, __viaddmax_s16x2[_relu]), each two
// cells' step in one instruction.  The per-problem scalars, the scan across
// lanes and the row reductions stay int32.  What differs from int32:
//   - H(i-1, j-1) of a pair is one byte permute of the pair and the one
//     before it (the left lane's last pair for the first);
//   - the M-zero quirk per half: H >= 0, so min(H, 1) * 0xffff is the mask
//     of the nonzero halves (the reference's own min(Hdiag, 1) trick);
//   - the score pair comes from a shared table packed by query-code pair;
//   - F(j+1) = max(F(j) - e_ins, u(j)) runs two columns a step: F(j+2) =
//     max(F(j) - 2 e_ins, max(u(j) - e_ins, u(j+1))), so the dependent chain
//     is S/2 long; so does the strip's scan input, the even and odd columns'
//     chains joined at the end;
//   - the row max with the LATEST column attaining it: __vibmax_s16x2's
//     predicates keep, per half, the last pair where the half's running max
//     was reached, and equal halves go to the odd (later) column.
#include "common.cuh"

namespace {

template <int S, bool COUNT>
__global__ void __launch_bounds__(ARACHNE_WARPS * 32) extend_kernel(
    const int8_t* __restrict__ qs, const int8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ ws, const int* __restrict__ h0s,
    const int* __restrict__ mat_g, int B, int qmax, int tmax,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    int* __restrict__ out, int* __restrict__ cells)
{
    __shared__ int mat[25];
    load_matrix(mat_g, mat);
    __syncthreads();
    const int b = blockIdx.x * ARACHNE_WARPS + (threadIdx.x >> 5);
    if (b >= B) return;
    const int lane = threadIdx.x & 31;
    const int j0 = lane * S;
    const int qlen = qlens[b], tlen = min(tlens[b], tmax), w = ws[b], h0 = h0s[b];
    const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    // the lane holding column qlen-1
    const int owner = qlen > 0 ? (qlen - 1) / S : 0;

    // H(-1, j) = max(h0 - oe_ins - j*e_ins, 0) inside the query, E = 0
    int qc[S], H[S], E[S], M[S], U[S];
    const int8_t* qrow = qs + (size_t)b * qmax;
#pragma unroll
    for (int k = 0; k < S; ++k) {
        const int j = j0 + k;
        qc[k] = j < qmax ? (int)qrow[j] : 4;
        H[k] = j < qlen ? max(h0 - oe_ins - j * e_ins, 0) : 0;
        E[k] = 0;
    }
    int end = qlen, maxv = h0, max_i = -1, max_j = -1, max_ie = -1;
    int gscore = -1, max_off = 0;
    // with COUNT, the DP cells of the rows reached (extend_batch_torch's
    // stats["cells"]); the kernel without it is the one the main path runs
    // untraced, untouched by the counter
    int n_cells = 0;

    const int8_t* trow = ts + (size_t)b * tmax;
    int tcodes = 4;
    for (int i = 0; i < tlen; ++i) {
        const int* mrow = target_matrix_row(trow, i, tlen, mat, tcodes);
        // adaptive end (ksw.c:417-418,468-469)
        const int end_used = min(min(end, i + w + 1), qlen);
        const int lo = max(i - w, 0);
        if constexpr (COUNT) n_cells += max(end_used - lo, 0);
        const int h1_init = (i - w <= 0) ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
        // H(i-1, -1): h0 on the first row, else the first-column boundary
        const int bound_prev = i == 0
            ? h0
            : ((i - 1) - w <= 0 ? max(h0 - (o_del + e_del * i), 0) : 0);
        int Hleft = __shfl_up_sync(ARACHNE_FULL_MASK, H[S - 1], 1);
        if (lane == 0) Hleft = bound_prev;
        const bool active = j0 < end_used && j0 + S > lo;

        // the strip's G = max_k u(k) - (S-1-k)*e_ins, so that its scan
        // input max_k u(k) + j*e_ins is G + (j0+S-1)*e_ins
        int tot = 0;
        if (active) {
            int G = 0;
#pragma unroll
            for (int k = 0; k < S; ++k) {
                const int Hd = k == 0 ? Hleft : H[k - 1];
                M[k] = Hd != 0 ? Hd + mrow[qc[k]] : 0;      // the M-zero quirk
                U[k] = __vimax_s32_relu(M[k] - oe_ins, 0);
                G = __viaddmax_s32(G, -e_ins, U[k]);
            }
            tot = G + (j0 + S - 1) * e_ins;
        }
        const int run_in = warp_excl_prefix_max(tot, 0);

        // this lane's part of the row reductions: (max H, largest j
        // attaining it), the last nonzero slot (slot s holds H(i, s-1) and
        // E(i+1, s)), and H at qlen-1 (H >= 0, so 0 elsewhere)
        int lm = 0, lj = -1, js = -1, hl = 0;
        if (active) {
            // F(j0) from the lanes to the left; then F(j+1) = max(F(j) -
            // e_ins, u(j)) along the strip
            int F = lane == 0 ? 0 : max(run_in - (j0 - 1) * e_ins, 0);
            const int kb = lo - j0, ke = end_used - j0;     // end_used <= qlen
#pragma unroll
            for (int k = 0; k < S; ++k) {
                const int j = j0 + k;
                const bool in_band = k >= kb && k < ke;
                const int Hn = in_band ? __vimax3_s32(M[k], E[k], F) : 0;
                const int En = in_band ? __vimax_s32_relu(E[k] - e_del, M[k] - oe_del) : 0;
                if (Hn >= lm) {
                    lm = Hn;
                    lj = j;
                }
                js = max(js, Hn != 0 ? j + 1 : (En != 0 ? j : -1));
                if (j == qlen - 1) hl = Hn;
                F = __viaddmax_s32(F, -e_ins, U[k]);
                H[k] = Hn;
                E[k] = En;
            }
        } else {
#pragma unroll
            for (int k = 0; k < S; ++k) {
                H[k] = 0;
                E[k] = 0;
            }
        }
        const int m = __reduce_max_sync(ARACHNE_FULL_MASK, lm);
        const int mj = __reduce_max_sync(ARACHNE_FULL_MASK, lm == m ? lj : -1);
        js = __reduce_max_sync(ARACHNE_FULL_MASK, js);
        if (h1_init != 0) js = max(js, 0);
        hl = __shfl_sync(ARACHNE_FULL_MASK, hl, owner);

        // gscore: the window reached the end of the query this row;
        // max_ie updates on ties (ksw.c:451-452)
        if (end_used == qlen) {
            if (!(gscore > hl)) max_ie = i;
            gscore = max(gscore, hl);
        }
        const bool improved = m > maxv;
        bool zdropped = false;
        if (zdrop > 0) {
            const int di = i - max_i, dj = mj - max_j;
            zdropped = di > dj ? (maxv - m - (di - dj) * e_del > zdrop)
                               : (maxv - m - (dj - di) * e_ins > zdrop);
        }
        const bool die = m == 0 || (!improved && zdropped);
        if (improved) {
            maxv = m;
            max_i = i;
            max_j = mj;
            max_off = max(max_off, abs(mj - i));
        }
        if (die) break;
        end = min(js + 2, qlen);
    }
    if (lane == 0) {
        out[0 * B + b] = maxv;
        out[1 * B + b] = max_j + 1;
        out[2 * B + b] = max_i + 1;
        out[3 * B + b] = max_ie + 1;
        out[4 * B + b] = gscore;
        out[5 * B + b] = max_off;
        if constexpr (COUNT) cells[b] = n_cells;
    }
}

// s16x2 helpers: x in both halves; the per-half sum (one DPX instruction:
// the max with -2^15 changes nothing); the low and high halves as ints
__device__ __forceinline__ unsigned pack2(int x) { return (unsigned)(x & 0xffff) * 0x10001u; }
__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
    return __viaddmax_s16x2(a, b, 0x80008000u);
}
__device__ __forceinline__ int lo16(unsigned v) { return (int)(short)(v & 0xffffu); }
__device__ __forceinline__ int hi16(unsigned v) { return (int)(short)(v >> 16); }

template <int S>
__global__ void __launch_bounds__(ARACHNE_WARPS * 32) extend16_kernel(
    const int8_t* __restrict__ qs, const int8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ ws, const int* __restrict__ h0s,
    const int* __restrict__ mat_g, int B, int qmax, int tmax,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop,
    int* __restrict__ out)
{
    constexpr int P = S / 2;
    // the scoring matrix by target code t and query-code pair (c0, c1):
    // pmat[25 t + c0 + 5 c1] = (mat[t][c0], mat[t][c1]) as s16x2
    __shared__ unsigned pmat[125];
    for (int x = threadIdx.x; x < 125; x += blockDim.x) {
        const int t = x / 25, c0 = x % 5, c1 = (x / 5) % 5;
        pmat[x] = ((unsigned)mat_g[5 * t + c0] & 0xffffu) | ((unsigned)mat_g[5 * t + c1] << 16);
    }
    __syncthreads();
    const int b = blockIdx.x * ARACHNE_WARPS + (threadIdx.x >> 5);
    if (b >= B) return;
    const int lane = threadIdx.x & 31;
    const int j0 = lane * S;
    const int qlen = qlens[b], tlen = min(tlens[b], tmax), w = ws[b], h0 = h0s[b];
    const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    // the lane holding column qlen-1, and that column in its strip
    const int owner = qlen > 0 ? (qlen - 1) / S : 0;
    const int hc = qlen - 1 - j0, hp = hc >> 1;
    const unsigned n_oe_ins = pack2(-oe_ins), n_oe_del = pack2(-oe_del);
    const unsigned n_e_del = pack2(-e_del), n_e_ins = pack2(-e_ins), n_2e_ins = pack2(-2 * e_ins);

    // H(-1, j) = max(h0 - oe_ins - j*e_ins, 0) inside the query, E = 0
    unsigned qp[P], H[P], E[P], M[P], U[P];
    const int8_t* qrow = qs + (size_t)b * qmax;
#pragma unroll
    for (int p = 0; p < P; ++p) {
        const int j = j0 + 2 * p;
        const int c0 = j < qmax ? (int)qrow[j] : 4, c1 = j + 1 < qmax ? (int)qrow[j + 1] : 4;
        qp[p] = c0 + 5 * c1;
        const int hl0 = j < qlen ? max(h0 - oe_ins - j * e_ins, 0) : 0;
        const int hl1 = j + 1 < qlen ? max(h0 - oe_ins - (j + 1) * e_ins, 0) : 0;
        H[p] = (unsigned)hl0 | ((unsigned)hl1 << 16);
        E[p] = 0;
    }
    int end = qlen, maxv = h0, max_i = -1, max_j = -1, max_ie = -1;
    int gscore = -1, max_off = 0;

    const int8_t* trow = ts + (size_t)b * tmax;
    int tcodes = 4;
    for (int i = 0; i < tlen; ++i) {
        const unsigned* prow = pmat + 25 * target_code(trow, i, tlen, tcodes);
        // adaptive end (ksw.c:417-418,468-469)
        const int end_used = min(min(end, i + w + 1), qlen);
        const int lo = max(i - w, 0);
        const int h1_init = (i - w <= 0) ? max(h0 - (o_del + e_del * (i + 1)), 0) : 0;
        // H(i-1, -1): h0 on the first row, else the first-column boundary
        const int bound_prev = i == 0
            ? h0
            : ((i - 1) - w <= 0 ? max(h0 - (o_del + e_del * i), 0) : 0);
        // the left lane's last pair; H(i-1, j0-1) is its high half
        unsigned Hleft = __shfl_up_sync(ARACHNE_FULL_MASK, H[P - 1], 1);
        if (lane == 0) Hleft = (unsigned)bound_prev << 16;
        const bool active = j0 < end_used && j0 + S > lo;

        // the strip's G = max_k u(k) - (S-1-k)*e_ins, from the even and odd
        // columns' chains (steps of 2 e_ins)
        int tot = 0;
        if (active) {
            unsigned Gp = 0;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const unsigned Hd = __byte_perm(p == 0 ? Hleft : H[p - 1], H[p], 0x5432);
                const unsigned nz = __vimin_s16x2_relu(Hd, 0x00010001u) * 0xffffu;
                M[p] = add2(Hd, prow[qp[p]]) & nz;                  // the M-zero quirk
                U[p] = __viaddmax_s16x2_relu(M[p], n_oe_ins, 0u);
                Gp = __viaddmax_s16x2(Gp, n_2e_ins, U[p]);
            }
            tot = max(lo16(Gp) - e_ins, hi16(Gp)) + (j0 + S - 1) * e_ins;
        }
        const int run_in = warp_excl_prefix_max(tot, 0);

        // this lane's part of the row reductions, as in extend_kernel
        int lm = 0, lj = -1, js = -1, hl = 0;
        if (active) {
            // F(j0) from the lanes to the left, F(j0+1) from it; then two
            // columns a step
            const int F0 = lane == 0 ? 0 : max(run_in - (j0 - 1) * e_ins, 0);
            unsigned F = (unsigned)F0 | ((unsigned)max(F0 - e_ins, lo16(U[0])) << 16);
            const int kb = lo - j0, ke = end_used - j0;     // end_used <= qlen
            // per half: the running max of H over the even / odd columns
            // and the last pair where it was reached
            unsigned run = 0;
            int ilo = -1, ihi = -1;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const unsigned in_band = (2 * p >= kb && 2 * p < ke ? 0xffffu : 0u)
                    | (2 * p + 1 >= kb && 2 * p + 1 < ke ? 0xffff0000u : 0u);
                const unsigned Hn = __vimax3_s16x2(M[p], E[p], F) & in_band;
                const unsigned En =
                    __viaddmax_s16x2_relu(E[p], n_e_del, add2(M[p], n_oe_del)) & in_band;
                if (p + 1 < P)
                    F = __viaddmax_s16x2(F, n_2e_ins, __viaddmax_s16x2(
                        U[p], n_e_ins, __byte_perm(U[p], U[p + 1], 0x5432)));
                bool ge_hi, ge_lo;
                run = __vibmax_s16x2(Hn, run, &ge_hi, &ge_lo);
                if (ge_lo) ilo = p;
                if (ge_hi) ihi = p;
                H[p] = Hn;
                E[p] = En;
            }
            // the row max and its latest column; ties go to the odd column
            // when its pair is not earlier
            const int rl = lo16(run), rh = hi16(run);
            if (rh > rl || (rh == rl && ihi >= ilo)) {
                lm = rh;
                lj = j0 + 2 * ihi + 1;
            } else {
                lm = rl;
                lj = j0 + 2 * ilo;
            }
            // the last nonzero slot: pair p's word holds slots 2p+1 and
            // 2p+2 (H of columns 2p, 2p+1; E of 2p+1, 2p+2), slot 0 is E(j0)
            int last = -1;
            unsigned last_w = 0;
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const unsigned sw = H[p] | __byte_perm(E[p], p + 1 < P ? E[p + 1] : 0u, 0x5432);
                if (sw != 0) {
                    last = p;
                    last_w = sw;
                }
            }
            js = last >= 0 ? j0 + 2 * last + 1 + (last_w > 0xffffu) : ((E[0] & 0xffffu) ? j0 : -1);
            // H at qlen-1 (H >= 0, so 0 in every other lane)
            unsigned hw = 0;
#pragma unroll
            for (int p = 0; p < P; ++p) hw = p == hp ? H[p] : hw;
            hl = (hc & 1) ? (int)(hw >> 16) : (int)(hw & 0xffffu);
        } else {
#pragma unroll
            for (int p = 0; p < P; ++p) {
                H[p] = 0;
                E[p] = 0;
            }
        }
        const int m = __reduce_max_sync(ARACHNE_FULL_MASK, lm);
        const int mj = __reduce_max_sync(ARACHNE_FULL_MASK, lm == m ? lj : -1);
        js = __reduce_max_sync(ARACHNE_FULL_MASK, js);
        if (h1_init != 0) js = max(js, 0);
        hl = __shfl_sync(ARACHNE_FULL_MASK, hl, owner);

        // gscore: the window reached the end of the query this row;
        // max_ie updates on ties (ksw.c:451-452)
        if (end_used == qlen) {
            if (!(gscore > hl)) max_ie = i;
            gscore = max(gscore, hl);
        }
        const bool improved = m > maxv;
        bool zdropped = false;
        if (zdrop > 0) {
            const int di = i - max_i, dj = mj - max_j;
            zdropped = di > dj ? (maxv - m - (di - dj) * e_del > zdrop)
                               : (maxv - m - (dj - di) * e_ins > zdrop);
        }
        const bool die = m == 0 || (!improved && zdropped);
        if (improved) {
            maxv = m;
            max_i = i;
            max_j = mj;
            max_off = max(max_off, abs(mj - i));
        }
        if (die) break;
        end = min(js + 2, qlen);
    }
    if (lane == 0) {
        out[0 * B + b] = maxv;
        out[1 * B + b] = max_j + 1;
        out[2 * B + b] = max_i + 1;
        out[3 * B + b] = max_ie + 1;
        out[4 * B + b] = gscore;
        out[5 * B + b] = max_off;
    }
}

template <int S>
int launch_extend(
    const void* qs, const void* ts, const void* qlens, const void* tlens,
    const void* ws, const void* h0s, const void* mat, int B, int qmax, int tmax,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop, void* out, void* cells,
    cudaStream_t stream)
{
    const int blocks = (B + ARACHNE_WARPS - 1) / ARACHNE_WARPS;
    const auto kernel = cells ? extend_kernel<S, true> : extend_kernel<S, false>;
    kernel<<<blocks, ARACHNE_WARPS * 32, 0, stream>>>(
        (const int8_t*)qs, (const int8_t*)ts, (const int*)qlens, (const int*)tlens,
        (const int*)ws, (const int*)h0s, (const int*)mat, B, qmax, tmax,
        o_del, e_del, o_ins, e_ins, zdrop, (int*)out, (int*)cells);
    return (int)cudaGetLastError();
}

template <int S>
int launch_extend16(
    const void* qs, const void* ts, const void* qlens, const void* tlens,
    const void* ws, const void* h0s, const void* mat, int B, int qmax, int tmax,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop, void* out, cudaStream_t stream)
{
    const int blocks = (B + ARACHNE_WARPS - 1) / ARACHNE_WARPS;
    extend16_kernel<S><<<blocks, ARACHNE_WARPS * 32, 0, stream>>>(
        (const int8_t*)qs, (const int8_t*)ts, (const int*)qlens, (const int*)tlens,
        (const int*)ws, (const int*)h0s, (const int*)mat, B, qmax, tmax,
        o_del, e_del, o_ins, e_ins, zdrop, (int*)out);
    return (int)cudaGetLastError();
}

}  // namespace

// cells: NULL, or (B,) int32 that receives each problem's DP cells (the
// count extend_batch_torch's stats take: the in-band cells of every row the
// problem reaches before it dies or ends)
extern "C" int arachne_extend(
    const void* qs, const void* ts, const void* qlens, const void* tlens,
    const void* ws, const void* h0s, const void* mat, int B, int qmax, int tmax,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop, void* out, void* cells,
    void* stream)
{
    if (B <= 0) return 0;
    ARACHNE_STRIP_DISPATCH(arachne_strip(qmax), launch_extend,
                           qs, ts, qlens, tlens, ws, h0s, mat, B, qmax, tmax,
                           o_del, e_del, o_ins, e_ins, zdrop, out, cells,
                           (cudaStream_t)stream);
}

// K1 with int16 DP state; the caller has proven the range
// (sw_extend.int16_state_fits)
extern "C" int arachne_extend16(
    const void* qs, const void* ts, const void* qlens, const void* tlens,
    const void* ws, const void* h0s, const void* mat, int B, int qmax, int tmax,
    int o_del, int e_del, int o_ins, int e_ins, int zdrop, void* out, void* stream)
{
    if (B <= 0) return 0;
    ARACHNE_STRIP_DISPATCH(arachne_strip(qmax), launch_extend16,
                           qs, ts, qlens, tlens, ws, h0s, mat, B, qmax, tmax,
                           o_del, e_del, o_ins, e_ins, zdrop, out, (cudaStream_t)stream);
}

extern "C" const char* arachne_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
