// K2: local Smith-Waterman for mate rescue, the forward pass of
// ksw_align2 (ksw.c:111-335), with the second-best (b-array) scan fused in.
//
// Replaces the TPU kernel arachne_tpu/ops/pallas_local.py::_local_kernel
// together with the XLA scan arachne_tpu/ops/sw_local.py::score2_scan that
// local_sw_full_pallas_bundled fused after it.  The plain PyTorch version
// is arachne_tpu_torch/ops/sw_local.py::local_sw_full_torch.
//
// What bounds it on an H100: the least time for its work is set by
// integer instructions, at least 5 per DP cell with DPX (rows before the
// early stop, times qlen); bytes moved are O((qmax + tmax) * B):
// sequences in, five int32 per problem out.  The per-row maxima, which
// the TPU kernel streamed to HBM as a (tmax, B) matrix for the scan, stay
// in shared memory and never reach HBM.  What bounds this design is
// latency: each row is a chain of dependent shuffles and a warp
// reduction, so a launch lasts about as long as its longest problem (~15x
// above that bound at 1024 x 192 x 768; PERF.md).  The first design (one
// block per problem, thread j = column j) paid two __syncthreads() and
// cross-warp passes per row on top.
//
// Design: one warp per problem, ARACHNE_WARPS problems per block (fewer
// when tmax is large), no barrier in the row loop.  Lane l owns the strip
// of S consecutive query columns from l*S, with H, E and Hmax (the best
// row's H) in registers.  The strip's first H(i-1, j-1) comes from the
// left lane by one shuffle; F follows F(j+1) = max(F(j) - e_ins, Hpre(j) -
// oe_ins, 0) along the strip, entering it from a 6-step shuffle scan of
// the strips' maxima across lanes; the row max is one warp reduction, and
// lane 0 writes it to the warp's tmax ints of dynamic shared memory.  The
// max-plus steps are DPX instructions on int32 state.  The early stop on endsc happens after the row is recorded
// (ksw.c:205).  After the row loop a warp min gives qe (the SMALLEST j of
// the Hmax row's max), and lane 0 runs score2_scan's one-row-memory
// automaton over the row maxima; rows the loop never reached read 0, as on
// the TPU.
#include "common.cuh"

namespace {

// below every (H - oe_ins) + j*e_ins, and far enough from INT_MIN that
// subtracting j*e_ins cannot wrap
#define LOCAL_SCAN_IDENT (-(1 << 30))

template <int S>
__global__ void __launch_bounds__(ARACHNE_WARPS * 32) local_kernel(
    const int8_t* __restrict__ qs, const int8_t* __restrict__ ts,
    const int* __restrict__ qlens, const int* __restrict__ tlens,
    const int* __restrict__ endscs, const int* __restrict__ minscs,
    const int* __restrict__ mat_g, int B, int qmax, int tmax,
    int o_del, int e_del, int o_ins, int e_ins, int max_mat,
    int* __restrict__ out)
{
    extern __shared__ int rowmax_all[];      // tmax ints per warp
    __shared__ int mat[25];
    load_matrix(mat_g, mat);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * (blockDim.x >> 5) + warp;
    if (b >= B) return;
    int* rowmax = rowmax_all + (size_t)warp * tmax;
    const int j0 = lane * S;
    const int qlen = qlens[b], tlen = min(tlens[b], tmax);
    const int endsc = endscs[b], minsc = minscs[b];
    const int oe_del = o_del + e_del, oe_ins = o_ins + e_ins;
    // strips wholly past the query keep H = E = 0 and do no DP
    const bool active = j0 < qlen;

    int qc[S], H[S], E[S], Hp[S], Hmax[S];
    const int8_t* qrow = qs + (size_t)b * qmax;
#pragma unroll
    for (int k = 0; k < S; ++k) {
        qc[k] = j0 + k < qmax ? (int)qrow[j0 + k] : 4;
        H[k] = 0;
        E[k] = 0;
        Hmax[k] = 0;
    }
    int gmax = 0, te = -1, nrows = 0;

    const int8_t* trow = ts + (size_t)b * tmax;
    int tcodes = 4;
    for (int i = 0; i < tlen; ++i) {
        const int* mrow = target_matrix_row(trow, i, tlen, mat, tcodes);
        int Hleft = __shfl_up_sync(ARACHNE_FULL_MASK, H[S - 1], 1);
        if (lane == 0) Hleft = 0;

        // Hpre = max(H(i-1, j-1) + s, 0, E); the scan runs over
        // (Hpre(k) - oe_ins) + k*e_ins, and the strip's G = max_k (Hpre(k)
        // - oe_ins) - (S-1-k)*e_ins makes its input G + (j0+S-1)*e_ins
        int tot = LOCAL_SCAN_IDENT;
        if (active) {
            int G = LOCAL_SCAN_IDENT;
#pragma unroll
            for (int k = 0; k < S; ++k) {
                const int Hd = k == 0 ? Hleft : H[k - 1];
                Hp[k] = j0 + k < qlen ? __vimax3_s32(Hd + mrow[qc[k]], 0, E[k]) : 0;
                G = __viaddmax_s32(G, -e_ins, Hp[k] - oe_ins);
            }
            tot = G + (j0 + S - 1) * e_ins;
        }
        const int run_in = warp_excl_prefix_max(tot, LOCAL_SCAN_IDENT);

        int lm = 0;
        if (active) {
            // F(0) = 0; F(j) = max(0, F(j-1) - e_ins, Hpre(j-1) - oe_ins):
            // F(j0) from the lanes to the left, then along the strip
            int F = lane == 0 ? 0 : max(run_in - (j0 - 1) * e_ins, 0);
            const int kq = qlen - j0;
#pragma unroll
            for (int k = 0; k < S; ++k) {
                const bool valid = k < kq;
                const int Hn = valid ? max(Hp[k], F) : 0;
                E[k] = valid ? __vimax_s32_relu(E[k] - e_del, Hn - oe_del) : 0;
                F = __vimax_s32_relu(F - e_ins, Hp[k] - oe_ins);
                H[k] = Hn;
                lm = max(lm, Hn);
            }
        }
        const int imax = __reduce_max_sync(ARACHNE_FULL_MASK, lm);
        if (lane == 0) rowmax[i] = imax;
        nrows = i + 1;
        if (imax > gmax) {
            gmax = imax;
            te = i;
#pragma unroll
            for (int k = 0; k < S; ++k) Hmax[k] = H[k];
            // early stop AFTER recording this row (ksw.c:205)
            if (gmax >= endsc) break;
        }
    }

    // qe: the smallest j attaining the Hmax row's max (which is gmax);
    // -1 when it is 0
    int lq = INT_MAX;
#pragma unroll
    for (int k = S - 1; k >= 0; --k)
        if (Hmax[k] == gmax) lq = j0 + k;
    lq = __reduce_min_sync(ARACHNE_FULL_MASK, lq);
    if (lane != 0) return;
    const int qe = gmax > 0 ? lq : -1;

    // score2_scan (sw_local.py:138-201): the b-array merge automaton with
    // its one-row memory, emitting entries in creation order; the second
    // best is the first strict maximum outside [te - rng, te + rng]
    const int rng = (gmax + max_mat - 1) / max_mat;
    const int low = te - rng, high = te + rng;
    bool qual_prev = false, absorb_prev = false, open = false;
    int ent_val = 0, ent_row = -1, best2 = -1, te2 = -1;
    for (int r = 0; r < tlen; ++r) {
        const int v = r < nrows ? rowmax[r] : 0;
        const bool qual = v >= minsc;
        const bool start = qual && (!qual_prev || absorb_prev);
        const bool cont = qual && qual_prev && !absorb_prev;
        const bool improve = cont && v > ent_val;
        if (start && open && (ent_row < low || ent_row > high) && ent_val > best2) {
            best2 = ent_val;
            te2 = ent_row;
        }
        if (start || improve) {
            ent_val = v;
            ent_row = r;
        }
        open = open || start;
        qual_prev = qual;
        absorb_prev = cont && !improve;
    }
    if (open && (ent_row < low || ent_row > high) && ent_val > best2) {
        best2 = ent_val;
        te2 = ent_row;
    }
    out[0 * B + b] = gmax;
    out[1 * B + b] = te;
    out[2 * B + b] = qe;
    out[3 * B + b] = best2;
    out[4 * B + b] = te2;
}

template <int S>
int launch_local(
    const void* qs, const void* ts, const void* qlens, const void* tlens,
    const void* endscs, const void* minscs, const void* mat, int B, int qmax,
    int tmax, int o_del, int e_del, int o_ins, int e_ins, int max_mat,
    void* out, cudaStream_t stream)
{
    // each warp keeps tmax row maxima: fewer warps per block when that
    // passes the 227 KB a block may use
    const size_t per_warp = (size_t)(tmax > 0 ? tmax : 1) * sizeof(int);
    int warps = ARACHNE_WARPS;
    while (warps > 1 && warps * per_warp > ARACHNE_MAX_DYN_SMEM) --warps;
    const size_t smem = warps * per_warp;
    if (smem > ARACHNE_MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            local_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (B + warps - 1) / warps;
    local_kernel<S><<<blocks, warps * 32, smem, stream>>>(
        (const int8_t*)qs, (const int8_t*)ts, (const int*)qlens, (const int*)tlens,
        (const int*)endscs, (const int*)minscs, (const int*)mat, B, qmax, tmax,
        o_del, e_del, o_ins, e_ins, max_mat, (int*)out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int arachne_local(
    const void* qs, const void* ts, const void* qlens, const void* tlens,
    const void* endscs, const void* minscs, const void* mat, int B, int qmax,
    int tmax, int o_del, int e_del, int o_ins, int e_ins, int max_mat,
    void* out, void* stream)
{
    if (B <= 0) return 0;
    ARACHNE_STRIP_DISPATCH(arachne_strip(qmax), launch_local,
                           qs, ts, qlens, tlens, endscs, minscs, mat, B, qmax, tmax,
                           o_del, e_del, o_ins, e_ins, max_mat, out, (cudaStream_t)stream);
}
