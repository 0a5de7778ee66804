// S1 and S3: the SMEM seeding state machines, one thread per read.
//
// S1 (arachne_smem_pass) replaces the jitted XLA while-loop
// arachne_tpu/ops/fm_seed.py::_smem_pass_program (passes 1 and 2 of
// mem_collect_intv: bwt_smem1a sweeps along the pivot chain, or one sweep
// from a given pivot); S3 (arachne_seed_pass3) replaces _pass3_program
// (bwt_seed_strategy1).  Their plain versions are the lockstep translations
// arachne_tpu_torch/ops/fm_seed.py::smem_pass_torch and pass3_torch.
//
// The reference advances every read by one step per loop iteration, in
// lockstep, until all are done or a step cap is reached.  Reads never
// interact and a finished read's state never changes, so a thread that runs
// its own read's steps with the same per-read cap (16 * L + 64 for S1,
// 8 * L + 64 for S3, L the padded width) writes the same out, out_n and
// overflow.  Each step keeps the reference's order: in one step a read may
// find its pivot, start a forward sweep and take a forward step, and turn
// backward and take a backward step.  The backward step extends only the
// carried intervals that exist (the reference extends all MAXC, masked).
//
// What bounds them on an H100: two dependent occ4 gathers (rank.cuh) per
// forward step and per carried interval per backward step; with one read
// per thread the warps wait on memory latency, and reads of a warp diverge.
// The per-read buffers (curr, prev, the sweep's SMEMs) live in a global
// workspace sized by the runtime MAXC and MAXS, interleaved across reads so
// that a warp touching the same slot reads consecutive words.  Backward
// steps swap curr and prev instead of copying.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int PH_PIVOT = 0;   // looking for the next pivot
constexpr int PH_FWD = 1;     // forward sweep
constexpr int PH_BACK = 2;    // backward sweep
constexpr int PH_DONE = 3;

template <typename T>
struct Tables {
    const T* occ;
    const uint32_t* words;
    T L2[5];
    T primary;
    T seq_len;

    __device__ void occ4(T k, T (&out)[4]) const {
        arachne_occ4<T>(occ, words, L2, primary, seq_len, k, out);
    }

    // bwt_extend (bwt.c:262-275) of interval (x0, x1, x2), keeping only
    // the result for base c: forward for is_back false, else backward.
    __device__ void extend(T x0, T x1, T x2, bool is_back, int c,
                           T& r0, T& r1, T& rs) const {
        const T xb = is_back ? x0 : x1;
        T tk[4], tl[4];
        occ4(xb - 1, tk);
        occ4(xb - 1 + x2, tl);
        const T hit = (xb <= primary && xb + x2 - 1 >= primary) ? 1 : 0;
        T o = (is_back ? x1 : x0) + hit;
        for (int d = 3; d > c; --d) o += tl[d] - tk[d];
        const T b = L2[c] + 1 + tk[c];
        r0 = is_back ? b : o;
        r1 = is_back ? o : b;
        rs = tl[c] - tk[c];
    }
};

template <typename T>
__device__ Tables<T> load_tables(const T* occ, const uint32_t* words, const T* L2,
                                 long long primary, long long seq_len) {
    Tables<T> fm;
    fm.occ = occ;
    fm.words = words;
    for (int c = 0; c < 5; ++c) fm.L2[c] = L2[c];
    fm.primary = (T)primary;
    fm.seq_len = (T)seq_len;
    return fm;
}

// One read's buffer of F-field slots in the workspace: slot s, field f at
// p[(s * F + f) * stride], stride the number of reads.
template <typename T, int F>
struct Slots {
    T* p;
    size_t stride;
    __device__ T& operator()(int s, int f) const { return p[((size_t)s * F + f) * stride]; }
};

// q[x], or 4 (N) outside [0, qlen)
template <typename T>
__device__ __forceinline__ int code_at(const int8_t* q, T qlen, T x) {
    return (x >= 0 && x < qlen) ? (int)q[x] : 4;
}

template <typename T>
__global__ void smem_pass_kernel(
    const T* __restrict__ occ, const uint32_t* __restrict__ words,
    const T* __restrict__ L2, long long primary, long long seq_len,
    const int8_t* __restrict__ qs, const int* __restrict__ qlens,
    const int* __restrict__ pivots0, const int* __restrict__ min_intvs,
    int single_sweep, int R, int L, int MAXC, int MAXS, T* __restrict__ ws,
    T* __restrict__ out, T* __restrict__ out_n, bool* __restrict__ overflow)
{
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const Tables<T> fm = load_tables<T>(occ, words, L2, primary, seq_len);
    const int8_t* q = qs + (size_t)r * L;
    const T qlen = qlens[r];
    const T min_intv = min_intvs[r];
    T* o = out + (size_t)r * MAXS * 5;

    Slots<T, 4> curr{ws + r, (size_t)R};
    Slots<T, 4> prev{ws + (size_t)R * 4 * MAXC + r, (size_t)R};
    // this sweep's SMEMs, qb descending
    const Slots<T, 5> mem{ws + (size_t)R * 8 * MAXC + r, (size_t)R};
    int curr_n = 0, prev_n = 0, mem_n = 0, n_out = 0;
    bool ovf = false;
    int phase = PH_PIVOT;
    T x = pivots0[r];
    T pivot = x;
    T i = 0;
    T ik[4] = {0, 0, 0, 0};   // k, l, s, info

    auto push_curr = [&](T a, T b, T s, T info) {
        if (curr_n >= MAXC) {
            ovf = true;
        } else {
            curr(curr_n, 0) = a; curr(curr_n, 1) = b;
            curr(curr_n, 2) = s; curr(curr_n, 3) = info;
            ++curr_n;
        }
    };

    const int cap = 16 * L + 64;
    for (int step = 0; step < cap && phase != PH_DONE; ++step) {
        // ---- pivot: skip Ns, finish at the end, or start a forward sweep
        if (phase == PH_PIVOT) {
            pivot = x;
            const int c = code_at(q, qlen, x);
            if (x >= qlen) {
                phase = PH_DONE;
            } else if (c >= 4) {
                x += 1;
            } else {
                ik[0] = fm.L2[c] + 1;
                ik[1] = fm.L2[3 - c] + 1;
                ik[2] = fm.L2[c + 1] - fm.L2[c];
                ik[3] = x + 1;
                i = x + 1;
                curr_n = 0;
                mem_n = 0;
                phase = PH_FWD;
            }
        }
        // ---- one forward step
        if (phase == PH_FWD) {
            const int ci = code_at(q, qlen, i);
            const bool terminal = i >= qlen || ci >= 4;
            bool to_back = terminal;
            if (terminal) {
                push_curr(ik[0], ik[1], ik[2], ik[3]);
            } else {
                T n0, n1, ns;
                fm.extend(ik[0], ik[1], ik[2], false, 3 - ci, n0, n1, ns);
                const bool changed = ns != ik[2];
                if (changed) push_curr(ik[0], ik[1], ik[2], ik[3]);
                if (changed && ns < min_intv) {
                    to_back = true;   // too small
                } else {
                    ik[0] = n0; ik[1] = n1; ik[2] = ns; ik[3] = i + 1;
                    i += 1;
                    if (i >= qlen) {   // reached the end: push the final interval
                        push_curr(ik[0], ik[1], ik[2], ik[3]);
                        to_back = true;
                    }
                }
            }
            if (to_back) {
                // prev = curr reversed; the next pivot is the last push's info
                const int last = min(max(curr_n - 1, 0), MAXC - 1);
                x = curr(last, 3);
                for (int t = 0; t < curr_n; ++t)
                    for (int f = 0; f < 4; ++f) prev(t, f) = curr(curr_n - 1 - t, f);
                prev_n = curr_n;
                i = pivot - 1;
                phase = PH_BACK;
            }
        }
        // ---- one backward step over the carried intervals
        if (phase == PH_BACK) {
            const int cb = code_at(q, qlen, i);
            const bool c_ok = i >= 0 && cb < 4;
            int ncurr = 0;        // the new intervals go to curr
            T last_s = -1;
            for (int j = 0; j < prev_n; ++j) {
                const T pj[4] = {prev(j, 0), prev(j, 1), prev(j, 2), prev(j, 3)};
                T nb0 = 0, nb1 = 0, nbs = 0;
                bool keep = true;
                if (c_ok) {
                    fm.extend(pj[0], pj[1], pj[2] > 0 ? pj[2] : 0, true, cb, nb0, nb1, nbs);
                    keep = nbs < min_intv;
                }
                if (keep) {
                    // an SMEM ends here unless a longer one already covers it
                    const bool no_contain =
                        mem_n == 0 || i + 1 < mem(min(mem_n - 1, MAXS - 1), 3);
                    if (ncurr == 0 && no_contain) {
                        if (mem_n >= MAXS) {
                            ovf = true;
                        } else {
                            mem(mem_n, 0) = pj[0]; mem(mem_n, 1) = pj[1];
                            mem(mem_n, 2) = pj[2]; mem(mem_n, 3) = i + 1;
                            mem(mem_n, 4) = pj[3];
                            ++mem_n;
                        }
                    }
                } else if (ncurr == 0 || nbs != last_s) {
                    if (ncurr >= MAXC) {
                        ovf = true;
                    } else {
                        curr(ncurr, 0) = nb0; curr(ncurr, 1) = nb1;
                        curr(ncurr, 2) = nbs; curr(ncurr, 3) = pj[3];
                        ++ncurr;
                    }
                    last_s = nbs;
                }
            }
            if (ncurr != 0 && i >= 0) {
                const Slots<T, 4> tmp = prev;   // the new intervals become prev
                prev = curr;
                curr = tmp;
                prev_n = ncurr;
                i -= 1;
            } else {
                // sweep done: append its SMEMs in ascending qb, as far as
                // they fit
                for (int t = 0; t < mem_n && n_out + t < MAXS; ++t)
                    for (int f = 0; f < 5; ++f)
                        o[(size_t)(n_out + t) * 5 + f] = mem(mem_n - 1 - t, f);
                if (n_out + mem_n > MAXS) ovf = true;
                n_out = min(n_out + mem_n, MAXS);
                phase = single_sweep ? PH_DONE : PH_PIVOT;
            }
        }
    }
    out_n[r] = (T)n_out;
    overflow[r] = ovf;
}

template <typename T>
__global__ void pass3_kernel(
    const T* __restrict__ occ, const uint32_t* __restrict__ words,
    const T* __restrict__ L2, long long primary, long long seq_len,
    const int8_t* __restrict__ qs, const int* __restrict__ qlens,
    long long min_seed_len, long long max_intv, int R, int L, int MAXS,
    T* __restrict__ out, T* __restrict__ out_n, bool* __restrict__ overflow)
{
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const Tables<T> fm = load_tables<T>(occ, words, L2, primary, seq_len);
    const int8_t* q = qs + (size_t)r * L;
    const T qlen = qlens[r];
    T* o = out + (size_t)r * MAXS * 5;

    T x = 0, i = 0;
    T ik[3] = {0, 0, 0};
    bool scanning = false, done = false, ovf = false;
    int n_out = 0;
    const int cap = 8 * L + 64;
    for (int step = 0; step < cap && !done; ++step) {
        // idle: look for the next pivot
        if (!scanning) {
            const int cx = code_at(q, qlen, x);
            if (x >= qlen) {
                done = true;
            } else if (cx >= 4) {
                x += 1;
            } else {
                ik[0] = fm.L2[cx] + 1;
                ik[1] = fm.L2[3 - cx] + 1;
                ik[2] = fm.L2[cx + 1] - fm.L2[cx];
                i = x + 1;
                scanning = true;
            }
        }
        // scanning: one forward step
        if (scanning) {
            const int ci = code_at(q, qlen, i);
            const bool at_end = i >= qlen;
            const bool hit_n = !at_end && ci >= 4;
            bool emit = false;
            if (!at_end && !hit_n) {
                T n0, n1, ns;
                fm.extend(ik[0], ik[1], ik[2], false, 3 - ci, n0, n1, ns);
                emit = ns < (T)max_intv && i - x >= (T)min_seed_len;
                if (emit && ns > 0) {
                    if (n_out >= MAXS) {
                        ovf = true;
                    } else {
                        T* e = o + (size_t)n_out * 5;
                        e[0] = n0; e[1] = n1; e[2] = ns; e[3] = x; e[4] = i + 1;
                        ++n_out;
                    }
                }
                if (!emit) {
                    ik[0] = n0; ik[1] = n1; ik[2] = ns;
                    i += 1;
                }
            }
            if (at_end || hit_n || emit) {
                x = at_end ? qlen : i + 1;
                scanning = false;
            }
        }
    }
    out_n[r] = (T)n_out;
    overflow[r] = ovf;
}

constexpr int SEED_THREADS = 64;

}  // namespace

// qs (R, L) int8 codes; qlens, pivots0, min_intvs (R,) int32; ws a
// workspace of R * (8 * MAXC + 5 * MAXS) elements, out (R, MAXS, 5) and
// out_n (R,), all in the tables' row type (int64 when wide != 0); overflow
// (R,) bool.  out must be zeroed: only the SMEMs found are written.
extern "C" int arachne_smem_pass(
    const void* occ, const void* words, const void* L2, long long primary,
    long long seq_len, int wide, const void* qs, const void* qlens,
    const void* pivots0, const void* min_intvs, int single_sweep, int R, int L,
    int MAXC, int MAXS, void* ws, void* out, void* out_n, void* overflow, void* stream)
{
    if (R <= 0) return 0;
    if (MAXC < 1 || MAXS < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (R + SEED_THREADS - 1) / SEED_THREADS;
    cudaStream_t s = (cudaStream_t)stream;
    if (wide) {
        smem_pass_kernel<long long><<<blocks, SEED_THREADS, 0, s>>>(
            (const long long*)occ, (const uint32_t*)words, (const long long*)L2, primary,
            seq_len, (const int8_t*)qs, (const int*)qlens, (const int*)pivots0,
            (const int*)min_intvs, single_sweep, R, L, MAXC, MAXS, (long long*)ws,
            (long long*)out, (long long*)out_n, (bool*)overflow);
    } else {
        smem_pass_kernel<int><<<blocks, SEED_THREADS, 0, s>>>(
            (const int*)occ, (const uint32_t*)words, (const int*)L2, primary, seq_len,
            (const int8_t*)qs, (const int*)qlens, (const int*)pivots0,
            (const int*)min_intvs, single_sweep, R, L, MAXC, MAXS, (int*)ws, (int*)out,
            (int*)out_n, (bool*)overflow);
    }
    return (int)cudaGetLastError();
}

extern "C" int arachne_seed_pass3(
    const void* occ, const void* words, const void* L2, long long primary,
    long long seq_len, int wide, const void* qs, const void* qlens,
    long long min_seed_len, long long max_intv, int R, int L, int MAXS,
    void* out, void* out_n, void* overflow, void* stream)
{
    if (R <= 0) return 0;
    if (MAXS < 1) return (int)cudaErrorInvalidValue;
    const int blocks = (R + SEED_THREADS - 1) / SEED_THREADS;
    cudaStream_t s = (cudaStream_t)stream;
    if (wide) {
        pass3_kernel<long long><<<blocks, SEED_THREADS, 0, s>>>(
            (const long long*)occ, (const uint32_t*)words, (const long long*)L2, primary,
            seq_len, (const int8_t*)qs, (const int*)qlens, min_seed_len, max_intv, R, L,
            MAXS, (long long*)out, (long long*)out_n, (bool*)overflow);
    } else {
        pass3_kernel<int><<<blocks, SEED_THREADS, 0, s>>>(
            (const int*)occ, (const uint32_t*)words, (const int*)L2, primary, seq_len,
            (const int8_t*)qs, (const int*)qlens, min_seed_len, max_intv, R, L, MAXS,
            (int*)out, (int*)out_n, (bool*)overflow);
    }
    return (int)cudaGetLastError();
}
