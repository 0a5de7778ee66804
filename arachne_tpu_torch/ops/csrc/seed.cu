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
// What bounds them on an H100: a chain of dependent extends per read (about
// 150 forward ones for a read of 150 bases, each needing the last), each a
// round trip to the L2 for two occ4 queries (rank.cuh) and ~250
// instructions of counting and bookkeeping.  A superbatch of 8192 reads is
// only 256 warps, about one per SM partition, so nothing hides either and a
// launch lasts as long as its slowest warp's chain.  The design makes each
// link of the chain one round trip and keeps a warp's threads on one path:
//   * the occ4 queries of a round are copied into shared memory with
//     cp.async and waited for once (rank.cuh: the compiler may not sink a
//     copy to its use, as it sinks an ordinary load into the branch that
//     uses it);
//   * S1 runs in rounds: a forward step's extend, or the next SEED_GROUP
//     carried intervals of a backward step, whose copies all go out before
//     the reference's bookkeeping runs over them in order.  Both kinds of
//     round go through the same code, so that a warp whose threads are in
//     different phases pays one round, not a forward and a backward one, and
//     a thread goes on to its next round as soon as its last one is done;
//   * a round issues its copies before it reads the query's code byte,
//     which they do not need (a terminal step's copies are dropped);
//   * a run-time index into a small array is a chain of selects (pick), so
//     that no array goes to local memory.
// What is left is the counting: a warp iteration counts the largest group
// among its threads one extend after another, so groups larger than two
// cost more than the round trips they save (PERF.md).  The per-read buffers
// (two of carried intervals, the sweep's SMEMs) live in a global workspace
// sized by the run-time MAXC and MAXS, interleaved across reads so that a
// warp touching the same slot moves consecutive chunks.  The two interval
// buffers swap roles: a forward sweep pushes into one, the backward steps
// read it in reverse (no copy) and write the next step's intervals into the
// other.  Both kernels take the record table as one array (arachne_smem_pass,
// arachne_seed_pass3) or split across cards (the _sharded entry points,
// rank.cuh's ArachneShardedTable); only the address of a record differs.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int SEED_GROUP = 2;     // carried intervals per round
constexpr int SEED_THREADS = 32;  // reads per block

constexpr int PH_PIVOT = 0;   // looking for the next pivot
constexpr int PH_FWD = 1;     // forward sweep
constexpr int PH_BACK = 2;    // backward sweep
constexpr int PH_DONE = 3;

// a[i] for a run-time i, by selects: indexing a register array with a
// run-time index would put the array in local memory
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
    T v = a[0];
#pragma unroll
    for (int t = 1; t < N; ++t) v = i == t ? a[t] : v;
    return v;
}

template <typename T, typename Table>
struct Tables {
    Table table;          // the record table (rank.cuh)
    T L2[5];
    T primary;
    T seq_len;

    // chunks of the stage one extend takes
    static constexpr int CHUNKS = 2 * arachne_occ4_chunks<T>();

    // Issue the copies of one bwt_extend (bwt.c:262-275) from edge row xb
    // of an interval of size x2 (occ4 at xb - 1 and at xb - 1 + x2) into
    // chunks q0 .. q0 + CHUNKS - 1.
    __device__ __forceinline__ void issue(T xb, T x2, const ArachneStage& st, int q0) const {
        arachne_occ4_stage<T>(table, primary, seq_len, xb - 1, st, q0);
        arachne_occ4_stage<T>(table, primary, seq_len, xb - 1 + x2, st, q0 + CHUNKS / 2);
    }

    // The extend's result for base c, once its copies have arrived:
    // forward (is_back false, xb = l, xo = k) or backward (xb = k, xo = l).
    __device__ __forceinline__ void finish(const ArachneStage& st, int q0, T xb, T x2, T xo,
                                           bool is_back, int c, T& r0, T& r1, T& rs) const {
        T tk[4], tl[4];
        arachne_occ4_count<T>(
            arachne_occ4_staged<T>(st, q0, arachne_occ4_ref<T>(primary, seq_len, xb - 1)),
            L2, seq_len, tk);
        arachne_occ4_count<T>(
            arachne_occ4_staged<T>(st, q0 + CHUNKS / 2,
                                   arachne_occ4_ref<T>(primary, seq_len, xb - 1 + x2)),
            L2, seq_len, tl);
        const T hit = (xb <= primary && xb + x2 - 1 >= primary) ? 1 : 0;
        T o = xo + hit;
#pragma unroll
        for (int d = 1; d < 4; ++d) o += d > c ? tl[d] - tk[d] : (T)0;
        const T kc = pick(tk, c);
        const T b = pick(L2, c) + 1 + kc;
        r0 = is_back ? b : o;
        r1 = is_back ? o : b;
        rs = pick(tl, c) - kc;
    }

    // the interval of base c alone: k, l and s of bwt_set_intv
    __device__ __forceinline__ void base_interval(int c, T (&ik)[4]) const {
        const T lc = pick(L2, c);
        ik[0] = lc + 1;
        ik[1] = pick(L2, 3 - c) + 1;
        ik[2] = pick(L2, c + 1) - lc;
    }
};

template <typename T, typename Table>
__device__ Tables<T, Table> load_tables(const Table& table, const T* L2, long long primary,
                                        long long seq_len) {
    Tables<T, Table> fm;
    fm.table = table;
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

// One read's buffer of intervals (k, l, s, info) in the workspace: slot s
// at p[s * stride * 4], its four values side by side (one 16-byte chunk for
// int, two for long long, ``half`` chunks apart), the reads' slots
// interleaved so that a warp touching one slot moves consecutive chunks.
// With stride 0 and half the block's width, the same accessors read and
// write a thread's chunks in the stage.
template <typename T>
struct Intervals {
    static constexpr int CHUNKS = sizeof(T) == 4 ? 1 : 2;
    T* p;
    size_t stride;
    size_t half;

    __device__ __forceinline__ uint4* at(int s) const {
        return reinterpret_cast<uint4*>(p + (size_t)s * stride * 4);
    }
    __device__ __forceinline__ void get(int s, T (&it)[4]) const {
        const uint4 a = at(s)[0];
        if constexpr (sizeof(T) == 4) {
            it[0] = (int)a.x; it[1] = (int)a.y; it[2] = (int)a.z; it[3] = (int)a.w;
        } else {
            const uint4 b = at(s)[half];
            it[0] = arachne_join64(a.x, a.y); it[1] = arachne_join64(a.z, a.w);
            it[2] = arachne_join64(b.x, b.y); it[3] = arachne_join64(b.z, b.w);
        }
    }
    __device__ __forceinline__ void put(int s, T a, T b, T c, T d) const {
        uint4* q = at(s);
        if constexpr (sizeof(T) == 4) {
            q[0] = make_uint4((uint32_t)a, (uint32_t)b, (uint32_t)c, (uint32_t)d);
        } else {
            q[0] = make_uint4((uint32_t)a, (uint32_t)((unsigned long long)a >> 32),
                              (uint32_t)b, (uint32_t)((unsigned long long)b >> 32));
            q[half] = make_uint4((uint32_t)c, (uint32_t)((unsigned long long)c >> 32),
                                 (uint32_t)d, (uint32_t)((unsigned long long)d >> 32));
        }
    }
};

// A thread's stage in S1: a round's copies (two queries an interval of the
// group), then the round's intervals.
template <typename T, int G>
__host__ __device__ constexpr int stage_chunks() {
    return G * (2 * arachne_occ4_chunks<T>() + Intervals<T>::CHUNKS);
}

// q[x], or 4 (N) outside [0, qlen)
template <typename T>
__device__ __forceinline__ int code_at(const int8_t* q, T qlen, T x) {
    return (x >= 0 && x < qlen) ? (int)q[x] : 4;
}

template <typename T, int G, typename Table, bool COUNT>
__global__ void __launch_bounds__(SEED_THREADS) smem_pass_kernel(
    const Table table, const T* __restrict__ L2, long long primary,
    long long seq_len,
    const int8_t* __restrict__ qs, const int* __restrict__ qlens,
    const int* __restrict__ pivots0, const int* __restrict__ min_intvs,
    int single_sweep, int R, int L, int MAXC, int MAXS, T* __restrict__ ws,
    T* __restrict__ out, T* __restrict__ out_n, bool* __restrict__ overflow,
    T* __restrict__ rows)
{
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const Tables<T, Table> fm = load_tables<T>(table, L2, primary, seq_len);
    extern __shared__ uint4 stage_mem[];
    const ArachneStage st{stage_mem + threadIdx.x, (int)blockDim.x};
    const int8_t* q = qs + (size_t)r * L;
    const T qlen = qlens[r];
    const T min_intv = min_intvs[r];
    T* o = out + (size_t)r * MAXS * 5;

    // curr receives intervals; prev holds those a backward step extends,
    // in reverse slot order right after a forward sweep (prev_rev)
    constexpr int CH = Tables<T, Table>::CHUNKS;
    constexpr int IC = Intervals<T>::CHUNKS;
    Intervals<T> curr{ws + (size_t)r * 4, (size_t)R, 1};
    Intervals<T> prev{ws + (size_t)R * 4 * MAXC + (size_t)r * 4, (size_t)R, 1};
    // this sweep's SMEMs, qb descending
    const Slots<T, 5> mem{ws + (size_t)R * 8 * MAXC + r, (size_t)R};
    int curr_n = 0, prev_n = 0, mem_n = 0, n_out = 0;
    // with COUNT, the occ4 rows the read needs (smem_pass_torch's
    // stats["rank_rows"]); the kernel without it is the one the main path
    // runs untraced, untouched by the counter
    int n_rows = 0;
    bool prev_rev = false, ovf = false;
    int phase = PH_PIVOT;
    T x = pivots0[r];
    T pivot = x;
    T i = 0;
    T ik[4] = {0, 0, 0, 0};   // k, l, s, info
    // the backward step under way: its base, the next carried interval to
    // extend, the intervals it has kept so far and the last one's size
    int cb = 4;
    bool c_ok = false;
    int j0 = 0, ncurr = 0;
    T last_s = -1;
    T last_qb = 0;     // qb of this sweep's last SMEM (mem(mem_n - 1, 3))
    T last_info = 0;   // info of the sweep's last interval pushed

    auto push_curr = [&](T a, T b, T s, T info) {
        if (curr_n >= MAXC) {
            ovf = true;
        } else {
            curr.put(curr_n, a, b, s, info);
            last_info = info;
            ++curr_n;
        }
    };
    auto begin_back_step = [&]() {
        cb = code_at(q, qlen, i);
        c_ok = i >= 0 && cb < 4;
        j0 = 0;
        ncurr = 0;
        last_s = -1;
    };
    // end of a forward sweep: prev = curr read in reverse, the next pivot
    // is the last push's info
    auto turn_back = [&]() {
        x = last_info;   // curr(min(curr_n, MAXC) - 1, 3): a sweep pushes at least once
        const Intervals<T> tmp = prev;
        prev = curr;
        curr = tmp;
        prev_n = curr_n;
        prev_rev = true;
        i = pivot - 1;
        phase = PH_BACK;
        begin_back_step();
    };

    // the round's g-th interval in the stage, after the copies' chunks
    auto stashed = [&](int g) {
        return Intervals<T>{reinterpret_cast<T*>(st.at(G * CH + g * IC)), 0,
                            (size_t)st.stride};
    };
    const int cap = 16 * L + 64;
    int step = 0;
    while (true) {
        // ---- what needs no rank query: pivots (a step each when an N is
        // skipped or the read ends; else the step goes on forward)
        while (phase == PH_PIVOT && step < cap) {
            pivot = x;
            const int c = code_at(q, qlen, x);
            if (x >= qlen) {
                phase = PH_DONE;
                ++step;
            } else if (c >= 4) {
                x += 1;
                ++step;
            } else {
                fm.base_interval(c, ik);
                ik[3] = x + 1;
                i = x + 1;
                curr_n = 0;
                mem_n = 0;
                phase = PH_FWD;
            }
        }
        if (phase == PH_DONE || step >= cap) break;

        // ---- one round: the forward step's extend, or the next group of
        // up to G carried intervals of the backward step.  Both go through
        // the same code, so that a warp whose threads are in different
        // phases pays one round, not a forward and a backward one.
        const bool fwd = phase == PH_FWD;
        const int n = fwd ? 1 : min(G, prev_n - j0);
        // the round's intervals, all loaded at once; a forward step's
        // extends from l, a backward one's from k with size >= 0; then
        // every copy of the round, whatever the base; the intervals wait in
        // the stage, after the copies' chunks, for the count loop
        T its[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (g < n) {
                if (fwd) {
                    for (int f = 0; f < 4; ++f) its[g][f] = ik[f];
                } else {
                    prev.get(prev_rev ? prev_n - 1 - (j0 + g) : j0 + g, its[g]);
                }
            }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (g < n) {
                const T (&it)[4] = its[g];
                fm.issue(fwd ? it[1] : it[0], fwd || it[2] > 0 ? it[2] : 0, st, g * CH);
                stashed(g).put(0, it[0], it[1], it[2], it[3]);
            }
        }
        const int ci = fwd ? code_at(q, qlen, i) : cb;
        arachne_cp_wait();
        const bool terminal = fwd && (i >= qlen || ci >= 4);
        const bool c_ok_now = fwd ? !terminal : c_ok;
        const int c = fwd ? 3 - (ci & 3) : (cb & 3);
        bool to_back = fwd;
#pragma unroll 1
        for (int g = 0; g < n; ++g) {
            T it[4];
            stashed(g).get(0, it);
            const T x2 = fwd || it[2] > 0 ? it[2] : 0;
            T n0 = 0, n1 = 0, ns = 0;
            fm.finish(st, g * CH, fwd ? it[1] : it[0], x2, fwd ? it[0] : it[1], !fwd, c,
                      n0, n1, ns);
            if constexpr (COUNT)   // an extend that counts (not a dropped copy)
                n_rows += c_ok_now ? 2 : 0;
            if (fwd) {
                // ---- the forward step
                if (terminal) {
                    push_curr(ik[0], ik[1], ik[2], ik[3]);
                } else {
                    const bool changed = ns != ik[2];
                    if (changed) push_curr(ik[0], ik[1], ik[2], ik[3]);
                    if (!(changed && ns < min_intv)) {   // not too small: advance
                        ik[0] = n0; ik[1] = n1; ik[2] = ns; ik[3] = i + 1;
                        i += 1;
                        to_back = i >= qlen;
                        if (to_back)   // reached the end: push the final interval
                            push_curr(ik[0], ik[1], ik[2], ik[3]);
                    }
                }
                continue;
            }
            // ---- a carried interval of the backward step, in order
            const bool keep = !c_ok_now || ns < min_intv;
            if (keep) {
                // an SMEM ends here unless a longer one already covers it
                const bool no_contain = mem_n == 0 || i + 1 < last_qb;
                if (ncurr == 0 && no_contain) {
                    if (mem_n >= MAXS) {
                        ovf = true;
                    } else {
                        mem(mem_n, 0) = it[0]; mem(mem_n, 1) = it[1];
                        mem(mem_n, 2) = it[2]; mem(mem_n, 3) = i + 1;
                        mem(mem_n, 4) = it[3];
                        ++mem_n;
                        last_qb = i + 1;
                    }
                }
            } else if (ncurr == 0 || ns != last_s) {
                if (ncurr >= MAXC) {
                    ovf = true;
                } else {
                    curr.put(ncurr, n0, n1, ns, it[3]);
                    ++ncurr;
                }
                last_s = ns;
            }
        }
        if (fwd) {
            // turning back, the step goes on with its backward part
            if (to_back)
                turn_back();
            else
                ++step;
            continue;
        }
        j0 += max(n, 0);
        if (j0 < prev_n) continue;   // more groups in this step
        if (ncurr != 0 && i >= 0) {
            // the new intervals become prev, in order
            const Intervals<T> tmp = prev;
            prev = curr;
            curr = tmp;
            prev_n = ncurr;
            prev_rev = false;
            i -= 1;
            begin_back_step();
        } else {
            // sweep done: append its SMEMs in ascending qb, as far as they
            // fit
            for (int t = 0; t < mem_n && n_out + t < MAXS; ++t)
                for (int f = 0; f < 5; ++f)
                    o[(size_t)(n_out + t) * 5 + f] = mem(mem_n - 1 - t, f);
            if (n_out + mem_n > MAXS) ovf = true;
            n_out = min(n_out + mem_n, MAXS);
            phase = single_sweep ? PH_DONE : PH_PIVOT;
        }
        ++step;
    }
    out_n[r] = (T)n_out;
    overflow[r] = ovf;
    if constexpr (COUNT) rows[r] = (T)n_rows;
}

template <typename T, typename Table, bool COUNT>
__global__ void __launch_bounds__(SEED_THREADS) pass3_kernel(
    const Table table, const T* __restrict__ L2, long long primary,
    long long seq_len,
    const int8_t* __restrict__ qs, const int* __restrict__ qlens,
    long long min_seed_len, long long max_intv, int R, int L, int MAXS,
    T* __restrict__ out, T* __restrict__ out_n, bool* __restrict__ overflow,
    T* __restrict__ rows)
{
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= R) return;
    const Tables<T, Table> fm = load_tables<T>(table, L2, primary, seq_len);
    extern __shared__ uint4 stage_mem[];
    const ArachneStage st{stage_mem + threadIdx.x, (int)blockDim.x};
    const int8_t* q = qs + (size_t)r * L;
    const T qlen = qlens[r];
    T* o = out + (size_t)r * MAXS * 5;

    T x = 0, i = 0;
    T ik[4] = {0, 0, 0, 0};   // k, l, s (and an unused info slot)
    bool scanning = false, done = false, ovf = false;
    int n_out = 0, n_rows = 0;   // with COUNT: pass3_torch's stats["rank_rows"]
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
                fm.base_interval(cx, ik);
                i = x + 1;
                scanning = true;
            }
        }
        // scanning: one forward step, its copies issued before the code
        // at i is read
        if (scanning) {
            fm.issue(ik[1], ik[2], st, 0);
            const int ci = code_at(q, qlen, i);
            arachne_cp_wait();
            const bool at_end = i >= qlen;
            const bool hit_n = !at_end && ci >= 4;
            bool emit = false;
            if (!at_end && !hit_n) {
                if constexpr (COUNT) n_rows += 2;
                T n0, n1, ns;
                fm.finish(st, 0, ik[1], ik[2], ik[0], false, 3 - ci, n0, n1, ns);
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
    if constexpr (COUNT) rows[r] = (T)n_rows;
}

// Launch kernel k (S1 or S3) with the stage it needs: ``chunks`` 16-byte
// chunks a thread.  Above 48 KB of shared memory a kernel must opt in
// first.
template <typename K, typename... A>
int launch_staged(K kernel, int chunks, int R, cudaStream_t s, A... args) {
    const size_t smem = (size_t)SEED_THREADS * chunks * sizeof(uint4);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(R + SEED_THREADS - 1) / SEED_THREADS, SEED_THREADS, smem, s>>>(args...);
    return (int)cudaGetLastError();
}

template <typename T, typename Table>
int launch_smem_pass(Table table, const void* L2, long long primary, long long seq_len,
                     const void* qs, const void* qlens, const void* pivots0,
                     const void* min_intvs, int single_sweep, int R, int L, int MAXC, int MAXS,
                     void* ws, void* out, void* out_n, void* overflow, void* rows,
                     void* stream)
{
    if (R <= 0) return 0;
    if (MAXC < 1 || MAXS < 1) return (int)cudaErrorInvalidValue;
    return launch_staged(
        rows ? smem_pass_kernel<T, SEED_GROUP, Table, true>
             : smem_pass_kernel<T, SEED_GROUP, Table, false>, stage_chunks<T, SEED_GROUP>(), R,
        (cudaStream_t)stream, table, (const T*)L2, primary, seq_len, (const int8_t*)qs,
        (const int*)qlens, (const int*)pivots0, (const int*)min_intvs, single_sweep, R, L, MAXC,
        MAXS, (T*)ws, (T*)out, (T*)out_n, (bool*)overflow, (T*)rows);
}

template <typename T, typename Table>
int launch_pass3(Table table, const void* L2, long long primary, long long seq_len,
                 const void* qs, const void* qlens, long long min_seed_len, long long max_intv,
                 int R, int L, int MAXS, void* out, void* out_n, void* overflow, void* rows,
                 void* stream)
{
    if (R <= 0) return 0;
    if (MAXS < 1) return (int)cudaErrorInvalidValue;
    return launch_staged(
        rows ? pass3_kernel<T, Table, true> : pass3_kernel<T, Table, false>,
        2 * arachne_occ4_chunks<T>(), R, (cudaStream_t)stream, table,
        (const T*)L2, primary, seq_len, (const int8_t*)qs, (const int*)qlens, min_seed_len,
        max_intv, R, L, MAXS, (T*)out, (T*)out_n, (bool*)overflow, (T*)rows);
}

}  // namespace

// qs (R, L) int8 codes; qlens, pivots0, min_intvs (R,) int32; ws a
// workspace of R * (8 * MAXC + 5 * MAXS) elements, out (R, MAXS, 5) and
// out_n (R,), all in the tables' row type (int64 when wide != 0); overflow
// (R,) bool; rows NULL, or (R,) in the row type, which receives each read's
// occ4 rows (the count smem_pass_torch's and pass3_torch's stats take).
// out must be zeroed: only the SMEMs found are written.  table is the
// record table and must start on 64 bytes (the launchers check it).
extern "C" int arachne_smem_pass(
    const void* table, const void* L2, long long primary, long long seq_len, int wide,
    const void* qs, const void* qlens,
    const void* pivots0, const void* min_intvs, int single_sweep, int R, int L,
    int MAXC, int MAXS, void* ws, void* out, void* out_n, void* overflow, void* rows,
    void* stream)
{
    const ArachneFlatTable t{(const uint4*)table};
    if (wide)
        return launch_smem_pass<long long>(t, L2, primary, seq_len, qs, qlens, pivots0,
                                           min_intvs, single_sweep, R, L, MAXC, MAXS, ws, out,
                                           out_n, overflow, rows, stream);
    return launch_smem_pass<int>(t, L2, primary, seq_len, qs, qlens, pivots0, min_intvs,
                                 single_sweep, R, L, MAXC, MAXS, ws, out, out_n, overflow,
                                 rows, stream);
}

// arachne_smem_pass on a table split across cards: shards and per as
// rank.cu's arachne_rank_sharded takes them.
extern "C" int arachne_smem_pass_sharded(
    const void* shards, long long per, const void* L2, long long primary, long long seq_len,
    int wide, const void* qs, const void* qlens,
    const void* pivots0, const void* min_intvs, int single_sweep, int R, int L,
    int MAXC, int MAXS, void* ws, void* out, void* out_n, void* overflow, void* rows,
    void* stream)
{
    const auto s = (const uint4* const*)shards;
    if (wide)
        return launch_smem_pass<long long>(ArachneShardedTable<long long>{s, per}, L2, primary,
                                           seq_len, qs, qlens, pivots0, min_intvs, single_sweep,
                                           R, L, MAXC, MAXS, ws, out, out_n, overflow, rows,
                                           stream);
    return launch_smem_pass<int>(ArachneShardedTable<int>{s, (int)per}, L2, primary, seq_len,
                                 qs, qlens, pivots0, min_intvs, single_sweep, R, L, MAXC, MAXS,
                                 ws, out, out_n, overflow, rows, stream);
}

extern "C" int arachne_seed_pass3(
    const void* table, const void* L2, long long primary, long long seq_len, int wide,
    const void* qs, const void* qlens,
    long long min_seed_len, long long max_intv, int R, int L, int MAXS,
    void* out, void* out_n, void* overflow, void* rows, void* stream)
{
    const ArachneFlatTable t{(const uint4*)table};
    if (wide)
        return launch_pass3<long long>(t, L2, primary, seq_len, qs, qlens, min_seed_len,
                                       max_intv, R, L, MAXS, out, out_n, overflow, rows, stream);
    return launch_pass3<int>(t, L2, primary, seq_len, qs, qlens, min_seed_len, max_intv, R, L,
                             MAXS, out, out_n, overflow, rows, stream);
}

extern "C" int arachne_seed_pass3_sharded(
    const void* shards, long long per, const void* L2, long long primary, long long seq_len,
    int wide, const void* qs, const void* qlens,
    long long min_seed_len, long long max_intv, int R, int L, int MAXS,
    void* out, void* out_n, void* overflow, void* rows, void* stream)
{
    const auto s = (const uint4* const*)shards;
    if (wide)
        return launch_pass3<long long>(ArachneShardedTable<long long>{s, per}, L2, primary,
                                       seq_len, qs, qlens, min_seed_len, max_intv, R, L, MAXS,
                                       out, out_n, overflow, rows, stream);
    return launch_pass3<int>(ArachneShardedTable<int>{s, (int)per}, L2, primary, seq_len, qs,
                             qlens, min_seed_len, max_intv, R, L, MAXS, out, out_n, overflow,
                             rows, stream);
}
