// occ4 of one BWT row: the device routine of kernel K5 (rank.cu), inlined
// into the seeding state machines S1 and S3 (seed.cu).
//
// Layout (arachne_tpu/index/build.py, uploaded as it is): occ holds the
// checkpoint counts of A, C, G, T before each 128-base block, one row of
// four T per block; words holds the BWT at 16 bases per uint32, first base
// in the top two bits, eight words per block.  T is int for indexes under
// 2^31 rows and long long above (the wide tables).  The launchers check
// that occ and words start on 16 bytes, so a block's words are two aligned
// 16-byte vectors and its checkpoint row one (int) or two (long long).
//
// What bounds it on an H100: one random gather per query, two sectors that
// do not depend on each other (the block's 32 bytes of words and its 16- or
// 32-byte checkpoint row).  A table of a few MB stays in the 50 MB L2; a
// GRCh38-sized one (about 3.1 GB) does not, and each query then waits on
// HBM.
//
// Design: a query is split into its loads and arachne_occ4_count, which
// counts them without a branch.  K5 loads into registers
// (arachne_occ4_load: three or four 16-byte loads, all before the first
// use).  A caller that needs several queries at once (an extend needs two,
// S1's backward step two per carried interval) stages them
// (arachne_occ4_stage, arachne_cp_wait, arachne_occ4_staged), so that all
// their loads are in flight together and the queries cost one round trip,
// not one each.
#pragma once

#include <cstdint>

// The bytes one occ4 query needs, as they arrive.
template <typename T>
struct ArachneOcc4Row {
    uint4 w0, w1;   // the block's words 0-3 and 4-7
    T base[4];      // checkpoint counts of A, C, G, T before the block
    T k;            // the queried row
    int j;          // the row's base within its block (of the clamped row)
};

// The clamped row of a query, k - (k >= primary) within [0, seq_len - 1],
// as the reference takes it, so that every load is in bounds whatever k
// is; the k == -1 and k == seq_len edges are settled by arachne_occ4_count.
template <typename T>
__device__ __forceinline__ T arachne_occ4_row(T primary, T seq_len, T k) {
    const T kk = k - (k >= primary ? 1 : 0);
    return kk < 0 ? 0 : (kk > seq_len - 1 ? seq_len - 1 : kk);
}

__device__ __forceinline__ long long arachne_join64(uint32_t lo, uint32_t hi) {
    return (long long)(((unsigned long long)hi << 32) | lo);
}

// The checkpoint row from its one (int) or two (long long) 16-byte chunks.
template <typename T>
__device__ __forceinline__ void arachne_set_base(ArachneOcc4Row<T>& r, uint4 a, uint4 b) {
    if constexpr (sizeof(T) == 4) {
        r.base[0] = (int)a.x; r.base[1] = (int)a.y; r.base[2] = (int)a.z; r.base[3] = (int)a.w;
    } else {
        r.base[0] = arachne_join64(a.x, a.y); r.base[1] = arachne_join64(a.z, a.w);
        r.base[2] = arachne_join64(b.x, b.y); r.base[3] = arachne_join64(b.z, b.w);
    }
}

// Load Occ(k, .)'s bytes into registers (K5: one query a thread, nothing
// to wait on but its own loads).
template <typename T>
__device__ __forceinline__ ArachneOcc4Row<T> arachne_occ4_load(
    const T* __restrict__ occ, const uint32_t* __restrict__ words, T primary, T seq_len, T k)
{
    const T kk = arachne_occ4_row(primary, seq_len, k);
    const T block = kk >> 7;
    ArachneOcc4Row<T> r;
    const uint4* w = reinterpret_cast<const uint4*>(words + block * 8);
    const uint4* c = reinterpret_cast<const uint4*>(occ + block * 4);
    r.w0 = __ldg(w);
    r.w1 = __ldg(w + 1);
    arachne_set_base(r, __ldg(c), sizeof(T) == 4 ? make_uint4(0, 0, 0, 0) : __ldg(c + 1));
    r.k = k;
    r.j = (int)(kk & 127);
    return r;
}

// ---- Staged queries (S1, S3).  A thread that needs several queries at
// once copies their bytes into shared memory with cp.async and waits for
// all of them once.  Ordinary loads would not do: the compiler sinks a load
// to its first use, into the branch that uses it or past another query's
// count, and each query would cost a round trip again; a copy cannot be
// moved past the wait, and its bytes hold no registers while in flight.

// 16-byte chunks of a query: the block's words (two), then its checkpoint
// row (one for int, two for long long)
template <typename T>
__host__ __device__ constexpr int arachne_occ4_chunks() { return sizeof(T) == 4 ? 3 : 4; }

// A thread's chunks: chunk q at p[q * stride], the block's threads side by
// side, so that a warp's accesses to one chunk index hit distinct banks.
struct ArachneStage {
    uint4* p;
    int stride;
    __device__ __forceinline__ uint4* at(int q) const { return p + q * stride; }
};

// What a staged query keeps in registers until its chunks arrive.
template <typename T>
struct ArachneOcc4Ref {
    T k;
    int j;
};

__device__ __forceinline__ void arachne_cp16(uint4* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

// Wait for every copy this thread has issued.
__device__ __forceinline__ void arachne_cp_wait() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ ArachneOcc4Ref<T> arachne_occ4_ref(T primary, T seq_len, T k) {
    return {k, (int)(arachne_occ4_row(primary, seq_len, k) & 127)};
}

// Issue the copies of Occ(k, .) into chunks q0.. of the stage.
template <typename T>
__device__ __forceinline__ void arachne_occ4_stage(
    const T* __restrict__ occ, const uint32_t* __restrict__ words, T primary, T seq_len, T k,
    const ArachneStage& st, int q0)
{
    const T block = arachne_occ4_row(primary, seq_len, k) >> 7;
    arachne_cp16(st.at(q0), words + block * 8);
    arachne_cp16(st.at(q0 + 1), words + block * 8 + 4);
    arachne_cp16(st.at(q0 + 2), occ + block * 4);
    if constexpr (sizeof(T) == 8) arachne_cp16(st.at(q0 + 3), occ + block * 4 + 2);
}

// A staged query's bytes, after arachne_cp_wait.
template <typename T>
__device__ __forceinline__ ArachneOcc4Row<T> arachne_occ4_staged(
    const ArachneStage& st, int q0, ArachneOcc4Ref<T> ref)
{
    ArachneOcc4Row<T> r;
    r.w0 = *st.at(q0);
    r.w1 = *st.at(q0 + 1);
    arachne_set_base(r, *st.at(q0 + 2), sizeof(T) == 4 ? make_uint4(0, 0, 0, 0) : *st.at(q0 + 3));
    r.k = ref.k;
    r.j = ref.j;
    return r;
}

// The C, G and T bits of word v: lo holds each base's low bit, hi its high
// bit, both at the low bit of the base's two (C = 01, G = 10, T = 11).
__device__ __forceinline__ void arachne_base_bits(uint32_t v, uint32_t& lo, uint32_t& hi) {
    lo = v & 0x55555555u;
    hi = (v >> 1) & 0x55555555u;
}

// Occ(k, c) for c = 0..3 (bwt.c:107-186, arachne_tpu/ops/fm_rank.py:88):
// k == -1 -> 0; k == seq_len -> L2[c+1] - L2[c]; otherwise the checkpoint
// row plus the bases 0..j of the block.  Words below j's word count whole,
// j's word keeps its bases 0..j & 15, the words above it count nothing:
// each word is masked by a select, never by a branch.  The masked-off bases
// read as A (00) and carry no C, G or T bit, so C, G and T are counted and
// A is the rest of the j + 1 bases, which is what the reference's count of
// A less its 127 - j masked-off bases comes to.  Two words' bit planes
// share one popcount (one shifted onto the odd bits).
template <typename T>
__device__ __forceinline__ void arachne_occ4_count(
    const ArachneOcc4Row<T>& r, const T (&L2)[5], T seq_len, T (&out)[4])
{
    const int wi = r.j >> 4;    // the word holding the row
    const int p = r.j & 15;     // its base within that word
    // keep bases 0..p: the shift is 2 * (15 - p) <= 30, so the undefined
    // 32-bit shift of the reference's nvalid == 0 case never arises
    const uint32_t part = ~((1u << (2 * (15 - p))) - 1u);
    const uint32_t y[8] = {r.w0.x, r.w0.y, r.w0.z, r.w0.w, r.w1.x, r.w1.y, r.w1.z, r.w1.w};
    int c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
    for (int x = 0; x < 8; x += 2) {
        const uint32_t ma = x < wi ? 0xffffffffu : (x == wi ? part : 0u);
        const uint32_t mb = x + 1 < wi ? 0xffffffffu : (x + 1 == wi ? part : 0u);
        uint32_t loa, hia, lob, hib;
        arachne_base_bits(y[x] & ma, loa, hia);
        arachne_base_bits(y[x + 1] & mb, lob, hib);
        const uint32_t lo = loa | (lob << 1), hi = hia | (hib << 1);
        const int t = __popc(lo & hi);
        c3 += t;
        c2 += __popc(hi) - t;
        c1 += __popc(lo) - t;
    }
    const int cnt[4] = {r.j + 1 - c1 - c2 - c3, c1, c2, c3};
    const bool at_end = r.k == seq_len, before = r.k == -1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const T v = r.base[c] + (T)cnt[c];
        out[c] = at_end ? L2[c + 1] - L2[c] : (before ? (T)0 : v);
    }
}

template <typename T>
__device__ __forceinline__ void arachne_occ4(
    const T* __restrict__ occ, const uint32_t* __restrict__ words,
    const T (&L2)[5], T primary, T seq_len, T k, T (&out)[4])
{
    arachne_occ4_count<T>(arachne_occ4_load<T>(occ, words, primary, seq_len, k), L2, seq_len, out);
}
