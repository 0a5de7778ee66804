// occ4 of one BWT row: the device routine of kernel K5 (rank.cu), inlined
// into the seeding state machines S1 and S3 (seed.cu).
//
// Layout (arachne_tpu_torch/ops/fm_rank.py DeviceFMIndex): one 64-byte
// record per 128-base block, as BWA interleaves its BWT (bwt.h:
// bwt_occ_intv): the checkpoint counts of A, C, G, T before the block
// first, then the block's eight words (16 bases per uint32, first base in
// the top two bits).  T is int for indexes under 2^31 rows and long long
// above (the wide tables).  int: counts in 16-byte chunk 0, words in
// chunks 1-2, chunk 3 padding.  long long: counts in chunks 0-1, words in
// chunks 2-3 (exactly BWA's record).  The launchers check that the table
// starts on 64 bytes, so a record is one aligned line, and a query reads
// its first 3 (int) or 4 (long long) 16-byte chunks.
//
// The table is one array on the launching card (ArachneFlatTable) or, for
// the block-sharded index (arachne_tpu_torch/parallel/mesh.py), split into
// contiguous ranges of ``per`` records, range s at shards[s], each on the
// card that holds it (ArachneShardedTable): a query loads its record from
// that card, over NVLink when it is another one.  The counts in a record
// are the whole index's, so the one range that holds a block answers a
// query alone and no sum across ranges is needed.  Every routine below
// takes either type; the two differ only in arachne_record.
//
// What bounds it on an H100: one random gather of one line per query.  A
// table of a few MB stays in the 50 MB L2; a GRCh38-sized one (about 3.1
// GB) does not, and each query then waits on HBM.  Counts and words in two
// arrays would cost each query two lines, in two DRAM pages.
//
// Design: a query is split into its loads and arachne_occ4_count, which
// counts them without a branch.  K5 with one thread per query loads into
// registers (arachne_occ4_load; its group of lanes per query, for tables
// beyond the L2, is in rank.cu).  A caller that needs several queries at once (an extend
// needs two, S1's backward step two per carried interval) stages them
// (arachne_occ4_stage, arachne_cp_wait, arachne_occ4_staged), so that all
// their loads are in flight together and the queries cost one round trip,
// not one each.
#pragma once

#include <cstdint>

// 16-byte chunks of a record that hold counts (1 for int, 2 for long
// long); the two chunks of words follow them
template <typename T>
__host__ __device__ constexpr int arachne_count_chunks() { return sizeof(T) == 4 ? 1 : 2; }

// 16-byte chunks a query reads: its counts and its words
template <typename T>
__host__ __device__ constexpr int arachne_occ4_chunks() { return arachne_count_chunks<T>() + 2; }

// The record table as one array.
struct ArachneFlatTable {
    const uint4* base;
};

// The record table in ranges of ``per`` records: record b is record b %
// per of range b / per.
template <typename T>
struct ArachneShardedTable {
    const uint4* const* shards;   // each range's first record; the array lies on the launching card
    T per;
};

// Record ``block`` of the table, as 16-byte chunks.
template <typename T>
__device__ __forceinline__ const uint4* arachne_record(const ArachneFlatTable& table, T block) {
    return table.base + block * 4;
}

template <typename T>
__device__ __forceinline__ const uint4* arachne_record(const ArachneShardedTable<T>& table,
                                                       T block) {
    const T s = block / table.per;
    const uint4* shard = reinterpret_cast<const uint4*>(
        __ldg(reinterpret_cast<const unsigned long long*>(table.shards) + s));
    return shard + (block - s * table.per) * 4;
}

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

// Two checkpoint counts from one 16-byte chunk: counts 2h and 2h + 1 of a
// long long record's chunk h, or, for int, counts 0-3 of chunk 0.
template <typename T>
__device__ __forceinline__ void arachne_set_base(ArachneOcc4Row<T>& r, uint4 a, uint4 b) {
    if constexpr (sizeof(T) == 4) {
        r.base[0] = (int)a.x; r.base[1] = (int)a.y; r.base[2] = (int)a.z; r.base[3] = (int)a.w;
    } else {
        r.base[0] = arachne_join64(a.x, a.y); r.base[1] = arachne_join64(a.z, a.w);
        r.base[2] = arachne_join64(b.x, b.y); r.base[3] = arachne_join64(b.z, b.w);
    }
}

// A query's row from its chunks c[0 .. arachne_occ4_chunks<T>() - 1].
template <typename T>
__device__ __forceinline__ ArachneOcc4Row<T> arachne_occ4_from(
    const uint4 (&c)[4], T k, int j)
{
    constexpr int CC = arachne_count_chunks<T>();
    ArachneOcc4Row<T> r;
    arachne_set_base(r, c[0], c[CC - 1]);
    r.w0 = c[CC];
    r.w1 = c[CC + 1];
    r.k = k;
    r.j = j;
    return r;
}

// One 16-byte chunk of a record, by the read-only path.
__device__ __forceinline__ uint4 arachne_ld16(const uint4* p) { return __ldg(p); }

// Load Occ(k, .)'s bytes into registers (K5 with one thread per query:
// nothing to wait on but its own loads).
template <typename T, typename Table>
__device__ __forceinline__ ArachneOcc4Row<T> arachne_occ4_load(
    const Table& table, T primary, T seq_len, T k)
{
    const T kk = arachne_occ4_row(primary, seq_len, k);
    const uint4* rec = arachne_record(table, kk >> 7);
    uint4 c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        c[q] = q < arachne_occ4_chunks<T>() ? arachne_ld16(rec + q) : make_uint4(0, 0, 0, 0);
    return arachne_occ4_from<T>(c, k, (int)(kk & 127));
}

// ---- Staged queries (S1, S3).  A thread that needs several queries at
// once copies their bytes into shared memory with cp.async and waits for
// all of them once.  Ordinary loads would not do: the compiler sinks a load
// to its first use, into the branch that uses it or past another query's
// count, and each query would cost a round trip again; a copy cannot be
// moved past the wait, and its bytes hold no registers while in flight.

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

// Start the copies of Occ(k, .) (the first arachne_occ4_chunks<T>()
// chunks of its record, one line) into chunks q0.. of the stage.
template <typename T, typename Table>
__device__ __forceinline__ void arachne_occ4_stage(
    const Table& table, T primary, T seq_len, T k, const ArachneStage& st, int q0)
{
    const uint4* rec = arachne_record(table, arachne_occ4_row(primary, seq_len, k) >> 7);
#pragma unroll
    for (int q = 0; q < arachne_occ4_chunks<T>(); ++q) arachne_cp16(st.at(q0 + q), rec + q);
}

// A staged query's bytes, after arachne_cp_wait.
template <typename T>
__device__ __forceinline__ ArachneOcc4Row<T> arachne_occ4_staged(
    const ArachneStage& st, int q0, ArachneOcc4Ref<T> ref)
{
    uint4 c[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        c[q] = q < arachne_occ4_chunks<T>() ? *st.at(q0 + q) : make_uint4(0, 0, 0, 0);
    return arachne_occ4_from<T>(c, ref.k, ref.j);
}

// The C, G and T bits of word v: lo holds each base's low bit, hi its high
// bit, both at the low bit of the base's two (C = 01, G = 10, T = 11).
__device__ __forceinline__ void arachne_base_bits(uint32_t v, uint32_t& lo, uint32_t& hi) {
    lo = v & 0x55555555u;
    hi = (v >> 1) & 0x55555555u;
}

// The mask of word x of a block for a row at base j of it: whole below j's
// word, bases 0..j & 15 in it, nothing above.  The shift is 2 * (15 - p)
// <= 30, so the undefined 32-bit shift of the reference's nvalid == 0 case
// never arises.
__device__ __forceinline__ uint32_t arachne_word_mask(int x, int j) {
    const int wi = j >> 4, p = j & 15;
    const uint32_t part = ~((1u << (2 * (15 - p))) - 1u);
    return x < wi ? 0xffffffffu : (x == wi ? part : 0u);
}

// C, G and T counted in the masked words a and b (two words' bit planes
// share one popcount, the second shifted onto the odd bits).
__device__ __forceinline__ void arachne_count_pair(uint32_t a, uint32_t b, int& c1, int& c2,
                                                   int& c3) {
    uint32_t loa, hia, lob, hib;
    arachne_base_bits(a, loa, hia);
    arachne_base_bits(b, lob, hib);
    const uint32_t lo = loa | (lob << 1), hi = hia | (hib << 1);
    const int t = __popc(lo & hi);
    c3 += t;
    c2 += __popc(hi) - t;
    c1 += __popc(lo) - t;
}

// Occ(k, c) from the base counts and the C, G and T counts of bases 0..j:
// k == -1 -> 0; k == seq_len -> L2[c+1] - L2[c]; otherwise the checkpoint
// row plus the counts.  A is the rest of the j + 1 bases: the masked-off
// bases read as A (00) and carry no C, G or T bit, so this is what the
// reference's count of A less its 127 - j masked-off bases comes to.
template <typename T>
__device__ __forceinline__ T arachne_occ4_finish(int c, T base, int j, int c1, int c2, int c3,
                                                 const T (&L2)[5], T seq_len, T k) {
    const int cnt = c == 0 ? j + 1 - c1 - c2 - c3 : (c == 1 ? c1 : (c == 2 ? c2 : c3));
    return k == seq_len ? L2[c + 1] - L2[c] : (k == -1 ? (T)0 : base + (T)cnt);
}

// Occ(k, c) for c = 0..3 (bwt.c:107-186, arachne_tpu/ops/fm_rank.py:88)
// of one query's row.  Each word is masked by a select, never by a branch.
template <typename T>
__device__ __forceinline__ void arachne_occ4_count(
    const ArachneOcc4Row<T>& r, const T (&L2)[5], T seq_len, T (&out)[4])
{
    const uint32_t y[8] = {r.w0.x, r.w0.y, r.w0.z, r.w0.w, r.w1.x, r.w1.y, r.w1.z, r.w1.w};
    int c1 = 0, c2 = 0, c3 = 0;
#pragma unroll
    for (int x = 0; x < 8; x += 2)
        arachne_count_pair(y[x] & arachne_word_mask(x, r.j),
                           y[x + 1] & arachne_word_mask(x + 1, r.j), c1, c2, c3);
#pragma unroll
    for (int c = 0; c < 4; ++c)
        out[c] = arachne_occ4_finish<T>(c, r.base[c], r.j, c1, c2, c3, L2, seq_len, r.k);
}
