// Copy of arachne_tpu/native/ropebwt.cpp, the JAX package's host code.
// Incremental BWT construction via a dynamic rank/insert sequence.
//
// Memory-proportional replacement for the full-suffix-array build at genome
// scale.  The reference faces the same wall and switches to incremental
// ropebwt2 construction above 50 Mbp (bwtindex.c:271, rope.c/rle.c); this is
// the same strategy re-designed for our planar index layout: maintain the
// BWT of the current text suffix T[i:] in a B+-tree whose nodes carry
// per-symbol subtree counts, and prepend one character per step:
//
//     r  = rank_c(W, p)            // occurrences of c before the $ row
//     insert c into W at position p
//     p' = 1 + #chars<c + r        // new $ row (row 0 is the $-suffix)
//
// (Chan-Hon-Lam-Sadakane dynamic-FM update; the stored sequence W is bwa's
// $-free BWT with `primary` tracking the implicit $ row, bwt.c:38-50.)
// Peak memory is O(n/4) tree bytes + the 2-bit packed text, vs ~8n for the
// in-RAM suffix array — GRCh38's forward+reverse would need ~50 GB of SA
// where this path stays under a few GB.
//
// The output BWT is bit-identical to the SA route (bwt_from_sa in
// index/build.py); parity is asserted in tests/test_index_incremental.py.

#include <cstdint>
#include <cstring>
#include <vector>

#define ARACHNE_NATIVE_ABI 10

extern "C" int64_t arachne_native_abi() { return ARACHNE_NATIVE_ABI; }

namespace {

constexpr int LEAF_SYMS = 1024;            // symbols per leaf
constexpr int LEAF_WORDS = LEAF_SYMS / 32; // 2-bit packed, 32 per uint64
constexpr int FAN = 32;                    // max children per inner node
constexpr uint32_t LEAF_BIT = 0x80000000u;
constexpr uint64_t LANES = 0x5555555555555555ull;

struct Leaf {
    uint64_t w[LEAF_WORDS];  // LSB-first 2-bit lanes
    int32_t n;
};

struct Inner {
    int64_t totals[FAN];
    int64_t cnt[4][FAN];
    uint32_t child[FAN];
    int32_t n;
};

static inline int popcount64(uint64_t x) { return __builtin_popcountll(x); }

// count occurrences of symbol c in the low `m` lanes of word w
static inline int word_rank(uint64_t w, int c, int m) {
    uint64_t x = w ^ (LANES * (uint64_t)c);
    uint64_t t = ~(x | (x >> 1)) & LANES;
    if (m < 32) t &= ((1ull << (2 * m)) - 1ull) & LANES;
    return popcount64(t);
}

struct Rope {
    std::vector<Leaf> leaves;
    std::vector<Inner> inners;
    uint32_t root;
    int64_t cnt_total[4];

    explicit Rope(int64_t n_expected) {
        leaves.reserve((size_t)(n_expected / (LEAF_SYMS / 2) + 4));
        inners.reserve((size_t)(n_expected / (LEAF_SYMS / 2) / (FAN / 2) + 8));
        leaves.push_back(Leaf{});
        std::memset(&leaves[0], 0, sizeof(Leaf));
        root = LEAF_BIT | 0;
        cnt_total[0] = cnt_total[1] = cnt_total[2] = cnt_total[3] = 0;
    }

    int leaf_rank(const Leaf& L, int64_t pos, int c) const {
        int r = 0;
        int full = (int)(pos >> 5);
        for (int k = 0; k < full; ++k) r += word_rank(L.w[k], c, 32);
        int rem = (int)(pos & 31);
        if (rem) r += word_rank(L.w[full], c, rem);
        return r;
    }

    void leaf_insert(Leaf& L, int64_t pos, int c) {
        int wi = (int)(pos >> 5);
        int off = (int)(pos & 31) * 2;
        int last = (L.n >> 5);  // highest word holding data after insert
        if (last >= LEAF_WORDS) last = LEAF_WORDS - 1;
        for (int k = last; k > wi; --k)
            L.w[k] = (L.w[k] << 2) | (L.w[k - 1] >> 62);
        uint64_t low = off ? (L.w[wi] & ((1ull << off) - 1ull)) : 0ull;
        uint64_t high = (off + 2 < 64) ? ((L.w[wi] >> off) << (off + 2)) : 0ull;
        L.w[wi] = low | ((uint64_t)c << off) | high;
        L.n += 1;
    }

    void leaf_counts(const Leaf& L, int64_t out[4]) const {
        out[0] = out[1] = out[2] = out[3] = 0;
        int full = L.n >> 5, rem = L.n & 31;
        for (int c = 0; c < 4; ++c) {
            int r = 0;
            for (int k = 0; k < full; ++k) r += word_rank(L.w[k], c, 32);
            if (rem) r += word_rank(L.w[full], c, rem);
            out[c] = r;
        }
    }

    uint32_t new_leaf() {
        leaves.push_back(Leaf{});
        std::memset(&leaves.back(), 0, sizeof(Leaf));
        return LEAF_BIT | (uint32_t)(leaves.size() - 1);
    }

    uint32_t new_inner() {
        inners.push_back(Inner{});
        std::memset(&inners.back(), 0, sizeof(Inner));
        return (uint32_t)(inners.size() - 1);
    }

    // Split the full child `slot` of inner node `pi` (or the root when
    // pi == UINT32_MAX), cascading upward as needed.  The caller restarts
    // its descent afterwards; splits are O(n / LEAF_SYMS) amortized.
    struct PathEnt { uint32_t node; int slot; };

    void split_child(PathEnt* path, int depth) {
        // path[depth] identifies the full node (leaf or inner) to split,
        // path[depth-1] its parent, ... path[0].node is below the root only
        // if root itself is on the path.  We pass the chain from root.
        if (depth > 0 && inners[path[depth - 1].node].n == FAN) {
            // parent has no room for a new child entry: split the parent
            // first (cascading), leave this node untouched, and let the
            // caller restart its descent.
            split_child(path, depth - 1);
            return;
        }
        uint32_t full_ref =
            depth == 0 ? root : inners[path[depth - 1].node].child[path[depth - 1].slot];
        uint32_t right_ref;
        int64_t right_cnt[4];
        if (full_ref & LEAF_BIT) {
            uint32_t li = full_ref & ~LEAF_BIT;
            right_ref = new_leaf();
            Leaf& L = leaves[li];  // (new_leaf may have reallocated; re-take)
            Leaf& R = leaves[right_ref & ~LEAF_BIT];
            constexpr int H = LEAF_WORDS / 2;
            for (int k = 0; k < H; ++k) {
                R.w[k] = L.w[H + k];
                L.w[H + k] = 0;
            }
            R.n = L.n - LEAF_SYMS / 2;
            L.n = LEAF_SYMS / 2;
            leaf_counts(R, right_cnt);
        } else {
            right_ref = new_inner();
            Inner& I = inners[full_ref];
            Inner& R = inners[right_ref];
            constexpr int H = FAN / 2;
            for (int k = 0; k < H; ++k) {
                R.child[k] = I.child[H + k];
                R.totals[k] = I.totals[H + k];
                for (int c = 0; c < 4; ++c) R.cnt[c][k] = I.cnt[c][H + k];
            }
            R.n = I.n - H;
            I.n = H;
            right_cnt[0] = right_cnt[1] = right_cnt[2] = right_cnt[3] = 0;
            for (int k = 0; k < R.n; ++k)
                for (int c = 0; c < 4; ++c) right_cnt[c] += R.cnt[c][k];
        }
        if (depth == 0) {
            // grow a new root
            uint32_t nr = new_inner();
            Inner& NR = inners[nr];
            NR.n = 2;
            NR.child[0] = full_ref;
            NR.child[1] = right_ref;
            int64_t left_cnt[4];
            if (full_ref & LEAF_BIT) {
                leaf_counts(leaves[full_ref & ~LEAF_BIT], left_cnt);
            } else {
                Inner& I = inners[full_ref];
                for (int c = 0; c < 4; ++c) {
                    left_cnt[c] = 0;
                    for (int k = 0; k < I.n; ++k) left_cnt[c] += I.cnt[c][k];
                }
            }
            for (int c = 0; c < 4; ++c) {
                NR.cnt[c][0] = left_cnt[c];
                NR.cnt[c][1] = right_cnt[c];
            }
            NR.totals[0] = left_cnt[0] + left_cnt[1] + left_cnt[2] + left_cnt[3];
            NR.totals[1] = right_cnt[0] + right_cnt[1] + right_cnt[2] + right_cnt[3];
            root = nr;
            return;
        }
        // insert right_ref into the parent after `slot` (room guaranteed by
        // the parent-full check at entry)
        uint32_t pi = path[depth - 1].node;
        Inner& P = inners[pi];
        int slot = path[depth - 1].slot;
        for (int k = P.n; k > slot + 1; --k) {
            P.child[k] = P.child[k - 1];
            P.totals[k] = P.totals[k - 1];
            for (int c = 0; c < 4; ++c) P.cnt[c][k] = P.cnt[c][k - 1];
        }
        P.child[slot + 1] = right_ref;
        int64_t rt = right_cnt[0] + right_cnt[1] + right_cnt[2] + right_cnt[3];
        P.totals[slot + 1] = rt;
        P.totals[slot] -= rt;
        for (int c = 0; c < 4; ++c) {
            P.cnt[c][slot + 1] = right_cnt[c];
            P.cnt[c][slot] -= right_cnt[c];
        }
        P.n += 1;
    }

    // rank_c(W, pos) then insert c at pos.
    int64_t insert_and_rank(int64_t pos, int c) {
        for (;;) {
            PathEnt path[24];
            int depth = 0;
            uint32_t ref = root;
            int64_t rank = 0;
            int64_t p = pos;
            bool restart = false;
            while (!(ref & LEAF_BIT)) {
                Inner& I = inners[ref];
                int slot = 0;
                while (slot < I.n - 1 && p > I.totals[slot]) {
                    p -= I.totals[slot];
                    rank += I.cnt[c][slot];
                    ++slot;
                }
                path[depth].node = ref;
                path[depth].slot = slot;
                ++depth;
                ref = I.child[slot];
            }
            Leaf* L = &leaves[ref & ~LEAF_BIT];
            if (L->n == LEAF_SYMS) {
                path[depth].node = ref;  // position of the full leaf itself
                path[depth].slot = 0;
                split_child(path, depth);
                continue;  // restart descent with updated tree
            }
            (void)restart;
            rank += leaf_rank(*L, p, c);
            leaf_insert(*L, p, c);
            for (int d = 0; d < depth; ++d) {
                Inner& I = inners[path[d].node];
                I.totals[path[d].slot] += 1;
                I.cnt[c][path[d].slot] += 1;
            }
            cnt_total[c] += 1;
            return rank;
        }
    }

    // In-order traversal emitting symbols into a 2-bit .pac-layout buffer
    // (4 symbols/byte, high bits first — pack_2bit in index/build.py).
    void emit(uint8_t* out) const {
        int64_t pos = 0;
        emit_node(root, out, pos);
    }

    void emit_node(uint32_t ref, uint8_t* out, int64_t& pos) const {
        if (ref & LEAF_BIT) {
            const Leaf& L = leaves[ref & ~LEAF_BIT];
            for (int j = 0; j < L.n; ++j) {
                int c = (int)((L.w[j >> 5] >> ((j & 31) * 2)) & 3u);
                out[pos >> 2] |= (uint8_t)(c << ((3 - (pos & 3)) * 2));
                ++pos;
            }
        } else {
            const Inner& I = inners[ref];
            for (int k = 0; k < I.n; ++k) emit_node(I.child[k], out, pos);
        }
    }
};

static inline int get2(const uint8_t* pac2, int64_t i) {
    return (pac2[i >> 2] >> ((3 - (i & 3)) * 2)) & 3;
}

}  // namespace

// Build the BWT of the n-symbol text in pac2 (2-bit packed, 4/byte,
// high-first).  out_pac2 (ceil(n/4) bytes, caller-zeroed) receives the
// stored ($-free) BWT in the same packing; *out_primary receives the
// implicit-$ row.  progress, if non-null, is updated with the number of
// processed symbols every ~16M steps so a monitor thread can report.
extern "C" int rb_bwt_build(const uint8_t* pac2, int64_t n, uint8_t* out_pac2,
                            int64_t* out_primary, volatile int64_t* progress) {
    if (n <= 0) return -1;
    Rope rope(n);
    int64_t p = 0;
    for (int64_t i = n - 1; i >= 0; --i) {
        int c = get2(pac2, i);
        int64_t r = rope.insert_and_rank(p, c);
        int64_t less = 0;
        for (int d = 0; d < c; ++d) less += rope.cnt_total[d];
        // cnt_total was updated by the insert; subtract the inserted char's
        // own contribution only if it counted below c (it never does: the
        // inserted symbol is exactly c).
        p = 1 + less + r;
        if (progress && ((n - i) & 0xFFFFFF) == 0) *progress = n - i;
    }
    rope.emit(out_pac2);
    *out_primary = p;
    if (progress) *progress = n;
    return 0;
}
