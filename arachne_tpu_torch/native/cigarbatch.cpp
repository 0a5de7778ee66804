// The host side of the CIGAR stage (ops/engine.TorchEngine.reg2aln_batch
// and ops/sw_global.BatchGlobal.run) over a whole batch of hits at once.
//
// mem_reg2aln (bwamem.c:1086-1156) and bwa_gen_cigar2 (bwa.c:121-208) as
// the scalar align/cigar.py writes them, which stays the spec: the SE
// mapq and the first band (infer_bw), the window fetch and orientation,
// the no-gap score and the DP band, and after the batched global DP the
// NM/MD strings, the squeeze of a leading or trailing deletion, the soft
// clips and the contig coordinates.  For BatchGlobal: the padded query and
// target buffers of a launch, the all-M screen's no-gap scores and the
// run-length decode of K4's op streams.  Python calls these through ctypes,
// which releases the interpreter lock for each call; the batched Python
// path in ops/ stays as the fallback where this library does not load.
//
// Layout: sequences are flat uint8 code runs with int64 offset tables,
// CIGARs flat (op, len) int32 pairs with offset tables, op codes M=0,
// I=1, D=2, S=3 as align/cigar.py has them.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int32_t OP_M = 0, OP_I = 1, OP_D = 2, OP_S = 3;

// (l + 1) // 2 * mat[0, 0] - o as the spec computes it: mat is numpy
// int8, so where (l + 1) // 2 fits in int8 the product and the difference
// wrap in int8
int64_t band_term(int64_t l_query, int8_t mat00, int32_t o) {
    const int64_t half = (l_query + 1) / 2;
    if (half > 127) return half * mat00 - o;
    return (int8_t)((int8_t)(half * mat00) - o);
}

// infer_bw (bwamem.c:792-799)
int64_t infer_bw(int64_t l1, int64_t l2, int64_t score, int64_t a, int64_t q, int64_t r) {
    if (l1 == l2 && l1 * a - score < (q + r - a) * 2) return 0;
    int64_t w = (int64_t)((double)((l1 < l2 ? l1 : l2) * a - score - q) / (double)r + 2.0);
    int64_t d = l1 > l2 ? l1 - l2 : l2 - l1;
    return w > d ? w : d;
}

// mem_approx_mapq_se (bwamem.c:950-974), in the spec's order of float
// operations: no contraction into fused multiply-adds, so the result is
// Python's bit for bit
__attribute__((optimize("fp-contract=off")))
int64_t approx_mapq_se(int64_t score, int64_t sub, int64_t csub, int64_t sub_n, int64_t seedcov,
                       int64_t qlen, int64_t rlen, double frac_rep, int64_t a, int64_t b,
                       int64_t min_seed_len, int64_t coef_len, double coef_fac) {
    sub = sub ? sub : min_seed_len * a;
    sub = csub > sub ? csub : sub;
    if (sub >= score) return 0;
    int64_t length = qlen > rlen ? qlen : rlen;
    double identity = 1.0 - (double)(length * a - score) / (double)(a + b) / (double)length;
    int64_t mapq;
    if (score == 0) {
        mapq = 0;
    } else if (coef_len > 0) {
        double tmp = length < coef_len ? 1.0 : coef_fac / std::log((double)length);
        tmp *= identity * identity;
        mapq = (int64_t)(6.02 * (double)(score - sub) / (double)a * tmp * tmp + 0.499);
    } else {
        mapq = (int64_t)(30.0 * (1.0 - (double)sub / (double)score) * std::log((double)seedcov)
                         + 0.499);
        if (identity < 0.95) mapq = (int64_t)((double)mapq * identity * identity + 0.499);
    }
    if (sub_n > 0) mapq -= (int64_t)(4.343 * std::log((double)(sub_n + 1)) + 0.499);
    if (mapq > 60) mapq = 60;
    if (mapq < 0) mapq = 0;
    return (int64_t)((double)mapq * (1.0 - frac_rep) + 0.499);
}

// Python's slice bounds of seq[b:e] over a sequence of length n
void py_slice(int64_t n, int64_t& b, int64_t& e) {
    if (b < 0) b = b + n < 0 ? 0 : b + n;
    if (b > n) b = n;
    if (e < 0) e = e + n < 0 ? 0 : e + n;
    if (e > n) e = n;
    if (e < b) e = b;
}

inline uint8_t pac_base(const uint8_t* pac, int64_t p) {
    return (pac[p >> 2] >> ((~p & 3) << 1)) & 3;
}

// forward-strand codes [b, e) from the unpacked cache or the 2-bit pac
inline uint8_t fwd_base(const uint8_t* fwd, const uint8_t* pac, int64_t p) {
    return fwd ? fwd[p] : pac_base(pac, p);
}

// the decimal digits of v >= 0 (Python's str), no terminator
char* put_num(char* out, int64_t v) {
    char tmp[20];
    int k = 0;
    do {
        tmp[k++] = (char)('0' + v % 10);
        v /= 10;
    } while (v > 0);
    while (k > 0) *out++ = tmp[--k];
    return out;
}

}  // namespace

// The per-hit set-up of mem_reg2aln for n mapped hits (regions ``reg``,
// n rows of qb, qe, rb, re, truesc, w, secondary, score, sub, csub, sub_n,
// seedcov): mapq (0 for a secondary hit) and the first band w2.
extern "C" int cigar_init_batch(
    int64_t n, const int64_t* reg, const double* frac_rep,
    int32_t a, int32_t b, int32_t o_del, int32_t e_del, int32_t o_ins, int32_t e_ins,
    int32_t w, int32_t min_seed_len, int32_t coef_len, double coef_fac,
    int64_t* mapq, int64_t* w2) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t* r = reg + 12 * i;
        int64_t qb = r[0], qe = r[1], rb = r[2], re = r[3], truesc = r[4], aw = r[5];
        int64_t secondary = r[6];
        mapq[i] = secondary < 0
            ? approx_mapq_se(r[7], r[8], r[9], r[10], r[11], qe - qb, re - rb, frac_rep[i],
                             a, b, min_seed_len, coef_len, coef_fac)
            : 0;
        int64_t d = infer_bw(qe - qb, re - rb, truesc, a, o_del, e_del);
        int64_t i2 = infer_bw(qe - qb, re - rb, truesc, a, o_ins, e_ins);
        int64_t v = d > i2 ? d : i2;
        if (v > w) v = v < aw ? v : aw;
        w2[i] = v;
    }
    return 0;
}

// gen_cigar_prepare (bwa.c:121-170) for n hits, once: the query slice
// query[qb:qe] into qbuf at the query's own offset, the reference window
// [rb, re) into rbuf at rbuf_off, both reversed (the window as forward
// codes complemented) on the reverse strand; ok 0 where the spec fails
// (empty query or window, a window across l_pac, a short fetch).  nogap
// is the no-gap score where lq == rlen, band the DP band before the
// wave's w: (max_gap + |rlen - lq| + 1) >> 1.
extern "C" int cigar_prepare_batch(
    int64_t n, const uint8_t* query, const int64_t* query_off,
    const int64_t* qb_, const int64_t* qe_, const int64_t* rb_, const int64_t* re_,
    const uint8_t* fwd, const uint8_t* pac, int64_t l_pac, int64_t seq_len,
    const int8_t* mat, int32_t o_del, int32_t e_del, int32_t o_ins, int32_t e_ins,
    uint8_t* qbuf, uint8_t* rbuf, const int64_t* rbuf_off,
    int32_t* lq_out, int32_t* rlen_out, uint8_t* ok, int64_t* nogap, int32_t* band) {
    for (int64_t i = 0; i < n; ++i) {
        const int64_t q0 = query_off[i], n_query = query_off[i + 1] - q0;
        int64_t qb = qb_[i], qe = qe_[i];
        py_slice(n_query, qb, qe);
        const int64_t lq = qe - qb, rb = rb_[i], re = re_[i];
        lq_out[i] = (int32_t)lq;
        rlen_out[i] = 0;
        ok[i] = 0;
        nogap[i] = 0;
        band[i] = 0;
        if (lq <= 0 || rb >= re || (rb < l_pac && re > l_pac)) continue;
        // bns_get_seq clamps the window to [0, seq_len)
        const int64_t beg = rb < 0 ? 0 : rb, end = re < seq_len ? re : seq_len;
        if (end - beg != re - rb) continue;
        const int64_t rlen = re - rb;
        uint8_t* q = qbuf + q0;
        uint8_t* r = rbuf + rbuf_off[i];
        const uint8_t* src = query + q0 + qb;
        if (rb >= l_pac) {
            for (int64_t k = 0; k < lq; ++k) q[k] = src[lq - 1 - k];
            const int64_t fb = (l_pac << 1) - end;
            for (int64_t k = 0; k < rlen; ++k) r[k] = 3 - fwd_base(fwd, pac, fb + k);
        } else {
            std::memcpy(q, src, (size_t)lq);
            for (int64_t k = 0; k < rlen; ++k) r[k] = fwd_base(fwd, pac, beg + k);
        }
        if (lq == rlen) {
            int64_t s = 0;
            for (int64_t k = 0; k < lq; ++k) s += mat[5 * r[k] + q[k]];
            nogap[i] = s;
        }
        int64_t max_ins = (int64_t)((double)band_term(lq, mat[0], o_ins) / e_ins + 1.0);
        int64_t max_del = (int64_t)((double)band_term(lq, mat[0], o_del) / e_del + 1.0);
        int64_t max_gap = max_ins > max_del ? max_ins : max_del;
        if (max_gap < 1) max_gap = 1;
        const int64_t d = rlen > lq ? rlen - lq : lq - rlen;
        band[i] = (int32_t)((max_gap + d + 1) >> 1);
        rlen_out[i] = (int32_t)rlen;
        ok[i] = 1;
    }
    return 0;
}

// gen_cigar_finish (bwa.c:172-202) and the tail of mem_reg2aln
// (bwamem.c:1119-1156) for n hits.  kind: 0 the spec failed (no CIGAR,
// NM -1, MD empty), 1 the no-gap shortcut [(M, lq)], 2 the DP's CIGAR of
// cig_n pairs at pair cig_start.  Writes the final CIGAR (the squeeze,
// the clips) contiguously into out_cig with out_cig_off (n + 1), the MD
// strings into md with md_off (n + 1), NM, the forward position relative
// to its contig, the contig and the strand.  The caller sizes out_cig to
// sum(cig_n) + 3n pairs and md to sum over hits of 3 (lq + rlen) + 24.
extern "C" int cigar_finish_batch(
    int64_t n, const uint8_t* kind, const int32_t* cig, const int64_t* cig_start,
    const int32_t* cig_n,
    const uint8_t* qbuf, const int64_t* query_off, const int32_t* lq_,
    const uint8_t* rbuf, const int64_t* rbuf_off, const int32_t* rlen_,
    const int64_t* qb_, const int64_t* qe_, const int64_t* rb_, const int64_t* re_,
    int64_t l_pac, const int64_t* contig_off, int64_t n_contigs,
    int32_t* out_cig, int64_t* out_cig_off, char* md, int64_t* md_off,
    int64_t* nm_out, int64_t* pos_out, int64_t* rid_out, uint8_t* rev_out) {
    int64_t oc = 0, om = 0;
    out_cig_off[0] = 0;
    md_off[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t rb = rb_[i], re = re_[i], qb = qb_[i], qe = qe_[i];
        const int64_t l_query = query_off[i + 1] - query_off[i];
        const uint8_t* q = qbuf + query_off[i];
        const uint8_t* r = rbuf + rbuf_off[i];
        const int64_t lq = lq_[i], rlen = rlen_[i];
        int32_t one[2] = {OP_M, (int32_t)lq};
        const int32_t* c = kind[i] == 2 ? cig + 2 * cig_start[i] : one;
        const int64_t nc = kind[i] == 2 ? cig_n[i] : (kind[i] == 1 ? 1 : 0);
        // NM and MD
        if (kind[i] == 0) {
            nm_out[i] = -1;
        } else {
            const char* int2base = rb < l_pac ? "ACGTN" : "TGCAN";
            char* out = md + om;
            int64_t n_mm = 0, n_gap = 0, x = 0, y = 0, u = 0;
            for (int64_t k = 0; k < nc; ++k) {
                const int32_t op = c[2 * k], ln = c[2 * k + 1];
                if (op == OP_M) {
                    int64_t lim = ln;
                    if (lim > lq - x) lim = lq - x;
                    if (lim > rlen - y) lim = rlen - y;
                    int64_t prev = -1;
                    for (int64_t m = 0; m < lim; ++m) {
                        if (q[x + m] != r[y + m]) {
                            out = put_num(out, u + (m - prev - 1));
                            *out++ = int2base[r[y + m]];
                            u = 0;
                            prev = m;
                            ++n_mm;
                        }
                    }
                    u = prev >= 0 ? ln - 1 - prev : u + ln;
                    x += ln;
                    y += ln;
                } else if (op == OP_D) {
                    if (0 < k && k < nc - 1) {
                        out = put_num(out, u);
                        *out++ = '^';
                        int64_t hi = y + ln < rlen ? y + ln : rlen;
                        for (int64_t m = y; m < hi; ++m) *out++ = int2base[r[m]];
                        u = 0;
                        n_gap += ln;
                    }
                    y += ln;
                } else if (op == OP_I) {
                    x += ln;
                    n_gap += ln;
                }
            }
            out = put_num(out, u);
            om = out - md;
            nm_out[i] = n_mm + n_gap;
        }
        md_off[i + 1] = om;
        // bns_depos, the squeeze of a leading or trailing deletion
        const int64_t p = rb < l_pac ? rb : re - 1;
        const bool is_rev = p >= l_pac;
        int64_t pos = is_rev ? (l_pac << 1) - 1 - p : p;
        int64_t k0 = 0, k1 = nc;
        if (nc > 0) {
            if (c[0] == OP_D) {
                pos += c[1];
                k0 = 1;
            } else if (c[2 * (nc - 1)] == OP_D) {
                k1 = nc - 1;
            }
        }
        int64_t clip5 = 0, clip3 = 0;
        if (qb != 0 || qe != l_query) {
            clip5 = is_rev ? l_query - qe : qb;
            clip3 = is_rev ? qb : l_query - qe;
        }
        int32_t* oc_p = out_cig + 2 * oc;
        if (clip5) { *oc_p++ = OP_S; *oc_p++ = (int32_t)clip5; }
        for (int64_t k = k0; k < k1; ++k) { *oc_p++ = c[2 * k]; *oc_p++ = c[2 * k + 1]; }
        if (clip3) { *oc_p++ = OP_S; *oc_p++ = (int32_t)clip3; }
        oc = (oc_p - out_cig) / 2;
        out_cig_off[i + 1] = oc;
        // bns_pos2rid: -1 at or past l_pac, and the offset Python's
        // anns[-1] gives there
        int64_t lo = 0, hi = n_contigs;
        while (lo < hi) {
            int64_t mid = (lo + hi) >> 1;
            if (contig_off[mid] <= pos) lo = mid + 1; else hi = mid;
        }
        int64_t rid = pos >= l_pac ? -1 : lo - 1;
        rid_out[i] = rid;
        pos_out[i] = pos - contig_off[rid >= 0 ? rid : n_contigs - 1];
        rev_out[i] = is_rev;
    }
    return 0;
}

// BatchGlobal's padded launch buffers: row k of out (m, width) int8 holds
// the codes of problem sel[k] (flat[off[j], off[j + 1])), padded with N (4)
extern "C" int global_gather_batch(
    int64_t m, const int64_t* sel, const uint8_t* flat, const int64_t* off, int64_t width,
    int8_t* out) {
    for (int64_t k = 0; k < m; ++k) {
        const int64_t j = sel[k], len = off[j + 1] - off[j];
        int8_t* row = out + k * width;
        std::memcpy(row, flat + off[j], (size_t)len);
        std::memset(row + len, 4, (size_t)(width - len));
    }
    return 0;
}

// the no-gap score sum(mat[t, q]) of each problem sel[k] whose query and
// target have one length (BatchGlobal's all-M screen)
extern "C" int global_nogap_batch(
    int64_t m, const int64_t* sel, const uint8_t* qs, const int64_t* q_off,
    const uint8_t* ts, const int64_t* t_off, const int64_t* mat, int64_t* out) {
    for (int64_t k = 0; k < m; ++k) {
        const int64_t j = sel[k], len = q_off[j + 1] - q_off[j];
        const uint8_t* q = qs + q_off[j];
        const uint8_t* t = ts + t_off[j];
        int64_t s = 0;
        for (int64_t x = 0; x < len; ++x) s += mat[5 * t[x] + q[x]];
        out[k] = s;
    }
    return 0;
}

// The CIGAR of each of n problems: [(M, qlen)] where lane[i] < 0 (the
// screen proved the all-M alignment), else the op stream of K4's lane
// lane[i] (column lane[i] of ops (steps, lanes) int8: 0 M, 2 D, 1 I, 3
// after the walk ended, in walk order from the end) with the trailing
// deletion (fi + 1) and insertion (fk + 1) runs, reversed and run-length
// encoded, as sw_global.decode_traceback_ops does.  out holds
// sum(steps + 2) pairs for the lanes plus one a screened problem.
extern "C" int global_decode_batch(
    int64_t n, const int64_t* lane, const int64_t* qlen,
    const int8_t* ops, int64_t steps, int64_t lanes, const int64_t* fi, const int64_t* fk,
    int32_t* out, int64_t* out_off) {
    // each lane's runs, lane by lane: the op matrix is read a tile of
    // TILE lanes (one cache line of a row) at a time
    const int64_t TILE = 64;
    std::vector<int32_t> runs;
    std::vector<int64_t> lane_off(lanes + 1, 0);
    std::vector<int8_t> tile((size_t)(steps * TILE));
    for (int64_t l0 = 0; l0 < lanes; l0 += TILE) {
        const int64_t nb = lanes - l0 < TILE ? lanes - l0 : TILE;
        for (int64_t s = 0; s < steps; ++s)
            for (int64_t b = 0; b < nb; ++b) tile[b * steps + s] = ops[s * lanes + l0 + b];
        for (int64_t b = 0; b < nb; ++b) {
            const int64_t l = l0 + b;
            const size_t r0 = runs.size();
            auto push = [&](int32_t op, int64_t len) {
                if (runs.size() > r0 && runs[runs.size() - 2] == op) {
                    runs.back() += (int32_t)len;
                } else {
                    runs.push_back(op);
                    runs.push_back((int32_t)len);
                }
            };
            if (fk[l] >= 0) push(OP_I, fk[l] + 1);
            if (fi[l] >= 0) push(OP_D, fi[l] + 1);
            const int8_t* col = tile.data() + b * steps;
            for (int64_t s = steps - 1; s >= 0; --s)
                if (col[s] != 3) push(col[s], 1);
            lane_off[l + 1] = (int64_t)runs.size() / 2;
        }
    }
    int64_t o = 0;
    out_off[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t l = lane[i];
        if (l < 0) {
            out[2 * o] = OP_M;
            out[2 * o + 1] = (int32_t)qlen[i];
            ++o;
        } else {
            const int64_t k = lane_off[l + 1] - lane_off[l];
            std::memcpy(out + 2 * o, runs.data() + 2 * lane_off[l], (size_t)(8 * k));
            o += k;
        }
        out_off[i + 1] = o;
    }
    return 0;
}
