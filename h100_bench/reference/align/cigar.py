# Frozen copy of arachne_tpu_torch/align/cigar.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Region -> final alignment: global CIGAR, NM/MD, clipping, SE mapq.

Reproduces bwa_gen_cigar2 (bwa.c:121-208), infer_bw (bwamem.c:792-799),
mem_reg2aln (bwamem.c:1086-1156) and mem_approx_mapq_se (bwamem.c:950-974).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import MemOptions
from ..index.fmindex import FMIndex
from . import ksw
from .extend import AlnReg

# CIGAR op codes as the reference emits them through the cgo bridge
# (gobwa.go:449-488): M=0, I=1, D=2, S=3 (after &0xf remapping in the Go
# layer; BAM codes are remapped at write time, bamwriter.go:248-254).
OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 3


def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """infer_bw (bwamem.c:792-799)."""
    if l1 == l2 and l1 * a - score < (q + r - a) * 2:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def gen_cigar_prepare(
    idx: FMIndex,
    query: np.ndarray,
    rb: int,
    re: int,
    w: int,
    opt: MemOptions,
    mat: np.ndarray,
    want_cigar: bool = True,
):
    """First phase of bwa_gen_cigar2 (bwa.c:121-170): fetch/orient the
    sequences, handle the no-gap shortcut, compute the effective band.

    Returns ("fail",), ("done", q, rseq, score, cigar) for the shortcut, or
    ("dp", q, rseq, w_eff) when a global DP is required."""
    l_pac = idx.l_pac
    l_query = len(query)
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return ("fail",)
    rseq = idx.get_seq(rb, re)
    if len(rseq) != re - rb:
        return ("fail",)
    q = query
    if rb >= l_pac:  # reverse both to left-align indels
        q = query[::-1].copy()
        rseq = rseq[::-1].copy()
    rlen = len(rseq)
    if l_query == re - rb and w == 0:  # no-gap shortcut
        cigar = [(OP_M, l_query)] if want_cigar else None
        score = int(mat[rseq, q].sum())
        return ("done", q, rseq, score, cigar)
    max_ins = int(((l_query + 1) // 2 * mat[0, 0] - opt.o_ins) / opt.e_ins + 1.0)
    max_del = int(((l_query + 1) // 2 * mat[0, 0] - opt.o_del) / opt.e_del + 1.0)
    max_gap = max(max_ins, max_del, 1)
    w2 = (max_gap + abs(rlen - l_query) + 1) >> 1
    w2 = min(w2, w)
    min_w = abs(rlen - l_query) + 3
    w2 = max(w2, min_w)
    return ("dp", q, rseq, w2)


def gen_cigar_finish(
    q: np.ndarray,
    rseq: np.ndarray,
    rb: int,
    l_pac: int,
    score: int,
    cigar,
    want_cigar: bool,
) -> Tuple[int, Optional[List[Tuple[int, int]]], int, str]:
    """Second phase of bwa_gen_cigar2 (bwa.c:172-202): NM and MD."""
    nm = -1
    md = ""
    if want_cigar and cigar is not None:
        n_mm = n_gap = 0
        parts: List[str] = []
        int2base = "ACGTN" if rb < l_pac else "TGCAN"
        x = y = u = 0
        n_cigar = len(cigar)
        for kth, (op, ln) in enumerate(cigar):
            if op == OP_M:
                # vectorized mismatch scan (the per-base loop was ~40% of
                # the CIGAR stage); identical MD/NM emission
                seg_q = q[x : x + ln]
                seg_r = rseq[y : y + ln]
                mism = np.flatnonzero(seg_q != seg_r)
                if len(mism) == 0:
                    u += ln
                else:
                    prev = -1
                    for m in mism.tolist():
                        parts.append(str(u + (m - prev - 1)))
                        parts.append(int2base[seg_r[m]])
                        u = 0
                        prev = m
                    u = ln - 1 - int(mism[-1])
                    n_mm += len(mism)
                x += ln
                y += ln
            elif op == OP_D:
                if 0 < kth < n_cigar - 1:
                    parts.append(str(u))
                    parts.append("^")
                    parts.append("".join(int2base[b] for b in rseq[y : y + ln]))
                    u = 0
                    n_gap += ln
                y += ln
            elif op == OP_I:
                x += ln
                n_gap += ln
        parts.append(str(u))
        md = "".join(parts)
        nm = n_mm + n_gap
    return score, cigar, nm, md


def gen_cigar(
    idx: FMIndex,
    query: np.ndarray,
    rb: int,
    re: int,
    w: int,
    opt: MemOptions,
    mat: Optional[np.ndarray] = None,
    want_cigar: bool = True,
    global_fn=None,
) -> Tuple[int, Optional[List[Tuple[int, int]]], int, str]:
    """bwa_gen_cigar2 (bwa.c:121-208): global alignment of query vs the
    reference window [rb, re) on the fwd-rev coordinate.

    Returns (score, cigar, NM, MD).  For reverse-strand windows both
    sequences are reversed before the DP so indels left-align, exactly as
    the reference does.  ``global_fn(q, rseq, w) -> (score, cigar)`` may
    replace the scalar DP (device batching)."""
    if mat is None:
        mat = opt.scoring_matrix()
    prep = gen_cigar_prepare(idx, query, rb, re, w, opt, mat, want_cigar)
    if prep[0] == "fail":
        return 0, None, -1, ""
    if prep[0] == "done":
        _, q, rseq, score, cigar = prep
    else:
        _, q, rseq, w2 = prep
        if global_fn is not None:
            score, cigar = global_fn(q, rseq, w2)
        else:
            score, cigar = ksw.global2(
                q, rseq, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w2, want_cigar
            )
    return gen_cigar_finish(q, rseq, rb, idx.l_pac, score, cigar, want_cigar)


@dataclass
class MemAln:
    """mem_aln_t (bwamem.h:87-97): finalized single alignment."""

    pos: int = -1           # contig-relative, forward-strand 5' position
    rid: int = -1
    flag: int = 0
    is_rev: bool = False
    is_alt: bool = False
    mapq: int = 0
    NM: int = -1
    cigar: List[Tuple[int, int]] = field(default_factory=list)
    MD: str = ""
    score: int = -1
    sub: int = -1
    alt_sc: int = 0


def approx_mapq_se(opt: MemOptions, a: AlnReg) -> int:
    """mem_approx_mapq_se (bwamem.c:950-974)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    length = max(a.qe - a.qb, a.re - a.rb)
    identity = 1.0 - (length * opt.a - a.score) / (opt.a + opt.b) / length
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if length < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(length)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + 0.499)
    else:
        MEM_MAPQ_COEF = 30.0
        mapq = int(MEM_MAPQ_COEF * (1.0 - sub / a.score) * math.log(a.seedcov) + 0.499)
        if identity < 0.95:
            mapq = int(mapq * identity * identity + 0.499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    mapq = int(mapq * (1.0 - a.frac_rep) + 0.499)
    return mapq


def reg2aln(
    idx: FMIndex, opt: MemOptions, query: np.ndarray, ar: Optional[AlnReg],
    mat: Optional[np.ndarray] = None,
) -> MemAln:
    """mem_reg2aln (bwamem.c:1086-1156)."""
    a = MemAln()
    if ar is None or ar.rb < 0 or ar.re < 0:
        a.flag |= 0x4
        return a
    if mat is None:
        mat = opt.scoring_matrix()
    l_query = len(query)
    qb, qe = ar.qb, ar.qe
    rb, re = ar.rb, ar.re
    a.mapq = approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    w2 = max(
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_del, opt.e_del),
        infer_bw(qe - qb, re - rb, ar.truesc, opt.a, opt.o_ins, opt.e_ins),
    )
    if w2 > opt.w:
        w2 = min(w2, ar.w)
    last_sc = -(1 << 30)
    i = 0
    score, cigar, nm, md = 0, None, -1, ""
    while True:
        w2 = min(w2, opt.w * 4)
        score, cigar, nm, md = gen_cigar(idx, query[qb:qe], rb, re, w2, opt, mat)
        if score == last_sc or w2 == opt.w * 4:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if not (i < 3 and score < ar.truesc - opt.a):
            break
    a.NM = nm
    a.MD = md
    cigar = list(cigar) if cigar else []
    fpos, is_rev = idx.depos(np.array([rb if rb < idx.l_pac else re - 1]))
    pos = int(fpos[0])
    a.is_rev = bool(is_rev[0])
    if cigar:  # squeeze leading/trailing deletions (:1124-1133)
        if cigar[0][0] == OP_D:
            pos += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == OP_D:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:  # soft clips (:1134-1148)
        clip5 = l_query - qe if a.is_rev else qb
        clip3 = qb if a.is_rev else l_query - qe
        if clip5:
            cigar = [(OP_S, clip5)] + cigar
        if clip3:
            cigar = cigar + [(OP_S, clip3)]
    a.cigar = cigar
    a.rid = int(idx.pos2rid(np.array([pos]))[0])
    assert a.rid == ar.rid
    a.pos = pos - idx.packed.anns[a.rid].offset
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a
