# Frozen copy of arachne_tpu_torch/align/extend.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Chain extension into alignment regions + de-overlapping + primary marking.

Reproduces mem_chain2aln (bwamem.c:632-786) — the band-doubling left/right
extension driver around each chain's seeds — plus mem_sort_dedup_patch
(:437-489), mem_patch_reg (:406-435) and mem_mark_primary_se (:493-558).

The actual extension DP calls go through a pluggable ``extender`` so the
same driver can run the scalar oracle (align/ksw.py) or the batched Pallas
kernel (ops/sw_extend.py): the driver collects (query, ref-window) problems
and the extender returns (score, qle, tle, gtle, gscore, max_off) tuples.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..config import MemOptions
from ..index.fmindex import FMIndex
from ..utils.rng import hash_64
from . import ksw
from .chain import Chain

MAX_BAND_TRY = 2


@dataclass
class AlnReg:
    """mem_alnreg_t (bwamem.h:59-77)."""

    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = 0
    truesc: int = 0
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 0
    is_alt: bool = False
    frac_rep: float = 0.0
    hash: int = 0


def cal_max_gap(opt: MemOptions, qlen: int) -> int:
    """cal_max_gap (bwamem.c:621-628)."""
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = max(l_del, l_ins, 1)
    return min(l, opt.w * 2)


ExtendFn = Callable[
    [np.ndarray, np.ndarray, int, int, int],  # (query, target, w, end_bonus, h0)
    Tuple[int, int, int, int, int, int],
]


def _default_extender(opt: MemOptions, mat: np.ndarray) -> ExtendFn:
    def run(qs, ts, w, end_bonus, h0):
        return ksw.extend2(
            qs, ts, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, w, end_bonus, opt.zdrop, h0
        )

    return run


def chain2aln(
    idx: FMIndex,
    q: np.ndarray,
    c: Chain,
    opt: MemOptions,
    regs: List[AlnReg],
    extender: Optional[ExtendFn] = None,
    mat: Optional[np.ndarray] = None,
) -> None:
    """mem_chain2aln (bwamem.c:632-786): extend each seed of a chain."""
    if not c.seeds:
        return
    if mat is None:
        mat = opt.scoring_matrix()
    if extender is None:
        extender = _default_extender(opt, mat)
    l_query = len(q)
    l_pac = idx.l_pac

    if c.win_seq is not None:
        rseq, rmax0 = c.win_seq, c.win_rmax0
    else:
        # max possible span (rmax) over all seeds (:642-657)
        rmax0, rmax1 = l_pac << 1, 0
        for t in c.seeds:
            b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
            e = t.rbeg + t.len + (
                (l_query - t.qbeg - t.len) + cal_max_gap(opt, l_query - t.qbeg - t.len)
            )
            rmax0 = min(rmax0, b)
            rmax1 = max(rmax1, e)
        rmax0 = max(rmax0, 0)
        rmax1 = min(rmax1, l_pac << 1)
        if rmax0 < l_pac < rmax1:
            if c.seeds[0].rbeg < l_pac:
                rmax1 = l_pac
            else:
                rmax0 = l_pac
        rseq, rid, rmax0, rmax1 = idx.fetch_seq(rmax0, c.seeds[0].rbeg, rmax1)
        assert rid == c.rid

    # sort seed indices by (score, index) ascending, process descending
    srt = sorted(range(len(c.seeds)), key=lambda i: (c.seeds[i].score << 32) | i)
    srt_alive = [True] * len(srt)

    for kk in range(len(srt) - 1, -1, -1):
        s = c.seeds[srt[kk]]
        # containment test against existing regions (:671-706)
        hit_i = -1
        for i, p in enumerate(regs):
            if (
                s.rbeg < p.rb
                or s.rbeg + s.len > p.re
                or s.qbeg < p.qb
                or s.qbeg + s.len > p.qe
            ):
                continue
            if s.len - p.seedlen0 > 0.1 * l_query:
                continue
            qd = s.qbeg - p.qb
            rd = s.rbeg - p.rb
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit_i = i
                break
            qd = p.qe - (s.qbeg + s.len)
            rd = p.re - (s.rbeg + s.len)
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit_i = i
                break
        if hit_i >= 0:
            # check overlapping seeds in the same chain (:692-699)
            ii = kk + 1
            while ii < len(c.seeds):
                if not srt_alive[ii]:
                    ii += 1
                    continue
                t = c.seeds[srt[ii]]
                if t.len < s.len * 0.95:
                    ii += 1
                    continue
                if (
                    s.qbeg <= t.qbeg
                    and s.qbeg + s.len - t.qbeg >= s.len >> 2
                    and t.qbeg - s.qbeg != t.rbeg - s.rbeg
                ):
                    break
                if (
                    t.qbeg <= s.qbeg
                    and t.qbeg + t.len - s.qbeg >= s.len >> 2
                    and s.qbeg - t.qbeg != s.rbeg - t.rbeg
                ):
                    break
                ii += 1
            if ii == len(c.seeds):
                srt_alive[kk] = False
                continue

        a = AlnReg()
        # the C memset leaves secondary/secondary_all at 0 (bwamem.c:709);
        # Arachne never runs mem_mark_primary_se, so this is observable via
        # mem_reg2aln's secondary checks and the bridge's Secondary bool.
        a.secondary = 0
        a.secondary_all = 0
        a.w = aw0 = aw1 = opt.w
        a.score = a.truesc = -1
        a.rid = c.rid
        qle = tle = gtle = gscore = 0

        if s.qbeg:  # left extension (:715-744)
            qs = q[: s.qbeg][::-1].copy()
            tmp = s.rbeg - rmax0
            rs = rseq[:tmp][::-1].copy()
            for i in range(MAX_BAND_TRY):
                prev = a.score
                aw0 = opt.w << i
                a.score, qle, tle, gtle, gscore, max_off0 = extender(
                    qs, rs, aw0, opt.pen_clip5, s.len * opt.a
                )
                if a.score == prev or max_off0 < (aw0 >> 1) + (aw0 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip5:  # local
                a.qb = s.qbeg - qle
                a.rb = s.rbeg - tle
                a.truesc = a.score
            else:  # to-end
                a.qb = 0
                a.rb = s.rbeg - gtle
                a.truesc = gscore
        else:
            a.score = a.truesc = s.len * opt.a
            a.qb = 0
            a.rb = s.rbeg

        if s.qbeg + s.len != l_query:  # right extension (:746-771)
            sc0 = a.score
            qe = s.qbeg + s.len
            re = s.rbeg + s.len - rmax0
            assert re >= 0
            for i in range(MAX_BAND_TRY):
                prev = a.score
                aw1 = opt.w << i
                a.score, qle, tle, gtle, gscore, max_off1 = extender(
                    q[qe:], rseq[re:], aw1, opt.pen_clip3, sc0
                )
                if a.score == prev or max_off1 < (aw1 >> 1) + (aw1 >> 2):
                    break
            if gscore <= 0 or gscore <= a.score - opt.pen_clip3:
                a.qe = qe + qle
                a.re = rmax0 + re + tle
                a.truesc += a.score - sc0
            else:
                a.qe = l_query
                a.re = rmax0 + re + gtle
                a.truesc += gscore - sc0
        else:
            a.qe = l_query
            a.re = s.rbeg + s.len

        # seedcov (:774-779)
        a.seedcov = 0
        for t in c.seeds:
            if (
                t.qbeg >= a.qb
                and t.qbeg + t.len <= a.qe
                and t.rbeg >= a.rb
                and t.rbeg + t.len <= a.re
            ):
                a.seedcov += t.len
        a.w = max(aw0, aw1)
        a.seedlen0 = s.len
        a.frac_rep = c.frac_rep
        regs.append(a)


# ---------------------------------------------------------------------------
# de-overlap / dedup / patch (bwamem.c:391-489)
# ---------------------------------------------------------------------------

PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90


def _patch_reg(
    idx: Optional[FMIndex],
    q: Optional[np.ndarray],
    a: AlnReg,
    b: AlnReg,
    opt: MemOptions,
    mat: np.ndarray,
) -> Tuple[int, int]:
    """mem_patch_reg (bwamem.c:406-435): can a and b merge? -> (score, w)."""
    if idx is None or q is None:
        return 0, 0
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < idx.l_pac <= b.rb:
        return 0, 0
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return 0, 0
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs(
        (a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb)
    )
    if a.re < b.rb or a.qe < b.qb:
        if w > opt.w * 2 or r >= PATCH_MAX_R_BW:
            return 0, 0
    elif w > opt.w * 4 or r >= PATCH_MAX_R_BW * 2:
        return 0, 0
    w += a.w + b.w
    w = min(w, opt.w * 4)
    from .cigar import gen_cigar

    score, _, _, _ = gen_cigar(idx, q[a.qb : b.qe], a.rb, b.re, w, opt, mat, want_cigar=False)
    q_s = int((b.qe - a.qb) / ((b.qe - b.qb) + (a.qe - a.qb)) * (b.score + a.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb)) * (b.score + a.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, 0
    return score, w


def sort_dedup_patch(
    opt: MemOptions,
    regs: List[AlnReg],
    idx: Optional[FMIndex] = None,
    q: Optional[np.ndarray] = None,
    mat: Optional[np.ndarray] = None,
) -> List[AlnReg]:
    """mem_sort_dedup_patch (bwamem.c:437-489)."""
    n = len(regs)
    if n <= 1:
        return regs
    if mat is None:
        mat = opt.scoring_matrix()
    a = sorted(regs, key=lambda r: r.re)  # sort by END position
    for r in a:
        r.n_comp = 1
    for i in range(1, n):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        j = i - 1
        while j >= 0 and p.rid == a[j].rid and p.rb < a[j].re + opt.max_chain_gap:
            qreg = a[j]
            if qreg.qe == qreg.qb:
                j -= 1
                continue
            o_r = qreg.re - p.rb
            o_q = qreg.qe - p.qb if qreg.qb < p.qb else p.qe - qreg.qb
            m_r = min(qreg.re - qreg.rb, p.re - p.rb)
            m_q = min(qreg.qe - qreg.qb, p.qe - p.qb)
            if o_r > opt.mask_level_redun * m_r and o_q > opt.mask_level_redun * m_q:
                if p.score < qreg.score:
                    p.qe = p.qb  # exclude p
                    break
                else:
                    qreg.qe = qreg.qb  # exclude q
            elif qreg.rb < p.rb:
                score, w = _patch_reg(idx, q, qreg, p, opt, mat)
                if score > 0:  # merge q into p
                    p.n_comp += qreg.n_comp + 1
                    p.seedcov = max(p.seedcov, qreg.seedcov)
                    p.sub = max(p.sub, qreg.sub)
                    p.csub = max(p.csub, qreg.csub)
                    p.qb, p.rb = qreg.qb, qreg.rb
                    p.truesc = p.score = score
                    p.w = w
                    qreg.qb = qreg.qe
            j -= 1
    a = [r for r in a if r.qe > r.qb]
    # sort by score desc, then rb, then qb (alnreg_slt)
    a.sort(key=lambda r: (-r.score, r.rb, r.qb))
    for i in range(1, len(a)):
        if a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb and a[i].qb == a[i - 1].qb:
            a[i].qe = a[i].qb
    # note: the reference keeps index 0 unconditionally in the second
    # exclusion pass (bwamem.c:483-488 starts at i=1, m=1)
    out = [a[0]] if a else []
    out += [r for r in a[1:] if r.qe > r.qb]
    return out


def mark_primary(opt: MemOptions, regs: List[AlnReg], read_id: int) -> int:
    """mem_mark_primary_se (bwamem.c:521-558); returns n_pri."""
    n = len(regs)
    if n == 0:
        return 0
    for i, r in enumerate(regs):
        r.sub = r.alt_sc = 0
        r.secondary = r.secondary_all = -1
        r.hash = hash_64(read_id + i)
    n_pri = sum(1 for r in regs if not r.is_alt)
    # sort: score desc, is_alt asc, hash asc (alnreg_hlt)
    regs.sort(key=lambda r: (-r.score, r.is_alt, r.hash))
    _mark_primary_core(opt, regs, n)
    for i, p in enumerate(regs):
        p.secondary_all = i
        if not p.is_alt and p.secondary >= 0 and regs[p.secondary].is_alt:
            p.alt_sc = regs[p.secondary].score
    if 0 <= n_pri < n:
        z = [0] * n
        if n_pri > 0:
            regs.sort(key=lambda r: (r.is_alt, -r.score, r.hash))  # alnreg_hlt2
        for i, r in enumerate(regs):
            z[r.secondary_all] = i
        for r in regs:
            if r.secondary >= 0:
                r.secondary_all = z[r.secondary]
                if r.is_alt:
                    r.secondary = 1 << 30
            else:
                r.secondary_all = -1
        if n_pri > 0:
            for i in range(n_pri):
                regs[i].sub = 0
                regs[i].secondary = -1
            _mark_primary_core(opt, regs[:n_pri], n_pri)
    else:
        for r in regs:
            r.secondary_all = r.secondary
    return n_pri


def _mark_primary_core(opt: MemOptions, a: List[AlnReg], n: int) -> None:
    """mem_mark_primary_se_core (bwamem.c:493-519)."""
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, n):
        placed = False
        for k in z:
            b_max = max(a[k].qb, a[i].qb)
            e_min = min(a[k].qe, a[i].qe)
            if e_min > b_max:
                min_l = min(a[i].qe - a[i].qb, a[k].qe - a[k].qb)
                if e_min - b_max >= min_l * opt.mask_level:
                    if a[k].sub == 0:
                        a[k].sub = a[i].score
                    if a[k].score - a[i].score <= tmp and (a[k].is_alt or not a[i].is_alt):
                        a[k].sub_n += 1
                    a[i].secondary = k
                    placed = True
                    break
        if not placed:
            z.append(i)
