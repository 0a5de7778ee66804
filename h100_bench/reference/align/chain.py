# Frozen copy of arachne_tpu_torch/align/chain.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Seed chaining and chain filtering.

Reproduces mem_chain (bwamem.c:251-315), test_and_merge (:190-211),
mem_chain_weight (:213-232), mem_chain_flt (:327-385) and
mem_flt_chained_seeds (:598-615).  The reference uses a B-tree keyed by
chain position; we use a sorted list with bisect — iteration order and
merge decisions are identical.
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import MemOptions
from ..index.fmindex import FMIndex
from .smem import SMEM, collect_seeds

MEM_SHORT_EXT = 50
MEM_SHORT_LEN = 200
MEM_HSP_COEF = 1.1
MEM_MINSC_COEF = 5.5
MEM_SEEDSW_COEF = 0.05


@dataclass(slots=True)
class Seed:
    """mem_seed_t: one seed occurrence on the fwd-rev reference."""

    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclass
class Chain:
    """mem_chain_t."""

    pos: int
    rid: int
    seeds: List[Seed] = field(default_factory=list)
    w: int = 0
    kept: int = 0
    first: int = -1
    is_alt: bool = False
    frac_rep: float = 0.0
    # pre-fetched mem_chain2aln extension window (native chaining path);
    # None -> chain2aln computes and fetches it itself
    win_seq: Optional[np.ndarray] = None
    win_rmax0: int = 0

    @property
    def qbeg(self) -> int:
        return self.seeds[0].qbeg

    @property
    def qend(self) -> int:
        last = self.seeds[-1]
        return last.qbeg + last.len


def chain_weight(c: Chain) -> int:
    """mem_chain_weight (bwamem.c:213-232): min of query/ref coverage."""
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp = w
    w = 0
    end = 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    w = min(w, tmp)
    return min(w, (1 << 30) - 1)


def _test_and_merge(opt: MemOptions, l_pac: int, c: Chain, s: Seed, seed_rid: int) -> bool:
    """test_and_merge (bwamem.c:190-211)."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (
        s.qbeg >= c.seeds[0].qbeg
        and s.qbeg + s.len <= qend
        and s.rbeg >= c.seeds[0].rbeg
        and s.rbeg + s.len <= rend
    ):
        return True  # contained; do nothing
    if (last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and s.rbeg >= l_pac:
        return False  # different strands
    x = s.qbeg - last.qbeg
    y = s.rbeg - last.rbeg
    if (
        y >= 0
        and x - y <= opt.w
        and y - x <= opt.w
        and x - last.len < opt.max_chain_gap
        and y - last.len < opt.max_chain_gap
    ):
        c.seeds.append(s)
        return True
    return False


def _occ_rows(mems: List[SMEM], opt: MemOptions):
    """The sampled SA rows of every seed occurrence (bwamem.c:282-287):
    high-occ SMEMs are stride-sampled down to max_occ occurrences."""
    all_rows: List[np.ndarray] = []
    occ_slices: List[Tuple[int, int]] = []
    off = 0
    for p in mems:
        step = p.s // opt.max_occ if p.s > opt.max_occ else 1
        n_occ = min((p.s + step - 1) // step, opt.max_occ)
        rows = p.k + np.arange(n_occ, dtype=np.int64) * step
        all_rows.append(rows)
        occ_slices.append((off, off + n_occ))
        off += n_occ
    return all_rows, occ_slices, off


def mem_chain_batch(
    idx: FMIndex,
    reads: List[np.ndarray],
    opt: MemOptions,
    all_mems: List[List[SMEM]],
) -> List[List[Chain]]:
    """mem_chain over MANY reads with the SA walks + rid interval checks
    flattened into ONE batched lookup across the whole read set (the
    per-read batching in mem_chain still paid per-call numpy overhead
    9600x per superbatch)."""
    rows_flat: List[np.ndarray] = []
    lens_flat: List[np.ndarray] = []
    per_read: List[Tuple[List[Tuple[int, int]], int]] = []
    for q, mems in zip(reads, all_mems):
        if len(q) < opt.min_seed_len:
            per_read.append(([], 0))
            continue
        rows, slices, n = _occ_rows(mems, opt)
        per_read.append((slices, n))
        rows_flat.extend(rows)
        lens_flat.extend(
            np.full(b - a, m.length, np.int64) for (a, b), m in zip(slices, mems)
        )
    rbegs = rids = np.empty(0, np.int64)
    if rows_flat:
        cat = np.concatenate(rows_flat)
        rbegs = idx.sa(cat)
        rids = idx.intv2rid(rbegs, rbegs + np.concatenate(lens_flat))
    out: List[List[Chain]] = []
    base = 0
    for (q, mems), (slices, n) in zip(zip(reads, all_mems), per_read):
        if len(q) < opt.min_seed_len:
            out.append([])
            continue
        out.append(
            mem_chain(
                idx, q, opt, mems=mems,
                occ_data=(slices, rbegs[base : base + n], rids[base : base + n]),
            )
        )
        base += n
    return out


def mem_chain(
    idx: FMIndex,
    q: np.ndarray,
    opt: MemOptions,
    mems: Optional[List[SMEM]] = None,
    occ_data=None,
) -> List[Chain]:
    """mem_chain (bwamem.c:251-315): SMEMs -> chains of co-linear seeds.

    ``mems`` may be precomputed (e.g. by the wave-batched collector);
    ``occ_data`` may carry pre-batched SA/rid lookups (mem_chain_batch)."""
    length = len(q)
    if length < opt.min_seed_len:
        return []
    if mems is None:
        mems = collect_seeds(idx, q, opt)

    # frac_rep: fraction of the read covered by high-occ seeds (:265-272)
    l_rep = 0
    b = e = 0
    for p in mems:
        if p.s <= opt.max_occ:
            continue
        sb, se = p.qb, p.qe
        if sb > e:
            l_rep += e - b
            b, e = sb, se
        else:
            e = max(e, se)
    l_rep += e - b

    chains: List[Chain] = []      # kept sorted by pos
    positions: List[int] = []
    l_pac = idx.l_pac
    # batch all SA lookups + rid checks across every occurrence up front
    if occ_data is not None:
        occ_slices, flat_rbegs, flat_rids = occ_data
        off = len(flat_rbegs)
    else:
        all_rows, occ_slices, off = _occ_rows(mems, opt)
        if off:
            flat_rows = np.concatenate(all_rows)
            flat_rbegs = idx.sa(flat_rows)
            lens = np.concatenate(
                [np.full(b - a, m.length, np.int64) for (a, b), m in zip(occ_slices, mems)]
            )
            flat_rids = idx.intv2rid(flat_rbegs, flat_rbegs + lens)
    for pi, p in enumerate(mems):
        slen = p.length
        a, b = occ_slices[pi]
        for rbeg, rid in zip(flat_rbegs[a:b], flat_rids[a:b]):
            rbeg = int(rbeg)
            rid = int(rid)
            seed = Seed(rbeg=rbeg, qbeg=p.qb, len=slen, score=slen)
            if rid >= 0:
                to_add = True
                if chains:
                    # closest chain with pos <= rbeg (kb_intervalp "lower")
                    ins = bisect.bisect_right(positions, rbeg)
                    if ins > 0 and _test_and_merge(opt, l_pac, chains[ins - 1], seed, rid):
                        to_add = False
                if to_add:
                    c = Chain(pos=rbeg, rid=rid, seeds=[seed])
                    ins = bisect.bisect_left(positions, rbeg)
                    positions.insert(ins, rbeg)
                    chains.insert(ins, c)
    fr = l_rep / length
    for c in chains:
        c.frac_rep = fr
    return chains


def chain_filter(opt: MemOptions, chains: List[Chain]) -> List[Chain]:
    """mem_chain_flt (bwamem.c:327-385)."""
    if not chains:
        return []
    a = []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            a.append(c)
    if not a:
        return []
    # sort by weight descending (flt_lt: (a).w > (b).w), stable
    a.sort(key=lambda c: -c.w)
    kept_idx = [0]
    a[0].kept = 3
    for i in range(1, len(a)):
        large_ovlp = False
        broke = False
        for j in kept_idx:
            b_max = max(a[j].qbeg, a[i].qbeg)
            e_min = min(a[j].qend, a[i].qend)
            if e_min > b_max and (not a[j].is_alt or a[i].is_alt):
                li = a[i].qend - a[i].qbeg
                lj = a[j].qend - a[j].qbeg
                min_l = min(li, lj)
                if e_min - b_max >= min_l * opt.mask_level and min_l < opt.max_chain_gap:
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if (
                        a[i].w < a[j].w * opt.drop_ratio
                        and a[j].w - a[i].w >= opt.min_seed_len * 2
                    ):
                        broke = True
                        break
        if not broke:
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    # cap the number of kept=1/2 chains to extend (:373-378)
    k = 0
    cut = len(a)
    for i, c in enumerate(a):
        if c.kept == 0 or c.kept == 3:
            continue
        k += 1
        if k >= opt.max_chain_extend:
            cut = i
            break
    for i in range(cut, len(a)):
        if a[i].kept < 3:
            a[i].kept = 0
    return [c for c in a if c.kept != 0]


def _seed_sw(idx: FMIndex, q: np.ndarray, s: Seed, opt: MemOptions, mat) -> int:
    """mem_seed_sw (bwamem.c:571-596)."""
    from . import ksw

    l_query = len(q)
    l_pac = idx.l_pac
    if s.len >= MEM_SHORT_LEN:
        return -1
    qb, qe = s.qbeg, s.qbeg + s.len
    rb, re = s.rbeg, s.rbeg + s.len
    mid = (rb + re) >> 1
    qb = max(qb - MEM_SHORT_EXT, 0)
    qe = min(qe + MEM_SHORT_EXT, l_query)
    rb = max(rb - MEM_SHORT_EXT, 0)
    re = min(re + MEM_SHORT_EXT, l_pac << 1)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return -1
    rseq, rid, rb, re = idx.fetch_seq(rb, mid, re)
    res = ksw.align2(
        q[qb:qe], rseq, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, ksw.KSW_XSTART
    )
    return res.score


def filter_chained_seeds(
    idx: FMIndex, q: np.ndarray, chains: List[Chain], opt: MemOptions
) -> None:
    """mem_flt_chained_seeds (bwamem.c:598-615).  No-op for short reads
    (min_l > 0.05*l_query), which covers all linked-read inputs."""
    l_query = len(q)
    min_l = (
        MEM_HSP_COEF * opt.min_chain_weight
        if opt.min_chain_weight
        else MEM_MINSC_COEF * math.log(l_query)
    )
    if min_l > MEM_SEEDSW_COEF * l_query:
        return
    mat = opt.scoring_matrix()
    min_hsp_score = int(opt.a * min_l + 0.499)
    for c in chains:
        kept = []
        for s in c.seeds:
            s.score = _seed_sw(idx, q, s, opt, mat)
            if s.score < 0 or s.score >= min_hsp_score:
                s.score = s.len * opt.a if s.score < 0 else s.score
                kept.append(s)
        if len(kept) != len(c.seeds):
            # the pre-fetched extension window (native chaining) was
            # computed over ALL seeds; the reference computes rmax AFTER
            # this filter (mem_chain2aln follows mem_flt_chained_seeds),
            # so a narrower seed set must refetch
            c.win_seq = None
        c.seeds = kept
