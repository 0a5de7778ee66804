# Frozen copy of arachne_tpu_torch/align/pairing.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Mate rescue via windowed full Smith-Waterman.

Reproduces mem_infer_dir (bwamem_pair.c:23-30) and mem_matesw
(bwamem_pair.c:111-180) with the reference's hard-coded FR insert-size
model (gobwa.go:229-237): rescue only runs for orientations whose distance
window is not already satisfied, fetching a [low, high]-bounded reference
window around the anchor and running full SW.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import InsertSizeModel, MemOptions
from ..index.fmindex import FMIndex
from . import ksw
from .extend import AlnReg, sort_dedup_patch


def infer_dir(l_pac: int, b1: int, b2: int) -> Tuple[int, int]:
    """mem_infer_dir: orientation code (FF=0, FR=1, RF=2, RR=3) + distance."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def matesw(
    idx: FMIndex,
    opt: MemOptions,
    pes: InsertSizeModel,
    anchor: AlnReg,
    mate_seq: np.ndarray,
    mate_regs: List[AlnReg],
    mat: np.ndarray,
) -> int:
    """mem_matesw (bwamem_pair.c:111-180): try to rescue the mate around
    ``anchor``.  Appends found regions to mate_regs (kept sorted by score)
    and dedups.  Returns the number of rescue attempts performed.

    Only the FR orientation is live (pes fixes FF/RF/RR as failed,
    gobwa.go:230-237)."""
    l_pac = idx.l_pac
    l_ms = len(mate_seq)
    skip = [True, False, True, True]  # failed flags: only FR (r=1) alive
    for m in mate_regs:
        r, dist = infer_dir(l_pac, anchor.rb, m.rb)
        if r == 1 and pes.low <= dist <= pes.high:
            skip[r] = True
    if all(skip):
        return 0
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.array([3 - b if b < 4 else 4 for b in mate_seq[::-1]], dtype=np.uint8)
        else:
            seq = mate_seq
        if not is_rev:
            rb = anchor.rb + pes.low if is_larger else anchor.rb - pes.high
            re = (anchor.rb + pes.high if is_larger else anchor.rb - pes.low) + l_ms
        else:
            rb = (anchor.rb + pes.low if is_larger else anchor.rb - pes.high) - l_ms
            re = anchor.rb + pes.high if is_larger else anchor.rb - pes.low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        rid = -1
        ref = None
        if rb < re:
            ref, rid, rb, re = idx.fetch_seq(rb, (rb + re) >> 1, re)
        if anchor.rid == rid and re - rb >= opt.min_seed_len:
            xtra = (
                ksw.KSW_XSUBO
                | ksw.KSW_XSTART
                | (ksw.KSW_XBYTE if l_ms * opt.a < 250 else 0)
                | (opt.min_seed_len * opt.a)
            )
            aln = ksw.align2(
                seq, ref, mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, xtra
            )
            if aln.score >= opt.min_seed_len and aln.qb >= 0:
                b = AlnReg()
                b.rid = anchor.rid
                b.is_alt = anchor.is_alt
                b.qb = l_ms - (aln.qe + 1) if is_rev else aln.qb
                b.qe = l_ms - aln.qb if is_rev else aln.qe + 1
                b.rb = (l_pac << 1) - (rb + aln.te + 1) if is_rev else rb + aln.tb
                b.re = (l_pac << 1) - (rb + aln.tb) if is_rev else rb + aln.te + 1
                b.score = aln.score  # truesc stays 0 (memset) as in the C
                b.csub = aln.score2
                b.secondary = -1
                b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                # insert keeping the list sorted by score (bwamem_pair.c:166-171)
                ins = len(mate_regs)
                for i in range(len(mate_regs)):
                    if mate_regs[i].score < b.score:
                        ins = i
                        break
                mate_regs.insert(ins, b)
            n += 1
        if n:
            deduped = list(sort_dedup_patch(opt, mate_regs))
            mate_regs.clear()
            mate_regs.extend(deduped)
    return n
