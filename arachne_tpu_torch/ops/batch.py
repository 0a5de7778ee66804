"""Batched candidate generation: mem_align1_core over many reads with every
seed extension run in device waves.

A copy of the reference's arachne_tpu/ops/batch.py (``batch_align_single``
and its helpers; that module cannot be imported without JAX) bound to the
port's ``BatchExtender``:

  1. SMEM seeding, on the device (``fm_seed.collect_seeds_device_flat``,
     kernels S1 and S3) when given the index's device tables, else on the
     host (the native C++ collector); either way the seeds enter the native
     chainer as one flat ``SeedBatch``; then filtering per read;
  2. wave 1: every seed's LEFT extension at the base band, deduplicated by
     content; rounds 2-4: the doubled-band retries (bwamem.c:723-733) and
     the RIGHT extensions whose h0 the left result fixes;
  3. host: replay chain2aln's sequential bookkeeping with the results in
     hand, looked up by problem content (exact host oracle on a miss).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..align.chain import Chain, filter_chained_seeds
from ..align.chain_native import mem_chain_flat_native
from ..align.extend import AlnReg, cal_max_gap, chain2aln, sort_dedup_patch
from ..align.smem_native import collect_seeds_native_flat
from ..config import MemOptions
from ..index.fmindex import FMIndex
from ..runtime.timers import TIMERS

from .fm_rank import RankTables
from .fm_seed import SeedBatch, collect_seeds_device_flat
from .sw_extend import BatchExtender


def _problem_key(qs: np.ndarray, ts: np.ndarray, w: int, end_bonus: int, h0: int):
    return (qs.tobytes(), ts.tobytes(), w, end_bonus, h0)


class _SeedProblems:
    """Extension problems for one seed within one chain."""

    __slots__ = ("left", "right_parts", "h0")

    def __init__(self):
        self.left = None          # (qs, rs) or None
        self.right_parts = None   # (q_tail, r_tail) or None
        self.h0 = 0               # s.len * a


def _chain_window(idx: FMIndex, q: np.ndarray, c: Chain, opt: MemOptions):
    """The rmax/rseq construction of mem_chain2aln (bwamem.c:642-659)."""
    if c.win_seq is not None:
        return c.win_seq, c.win_rmax0
    l_query = len(q)
    l_pac = idx.l_pac
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
    return rseq, rmax0


def batch_align_single(
    idx: FMIndex,
    opt: MemOptions,
    reads: List[np.ndarray],
    extender_batch: BatchExtender,
    mat: Optional[np.ndarray] = None,
    dfm: Optional[RankTables] = None,
) -> List[List[AlnReg]]:
    """mem_align1_core over a batch of reads with device-batched extension.

    With ``dfm`` (the index's rank tables, replicated or sharded) seeding
    runs on its device too."""
    if mat is None:
        mat = opt.scoring_matrix()
    if dfm is not None:
        with TIMERS.stage("seed.device"):
            flat = collect_seeds_device_flat(reads, opt, dfm)
    else:
        with TIMERS.stage("seed.host"):
            # C++ three-pass collector: exact scalar output, releases the GIL
            flat = SeedBatch.of_rows(len(reads), *collect_seeds_native_flat(idx, reads, opt))
    per_read_chains: List[List[Chain]] = []
    seed_probs: List[_SeedProblems] = []
    with TIMERS.stage("chain.host"):
        chained = mem_chain_flat_native(idx, reads, opt, flat.k, flat.s, flat.qb, flat.qe,
                                        flat.off)
        for codes, chains in zip(reads, chained):
            filter_chained_seeds(idx, codes, chains, opt)
            per_read_chains.append(chains)
            l_query = len(codes)
            for c in chains:
                if not c.seeds:
                    continue
                rseq, rmax0 = _chain_window(idx, codes, c, opt)
                for s in c.seeds:
                    sp = _SeedProblems()
                    sp.h0 = s.len * opt.a
                    if s.qbeg:
                        qs = codes[: s.qbeg][::-1].copy()
                        rs = rseq[: s.rbeg - rmax0][::-1].copy()
                        sp.left = (qs, rs)
                    if s.qbeg + s.len != l_query:
                        sp.right_parts = (
                            codes[s.qbeg + s.len :],
                            rseq[s.rbeg + s.len - rmax0 :],
                        )
                    seed_probs.append(sp)
        TIMERS.add_to("superbatch", chains=sum(map(len, per_read_chains)))

    cache: Dict[Tuple, Tuple] = {}

    def _run_wave(probs: List[Tuple]) -> None:
        """Dispatch the wave's problems, deduplicated by content; results
        land in the shared cache."""
        uniq: List[Tuple] = []
        seen = set()
        for p in probs:
            key = _problem_key(*p)
            if key in seen or key in cache:
                continue
            seen.add(key)
            uniq.append(p)
        if not uniq:
            return
        for p in uniq:
            extender_batch.submit(*p)
        with TIMERS.stage("extend.device"):
            out = extender_batch.run()
        for p, res in zip(uniq, out):
            cache[_problem_key(*p)] = res

    def _needs_retry(res: Tuple, prev_score: int, band_try: int) -> bool:
        """The band-doubling continue condition (bwamem.c:723-733): another
        try runs only when the score changed AND max_off reached 3/4 of the
        band."""
        aw = opt.w << band_try
        return not (res[0] == prev_score or res[5] < (aw >> 1) + (aw >> 2))

    # Round 1: every seed's LEFT extension at the base band.  The doubled-
    # band left retries and the RIGHT extensions whose h0 (= effective left
    # score) is known merge into round 2; right extensions of retried seeds
    # plus right-side retries form round 3; round 4 covers right retries
    # from round 3.
    wave1 = [
        (sp.left[0], sp.left[1], opt.w, opt.pen_clip5, sp.h0)
        for sp in seed_probs
        if sp.left is not None
    ]
    if wave1:
        _run_wave(wave1)

    def _left_sc0(sp):
        """Effective left score; None if its doubled-band try is pending."""
        if sp.left is None:
            return sp.h0
        qs, rs = sp.left
        res0 = cache[_problem_key(qs, rs, opt.w, opt.pen_clip5, sp.h0)]
        if not _needs_retry(res0, -1, 0):
            return res0[0]
        key1 = _problem_key(qs, rs, opt.w << 1, opt.pen_clip5, sp.h0)
        res1 = cache.get(key1)
        return res1[0] if res1 is not None else None

    round2: List[Tuple] = []
    deferred: List[object] = []     # right extensions waiting on a left retry
    right_submitted: List[Tuple] = []
    for sp in seed_probs:
        sc0 = _left_sc0(sp)
        if sc0 is None:
            qs, rs = sp.left
            round2.append((qs, rs, opt.w << 1, opt.pen_clip5, sp.h0))
            if sp.right_parts is not None:
                deferred.append(sp)
        elif sp.right_parts is not None:
            qt, rt = sp.right_parts
            round2.append((qt, rt, opt.w, opt.pen_clip3, sc0))
            right_submitted.append((qt, rt, opt.w, opt.pen_clip3, sc0))
    if round2:
        _run_wave(round2)

    round3: List[Tuple] = []
    for sp in deferred:
        sc0 = _left_sc0(sp)
        qt, rt = sp.right_parts
        round3.append((qt, rt, opt.w, opt.pen_clip3, sc0))
    for p in right_submitted:
        res = cache[_problem_key(*p)]
        if _needs_retry(res, p[4], 0):
            round3.append((p[0], p[1], opt.w << 1, p[3], p[4]))
    if round3:
        _run_wave(round3)
        retry4 = [
            (qt, rt, opt.w << 1, eb, sc0)
            for (qt, rt, w, eb, sc0) in round3
            if w == opt.w
            and _needs_retry(cache[_problem_key(qt, rt, w, eb, sc0)], sc0, 0)
        ]
        if retry4:
            _run_wave(retry4)

    def lookup_extender(qs, ts, w, end_bonus, h0):
        key = _problem_key(np.asarray(qs), np.asarray(ts), w, end_bonus, h0)
        res = cache.get(key)
        if res is None:
            from ..align import ksw

            res = ksw.extend2(
                np.asarray(qs), np.asarray(ts), mat,
                opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                w, end_bonus, opt.zdrop, h0,
            )
            cache[key] = res
        return res

    out: List[List[AlnReg]] = []
    with TIMERS.stage("extend.replay"):
        for codes, chains in zip(reads, per_read_chains):
            regs: List[AlnReg] = []
            for c in chains:
                chain2aln(idx, codes, c, opt, regs, extender=lookup_extender, mat=mat)
            regs = sort_dedup_patch(opt, regs, idx, codes, mat)
            out.append(regs)
    return out
