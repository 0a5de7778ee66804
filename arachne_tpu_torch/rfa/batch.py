"""RFA's host stage for a superbatch of barcodes, in one native call.

GetAlignments (aligner.go:1484-1631) and the tag -> molecules -> optimize
-> MAPQ tail of DoRFAForOneBarcode (aligner.go:440-501) over every hit of
every barcode: ``native/rfa_tail.cpp`` ``rfa_superbatch`` walks each hit's
CIGAR against its reference window, scores it, keeps the hits within
``alignment_score_delta`` of their read's best chain score, and runs each
barcode's tail on the kept ones, with the interpreter lock released.
Python then builds each Alignment, with its MapQData, once, from the
outputs.  The Python forms (``candidates.get_alignments``,
``engine._finish_barcode``) stay the reference this is held to
(tests/test_torch_rfa_native.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
from itertools import compress, repeat
from operator import attrgetter
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from ..align.cigar import FlatAlns
from ..config import ArachneConfig
from ..index.fmindex import FMIndex
from ..runtime.timers import TIMERS
from .candidates import ChainedHit, FastQRecordView, chain_codes
from .types import Alignment, MapQData, Region

# the rows of the native outputs, a column a hit (rfa_tail.cpp I32Row, F64Row)
(MATCHES, MISMATCHES, INDELS, SOFT_CLIPPED, SOFT_LEN, N_LOCS, KEPT, ACTIVE, PROPER, BWA_PICK,
 MAPQ, MOL_ID, ACTIVE_MOL, MATE, SECOND_BEST, SB_PROPER, SB_MOL_READS, COPIES, COPIES_IN,
 COPIES_OUT, UNIQ_MOLS, READS_IN_MOL) = range(22)
(LOGP, UPDATED_LOGP, MOL_CONF, MOL_DIFF, SUM_MOVE, SB_SCORE, SB_MOL_CONF, MD_SCORE) = range(8)

_CHAIN = attrgetter("pos", "aend", "score", "hit_id", "mate_id", "read1", "read_id", "easy")

# per barcode: the kept alignments by read; every alignment of each read the
# split-read pass may split; the molecules
Finished = Tuple[List[List[Alignment]], List[List[Alignment]], int]


def _build(cls, cols: Dict[str, object]) -> list:
    """cls(**row) for each row of the columns, a column a field."""
    return list(map(cls, *(cols[f.name] for f in dataclasses.fields(cls))))


def _ptr(a, ctype):
    return None if a is None else native._ptr(a, ctype)


def run_superbatch(
    idx: FMIndex,
    cfg: ArachneConfig,
    reads: List[List[FastQRecordView]],
    chains: List[List[List[ChainedHit]]],
    alns: FlatAlns,
    run_rfa: List[bool],
    centromeres: Dict[str, Region],
    stage: Optional[str] = None,
) -> List[Finished]:
    """Each barcode's alignments: ``reads[b]`` are barcode b's pairs,
    ``chains[b]`` get_chains' hit lists of its reads (2 a pair), and row j
    of ``alns`` is reg2aln's record of the j-th hit with a region, in that
    order across every barcode.  ``stage`` names the TIMERS stage opened
    around the native call."""
    if not reads:
        return []
    recs = [rec for rs in reads for rec in rs]
    lists = [lst for c in chains for lst in c]
    hits = [ch for lst in lists for ch in lst]
    n_reads, H = len(lists), len(hits)
    assert n_reads == 2 * len(recs)
    bc_read_off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([2 * len(rs) for rs in reads], out=bc_read_off[1:])
    read_hit_off = np.zeros(n_reads + 1, np.int64)
    np.cumsum(np.fromiter(map(len, lists), np.int64, n_reads), out=read_hit_off[1:])
    hits_of = np.repeat(np.arange(n_reads), np.diff(read_hit_off))   # each hit's read

    # the reads: codes as sequenced (every read has a hit, a placeholder at
    # least, which holds them) and the jitter seeds, md5 of the read name
    codes = [chain_codes(lst[0]) for lst in lists]
    code_off = np.zeros(n_reads + 1, np.int64)
    np.cumsum(np.fromiter(map(len, codes), np.int64, n_reads), out=code_off[1:])
    seeds = [int.from_bytes(hashlib.md5(r.read_info.encode()).digest()[:8], "little")
             for r in recs]
    jitter = np.repeat(np.array(seeds, np.uint64), 2)

    # the hits: the chains' fields, and reg2aln's where a hit has a region
    pos, aend, score, hit_id, mate_id, read1, read_id, easy = map(list, zip(*map(_CHAIN, hits)))
    job = np.fromiter((e is not None for e in easy), bool, H)
    n_jobs = len(alns.nm)
    assert int(job.sum()) == n_jobs
    cig_off = np.zeros(H + 1, np.int64)
    cig_off[1:][job] = np.diff(alns.cig_off)
    np.cumsum(cig_off, out=cig_off)
    nm, rid, is_rev = np.zeros(H, np.int64), np.full(H, -1, np.int64), np.zeros(H, bool)
    nm[job], rid[job], is_rev[job] = alns.nm, alns.rid, alns.is_rev
    readmap = np.zeros((2, H), np.int64)
    for row, field in enumerate(("read_s", "read_e")):
        readmap[row, job] = np.fromiter(map(attrgetter(field), compress(easy, job)), np.int64,
                                        n_jobs)
    ch_pos, ch_aend = np.array(pos, np.int64), np.array(aend, np.int64)
    ch_score, ch_id, ch_mate = (np.array(c, np.int32) for c in (score, hit_id, mate_id))

    names = [a.name for a in idx.packed.anns] + [""]   # rid -1: no contig
    cen = np.full((2, len(names)), -1, np.int64)
    for i, name in enumerate([""] + names[:-1]):       # by rid + 1
        region = centromeres.get(name)
        if region is not None:
            cen[:, i] = region.start, region.end
    loc_cap = np.zeros(H + 1, np.int64)
    np.cumsum(np.diff(code_off)[hits_of], out=loc_cap[1:])

    coords = np.empty((2, H), np.int64)
    i32 = np.empty((22, H), np.int32)
    f64 = np.empty((8, H), np.float64)
    locs = np.empty(max(int(loc_cap[-1]), 1), np.int64)
    rlocs = np.empty(len(locs), np.int32)
    loc_off = np.empty(H + 1, np.int64)
    n_mol = np.zeros(len(reads), np.int32)
    rc = np.zeros(len(reads), np.int32)
    cigar = np.ascontiguousarray(alns.cigar, np.int32)
    contig_off = np.ascontiguousarray(idx._offsets, np.int64)
    run = np.array(run_rfa, np.uint8)
    i64, u8, i32_t = ctypes.c_int64, ctypes.c_uint8, ctypes.c_int32
    rfa = cfg.rfa
    with TIMERS.stage(stage) if stage else contextlib.nullcontext():
        native.require_lib().rfa_superbatch(
            len(reads), _ptr(bc_read_off, i64), _ptr(read_hit_off, i64), _ptr(run, u8),
            _ptr(np.concatenate(codes), u8), _ptr(code_off, i64), _ptr(jitter, ctypes.c_uint64),
            H, _ptr(ch_pos, i64), _ptr(ch_aend, i64), _ptr(ch_score, i32_t), _ptr(ch_id, i32_t),
            _ptr(ch_mate, i32_t),
            _ptr(cigar, i32_t), _ptr(cig_off, i64),
            _ptr(nm, i64), _ptr(rid, i64), _ptr(is_rev.view(np.uint8), u8),
            _ptr(idx._fwd_codes(), u8), _ptr(idx.packed.pac, u8), idx.l_pac,
            _ptr(contig_off, i64), _ptr(idx._lengths, i64), len(contig_off),
            _ptr(cen[0], i64), _ptr(cen[1], i64), rfa.improper_pair_penalty,
            rfa.reference_length, rfa.alignment_score_delta, rfa.anneal_temp_steps,
            rfa.anneal_steps_per_temp_factor, _ptr(loc_cap, i64),
            _ptr(coords, i64), _ptr(i32, i32_t), _ptr(f64, ctypes.c_double),
            _ptr(locs, i64), _ptr(rlocs, i32_t), _ptr(loc_off, i64), _ptr(n_mol, i32_t),
            _ptr(rc, i32_t), native.native_threads(),
        )
    if rc.any():
        b = int(np.flatnonzero(rc)[0])
        raise AssertionError(f"barcode {b} of the superbatch: an active alignment has an "
                             f"inactive mate (checkMates)")

    # The Alignments the writer and the split-read pass read, each once with
    # its final values: the kept hits, and every hit of a read whose first
    # active alignment is placed and leaves 15 bases or more of the read
    # uncovered -- for any other read split.get_split_alignment returns at
    # its first two tests, and the hits the filter dropped are never read.
    active = np.flatnonzero(i32[ACTIVE])
    reads_active, first = np.unique(hits_of[active], return_index=True)
    first = active[first]
    uncovered = np.diff(code_off)[reads_active] - np.abs(readmap[1, first] - readmap[0, first])
    splits = reads_active[(coords[0, first] != -1) & (uncovered >= 15)]
    need = i32[KEPT].astype(bool)
    need[np.isin(hits_of, splits)] = True
    sel = np.flatnonzero(need)
    pick = lambda col: list(compress(col, need))
    ints, floats = i32[:, sel].tolist(), f64[:, sel].tolist()
    flags = {row: i32[row, sel].astype(bool).tolist()
             for row in (ACTIVE, PROPER, BWA_PICK, ACTIVE_MOL, SB_PROPER)}
    n_locs = np.diff(loc_off)
    of_needed = np.repeat(need, n_locs)
    L, RL = locs[: loc_off[-1]][of_needed].tolist(), rlocs[: loc_off[-1]][of_needed].tolist()
    lo = np.zeros(len(sel) + 1, np.int64)
    np.cumsum(n_locs[sel], out=lo[1:])
    lo, hi = lo[:-1].tolist(), lo[1:].tolist()
    C = cigar.ravel().tolist()
    co, ce = (2 * cig_off[sel]).tolist(), (2 * cig_off[sel + 1]).tolist()
    reads_sel = hits_of[sel].tolist()
    per_read = lambda col: list(map(col.__getitem__, reads_sel))
    mapq_data = _build(MapQData, dict(
        copies=ints[COPIES], copies_in_active_molecules=ints[COPIES_IN],
        unique_molecules_active=ints[UNIQ_MOLS],
        copies_outside_active_molecules=ints[COPIES_OUT], reads_in_molecule=ints[READS_IN_MOL],
        active_alignments_in_molecules=repeat(""), second_best=repeat(None),
        second_best_score=floats[SB_SCORE], score=floats[MD_SCORE],
        second_best_proper_pair=flags[SB_PROPER], second_best_molecule_reads=ints[SB_MOL_READS],
        second_best_molecule_confidence=floats[SB_MOL_CONF],
    ))
    objs = _build(Alignment, dict(
        id=pick(hit_id), read1=pick(read1), is_proper=flags[PROPER],
        soft_clipped=ints[SOFT_CLIPPED], soft_clipped_length=ints[SOFT_LEN],
        barcode=per_read([r.barcode for r in recs for _ in (0, 1)]),
        read_name=per_read([r.read_info for r in recs for _ in (0, 1)]),
        read_seq=per_read([s for r in recs for s in (r.read1, r.read2)]),
        read_qual=per_read([q for r in recs for q in (r.qual1, r.qual2)]),
        mapq=ints[MAPQ], molecule_difference=floats[MOL_DIFF],
        contig=list(map(names.__getitem__, rid[sel].tolist())),
        pos=coords[0, sel].tolist(), aend=coords[1, sel].tolist(), score=pick(score),
        mismatches=ints[MISMATCHES], matches=ints[MATCHES],
        mismatch_locs=[L[a:b] for a, b in zip(lo, hi)],
        mismatch_read_locs=[RL[a:b] for a, b in zip(lo, hi)],
        indels=ints[INDELS], read_id=pick(read_id), bad_molecule=repeat(False),
        mate_id=pick(mate_id), mate_alignment=repeat(None), reversed_=is_rev[sel].tolist(),
        molecule_id=ints[MOL_ID], cigar=[C[a:b] for a, b in zip(co, ce)],
        read_group=per_read([r.read_group for r in recs for _ in (0, 1)]),
        active=flags[ACTIVE], log_alignment_probability=floats[LOGP],
        updated_log_alignment_probability=floats[UPDATED_LOGP], bwa_pick=flags[BWA_PICK],
        mapq_data=mapq_data, sum_move_probability_change=floats[SUM_MOVE],
        molecule_confidence=floats[MOL_CONF], active_molecule=flags[ACTIVE_MOL],
        readmap_s=readmap[0, sel].tolist(), readmap_e=readmap[1, sel].tolist(),
        secondary=repeat(None), primary=repeat(None), duplicate=repeat(False),
    ))
    # the references between them, by hit number: kept hits all
    at = np.zeros(H + 1, np.int64)
    np.cumsum(need, out=at[1:])
    for row, attr in ((MATE, "mate_alignment"), (SECOND_BEST, "second_best")):
        k = np.flatnonzero(i32[row, sel] >= 0)
        owners = objs if row == MATE else mapq_data
        for j, h in zip(k.tolist(), at[i32[row, sel[k]]].tolist()):
            setattr(owners[j], attr, objs[h])

    kept_objs = list(compress(objs, i32[KEPT, sel].tolist()))
    kept_at = np.zeros(H + 1, np.int64)
    np.cumsum(i32[KEPT], out=kept_at[1:])
    ko = kept_at[read_hit_off].tolist()
    kept = [kept_objs[a:b] for a, b in zip(ko, ko[1:])]
    split_lists = [objs[at[read_hit_off[r]] : at[read_hit_off[r + 1]]] for r in splits.tolist()]
    bro = bc_read_off.tolist()
    cut = np.searchsorted(splits, bc_read_off).tolist()
    return [(kept[a:b], split_lists[c:d], n)
            for a, b, c, d, n in zip(bro, bro[1:], cut, cut[1:], n_mol.tolist())]
