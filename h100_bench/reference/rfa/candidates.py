# Frozen copy of arachne_tpu_torch/rfa/candidates.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Candidate Alignment construction for the RFA layer.

``get_chains`` = GetChains (aligner.go:1633-1715): run paired candidate
generation + mate rescue per read pair; read ids are 2i (R1) / 2i+1 (R2);
sides with no hits get an unmapped placeholder (pos=-1).

``get_alignments`` = GetAlignments (aligner.go:1484-1631): finalize each
hit's CIGAR (mem_reg2aln), walk it against the fetched reference window to
collect matches / mismatch loci / indels / soft-clips, build Alignment
records, and return both the score-filtered (best-17) and full sets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..align.cigar import reg2aln
from ..align.pipeline import EasyAlignment, align_pair_with_rescue, seq_to_codes
from ..config import ArachneConfig
from ..index.fmindex import FMIndex
from .scoring import score_alignment
from .types import Alignment, MapQData


@dataclass
class ChainedHit:
    """ChainedHit (aligner.go:46-62)."""

    contig: str = ""
    pos: int = -1
    aend: int = 0
    read_id: int = 0
    mate_id: int = 0
    hit_id: int = 0
    secondary: bool = False
    read1: bool = True
    score: int = 0
    easy: Optional[EasyAlignment] = None     # the interpreted hit ("aln")
    fastq: Optional["FastQRecordView"] = None
    read: Optional[bytes] = None
    codes: Optional[np.ndarray] = None       # memoized seq_to_codes(read)


def chain_codes(ch: "ChainedHit") -> np.ndarray:
    """The chain's read as 2-bit codes, encoded once (three consumers:
    the reg2aln job batch, the CIGAR mismatch walk, and the replay path
    all re-encoded the same bytes).  Read-only by convention."""
    if ch.codes is None:
        ch.codes = seq_to_codes(ch.read)
    return ch.codes


@dataclass
class FastQRecordView:
    """Minimal view of one paired FASTQ record used downstream."""

    read1: bytes = b""
    qual1: bytes = b""
    read2: bytes = b""
    qual2: bytes = b""
    barcode: bytes = b""
    valid: bool = True
    read_info: str = ""
    read_group: str = ""


def get_chains(
    idx: FMIndex,
    cfg: ArachneConfig,
    reads: List[FastQRecordView],
    extender=None,
    engine=None,
    pair_results=None,
) -> Tuple[List[List[ChainedHit]], str]:
    """GetChains (aligner.go:1633-1715).

    With ``engine`` (a TpuEngine) all pairs of the barcode run through the
    batched device path; ``pair_results`` may carry results precomputed
    across several barcodes (the superbatch scheduler); otherwise the
    scalar per-pair path is used."""
    out: List[List[ChainedHit]] = []
    hit_num = 0
    barcode = ""
    mat = cfg.mem.scoring_matrix()
    if pair_results is None and engine is not None:
        pairs = [
            (seq_to_codes(rec.read1), seq_to_codes(rec.read2)) for rec in reads
        ]
        pair_results = engine.align_pairs(pairs)
    for i, rec in enumerate(reads):
        if pair_results is not None:
            a1, a2 = pair_results[i]
        else:
            codes1 = seq_to_codes(rec.read1)
            codes2 = seq_to_codes(rec.read2)
            a1, a2 = align_pair_with_rescue(
                idx, cfg.mem, cfg.pes, codes1, codes2,
                score_delta=cfg.rfa.chain_score_delta, extender=extender, mat=mat,
            )
        barcode = rec.barcode.decode() if isinstance(rec.barcode, bytes) else rec.barcode
        lst1: List[ChainedHit] = []
        for ea in a1:
            lst1.append(
                ChainedHit(
                    contig=ea.contig, pos=ea.offset, aend=ea.aend,
                    read_id=i * 2, mate_id=i * 2 + 1, hit_id=hit_num,
                    read1=True, secondary=ea.secondary, score=ea.score,
                    easy=ea, fastq=rec, read=rec.read1,
                )
            )
            hit_num += 1
        if not lst1:
            # unmapped placeholder; note the reference omits hit_id here
            # (aligner.go:1664-1676), so it stays 0
            lst1.append(
                ChainedHit(read_id=i * 2, mate_id=i * 2 + 1, pos=-1, read1=True,
                           easy=None, fastq=rec, read=rec.read1)
            )
            hit_num += 1
        out.append(lst1)
        lst2: List[ChainedHit] = []
        for ea in a2:
            lst2.append(
                ChainedHit(
                    contig=ea.contig, pos=ea.offset, aend=ea.aend,
                    read_id=i * 2 + 1, mate_id=i * 2, hit_id=hit_num,
                    read1=False, secondary=ea.secondary, score=ea.score,
                    easy=ea, fastq=rec, read=rec.read2,
                )
            )
            hit_num += 1
        if not lst2:
            lst2.append(
                ChainedHit(read_id=i * 2 + 1, mate_id=i * 2, pos=-1, hit_id=hit_num,
                           read1=False, easy=None, fastq=rec, read=rec.read2)
            )
            hit_num += 1
        out.append(lst2)
    return out, barcode


_CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def get_alignments(
    idx: FMIndex,
    cfg: ArachneConfig,
    barcode_chains: List[List[ChainedHit]],
    engine=None,
    mem_cache=None,
) -> Tuple[List[List[Alignment]], List[List[Alignment]]]:
    """GetAlignments (aligner.go:1484-1631); delta = best-17 filter."""
    delta = cfg.rfa.alignment_score_delta
    improper = cfg.rfa.improper_pair_penalty
    mat = cfg.mem.scoring_matrix()
    n = len(barcode_chains)
    filtered: List[List[Alignment]] = [[] for _ in range(n)]
    full: List[List[Alignment]] = [[] for _ in range(n)]
    walk = None  # the program's native walk is left out: the Python walk is the reference
    for i in range(n):
        best_score = 0
        for ch in barcode_chains[i]:
            if ch.score > best_score:
                best_score = ch.score
        for ch in barcode_chains[i]:
            codes = None
            if ch.easy is not None:
                codes = chain_codes(ch)
                if mem_cache is not None:
                    mem = mem_cache[id(ch)]
                else:
                    mem = reg2aln(idx, cfg.mem, codes, ch.easy.reg, mat)
                chrom = idx.packed.anns[mem.rid].name if mem.rid >= 0 else ""
                rev = mem.is_rev
                flat_cigar: List[int] = []
                for op, ln in mem.cigar:
                    flat_cigar.append(op)
                    flat_cigar.append(ln)
                edit_distance = mem.NM if mem.NM >= 0 else 0
            else:
                chrom, rev, flat_cigar, edit_distance = "", False, [], 0

            if walk is not None and id(ch) in walk:
                (
                    matches, mismatches, indels, indel_length,
                    soft_clipping, soft_clipping_length,
                    mismatch_locs, mismatch_read_locs,
                ) = walk[id(ch)]
            else:
                matches = 0
                indels = 0
                indel_length = 0
                soft_clipping = 0
                soft_clipping_length = 0
                ref_start, ref_end = ch.pos, ch.aend
                if rev:
                    ref_start = ch.aend + 1
                    ref_end = ch.pos + 1
                mismatch_locs: List[int] = []
                mismatch_read_locs: List[int] = []
                if ch.easy is not None:
                    ref_seq = idx.get_contig_seq(chrom, ref_start, ref_end, rev)
                else:
                    ref_seq = np.empty(0, dtype=np.uint8)
                if codes is not None:
                    read_seq = codes
                else:
                    read_seq = chain_codes(ch) if ch.read else np.empty(0, dtype=np.uint8)
                ref_off = 0
                read_off = 0
                # walk the CIGAR; reversed hits walk it back-to-front so
                # offsets track the *original* read orientation
                # (aligner.go:1524-1564)
                pairs = list(range(0, len(flat_cigar), 2))
                if rev:
                    pairs = pairs[::-1]
                for k in pairs:
                    op, ln = flat_cigar[k], flat_cigar[k + 1]
                    if op == 0:
                        matches += ln
                        limit = min(ln, len(ref_seq) - ref_off, len(read_seq) - read_off)
                        seg_r = ref_seq[ref_off : ref_off + max(limit, 0)]
                        seg_q = read_seq[read_off : read_off + max(limit, 0)]
                        mism = np.flatnonzero(seg_r != seg_q)
                        for m in mism:
                            m = int(m)
                            if rev:
                                mismatch_locs.append(int(ref_end) - (ref_off + m))
                            else:
                                mismatch_locs.append(ref_off + int(ref_start) + m)
                            mismatch_read_locs.append(read_off + m)
                        ref_off += ln
                        read_off += ln
                    elif op == 1:
                        indels += 1
                        indel_length += ln
                        read_off += ln
                    elif op == 2:
                        indels += 1
                        indel_length += ln
                        ref_off += ln
                    elif op == 3:
                        soft_clipping += 1
                        soft_clipping_length += ln
                        read_off += ln
                mismatches = edit_distance - indel_length
                matches -= mismatches
                if mismatches < 0:
                    mismatches = 0

            quals = ch.fastq.qual1 if ch.read1 else ch.fastq.qual2
            pos, aend = ch.pos, ch.aend
            if pos != -1 and rev:
                pos = ch.aend + 1
                aend = ch.pos + 1

            aln = Alignment(
                id=ch.hit_id,
                aend=aend,
                read_name=ch.fastq.read_info,
                read_seq=ch.read,
                read_qual=quals,
                matches=matches,
                mismatches=mismatches,
                mismatch_locs=mismatch_locs,
                mismatch_read_locs=mismatch_read_locs,
                indels=indels,
                soft_clipped=soft_clipping,
                soft_clipped_length=soft_clipping_length,
                read1=ch.read1,
                mapq_data=MapQData(),
                barcode=ch.fastq.barcode,
                contig=chrom,
                pos=pos,
                molecule_id=-1,
                score=ch.score,
                cigar=flat_cigar,
                read_id=ch.read_id,
                mate_id=ch.mate_id,
                reversed_=rev,
                read_group=ch.fastq.read_group,
                sum_move_probability_change=1.0,
                duplicate=False,
            )
            aln.log_alignment_probability = (
                score_alignment(aln, None, 0.0, improper) - improper
            )
            aln.updated_log_alignment_probability = (
                aln.log_alignment_probability + 2.0 * len(mismatch_locs)
            )
            if ch.easy is not None:
                aln.readmap_s = ch.easy.read_s
                aln.readmap_e = ch.easy.read_e
            full[ch.read_id].append(aln)
            if aln.score >= best_score - delta:
                filtered[ch.read_id].append(aln)
    return filtered, full
