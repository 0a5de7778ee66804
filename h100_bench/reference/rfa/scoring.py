# Frozen copy of arachne_tpu_torch/rfa/scoring.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Log10-domain pair scoring (aligner.go:547-581, :1032-1063)."""

from __future__ import annotations

from typing import Optional

from .types import Alignment


def is_pair(read1: Alignment, read2: Alignment) -> bool:
    """isPair (aligner.go:1032-1063): opposite strands, same contig,
    -35 <= (reverse.pos - forward.pos) < 750."""
    if read1.reversed_ == read2.reversed_ or read1.contig != read2.contig:
        return False
    if read1.reversed_:
        forward, reverse = read2, read1
    else:
        forward, reverse = read1, read2
    dist = reverse.pos - forward.pos
    return -35 <= dist < 750


def score_alignment(
    aln: Optional[Alignment],
    mate: Optional[Alignment],
    log_molecule_penalty: float,
    improper_pair_penalty: float,
) -> float:
    """scoreAlignment (aligner.go:556-581): mismatch -2, indel -3,
    soft-clip -5/side -0.5/base; improper-pair and molecule penalties."""
    score = 0.0
    if aln is not None:
        score += aln.mismatches * -2.0 + aln.indels * -3.0
        if aln.soft_clipped > 0:
            score -= 5.0 * aln.soft_clipped
            score -= aln.soft_clipped_length * 0.5
    if mate is not None:
        score += mate.mismatches * -2.0 + mate.indels * -3.0
        if mate.soft_clipped > 0:
            score -= 5.0 * mate.soft_clipped
            score -= mate.soft_clipped_length * 0.5
    if mate is None or aln is None or not is_pair(aln, mate):
        score += improper_pair_penalty
    if aln is not None and not aln.active_molecule:
        score += log_molecule_penalty
    return score


def pseudo_count_alignment_score(aln: Alignment, log_molecule_penalty: float) -> float:
    """psuedoCountAlignmentScore (aligner.go:547-554)."""
    pseudo_len = 25.0
    score = 0.0
    score -= 10.0
    score -= (len(aln.read_seq) - pseudo_len) * 0.5
    score += log_molecule_penalty
    return score
