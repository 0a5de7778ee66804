# Frozen copy of arachne_tpu_torch/rfa/mapq.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Molecule-aware MAPQ estimation.

``estimate_map_qualities`` = estimateMapQualities (aligner.go:797-922):
two methods, take the min —

  1. normalize best-pair scores of all alternate alignments (plus a
     pseudocount alignment; top-15 only), mapq = -10*log10(1 - p/Σp);
  2. molecule-move mapq from the summed probabilities of whole-molecule
     sub-moves (moleculeMapqProbabilitySums, :697-720).

Plus calculateLogMoleculePenalty (:722-755, reference length hard-coded
3.2 Gbp), updateAlignmentsMoleculeStatus (:643-675) and the checkMates
invariant (:757-776).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from .. import prec
from .optimizer import fast_score
from .scoring import pseudo_count_alignment_score, score_alignment
from .types import Alignment, CandidateMolecule, Region


def molecule_mapq_probability_sums(
    molecules: Optional[List[CandidateMolecule]], log_unpaired_probability: float
) -> None:
    """aligner.go:697-720.

    Restricted to read-sharing molecule pairs (optimizer.sink_neighborhoods):
    a disjoint pair contributes to no alignment (source_alignments comes up
    empty), so skipping it is output-identical and kills the second O(n²)
    fast_score sweep (SURVEY.md 3.5 hot loop #4)."""
    if not molecules:
        return
    from .optimizer import sink_neighborhoods

    nbr = sink_neighborhoods(molecules)
    for mol_id, source in enumerate(molecules):
        for mol2_id in nbr[mol_id]:
            sink = molecules[mol2_id]
            source_alignments = []
            for aln in source.active_alignments.iter_values():
                if sink.best_alignment_for_read.get(aln.read_id) is not None:
                    source_alignments.append(aln)
            if not source_alignments:
                continue
            change, _ = fast_score(source, sink, log_unpaired_probability)
            move_probability = prec.pow(10, change)
            for alignment in source_alignments:
                if not alignment.active:
                    raise AssertionError("setting molecule mapq for non-active alignment")
                alignment.sum_move_probability_change = prec.f(
                    alignment.sum_move_probability_change + move_probability
                )


def update_alignments_molecule_status(
    alignments: List[List[Alignment]],
    molecules: Optional[List[CandidateMolecule]],
    read_copies_in_active: Dict[int, int],
    read_copies_not_in_active: Dict[int, int],
    unique_molecules_active: Dict[int, Dict[int, bool]],
) -> None:
    """aligner.go:643-675."""
    if molecules is None:
        return
    from .molecules import set_molecule_confidences, set_molecule_differences

    set_molecule_confidences(molecules)
    set_molecule_differences(molecules, False)
    for read_id, alignment_array in enumerate(alignments):
        for alignment in alignment_array:
            is_active = False
            if alignment.molecule_id != -1:
                mol = molecules[alignment.molecule_id]
                is_active = (
                    len(mol.active_alignments) - mol.soft_clipped > 4
                    and mol.molecule_confidence > 0.1
                )
                alignment.active_molecule = is_active
            if is_active:
                molecules[alignment.molecule_id].active_molecule = True
                read_copies_in_active[read_id] = read_copies_in_active.get(read_id, 0) + 1
                unique_molecules_active.setdefault(read_id, {})[alignment.molecule_id] = True
            else:
                read_copies_not_in_active[read_id] = (
                    read_copies_not_in_active.get(read_id, 0) + 1
                )
            if alignment.molecule_id != -1:
                alignment.mapq_data.reads_in_molecule = len(
                    molecules[alignment.molecule_id].active_alignments
                )


def calculate_log_molecule_penalty(
    molecules: Optional[List[CandidateMolecule]], reference_length: float
) -> float:
    """aligner.go:722-755."""
    dna_length = 1000.0
    if not molecules:
        return 0.0
    for mol in molecules:
        if mol.active_molecule:
            smallest = math.inf
            biggest = -1.0
            for alignment in mol.active_alignments.iter_values():
                biggest = max(biggest, alignment.pos)
                smallest = min(smallest, alignment.pos)
            if biggest >= smallest:
                dna_length += (biggest - smallest) + 1000.0
        else:
            for alignment in mol.active_alignments.iter_values():
                dna_length += (alignment.aend - alignment.pos) * 2.0
    singleton_prob = 0.05
    return prec.log10(prec.f(dna_length / reference_length * singleton_prob))


def check_mates(alignments: List[List[Alignment]]) -> None:
    """checkMates invariant (aligner.go:757-776)."""
    for alignment_array in alignments:
        for alignment in alignment_array:
            if alignment.active and alignment.mate_alignment is not None:
                if not alignment.mate_alignment.active:
                    raise AssertionError(
                        f"active alignment {alignment.id} (read {alignment.read_id}) "
                        f"has inactive mate {alignment.mate_alignment.id}"
                    )


def _append_pseudocount_score(
    scores: List[float],
    alignment_array: List[Alignment],
    alignments: List[List[Alignment]],
    log_molecule_penalty: float,
    improper: float,
) -> None:
    """appendPsuedocountAlignmentScore (aligner.go:677-695)."""
    if not alignment_array:
        return
    mate_array = alignments[alignment_array[0].mate_id]
    best_single_mate = -math.inf
    for mate_alignment in mate_array:
        s = score_alignment(None, mate_alignment, log_molecule_penalty, improper)
        if s > best_single_mate:
            best_single_mate = s
    if mate_array:
        scores.append(
            best_single_mate
            + pseudo_count_alignment_score(alignment_array[0], log_molecule_penalty)
        )
    else:
        scores.append(pseudo_count_alignment_score(alignment_array[0], log_molecule_penalty))


def estimate_map_qualities(
    alignments: List[List[Alignment]],
    molecules: Optional[List[CandidateMolecule]],
    log_unpaired_probability: float,
    centromeres: Optional[Dict[str, Region]] = None,
    reference_length: float = 3_200_000_000.0,
) -> None:
    """estimateMapQualities (aligner.go:797-922)."""
    centromeres = centromeres or {}
    improper = log_unpaired_probability
    read_copies_in_active: Dict[int, int] = {}
    read_copies_not_in_active: Dict[int, int] = {}
    unique_molecules_active: Dict[int, Dict[int, bool]] = {}

    molecule_mapq_probability_sums(molecules, log_unpaired_probability)
    update_alignments_molecule_status(
        alignments,
        molecules,
        read_copies_in_active,
        read_copies_not_in_active,
        unique_molecules_active,
    )
    log_molecule_penalty = calculate_log_molecule_penalty(molecules, reference_length)

    for read_id, alignment_array in enumerate(alignments):
        scores: List[float] = []
        _append_pseudocount_score(
            scores, alignment_array, alignments, log_molecule_penalty, improper
        )
        total_probability = 0.0
        # link active mates (aligner.go:822-830)
        for alignment in alignment_array:
            for mate_alignment in alignments[alignment.mate_id]:
                if alignment.active and mate_alignment.active:
                    alignment.mate_alignment = mate_alignment
                    mate_alignment.mate_alignment = alignment

        for alignment in alignment_array:
            mate_array = alignments[alignment.mate_id]
            best_score = -math.inf
            for mate_alignment in mate_array:
                s = score_alignment(alignment, mate_alignment, log_molecule_penalty, improper)
                if s > best_score:
                    best_score = s
            if not mate_array:
                best_score = score_alignment(alignment, None, log_molecule_penalty, improper)
            scores.append(best_score)

        # second-best bookkeeping (aligner.go:847-891)
        second_best_proper_pair = False
        second_best_raw_score = scores[0] if scores else 0.0
        second_best_log_probability = -1000.0
        second_best_molecule_reads = -1
        second_best_alignment = None
        second_best_molecule_confidence = -1.0
        for alignment in alignment_array:
            for mate_alignment in alignments[alignment.mate_id]:
                s = score_alignment(alignment, mate_alignment, log_molecule_penalty, improper)
                if not alignment.active and s > second_best_log_probability:
                    second_best_log_probability = s
                    second_best_raw_score = score_alignment(
                        alignment, mate_alignment, 0.0, improper
                    )
                    second_best_alignment = alignment
                    alignment.mate_alignment = mate_alignment
                    second_best_proper_pair = alignment.is_proper
                    if alignment.molecule_id != -1 and molecules is not None:
                        alt_mol = molecules[alignment.molecule_id]
                        second_best_molecule_confidence = alt_mol.molecule_confidence
                        second_best_molecule_reads = len(alt_mol.active_alignments)
        for alignment in alignment_array:
            if alignment.active:
                md = alignment.mapq_data
                md.second_best = second_best_alignment
                md.second_best_score = second_best_raw_score
                md.second_best_proper_pair = second_best_proper_pair
                md.second_best_molecule_confidence = second_best_molecule_confidence
                md.second_best_molecule_reads = second_best_molecule_reads
                md.copies = len(alignment_array)
                md.copies_in_active_molecules = read_copies_in_active.get(
                    alignment.read_id, 0
                )
                md.copies_outside_active_molecules = read_copies_not_in_active.get(
                    read_id, 0
                )
                md.unique_molecules_active = len(unique_molecules_active.get(read_id, {}))
                md.score = score_alignment(
                    alignment, alignment.mate_alignment, 0.0, improper
                )

        # top-15 normalization (aligner.go:895-898)
        scores.sort()
        count = 0
        for i in range(len(scores) - 1, -1, -1):
            if len(scores) - i > 15:
                break
            total_probability = prec.f(total_probability + prec.pow(10, scores[i]))
            count += 1

        # final mapq (aligner.go:900-919)
        for alignment in alignment_array:
            s = score_alignment(
                alignment, alignment.mate_alignment, log_molecule_penalty, improper
            )
            ratio = prec.f(prec.pow(10, s) / total_probability) if total_probability > 0 else 1.0
            mapq = -10.0 * prec.log10(prec.f(1.0 - ratio)) if ratio < 1.0 else math.inf
            if alignment.sum_move_probability_change > 0:
                inv = prec.f(1.0 / alignment.sum_move_probability_change)
                molecule_mapq = (
                    -10.0 * prec.log10(prec.f(1.0 - inv)) if inv < 1.0 else math.inf
                )
            else:
                molecule_mapq = math.inf
            mapq = min(mapq, molecule_mapq)
            mapq = min(60.0, mapq)
            region = centromeres.get(alignment.contig)
            start, end = (region.start, region.end) if region else (-1, -1)
            if start < alignment.pos <= end:
                mapq = 0.0
            alignment.mapq = int(mapq)
    check_mates(alignments)
