# Frozen copy of arachne_tpu_torch/rfa/molecules.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Best-alignment tagging and molecule inference.

``tag_best_alignments``  = tagBestAlignments (aligner.go:1397-1481)
``infer_molecules``      = inferMolecules (aligner.go:1300-1338)
``mark_best_alignment_for_read_in_molecule``
                         = markBestAlignmentForReadInMolecule (:1340-1393)
``scrap_molecules``      = scrapMolecules (:991-1016)
``set_molecule_differences`` = setMoleculeDifferences (:527-545)
``set_molecule_confidences`` = setMoleculeConfidences (:978-989)
"""

from __future__ import annotations

import math
from typing import Dict, List

from ..utils.rng import JitterRand
from .scoring import is_pair, score_alignment
from .types import Alignment, CandidateMolecule, OrderedMap


def tag_best_alignments(
    alignments: List[List[Alignment]], improper_pair_penalty: float
) -> List[List[Alignment]]:
    """Pick each pair's initial active alignments (argmax pair score with
    deterministic md5(read_name)-seeded jitter) and group all alignments by
    contig, position-sorted — the input to molecule inference."""
    positions: List[List[Alignment]] = []
    contigs: Dict[str, int] = {}
    touched = [False] * len(alignments)
    for read_id, alignment_array in enumerate(alignments):
        best_score = -math.inf
        best_alignment = None
        best_mate = None
        if alignment_array:
            random = JitterRand(alignment_array[0].read_name)
        else:
            random = JitterRand("")
        for alignment in alignment_array:
            assert read_id == alignment.read_id
            mate_alignments = alignments[alignment.mate_id]
            for mate_alignment in mate_alignments:
                total = (
                    score_alignment(alignment, mate_alignment, 0.0, improper_pair_penalty)
                    + random.float64() / 2.0
                )
                if total > best_score:
                    best_score = total
                    best_alignment = alignment
                    best_mate = mate_alignment
            if not mate_alignments:
                score = alignment.score + random.float64() / 2.0
                if score > best_score:
                    best_score = score
                    best_alignment = alignment
            idx = contigs.get(alignment.contig)
            if idx is not None:
                positions[idx].append(alignment)
            else:
                contigs[alignment.contig] = len(positions)
                positions.append([alignment])
        if not touched[read_id] and best_alignment is not None:
            best_alignment.active = True
            best_alignment.bwa_pick = True
            if best_mate is not None:
                if not is_pair(best_alignment, best_mate):
                    pass  # improper pair counters are vestigial stats
                else:
                    best_alignment.is_proper = True
                    best_mate.is_proper = True
                best_mate.active = True
                best_mate.bwa_pick = True
                touched[best_mate.read_id] = True
    for plist in positions:
        plist.sort(key=lambda a: a.pos)
    return positions


def infer_molecules(positions: List[List[Alignment]]) -> List[CandidateMolecule]:
    """Sweep position-sorted alignments per contig; gap > 50 kb starts a
    new CandidateMolecule (aligner.go:1300-1338)."""
    out: List[CandidateMolecule] = []
    molecule_num = 0
    current = None
    for plist in positions:
        for i, aln in enumerate(plist):
            if i == 0 or (i > 0 and aln.pos - plist[i - 1].pos > 50000):
                if i > 0 and current is not None:
                    current.stop = plist[i - 1].pos
                current = CandidateMolecule(
                    chrom=aln.contig,
                    start=aln.pos,
                    id=molecule_num,
                    molecule_confidence=1.0,
                )
                aln_map = OrderedMap()
                aln_map.set(aln.id, aln)
                current.alignments.set(aln.read_id, aln_map)
                out.append(current)
                molecule_num += 1
            alignment_map = current.alignments.get(aln.read_id)
            if alignment_map is not None:
                alignment_map.set(aln.id, aln)
            else:
                aln_map = OrderedMap()
                aln_map.set(aln.id, aln)
                current.alignments.set(aln.read_id, aln_map)
        if plist:
            current.stop = plist[-1].pos
    return out


def mark_best_alignment_for_read_in_molecule(
    molecules: List[CandidateMolecule], improper_pair_penalty: float
) -> None:
    """aligner.go:1340-1393."""
    for molecule in molecules:
        active_alignments = OrderedMap()
        best_alignment_for_read = OrderedMap()
        for read_id in list(molecule.alignments.iter_keys()):
            alns = molecule.alignments.get(read_id)
            best_score = -math.inf
            best_alignment = None
            for alignment_id in list(alns.iter_keys()):
                alignment = alns.get(alignment_id)
                mate_alignments = molecule.alignments.get(alignment.mate_id)
                if mate_alignments is not None and len(mate_alignments) > 0:
                    for mate_alignment_id in list(mate_alignments.iter_keys()):
                        mate_alignment = mate_alignments.get(mate_alignment_id)
                        score = score_alignment(
                            alignment, mate_alignment, 0.0, improper_pair_penalty
                        )
                        if score > best_score:
                            best_score = score
                            best_alignment = alignment
                else:
                    if alignment.log_alignment_probability > best_score:
                        best_score = alignment.log_alignment_probability
                        best_alignment = alignment
                if alignment.active:
                    active_alignments.set(read_id, alignment)
            if best_alignment.active:
                active_alignments.set(read_id, best_alignment)
            best_alignment_for_read.set(read_id, best_alignment)
        for aln in active_alignments.iter_values():
            for loc in aln.mismatch_locs:
                molecule.mismatch_locs[loc] = molecule.mismatch_locs.get(loc, 0) + 1
        molecule.active_alignments = active_alignments
        molecule.best_alignment_for_read = best_alignment_for_read


def scrap_molecules(molecules: List[CandidateMolecule]) -> List[CandidateMolecule]:
    """Drop molecules with no active alignments, renumber ids
    (aligner.go:991-1016)."""
    out: List[CandidateMolecule] = []
    count = 0
    for mol in molecules:
        if len(mol.active_alignments) > 0:
            out.append(mol)
            for read_id in mol.alignments.iter_keys():
                amap = mol.alignments.get(read_id)
                for aln_id in amap.iter_keys():
                    amap.get(aln_id).molecule_id = count
            count += 1
        else:
            for read_id in mol.alignments.iter_keys():
                amap = mol.alignments.get(read_id)
                for aln_id in amap.iter_keys():
                    amap.get(aln_id).molecule_id = -1
    return out


def set_molecule_differences(molecules: List[CandidateMolecule], set_bad: bool) -> None:
    """aligner.go:527-545."""
    for mol in molecules:
        differences = 0
        for alignment in mol.active_alignments.iter_values():
            differences += alignment.mismatches
        n_active = len(mol.active_alignments)
        if set_bad and n_active and differences / n_active > 1.5:
            for alignment in mol.active_alignments.iter_values():
                alignment.bad_molecule = True
        mol.differences = differences / n_active if n_active else math.nan
        for alignment in mol.active_alignments.iter_values():
            alignment.molecule_difference = mol.differences


def molecule_confidence(mol: CandidateMolecule, num_active: int) -> float:
    """moleculeConfidence (aligner.go:1256-1259)."""
    return num_active / len(mol.best_alignment_for_read)


def set_molecule_confidences(molecules: List[CandidateMolecule]) -> None:
    """aligner.go:978-989."""
    for mol in molecules:
        mol.molecule_confidence = molecule_confidence(mol, len(mol.active_alignments))
        for alignment in mol.active_alignments.iter_values():
            if alignment.soft_clipped > 0:
                mol.soft_clipped += 1
            alignment.molecule_confidence = mol.molecule_confidence
