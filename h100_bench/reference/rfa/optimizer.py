# Frozen copy of arachne_tpu_torch/rfa/optimizer.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""RFA move generation and greedy optimization.

``fast_score``    = fastScore (aligner.go:1109-1237): the Δlog10-probability
                    of migrating a source molecule's movable reads into a
                    sink molecule.
``accept_move``   = acceptMove (aligner.go:1261-1298).
``Optimizer``     = the Optimizer model (aligner.go:195-203, 1065-1097);
                    GenerateMove evaluates all sinks and greedily applies
                    the best positive move (the annealing accept function is
                    intentionally ignored, matching the reference).
``optimize``      = optimizer.Optimize (optimizer.go:15-27): the annealing
                    skeleton whose schedule (1, 2, 4*n_molecules) makes it
                    2*4n greedy sweeps in practice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .scoring import is_pair
from .types import Alignment, CandidateMolecule


@dataclass
class Move:
    """Move (aligner.go:1099-1107)."""

    score_change: float = -math.inf
    alignment_change: float = 0.0
    source: Optional[CandidateMolecule] = None
    sink: Optional[CandidateMolecule] = None
    to_delete: List[int] = field(default_factory=list)
    to_set: List[Alignment] = field(default_factory=list)
    num_moved: int = 0


def is_active_molecule(mol: CandidateMolecule, read_change: int) -> bool:
    """isActiveMolecule (aligner.go:1239-1249): >4 active reads and
    active/potential >= 0.1."""
    active = len(mol.active_alignments) + read_change
    potential = len(mol.best_alignment_for_read)
    if active <= 4:
        return False
    if active / potential < 0.1:
        return False
    return True


def fast_score(
    source: CandidateMolecule,
    sink: CandidateMolecule,
    log_unpaired_probability: float,
) -> Tuple[float, Move]:
    """fastScore (aligner.go:1109-1237)."""
    change = 0.0
    alignment_change = 0.0
    num = 0
    to_delete: List[int] = []
    to_set: List[Alignment] = []
    source_mismatch_remove: Dict[int, int] = {}
    sink_mismatch_add: Dict[int, int] = {}

    for source_alignment in source.active_alignments.iter_values():
        read_id = source_alignment.read_id
        sink_alignment = sink.best_alignment_for_read.get(read_id)
        if sink_alignment is None:
            continue
        mate_id = source_alignment.mate_id
        source_mate = source.active_alignments.get(mate_id)
        source_has_mate = source_mate is not None
        source_has_mate_pair = source_has_mate and is_pair(source_alignment, source_mate)
        mate = sink.best_alignment_for_read.get(mate_id)
        sink_has_mate_pair = (
            mate is not None and is_pair(sink_alignment, mate) and source_has_mate
        )
        if not source_has_mate_pair or (source_has_mate and sink_has_mate_pair):
            to_delete.append(read_id)
            to_set.append(sink_alignment)
        alignment_change += (
            sink_alignment.log_alignment_probability
            - source_alignment.log_alignment_probability
        )
        # shared mismatch-locus bookkeeping (aligner.go:1159-1184): the
        # score adjustments are commented out in the reference, but the
        # consistency checks are kept as invariants
        for loc in source_alignment.mismatch_locs:
            n_mm = source.mismatch_locs.get(loc)
            if not n_mm:
                raise AssertionError(
                    f"source molecule should have mismatch locus {loc}"
                )
            source_mismatch_remove[loc] = source_mismatch_remove.get(loc, 0) + 1
        for loc in sink_alignment.mismatch_locs:
            sink_mismatch_add[loc] = sink_mismatch_add.get(loc, 0) + 1
        if source_has_mate_pair and not sink_has_mate_pair and source.id != sink.id:
            alignment_change += log_unpaired_probability / 2.0
        elif (not source_has_mate_pair) and sink_has_mate_pair and source.id != sink.id:
            alignment_change -= log_unpaired_probability / 2.0
        num += 1

    source_active_before = is_active_molecule(source, 0)
    source_active_after = is_active_molecule(source, -num)
    if (not source_active_after) and source_active_before and source.id != sink.id:
        change -= len(source.best_alignment_for_read) * -0.5
    sink_active_before = is_active_molecule(sink, 0)
    sink_active_after = is_active_molecule(sink, num)
    if sink_active_after and (not sink_active_before) and source.id != sink.id:
        change += len(sink.best_alignment_for_read) * -0.5
    if len(source.active_alignments) - num == 0 and num > 0 and source.id != sink.id:
        change -= -3.0
    if len(sink.active_alignments) == 0 and num > 0 and source.id != sink.id:
        change += -3.0
    change += alignment_change
    return change, Move(
        source=source,
        sink=sink,
        to_delete=to_delete,
        to_set=to_set,
        num_moved=num,
        score_change=change,
        alignment_change=alignment_change,
    )


def accept_move(move: Move) -> None:
    """acceptMove (aligner.go:1261-1298)."""
    for read_id, sink_alignment in zip(move.to_delete, move.to_set):
        source_alignment = move.source.active_alignments.get(read_id)
        for loc in source_alignment.mismatch_locs:
            n = move.source.mismatch_locs.get(loc)
            if not n:
                raise AssertionError("source molecule should have this entry")
            move.source.mismatch_locs[loc] = n - 1
        for loc in sink_alignment.mismatch_locs:
            move.sink.mismatch_locs[loc] = move.sink.mismatch_locs.get(loc, 0) + 1
        move.source.active_alignments.delete(read_id)
        move.sink.active_alignments.set(read_id, sink_alignment)
        source_alignment.active = False
        sink_alignment.active = True


def sink_neighborhoods(mols: List[CandidateMolecule]) -> List[List[int]]:
    """For each molecule, the ascending-index list of molecules sharing at
    least one candidate read (a key of best_alignment_for_read).

    fast_score between molecules sharing NO reads is a provable no-op:
    num_moved stays 0, so GenerateMove ignores the move
    (aligner.go:1091-1093) and moleculeMapqProbabilitySums adds the
    probability to an empty alignment list (aligner.go:703-717).  Active
    reads are always a subset of best_alignment_for_read keys (moves only
    install sink.best_alignment_for_read entries), so this static
    neighborhood is a sound over-approximation — restricting both O(n²)
    loops to it leaves their output bit-identical while the 30k-read
    blow-up (SURVEY.md 7 "hard parts") becomes O(shared-read pairs)."""
    by_read: Dict[int, List[int]] = {}
    for i, m in enumerate(mols):
        for rid in m.best_alignment_for_read.iter_keys():
            by_read.setdefault(rid, []).append(i)
    nbr: List[set] = [set() for _ in mols]
    for lst in by_read.values():
        if len(lst) > 1:
            s = set(lst)
            for i in lst:
                nbr[i] |= s
    return [sorted(s - {i}) for i, s in enumerate(nbr)]


@dataclass
class Optimizer:
    """Optimizer model (aligner.go:195-203)."""

    candidate_molecules: List[CandidateMolecule]
    alignments: List[List[Alignment]]
    log_unpaired_probability: float
    barcode: str = ""
    current_source: int = 0
    neighborhoods: Optional[List[List[int]]] = None

    def generate_move(self) -> None:
        """GenerateMove (aligner.go:1065-1097): pure greedy — evaluates all
        sinks from the current source, applies the best move if Δ>0 (or Δ==0
        into a larger sink).  Only read-sharing sinks are scored (see
        sink_neighborhoods — identical output, not O(n_mol²))."""
        mols = self.candidate_molecules
        if self.neighborhoods is None:
            self.neighborhoods = sink_neighborhoods(mols)
        source = mols[self.current_source]
        if len(source.active_alignments) == 0:
            self.current_source = (self.current_source + 1) % len(mols)
            return
        best = Move(score_change=-math.inf, sink=source)
        for i in self.neighborhoods[self.current_source]:
            sink = mols[i]
            score, move = fast_score(source, sink, self.log_unpaired_probability)
            if (
                score > best.score_change
                or (
                    score == best.score_change
                    and best.sink is not None
                    and move.sink is not None
                    and len(move.sink.active_alignments) > len(best.sink.active_alignments)
                )
            ) and move.num_moved > 0:
                best = move
        if best.sink is not None and best.num_moved > 0:
            if best.score_change > 0 or (
                best.score_change == 0
                and len(best.sink.active_alignments) > len(source.active_alignments)
            ):
                accept_move(best)
        self.current_source = (self.current_source + 1) % len(mols)


def optimize(
    model: Optimizer,
    start_temp: float = 1.0,
    temperature_steps: int = 2,
    steps_per_temp: int = 0,
) -> Optimizer:
    """optimizer.Optimize (optimizer.go:15-27).  The Metropolis accept
    function is built but ignored by GenerateMove (reference behavior), so
    this is temperature_steps*steps_per_temp greedy sweeps."""
    if not model.candidate_molecules:
        return model
    for _temp_step in range(temperature_steps):
        for _step in range(steps_per_temp):
            model.generate_move()
    return model
