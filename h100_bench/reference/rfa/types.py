# Frozen copy of arachne_tpu_torch/rfa/types.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""RFA data model: alignments, molecules, ordered maps.

Mirrors the reference's types: Alignment (aligner.go:65-114), MapQData
(:147-160), CandidateMolecule (:178-193), and the swap-remove OrderedMap
(ordered_map.go / ordered_alignment_map.go) whose deletion reordering is
deliberately reproduced — iteration order is part of the reference's
deterministic behavior.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


class OrderedMap:
    """Insertion-ordered int-keyed map with swap-remove deletion
    (ordered_map.go:5-51): deleting a key moves the *last* entry into its
    slot, so iteration order after deletes matches the reference exactly."""

    __slots__ = ("index", "reverse_index", "store")

    def __init__(self):
        self.index: Dict[int, int] = {}
        self.reverse_index: List[int] = []
        self.store: List = []

    def get(self, key: int):
        i = self.index.get(key)
        return self.store[i] if i is not None else None

    def set(self, key: int, val) -> None:
        i = self.index.get(key)
        if i is not None:
            self.store[i] = val
        else:
            self.index[key] = len(self.store)
            self.reverse_index.append(key)
            self.store.append(val)

    def delete(self, key: int) -> None:
        i = self.index.get(key)
        if i is None:
            return
        if len(self.store) > 1:
            self.store[i] = self.store[-1]
            self.index[self.reverse_index[-1]] = i
            self.reverse_index[i] = self.reverse_index[-1]
        self.store.pop()
        self.reverse_index.pop()
        del self.index[key]

    def iter_values(self) -> List:
        return self.store

    def iter_keys(self) -> List[int]:
        return self.reverse_index

    def __len__(self) -> int:
        return len(self.reverse_index)

    def __contains__(self, key: int) -> bool:
        return key in self.index


@dataclass
class MapQData:
    """MapQData (aligner.go:147-160)."""

    copies: int = 0
    copies_in_active_molecules: int = 0
    unique_molecules_active: int = 0
    copies_outside_active_molecules: int = 0
    reads_in_molecule: int = 0
    active_alignments_in_molecules: str = ""
    second_best: Optional["Alignment"] = None
    second_best_score: float = 0.0
    score: float = 0.0
    second_best_proper_pair: bool = False
    second_best_molecule_reads: int = 0
    second_best_molecule_confidence: float = 0.0


@dataclass
class Alignment:
    """Alignment (aligner.go:65-114): one candidate placement of one read.

    ``pos``/``aend`` are contig-relative; for reversed hits they are already
    swapped to leftmost/rightmost+1 (GetAlignments, aligner.go:1577-1582).
    ``cigar`` is the flat [op, len, ...] list in bridge encoding
    (M=0, I=1, D=2, S=3)."""

    id: int = 0
    read1: bool = True
    is_proper: bool = False
    soft_clipped: int = 0
    soft_clipped_length: int = 0
    barcode: bytes = b""
    read_name: str = ""
    read_seq: bytes = b""
    read_qual: bytes = b""
    mapq: int = 0
    molecule_difference: float = 0.0
    contig: str = ""
    pos: int = -1
    aend: int = -1
    score: int = 0
    mismatches: int = 0
    matches: int = 0
    mismatch_locs: List[int] = field(default_factory=list)
    mismatch_read_locs: List[int] = field(default_factory=list)
    indels: int = 0
    read_id: int = 0
    bad_molecule: bool = False
    mate_id: int = 0
    mate_alignment: Optional["Alignment"] = None
    reversed_: bool = False
    molecule_id: int = -1
    cigar: List[int] = field(default_factory=list)
    read_group: str = ""
    active: bool = False
    log_alignment_probability: float = 0.0
    updated_log_alignment_probability: float = 0.0
    bwa_pick: bool = False
    mapq_data: Optional[MapQData] = None
    sum_move_probability_change: float = 1.0
    molecule_confidence: float = 0.00075 * 0.025
    active_molecule: bool = False
    readmap_s: int = 0
    readmap_e: int = 0
    secondary: Optional["Alignment"] = None   # split-read supplementary
    primary: Optional["Alignment"] = None
    duplicate: bool = False

    def is_unmapped(self) -> bool:
        """IsUnmapped (aligner.go:140-145)."""
        return (not self.is_proper) and self.score - 17 < 19


@dataclass
class CandidateMolecule:
    """CandidateMolecule (aligner.go:178-193)."""

    id: int = 0
    chrom: str = ""
    start: int = 0
    stop: int = 0
    alignments: OrderedMap = field(default_factory=OrderedMap)  # read_id -> OrderedMap(aln_id -> Alignment)
    best_alignment_for_read: OrderedMap = field(default_factory=OrderedMap)
    active_alignments: OrderedMap = field(default_factory=OrderedMap)
    log_probability: float = 0.0
    active_molecule: bool = False
    molecule_confidence: float = 1.0
    differences: float = 0.0
    soft_clipped: int = 0
    mismatch_locs: Dict[int, int] = field(default_factory=dict)


@dataclass
class Region:
    """Centromere region (aligner.go:261-264)."""

    start: int
    end: int
