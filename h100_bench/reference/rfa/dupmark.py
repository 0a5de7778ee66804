# Frozen copy of arachne_tpu_torch/rfa/dupmark.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Duplicate marking (markDuplicates, aligner.go:598-641).

Dup key = (read1, reversed, contig, pos, mateContig, matePos) over active
alignments; first seen wins, the rest get BAM flag 0x400.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from .types import Alignment


def mark_duplicates(alignments: List[List[Alignment]]) -> None:
    seen: Set[Tuple] = set()
    for alignment_array in alignments:
        for alignment in alignment_array:
            if alignment.active:
                mate = alignment.mate_alignment
                key = (
                    alignment.read1,
                    alignment.reversed_,
                    alignment.contig,
                    alignment.pos,
                    mate.contig if mate else "",
                    mate.pos if mate else -1,
                )
                if key in seen:
                    alignment.duplicate = True
                else:
                    seen.add(key)
