# Frozen copy of arachne_tpu_torch/index/build.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Reference packing: FASTA -> 2-bit packed reference (.pac semantics;
bntseq.c:227-300 add1/bns_fasta2bntseq) with the exact lrand48-based N
randomization (seed 11).  The index itself is the reference's own
(fmindex.py)."""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..utils.rng import Lrand48

NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i

OCC_INTERVAL = 128  # bwt.h:36; blocks of 128 bases per occ checkpoint


@dataclass
class ContigAnn:
    """One reference contig annotation (bntann1_t, bntseq.h)."""

    name: str
    offset: int
    length: int
    n_ambs: int = 0
    anno: str = "(null)"
    is_alt: bool = False


@dataclass
class AmbHole:
    """A run of ambiguous bases (bntamb1_t, bntseq.h)."""

    offset: int
    length: int
    amb: str


@dataclass
class PackedReference:
    """2-bit packed forward reference + annotations (bntseq_t semantics)."""

    pac: np.ndarray          # uint8, 4 bases/byte, forward strand only
    l_pac: int               # forward length in bases
    anns: List[ContigAnn] = field(default_factory=list)
    ambs: List[AmbHole] = field(default_factory=list)
    seed: int = 11           # bns->seed (bntseq.c:292)

    @property
    def n_seqs(self) -> int:
        return len(self.anns)

    def contig_offsets(self) -> np.ndarray:
        return np.array([a.offset for a in self.anns], dtype=np.int64)

    def contig_lengths(self) -> np.ndarray:
        return np.array([a.length for a in self.anns], dtype=np.int64)


def parse_fasta(path: str) -> List[Tuple[str, str, str]]:
    """Parse a (possibly gzipped) FASTA into (name, comment, sequence)."""
    opener = gzip.open if path.endswith(".gz") else open
    out: List[Tuple[str, str, List[str]]] = []
    with opener(path, "rt") as fh:
        name = None
        comment = ""
        chunks: List[str] = []
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out.append((name, comment, "".join(chunks)))
                header = line[1:].split(None, 1)
                name = header[0]
                comment = header[1] if len(header) > 1 else ""
                chunks = []
            elif line and name is not None:
                chunks.append(line.strip())
        if name is not None:
            out.append((name, comment, "".join(chunks)))
    return out


def pack_reference(contigs: List[Tuple[str, str, str]], seed: int = 11) -> PackedReference:
    """FASTA contigs -> PackedReference (add1 semantics, bntseq.c:227-275).

    Ambiguous bases are replaced with lrand48()&3 under srand48(seed) in
    sequence order, exactly as the reference does, so .pac output is
    byte-identical to ``bwa index``.
    """
    rng = Lrand48(seed)
    anns: List[ContigAnn] = []
    ambs: List[AmbHole] = []
    codes_parts: List[np.ndarray] = []
    offset = 0
    for name, comment, seq in contigs:
        raw = np.frombuffer(seq.encode(), dtype=np.uint8)
        codes = NT4_TABLE[raw].copy()
        n_amb = 0
        amb_mask = codes >= 4
        if amb_mask.any():
            # record N-holes: runs keyed by the *raw character* (add1 keeps
            # one hole per run of identical ambiguity characters)
            idx = np.flatnonzero(amb_mask)
            start = idx[0]
            last_char = raw[idx[0]]
            run_len = 1
            for j in idx[1:]:
                if j == start + run_len and raw[j] == last_char:
                    run_len += 1
                else:
                    ambs.append(AmbHole(offset + int(start), int(run_len), chr(last_char)))
                    n_amb += 1
                    start, last_char, run_len = j, raw[j], 1
            ambs.append(AmbHole(offset + int(start), int(run_len), chr(last_char)))
            n_amb += 1
            # randomize, in order, matching lrand48()&3 per ambiguous base
            repl = np.array([rng.lrand48() & 3 for _ in range(len(idx))], dtype=np.uint8)
            codes[idx] = repl
        anns.append(
            ContigAnn(
                name=name,
                offset=offset,
                length=len(codes),
                n_ambs=n_amb,
                anno=comment if comment else "(null)",
            )
        )
        offset += len(codes)
        codes_parts.append(codes)
    all_codes = (
        np.concatenate(codes_parts) if codes_parts else np.empty(0, dtype=np.uint8)
    )
    return PackedReference(pac=pack_2bit(all_codes), l_pac=len(all_codes), anns=anns, ambs=ambs, seed=seed)


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (0..3) 4-per-byte, high bits first (_set_pac layout)."""
    n = len(codes)
    padded = np.zeros(((n + 3) // 4) * 4, dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(-1, 4)
    return (
        (quads[:, 0] << 6) | (quads[:, 1] << 4) | (quads[:, 2] << 2) | quads[:, 3]
    ).astype(np.uint8)


def unpack_2bit(pac: np.ndarray, start: int, end: int) -> np.ndarray:
    """Unpack forward-strand base codes for [start, end) (_get_pac layout)."""
    if end <= start:
        return np.empty(0, dtype=np.uint8)
    b0, b1 = start // 4, (end + 3) // 4
    chunk = pac[b0:b1]
    expanded = np.empty(len(chunk) * 4, dtype=np.uint8)
    expanded[0::4] = (chunk >> 6) & 3
    expanded[1::4] = (chunk >> 4) & 3
    expanded[2::4] = (chunk >> 2) & 3
    expanded[3::4] = chunk & 3
    off = start - b0 * 4
    return expanded[off : off + (end - start)]
