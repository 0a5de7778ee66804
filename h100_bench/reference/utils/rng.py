# Frozen copy of arachne_tpu_torch/utils/rng.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Deterministic RNG utilities used for behavior parity with the reference.

* ``Lrand48`` reproduces glibc's drand48 family exactly — the reference's
  index builder randomizes N bases via ``srand48(11)``/``lrand48()``
  (bntseq.c:261,299 add1/bns_fasta2bntseq), so matching it bit-for-bit makes
  our ``.pac`` files identical to ``bwa index`` output.

* ``hash_64`` is BWA's Wang hash (utils.h:97-108) used to tie-break
  equal-score alignments in mem_mark_primary_se (bwamem.c:527).

* ``JitterRand`` supplies the deterministic per-read jitter used by
  tagBestAlignments (aligner.go:1413-1418): the reference seeds Go's
  math/rand with the first 8 bytes of md5(read_name) and adds
  ``Float64()/2`` to pair scores.  Go's generator depends on an unpublished
  precomputed table (rngCooked), so we keep the md5 seeding but generate the
  uniform doubles with splitmix64 — deterministic and documented, not
  bit-identical to Go (the reference binary itself cannot run; see
  SURVEY.md 2.4).
"""

from __future__ import annotations

import hashlib
import struct

_MASK48 = (1 << 48) - 1
_MASK64 = (1 << 64) - 1


class Lrand48:
    """Exact glibc drand48/lrand48 linear congruential generator."""

    A = 0x5DEECE66D
    C = 0xB

    def __init__(self, seed: int = 0):
        self.srand48(seed)

    def srand48(self, seed: int) -> None:
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def lrand48(self) -> int:
        self.x = (self.A * self.x + self.C) & _MASK48
        return self.x >> 17  # non-negative long in [0, 2^31)


def hash_64(key: int) -> int:
    """BWA's 64-bit Wang hash (utils.h:97-108)."""
    key &= _MASK64
    key = (key + (~(key << 32) & _MASK64)) & _MASK64
    key ^= key >> 22
    key = (key + (~(key << 13) & _MASK64)) & _MASK64
    key ^= key >> 8
    key = (key + (key << 3)) & _MASK64
    key ^= key >> 15
    key = (key + (~(key << 27) & _MASK64)) & _MASK64
    key ^= key >> 31
    return key


def _splitmix64(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _MASK64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return state, z ^ (z >> 31)


class JitterRand:
    """Deterministic uniform doubles seeded from md5(read_name).

    Mirrors aligner.go:1413-1418: seed = little-endian uint64 of
    md5(read_name)[0:8].  ``float64()`` returns values in [0, 1).
    """

    def __init__(self, read_name: str):
        digest = hashlib.md5(read_name.encode()).digest()
        (seed,) = struct.unpack("<Q", digest[:8])
        self.state = seed

    def float64(self) -> float:
        self.state, z = _splitmix64(self.state)
        return (z >> 11) * (1.0 / (1 << 53))


class GoRand:
    """Deterministic generator with Go-style Float64 call pattern.

    Used where the reference calls rand.New(rand.NewSource(seed)); we keep
    the same *sequence positions* of draws (one draw per candidate pair,
    aligner.go:1431/1442) so independently-seeded runs are reproducible.
    """

    def __init__(self, seed: int):
        self.state = seed & _MASK64

    def float64(self) -> float:
        self.state, z = _splitmix64(self.state)
        return (z >> 11) * (1.0 / (1 << 53))
