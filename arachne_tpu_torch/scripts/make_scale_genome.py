# Copy of scripts/make_scale_genome.py, the JAX package's scale script.
"""Generate the synthetic genome for the wide-index (config-4) scale runs.

Produces a FASTA whose fwd+rev row count exceeds 2^31, so the built index
genuinely exercises the wide (int64) device rank path (ops/fm_rank.py) that
smaller fixtures can only force synthetically.  Default: 4 contigs x 300 Mbp
= 1.2 Gbp forward -> seq_len 2.4e9 rows.

Structure (seeded, reproducible):
  * random ACGT background
  * per contig, a handful of planted repeat families (unit 1-8 kb, ~30
    copies at ~97% identity scattered contig-wide) so max_occ subsampling,
    chain filtering and frac_rep all fire at scale
  * occasional N runs (exercises amb-hole bookkeeping and the lrand48
    N randomization, bntseq.c:227)

Usage: python scripts/make_scale_genome.py OUT.fa [--contigs 4]
       [--contig-len 300000000] [--seed 7]
"""

from __future__ import annotations

import argparse

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_contig(fh, name: str, length: int, rng: np.random.Generator,
                 line: int = 80, chunk_lines: int = 1_000_000) -> None:
    fh.write(f">{name}\n".encode())
    # plant repeat families: unit copies pasted over the random background
    n_fam = 5
    fam_units = []
    for _ in range(n_fam):
        unit_len = int(rng.integers(1000, 8000))
        fam_units.append(rng.integers(0, 4, unit_len, dtype=np.uint8))
    placements = []  # (pos, family)
    for f in range(n_fam):
        for _ in range(30):
            pos = int(rng.integers(0, max(1, length - len(fam_units[f]))))
            placements.append((pos, f))
    placements.sort()
    chunk = line * chunk_lines
    pi = 0
    for start in range(0, length, chunk):
        end = min(start + chunk, length)
        codes = rng.integers(0, 4, end - start, dtype=np.uint8)
        # paste repeat copies that overlap this chunk (~97% identity)
        while pi < len(placements) and placements[pi][0] < end:
            pos, f = placements[pi]
            unit = fam_units[f]
            u0, u1 = max(start, pos), min(end, pos + len(unit))
            if u1 > u0:
                seg = unit[u0 - pos : u1 - pos].copy()
                mut = rng.random(len(seg)) < 0.03
                seg[mut] = (seg[mut] + rng.integers(1, 4, int(mut.sum()))) & 3
                codes[u0 - start : u1 - start] = seg
            if pos + len(unit) <= end:
                pi += 1
            else:
                break
        # occasional N runs (~1 per 10 Mbp, 10-200 bp)
        arr = BASES[codes]
        for _ in range(max(1, (end - start) // 10_000_000)):
            npos = int(rng.integers(0, max(1, len(arr) - 200)))
            nlen = int(rng.integers(10, 200))
            arr[npos : npos + nlen] = ord("N")
        pad = (-len(arr)) % line
        if pad and end == length:
            mat = np.concatenate([arr, np.full(pad, ord(" "), np.uint8)])
        else:
            mat = arr
        if len(mat) % line == 0:
            block = np.column_stack(
                [mat.reshape(-1, line),
                 np.full((len(mat) // line, 1), ord("\n"), np.uint8)]
            )
            out = block.ravel().tobytes().replace(b" ", b"")
        else:
            out = b"\n".join(
                mat[i : i + line].tobytes() for i in range(0, len(mat), line)
            ) + b"\n"
        fh.write(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--contigs", type=int, default=4)
    ap.add_argument("--contig-len", type=int, default=300_000_000)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    with open(args.out, "wb") as fh:
        for c in range(args.contigs):
            write_contig(fh, f"chr{c + 1}", args.contig_len, rng)
            print(f"chr{c + 1} written", flush=True)


if __name__ == "__main__":
    main()
