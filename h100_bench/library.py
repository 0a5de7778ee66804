"""A traffic mix's libraries: linked-read FASTQ made from a seed.

``simulate`` is a copy of arachne_tpu_torch/io/simulate.py's
``simulate_linked_reads`` (and ``skewed_pair_counts``, ``_barcode``,
``_apply_read_errors``, ``_qual_string``), changed only to write plain
FASTQ and to number the reads of library ``lib`` from ``lib * 10**7`` so
that names differ between the libraries of a run.  Read names keep the
truth form ``<contig>_<p1>_<p2>_<serial>``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

SERIAL_STRIDE = 10 ** 7


@dataclass
class SimConfig:
    n_barcodes: int = 50
    molecules_per_barcode: int = 3
    molecule_len: int = 40_000
    pairs_per_molecule: int = 12
    read_len: int = 150
    fragment_mean: int = 350
    fragment_std: int = 50
    error_rate: float = 0.002
    indel_rate: float = 0.0
    vary_quals: bool = False
    pair_counts: Optional[List[int]] = None
    invalid_every: int = 0


def skewed_pair_counts(rng: np.random.Generator, n_barcodes: int, mean_pairs: int,
                       sigma: float = 1.0, big_barcode_pairs: int = 0) -> List[int]:
    """Lognormal pairs-per-barcode, optionally with one giant barcode
    planted at the front."""
    raw = rng.lognormal(mean=0.0, sigma=sigma, size=n_barcodes)
    counts = np.maximum(1, (raw / raw.mean() * mean_pairs).astype(int)).tolist()
    if big_barcode_pairs:
        counts[0] = big_barcode_pairs
    return counts


def sim_config(traffic: dict) -> SimConfig:
    """A mix's library shape.  ``pair_counts`` in the mix is drawn from
    its own fixed ``rng``, so every library of every seed has the same
    sizes; the seed moves the reads."""
    keys = {k: traffic[k] for k in SimConfig.__dataclass_fields__ if k in traffic}
    counts = traffic.get("pair_counts")
    if counts is not None:
        c = dict(counts)
        keys["pair_counts"] = skewed_pair_counts(np.random.default_rng(c.pop("rng")),
                                                 traffic["n_barcodes"], **c)
    return SimConfig(**keys)


def _barcode(i: int) -> str:
    a, rest = divmod(i, 96 * 96 * 96)
    c, rest = divmod(rest, 96 * 96)
    b, d = divmod(rest, 96)
    return f"A{a % 96 + 1:02d}C{c + 1:02d}B{b + 1:02d}D{d + 1:02d}"


def revcomp_str(s: str) -> str:
    return s.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


def _apply_read_errors(template: str, cfg: SimConfig, rng) -> List[str]:
    L = cfg.read_len
    r = list(template[:L])
    n_err = rng.poisson(cfg.error_rate * L)
    for _ in range(n_err):
        j = int(rng.integers(0, L))
        r[j] = "ACGT"[int(rng.integers(0, 4))]
    if cfg.indel_rate and rng.random() < cfg.indel_rate:
        j = int(rng.integers(8, L - 8))
        if rng.random() < 0.5 and len(template) > L:
            r = r[:j] + list(template[j + 1 : L + 1])
        else:
            r = r[:j] + ["ACGT"[int(rng.integers(0, 4))]] + r[j : L - 1]
    return r


def _qual_string(cfg: SimConfig, rng) -> str:
    if not cfg.vary_quals:
        return "I" * cfg.read_len
    phreds = rng.integers(20, 41, cfg.read_len)
    return (phreds + 33).astype(np.uint8).tobytes().decode()


def simulate(contigs: List[Tuple[str, str, str]], out_r1: str, out_r2: str, cfg: SimConfig,
             seed, lib: int) -> int:
    """Write one barcode-sorted library as plain paired FASTQ; returns the
    pairs written.  ``seed`` is anything ``numpy.random.default_rng``
    takes."""
    rng = np.random.default_rng(seed)
    total = 0
    serial = lib * SERIAL_STRIDE
    with open(out_r1, "w") as f1, open(out_r2, "w") as f2:
        for bi in range(cfg.n_barcodes):
            bc = _barcode(bi)
            valid = 1
            if cfg.invalid_every and (bi + 1) % cfg.invalid_every == 0:
                valid = 0
            if cfg.pair_counts is not None:
                want = cfg.pair_counts[bi]
                n_mols = -(-want // cfg.pairs_per_molecule)
            else:
                want = cfg.molecules_per_barcode * cfg.pairs_per_molecule
                n_mols = cfg.molecules_per_barcode
            emitted = 0
            for _mi in range(n_mols):
                if emitted >= want:
                    break
                ci = int(rng.integers(0, len(contigs)))
                name, _, seq = contigs[ci]
                if len(seq) <= cfg.molecule_len + cfg.fragment_mean:
                    mol_start = 0
                    mol_len = len(seq)
                else:
                    mol_start = int(rng.integers(0, len(seq) - cfg.molecule_len))
                    mol_len = cfg.molecule_len
                for _p in range(min(cfg.pairs_per_molecule, want - emitted)):
                    frag = int(np.clip(rng.normal(cfg.fragment_mean, cfg.fragment_std),
                                       2 * cfg.read_len, mol_len))
                    pos = mol_start + int(rng.integers(0, max(mol_len - frag, 1)))
                    fragment = seq[pos : pos + frag]
                    if len(fragment) < 2 * cfg.read_len:
                        continue
                    t1 = fragment[: cfg.read_len + 1]
                    t2 = revcomp_str(fragment[-(cfg.read_len + 1):])
                    r1 = _apply_read_errors(t1, cfg, rng)
                    r2 = _apply_read_errors(t2, cfg, rng)
                    qname = f"{name}_{pos + 1}_{pos + frag}_{serial}"
                    serial += 1
                    hdr = f"BX:Z:{bc}\tVX:i:{valid}"
                    q1 = _qual_string(cfg, rng)
                    q2 = _qual_string(cfg, rng)
                    f1.write(f"@{qname}/1\t{hdr}\n{''.join(r1)}\n+\n{q1}\n")
                    f2.write(f"@{qname}/2\t{hdr}\n{''.join(r2)}\n+\n{q2}\n")
                    total += 1
                    emitted += 1
    return total


def pool(contigs, traffic: dict, seed: int, n_libraries: int, work: str) -> List[Tuple[str, str, int]]:
    """``n_libraries`` libraries of the mix under ``work``: [(r1, r2,
    pairs)].  Library i is made from the seed sequence (seed, i)."""
    cfg = sim_config(traffic)
    out = []
    for i in range(n_libraries):
        r1, r2 = os.path.join(work, f"lib{i}.R1.fq"), os.path.join(work, f"lib{i}.R2.fq")
        n = simulate(contigs, r1, r2, cfg, [seed, i], i)
        out.append((r1, r2, n))
    return out
