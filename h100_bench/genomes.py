"""A configuration's genome, made from its own seed, and the program's
index of it, both cached under ``cache/<config>/`` in the checkout.

Two generators, as the configuration's ``genome`` entry names them:
``composition`` makes the genome from a published composition (the share
of the genome in each class of interspersed repeat, each class's unit
lengths, the share in segmental duplications); ``scale`` is a copy of
scripts/make_scale_genome.py's ``write_contig`` (arachne_tpu_torch/
scripts/): random background, a few planted repeat families and N runs.
The genome is the deployment: it does not change with ``--seed``.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Tuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, "cache")
BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)
N_CODE = 4


def write_scale_contig(fh, name: str, length: int, rng: np.random.Generator,
                       line: int = 80, chunk_lines: int = 1_000_000) -> None:
    """Copy of make_scale_genome.write_contig: random background, 5 planted
    repeat families (units of 1-8 kb, 30 copies each at ~97% identity)
    and N runs of 10-200 bp, about one per 10 Mbp."""
    fh.write(f">{name}\n".encode())
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


def families(classes: List[dict], rng: np.random.Generator):
    """Every class's family consensus sequences, concatenated: (codes,
    start of each family, its length, its divergence, its class)."""
    seqs, div, cls = [], [], []
    for ci, c in enumerate(classes):
        for _ in range(c["families"]):
            n = int(rng.integers(c["unit_bp"][0], c["unit_bp"][1] + 1))
            if "tandem_unit_bp" in c:
                k = int(rng.integers(c["tandem_unit_bp"][0], c["tandem_unit_bp"][1] + 1))
                seq = np.resize(rng.integers(0, 4, k, dtype=np.uint8), n)
            else:
                seq = rng.integers(0, 4, n, dtype=np.uint8)
            seqs.append(seq)
            div.append(rng.uniform(*c["divergence"]))
            cls.append(ci)
    lens = np.array([len(s) for s in seqs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return np.concatenate(seqs), starts, lens, np.array(div), np.array(cls)


def mutate(seq: np.ndarray, rate, rng: np.random.Generator) -> None:
    """Substitute each base of ``seq`` (codes 0-3) with probability
    ``rate`` (a number or one a base), in place."""
    hit = rng.random(len(seq)) < rate
    seq[hit] = (seq[hit] + rng.integers(1, 4, int(hit.sum()), dtype=np.uint8)) & 3


def copies(classes: List[dict], fam, length: int, rng: np.random.Generator):
    """Copies of the families for one contig of ``length``, each class
    until its share is met: (family, start in its consensus, length,
    reversed), in the order they lie on the contig."""
    _, _, fam_len, _, fam_cls = fam
    out = []
    for ci, c in enumerate(classes):
        ids = np.flatnonzero(fam_cls == ci)
        want, got, parts = int(round(c["share"] * length)), 0, []
        while got < want:
            f = ids[rng.integers(0, len(ids), 4096)]
            frac = rng.uniform(c["copy_fraction"][0], c["copy_fraction"][1], len(f))
            n = np.maximum(1, np.round(frac * fam_len[f])).astype(np.int64)
            if c.get("copy_from") == "3prime":
                at = fam_len[f] - n
            else:
                at = (rng.random(len(f)) * (fam_len[f] - n + 1)).astype(np.int64)
            keep = np.cumsum(n) - n + got < want   # up to the copy that meets the share
            f, at, n = f[keep], at[keep], n[keep]
            parts.append((f, at, n))
            got += int(n.sum())
        out.extend(parts)
    f, at, n = (np.concatenate([p[i] for p in out]) for i in range(3))
    order = rng.permutation(len(f))
    return f[order], at[order], n[order], rng.random(len(f)) < 0.5


def compose_contig(classes: List[dict], fam, length: int, rng: np.random.Generator) -> np.ndarray:
    """One contig: the copies of ``copies`` laid end to end in random order,
    between stretches of random (unique) sequence."""
    cons, fam_start, _, fam_div, _ = fam
    f, at, n, rev = copies(classes, fam, length, rng)
    total = int(n.sum())
    if total >= length:
        raise ValueError("the repeat classes' shares fill the contig")
    cuts = np.sort(rng.integers(0, length - total + 1, len(n)))
    gaps = np.diff(np.concatenate([[0], cuts]))
    dst0 = np.cumsum(gaps) + np.concatenate([[0], np.cumsum(n)[:-1]])
    first = np.repeat(np.cumsum(n) - n, n)
    rel = np.arange(total, dtype=np.int64) - first
    flip = np.repeat(rev, n)
    nn = np.repeat(n, n)
    src = np.repeat(fam_start[f] + at, n) + np.where(flip, nn - 1 - rel, rel)
    del first, nn
    seq = cons[src]
    del src
    seq[flip] = 3 - seq[flip]
    mutate(seq, np.repeat(fam_div[f], n), rng)
    out = rng.integers(0, 4, length, dtype=np.uint8)
    out[np.repeat(dst0, n) + rel] = seq
    return out


def duplicate_segments(g: np.ndarray, sd: dict, rng: np.random.Generator) -> None:
    """Segmental duplications, in place: segments of log-uniform length
    copied (either strand) to another place of the genome, each at an
    identity drawn from the stated range, until their share is met."""
    want, got = int(round(sd["share"] * len(g))), 0
    lo, hi = np.log(sd["length_bp"][0]), np.log(sd["length_bp"][1])
    while got < want:
        n = int(min(np.exp(rng.uniform(lo, hi)), want - got + sd["length_bp"][0]))
        s, d = (int(v) for v in rng.integers(0, len(g) - n, 2))
        seg = g[s : s + n].copy()
        if rng.random() < 0.5:
            seg = (3 - seg)[::-1].copy()
        mutate(seg, 1.0 - rng.uniform(*sd["identity"]), rng)
        g[d : d + n] = seg
        got += n


def make_genome(genome: dict) -> List[Tuple[str, np.ndarray]]:
    """[(name, codes)] of every contig of a ``genome`` entry (codes 0-3,
    4 for N)."""
    rng = np.random.default_rng(genome["seed"])
    classes = genome["classes"]
    fam = families(classes, rng)
    length, k = genome["contig_len"], genome["contigs"]
    g = np.empty(length * k, np.uint8)
    for c in range(k):
        g[c * length : (c + 1) * length] = compose_contig(classes, fam, length, rng)
    duplicate_segments(g, genome["segmental_duplications"], rng)
    runs = genome["n_runs"]
    for c in range(k):
        for _ in range(max(1, length // runs["every_bp"])):
            n = int(rng.integers(runs["length_bp"][0], runs["length_bp"][1] + 1))
            at = c * length + int(rng.integers(0, length - n))
            g[at : at + n] = N_CODE
    return [(f"chr{c + 1}", g[c * length : (c + 1) * length]) for c in range(k)]


def write_genome(path: str, genome: dict, line: int = 80) -> None:
    """The FASTA of a configuration's ``genome`` entry."""
    kind = genome["generator"]
    if kind not in ("scale", "composition"):
        raise ValueError(f"unknown genome generator {kind!r}")
    with open(path, "wb") as fh:
        if kind == "scale":
            rng = np.random.default_rng(genome["seed"])
            for c in range(genome["contigs"]):
                write_scale_contig(fh, f"chr{c + 1}", genome["contig_len"], rng)
            return
        for name, codes in make_genome(genome):
            fh.write(f">{name}\n".encode())
            arr = BASES[codes]
            full = len(arr) - len(arr) % line
            block = np.column_stack([arr[:full].reshape(-1, line),
                                     np.full((full // line, 1), ord("\n"), np.uint8)])
            fh.write(block.tobytes())
            if full < len(arr):
                fh.write(arr[full:].tobytes() + b"\n")



def read_contigs(path: str) -> List[Tuple[str, str, str]]:
    """(name, comment, sequence) of every contig of a FASTA."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    for part in data.split(b">")[1:]:
        head, _, body = part.partition(b"\n")
        fields = head.decode().split(None, 1)
        out.append((fields[0], fields[1] if len(fields) > 1 else "",
                    body.replace(b"\n", b"").decode()))
    return out


def prepared(config: dict, cache: str = CACHE) -> Dict[str, object]:
    """The configuration's genome and the program's index of it, made the
    first time into ``cache/<name>/`` (each in a directory renamed into
    place when whole): {"fasta": path, "built": {part: seconds}}."""
    d = os.path.join(cache, config["name"])
    fasta = os.path.join(d, "genome.fa")
    built = {}
    if not os.path.exists(fasta + ".arx.npz"):
        from arachne_tpu_torch.index import build_index_files

        tmp = d + ".partial"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        t0 = time.perf_counter()
        write_genome(os.path.join(tmp, "genome.fa"), config["genome"])
        built["genome_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        build_index_files(os.path.join(tmp, "genome.fa"))
        built["program_index_s"] = time.perf_counter() - t0
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
    return {"fasta": fasta, "dir": d, "built": built}


def reference_index(prep: Dict[str, object]) -> Tuple[str, float]:
    """The reference's own index of the genome (built by the reference from
    the FASTA the first time): (its directory, seconds spent building)."""
    from .reference.index.fmindex import build

    out = os.path.join(prep["dir"], "reference_index")
    if os.path.isdir(out):
        return out, 0.0
    t0 = time.perf_counter()
    shutil.rmtree(out + ".partial", ignore_errors=True)
    build(prep["fasta"], out)
    return out, time.perf_counter() - t0
