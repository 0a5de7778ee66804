"""Whether the timed path wrote the right records (``correct``).

After the run, the output's BAM files are read back.  Every set fed must
have been written, each with at least a record a read, in input order in
the barcode-sorted file.  A sample of the sets written inside the window,
drawn from the seed (the largest first where the mix asks for it), is
aligned again by the reference (reference/oracle.py, over its own index
of the genome, from the same FASTQ files), and every record of each
sampled set must equal the program's byte for byte, in the barcode-sorted
file and in its position-bucketed shard, as must every shard's header.
Each number compared has the limit 0.
"""

from __future__ import annotations

import os
import re
import time
from typing import Dict, List, Sequence

import numpy as np

from . import bamread
from .reference import oracle

LIMITS = {"mismatched_records": 0, "mismatched_headers": 0, "unwritten_sets": 0}


def diff(a: Sequence[bytes], b: Sequence[bytes]) -> int:
    """Records that differ between two lists, position by position, plus
    those one has beyond the other."""
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def split_by_set(records: List[bytes], feed) -> List[List[bytes]]:
    """The barcode-sorted file's records cut into the written sets, in
    order: each takes the records that follow whose read is one of its
    own.  What no set takes is left at the end."""
    out, p = [], 0
    for fs in feed:
        names = set(fs.names)
        q = p
        while q < len(records) and bamread.qname(records[q]) in names:
            q += 1
        out.append(records[p:q])
        p = q
    out.append(records[p:])
    return out


def draw(pairs: Dict[int, int], traffic: dict, seed: int) -> List[int]:
    """Sets (by index, with their pairs) drawn from the seed until their
    pairs reach the mix's ``check_pairs``, the largest first where the mix
    sets ``check_largest``; returned in order."""
    rng = np.random.default_rng([seed, 0x636865636B])
    order = [int(j) for j in rng.permutation(sorted(pairs))]
    if traffic.get("check_largest") and order:
        big = max(order, key=lambda j: pairs[j])
        order.remove(big)
        order.insert(0, big)
    chosen, total = [], 0
    for j in order:
        if total >= traffic["check_pairs"]:
            break
        chosen.append(j)
        total += pairs[j]
    return sorted(chosen)


def sample(probes, traffic: dict, seed: int) -> List[int]:
    """Indices (in input order) of the sets the reference checks: ``draw``
    over the sets written inside the window, of libraries fed once."""
    fed_twice = {i % len(probes.libraries) for i in range(probes.libraries_reused)}
    return draw({j: probes.feed[j].pairs for j in range(probes.opened + 1, probes.closed + 1)
                 if probes.feed[j].lib not in fed_twice}, traffic, seed)


def program_version(header: bytes) -> str:
    m = re.search(rb"@PG\tID:arachne\tPN:arachne\tVN:([^\t\n]*)", header)
    return m.group(1).decode() if m else ""


def compare(out_dir: str, probes, libraries, index_dir: str, traffic: dict, seed: int,
            threads: int, processes: int, control: bool = False) -> Dict[str, object]:
    """The numbers compared, each beside its limit, and what was checked."""
    t0 = time.perf_counter()
    files = {n: bamread.read_bam(os.path.join(out_dir, n))
             for n in sorted(os.listdir(out_dir)) if n.endswith(".bam")}
    bc_header, bc_records = files.get("bc_sorted_bam.bam", (b"", []))
    written = probes.feed[: probes.emitted]
    per_set = split_by_set(bc_records, written)
    unwritten = len(probes.feed) - probes.emitted
    unwritten += sum(1 for fs, recs in zip(written, per_set) if len(recs) < 2 * fs.pairs)
    unwritten += 1 if per_set[-1] else 0

    chosen = sample(probes, traffic, seed)
    wanted: Dict[int, List[int]] = {}
    for j in chosen:
        wanted.setdefault(probes.feed[j].lib, []).append(probes.feed[j].index)
    sets = {}
    for lib, idxs in wanted.items():
        r1, r2, _ = libraries[lib]
        got = oracle.read_sets(r1, r2, idxs)
        for j in chosen:
            if probes.feed[j].lib == lib:
                sets[j] = got[probes.feed[j].index]
    version = program_version(bc_header)
    t_ref = time.perf_counter()
    expected = oracle.run_sets(index_dir, threads, version, sets, processes, control=control)
    t_ref = time.perf_counter() - t_ref

    mismatched = sum(diff(per_set[j], expected[j].get("bc_sorted_bam.bam", [])) for j in chosen)
    names = set()
    for j in chosen:
        names.update(probes.feed[j].names)
    shard_names = set()
    for j in chosen:
        shard_names.update(expected[j])
    shard_names.discard("bc_sorted_bam.bam")
    for shard in sorted(shard_names):
        want = [r for j in chosen for r in expected[j].get(shard, [])]
        have = [r for r in files.get(shard, (b"", []))[1] if bamread.qname(r) in names]
        mismatched += diff(have, want)

    from .reference.index.fmindex import FMIndex

    headers = oracle.shard_headers(FMIndex(index_dir), oracle.align_config(threads), version)
    bad_headers = sum(1 for n, h in headers.items() if files.get(n, (None,))[0] != h)
    bad_headers += len(set(files) - set(headers))
    return {
        "numbers": {"mismatched_records": mismatched, "mismatched_headers": bad_headers,
                    "unwritten_sets": unwritten},
        "sets_checked": len(chosen),
        "pairs_checked": sum(probes.feed[j].pairs for j in chosen),
        "records_checked": sum(len(v) for j in chosen for v in expected[j].values()),
        "reference_s": t_ref,
        "check_s": time.perf_counter() - t0,
        "failed_sets": sum(1 for j in chosen
                           if diff(per_set[j], expected[j].get("bc_sorted_bam.bam", []))),
    }


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
