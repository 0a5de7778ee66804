"""The lower-precision control of the benchmark's comparison, read at a
cell's own size:

    python3 h100_bench/control.py --workload NAME --seeds 11 12 13

For each seed it makes the library a run's window would hold (the pool's
second), draws the run's sample of barcode sets from it (check.draw's
rule), and puts the reference in the program's place one step below the
precisions the configuration states (reference/prec.py: int8 extension DP
state, float32 RFA/MAPQ): the control aligns those sets and writes its
records as the program's BAM files (bamread.write_bam).  Then check.py
judges that output as it judges a run's, and ``correct`` has to come out
false on every seed.  It needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from h100_bench import bamread, catalog, check, genomes, library  # noqa: E402
from h100_bench.probes import FedSet  # noqa: E402
from h100_bench.reference import oracle  # noqa: E402
from h100_bench.reference.index.fmindex import FMIndex  # noqa: E402

VERSION = "0.1.0"


def write_output(out_dir: str, index_dir: str, threads: int, order, records) -> None:
    """The program's BAM files for ``records`` {set: {shard: records}}:
    every shard's header, then its records, set after set in ``order``."""
    os.makedirs(out_dir)
    headers = oracle.shard_headers(FMIndex(index_dir), oracle.align_config(threads), VERSION)
    for name, header in headers.items():
        bamread.write_bam(os.path.join(out_dir, name), header,
                          [r for j in order for r in records[j].get(name, [])])


def control_run(index_dir: str, contigs, traffic: dict, threads: int, seed: int, work: str,
                processes: int) -> dict:
    """The control's output for one seed, judged by check.compare: its
    numbers, the verdict and what was checked."""
    r1, r2 = os.path.join(work, "R1.fq"), os.path.join(work, "R2.fq")
    n = library.simulate(contigs, r1, r2, library.sim_config(traffic), [seed, 1], 1)
    sets = oracle.read_sets(r1, r2)
    chosen = check.draw({j: len(s[0]) for j, s in sets.items()}, traffic, seed)
    low = oracle.run_sets(index_dir, threads, VERSION, {j: sets[j] for j in chosen}, processes,
                          control=True)
    out = os.path.join(work, "out")
    write_output(out, index_dir, threads, chosen, low)
    # the control's output as a run whose window holds exactly the sets it wrote
    feed = [FedSet(0, j, len(sets[j][0]), False, [r.read_info for r in sets[j][0]])
            for j in chosen]
    run = SimpleNamespace(feed=feed, emitted=len(feed), opened=-1, closed=len(feed) - 1,
                          libraries=[(r1, r2, n)], libraries_reused=0)
    chk = check.compare(out, run, run.libraries, index_dir, traffic, seed, threads, processes)
    chk["correct"] = check.verdict(chk["numbers"])
    return chk


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--processes", type=int, default=min(8, os.cpu_count() or 1))
    args = ap.parse_args(argv)
    root = os.path.dirname(genomes.HERE)
    bench = catalog.load(root)
    cell = catalog.cell(bench, args.workload)
    cfg = catalog.config(bench, root, cell["config"])
    traffic = catalog.traffic(root, cell["traffic"])
    prep = genomes.prepared(cfg)
    index_dir, _ = genomes.reference_index(prep)
    contigs = genomes.read_contigs(prep["fasta"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        work = tempfile.mkdtemp(prefix="h100_bench_control_")
        try:
            chk = control_run(index_dir, contigs, traffic, int(cfg["threads"]), seed, work,
                              args.processes)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": chk["correct"],
                          "sets": chk["sets_checked"], "pairs": chk["pairs_checked"],
                          "records": chk["records_checked"],
                          "check": {k: {"value": v, "limit": check.LIMITS[k]}
                                    for k, v in chk["numbers"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
