"""Dispatch-scaling study of the port: the align main path over N entries
of the device pool, and over two processes.

    python -m arachne_tpu_torch.scripts.scaling_study [--pairs 20000] [--threads 2] \\
        [--devices 1,2,4] [--engine cuda] [--out study.json]

The twin of scripts/scaling_study.py.  The port spreads work over cards in
two ways: (a) in one process, the batchers' chunks round-robin over the
device pool (ops/devicepool.py); (b) one process per card, the barcode
stream partitioned by claims (parallel/distributed.py, gloo).  On a 2 Mbp
genome and a bench-shaped library of ``--pairs`` pairs it runs ``align
--sam`` with the pool pinned to the one device repeated N times, for each
N of ``--devices``, then two processes (``--coordinator 127.0.0.1:<port>
--num-processes 2``) on it.  Every run's output is held to the N = 1 run's:
the pool runs shard for shard, the two processes by the sorted union of
their records and each one's header.  It prints pairs/s and stage seconds
of each run.

Caveat, printed with the results: the pool is one card (or the CPU)
repeated, and both processes share it and this host's cores, so the
curve measures the dispatch (the round robin's and the claims' overhead)
and the host, not a second card's compute.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ENGINE_DEVICE = {"cuda": "cuda", "torch-cpu": "cpu"}
# seconds either process of the two-process run may take
PROCESS_TIMEOUT = 900


def make_fixture(work: str, n_pairs: int):
    """A 2 Mbp random genome, its index, and about ``n_pairs`` simulated
    pairs (bench-fixture shaped: 3 molecules a barcode)."""
    from ..index import build_index_files, parse_fasta
    from ..io.simulate import SimConfig, simulate_linked_reads
    from ..measure import write_genome

    ref = os.path.join(work, "scale_ref.fa")
    write_genome(ref, 2_000_000)
    build_index_files(ref)
    r1, r2 = os.path.join(work, "scale.R1.fq.gz"), os.path.join(work, "scale.R2.fq.gz")
    n_barcodes = max(10, n_pairs // 60)
    simulate_linked_reads(
        parse_fasta(ref), r1, r2,
        SimConfig(n_barcodes=n_barcodes, molecules_per_barcode=3,
                  pairs_per_molecule=max(1, n_pairs // n_barcodes // 3), seed=7),
    )
    return ref, r1, r2


def run_pool(engine, dev, n, lib, threads, out):
    """One in-process align with the pool pinned to ``[dev] * n``."""
    from .. import cli
    from ..measure import quiet
    from ..ops import devicepool
    from ..runtime.timers import TIMERS

    TIMERS.reset()
    t0 = time.perf_counter()
    with devicepool.pinned([dev] * n), quiet(out + ".log"):
        stats = cli.main(["align", "--sam", "--engine", engine, "-t", str(threads), out, *lib])
    return {"pairs": stats.reads, "elapsed_s": stats.elapsed,
            "wall_s": time.perf_counter() - t0,
            "pairs_per_s": stats.reads / max(stats.elapsed, 1e-9),
            "stage_times": {k: round(v["seconds"], 3) for k, v in TIMERS.as_dict().items()}}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(engine, lib, threads, out, n=2):
    """``n`` align processes over gloo on localhost, each a subprocess with
    its own log; returns each one's pairs, pairs/s and stage seconds."""
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for i in range(n):
            logs.append(f"{out}.p{i}.log")
            with open(logs[-1], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "arachne_tpu_torch.cli", "align", "--sam",
                     "--engine", engine, "-t", str(threads), "--coordinator", coord,
                     "--num-processes", str(n), "--process-id", str(i),
                     "--stats-json", f"{out}.stats.json", out, *lib],
                    env=env, cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=PROCESS_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    res = []
    for i, (rc, path) in enumerate(zip(rcs, logs)):
        with open(path) as fh:
            text = fh.read()
        if rc != 0:
            raise SystemExit(f"process {i} of {n} failed (exit code {rc}):\n{text[-2000:]}")
        with open(f"{out}.stats.json.host{i:03d}") as fh:
            st = json.load(fh)
        m = re.search(r"completed successfully: .* ([\d.]+) pairs/s", text)
        res.append({"pairs": st["reads"], "pairs_per_s": float(m.group(1)), "wall_s": wall,
                    "stage_times": {k: round(v["seconds"], 3)
                                    for k, v in st["stage_times"].items()}})
    return res


def records(path):
    with open(path) as fh:
        lines = fh.readlines()
    return ([ln for ln in lines if not ln.startswith("@")],
            [ln for ln in lines if ln.startswith("@")])


def same_as_processes(base, out, n):
    """Do the ``n`` processes' shards hold, together, the records of
    ``base``'s bc_sorted_bam.sam, each under its header?"""
    want, header = records(os.path.join(base, "bc_sorted_bam.sam"))
    got = []
    for i in range(n):
        recs, head = records(os.path.join(out, f"bc_sorted_bam.host{i:03d}.sam"))
        if head != header:
            return False
        got += recs
    return sorted(got) == sorted(want)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m arachne_tpu_torch.scripts.scaling_study",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=20_000)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--devices", default="1,2,4", help="pool sizes, comma-separated")
    ap.add_argument("--engine", choices=sorted(ENGINE_DEVICE), default="cuda")
    ap.add_argument("--out", help="write the JSON result here")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from ..measure import same_shards

    dev = resolve_device(ENGINE_DEVICE[args.engine])
    sizes = [int(x) for x in args.devices.split(",")]
    work = tempfile.mkdtemp(prefix="scaling_study_")
    results = {}
    try:
        lib = make_fixture(work, args.pairs)
        base = None
        for n in sizes:
            out = os.path.join(work, f"pool{n}")
            r = run_pool(args.engine, dev, n, lib, args.threads, out)
            base = base or out
            r["identical_to_first"] = all(same_shards(base, out).values())
            results[f"pool {n}"] = r
            print(f"pool of {n} x {dev}: {r['pairs_per_s']:.1f} pairs/s ({r['pairs']} pairs, "
                  f"{r['elapsed_s']:.2f} s align, {r['wall_s']:.1f} s wall) "
                  f"identical={r['identical_to_first']}", flush=True)
            print(f"  stages: {r['stage_times']}", flush=True)
        out = os.path.join(work, "processes")
        procs = run_processes(args.engine, lib, args.threads, out)
        same = same_as_processes(base, out, len(procs))
        results["2 processes"] = {"processes": procs, "identical_to_first": same}
        for i, r in enumerate(procs):
            print(f"process {i} of 2: {r['pairs']} pairs at {r['pairs_per_s']:.1f} pairs/s "
                  f"({r['wall_s']:.1f} s wall for both) identical={same}", flush=True)
            print(f"  stages: {r['stage_times']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    first = results[f"pool {sizes[0]}"]["pairs_per_s"]
    print(f"\n--- against a pool of {sizes[0]} ---")
    for name, r in results.items():
        rate = r.get("pairs_per_s") or sum(p["pairs_per_s"] for p in r["processes"])
        print(f"  {name}: {rate / first:.2f}x")
    print(f"\nCaveat: every pool entry is the one {dev.type} device, and both processes share "
          f"it and this host's {os.cpu_count()} cores; the curve measures dispatch overhead "
          "and the host, not a second card's compute.")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)
    if not all(r["identical_to_first"] for r in results.values()):
        sys.exit("a run's output differs from the first pool's")
    return results


if __name__ == "__main__":
    main()
