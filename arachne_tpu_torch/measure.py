"""Measure the align main path on a simulated linked-read library.

    python -m arachne_tpu_torch.measure --trials 3 --profile --compare torch-cpu \\
        --out measure.json

makes the fixture chip_smoke.py runs (by default a 2 Mbp random genome and
320 barcodes x 3 molecules x 20 pairs = 19,200 pairs of 150 bp, indel rate
0.1), builds its index and warms the kernels, then:

  * ``--trials N``: N timed runs of ``align --engine ENGINE --sam``, each
    with pairs/s, the align loop's seconds and the stage seconds, seeding
    where the engine's device seeds by default (the card; the host for
    torch-cpu) unless ARACHNE_DEVICE_SEEDING says otherwise;
  * ``--profile``: one more run under torch.profiler (CUDA only), giving
    the device's busy time, its share of the align loop and the device
    time of each kernel and copy by name;
  * ``--compare E ...``: the same library through each other engine, with
    every SAM shard compared byte for byte with the first trial's (exit
    code 1 if any differs);
  * ``--bands``: the band widths w of the CIGAR-stage problems the first
    trial submits to ``BatchGlobal`` (kernels K3 and K4), as {w: count}.

``--reference FASTA`` takes the library's genome from a FASTA (for
instance one of ``python -m arachne_tpu_torch.scripts.make_scale_genome``)
in place of the random ``--genome-bp`` one.  Unless ``FASTA.arx.npz`` is
there already, the index is built by ``python -m arachne_tpu_torch.cli
index FASTA`` in a subprocess, and the result records that build: its
seconds, the ``build-mode auto`` line it printed (genomes of over 1e9 rows
print one), its peak resident memory, the index file's bytes, ``sa_intv``,
whether the suffix array is sampled and whether the device tables are
wide.  The first trial then also records its accuracy against the
simulated truth, the SHA-256 of every shard (two runs on one library wrote
the same bytes when these are equal) and, on the card, its peak device
memory.

Every run is bracketed by the card's name, power limit, SM clock and power
draw from nvidia-smi.  The result also records, once, the host it ran on
(``host_facts``): its memory, which decides ``build-mode auto``'s route,
its cores, the free disk of the working directories and the card.  The
result is one JSON object, written to ``--out`` and summarised on standard
output.
"""

from __future__ import annotations

import argparse
import contextlib
import filecmp
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

GENOME_SEED = 20260820


@contextlib.contextmanager
def quiet(path):
    """Send the align command's per-barcode chatter to a log file."""
    with open(path, "w") as fh, contextlib.redirect_stdout(fh):
        yield


def write_fasta(path, contig, seq):
    """A single-contig FASTA of ``seq``, 70 bases a line."""
    with open(path, "w") as fh:
        fh.write(f">{contig}\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i : i + 70] + "\n")


def write_genome(path, n, seed=GENOME_SEED):
    """A random n bp single-contig FASTA."""
    rng = np.random.default_rng(seed)
    write_fasta(path, "chr_bench", "".join("ACGT"[i] for i in rng.integers(0, 4, n)))


def simulate_reads(ref, work, cfg):
    """Linked reads of ``ref`` under ``work`` as ``SimConfig`` ``cfg`` says:
    returns (r1, r2, pairs simulated, seconds)."""
    from .index import parse_fasta
    from .io.simulate import simulate_linked_reads

    r1, r2 = os.path.join(work, "m.R1.fq.gz"), os.path.join(work, "m.R2.fq.gz")
    t0 = time.perf_counter()
    n = simulate_linked_reads(parse_fasta(ref), r1, r2, cfg)
    return r1, r2, n, time.perf_counter() - t0


def simulate_library(ref, work, barcodes, molecules, pairs, molecule_len, indel_rate, seed):
    """Linked reads of ``ref`` under ``work``, quals varied: returns (r1,
    r2, pairs simulated, seconds)."""
    from .io.simulate import SimConfig

    return simulate_reads(ref, work, SimConfig(
        n_barcodes=barcodes, molecules_per_barcode=molecules, pairs_per_molecule=pairs,
        molecule_len=molecule_len, indel_rate=indel_rate, vary_quals=True, seed=seed))


def make_library(work, genome_bp=2_000_000, barcodes=320, molecules=3, pairs=20,
                 molecule_len=40_000, indel_rate=0.1, seed=2):
    """Genome, index and simulated reads under ``work``: returns (ref, r1,
    r2, pairs simulated, index seconds, simulation seconds)."""
    from .index import build_index_files

    ref = os.path.join(work, "ref.fa")
    t0 = time.perf_counter()
    write_genome(ref, genome_bp)
    build_index_files(ref)
    t_index = time.perf_counter() - t0
    r1, r2, n, t_sim = simulate_library(ref, work, barcodes, molecules, pairs, molecule_len,
                                        indel_rate, seed)
    return ref, r1, r2, n, t_index, t_sim


def index_reference(reference, log_path, timeout=None):
    """Index ``reference`` with ``python -m arachne_tpu_torch.cli index`` in
    a subprocess (its output to ``log_path``), unless ``reference.arx.npz``
    exists; returns the build's record and the index's (``build_s``,
    ``build_mode_line`` and ``peak_rss_bytes`` are None for an index found
    on disk).  The peak is the child's own ``ru_maxrss``, read by
    ``os.wait4`` when it is reaped (the field RUSAGE_CHILDREN gives, for
    this child alone).  A build past ``timeout`` seconds is killed and
    raises, as does a failed one."""
    arx = reference + ".arx.npz"
    rec = {"built": False, "build_s": None, "build_mode_line": None, "peak_rss_bytes": None}
    if not os.path.exists(arx):
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.perf_counter()
        with open(log_path, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-m", "arachne_tpu_torch.cli", "index", reference],
                stdout=fh, stderr=subprocess.STDOUT, env=env)
        killer = threading.Timer(timeout, proc.kill) if timeout else None
        if killer:
            killer.start()
        try:
            _, status, usage = os.wait4(proc.pid, 0)
        finally:
            if killer:
                killer.cancel()
        proc.returncode = os.waitstatus_to_exitcode(status)
        rec["build_s"] = time.perf_counter() - t0
        with open(log_path) as fh:
            text = fh.read()
        if proc.returncode != 0:
            why = f", killed past {timeout} s" if proc.returncode == -signal.SIGKILL else ""
            raise RuntimeError(f"index of {reference} failed (exit code {proc.returncode}{why}); "
                               f"its output ends:\n{text[-3000:]}")
        rec.update(built=True, peak_rss_bytes=usage.ru_maxrss * 1024,
                   build_mode_line=next((ln.strip() for ln in text.splitlines()
                                         if "build-mode auto" in ln), None))
    with np.load(arx, allow_pickle=False) as z:
        seq_len = int(z["seq_len"])
        rec.update(index_bytes=os.path.getsize(arx), seq_len=seq_len, sa_intv=int(z["sa_intv"]),
                   sa_sampled=z["sa"].size == 0 and z["sa_sampled"].size > 0,
                   wide=seq_len >= (1 << 31))
    return rec


def reference_library(work, reference, barcodes=320, molecules=3, pairs=20,
                      molecule_len=40_000, indel_rate=0.1, seed=2, timeout=None):
    """A library on a given reference, as ``--reference`` makes it: the
    index (``index_reference``) and simulated reads under ``work``.
    Returns (reference, r1, r2, pairs simulated, the index record,
    simulation seconds)."""
    build = index_reference(reference, os.path.join(work, "index.log"), timeout)
    r1, r2, n, t_sim = simulate_library(reference, work, barcodes, molecules, pairs,
                                        molecule_len, indel_rate, seed)
    return reference, r1, r2, n, build, t_sim


def shard_digests(out):
    """{shard: SHA-256} of an output directory's shards."""
    digests = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name), "rb") as fh:
            digests[name] = hashlib.sha256(fh.read()).hexdigest()
    return digests


def library_reads(r1, r2, n_pairs):
    """The first ``n_pairs`` pairs of a library's gzipped FASTQ files as
    2 n code arrays, read 1 then read 2 of each pair."""
    import gzip

    from .align.pipeline import seq_to_codes

    reads = []
    with gzip.open(r1, "rt") as f1, gzip.open(r2, "rt") as f2:
        for k, (l1, l2) in enumerate(zip(f1, f2)):
            if k // 4 >= n_pairs:
                break
            if k % 4 == 1:
                reads += [seq_to_codes(l1.strip()), seq_to_codes(l2.strip())]
    return reads


def align(engine, out, ref, r1, r2, threads):
    """One ``align --sam`` run; returns its RunStats."""
    from . import cli

    with quiet(out + ".log"):
        return cli.main(["align", "--engine", engine, "--sam", "-t", str(threads),
                         out, ref, r1, r2])


def host_facts(paths):
    """The host a run is on: MemAvailable and MemTotal from /proc/meminfo
    in bytes (``build-mode auto`` picks the index build's route by
    MemAvailable, index/build.py), ``os.cpu_count()``, the free bytes of
    the filesystem that holds each of ``paths`` ({name: directory}), and,
    only where a card is present, nvidia-smi's name and power limit."""
    from .device import _first_line

    mem = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, _, rest = line.partition(":")
            if key in ("MemAvailable", "MemTotal"):
                mem[key] = int(rest.split()[0]) * 1024
    return {
        "mem_available_bytes": mem.get("MemAvailable"),
        "mem_total_bytes": mem.get("MemTotal"),
        "cpu_count": os.cpu_count(),
        "disk_free_bytes": {name: shutil.disk_usage(d).free for name, d in paths.items()},
        "card": _first_line(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"]) if torch.cuda.is_available() else None,
    }


def card_state():
    """nvidia-smi's name, power limit, SM clock and power draw, or None."""
    from .device import _first_line

    return _first_line(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                        "--format=csv,noheader"])


@contextlib.contextmanager
def recorded_bands(counts):
    """Count, in ``counts``, the band width of every problem submitted to
    ``BatchGlobal`` while the block runs."""
    from .ops.sw_global import BatchGlobal

    submit = BatchGlobal.submit

    def counting(self, query, target, w):
        counts[int(w)] = counts.get(int(w), 0) + 1
        return submit(self, query, target, w)

    BatchGlobal.submit = counting
    try:
        yield
    finally:
        BatchGlobal.submit = submit


def timed_run(engine, out, lib, threads, checked=False):
    """One timed run; ``checked`` adds its accuracy, its shards' digests
    and, on the card, its peak device memory."""
    from .runtime.accuracy import evaluate_sam
    from .runtime.timers import TIMERS

    TIMERS.reset()
    on_card = engine == "cuda"
    if checked and on_card:
        torch.cuda.reset_peak_memory_stats()
    stats = align(engine, out, *lib, threads)
    run = {
        "engine": engine,
        "pairs": stats.reads,
        "barcodes": stats.barcodes,
        "pairs_per_s": stats.reads / stats.elapsed,
        "align_loop_s": stats.elapsed,
        "stages_s": {k: v["seconds"] for k, v in TIMERS.as_dict().items()},
        "card_after": card_state(),
    }
    if checked:
        acc = evaluate_sam(os.path.join(out, "bc_sorted_bam.sam"))
        run.update(accuracy=acc.correct / max(acc.total, 1), evaluated_reads=acc.total,
                   shard_sha256=shard_digests(out),
                   peak_device_bytes=torch.cuda.max_memory_allocated() if on_card else None)
    return run


def profiled_run(out, lib, threads, dev):
    """One CUDA run under torch.profiler: the device time of every event
    that has any, and their sum against the align loop's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run = timed_run("cuda", out, lib, threads)
        torch.cuda.synchronize(dev)
    rows = [
        {"name": e.key, "count": e.count, "self_device_us": e.self_device_time_total}
        for e in prof.key_averages() if e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r["self_device_us"])
    busy_us = sum(r["self_device_us"] for r in rows)
    run.update(device_busy_us=busy_us,
               device_busy_share=busy_us / 1e6 / run["align_loop_s"], events=rows)
    return run


def same_shards(a, b):
    """{shard: identical} over two output directories' shard sets."""
    names = sorted(os.listdir(a))
    if sorted(os.listdir(b)) != names:
        raise AssertionError(f"{a} and {b} hold different shard sets")
    return {f: filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False)
            for f in names}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m arachne_tpu_torch.measure",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", default="cuda", choices=["cuda", "torch-cpu", "oracle"])
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--compare", nargs="*", default=[], metavar="ENGINE")
    ap.add_argument("--bands", action="store_true")
    ap.add_argument("-t", "--threads", type=int, default=2)
    ap.add_argument("--genome-bp", type=int, default=2_000_000)
    ap.add_argument("--barcodes", type=int, default=320)
    ap.add_argument("--molecules", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=20)
    ap.add_argument("--molecule-len", type=int, default=40_000)
    ap.add_argument("--indel-rate", type=float, default=0.1)
    ap.add_argument("--reference", metavar="FASTA",
                    help="the library's genome (indexed unless FASTA.arx.npz exists) in "
                    "place of a random one of --genome-bp")
    ap.add_argument("--out", help="write the JSON result here")
    args = ap.parse_args(argv)
    if args.trials < 1:
        ap.error("--trials must be at least 1")
    if args.profile and args.engine != "cuda":
        ap.error("--profile measures the card: it needs --engine cuda")

    from .device import probe, resolve_device
    from .ops.engine import warmup

    dev = resolve_device("cuda" if args.engine == "cuda" else "cpu")
    res = {"probe": probe(), "args": vars(args)}
    dirs = {"cwd": os.getcwd(), "work": tempfile.gettempdir()}
    if args.reference:
        dirs["reference"] = os.path.dirname(os.path.abspath(args.reference))
    res["host"] = host_facts(dirs)
    print(f"host: {json.dumps(res['host'])}", flush=True)
    work = tempfile.mkdtemp(prefix="measure_")
    try:
        shape = (args.barcodes, args.molecules, args.pairs, args.molecule_len, args.indel_rate)
        if args.reference:
            ref, r1, r2, n, build, t_sim = reference_library(work, args.reference, *shape)
            res["library"] = {"pairs": n, "reference": args.reference, "index": build,
                              "simulate_s": t_sim}
            print(f"library: {n} pairs; index {json.dumps(build)}; simulation {t_sim:.1f} s",
                  flush=True)
        else:
            ref, r1, r2, n, t_index, t_sim = make_library(work, args.genome_bp, *shape)
            res["library"] = {"pairs": n, "index_s": t_index, "simulate_s": t_sim}
            print(f"library: {n} pairs; index {t_index:.1f} s, simulation {t_sim:.1f} s",
                  flush=True)
        lib = (ref, r1, r2)
        warmup(dev)
        res["card_before"] = card_state()
        res["trials"] = []
        bands = {}
        for k in range(args.trials):
            with recorded_bands(bands) if args.bands and k == 0 else contextlib.nullcontext():
                run = timed_run(args.engine, os.path.join(work, f"trial{k}"), lib, args.threads,
                                checked=bool(args.reference) and k == 0)
            res["trials"].append(run)
            print(f"trial {k}: {run['pairs_per_s']} pairs/s, align loop "
                  f"{run['align_loop_s']} s; {run['card_after']}", flush=True)
            if "accuracy" in run:
                print(f"trial {k}: accuracy {run['accuracy']:.4f} of {run['evaluated_reads']} "
                      f"reads, peak device memory {run['peak_device_bytes']} bytes, shards "
                      f"{json.dumps(run['shard_sha256'])}", flush=True)
        if args.bands:
            res["bands"] = {str(w): n for w, n in sorted(bands.items())}
            print(f"CIGAR-stage band widths (w: problems): {res['bands']}", flush=True)
        if args.profile:
            run = profiled_run(os.path.join(work, "profiled"), lib, args.threads, dev)
            res["profiled"] = run
            print(f"profiled: {run['pairs_per_s']} pairs/s, device busy "
                  f"{run['device_busy_us']} us of {run['align_loop_s']} s "
                  f"({100 * run['device_busy_share']:.3f}%)", flush=True)
            for r in run["events"][:12]:
                print(f"   {r['self_device_us']:12.1f} us  x{r['count']:<5} {r['name'][:90]}")
        res["compare"] = []
        for engine in args.compare:
            out = os.path.join(work, f"compare_{engine}")
            run = timed_run(engine, out, lib, args.threads)
            run["identical"] = same_shards(os.path.join(work, "trial0"), out)
            res["compare"].append(run)
            print(f"{engine}: {run['pairs_per_s']} pairs/s; shards identical to "
                  f"{args.engine}: {run['identical']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    if not all(all(c["identical"].values()) for c in res["compare"]):
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
