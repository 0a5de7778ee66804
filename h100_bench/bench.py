"""One run of one cell: ``align`` of arachne_tpu_torch on a steady stream
of linked-read libraries, measured over whole libraries.

Set-up (``setup_s``: from the process's start to the window's opening):
the configuration's genome and the program's index of it (built into
``cache/`` on the first run of a checkout, loaded after), the mix's pool
of libraries simulated from ``--seed`` into plain FASTQ under TMPDIR, and
the start of one ``align --engine cuda -t T`` invocation (index load,
kernel build or load, warm-up) up to the window.  The invocation reads
the pool library after library (probes.py) and is the one entry the
window drives.

Window: it opens at the first library boundary after the first T
superbatches have been written and closes at the first library boundary
at or after ``--seconds`` later (window.py).  ``pairs_per_s`` is the read
pairs written in it over its wall time.  Then the stream stops, the
in-flight sets drain and the run exits as ``align`` does.

``--trace 1`` runs under torch.profiler and reports the per-layer
metrics (metrics/*.py over the record readers.py describes) and a
breakdown; ``--trace 0`` reports the end-to-end metrics.

Then, with the program's state freed, check.py decides ``correct``.  The
result is the last line of standard output; the numbers compared, each
with its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

from . import catalog, check, genomes, hostinfo, library, window, work
from .probes import Probes, launch_count

ROOT = os.path.dirname(genomes.HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "arachne_tpu"}


def process_start_unix() -> float:
    """When this process started, by the Unix clock (from /proc: its start
    in clock ticks after boot, against the uptime now)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pool_libraries(traffic: dict, seconds: float) -> int:
    """Libraries to simulate: the one the window opens after, enough for
    ``seconds`` at the mix's ``pool_pairs_per_s`` (1.5 x the rate measured),
    and the one it closes in."""
    cfg = library.sim_config(traffic)
    per_lib = (sum(cfg.pair_counts) if cfg.pair_counts is not None
               else cfg.n_barcodes * cfg.molecules_per_barcode * cfg.pairs_per_molecule)
    return 2 + math.ceil(traffic["pool_pairs_per_s"] * seconds / per_lib)


def forbidden_modules():
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def run_cell(root: str, bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             engine: str = "cuda", processes: Optional[int] = None,
             t_process: Optional[float] = None) -> dict:
    """One run; returns the result object (the last line's)."""
    t_process = time.time() if t_process is None else t_process
    cell = catalog.cell(bench, cell_name)
    cfg = catalog.config(bench, root, cell["config"])
    traffic = catalog.traffic(root, cell["traffic"])
    threads = int(cfg["threads"])
    on_card = engine == "cuda"
    import torch

    prep = genomes.prepared(cfg, os.path.join(root, os.path.basename(genomes.HERE), "cache"))
    if prep["built"]:
        log(f"first run in this checkout: built {json.dumps(prep['built'])}")
    work_dir = tempfile.mkdtemp(prefix="h100_bench_")
    try:
        t0 = time.perf_counter()
        contigs = genomes.read_contigs(prep["fasta"])
        n_libs = pool_libraries(traffic, seconds)
        libs = library.pool(contigs, traffic, seed, n_libs, work_dir)
        del contigs
        os.sync()   # the pool's pages written back before the window, not inside it
        log(f"pool: {n_libs} libraries of {libs[0][2]} pairs simulated in "
            f"{time.perf_counter() - t0:.3f} s")
        probes = Probes(libs, threads, seconds, trace)
        out = os.path.join(work_dir, "out")
        from arachne_tpu_torch import cli

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        tracer = contextlib.nullcontext()
        if trace and on_card:
            from .devtrace import DeviceTrace

            tracer = DeviceTrace()
        launches0 = launch_count()
        with open(os.path.join(work_dir, "align.log"), "w") as chatter:
            with probes, tracer, contextlib.redirect_stdout(chatter):
                cli.main(["align", "--engine", engine, "-t", str(threads), out, prep["fasta"],
                          libs[0][0], libs[0][1]])
        launches = launch_count() - launches0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if probes.errors:
            raise RuntimeError("; ".join(probes.errors[:5]))
        if probes.t_close is None:
            raise RuntimeError("the run ended before its window closed")
        log(f"libraries fed {probes.libraries_fed}, reused {probes.libraries_reused}; "
            f"card {hostinfo.card_state()}; RunStats rfa_barcodes "
            f"{getattr(probes.stats, 'rfa_barcodes', None)} of "
            f"{getattr(probes.stats, 'barcodes', None)} barcodes")
        lo, hi = probes.t_open, probes.t_close
        pairs = window.window_pairs([fs.pairs for fs in probes.feed], probes.opened, probes.closed)
        setup_s = probes.unix_open - t_process
        ends = [fs.emitted for fs in probes.feed[probes.opened : probes.closed + 1] if fs.closes]
        log(f"window: sets {probes.opened + 1}..{probes.closed} of {probes.emitted} written, "
            f"{pairs} pairs in {hi - lo:.3f} s (libraries {[round(b - a, 3) for a, b in zip(ends, ends[1:])]} s, "
            f"process CPU {probes.cpu_close - probes.cpu_open:.1f} s); set-up {setup_s:.3f} s")
        log(f"host in the window: {json.dumps(hostinfo.cpu_between(probes.host_open, probes.host_close))}")
        result = {"correct": False, "attempted": probes.closed - probes.opened, "failed": 0}
        device = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
        if not trace:
            e2e = {"pairs_per_s": pairs / (hi - lo), "setup_s": setup_s}
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in catalog.metrics_of(bench, cell_name, "end_to_end")}
        else:
            run, breakdown, busy = traced_record(probes, tracer, threads, pairs, launches,
                                                 on_card)
            metrics = catalog.read_metrics(root, catalog.metrics_of(bench, cell_name, "per_layer"),
                                           run)
            if busy is not None:
                device.update(busy_s=busy, window_s=hi - lo)
                result["breakdown"] = breakdown
        result["metrics"] = metrics
        result["device"] = device
        del tracer, cli
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        index_dir, ref_build = genomes.reference_index(prep)
        if ref_build:
            log(f"first run in this checkout: the reference's index built in {ref_build:.1f} s")
        chk = check.compare(out, probes, libs, index_dir, traffic, seed, threads,
                            processes or min(8, os.cpu_count() or 1))
        log(f"check: {chk['sets_checked']} sets, {chk['pairs_checked']} pairs, "
            f"{chk['records_checked']} records against the reference in {chk['reference_s']:.1f} s "
            f"(all of the check {chk['check_s']:.1f} s)")
        result["correct"] = check.verdict(chk["numbers"])
        result["failed"] = chk["failed_sets"] + chk["numbers"]["unwritten_sets"]
        result["check"] = {k: {"value": v, "limit": check.LIMITS[k]}
                           for k, v in chk["numbers"].items()}
        return result
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def traced_record(probes, tracer, threads, pairs, launches, on_card):
    """The record the per-layer readers read, the breakdown, and the
    device's busy seconds in the window (None without a whole trace)."""
    lo, hi = probes.t_open, probes.t_close
    stages = {k: v - probes.stages_open.get(k, 0.0) for k, v in probes.stages_close.items()}
    stages = {k: v for k, v in stages.items() if v > 0}
    run = {"threads": threads, "pairs": pairs, "window": (lo, hi), "window_s": hi - lo,
           "stages_s": stages, "batch_spans": [(a, b) for a, b, _ in probes.batches],
           "device": None, "global_cells": None, "card": None, "max_sm_mhz": None}
    cells = work.band_cells((q, t, w) for ts, q, t, w in probes.global_problems if lo <= ts <= hi)
    run["global_cells"] = cells
    if not on_card:
        return run, None, None
    import torch

    from .devtrace import kernel_of, port_kernel_names

    names = port_kernel_names(os.path.join(ROOT, "arachne_tpu_torch", "ops", "csrc"))
    unix_minus_perf = probes.unix_open - probes.t_open
    events = tracer.events(unix_minus_perf)
    seen = sum(1 for n, _, _ in events if kernel_of(n, names) is not None)
    run.update(card=torch.cuda.get_device_name(0), max_sm_mhz=hostinfo.max_sm_mhz())
    if seen != launches:
        log(f"the profiler lost kernel records ({seen} traced, {launches} launched): "
            "the trace is discarded")
        return run, None, None
    memo = {}

    def kind(name):
        if name not in memo:
            memo[name] = kernel_of(name, names)
        return memo[name]

    run["device"] = {"events": events, "port_kernels": names, "kernel_of": kind}
    spans = [(a, b) for _, a, b in events]
    busy = window.covered(spans, lo, hi)
    by_op = {}
    for n, a, b in events:
        for x, y in window.clip([(a, b)], lo, hi):
            by_op[n] = by_op.get(n, 0.0) + (y - x)
    stage_spans = [(n, a / 1e9 - unix_minus_perf, b / 1e9 - unix_minus_perf)
                   for n, a, b in probes.stage_spans]
    idle = window.idle_by_stage(spans, stage_spans, lo, hi)
    breakdown = {
        "device_ops": [[n[:120], s] for n, s in sorted(by_op.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n[:120], s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
    }
    return run, breakdown, busy


def main(argv=None) -> int:
    t_process = process_start_unix()
    ap = argparse.ArgumentParser(prog="h100_bench/run.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    for k in [k for k in os.environ if k.startswith("ARACHNE_")]:
        del os.environ[k]   # the program's defaults, whatever the caller's environment
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(genomes.CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(genomes.CACHE, "triton")
    bench = catalog.load(ROOT)
    cell = catalog.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(ROOT, bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_process=t_process)
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(bad)}")
        return 3
    for k, v in result["check"].items():
        log(f"{k} {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0
