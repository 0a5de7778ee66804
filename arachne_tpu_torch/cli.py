"""arachne-tpu-torch command line.

    python -m arachne_tpu_torch.cli align <opts> output_dir reference.fa R1.fq R2.fq
    python -m arachne_tpu_torch.cli index reference.fa [--bwa-format] [--sa-mode ..]
    python -m arachne_tpu_torch.cli standardize R1.fq R2.fq
    python -m arachne_tpu_torch.cli sort R1.fq R2.fq
    python -m arachne_tpu_torch.cli simulate reference.fa --out-r1 .. --out-r2 ..
    python -m arachne_tpu_torch.cli evaluate out/bc_sorted_bam.sam
    python -m arachne_tpu_torch.cli merge output_dir
    python -m arachne_tpu_torch.cli status checkpoint_manifest

``align`` is the reference's run_align (arachne_tpu/cli.py), with these
engines:

  cuda       TorchEngine on the GPU: kernels K1-K4 (the default);
  torch-cpu  TorchEngine on the CPU: the kernels' plain PyTorch versions;
  oracle     the reference's scalar host engine, barcode by barcode.

TorchEngine seeds on its device when that is a GPU (kernels S1 and S3, as
the reference seeds on its chip) and on the host on the CPU;
ARACHNE_DEVICE_SEEDING=0 seeds on the host on the GPU too, =1 on the
device on the CPU too (the plain lockstep S1/S3: slow); any value but "0"
or "1" is an error.

``align --checkpoint CK`` saves claim manifests as it goes; the same
command after a crash resumes exactly once, writing ``.gen<N>`` shards
that ``merge`` folds into the first ones, and ``status CK`` reports each
process's progress.  ``--coordinator host:port --num-processes P
--process-id i`` runs one of P processes (torch.distributed, gloo), each
writing ``.host<i>`` shards; several cards in one process take chunks
round-robin (ops/devicepool.py, ARACHNE_DEVICE_DP).  ``--index-mode``
places the FM-index for device seeding: ``replicated`` keeps the whole
rank table on the seeding card, ``sharded`` splits it by block across the
process's cards (replicated on one card), and ``auto`` shards exactly when
there is more than one card and the table exceeds ARACHNE_HBM_BUDGET
(default: the card's free memory).

The other subcommands call the port's copies of the host library
functions the reference's CLI calls (that CLI cannot run without JAX).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import queue
import re
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from . import __version__
from .config import ArachneConfig, OutputOptions, PipelineOptions, RFAOptions
from .runtime.timers import TIMERS

ENGINES = {"cuda": "cuda", "torch-cpu": "cpu", "oracle": None}
# barcode sets the writer thread's queue holds before the producer blocks
EMIT_QUEUE_ITEMS = 64


def load_centromeres(path):
    """loadCentromeres (aligner.go:375-399): TSV rows
    CEN<chr>\\t<chr>\\t<start>\\t<stop>; other rows ignored."""
    from .rfa.types import Region

    out = {}
    if not path:
        return out
    with open(path) as fh:
        for line in fh:
            if not line.startswith("CEN"):
                continue
            tokens = line.rstrip("\n").split("\t")
            if len(tokens) < 4:
                continue
            try:
                start, end = int(tokens[2]), int(tokens[3])
            except ValueError:
                continue
            out[tokens[1]] = Region(start=start, end=end)
    return out


def load_or_build_index(reference: str):
    from .index import FMIndex, build_index_files, load_index

    arx = reference + ".arx.npz"
    if os.path.exists(arx):
        return FMIndex(*load_index(arx))
    if os.path.exists(reference + ".bwt"):
        from .index.bwaio import load_bwa_index

        print(f"Loading bwa-format index for {reference}", flush=True)
        return FMIndex(*load_bwa_index(reference))
    print(f"Building index for {reference} ...", flush=True)
    t0 = time.time()
    build_index_files(reference, keep_full_sa="auto")
    print(f"Index built in {time.time() - t0:.1f}s", flush=True)
    return FMIndex(*load_index(arx))


def start_profiler(device):
    """A torch.profiler run over the align loop (the counterpart of the
    reference's jax.profiler.start_trace): host activity, and the card's
    kernels when the engine runs on one.  The program's own spans
    (runtime/timers.py) are traced with it and written beside the
    profiler's trace, on its clock (``write_spans``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def profiler_running() -> bool:
    """Whether a torch.profiler session is recording in this process: this
    run's (--profile-dir) or one its caller opened around it (none where
    torch was never imported)."""
    torch = sys.modules.get("torch")
    return torch is not None and bool(torch.autograd._profiler_enabled())


def write_spans(profile_dir: str, sfx: str) -> None:
    """``arachne{sfx}.spans.json`` beside the profiler's
    ``arachne{sfx}.trace.json``: the program's spans and counters as Chrome
    trace events, their times after the trace's ``baseTimeNanoseconds``
    (read from its head; 0 where it has none) so that one viewer lines the
    host's threads up with the card's kernels."""
    with open(os.path.join(profile_dir, f"arachne{sfx}.trace.json"), "rb") as fh:
        m = re.search(rb'"baseTimeNanoseconds":\s*(\d+)', fh.read(1 << 16))
    TIMERS.write_chrome_trace(os.path.join(profile_dir, f"arachne{sfx}.spans.json"),
                              int(m.group(1)) if m else 0)


def run_align(args):
    """The Arachne() pipeline (aligner.go:269-373)."""
    from .io.bam import BAMWriters
    from .parallel.distributed import (
        allreduce_max_int,
        allreduce_stats,
        assert_uniform_int,
        init_distributed,
        shard_suffix,
        shutdown_distributed,
    )
    from .rfa.engine import do_rfa_for_one_barcode, process_barcodes
    from .runtime.checkpoint import CheckpointedStream
    from .runtime.stats import RunStats

    print(f"Starting arachne-tpu. Version: {__version__}")
    ctx = init_distributed(args.coordinator or None, args.num_processes, args.process_id)
    host_sfx = shard_suffix(ctx)
    if ctx.initialized:
        print(f"Multi-host: process {ctx.process_index}/{ctx.process_count}")
    device = ENGINES[args.engine]
    if device is not None:
        from .device import resolve_device

        device = resolve_device(device)   # raises for cuda without a card
    cfg = ArachneConfig(
        rfa=RFAOptions(
            improper_pair_penalty=args.improper_pair_penalty,
            **({"rfa_min_read_pairs": 1 << 60} if args.no_rfa else {}),
        ),
        output=OutputOptions(
            position_chunk_size=args.partitions,
            read_groups=args.read_group,
            sample_id=args.sample_id,
            debug_tags=args.debug_tags,
            emit_sam=args.sam,
        ),
        pipeline=PipelineOptions(
            engine=args.engine, num_workers=max(1, args.threads), index_mode=args.index_mode,
        ),
        centromeres=args.centromeres,
        threads=args.threads,
    )
    centromeres = load_centromeres(args.centromeres)
    os.makedirs(args.output, exist_ok=True)
    if not os.access(args.output, os.W_OK):
        raise SystemExit(f"Output directory not writable: {args.output}")
    print(f"Loading reference: {args.reference}")
    idx = load_or_build_index(args.reference)
    print("Reference loaded")
    ckpt_path = (args.checkpoint + host_sfx) if args.checkpoint else None
    stream = CheckpointedStream(
        args.r1, args.r2, ckpt_path,
        process_index=ctx.process_index, process_count=ctx.process_count,
    )
    if ctx.process_count > 1 and ckpt_path:
        # fleet-wide generation agreement before any manifest write (see
        # CheckpointedStream.agree_generation), and on the merged claim
        # union itself: a host whose manifest glob missed a sibling would
        # re-run that sibling's completed sets as duplicates
        stream.agree_generation(allreduce_max_int(stream.generation, ctx))
        assert_uniform_int(stream.claims_digest(), ctx, "checkpoint claim digest")
    # exactly-once resume: truncate the previous generation's shards back
    # to the last manifest's flushed offsets (records written after that
    # save are discarded and their barcode sets re-run)
    for fname, off in stream.resume_offsets.items():
        path = os.path.join(args.output, fname)
        if os.path.exists(path) and os.path.getsize(path) > off:
            os.truncate(path, off)
    suffix = host_sfx + (f".gen{stream.generation}" if stream.generation > 0 else "")
    bams = BAMWriters(idx, args.output, cfg, version=__version__, shard_suffix=suffix)
    # durability: BGZF/file buffers must reach the OS before a manifest
    # claims their records as emitted; the offsets feed the truncation above
    stream.flush_fn = lambda: (bams.flush(), bams.offsets())[1]
    stream.save_initial()
    stats = RunStats()
    if device is not None:
        from .ops.devicepool import dispatch_devices
        from .ops.engine import TorchEngine, warmup

        for dev in dict.fromkeys(dispatch_devices(device)):
            warmup(dev)
    if stream.skip:
        print(f"Resuming: skipping {stream.skip} completed barcode sets")
    t0 = time.time()
    prof = start_profiler(device) if args.profile_dir else None
    # the program's spans come with any profiler over the run, its own or a
    # caller's (runtime/timers.py); a trace the caller started is left on
    traced = (prof is not None or profiler_running()) and not TIMERS.tracing
    if traced:
        TIMERS.trace(True)
    crash_after = int(os.environ.get("ARACHNE_CRASH_AFTER_SETS", 0))

    def emit(res, n_records, unique):
        with TIMERS.stage("io.write"):
            bams.dump(res.alignments, res.attach_bx)
        stats.note_barcode(res)
        stream.mark_done(1, n_records)
        if crash_after and stats.barcodes >= crash_after:
            # fault-injection hook (tests): die hard, mid-stream, without
            # flushing, as a host failure would
            os._exit(17)
        if n_records > 2:
            print(
                f"working on barcode {res.barcode}  num reads: {n_records}  "
                f"doing RFA: {res.ran_rfa}  unique_barcode {unique}"
            )

    # dedicated writer thread fed by a bounded queue (the reference's
    # BamThread): queue order == emission order, so output stays
    # byte-deterministic; mark_done runs here AFTER the dump, so manifests
    # never lead the data
    emit_q: queue.Queue = queue.Queue(maxsize=EMIT_QUEUE_ITEMS)
    writer_exc: list = []

    def _writer_loop():
        while True:
            with TIMERS.span("writer.idle"):
                item = emit_q.get()
            if TIMERS.tracing:
                TIMERS.count("emit_q.depth", emit_q.qsize())
            if item is None:
                return
            if writer_exc:
                continue  # drain after failure; producers must not block
            try:
                emit(*item)
            except BaseException as e:  # noqa: BLE001 - reraised in main
                writer_exc.append(e)

    writer_thread = threading.Thread(target=_writer_loop, name="bam-writer", daemon=True)
    writer_thread.start()

    def emit_async(res, n_records, unique):
        if writer_exc:
            raise writer_exc[0]
        item = (res, n_records, unique)
        try:
            emit_q.put_nowait(item)
        except queue.Full:
            # the writer sets the pace: the time blocked here is its backpressure
            with TIMERS.span("driver.emit_blocked"):
                emit_q.put(item)
        if TIMERS.tracing:
            TIMERS.count("emit_q.depth", emit_q.qsize())

    def consume():
        if device is None:
            for records, unique in TIMERS.iter_spans("driver.parse", stream):
                res = do_rfa_for_one_barcode(
                    idx, cfg, records, unique, centromeres, extender=None
                )
                emit_async(res, len(records), unique)
            return
        # superbatch pipeline: host phases of batch N overlap the device
        # work of batch N+1; results are consumed in order
        tls = threading.local()

        def run_batch(sb, batch):
            eng = getattr(tls, "engine", None)
            if eng is None:
                eng = TorchEngine(idx, cfg, device)
                tls.engine = eng
            with TIMERS.in_superbatch(sb):
                return process_barcodes(idx, cfg, batch, eng, centromeres)

        batch_limit = (
            int(os.environ.get("ARACHNE_TEST_READS_PER_BATCH", 0)) or cfg.pipeline.reads_per_batch
        )

        def superbatches():
            """(id, barcode sets) in input order, the ids from 0."""
            pending, pending_pairs, sb = [], 0, 0
            for records, unique in TIMERS.iter_spans("driver.parse", stream):
                pending.append((records, unique))
                pending_pairs += len(records)
                if pending_pairs >= batch_limit:
                    yield sb, pending
                    pending, pending_pairs, sb = [], 0, sb + 1
            if pending:
                yield sb, pending

        def emit_batch(fut, b):
            with TIMERS.span("driver.wait"):
                results = fut.result()
            for res, (recs, uniq) in zip(results, b):
                emit_async(res, len(recs), uniq)

        with ThreadPoolExecutor(max_workers=cfg.pipeline.num_workers) as pool:
            futures = []
            for sb, batch in superbatches():
                futures.append((pool.submit(run_batch, sb, batch), batch))
                while len(futures) > cfg.pipeline.num_workers:
                    emit_batch(*futures.pop(0))
            for fut, b in futures:
                emit_batch(fut, b)

    try:
        consume()
    finally:
        # always deliver the sentinel, or the writer would block forever
        emit_q.put(None)
        writer_thread.join()
        if traced:
            TIMERS.trace(False)
    if writer_exc:
        raise writer_exc[0]
    # final manifest first (it flushes the writers for their offsets)
    stream.finish()
    bams.close()
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, f"arachne{host_sfx}.trace.json"))
        write_spans(args.profile_dir, host_sfx)
    dt = time.time() - t0
    stats.finish(dt)
    global_stats = stats
    if ctx.process_count > 1:
        # counters summed over the processes; each already wrote its own
        # shards, so no output collective is needed
        global_stats = RunStats.from_vector(allreduce_stats(stats.to_vector(), ctx))
        global_stats.finish(dt)
    if args.stats_json:
        d = stats.as_dict()
        d["stage_times"] = TIMERS.as_dict()
        if ctx.process_count > 1:
            d["process_index"] = ctx.process_index
            d["process_count"] = ctx.process_count
            d["global"] = global_stats.as_dict()
        with open(args.stats_json + host_sfx, "w") as fh:
            json.dump(d, fh, indent=2)
    if os.environ.get("ARACHNE_TIMERS"):
        print("--- stage times ---")
        print(TIMERS.summary())
    print(
        f"Arachne completed successfully: {global_stats.reads} read pairs, "
        f"{global_stats.barcodes} barcodes, {stats.reads / max(dt, 1e-9):.1f} pairs/s"
        + (f" (host {ctx.process_index}: {stats.reads} pairs)" if ctx.process_count > 1 else "")
    )
    shutdown_distributed(ctx)
    return stats


def run_status(ckpt_base: str, stale_after: float = 300.0) -> int:
    """Failure detection, manifest-side: every host's claim progress and
    the age of its last save.  A host whose manifest has gone stale while
    its claim is unfinished has likely died — its residue is recoverable
    by re-running with any process count (claim-based resume,
    runtime/checkpoint.py).  Returns 1 if any host looks stale/dead, or
    if no manifest is found."""
    from .runtime.checkpoint import Checkpoint

    base = re.sub(r"\.host\d+$", "", ckpt_base)
    paths = sorted(set(glob.glob(base) + glob.glob(base + ".host*")))
    paths = [p for p in paths if not p.endswith(".tmp")]
    if not paths:
        print(f"no manifests found at {base}[.host*]")
        return 1
    now = time.time()
    stale = False
    for p in paths:
        ck = Checkpoint.load(p)
        if ck is None:
            continue
        age = now - os.path.getmtime(p)
        own = ck.claims[-1] if ck.claims else None
        claims = ", ".join(f"g{c.g} h{c.h}/{c.P}: {c.n} sets" for c in ck.claims)
        # the threshold scales with the host's observed save cadence
        # (recorded in the manifest); --stale-after overrides; hosts that
        # never reached a second save fall back to the floor
        if stale_after is not None:
            threshold = stale_after
        elif ck.save_interval > 0:
            threshold = max(60.0, 5.0 * ck.save_interval)
        else:
            threshold = 300.0
        flag = ""
        if own is not None and age > threshold:
            flag = (f"  ** STALE ({age:.0f}s since last save, threshold "
                    f"{threshold:.0f}s — host likely dead; re-run to recover its residue)")
            stale = True
        print(f"{p}: last save {age:.0f}s ago; {claims}{flag}")
    return 1 if stale else 0


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="arachne_tpu_torch",
        description="linked-read aligner on PyTorch + CUDA (haplotagging/stLFR/TELLseq)",
    )
    sub = parser.add_subparsers(dest="command")

    al = sub.add_parser("align", help="align barcode-sorted paired FASTQ")
    al.add_argument("-c", "--centromeres", default="")
    al.add_argument("-i", "--improper-pair-penalty", type=float, default=-4.0)
    al.add_argument("-p", "--partitions", type=int, default=40_000_000)
    al.add_argument("-r", "--read-group", default="sample:library:molecule:flowcell:lane")
    al.add_argument("-s", "--sample-id", default="sample")
    al.add_argument("-t", "--threads", type=int, default=2)
    al.add_argument("--sam", action="store_true", help="emit SAM text instead of BAM")
    al.add_argument("--debug-tags", action="store_true")
    al.add_argument(
        "--no-rfa", action="store_true",
        help="disable barcode-joint (RFA) alignment for every barcode",
    )
    al.add_argument(
        "--engine", choices=sorted(ENGINES), default="cuda",
        help="cuda = kernels on the GPU (raises without one); torch-cpu = "
        "their plain PyTorch versions on the CPU; oracle = scalar host engine. "
        "cuda seeds on the GPU (kernels S1, S3) unless ARACHNE_DEVICE_SEEDING=0; "
        "torch-cpu seeds on the host unless ARACHNE_DEVICE_SEEDING=1",
    )
    al.add_argument(
        "--index-mode", choices=["auto", "replicated", "sharded"], default="auto",
        help="FM-index placement for device seeding: replicated = the seeding card holds "
        "the whole rank table; sharded = the table split by block across the process's "
        "cards (those the batchers use, ARACHNE_DEVICE_DP), each record read from the "
        "card that holds it (one card: replicated); auto = sharded exactly when there "
        "is more than one card and the table exceeds ARACHNE_HBM_BUDGET bytes (default: "
        "the card's free memory)",
    )
    al.add_argument("--checkpoint", default="", help="checkpoint manifest path for resume")
    al.add_argument(
        "--coordinator", default=os.environ.get("ARACHNE_COORDINATOR", ""),
        help="multi-process coordinator address host:port (torch.distributed, gloo)",
    )
    al.add_argument(
        "--num-processes", type=int,
        default=int(os.environ.get("ARACHNE_NUM_PROCESSES", 0)) or None,
        help="multi-process process count",
    )
    al.add_argument(
        "--process-id", type=int,
        default=(int(os.environ["ARACHNE_PROCESS_ID"])
                 if "ARACHNE_PROCESS_ID" in os.environ else None),
        help="multi-process process id (0-based)",
    )
    al.add_argument("--stats-json", default="", help="write run statistics JSON here")
    al.add_argument(
        "--profile-dir", default="",
        help="write a torch.profiler Chrome trace of the align loop into this directory, "
        "and the program's own spans beside it (arachne.spans.json)",
    )
    al.add_argument("output")
    al.add_argument("reference")
    al.add_argument("r1")
    al.add_argument("r2")

    ix = sub.add_parser("index", help="build the FM-index for a FASTA reference")
    ix.add_argument("reference")
    ix.add_argument(
        "--sa-mode", choices=["auto", "full", "sampled"], default="auto",
        help="auto = dense SA only for small genomes (IndexOptions.sa_full_max_len)",
    )
    ix.add_argument(
        "--sampled-sa", action="store_true", help="deprecated alias for --sa-mode sampled",
    )
    ix.add_argument(
        "--bwa-format", action="store_true",
        help="also write bwa-compatible .bwt/.sa/.pac/.ann/.amb files",
    )
    ix.add_argument(
        "--build-mode", choices=["auto", "sais", "incremental"], default="auto",
    )

    st = sub.add_parser("standardize", help="convert linked-read FASTQ to BX:Z/VX:i form")
    st.add_argument("r1")
    st.add_argument("r2")
    st.add_argument("--out-r1", default="standard.R1.fq.gz")
    st.add_argument("--out-r2", default="standard.R2.fq.gz")

    so = sub.add_parser("sort", help="barcode-sort paired FASTQ")
    so.add_argument("r1")
    so.add_argument("r2")
    so.add_argument("--out-r1", default="bc_sorted.R1.fq.gz")
    so.add_argument("--out-r2", default="bc_sorted.R2.fq.gz")

    sim = sub.add_parser("simulate", help="simulate linked-read FASTQ with truth names")
    sim.add_argument("reference")
    sim.add_argument("--out-r1", default="sim.R1.fq.gz")
    sim.add_argument("--out-r2", default="sim.R2.fq.gz")
    sim.add_argument("--barcodes", type=int, default=50)
    sim.add_argument("--molecules", type=int, default=3)
    sim.add_argument("--pairs", type=int, default=12)
    sim.add_argument("--molecule-len", type=int, default=40000)
    sim.add_argument("--error-rate", type=float, default=0.002)
    sim.add_argument("--indel-rate", type=float, default=0.0)
    sim.add_argument("--vary-quals", action="store_true")
    sim.add_argument("--seed", type=int, default=0)

    ev = sub.add_parser("evaluate", help="score a SAM against truth-encoded read names")
    ev.add_argument("sam")
    ev.add_argument("--tolerance", type=int, default=20)

    mg = sub.add_parser("merge", help="merge resume-generation output shards")
    mg.add_argument("output_dir")

    stt = sub.add_parser(
        "status", help="report fleet progress/staleness from checkpoint manifests"
    )
    stt.add_argument("checkpoint", help="manifest base path (as passed to --checkpoint)")
    stt.add_argument(
        "--stale-after", type=float, default=None,
        help="seconds since last save before a host is flagged stale "
        "(default: 5x the host's recorded save cadence, floor 60s)",
    )

    args = parser.parse_args(argv)
    if args.command == "align":
        return run_align(args)
    if args.command == "index":
        from .index import build_index_files

        mode = "sampled" if args.sampled_sa else args.sa_mode
        keep = {"auto": "auto", "full": True, "sampled": False}[mode]
        out = build_index_files(
            args.reference, keep_full_sa=keep, build_mode=args.build_mode, progress=True
        )
        print(f"Index written to {out}")
        if args.bwa_format:
            from .index import load_index
            from .index.bwaio import save_bwa_index

            save_bwa_index(args.reference, *load_index(out))
            print(f"bwa-format index written to {args.reference}.[bwt,sa,pac,ann,amb]")
    elif args.command == "standardize":
        from .io.standardize import standardize

        o1, o2 = standardize(args.r1, args.r2, args.out_r1, args.out_r2)
        print(f"Standardized FASTQ: {o1} {o2}")
    elif args.command == "sort":
        from .io.preprocess import barcode_sort

        o1, o2 = barcode_sort(args.r1, args.r2, args.out_r1, args.out_r2)
        print(f"Barcode-sorted FASTQ: {o1} {o2}")
    elif args.command == "simulate":
        from .index import parse_fasta
        from .io.simulate import SimConfig, simulate_linked_reads

        n = simulate_linked_reads(
            parse_fasta(args.reference), args.out_r1, args.out_r2,
            SimConfig(
                n_barcodes=args.barcodes,
                molecules_per_barcode=args.molecules,
                pairs_per_molecule=args.pairs,
                molecule_len=args.molecule_len,
                error_rate=args.error_rate,
                indel_rate=args.indel_rate,
                vary_quals=args.vary_quals,
                seed=args.seed,
            ),
        )
        print(f"Simulated {n} read pairs -> {args.out_r1} {args.out_r2}")
    elif args.command == "evaluate":
        from .runtime.accuracy import evaluate_sam

        print(evaluate_sam(args.sam, args.tolerance).as_csv(), end="")
    elif args.command == "status":
        raise SystemExit(run_status(args.checkpoint, args.stale_after))
    elif args.command == "merge":
        from .io.merge import merge_generations

        merged = merge_generations(args.output_dir)
        print(f"Merged {merged} sharded outputs in {args.output_dir}")
    else:
        parser.print_help()
        sys.exit(1)


if __name__ == "__main__":
    main()
