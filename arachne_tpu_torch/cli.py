"""arachne-tpu-torch command line.

    python -m arachne_tpu_torch.cli align <opts> output_dir reference.fa R1.fq R2.fq
    python -m arachne_tpu_torch.cli index reference.fa
    python -m arachne_tpu_torch.cli simulate reference.fa --out-r1 .. --out-r2 ..
    python -m arachne_tpu_torch.cli evaluate out/bc_sorted_bam.sam

``align`` is the reference's run_align (arachne_tpu/cli.py) on one process
and one device, with these engines:

  cuda       TorchEngine on the GPU: kernels K1-K4 (the default);
  torch-cpu  TorchEngine on the CPU: the kernels' plain PyTorch versions;
  oracle     the reference's scalar host engine, barcode by barcode.

TorchEngine seeds on the host unless ARACHNE_DEVICE_SEEDING=1, which moves
SMEM seeding onto its device (kernels S1 and S3 on the GPU); any value but
"0" or "1" is an error.

``index``, ``simulate`` and ``evaluate`` call the same host library
functions as the reference's CLI, which cannot run without JAX.
"""

from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from arachne_tpu import __version__
from arachne_tpu.config import ArachneConfig, OutputOptions, PipelineOptions, RFAOptions
from arachne_tpu.runtime.timers import TIMERS

ENGINES = {"cuda": "cuda", "torch-cpu": "cpu", "oracle": None}


def load_centromeres(path):
    """loadCentromeres (aligner.go:375-399): TSV rows
    CEN<chr>\\t<chr>\\t<start>\\t<stop>; other rows ignored."""
    from arachne_tpu.rfa.types import Region

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
    from arachne_tpu.index import FMIndex, build_index_files, load_index

    arx = reference + ".arx.npz"
    if os.path.exists(arx):
        return FMIndex(*load_index(arx))
    if os.path.exists(reference + ".bwt"):
        from arachne_tpu.index.bwaio import load_bwa_index

        print(f"Loading bwa-format index for {reference}", flush=True)
        return FMIndex(*load_bwa_index(reference))
    print(f"Building index for {reference} ...", flush=True)
    t0 = time.time()
    build_index_files(reference, keep_full_sa="auto")
    print(f"Index built in {time.time() - t0:.1f}s", flush=True)
    return FMIndex(*load_index(arx))


def run_align(args):
    """The Arachne() pipeline (aligner.go:269-373) on one process."""
    from arachne_tpu.io.bam import BAMWriters
    from arachne_tpu.rfa.engine import do_rfa_for_one_barcode, process_barcodes
    from arachne_tpu.runtime.checkpoint import CheckpointedStream
    from arachne_tpu.runtime.stats import RunStats

    print(f"Starting arachne-tpu. Version: {__version__}")
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
        pipeline=PipelineOptions(engine=args.engine, num_workers=max(1, args.threads)),
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
    stream = CheckpointedStream(args.r1, args.r2, None)
    bams = BAMWriters(idx, args.output, cfg, version=__version__)
    stats = RunStats()
    if device is not None:
        from .ops.engine import TorchEngine, warmup

        warmup(device)
    t0 = time.time()

    def emit(res, n_records, unique):
        with TIMERS.stage("io.write"):
            bams.dump(res.alignments, res.attach_bx)
        stats.note_barcode(res)
        if n_records > 2:
            print(
                f"working on barcode {res.barcode}  num reads: {n_records}  "
                f"doing RFA: {res.ran_rfa}  unique_barcode {unique}"
            )

    # dedicated writer thread fed by a bounded queue (the reference's
    # BamThread): queue order == emission order, so output stays
    # byte-deterministic
    emit_q: queue.Queue = queue.Queue(maxsize=64)
    writer_exc: list = []

    def _writer_loop():
        while True:
            item = emit_q.get()
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
        emit_q.put((res, n_records, unique))

    def consume():
        if device is None:
            for records, unique in stream:
                res = do_rfa_for_one_barcode(
                    idx, cfg, records, unique, centromeres, extender=None
                )
                emit_async(res, len(records), unique)
            return
        # superbatch pipeline: host phases of batch N overlap the device
        # work of batch N+1; results are consumed in order
        tls = threading.local()

        def run_batch(batch):
            eng = getattr(tls, "engine", None)
            if eng is None:
                eng = TorchEngine(idx, cfg, device)
                tls.engine = eng
            return process_barcodes(idx, cfg, batch, eng, centromeres)

        def superbatches():
            pending, pending_pairs = [], 0
            for records, unique in stream:
                pending.append((records, unique))
                pending_pairs += len(records)
                if pending_pairs >= cfg.pipeline.reads_per_batch:
                    yield pending
                    pending, pending_pairs = [], 0
            if pending:
                yield pending

        with ThreadPoolExecutor(max_workers=cfg.pipeline.num_workers) as pool:
            futures = []
            for batch in superbatches():
                futures.append((pool.submit(run_batch, batch), batch))
                while len(futures) > cfg.pipeline.num_workers:
                    fut, b = futures.pop(0)
                    for res, (recs, uniq) in zip(fut.result(), b):
                        emit_async(res, len(recs), uniq)
            for fut, b in futures:
                for res, (recs, uniq) in zip(fut.result(), b):
                    emit_async(res, len(recs), uniq)

    try:
        consume()
    finally:
        # always deliver the sentinel, or the writer would block forever
        emit_q.put(None)
        writer_thread.join()
    if writer_exc:
        raise writer_exc[0]
    bams.close()
    dt = time.time() - t0
    stats.finish(dt)
    if os.environ.get("ARACHNE_TIMERS"):
        print("--- stage times ---")
        print(TIMERS.summary())
    print(
        f"Arachne completed successfully: {stats.reads} read pairs, "
        f"{stats.barcodes} barcodes, {stats.reads / max(dt, 1e-9):.1f} pairs/s"
    )
    return stats


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
        "ARACHNE_DEVICE_SEEDING=1 seeds on the engine's device too",
    )
    al.add_argument("output")
    al.add_argument("reference")
    al.add_argument("r1")
    al.add_argument("r2")

    ix = sub.add_parser("index", help="build the FM-index for a FASTA reference")
    ix.add_argument("reference")
    ix.add_argument("--sa-mode", choices=["auto", "full", "sampled"], default="auto")
    ix.add_argument(
        "--build-mode", choices=["auto", "sais", "incremental"], default="auto",
    )

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

    args = parser.parse_args(argv)
    if args.command == "align":
        return run_align(args)
    if args.command == "index":
        from arachne_tpu.index import build_index_files

        keep = {"auto": "auto", "full": True, "sampled": False}[args.sa_mode]
        out = build_index_files(
            args.reference, keep_full_sa=keep, build_mode=args.build_mode, progress=True
        )
        print(f"Index written to {out}")
    elif args.command == "simulate":
        from arachne_tpu.index import parse_fasta
        from arachne_tpu.io.simulate import SimConfig, simulate_linked_reads

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
        from arachne_tpu.runtime.accuracy import evaluate_sam

        print(evaluate_sam(args.sam, args.tolerance).as_csv(), end="")
    else:
        parser.print_help()
        sys.exit(1)


if __name__ == "__main__":
    main()
