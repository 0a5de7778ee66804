"""The port's benchmark: kernel K1's DP rate and the aligner's end-to-end
throughput on one GPU.

    python -m arachne_tpu_torch.bench [--only LINE ...] [--trials N] [--cache DIR]

The jax-free twin of the repository's root ``bench.py``.  It prints one
JSON line per metric, ``{"metric", "value", "unit", "vs_baseline",
"correct", "detail"}``, in the reference's order and under its metric
names and units, the headline last:

  gcups          seed_extension_DP_GCUPS: kernel K1 (``ops/sw_extend.
                 extend_batch`` on the card) on the reference's 4096
                 problems of 100 x 250 (rng 0, h0 19), timed by CUDA events
                 around a CUDA graph of its launches (``device.graph_ms``),
                 with torch.profiler's device time in ``detail``; in-band
                 cells counted as the reference counts them.  ``correct``:
                 its outputs equal the plain version's on the card.
                 ``vs_baseline``: against the scalar ``align/ksw.extend2``
                 on 32 of the problems on this host;
  repeat         repeat_genome_pairs_per_sec: a 3 Mbp genome with 10 repeat
                 families of 20 x 1 kb copies at 95% identity, 150
                 lognormal barcodes (one of 15,000 pairs, every 17th
                 VX:i:0); ``vs_baseline`` is the accuracy;
  indel          indel_e2e_pairs_per_sec: the 2 Mbp genome, 19,200 pairs,
                 10% of reads with an indel (``measure.make_library``'s
                 library), with the count of gapped records;
  calibration    mapq_expected_calibration_error: a 3 Mbp genome with 8
                 families of 15 x 2 kb copies at 99.9% identity, 1%
                 substitutions, 10% indel reads, varied quals, 120 skewed
                 barcodes (every 19th VX:i:0);
  device_seeded  end_to_end_device_seeded_pairs_per_sec: the headline's
                 library with ARACHNE_DEVICE_SEEDING=1 (kernels S1 and S3);
  headline       end_to_end_pairs_per_sec: the 2 Mbp genome, 320 barcodes x
                 3 molecules x 20 pairs (seed 7), host seeding, best of
                 ``--trials``; its ``detail`` sums up the other lines.

Every line but device_seeded pins host seeding (ARACHNE_DEVICE_SEEDING=0),
though the card's default is device seeding, so that each measures what it
measured before device seeding became the default.

Every end-to-end line is one ``align --engine cuda --sam -t 2`` run
(``measure.timed_run``, as ``measure`` drives the CLI), its accuracy from
``runtime/accuracy.evaluate_sam``, and is ``correct`` when its fixture's
FASTA and decompressed FASTQ and every output shard have the SHA-256 that
``bench_reference.json`` records from the JAX package's run on the same
fixture.  The bench prints every line, then exits 1 if any is not correct.

The fixtures are made by the port's simulator copy with the reference's
seeds and sizes (default arguments of the fixture functions), once, under
``--cache`` (default ``build/bench_cache`` in the checkout), each in a
directory named by its arguments; their index builds are set-up and lie
outside every timed run.  Not ported: the reference's tunnel slope timing
and Pallas/XLA switch, and its round-1 baseline, a TPU figure: the
headline's ``vs_baseline`` is null.  The bench runs on the card and raises
without one; ``engine="torch-cpu"`` (the plain versions, for tests) is an
argument of ``main``, not a flag.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import hashlib
import json
import os
import re
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import measure
from .device import device_ms, graph_ms, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_reference.json")
THREADS = 2
REPEAT_GENOME_SEED = 20260821

Lib = Tuple[str, str, str]


# --------------------------------------------------------------- fixtures


def cached(cache: str, kind: str, args: dict, make: Callable[[str], None]) -> str:
    """The directory of one fixture part under ``cache``, named by its kind
    and arguments; ``make(dir)`` fills it the first time (in a temporary
    directory renamed when done, so a cut build is made again)."""
    key = hashlib.sha256(json.dumps(args, sort_keys=True).encode()).hexdigest()[:12]
    path = os.path.join(cache, f"{kind}-{key}")
    if not os.path.isdir(path):
        tmp = f"{path}.tmp{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        make(tmp)
        os.rename(tmp, path)
    return path


def random_genome(cache: str, genome_bp: int) -> str:
    """The headline's and the indel line's genome (``measure.write_genome``,
    seed 20260820), indexed."""
    from .index import build_index_files

    def make(d):
        measure.write_genome(os.path.join(d, "ref.fa"), genome_bp)
        build_index_files(os.path.join(d, "ref.fa"))

    d = cached(cache, "genome", {"bp": genome_bp, "seed": measure.GENOME_SEED}, make)
    return os.path.join(d, "ref.fa")


def repeat_genome(cache: str, contig: str, **genome) -> str:
    """A genome of ``io.simulate.make_repeat_genome`` (seed 20260821), indexed."""
    from .index import build_index_files
    from .io.simulate import make_repeat_genome

    def make(d):
        seq = make_repeat_genome(**genome, seed=REPEAT_GENOME_SEED)
        measure.write_fasta(os.path.join(d, "ref.fa"), contig, seq)
        build_index_files(os.path.join(d, "ref.fa"))

    d = cached(cache, contig, genome, make)
    return os.path.join(d, "ref.fa")


def reads(cache: str, kind: str, ref: str, counts: Optional[dict] = None, **sim) -> Lib:
    """Linked reads of ``ref`` (``measure.simulate_reads``) with SimConfig
    fields ``sim``; ``counts``: pairs per barcode from
    ``skewed_pair_counts(default_rng(counts["rng"]), n_barcodes, ...)``."""
    from .io.simulate import SimConfig, skewed_pair_counts

    def make(d):
        cfg = dict(sim)
        if counts is not None:
            c = dict(counts)
            cfg["pair_counts"] = skewed_pair_counts(np.random.default_rng(c.pop("rng")),
                                                    sim["n_barcodes"], **c)
        measure.simulate_reads(ref, d, SimConfig(**cfg))

    d = cached(cache, kind, {"ref": os.path.basename(os.path.dirname(ref)),
                             "counts": counts, **sim}, make)
    return ref, os.path.join(d, "m.R1.fq.gz"), os.path.join(d, "m.R2.fq.gz")


def headline_fixture(cache: str, genome_bp: int = 2_000_000, barcodes: int = 320,
                     molecules: int = 3, pairs: int = 20) -> Lib:
    """The reference's ``_bench_fixture`` (bench.py:87): 320 x 3 x 20 pairs
    of the 2 Mbp genome, seed 7."""
    return reads(cache, "headline", random_genome(cache, genome_bp), n_barcodes=barcodes,
                 molecules_per_barcode=molecules, pairs_per_molecule=pairs, seed=7)


def indel_fixture(cache: str, genome_bp: int = 2_000_000, barcodes: int = 320,
                  molecules: int = 3, pairs: int = 20) -> Lib:
    """The reference's indel library (bench.py:189-206), which is
    ``measure.make_library``'s: indel rate 0.1, varied quals, seed 2."""
    ref = random_genome(cache, genome_bp)
    d = cached(cache, "indel", {"bp": genome_bp, "barcodes": barcodes, "molecules": molecules,
                                "pairs": pairs},
               lambda d: measure.simulate_library(ref, d, barcodes, molecules, pairs,
                                                  40_000, 0.1, 2))
    return ref, os.path.join(d, "m.R1.fq.gz"), os.path.join(d, "m.R2.fq.gz")


def repeat_fixture(cache: str, genome_bp: int = 3_000_000, families: int = 10,
                   copies: int = 20, barcodes: int = 150, mean_pairs: int = 30,
                   big_barcode_pairs: int = 15_000, invalid_every: int = 17) -> Lib:
    """The reference's ``_repeat_fixture`` (bench.py:127): 1 kb repeat
    units at 95% identity, lognormal barcodes (sigma 1.2, rng 11) with one
    giant barcode first, 25 pairs a molecule, seed 9."""
    ref = repeat_genome(cache, "chr_repeat", length=genome_bp, n_families=families,
                        copies=copies, unit_len=1000, identity=0.95)
    return reads(cache, "repeat", ref,
                 counts=dict(rng=11, mean_pairs=mean_pairs, sigma=1.2,
                             big_barcode_pairs=big_barcode_pairs),
                 n_barcodes=barcodes, pairs_per_molecule=25, invalid_every=invalid_every,
                 seed=9)


def hard_fixture(cache: str, genome_bp: int = 3_000_000, families: int = 8, copies: int = 15,
                 barcodes: int = 120, mean_pairs: int = 40, invalid_every: int = 19) -> Lib:
    """The reference's ``_hard_fixture`` (bench.py:300): 2 kb repeat units
    at 99.9% identity; 1% substitutions, 10% indel reads, varied quals;
    lognormal barcodes (sigma 1.1, rng 23), 25 pairs a molecule, seed 31."""
    ref = repeat_genome(cache, "chr_hard", length=genome_bp, n_families=families,
                        copies=copies, unit_len=2000, identity=0.999)
    return reads(cache, "hard", ref, counts=dict(rng=23, mean_pairs=mean_pairs, sigma=1.1),
                 n_barcodes=barcodes, pairs_per_molecule=25, error_rate=0.01, indel_rate=0.1,
                 vary_quals=True, invalid_every=invalid_every, seed=31)


FIXTURES: Dict[str, Callable[[str], Lib]] = {
    "repeat": repeat_fixture, "indel": indel_fixture, "hard": hard_fixture,
    "headline": headline_fixture,
}


def fixture_sha256(lib: Lib) -> Dict[str, str]:
    """SHA-256 of the FASTA and of each FASTQ decompressed (gzip stamps
    the time into its header, so the .gz bytes differ between builds)."""
    ref, r1, r2 = lib
    out = {}
    for key, path, opener in (("fasta", ref, open), ("r1", r1, gzip.open), ("r2", r2, gzip.open)):
        h = hashlib.sha256()
        with opener(path, "rb") as fh:
            for block in iter(lambda: fh.read(1 << 20), b""):
                h.update(block)
        out[key] = h.hexdigest()
    return out


def load_reference(path: Optional[str] = None) -> dict:
    """The JAX package's recorded digests and figures, by fixture."""
    with open(path or REFERENCE) as fh:
        return json.load(fh)["fixtures"]


# ------------------------------------------------------------ line a: K1


def make_problems(rng, B, qlen, tlen):
    """The reference's problems (bench.py:45): queries cut from position
    40 of random targets, with 0-5 substitutions each."""
    ts = rng.integers(0, 4, (B, tlen)).astype(np.int8)
    qs = np.full((B, qlen), 4, np.int8)
    for i in range(B):
        q = ts[i, 40 : 40 + qlen].copy()
        nmut = rng.integers(0, 6)
        idxs = rng.integers(0, qlen, nmut)
        q[idxs] = (q[idxs] + 1) % 4
        qs[i] = q
    return qs, ts


def band_cells(qlen: int, tlen: int, w: int) -> int:
    """In-band DP cells of one problem, as the reference counts them
    (bench.py:491-497): every row's band, whether or not the row is
    reached."""
    return sum(max(0, min(qlen, i + w + 1) - max(0, i - w)) for i in range(tlen))


def gcups_problems(B: int = 4096, qlen: int = 100, tlen: int = 250, h0: int = 19):
    """The line's problems and band: (qs, ts, qlens, tlens, ws, h0s) as
    numpy arrays, and w = clamp_band(opt, qlen, opt.w, opt.pen_clip5, 1)."""
    from .config import MemOptions
    from .ops.sw_extend import clamp_band

    opt = MemOptions()
    qs, ts = make_problems(np.random.default_rng(0), B, qlen, tlen)
    w = clamp_band(opt, qlen, opt.w, opt.pen_clip5, 1)
    per = [np.full(B, v, np.int32) for v in (qlen, tlen, w, h0)]
    return (qs, ts, *per), w


def gcups_line(dev: torch.device, B: int = 4096, qlen: int = 100, tlen: int = 250,
               h0: int = 19, reps: int = 20) -> dict:
    """Line a on the card: K1 through ``extend_batch``, its outputs held to
    ``extend_batch_torch`` on the same tensors.  ``cells`` is the
    reference's count, every row's band; ``cells_needed`` the plain
    version's, the rows each problem reaches before it dies or ends."""
    from .align import ksw
    from .config import MemOptions
    from .ops.params import kernel_params
    from .ops.sw_extend import extend_batch, extend_batch_torch

    if dev.type != "cuda":
        raise ValueError(f"the GCUPS line times kernel K1 on the card, not on {dev}")
    opt = MemOptions()
    arrays, w = gcups_problems(B, qlen, tlen, h0)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    p = kernel_params(opt, dev)
    kw = dict(p.gaps(), zdrop=p.zdrop)

    def run():
        return extend_batch(*args, p.mat, **kw)

    got = run()
    needed = {"cells": 0}
    correct = torch.equal(got, extend_batch_torch(*args, p.mat, **kw, stats=needed))
    ms = graph_ms(run, reps)
    on_card_ms = device_ms(run, reps)
    cells_per = band_cells(qlen, tlen, w)
    gcups = cells_per * B / ms / 1e6

    qs, ts = arrays[:2]
    mat = opt.scoring_matrix()
    n_base = 32
    t0 = time.perf_counter()
    for i in range(n_base):
        ksw.extend2(qs[i].astype(np.uint8), ts[i].astype(np.uint8), mat, opt.o_del, opt.e_del,
                    opt.o_ins, opt.e_ins, w, opt.pen_clip5, opt.zdrop, h0)
    base_gcups = cells_per / ((time.perf_counter() - t0) / n_base) / 1e9
    return {
        "metric": "seed_extension_DP_GCUPS",
        "value": gcups,
        "unit": "GCUPS",
        "vs_baseline": gcups / base_gcups,
        "correct": correct,
        "detail": {
            "batch": B, "qlen": qlen, "tlen": tlen, "band": w,
            "kernel": "cuda K1 (arachne_tpu_torch/ops/csrc/extend.cu)",
            "device": card_name(dev),
            "batch_ms": ms,
            "batch_device_ms": on_card_ms,
            "cells": cells_per * B,
            "cells_needed": needed["cells"],
            "baseline_gcups_scalar_oracle": base_gcups,
        },
    }


# ---------------------------------------------------- end-to-end lines


def launchers() -> Dict[str, Callable]:
    """The kernels' wrappers by name; each counts its launches."""
    from .ops.cuda_extend import extend_cuda
    from .ops.cuda_global import global_score_cuda, global_z_cuda, traceback_cuda
    from .ops.cuda_local import local_cuda
    from .ops.cuda_seed import pass3_cuda, smem_pass_cuda

    return {"K1": extend_cuda, "K2": local_cuda, "K3 score": global_score_cuda,
            "K3 z": global_z_cuda, "K4": traceback_cuda, "S1": smem_pass_cuda, "S3": pass3_cuda}


def card_name(dev: torch.device) -> str:
    """The card's name with nvidia-smi's power limit (``measure.card_state``);
    "cpu" for the CPU."""
    if dev.type != "cuda":
        return "cpu"
    return f"{torch.cuda.get_device_name(dev)}; nvidia-smi: {measure.card_state()}"


@contextlib.contextmanager
def seeding_env(value: str):
    """ARACHNE_DEVICE_SEEDING=``value`` while the block runs, restored
    after: "0" pins host seeding on the card too, where the default is
    device seeding; "1" seeds on any device."""
    old = os.environ.get("ARACHNE_DEVICE_SEEDING")
    os.environ["ARACHNE_DEVICE_SEEDING"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("ARACHNE_DEVICE_SEEDING", None)
        else:
            os.environ["ARACHNE_DEVICE_SEEDING"] = old


def gapped_records(sam: str) -> int:
    """Records whose CIGAR holds an insertion or a deletion."""
    gapped = 0
    with open(sam) as fh:
        for line in fh:
            if not line.startswith("@") and re.search(r"\d+[ID]", line.split("\t")[5]):
                gapped += 1
    return gapped


def aligned(engine: str, lib: Lib, expect: Optional[dict], trials: int = 1,
            seeding: str = "0") -> dict:
    """``trials`` timed runs of ``align --engine ENGINE --sam -t 2`` on
    ``lib`` (``measure.timed_run``, each checked) under
    ``seeding_env(seeding)``, host seeding by default, each in a temporary
    directory removed after.  Returns the best run (least align-loop
    seconds) with the accuracy report and gapped records of the first,
    every run's pairs/s, the kernels' launches over all runs, and
    ``correct``: the fixture's and every run's shards' digests equal
    ``expect``'s."""
    from .runtime.accuracy import evaluate_sam

    fixture = fixture_sha256(lib)
    before = {k: fn.launches for k, fn in launchers().items()}
    runs, acc, gapped = [], None, None
    for _ in range(trials):
        work = tempfile.mkdtemp(prefix="arachne_bench_")
        try:
            out = os.path.join(work, "out")
            with seeding_env(seeding):
                run = measure.timed_run(engine, out, lib, THREADS, checked=True)
            if acc is None:
                sam = os.path.join(out, "bc_sorted_bam.sam")
                acc, gapped = evaluate_sam(sam), gapped_records(sam)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        runs.append(run)
    launches = {k: fn.launches - before[k] for k, fn in launchers().items()}
    best = min(runs, key=lambda r: r["align_loop_s"])
    correct = (expect is not None and expect["fixture_sha256"] == fixture
               and all(r["shard_sha256"] == expect["output_sha256"] for r in runs))
    return dict(best=best, acc=acc, gapped=gapped, runs=runs, launches=launches,
                fixture=fixture, correct=correct)


def e2e_detail(r: dict, dev: torch.device) -> dict:
    """What every end-to-end line's detail holds."""
    best = r["best"]
    stages = dict(best["stages_s"])
    stages.pop("warmup", None)
    return {
        "pairs": best["pairs"],
        "barcodes": best["barcodes"],
        "elapsed_s": best["align_loop_s"],
        "accuracy_overall": best["accuracy"],
        "stage_seconds": stages,
        "launches": r["launches"],
        "peak_device_bytes": best["peak_device_bytes"],
        "engine": best["engine"],
        "device": card_name(dev),
        "card_after": best["card_after"],
        "fixture_sha256": r["fixture"],
        "output_sha256": best["shard_sha256"],
    }


def repeat_line(engine, dev, lib, expect) -> dict:
    r = aligned(engine, lib, expect)
    return {
        "metric": "repeat_genome_pairs_per_sec",
        "value": r["best"]["pairs_per_s"],
        "unit": "pairs/s/chip",
        "vs_baseline": r["best"]["accuracy"],
        "correct": r["correct"],
        "detail": dict(e2e_detail(r, dev), accuracy_csv=r["acc"].as_csv().splitlines(),
                       fixture="3 Mbp / 10 repeat families x 20 copies @95% id; 150 skewed "
                               "barcodes + one 15k-pair + VX:i:0 every 17th"),
    }


def indel_line(engine, dev, lib, expect) -> dict:
    r = aligned(engine, lib, expect)
    return {
        "metric": "indel_e2e_pairs_per_sec",
        "value": r["best"]["pairs_per_s"],
        "unit": "pairs/s/chip",
        "vs_baseline": r["best"]["accuracy"],
        "correct": r["correct"],
        "detail": dict(e2e_detail(r, dev), gapped_records=r["gapped"],
                       fixture="2 Mbp genome, 19200 pairs, indel_rate 0.1 (kernels K3 z and "
                               "K4: the traceback path)"),
    }


def calibration_line(engine, dev, lib, expect) -> dict:
    r = aligned(engine, lib, expect)
    acc = r["acc"]
    return {
        "metric": "mapq_expected_calibration_error",
        "value": acc.expected_calibration_error(),
        "unit": "|empirical-claimed| err, record-weighted",
        "vs_baseline": r["best"]["accuracy"],
        "correct": r["correct"],
        "detail": dict(e2e_detail(r, dev), pairs_per_sec=r["best"]["pairs_per_s"],
                       calibration=acc.calibration_rows(),
                       fixture="3 Mbp, 8x15x2kb repeats @99.9% id; 1% subs + 10% indel reads "
                               "+ varied quals; 120 skewed barcodes"),
    }


def device_seeded_line(engine, dev, lib, expect) -> dict:
    r = aligned(engine, lib, expect, seeding="1")
    return {
        "metric": "end_to_end_device_seeded_pairs_per_sec",
        "value": r["best"]["pairs_per_s"],
        "unit": "pairs/s/chip",
        "vs_baseline": None,
        "correct": r["correct"],
        "detail": dict(e2e_detail(r, dev),
                       fixture="the headline's; ARACHNE_DEVICE_SEEDING=1 (kernels S1, S3)"),
    }


def headline_line(engine, dev, lib, expect, trials=3) -> dict:
    r = aligned(engine, lib, expect, trials)
    return {
        "metric": "end_to_end_pairs_per_sec",
        "value": r["best"]["pairs_per_s"],
        "unit": "pairs/s/chip",
        "vs_baseline": None,
        "correct": r["correct"],
        "detail": dict(e2e_detail(r, dev),
                       trial_pairs_per_sec=[run["pairs_per_s"] for run in r["runs"]],
                       baseline=None),
    }


# name: (fixture, line); "gcups" needs none
LINES = {
    "gcups": (None, None),
    "repeat": ("repeat", repeat_line),
    "indel": ("indel", indel_line),
    "calibration": ("hard", calibration_line),
    "device_seeded": ("headline", device_seeded_line),
    "headline": ("headline", headline_line),
}


def summarize(lines: Dict[str, dict]) -> None:
    """The headline's detail gathers the other lines, as the reference's
    does (bench.py:541-558), with the device-seeded line beside them and
    whether its shards equal the headline's."""
    d = lines["headline"]["detail"]
    if "gcups" in lines:
        d["kernel_gcups"] = lines["gcups"]["value"]
    if "repeat" in lines:
        rep = lines["repeat"]
        d["repeat_genome"] = {"pairs_per_sec": rep["value"],
                              "accuracy": rep["detail"]["accuracy_overall"]}
    if "indel" in lines:
        ind = lines["indel"]
        d["indel_e2e"] = {"pairs_per_sec": ind["value"],
                          "accuracy": ind["detail"]["accuracy_overall"],
                          "gapped_records": ind["detail"]["gapped_records"]}
    if "calibration" in lines:
        cal = lines["calibration"]
        d["mapq_calibration"] = {"expected_calibration_error": cal["value"],
                                 "accuracy": cal["detail"]["accuracy_overall"]}
    if "device_seeded" in lines:
        dsd = lines["device_seeded"]
        d["end_to_end_device_seeded"] = {
            "pairs_per_sec": dsd["value"],
            "shards_equal_headline": dsd["detail"]["output_sha256"] == d["output_sha256"]}


def main(argv=None, engine: str = "cuda") -> Dict[str, dict]:
    ap = argparse.ArgumentParser(prog="python -m arachne_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=list(LINES), metavar="LINE",
                    help=f"run only these lines, of {', '.join(LINES)}")
    ap.add_argument("--trials", type=int, default=3, help="the headline's runs (best taken)")
    ap.add_argument("--cache", default=os.path.join(ROOT, "build", "bench_cache"),
                    help="where the fixtures and their indexes are kept")
    args = ap.parse_args(argv)
    if args.trials < 1:
        ap.error("--trials must be at least 1")
    if engine not in ("cuda", "torch-cpu"):
        raise ValueError(f"engine {engine!r}: expected 'cuda' or 'torch-cpu'")
    names = [n for n in LINES if args.only is None or n in args.only]
    dev = resolve_device("cuda" if engine == "cuda" else "cpu")
    if "gcups" in names and dev.type != "cuda":
        raise ValueError("the GCUPS line times kernel K1 on the card: engine 'cuda' only")
    reference = load_reference()
    os.makedirs(args.cache, exist_ok=True)
    from .ops.engine import warmup

    t0 = time.perf_counter()
    warmup(dev)
    warm_s = time.perf_counter() - t0
    lines: Dict[str, dict] = {}
    for name in names:
        fixture, line = LINES[name]
        if line is None:
            lines[name] = gcups_line(dev)
        else:
            lib = FIXTURES[fixture](args.cache)
            extra = {"trials": args.trials} if name == "headline" else {}
            lines[name] = line(engine, dev, lib, reference.get(fixture), **extra)
        if name == "headline":
            lines[name]["detail"]["warmup_s_excluded"] = warm_s
            summarize(lines)
        print(json.dumps(lines[name]), flush=True)
    wrong = [line["metric"] for line in lines.values() if not line["correct"]]
    if wrong:
        print(f"bench: not correct: {', '.join(wrong)}", file=sys.stderr)
        sys.exit(1)
    return lines


if __name__ == "__main__":
    main()
