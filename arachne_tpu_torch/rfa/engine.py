# Copy of arachne_tpu/rfa/engine.py, the JAX package's host code.
"""Per-barcode RFA engine: the DoRFAForOneBarcode workflow.

Mirrors aligner.go:440-501: candidate generation -> best tagging ->
[RFA: molecule inference -> greedy optimization -> molecule MAPQ] ->
duplicate marking -> split reads.  Returns the per-read alignment lists
ready for BAM emission.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..config import ArachneConfig
from ..index.fmindex import FMIndex
from .candidates import FastQRecordView, get_alignments, get_chains
from .dupmark import mark_duplicates
from .mapq import estimate_map_qualities
from .molecules import (
    infer_molecules,
    mark_best_alignment_for_read_in_molecule,
    scrap_molecules,
    set_molecule_differences,
    tag_best_alignments,
)
from .optimizer import Optimizer, optimize
from .split import check_split_reads
from .types import Alignment, Region


# the work counts a traced ``superbatch`` span carries (process_barcodes)
WORK_COUNTS = ("seeds", "chains", "hits", "rescue_attempts", "rescue_placed", "candidates",
               "hits_native")


def worth_running_rfa(
    reads: List[FastQRecordView], unique_barcode: bool, cfg: ArachneConfig
) -> bool:
    """worthRunningRFA (aligner.go:1018-1030).  The reference additionally
    requires a '-' in the barcode (a 10x GEM-group suffix convention) which
    silently disables RFA for haplotagging/stLFR/TELLseq inputs
    (SURVEY.md 2.4); we gate on that only when configured for strict
    parity."""
    if not reads or not unique_barcode:
        return False
    if cfg.rfa.require_dash_in_barcode:
        bc = reads[0].barcode
        bc = bc.decode() if isinstance(bc, bytes) else bc
        if len(bc.split("-")) < 2:
            return False
    if len(reads) < cfg.rfa.rfa_min_read_pairs:
        return False
    return True


@dataclass
class BarcodeResult:
    """Output of one barcode's processing, ready for the BAM writer."""

    alignments: List[List[Alignment]]
    reads: List[FastQRecordView]
    attach_bx: bool
    barcode: str = ""
    ran_rfa: bool = False
    n_molecules: int = 0


def do_rfa_for_one_barcode(
    idx: FMIndex,
    cfg: ArachneConfig,
    reads: List[FastQRecordView],
    unique_barcode: bool,
    centromeres: Optional[Dict[str, Region]] = None,
    extender=None,
) -> BarcodeResult:
    """DoRFAForOneBarcode (aligner.go:440-501)."""
    engine = None
    if extender is not None and hasattr(extender, "align_pairs"):
        engine = extender  # a TpuEngine: full batched path
        extender = None
    barcode_chains, barcode = get_chains(
        idx, cfg, reads, extender=extender, engine=engine
    )
    alignments, stashed = get_alignments(idx, cfg, barcode_chains, engine=engine)
    return _finish_barcode(
        idx, cfg, reads, unique_barcode, alignments, stashed, barcode, centromeres
    )


def _finish_barcode(
    idx: FMIndex,
    cfg: ArachneConfig,
    reads: List[FastQRecordView],
    unique_barcode: bool,
    alignments,
    stashed,
    barcode: str,
    centromeres: Optional[Dict[str, Region]] = None,
) -> BarcodeResult:
    """The RFA/MAPQ/dup/split tail of DoRFAForOneBarcode."""
    centromeres = centromeres or {}
    improper = cfg.rfa.improper_pair_penalty
    run_rfa = worth_running_rfa(reads, unique_barcode, cfg)

    # native C++ tail (tag -> molecules -> optimize -> mapq) when available:
    # field-identical to the Python tail below (tests/test_rfa_native_tail.py
    # + e2e byte-identity); the Python implementation stays authoritative
    from .native_tail import native_rfa_enabled, run_native_tail

    if native_rfa_enabled():
        n_mol = run_native_tail(alignments, run_rfa, cfg, centromeres)
        if n_mol is not None:
            mark_duplicates(alignments)
            check_split_reads(stashed, centromeres, improper)
            return BarcodeResult(
                alignments=alignments,
                reads=reads,
                attach_bx=unique_barcode if not run_rfa else True,
                barcode=barcode,
                ran_rfa=run_rfa,
                n_molecules=n_mol,
            )

    positions = tag_best_alignments(alignments, improper)

    if not run_rfa:
        estimate_map_qualities(
            alignments, None, improper, centromeres, cfg.rfa.reference_length
        )
        mark_duplicates(alignments)
        check_split_reads(stashed, centromeres, improper)
        return BarcodeResult(
            alignments=alignments,
            reads=reads,
            attach_bx=unique_barcode,
            barcode=barcode,
            ran_rfa=False,
        )

    molecules = infer_molecules(positions)
    mark_best_alignment_for_read_in_molecule(molecules, improper)
    molecules = scrap_molecules(molecules)
    set_molecule_differences(molecules, False)
    model = Optimizer(
        candidate_molecules=molecules,
        alignments=alignments,
        log_unpaired_probability=improper,
        barcode=barcode,
    )
    model = optimize(
        model,
        cfg.rfa.anneal_start_temp,
        cfg.rfa.anneal_temp_steps,
        cfg.rfa.anneal_steps_per_temp_factor * len(molecules),
    )
    estimate_map_qualities(
        model.alignments, model.candidate_molecules, improper, centromeres,
        cfg.rfa.reference_length,
    )
    mark_duplicates(alignments)
    check_split_reads(stashed, centromeres, improper)
    return BarcodeResult(
        alignments=model.alignments,
        reads=reads,
        attach_bx=True,
        barcode=barcode,
        ran_rfa=True,
        n_molecules=len(molecules),
    )


def process_barcodes(
    idx: FMIndex,
    cfg: ArachneConfig,
    barcode_sets: List[Tuple[List[FastQRecordView], bool]],
    engine,
    centromeres: Optional[Dict[str, Region]] = None,
) -> List[BarcodeResult]:
    """Superbatch scheduler: run the device phases for MANY barcodes at
    once (one set of extension/rescue/CIGAR batches), then finish each
    barcode's RFA on the host.  Amortizes device round trips across
    barcodes; per-barcode output is identical to do_rfa_for_one_barcode.
    With the trace on, the call is one ``superbatch`` span, the root of its
    worker's spans (runtime/timers.py), which carries the work that repeats
    multiply as ``WORK_COUNTS``: seed occurrences entering the chainer,
    chains kept, reg2aln jobs (``hits``), rescue SW windows and those that
    placed a region, alignments entering the RFA tail (``candidates``), and
    the hits whose CIGAR stage ran its host side in native code
    (``hits_native``: ``hits``, or 0 without the native library).
    """
    from ..align.pipeline import seq_to_codes
    from ..runtime.timers import TIMERS
    from .candidates import chain_codes

    with TIMERS.span("superbatch", sets=len(barcode_sets),
                     pairs=sum(len(reads) for reads, _ in barcode_sets),
                     **dict.fromkeys(WORK_COUNTS, 0)):
        all_pairs = []
        spans = []
        for reads, _ in barcode_sets:
            start = len(all_pairs)
            for rec in reads:
                all_pairs.append((seq_to_codes(rec.read1), seq_to_codes(rec.read2)))
            spans.append((start, len(all_pairs)))
        pair_results = engine.align_pairs(all_pairs) if all_pairs else []

        chain_sets = []
        with TIMERS.stage("chains.replay"):
            for (reads, unique), (a, b) in zip(barcode_sets, spans):
                chains, bc = get_chains(idx, cfg, reads, pair_results=pair_results[a:b])
                chain_sets.append((chains, bc))

        # one reg2aln batch across every hit of every barcode
        jobs = []
        keys = []
        for chains, _ in chain_sets:
            for lst in chains:
                for ch in lst:
                    if ch.easy is not None:
                        jobs.append((chain_codes(ch), ch.easy.reg))
                        keys.append(id(ch))
        with TIMERS.stage("cigar"):
            mem_cache = dict(zip(keys, engine.reg2aln_batch(jobs))) if jobs else {}

        results = []
        with TIMERS.stage("rfa.host"):
            for (reads, unique), (chains, bc) in zip(barcode_sets, chain_sets):
                alignments, stashed = get_alignments(
                    idx, cfg, chains, mem_cache=mem_cache
                )
                TIMERS.add_to("superbatch", candidates=sum(map(len, alignments)))
                results.append(
                    _finish_barcode(
                        idx, cfg, reads, unique, alignments, stashed, bc, centromeres
                    )
                )
        TIMERS.add_to("superbatch", hits=len(jobs))
        return results
