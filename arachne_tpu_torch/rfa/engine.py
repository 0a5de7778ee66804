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

from ..align.cigar import FlatAlns, reg2aln
from ..config import ArachneConfig
from ..index.fmindex import FMIndex
from .batch import run_superbatch
from .candidates import ChainedHit, FastQRecordView, chain_codes, get_alignments, get_chains
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
WORK_COUNTS = ("seeds", "chains", "hits", "rescue_attempts", "rescue_placed", "candidates")


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
    """DoRFAForOneBarcode (aligner.go:440-501): a superbatch of one
    barcode.  With a TorchEngine as ``extender`` the batched device path,
    else the scalar per-pair path and the scalar ``reg2aln``."""
    engine = None
    if extender is not None and hasattr(extender, "align_pairs"):
        engine = extender  # a TorchEngine: full batched path
        extender = None
    chains, barcode = get_chains(idx, cfg, reads, extender=extender, engine=engine)
    jobs = hit_jobs([chains])
    if engine is not None:
        alns = engine.reg2aln_flat(jobs)
    else:
        mat = cfg.mem.scoring_matrix()
        alns = FlatAlns.of([reg2aln(idx, cfg.mem, q, reg, mat) for q, reg in jobs])
    return finish_barcodes(
        idx, cfg, [(reads, unique_barcode)], [(chains, barcode)], alns, centromeres
    )[0]


def hit_jobs(chain_sets: List[List[List[ChainedHit]]]):
    """(read codes, region) of every hit with a region, in chain order
    across the barcodes: reg2aln's jobs."""
    return [(chain_codes(ch), ch.easy.reg)
            for chains in chain_sets for lst in chains for ch in lst if ch.easy is not None]


def finish_barcodes(
    idx: FMIndex,
    cfg: ArachneConfig,
    barcode_sets: List[Tuple[List[FastQRecordView], bool]],
    chain_sets: List[Tuple[List[List[ChainedHit]], str]],
    alns: FlatAlns,
    centromeres: Optional[Dict[str, Region]] = None,
    native_stage: Optional[str] = None,
) -> List[BarcodeResult]:
    """GetAlignments and the tail of DoRFAForOneBarcode for many barcodes:
    the candidates, tags, molecules, optimizer and MAPQ in one native call
    (rfa/batch.py, timed as the TIMERS stage ``native_stage``), then each
    barcode's ``_finish_barcode``.  ``alns`` is reg2aln's record of each
    of ``hit_jobs``' jobs."""
    centromeres = centromeres or {}
    run_rfa = [worth_running_rfa(reads, unique, cfg) for reads, unique in barcode_sets]
    finished = run_superbatch(
        idx, cfg, [reads for reads, _ in barcode_sets], [chains for chains, _ in chain_sets],
        alns, run_rfa, centromeres, native_stage,
    )
    return [
        _finish_barcode(cfg, reads, unique, barcode, rfa, done, centromeres)
        for (reads, unique), (_, barcode), rfa, done in zip(
            barcode_sets, chain_sets, run_rfa, finished)
    ]


def _finish_barcode(
    cfg: ArachneConfig,
    reads: List[FastQRecordView],
    unique_barcode: bool,
    barcode: str,
    ran_rfa: bool,
    finished,
    centromeres: Dict[str, Region],
) -> BarcodeResult:
    """Duplicate marking and split reads on one barcode of
    ``run_superbatch``'s output, and its result for the writer."""
    alignments, split_reads, n_molecules = finished
    mark_duplicates(alignments)
    check_split_reads(split_reads, centromeres, cfg.rfa.improper_pair_penalty)
    return BarcodeResult(
        alignments=alignments, reads=reads, attach_bx=True if ran_rfa else unique_barcode,
        barcode=barcode, ran_rfa=ran_rfa, n_molecules=n_molecules,
    )


def finish_barcode_python(
    idx: FMIndex,
    cfg: ArachneConfig,
    reads: List[FastQRecordView],
    unique_barcode: bool,
    alignments,
    stashed,
    barcode: str,
    centromeres: Optional[Dict[str, Region]] = None,
) -> BarcodeResult:
    """The RFA/MAPQ/dup/split tail of DoRFAForOneBarcode in Python, over
    ``get_alignments``' lists: the reference ``finish_barcodes`` is held to
    (tests/test_torch_rfa_native.py)."""
    centromeres = centromeres or {}
    improper = cfg.rfa.improper_pair_penalty
    run_rfa = worth_running_rfa(reads, unique_barcode, cfg)

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
    placed a region, and alignments entering the RFA tail (``candidates``).
    """
    from ..align.pipeline import seq_to_codes
    from ..runtime.timers import TIMERS

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
        jobs = hit_jobs([chains for chains, _ in chain_sets])
        with TIMERS.stage("cigar"):
            alns = engine.reg2aln_flat(jobs)

        with TIMERS.stage("rfa.host"):
            results = finish_barcodes(idx, cfg, barcode_sets, chain_sets, alns, centromeres,
                                      native_stage="rfa.native")
        TIMERS.add_to("superbatch", hits=len(jobs),
                      candidates=sum(len(a) for r in results for a in r.alignments))
        return results
