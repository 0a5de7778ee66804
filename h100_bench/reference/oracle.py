"""The reference aligner, barcode by barcode: the scalar host engine of
the program's ``--engine oracle`` path, frozen into this directory (each
copied file names its source), over the reference's own index.  For one
barcode set it gives every BAM record the program's writer should have
written, by shard.

It imports nothing of the program and loads no native library: the
program's native RFA tail, CIGAR walk, seeding and chaining are left out,
and their Python originals, which the program's tests hold them to, run
in their place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .config import ArachneConfig, OutputOptions, PipelineOptions, RFAOptions
from .index.fmindex import FMIndex
from .io.bam import BAMWriters
from .align.pipeline import align_pair_with_rescue, seq_to_codes
from .io.fastq import iter_barcode_sets
from .rfa.candidates import get_alignments, get_chains
from .rfa.engine import _finish_barcode


def align_config(threads: int) -> ArachneConfig:
    """The configuration ``align`` builds from its defaults (the program's
    cli.run_align) for ``-t threads``, BAM output."""
    return ArachneConfig(
        rfa=RFAOptions(improper_pair_penalty=-4.0),
        output=OutputOptions(
            position_chunk_size=40_000_000,
            read_groups="sample:library:molecule:flowcell:lane",
            sample_id="sample",
            debug_tags=False,
            emit_sam=False,
        ),
        pipeline=PipelineOptions(engine="cuda", num_workers=max(1, threads), index_mode="auto"),
        centromeres="",
        threads=threads,
    )


def align_pairs(idx: FMIndex, cfg: ArachneConfig, records) -> list:
    """Each pair's candidate alignments with mate rescue, as GetChains
    makes them (rfa/candidates.get_chains' scalar path)."""
    mat = cfg.mem.scoring_matrix()
    return [
        align_pair_with_rescue(
            idx, cfg.mem, cfg.pes, seq_to_codes(rec.read1), seq_to_codes(rec.read2),
            score_delta=cfg.rfa.chain_score_delta, extender=None, mat=mat,
        )
        for rec in records
    ]


def barcode_records(idx: FMIndex, cfg: ArachneConfig, records, unique: bool, version: str,
                    pair_results=None) -> Dict[str, List[bytes]]:
    """{shard file name: the barcode set's records in that shard, in
    order} as the program's writer would write them (DoRFAForOneBarcode,
    then DoDumpToBam); ``pair_results``: ``align_pairs`` of the set, if
    made already."""
    if pair_results is None:
        pair_results = align_pairs(idx, cfg, records)
    chains, barcode = get_chains(idx, cfg, records, pair_results=pair_results)
    alignments, stashed = get_alignments(idx, cfg, chains)
    res = _finish_barcode(idx, cfg, records, unique, alignments, stashed, barcode, {})
    out = BAMWriters(idx, cfg, version=version)
    out.dump(res.alignments, res.attach_bx)
    return {name: w.records for name, w in out.files.items() if w.records}


def shard_headers(idx: FMIndex, cfg: ArachneConfig, version: str) -> Dict[str, bytes]:
    """{shard file name: its BAM header}."""
    return {name: w.header for name, w in BAMWriters(idx, cfg, version=version).files.items()}


def read_sets(r1: str, r2: str, wanted: Optional[Sequence[int]] = None
              ) -> Dict[int, Tuple[list, bool]]:
    """The barcode sets numbered ``wanted`` (0-based, in file order; all
    if None) of a library, with the reference's own copy of the FASTQ
    reader."""
    want = None if wanted is None else set(wanted)
    out = {}
    for i, (records, unique) in enumerate(iter_barcode_sets(r1, r2)):
        if want is None or i in want:
            out[i] = (records, unique)
            if want is not None and len(out) == len(want):
                break
    return out


_WORKER = {}


def _init(index_dir: str, threads: int, version: str, control: bool) -> None:
    from . import prec

    prec.LOWER = control
    _WORKER.update(idx=FMIndex(index_dir), cfg=align_config(threads), version=version)


def _task(task):
    """("pairs", key, records) -> ("pairs", key, align_pairs);
    ("set", key, records, unique, pair_results) -> ("set", key, records by shard)."""
    w = _WORKER
    if task[0] == "pairs":
        return "pairs", task[1], align_pairs(w["idx"], w["cfg"], task[2])
    _, key, records, unique, pair_results = task
    return "set", key, barcode_records(w["idx"], w["cfg"], records, unique, w["version"],
                                       pair_results)


def run_sets(index_dir: str, threads: int, version: str, sets, processes: int,
             control: bool = False, chunk: int = 200):
    """{key: records by shard} for ``sets`` {key: (records, unique)}, in
    ``processes`` spawned worker processes, all ended on return.  A set of
    more than ``chunk`` pairs has its pairs aligned in chunks across the
    workers first, then its RFA tail in one."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = {}
    parts = {}
    with ctx.Pool(processes, initializer=_init,
                  initargs=(index_dir, threads, version, control)) as pool:
        pending = []
        for key, (records, unique) in sorted(sets.items(), key=lambda kv: -len(kv[1][0])):
            if len(records) <= chunk:
                pending.append(pool.apply_async(_task, (("set", key, records, unique, None),)))
                continue
            n = -(-len(records) // chunk)
            parts[key] = [None] * n
            for j in range(n):
                pending.append(pool.apply_async(
                    _task, (("pairs", (key, j), records[j * chunk : (j + 1) * chunk]),)))
        while pending:
            kind, key, value = pending.pop(0).get()
            if kind == "set":
                out[key] = value
                continue
            key, j = key
            parts[key][j] = value
            if all(p is not None for p in parts[key]):
                records, unique = sets[key]
                results = [r for p in parts.pop(key) for r in p]
                pending.append(pool.apply_async(
                    _task, (("set", key, records, unique, results),)))
        pool.close()
        pool.join()
    return out
