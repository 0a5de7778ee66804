"""Reads that carry a run of inserted bases against the genome, through the
batched engine (``rfa.engine.process_barcodes`` with ``TorchEngine`` on the
CPU, host-seeded), held byte for byte to the benchmark's reference
(``h100_bench/reference/oracle.barcode_records``, the scalar path).

The reference's ``ksw.global2`` keeps an insertion's continuation at bit 4
of a cell's state, where K3 and its plain version keep it at bit 5 as
ksw.c does, so its walk leaves a run of inserted bases after the first one
and turns to a deletion.  K4 once stayed in the insertion, as ksw.c's walk
does; on the benchmark's half-repeat genome that moved a second-best
placement of a read, and with it the read's XS and XC (``human256m.indel``
on the card).  K4 and its plain version now take the reference's turn.
The genome here is a contig of the benchmark's human composition with a
5-base deletion every 500 bp, so the reads simulated from the contig cross
it with 5-base insertions."""

import os

import numpy as np
import pytest

from h100_bench import bamread, genomes, library
from h100_bench.reference import oracle
from h100_bench.reference.index import fmindex
from h100_bench.reference.io.fastq import iter_barcode_sets as reference_sets
from h100_bench.tests.tiny import small_genome

SITES = range(1_000, 39_000, 500)
THREADS = 2


def program_config():
    """The configuration ``align -t 2`` builds (oracle.align_config's)."""
    from arachne_tpu_torch.config import (ArachneConfig, OutputOptions, PipelineOptions,
                                          RFAOptions)

    return ArachneConfig(
        rfa=RFAOptions(improper_pair_penalty=-4.0),
        output=OutputOptions(position_chunk_size=40_000_000,
                             read_groups="sample:library:molecule:flowcell:lane",
                             sample_id="sample", debug_tags=False, emit_sam=False),
        pipeline=PipelineOptions(engine="torch-cpu", num_workers=THREADS, index_mode="auto"),
        centromeres="", threads=THREADS)


@pytest.fixture(scope="module")
def inserted(tmp_path_factory):
    d = tmp_path_factory.mktemp("insertion_runs")
    donor = genomes.make_genome(small_genome(1, 40_000, 19))[0][1]
    keep = np.ones(len(donor), bool)
    for at in SITES:
        keep[at : at + 5] = False
    ref = str(d / "ref.fa")
    with open(ref, "w") as fh:
        fh.write(">chrI\n" + genomes.BASES[donor[keep]].tobytes().decode() + "\n")
    r1, r2 = str(d / "r1.fq"), str(d / "r2.fq")
    sim = library.SimConfig(n_barcodes=3, molecules_per_barcode=2, pairs_per_molecule=6,
                            molecule_len=15_000, vary_quals=True)
    library.simulate([("chrI", "", genomes.BASES[donor].tobytes().decode())], r1, r2, sim,
                     [23, 0], 0)
    fmindex.build(ref, str(d / "reference"))
    return {"dir": d, "ref": ref, "r1": r1, "r2": r2, "reference": str(d / "reference")}


def test_insertion_runs_give_the_references_records(inserted, monkeypatch):
    from arachne_tpu_torch.cli import load_or_build_index
    from arachne_tpu_torch.io.bam import BAMWriters
    from arachne_tpu_torch.io.fastq import iter_barcode_sets
    from arachne_tpu_torch.ops import sw_global
    from arachne_tpu_torch.ops.engine import TorchEngine
    from arachne_tpu_torch.rfa.engine import process_barcodes

    idx = load_or_build_index(inserted["ref"])
    cfg = program_config()
    sets = list(iter_barcode_sets(inserted["r1"], inserted["r2"]))
    run, turned = sw_global.BatchGlobal.run, []

    def counted(self):
        out = run(self)
        # a turn out of an insertion: a D right before an I (I = 1, D = 2)
        turned.extend(c for _, c in out if any((a[0], b[0]) == (2, 1) for a, b in zip(c, c[1:])))
        return out

    monkeypatch.setattr(sw_global.BatchGlobal, "run", counted)
    results = process_barcodes(idx, cfg, sets, TorchEngine(idx, cfg, "cpu",
                                                           device_seeding=False))
    ref_idx = fmindex.FMIndex(inserted["reference"])
    ref_cfg = oracle.align_config(THREADS)
    for k, ((records, unique), res) in enumerate(zip(reference_sets(inserted["r1"],
                                                                    inserted["r2"]), results)):
        out = str(inserted["dir"] / f"set{k}")
        bams = BAMWriters(idx, out, cfg, version="test")
        bams.dump(res.alignments, res.attach_bx)
        bams.close()
        want = oracle.barcode_records(ref_idx, ref_cfg, records, unique, "test")
        for name in sorted(n for n in os.listdir(out) if n.endswith(".bam")):
            assert bamread.read_bam(os.path.join(out, name))[1] == want.get(name, []), (k, name)
    # the input does what it is for: batched CIGARs that take the
    # reference's turn out of a run of inserted bases
    assert len(turned) >= 3
