"""The RFA-disambiguation study through the port's CLI.

    python -m arachne_tpu_torch.scripts.rfa_study [WORKDIR] [--engine cuda]

The twin of scripts/rfa_study.py: the same two experiments, each aligning
the same reads with and without barcode-joint (RFA) alignment (``align
--sam`` and ``align --sam --no-rfa``) and comparing placements and MAPQ:

  1. ``spaced-repeats``: repeat families of 99.9% identity spaced along a
     4 Mbp genome (``make_repeat_genome``), uniform simulated coverage;
  2. ``decisive``: ``make_rfa_decisive_fixture``, exact copies of a unit
     far apart, interior pairs with no flank evidence, skewed coverage,
     where RFA-off coin-flips the interior pairs at a low MAPQ and RFA-on
     moves them to the anchored molecule's copy.

Each prints the accuracy with RFA on and off and the records RFA moved; the
decisive experiment also the MAPQ range of its interior reads.  WORKDIR
defaults to a new temporary directory; ``--barcodes`` (40) shrinks the
first experiment's library.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def parse_records(path):
    """{(qname, 1 or 2): (pos, mapq)} of a SAM's primary records."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            f = line.rstrip("\n").split("\t")
            flag = int(f[1])
            if flag & 0x100:
                continue
            read = 1 if flag & 0x40 else 2
            out[(f[0], read)] = (int(f[3]), int(f[4]))
    return out


def accuracy(recs):
    """Share of records within 20 bases of their simulated position."""
    ok = tot = 0
    for (qname, read), (pos, _mapq) in recs.items():
        parts = qname.rsplit("_", 3)
        t1, t2 = int(parts[1]), int(parts[2])
        want = t1 if read == 1 else t2 - 149
        tot += 1
        ok += abs(pos - want) <= 20
    return ok / max(1, tot), tot


def run_pair(tag, workdir, fasta, r1, r2, engine):
    from ..cli import main as cli_main
    from ..measure import quiet

    on, off = os.path.join(workdir, f"{tag}_on"), os.path.join(workdir, f"{tag}_off")
    with quiet(on + ".log"):
        cli_main(["align", "--sam", "--engine", engine, on, fasta, r1, r2])
    with quiet(off + ".log"):
        cli_main(["align", "--sam", "--engine", engine, "--no-rfa", off, fasta, r1, r2])
    recs_on = parse_records(os.path.join(on, "bc_sorted_bam.sam"))
    recs_off = parse_records(os.path.join(off, "bc_sorted_bam.sam"))
    moved = [k for k in recs_on if k in recs_off and recs_on[k][0] != recs_off[k][0]]
    acc_on, tot = accuracy(recs_on)
    acc_off, _ = accuracy(recs_off)
    print(f"[{tag}] reads={tot}  accuracy RFA-on={acc_on:.4f}  RFA-off={acc_off:.4f}  "
          f"records moved by RFA={len(moved)}", flush=True)
    return {"reads": tot, "accuracy_on": acc_on, "accuracy_off": acc_off,
            "moved": len(moved), "records_on": recs_on, "records_off": recs_off}


def spaced_repeats(workdir, engine, barcodes=40):
    from ..io.simulate import SimConfig, make_repeat_genome, simulate_linked_reads

    fasta = os.path.join(workdir, "spaced.fa")
    genome = make_repeat_genome(4_000_000, n_families=5, copies=8, unit_len=2500,
                                identity=0.999, seed=12)
    with open(fasta, "w") as fh:
        fh.write(">chrT\n")
        for i in range(0, len(genome), 70):
            fh.write(genome[i : i + 70] + "\n")
    r1 = os.path.join(workdir, "spaced.R1.fq.gz")
    r2 = os.path.join(workdir, "spaced.R2.fq.gz")
    simulate_linked_reads(
        [("chrT", "", genome)], r1, r2,
        SimConfig(n_barcodes=barcodes, molecules_per_barcode=3, molecule_len=30_000,
                  pairs_per_molecule=14, seed=9),
    )
    return run_pair("spaced-repeats", workdir, fasta, r1, r2, engine)


def decisive(workdir, engine):
    from ..io.simulate import make_rfa_decisive_fixture

    fasta = os.path.join(workdir, "decisive.fa")
    r1 = os.path.join(workdir, "decisive.R1.fq.gz")
    r2 = os.path.join(workdir, "decisive.R2.fq.gz")
    geom = make_rfa_decisive_fixture(fasta, r1, r2)
    res = run_pair("decisive", workdir, fasta, r1, r2, engine)
    a0, a1 = geom["pos_a"], geom["pos_a"] + geom["unit_len"]

    def interior(qname):
        p = qname.rsplit("_", 3)
        return int(p[1]) - 1 >= a0 and int(p[2]) <= a1

    inside = [k for k in res["records_on"] if interior(k[0])]
    mq_on = sorted(res["records_on"][k][1] for k in inside)
    mq_off = sorted(res["records_off"][k][1] for k in inside)
    print(f"[decisive] interior reads: {len(inside)}  "
          f"mapq RFA-on min/max={mq_on[0]}/{mq_on[-1]}  "
          f"RFA-off min/max={mq_off[0]}/{mq_off[-1]}", flush=True)
    res.update(interior_reads=len(inside), interior_mapq_on=mq_on, interior_mapq_off=mq_off)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m arachne_tpu_torch.scripts.rfa_study",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?")
    ap.add_argument("--engine", choices=["cuda", "torch-cpu", "oracle"], default="cuda")
    ap.add_argument("--barcodes", type=int, default=40,
                    help="barcodes of the spaced-repeat library")
    args = ap.parse_args(argv)
    workdir = args.workdir or tempfile.mkdtemp(prefix="rfa_study_")
    os.makedirs(workdir, exist_ok=True)
    return {"spaced-repeats": spaced_repeats(workdir, args.engine, args.barcodes),
            "decisive": decisive(workdir, args.engine)}


if __name__ == "__main__":
    main()
