"""The port at the shape of the scale configurations, on the CPU and small:

  * ``python -m arachne_tpu_torch.scripts.make_scale_genome`` writes the
    reference script's FASTA byte for byte (scripts/make_scale_genome.py);
  * on that genome (two contigs with planted repeat families and N runs),
    indexed with a sampled suffix array, the port's ``align`` with
    ``--engine torch-cpu`` (host-seeded, and with ARACHNE_DEVICE_SEEDING=1)
    and with ``--engine oracle`` writes the shards of the reference's
    ``python -m arachne_tpu.cli align --engine oracle``, each aligner on its
    own package's index;
  * ``measure --reference`` builds the index through the CLI and records
    the build.

Bytes and records: tolerance 0."""

import filecmp
import os
import shutil
import subprocess
import sys

import pytest
import torch

from torch_cli_util import REF_CLI, REPO, cli_env, run_cli

torch.set_num_threads(1)

GENOME_ARGS = ["--contigs", "2", "--contig-len", "300000", "--seed", "7"]
# 4 barcodes x 2 molecules x 12 pairs = 96 pairs, indel reads as the
# main path's library has them
SIM_ARGS = ["--barcodes", "4", "--molecules", "2", "--pairs", "12", "--molecule-len", "40000",
            "--indel-rate", "0.1", "--vary-quals", "--seed", "3"]


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("scale")
    fasta = str(d / "genome.fa")
    subprocess.run([sys.executable, "-m", "arachne_tpu_torch.scripts.make_scale_genome", fasta,
                    *GENOME_ARGS], cwd=REPO, env=cli_env(), check=True, timeout=120,
                   capture_output=True)
    return d, fasta


def test_scale_genome_is_the_reference_scripts(genome):
    d, fasta = genome
    ref_fasta = str(d / "reference_script.fa")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_scale_genome.py"),
                    ref_fasta, *GENOME_ARGS], cwd=REPO, env=cli_env(), check=True, timeout=120,
                   capture_output=True)
    assert filecmp.cmp(fasta, ref_fasta, shallow=False)
    with open(fasta) as fh:
        text = fh.read()
    # two contigs, N runs in each
    assert text.count(">") == 2 and "N" * 10 in text


@pytest.fixture(scope="module")
def aligned(genome, tmp_path_factory):
    """The genome in two directories, one indexed by each package's CLI
    with a sampled suffix array; the reads; the reference's oracle run."""
    _, fasta = genome
    base = tmp_path_factory.mktemp("scale_align")
    refs = {}
    for side, module in (("port", "arachne_tpu_torch.cli"), ("reference", REF_CLI)):
        os.makedirs(base / side)
        refs[side] = str(base / side / "genome.fa")
        shutil.copy(fasta, refs[side])
        run_cli(["index", "--sa-mode", "sampled", refs[side]], module=module)
    r1, r2 = str(base / "r1.fq.gz"), str(base / "r2.fq.gz")
    run_cli(["simulate", refs["port"], "--out-r1", r1, "--out-r2", r2, *SIM_ARGS])
    want = str(base / "out_reference_oracle")
    run_cli(["align", "--engine", "oracle", "--sam", "-t", "2", want, refs["reference"], r1, r2],
            module=REF_CLI)
    return base, refs, r1, r2, want


def test_the_index_keeps_a_sampled_suffix_array(aligned):
    import numpy as np

    _, refs, *_ = aligned
    for side in refs:
        with np.load(refs[side] + ".arx.npz") as z:
            assert z["sa"].size == 0 and z["sa_sampled"].size > 0 and int(z["sa_intv"]) == 32
            assert len(z["ann_names"]) == 2 and len(z["amb_offsets"]) >= 2


@pytest.mark.parametrize("engine,device_seeding", [("torch-cpu", "0"), ("torch-cpu", "1"),
                                                   ("oracle", "0")],
                         ids=["torch-cpu", "torch-cpu-device-seeded", "oracle"])
def test_alignment_matches_the_reference_oracle(aligned, engine, device_seeding):
    base, refs, r1, r2, want = aligned
    out = str(base / f"out_{engine}_{device_seeding}")
    run_cli(["align", "--engine", engine, "--sam", "-t", "2", out, refs["port"], r1, r2],
            ARACHNE_DEVICE_SEEDING=device_seeding)
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(out)) == names
    assert len(names) >= 3   # a shard per contig that holds reads, and the unmapped one
    for f in names:
        assert filecmp.cmp(os.path.join(out, f), os.path.join(want, f), shallow=False), f


def test_measure_reference_records_the_build(genome, tmp_path):
    from arachne_tpu_torch import measure

    _, fasta = genome
    ref = str(tmp_path / "genome.fa")
    shutil.copy(fasta, ref)
    tiny = ["--engine", "torch-cpu", "--trials", "1", "--reference", ref, "--barcodes", "2",
            "--molecules", "1", "--pairs", "4", "--molecule-len", "20000", "--indel-rate",
            "0.2", "-t", "1"]
    res = measure.main(tiny + ["--out", str(tmp_path / "m.json")])
    build = res["library"]["index"]
    assert res["library"]["reference"] == ref and res["args"]["indel_rate"] == 0.2
    assert build["built"] and build["build_s"] > 0 and build["peak_rss_bytes"] > 0
    assert build["index_bytes"] == os.path.getsize(ref + ".arx.npz")
    # 1.2e6 rows: a full suffix array, narrow tables, no build-mode line
    # (auto prints one above 1e9 rows)
    assert (build["seq_len"], build["sa_intv"], build["sa_sampled"], build["wide"],
            build["build_mode_line"]) == (1_200_000, 32, False, False, None)
    (trial,) = res["trials"]
    assert trial["pairs"] == res["library"]["pairs"] == 8
    assert trial["evaluated_reads"] == 16 and 0 < trial["accuracy"] <= 1
    assert trial["peak_device_bytes"] is None and "bc_sorted_bam.sam" in trial["shard_sha256"]
    # the index is on disk now: nothing is built, the same bytes come out
    again = measure.main(tiny)
    assert not again["library"]["index"]["built"]
    assert again["library"]["index"]["build_s"] is None
    assert again["trials"][0]["shard_sha256"] == trial["shard_sha256"]
