"""The port's align command end to end on the CPU: on the indel fixture of
tests/test_indel_e2e.py, ``arachne_tpu_torch.cli align --engine torch-cpu``
(TorchEngine with the kernels' plain PyTorch versions) must write SAM
shards byte-identical to the reference's ``arachne_tpu.cli align --engine
oracle``, and the gapped traceback path must fire."""

import filecmp
import os

import numpy as np
import pytest
import torch

from arachne_tpu.cli import main as reference_main
from arachne_tpu.io.simulate import SimConfig, simulate_linked_reads
from arachne_tpu_torch.cli import main as port_main
from arachne_tpu_torch.ops import sw_global

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    rng = np.random.default_rng(7)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 80_000)])
    tmp = tmp_path_factory.mktemp("torch_indel")
    fasta = str(tmp / "indel.fa")
    with open(fasta, "w") as fh:
        fh.write(">chrI\n")
        for i in range(0, len(genome), 60):
            fh.write(genome[i : i + 60] + "\n")
    r1 = str(tmp / "i.R1.fq.gz")
    r2 = str(tmp / "i.R2.fq.gz")
    n = simulate_linked_reads(
        [("chrI", "", genome)], r1, r2,
        SimConfig(n_barcodes=6, molecules_per_barcode=2, molecule_len=9000,
                  pairs_per_molecule=10, indel_rate=0.35, vary_quals=True, seed=21),
    )
    out = str(tmp / "oracle")
    reference_main(["align", "--sam", "--engine", "oracle", out, fasta, r1, r2])
    return tmp, fasta, r1, r2, n, out


def test_torch_cpu_engine_byte_identical_to_oracle(sim):
    tmp, fasta, r1, r2, n, oracle_out = sim
    out = str(tmp / "torch_cpu")
    before = sw_global.traceback_fetches
    stats = port_main(["align", "--sam", "--engine", "torch-cpu", "-t", "2", out, fasta, r1, r2])
    assert stats.reads == n
    assert sw_global.traceback_fetches > before, (
        "the gapped fixture must exercise the direction-byte traceback path"
    )
    names = sorted(os.listdir(oracle_out))
    assert sorted(os.listdir(out)) == names and "bc_sorted_bam.sam" in names
    for f in names:
        assert filecmp.cmp(os.path.join(oracle_out, f), os.path.join(out, f), shallow=False), f


def test_port_oracle_engine_byte_identical_to_reference(sim):
    tmp, fasta, r1, r2, n, oracle_out = sim
    out = str(tmp / "port_oracle")
    port_main(["align", "--sam", "--engine", "oracle", out, fasta, r1, r2])
    for f in sorted(os.listdir(oracle_out)):
        assert filecmp.cmp(os.path.join(oracle_out, f), os.path.join(out, f), shallow=False), f


def test_host_subcommands(sim, capsys):
    tmp, fasta, r1, r2, n, oracle_out = sim
    port_main(["evaluate", os.path.join(oracle_out, "bc_sorted_bam.sam")])
    table = capsys.readouterr().out
    assert table.startswith("mapq_bucket,total,correct,accuracy")
    all_row = [ln for ln in table.splitlines() if ln.startswith("all,")][0]
    assert float(all_row.split(",")[3]) >= 0.99
    s1, s2 = str(tmp / "s.R1.fq.gz"), str(tmp / "s.R2.fq.gz")
    port_main(["simulate", fasta, "--out-r1", s1, "--out-r2", s2, "--barcodes", "2",
               "--molecules", "1", "--pairs", "3", "--seed", "4"])
    assert "Simulated 6 read pairs" in capsys.readouterr().out
    small = tmp / "small.fa"
    small.write_text(">c\n" + "ACGTTGCAAGGCTTAC" * 40 + "\n")
    port_main(["index", str(small)])
    assert os.path.exists(str(small) + ".arx.npz")


@pytest.fixture(scope="module")
def small_sim(tmp_path_factory):
    """2 barcodes x 2 molecules x 5 pairs on a 40 kbp genome, with the
    reference's oracle output."""
    rng = np.random.default_rng(9)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40_000)])
    tmp = tmp_path_factory.mktemp("torch_devseed")
    fasta = str(tmp / "small.fa")
    with open(fasta, "w") as fh:
        fh.write(">chrS\n" + genome + "\n")
    r1, r2 = str(tmp / "s.R1.fq.gz"), str(tmp / "s.R2.fq.gz")
    n = simulate_linked_reads(
        [("chrS", "", genome)], r1, r2,
        SimConfig(n_barcodes=2, molecules_per_barcode=2, molecule_len=8000,
                  pairs_per_molecule=5, indel_rate=0.2, vary_quals=True, seed=10),
    )
    out = str(tmp / "oracle")
    reference_main(["align", "--sam", "--engine", "oracle", out, fasta, r1, r2])
    return tmp, fasta, r1, r2, n, out


def test_device_seeded_torch_cpu_byte_identical_to_oracle(small_sim, monkeypatch):
    """ARACHNE_DEVICE_SEEDING=1 sends seeding through collect_seeds_device
    (the plain S1 / S3 on the CPU); the shards stay the oracle's."""
    from arachne_tpu.runtime.timers import TIMERS

    tmp, fasta, r1, r2, n, oracle_out = small_sim
    out = str(tmp / "torch_cpu_devseed")
    monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "1")
    TIMERS.reset()
    stats = port_main(["align", "--sam", "--engine", "torch-cpu", "-t", "1", out, fasta, r1, r2])
    stages = TIMERS.as_dict()
    assert stats.reads == n == 20
    assert stages["seed.device"]["calls"] > 0 and "seed.host" not in stages
    names = sorted(os.listdir(oracle_out))
    assert sorted(os.listdir(out)) == names
    for f in names:
        assert filecmp.cmp(os.path.join(oracle_out, f), os.path.join(out, f), shallow=False), f
