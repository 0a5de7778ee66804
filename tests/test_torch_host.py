"""The port's copies of the JAX package's host modules against the
originals, on the CPU: from one numpy seed, index building and loading,
native seeding and chaining, the read simulator and the SAM evaluator give
the same arrays, fields and bytes.  Each side runs on its own package's
objects; they are compared field by field, since the two packages' classes
are distinct.  Everything is exact: tolerance 0."""

import gzip
import struct
from dataclasses import astuple, fields

import numpy as np
import pytest

from arachne_tpu import config as ref_config
from arachne_tpu import index as ref_index
from arachne_tpu.align import chain_native as ref_chain_native
from arachne_tpu.align import smem_native as ref_smem_native
from arachne_tpu.io import simulate as ref_simulate
from arachne_tpu.runtime import accuracy as ref_accuracy
from arachne_tpu_torch import config, index
from arachne_tpu_torch.align import chain_native, smem_native
from arachne_tpu_torch.io import simulate
from arachne_tpu_torch.runtime import accuracy

SEEDS = [3, 4]
BASES = np.array(list("ACGT"))


@pytest.fixture(scope="module", params=SEEDS, ids=[f"seed{s}" for s in SEEDS])
def genome(request, tmp_path_factory):
    """A 40 kbp genome in two contigs, with a planted repeat and a run of
    N, written as FASTA; both packages' indexes of it, built from that
    file and loaded back."""
    rng = np.random.default_rng(request.param)
    seq = "".join(BASES[rng.integers(0, 4, 40_000)])
    seq = seq[:9000] + seq[2000:4000] + "N" * 40 + seq[11_040:]
    contigs = [("chrA", "", seq[:28_000]), ("chrB", "", seq[28_000:])]
    tmp = tmp_path_factory.mktemp(f"host_seed{request.param}")
    fasta = str(tmp / "g.fa")
    with open(fasta, "w") as fh:
        for name, _, s in contigs:
            fh.write(f">{name}\n")
            for i in range(0, len(s), 70):
                fh.write(s[i : i + 70] + "\n")
    ref_npz = ref_index.build_index_files(fasta, out_prefix=str(tmp / "ref"))
    port_npz = index.build_index_files(fasta, out_prefix=str(tmp / "port"))
    return dict(
        seed=request.param, tmp=tmp, fasta=fasta, contigs=contigs,
        ref=ref_index.load_index(ref_npz), port=index.load_index(port_npz),
    )


def same_arrays(a, b):
    return type(a) is type(b) and (
        np.array_equal(a, b) and a.dtype == b.dtype if isinstance(a, np.ndarray) else a == b
    )


def test_index_files_match(genome):
    (rp, rf), (pp, pf) = genome["ref"], genome["port"]
    assert [f.name for f in fields(rp)] == [f.name for f in fields(pp)]
    for f in ("pac", "l_pac"):
        assert same_arrays(getattr(rp, f), getattr(pp, f)), f
    assert [astuple(a) for a in rp.anns] == [astuple(a) for a in pp.anns]
    assert [astuple(a) for a in rp.ambs] == [astuple(a) for a in pp.ambs] != []
    assert [f.name for f in fields(rf)] == [f.name for f in fields(pf)]
    for f in fields(rf):
        a, b = getattr(rf, f.name), getattr(pf, f.name)
        assert (a is None and b is None) or same_arrays(a, b), f.name
    # and the two parse the FASTA alike
    assert index.parse_fasta(genome["fasta"]) == ref_index.parse_fasta(genome["fasta"])


def sample_reads(genome, n=120):
    """Reads of 150 bp from both strands with substitutions, N bases and
    short indels, some across the planted repeat."""
    rng = np.random.default_rng(genome["seed"] + 100)
    fwd = index.unpack_2bit(genome["port"][0].pac, 0, genome["port"][0].l_pac)
    reads = []
    for i in range(n):
        pos = int(rng.integers(0, len(fwd) - 160)) if i % 6 else int(rng.integers(1500, 4500))
        r = fwd[pos : pos + 152].copy()
        r[rng.integers(0, len(r), int(rng.integers(0, 6)))] = rng.integers(0, 4)
        if i % 7 == 0:
            r[int(rng.integers(0, len(r)))] = 4
        if i % 5 == 0:
            at = int(rng.integers(20, 130))
            r = np.concatenate([r[:at], r[at + 2 :]])
        r = r[:150]
        reads.append((3 - r[::-1]).astype(np.uint8) if rng.integers(0, 2) else r)
    return reads


def chain_fields(c):
    win = None if c.win_seq is None else c.win_seq.tolist()
    return (c.pos, c.rid, [astuple(s) for s in c.seeds], c.w, c.kept, c.first, c.is_alt,
            c.frac_rep, win, c.win_rmax0)


def test_native_seeds_and_chains_match(genome):
    assert smem_native.smem_available() and ref_smem_native.smem_available()
    ref_idx, port_idx = ref_index.FMIndex(*genome["ref"]), index.FMIndex(*genome["port"])
    ref_opt, opt = ref_config.MemOptions(), config.MemOptions()
    reads = sample_reads(genome)
    ref_mems = ref_smem_native.collect_seeds_native(ref_idx, reads, ref_opt)
    mems = smem_native.collect_seeds_native(port_idx, reads, opt)
    assert [[astuple(m) for m in ms] for ms in mems] == [[astuple(m) for m in ms] for ms in ref_mems]
    assert sum(map(len, mems)) > len(reads)
    ref_chains = ref_chain_native.mem_chain_batch_native(ref_idx, reads, ref_opt, ref_mems)
    chains = chain_native.mem_chain_batch_native(port_idx, reads, opt, mems)
    assert chains is not None and ref_chains is not None
    assert [[chain_fields(c) for c in cs] for cs in chains] == [
        [chain_fields(c) for c in cs] for cs in ref_chains]
    assert sum(map(len, chains)) >= len(reads)


SIM_CASES = {
    "plain": dict(n_barcodes=4, molecules_per_barcode=2, molecule_len=6000, pairs_per_molecule=5),
    "indels": dict(n_barcodes=3, molecules_per_barcode=3, molecule_len=5000,
                   pairs_per_molecule=4, indel_rate=0.3, vary_quals=True),
    "skewed": dict(n_barcodes=4, pair_counts=[1, 9, 3, 12], invalid_every=2,
                   molecule_len=8000, pairs_per_molecule=4, error_rate=0.01),
}


def simulated(genome, case, name, mod, tmp):
    r1, r2 = str(tmp / f"{name}.{case}.R1.fq.gz"), str(tmp / f"{name}.{case}.R2.fq.gz")
    n = mod.simulate_linked_reads(genome["contigs"], r1, r2,
                                  mod.SimConfig(seed=genome["seed"], **SIM_CASES[case]))
    texts = []
    for path in (r1, r2):
        with gzip.open(path, "rb") as fh:
            texts.append(fh.read())
    return n, texts


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulated_fastq_bytes_match(genome, case, tmp_path):
    n, texts = simulated(genome, case, "port", simulate, tmp_path)
    ref_n, ref_texts = simulated(genome, case, "ref", ref_simulate, tmp_path)
    assert n == ref_n > 0
    assert texts == ref_texts


def synthetic_sam(genome, path):
    """A SAM of the simulated pairs' names, placed at their truth, near it
    or elsewhere, with a spread of MAPQs and flags."""
    _, (t1, _) = simulated(genome, "plain", "sam", simulate, genome["tmp"])
    names = [ln[1:].split("/")[0] for ln in t1.decode().splitlines()[::4]]
    rng = np.random.default_rng(genome["seed"] + 200)
    lines = ["@HD\tVN:1.6\tSO:coordinate", "@SQ\tSN:chrA\tLN:28000", "@SQ\tSN:chrB\tLN:12000"]
    for name in names:
        contig, p1, p2 = name.split("_")[:3]
        for mate, truth in ((1, int(p1)), (2, int(p2) - 150)):
            flag = int(rng.choice([0, 16, 0x100, 0x800, 0x4, 0]))
            pos = truth + int(rng.choice([0, 3, -15, 25, 4000]))
            chrom = contig if rng.random() < 0.9 else ("chrB" if contig == "chrA" else "chrA")
            cigar = str(rng.choice(["150M", "70M2D80M", "5S145M", "60M3I87M"]))
            lines.append(f"{name}\t{flag | (64 if mate == 1 else 128)}\t{chrom}\t{max(pos, 1)}\t"
                         f"{int(rng.integers(0, 61))}\t{cigar}\t=\t0\t0\t*\t*")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def test_evaluate_sam_matches(genome, tmp_path):
    path = str(tmp_path / "eval.sam")
    synthetic_sam(genome, path)
    got, want = accuracy.evaluate_sam(path), ref_accuracy.evaluate_sam(path)
    assert astuple(got) == astuple(want)
    assert got.as_csv() == want.as_csv()
    assert got.calibration_rows(min_n=5) == want.calibration_rows(min_n=5)
    assert 0 < got.correct < got.total


# ---------------------------------------------------------------------------
# io/merge.py against the reference's (tests/test_rfa.py::TestMergeGenerations)
# ---------------------------------------------------------------------------

def _raw_bam(records: bytes) -> bytes:
    text = b"@HD\tVN:1.6\n@SQ\tSN:c\tLN:100\n"
    name = b"c\x00"
    return (b"BAM\x01" + struct.pack("<i", len(text)) + text + struct.pack("<i", 1)
            + struct.pack("<i", len(name)) + name + struct.pack("<i", 100) + records)


def test_merge_generations_matches_reference(tmp_path):
    import filecmp
    import os
    import shutil

    from arachne_tpu.io.merge import merge_generations as ref_merge
    from arachne_tpu_torch.io.bgzf import BGZFWriter
    from arachne_tpu_torch.io.merge import merge_generations

    src = tmp_path / "src"
    src.mkdir()
    rec = "r{}\t0\tc\t{}\t60\t4M\t*\t0\t0\tACGT\tIIII\n"
    for gen, sfx in ((0, ""), (1, ".gen1"), (3, ".gen3")):
        (src / f"bc_sorted_bam{sfx}.sam").write_text(
            "@HD\tVN:1.6\n" + "".join(rec.format(gen * 10 + i, i + 1) for i in range(3)))
        for shard in ("bc_sorted_bam", "c_0_40000000"):
            with open(src / f"{shard}{sfx}.bam", "wb") as fh:
                w = BGZFWriter(fh)
                w.write(_raw_bam(bytes(range(gen, gen + 40)) * 50))
                w.close()
    (src / "bc_sorted_bam.host001.gen2.sam").write_text("@HD\tVN:1.6\n" + rec.format(99, 5))
    dirs = {}
    for side, fn in (("ref", ref_merge), ("port", merge_generations)):
        dirs[side] = str(tmp_path / side)
        shutil.copytree(src, dirs[side])
        assert fn(dirs[side]) == 4
    names = sorted(os.listdir(dirs["ref"]))
    assert sorted(os.listdir(dirs["port"])) == names == [
        "bc_sorted_bam.bam", "bc_sorted_bam.host001.sam", "bc_sorted_bam.sam", "c_0_40000000.bam"]
    for name in names:
        assert filecmp.cmp(os.path.join(dirs["ref"], name), os.path.join(dirs["port"], name),
                           shallow=False), name
    text = (tmp_path / "port" / "bc_sorted_bam.sam").read_text()
    assert text.count("@HD") == 1 and all(f"r{i}\t" in text for i in (0, 12, 31))


# ---------------------------------------------------------------------------
# faults of the reference's host code, repaired in the port's copies only
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_fm():
    from arachne_tpu_torch.index.build import build_fmindex, codes2_packed, pack_reference

    rng = np.random.default_rng(5)
    packed = pack_reference([("c", "", "".join(BASES[rng.integers(0, 4, 3000)]))])
    fm = build_fmindex(packed, sa_intv=32, keep_full_sa=True)
    pac2, _ = codes2_packed(packed)
    return packed, fm, pac2


def _walk_args(fm):
    return (np.ascontiguousarray(fm.bwt_words, np.uint32), np.ascontiguousarray(fm.occ, np.int64),
            np.ascontiguousarray(fm.L2, np.int64), int(fm.primary), int(fm.seq_len))


def test_sa_sampling_refuses_an_interval_that_is_not_a_power_of_two(small_fm):
    """native/smem.cpp samples by mask and shift: an interval such as 24
    used to write outside the sampled table and return wrong SA values."""
    import ctypes

    from arachne_tpu_torch import native
    from arachne_tpu_torch.index.build import build_fmindex

    packed, fm, pac2 = small_fm
    lib = native.get_lib()
    assert lib is not None
    words, occ, L2, primary, n = args = _walk_args(fm)
    for intv in (24, 0, -8):
        with pytest.raises(ValueError, match="power of two"):
            native.sa_sample_walk_native(*args, intv, pac2=pac2)
    u32p, i64p = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64)
    ptrs = (words.ctypes.data_as(u32p), len(words), occ.ctypes.data_as(i64p),
            L2.ctypes.data_as(i64p), primary, n)
    out = np.zeros(n + 1, np.int64)   # room for any interval's writes
    assert lib.sa_sample_walk(*ptrs, 24, out.ctypes.data_as(i64p)) == -1
    assert lib.sa_sample_walk_par(*ptrs, 24, out.ctypes.data_as(i64p),
                                  pac2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                  4, 2, None) == -1
    rows = np.arange(64, dtype=np.int64)
    res = np.zeros(64, np.int64)
    assert lib.sa_batch(*ptrs, out.ctypes.data_as(i64p), 24, rows.ctypes.data_as(i64p), 64,
                        res.ctypes.data_as(i64p), 1) == -1
    with pytest.raises(ValueError, match="power of two"):
        index.FMIndex(packed, build_fmindex(packed, sa_intv=24, keep_full_sa=False)).sa(rows)
    # powers of two still give the full SA's values
    for intv in (1, 8, 32):
        sampled = native.sa_sample_walk_native(*args, intv, pac2=pac2)
        np.testing.assert_array_equal(sampled[1:], fm.sa[::intv][1:])
        sparse = index.FMIndex(packed, build_fmindex(packed, sa_intv=intv, keep_full_sa=False))
        np.testing.assert_array_equal(sparse.sa(rows[1:]), fm.sa[1:64])


def test_parallel_sa_walk_progress_is_atomic_and_complete(small_fm):
    """The walk's flags and progress counters are std::atomic (they were
    volatile, read and written from several threads); the progress reaches
    the row count and the walk equals the serial one."""
    import os

    from arachne_tpu_torch import native

    _, fm, pac2 = small_fm
    args = _walk_args(fm)
    prog = np.zeros(1, np.int64)
    par = native.sa_sample_walk_native(*args, 32, pac2=pac2, progress=prog, n_chunks=8)
    assert prog[0] == fm.seq_len
    np.testing.assert_array_equal(par, native.sa_sample_walk_native(*args, 32))
    with open(os.path.join(os.path.dirname(native.__file__), "smem.cpp")) as fh:
        assert "volatile" not in fh.read()


def test_incremental_build_reports_progress_through_the_sa_walk(small_fm, monkeypatch, capsys):
    """The progress reporter used to stop before the SA sampling walk, the
    longer half of a genome-scale incremental build."""
    import time

    from arachne_tpu_torch import native
    from arachne_tpu_torch.index import build

    packed, fm, _ = small_fm
    real_walk = native.sa_sample_walk_native

    def slow_walk(*a, progress=None, **kw):
        progress[0] = 1   # a step taken: the reporter prints from here on
        time.sleep(0.5)
        return real_walk(*a, progress=progress, **kw)

    monkeypatch.setattr(native, "sa_sample_walk_native", slow_walk)
    monkeypatch.setattr(build, "PROGRESS_EVERY_S", 0.02)
    got = build.build_fmindex_incremental(packed, sa_intv=32, progress=True)
    assert "[index] SA sampling walk" in capsys.readouterr().out
    np.testing.assert_array_equal(got.sa_sampled, real_walk(*_walk_args(fm), 32))
