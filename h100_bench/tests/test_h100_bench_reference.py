"""The reference and the comparison that decides ``correct``, on the CPU:
the reference's own index equals the program's, a sound run is correct,
and every fault a cell can have makes it not correct."""

import os

import numpy as np
import pytest

from h100_bench import bench as hb
from h100_bench import check, genomes
from h100_bench.reference import oracle
from h100_bench.reference.index import fmindex

from .tiny import make_root, small_genome


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("genome")
    fa = str(d / "g.fa")
    genomes.write_genome(fa, small_genome(2, 120000, 11))
    return fa


def test_reference_index_equals_the_programs(genome, tmp_path):
    from arachne_tpu_torch.index import FMIndex, build_index_files, load_index

    fmindex.build(genome, str(tmp_path / "ref"))
    ref = fmindex.FMIndex(str(tmp_path / "ref"))
    packed, fm = load_index(build_index_files(genome, keep_full_sa=True))
    prog = FMIndex(packed, fm)
    assert np.array_equal(np.asarray(ref._sa), fm.sa)
    assert (ref.primary, list(ref.L2), ref.l_pac) == (fm.primary, list(fm.L2), packed.l_pac)
    rng = np.random.default_rng(3)
    ks = np.concatenate([[-1, 0, fm.primary, fm.primary + 1, fm.seq_len],
                         rng.integers(0, fm.seq_len, 3000)])
    assert np.array_equal(prog.occ4(ks), np.array([ref.occ4(int(k)) for k in ks]))
    for is_back in (True, False):
        for _ in range(300):
            c = int(rng.integers(0, 4))
            s = int(rng.integers(1, 40))
            x0, x1 = (int(v) for v in rng.integers(1, fm.seq_len - s, 2))
            got = prog.extend(np.array([x0]), np.array([x1]), np.array([s]), is_back)
            assert tuple(int(v[0, c]) for v in got) == ref.extend1(x0, x1, s, is_back, c)
    rows = rng.integers(1, fm.seq_len + 1, 500)
    assert np.array_equal(prog.sa(rows), ref.sa(rows))


def _run(tmp_path, monkeypatch, **kw):
    root, bench = make_root(str(tmp_path))
    monkeypatch.setenv("ARACHNE_TEST_READS_PER_BATCH", "40")
    return hb.run_cell(root, bench, "tiny.mini", 2 ** 31 + 5, 1.0, kw.pop("trace", False),
                       engine="torch-cpu", processes=2)


def test_a_sound_run_is_correct(tmp_path, monkeypatch):
    res = _run(tmp_path, monkeypatch, trace=True)
    assert res["correct"], res
    assert all(v["value"] == 0 == v["limit"] for v in res["check"].values())
    assert list(res)[-1] == "check"
    m = res["metrics"]
    assert 0 < m["scheduler.worker_busy_pct"]["value"] <= 100
    assert m["rfa.host_ms_per_kpair"]["value"] > 0


def _alter_mapq(monkeypatch):
    from arachne_tpu_torch.rfa import engine

    finish = engine._finish_barcode

    def altered(*a, **k):
        res = finish(*a, **k)
        for lst in res.alignments:
            for aln in lst:
                if aln.active:
                    aln.mapq = (aln.mapq + 1) % 61
                    return res
        return res
    monkeypatch.setattr(engine, "_finish_barcode", altered)


def _drop_half(monkeypatch):
    from arachne_tpu_torch.io.bam import BAMWriters

    dump = BAMWriters.dump
    calls = [0]

    def half(self, alignments, attach_bx):
        calls[0] += 1
        if calls[0] % 2:
            dump(self, alignments, attach_bx)
    monkeypatch.setattr(BAMWriters, "dump", half)


def _shift_hit(monkeypatch):
    from arachne_tpu_torch.ops.engine import TorchEngine

    align_pairs = TorchEngine.align_pairs

    def shifted(self, pairs):
        out = align_pairs(self, pairs)
        for a1, _ in out:
            if a1:
                a1[0].offset += 1
                break
        return out
    monkeypatch.setattr(TorchEngine, "align_pairs", shifted)


@pytest.mark.parametrize("fault", [_alter_mapq, _drop_half, _shift_hit],
                         ids=["answer_altered_in_rfa", "half_of_the_sets_unwritten",
                              "hit_altered_on_the_device_path"])
def test_every_fault_makes_the_run_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tmp_path, monkeypatch)
    assert not res["correct"], res
    assert sum(v["value"] for v in res["check"].values()) > 0


def test_the_control_in_the_programs_place_is_not_correct(genome, tmp_path):
    """The lower-precision reference, written as the program's output and
    judged by check.compare and check.verdict, reads not correct."""
    from h100_bench import control, library

    fmindex.build(genome, str(tmp_path / "ref"))
    contigs = genomes.read_contigs(genome)
    traffic = {"n_barcodes": 6, "molecules_per_barcode": 3, "pairs_per_molecule": 12,
               "check_pairs": 10 ** 6}
    chk = control.control_run(str(tmp_path / "ref"), contigs, traffic, 2, 9, str(tmp_path), 2)
    assert chk["sets_checked"] == 6 and chk["correct"] is False
    assert chk["numbers"]["mismatched_records"] > check.LIMITS["mismatched_records"]
    assert chk["numbers"]["mismatched_headers"] == chk["numbers"]["unwritten_sets"] == 0
    # and the same output in full precision is correct: the verdict reads the precision
    r1, r2 = str(tmp_path / "R1.fq"), str(tmp_path / "R2.fq")
    sets = oracle.read_sets(r1, r2)
    sound = oracle.run_sets(str(tmp_path / "ref"), 2, control.VERSION, sets, 2)
    control.write_output(str(tmp_path / "sound"), str(tmp_path / "ref"), 2, sorted(sets), sound)
    run = control.SimpleNamespace(
        feed=[control.FedSet(0, j, len(sets[j][0]), False, [r.read_info for r in sets[j][0]])
              for j in sorted(sets)],
        emitted=len(sets), opened=-1, closed=len(sets) - 1,
        libraries=[(r1, r2, sum(len(v[0]) for v in sets.values()))], libraries_reused=0)
    again = check.compare(str(tmp_path / "sound"), run, run.libraries, str(tmp_path / "ref"),
                          traffic, 9, 2, 2)
    assert check.verdict(again["numbers"]), again["numbers"]
