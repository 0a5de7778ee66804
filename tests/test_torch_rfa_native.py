"""RFA's host stage in native code (native/rfa_tail.cpp ``rfa_superbatch``,
rfa/batch.py).

The port's superbatch path must build, for every barcode, the Alignments
the Python forms build: ``candidates.get_alignments``' walk and
``engine._finish_barcode``'s tail (molecules.py, optimizer.py, mapq.py),
run here from the test.  Every field of every Alignment and its MapQData
is compared, types included; for ``mate_alignment``, ``secondary``,
``primary`` and ``second_best`` the object referenced.  The native path
builds the kept alignments and, for the reads the split-read pass may
split, all of them: the rest that pass provably leaves alone.  The library: three contigs with a planted family at
two divergences (hits that the best-17 filter keeps and hits it drops),
reads on both strands with substitutions, 1-bp indels, soft clips, N
bases, random mates (unmapped placeholders) and chimeras (split reads), a barcode under
``rfa_min_read_pairs`` and one not unique; with and without centromeres,
under ``--no-rfa``, and with hits put at the best-17 filter's edge.  Besides: a superbatch equals its barcodes run one
by one, the per-barcode oracle path gives the same records,
``reg2aln_flat`` is ``reg2aln_batch`` flattened, the per-barcode path
refuses to run without the native library, and an ASan/UBSan build of the
library runs the stage on several threads.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arachne_tpu_torch import native
from arachne_tpu_torch.align.cigar import FlatAlns
from arachne_tpu_torch.config import ArachneConfig, RFAOptions
from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference
from arachne_tpu_torch.ops.engine import TorchEngine
from arachne_tpu_torch.rfa import engine as rfa_engine
from arachne_tpu_torch.rfa.candidates import FastQRecordView, get_alignments, get_chains
from arachne_tpu_torch.rfa.types import Alignment, MapQData, Region

torch.set_num_threads(1)
CFG = ArachneConfig()
NO_RFA = dataclasses.replace(CFG, rfa=RFAOptions(rfa_min_read_pairs=1 << 60))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "arachne_tpu_torch", "native")
BASES = np.array(list("ACGTN"))
# (pairs, unique) of each barcode: one under rfa_min_read_pairs, one not unique
SIZES = [(22, True), (18, True), (3, True), (24, True), (14, False), (20, True), (16, True)]
CENTROMERES = {"c1": Region(start=2000, end=9000)}


def genome(seed=41):
    """Three contigs; a 1.5 kb family at c0:5000, copied at c1:3000 with 1%
    of its bases changed and at c2:8000 with 3%."""
    rng = np.random.default_rng(seed)
    contigs = [rng.integers(0, 4, n).astype(np.uint8) for n in (40_000, 25_000, 20_000)]
    fam = contigs[0][5000:6500]
    for c, at, rate in ((1, 3000, 0.01), (2, 8000, 0.03)):
        copy = fam.copy()
        k = rng.choice(len(copy), int(rate * len(copy)), replace=False)
        copy[k] = (copy[k] + rng.integers(1, 4, len(k))) % 4
        contigs[c][at : at + len(copy)] = copy
    return contigs


def index_of(contigs):
    packed = pack_reference([(f"c{i}", "", "".join(BASES[c])) for i, c in enumerate(contigs)])
    return FMIndex(packed, build_fmindex(packed))


def barcode_sets(contigs, seed=42, sizes=SIZES):
    """Linked reads: each barcode draws pairs from two 6 kb molecules (one
    on the family for every other barcode), fragments of 280-420 bases,
    reads of 100 or 150 on both strands, with substitutions, a 1-bp indel in a quarter,
    a clipped end in a tenth, an N now and then, one mate in twenty
    replaced by random bases and one first read in twelve a chimera of
    two contigs."""
    rng = np.random.default_rng(seed)
    sets = []
    for b, (n, unique) in enumerate(sizes):
        mols = []
        for m in range(2):
            c = int(rng.integers(0, 3)) if m or b % 2 else 0
            start = 4000 if (not m and b % 2 == 0) else int(rng.integers(0, len(contigs[c]) - 6500))
            mols.append((c, start))
        recs = []
        for i in range(n):
            c, start = mols[int(rng.integers(0, 2))]
            L = 150 if rng.integers(0, 3) else 100
            frag = int(rng.integers(280, 420))
            p = start + int(rng.integers(0, 6000 - frag))
            t = contigs[c][p : p + frag]
            r1, r2 = t[: L + 1].copy(), (3 - t[::-1][: L + 1]).astype(np.uint8)
            reads = []
            for r in (r1, r2):
                for _ in range(int(rng.integers(0, 4))):
                    j = int(rng.integers(0, L))
                    r[j] = (r[j] + 1 + rng.integers(0, 3)) % 4
                if rng.integers(0, 4) == 0:
                    j = int(rng.integers(20, L - 20))
                    r = np.delete(r, j) if rng.integers(0, 2) else np.insert(r, j, r[j] ^ 1)
                r = r[:L]
                if rng.integers(0, 10) == 0:
                    k = int(rng.integers(10, 16))
                    side = slice(0, k) if rng.integers(0, 2) else slice(L - k, L)
                    r[side] = rng.integers(0, 4, k)
                if rng.integers(0, 12) == 0:
                    r[int(rng.integers(0, L))] = 4
                reads.append(r)
            if rng.integers(0, 20) == 0:
                reads[1] = rng.integers(0, 4, L).astype(np.uint8)
            if rng.integers(0, 12) == 0:   # a chimera: a split read
                c2 = (c + 1) % 3
                q = int(rng.integers(10_000, len(contigs[c2]) - L))
                reads[0][L // 2 :] = contigs[c2][q : q + L - L // 2]
            quals = [bytes(rng.integers(35, 74, len(r)).astype(np.uint8)) for r in reads]
            recs.append(FastQRecordView(
                read1="".join(BASES[reads[0]]).encode(), qual1=quals[0],
                read2="".join(BASES[reads[1]]).encode(), qual2=quals[1],
                barcode=f"BC{b:02d}-1".encode(), read_info=f"bc{b}_pair{i}",
                read_group="rg" if b % 2 else "",
            ))
        sets.append((recs, unique))
    return sets


@pytest.fixture(scope="module")
def library():
    contigs = genome()
    idx = index_of(contigs)
    return idx, TorchEngine(idx, CFG, device="cpu"), barcode_sets(contigs)


def describe(x):
    """A comparable form of a field: an Alignment by its read and id, a
    MapQData field by field, a value with its type."""
    if isinstance(x, Alignment):
        return ("alignment", x.read_id, x.id)
    if isinstance(x, MapQData):
        return tuple((f.name, describe(getattr(x, f.name))) for f in dataclasses.fields(MapQData))
    if isinstance(x, list):
        return ("list", tuple(describe(v) for v in x))
    if isinstance(x, float) and x != x:
        return ("float", "nan")
    return (type(x).__name__, x)


def rows(lists):
    return [[tuple((f.name, describe(getattr(a, f.name))) for f in dataclasses.fields(Alignment))
             for a in lst] for lst in lists]


def reference(idx, cfg, sets, engine, centromeres=None):
    """Per barcode: the Python walk and the Python tail's result, with every
    alignment of each read."""
    out = []
    for reads, unique in sets:
        chains, bc = get_chains(idx, cfg, reads, engine=engine)
        alignments, stashed = get_alignments(idx, cfg, chains, engine=engine)
        res = rfa_engine.finish_barcode_python(idx, cfg, reads, unique, alignments, stashed, bc,
                                               centromeres)
        out.append((res, stashed))
    return out


@contextlib.contextmanager
def split_lists(monkeypatch):
    """The reads' lists the native path hands the split-read pass (every
    alignment of each read that pass may split), a list a call."""
    seen = []
    check = rfa_engine.check_split_reads
    monkeypatch.setattr(rfa_engine, "check_split_reads",
                        lambda lists, *a: (seen.append(lists), check(lists, *a))[1])
    try:
        yield seen
    finally:
        monkeypatch.undo()


def native_run(idx, cfg, sets, engine, centromeres, monkeypatch):
    """process_barcodes' results, each with its split-read lists."""
    with split_lists(monkeypatch) as seen:
        results = rfa_engine.process_barcodes(idx, cfg, sets, engine, centromeres)
    return list(zip(results, seen))


def outcome(res):
    return (res.ran_rfa, res.attach_bx, res.barcode, res.n_molecules, len(res.reads))


def assert_same(got, want):
    """One barcode: the native result (with its split-read lists) and the
    reference's (with every alignment of each read).  A read the native
    path hands no list to the split pass is one that pass leaves alone:
    its first active alignment unplaced or covering all but 14 bases of
    the read or fewer."""
    (g, g_split), (w, w_full) = got, want
    assert outcome(g) == outcome(w)
    assert rows(g.alignments) == rows(w.alignments)
    split = {lst[0].read_id: lst for lst in g_split}
    assert list(split) == sorted(split) and len(split) == len(g_split)
    for r, lst in enumerate(w_full):
        if r in split:
            assert rows([split[r]]) == rows([lst]), r
            continue
        first = next((a for a in lst if a.active), None)
        if first is not None:
            assert first.secondary is None and (
                first.pos == -1 or abs(first.readmap_e - first.readmap_s) > len(first.read_seq) - 15)


CASES = ("superbatch", "centromeres", "no-rfa")


@pytest.mark.parametrize("case", CASES)
def test_native_stage_is_the_python_walk_and_tail(library, case, monkeypatch):
    idx, engine, sets = library
    cfg = NO_RFA if case == "no-rfa" else CFG
    cen = CENTROMERES if case == "centromeres" else None
    got = native_run(idx, cfg, sets, engine, cen, monkeypatch)
    want = reference(idx, cfg, sets, engine, cen)
    assert len(got) == len(want) == len(sets)
    for g, w in zip(got, want):
        assert_same(g, w)

    # the library reaches what it is for
    alns = [a for _, full in want for lst in full for a in lst]
    kept = [a for res, _ in got for lst in res.alignments for a in lst]
    assert len(alns) >= 256                       # the native stage's threaded path
    assert {a.contig for a in alns} == {"", "c0", "c1", "c2"}
    assert any(a.reversed_ for a in kept) and any(not a.reversed_ for a in kept)
    assert any(a.pos == -1 for a in kept)          # unmapped placeholders
    assert any(a.soft_clipped for a in kept) and any(a.indels for a in kept)
    assert any(a.mismatch_locs for a in kept)
    assert any(a.secondary is not None for a in kept)     # a split read
    assert len(alns) > len(kept)                   # the best-17 filter dropped hits
    split_reads = sum(len(s) for _, s in got)
    assert 0 < split_reads < sum(len(full) for _, full in want)
    assert any(len(lst) > 1 for res, _ in got for lst in res.alignments)
    assert any(a.mapq_data.second_best is not None for a in kept)
    ran = [res.ran_rfa for res, _ in got]
    if case == "no-rfa":
        assert not any(ran)
    else:
        assert ran == [n >= 5 and u for n, u in SIZES]
        assert any(a.molecule_id >= 0 for a in kept)
    if case == "centromeres":
        assert any(a.contig == "c1" and 2000 < a.pos <= 9000 and a.active and a.mapq == 0
                   for a in kept)


def test_the_best_17_filter_at_its_edge(library, monkeypatch):
    """In the barcode with the most reads of several hits, one other hit
    of each such read put at exactly the read's best chain score less
    ``alignment_score_delta`` (kept) or a point lower (dropped), in turns,
    in the chains both sides read."""
    idx, engine, sets = library
    multi = lambda c: sum(len(lst) > 1 for lst in c[0])
    (chains, bc), (reads, unique) = max(
        ((get_chains(idx, CFG, r, engine=engine), (r, u)) for r, u in sets),
        key=lambda x: multi(x[0]))
    delta, edge = CFG.rfa.alignment_score_delta, []
    for lst in (lst for lst in chains if len(lst) > 1):
        best = max(range(len(lst)), key=lambda k: lst[k].score)
        other = lst[best - 1]          # another hit of the read
        other.score = lst[best].score - delta - len(edge) % 2
        edge.append(other)
    assert len(edge) >= 6
    mems = engine.reg2aln_batch(rfa_engine.hit_jobs([chains]))
    with split_lists(monkeypatch) as seen:
        (got,) = rfa_engine.finish_barcodes(idx, CFG, [(reads, unique)], [(chains, bc)],
                                            FlatAlns.of(mems))
    alignments, stashed = get_alignments(idx, CFG, chains, mems=mems)
    want = rfa_engine.finish_barcode_python(idx, CFG, reads, unique, alignments, stashed, bc)
    assert_same((got, seen[0]), (want, stashed))
    kept = {(a.read_id, a.id) for lst in got.alignments for a in lst}
    assert [(ch.read_id, ch.hit_id) in kept for ch in edge] == [k % 2 == 0
                                                                for k in range(len(edge))]


def test_a_superbatch_is_its_barcodes_one_by_one(library, monkeypatch):
    idx, engine, sets = library
    together = native_run(idx, CFG, sets, engine, CENTROMERES, monkeypatch)
    for b, s in enumerate(sets):
        ((alone, alone_split),) = native_run(idx, CFG, [s], engine, CENTROMERES, monkeypatch)
        res, split = together[b]
        assert outcome(alone) == outcome(res), b
        assert rows(alone.alignments) == rows(res.alignments), b
        assert rows(alone_split) == rows(split), b


def test_the_per_barcode_oracle_path_gives_the_same_records(library, monkeypatch):
    """``do_rfa_for_one_barcode`` without an engine (the CLI's ``--engine
    oracle``: the scalar pair path and the scalar reg2aln, flattened) goes
    through the same native stage, barcode by barcode."""
    idx, engine, sets = library
    batched = native_run(idx, CFG, sets[:3], engine, CENTROMERES, monkeypatch)
    for (reads, unique), (res, split) in zip(sets[:3], batched):
        with split_lists(monkeypatch) as seen:
            one = rfa_engine.do_rfa_for_one_barcode(idx, CFG, reads, unique, CENTROMERES)
        assert outcome(one) == outcome(res)
        assert rows(one.alignments) == rows(res.alignments)
        assert rows(seen[0]) == rows(split)


def test_reg2aln_flat_is_the_records_flattened(library):
    """Mapped and unmapped jobs (no region, rb < 0) alike."""
    from test_torch_cigar_native import fail_jobs

    idx, engine, sets = library
    chains, _ = get_chains(idx, CFG, sets[0][0], engine=engine)
    jobs = rfa_engine.hit_jobs([chains])
    fwd = np.concatenate([np.asarray(c) for c in genome()])
    jobs = jobs[:5] + fail_jobs(idx, fwd, np.random.default_rng(3)) + jobs[5:]
    flat, want = engine.reg2aln_flat(jobs), FlatAlns.of(engine.reg2aln_batch(jobs))
    for f in dataclasses.fields(FlatAlns):
        assert np.array_equal(getattr(flat, f.name), getattr(want, f.name)), f.name
    assert (want.rid == -1).sum() >= 2 and len(want.cigar) > 0


def test_the_per_barcode_path_requires_the_native_library(library, monkeypatch):
    idx, _, sets = library
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match=r"native/\*\.cpp"):
        rfa_engine.do_rfa_for_one_barcode(idx, CFG, *sets[2])


SANITIZED = """
import os, sys
os.environ["ARACHNE_NATIVE_THREADS"] = "4"
sys.path[:0] = [{repo!r}, {tests!r}]
from arachne_tpu_torch import native
native.lib_path = lambda: {so!r}      # the sanitized build
native._lib, native._tried = None, False
import pytest
from arachne_tpu_torch.ops.engine import TorchEngine
import test_torch_rfa_native as t

assert native.get_lib() is not None, "the sanitized library did not load"
contigs = t.genome()
idx = t.index_of(contigs)
sets = t.barcode_sets(contigs)
engine = TorchEngine(idx, t.CFG, device="cpu")
mp = pytest.MonkeyPatch()
got = t.native_run(idx, t.CFG, sets, engine, t.CENTROMERES, mp)
want = t.reference(idx, t.CFG, sets, engine, t.CENTROMERES)
for g, w in zip(got, want):
    t.assert_same(g, w)
print("SANITIZED_OK")
"""


def test_native_stage_under_asan_ubsan(tmp_path):
    """The native library built with -fsanitize=address,undefined and the
    stage run through process_barcodes on four threads in a subprocess
    (ASan preloaded): any overflow of a buffer the Python side sized, or
    undefined behaviour, aborts it; the records are still the Python
    forms'."""
    p = subprocess.run(["gcc", "-print-file-name=libasan.so"], capture_output=True, text=True)
    asan = p.stdout.strip()
    if not (os.path.isabs(asan) and os.path.exists(asan)):
        pytest.skip("libasan unavailable")
    so = str(tmp_path / "_arachne_native_asan.so")
    subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-shared", "-fPIC", "-pthread", "-o", so]
        + [os.path.join(NATIVE, s) for s in native._SOURCES],
        check=True, capture_output=True, timeout=600,
    )
    program = tmp_path / "sanitized_rfa.py"
    program.write_text(SANITIZED.format(repo=REPO, tests=os.path.join(REPO, "tests"), so=so))
    env = dict(os.environ, PYTHONPATH=REPO, LD_PRELOAD=asan,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1")
    p = subprocess.run([sys.executable, str(program)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "SANITIZED_OK" in p.stdout
