"""The CIGAR stage's host side in native code (native/cigarbatch.cpp).

``TorchEngine.reg2aln_batch`` with the native library must give, hit by
hit, the MemAln its batched Python path (the fallback where the library
does not load) and the scalar ``align/cigar.reg2aln`` give: every field,
its type included (the records' reprs are compared).  The cases: the
K3/K4 edge set of ops/problems.py as windows of a genome built from its
targets, on both strands; the no-gap shortcut; the failures (a window
across l_pac, an empty window, a short fetch, an empty query); leading and
trailing deletions squeezed; soft clips on both strands; a band doubled up
to 4w; a seeded random batch on the small reference, also through the
2-bit pac with the forward cache off.  Besides: the op-stream decode
against ``decode_traceback_ops`` on K4's plain walk, BatchGlobal's flat
results against its Python path, the SE mapq and first band against
``approx_mapq_se``/``infer_bw`` bit for bit, and the ``hits_native``
count on a traced superbatch.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from arachne_tpu_torch import native
from arachne_tpu_torch.align.cigar import OP_D, OP_S, approx_mapq_se, infer_bw, reg2aln
from arachne_tpu_torch.align.extend import AlnReg
from arachne_tpu_torch.config import ArachneConfig
from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
from arachne_tpu_torch.ops.engine import TorchEngine
from arachne_tpu_torch.ops.problems import edge_global_problems, repeat_insertion_problem
from arachne_tpu_torch.ops.sw_extend import lengths, padded_codes
from arachne_tpu_torch.ops.sw_global import (
    BatchGlobal, GlobalResults, decode_traceback_ops, global_batch_torch, traceback_torch,
)

torch.set_num_threads(1)
CFG = ArachneConfig()
OPT = CFG.mem
MAT = OPT.scoring_matrix()
GAPS = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins, e_ins=OPT.e_ins)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "arachne_tpu_torch", "native")

pytestmark = pytest.mark.skipif(not native.cigar_batch_available(),
                                reason="the native library does not build here")


def index_of(contigs):
    bases = np.array(list("ACGTN"))
    packed = pack_reference([(f"c{i}", "", "".join(bases[c])) for i, c in enumerate(contigs)])
    return FMIndex(packed, build_fmindex(packed))


@pytest.fixture(scope="module")
def small(small_reference):
    packed = pack_reference(small_reference)
    idx = FMIndex(packed, build_fmindex(packed))
    return idx, unpack_2bit(packed.pac, 0, packed.l_pac)


def revcomp(codes):
    return (3 - np.asarray(codes)[::-1]).astype(np.uint8)


def region(idx, rb, re, qb, qe, rng, **fields):
    """An AlnReg over [rb, re) on the fwd-rev coordinate and [qb, qe) of
    the read, its rid the contig the scalar reg2aln places it on, the rest
    random but plausible."""
    p = rb if rb < idx.l_pac else re - 1
    fpos, _ = idx.depos(np.array([p]))
    truesc = int(rng.integers(max(qe - qb, 1) // 2, max(qe - qb, 1) + 2))
    ar = AlnReg(
        rb=rb, re=re, qb=qb, qe=qe, rid=int(idx.pos2rid(fpos)[0]), score=truesc, truesc=truesc,
        sub=int(rng.integers(0, truesc + 1)) if rng.integers(0, 2) else 0,
        csub=int(rng.integers(0, truesc + 1)), sub_n=int(rng.integers(0, 3)),
        w=int(rng.integers(1, 200)), seedcov=int(rng.integers(1, 100)),
        secondary=-1 if rng.integers(0, 4) else 0, is_alt=bool(rng.integers(0, 2)),
        frac_rep=float(rng.random()) if rng.integers(0, 2) else 0.0,
        alt_sc=int(rng.integers(0, 50)),
    )
    for k, v in fields.items():
        setattr(ar, k, v)
    return ar


def job(idx, fwd, rng, beg, core, ref_len, strand, flank=(0, 0), **fields):
    """The read ``core`` (forward-strand codes) against the forward window
    [beg, beg + ref_len), with random flanks; on the reverse strand the
    read is reverse-complemented and the window mirrored."""
    left = rng.integers(0, 4, flank[0]).astype(np.uint8)
    right = rng.integers(0, 4, flank[1]).astype(np.uint8)
    l2 = idx.l_pac << 1
    if strand:
        read = np.concatenate([left, revcomp(core), right])
        rb, re = l2 - (beg + ref_len), l2 - beg
    else:
        read = np.concatenate([left, np.asarray(core, np.uint8), right])
        rb, re = beg, beg + ref_len
    return read, region(idx, rb, re, len(left), len(read) - len(right), rng, **fields)


def mutate(rng, t, subs=0, ins=0, dels=0):
    q = np.array(t, np.uint8)
    for _ in range(subs):
        k = int(rng.integers(0, len(q)))
        q[k] = (q[k] + 1 + rng.integers(0, 3)) % 4
    for _ in range(dels):
        n, at = int(rng.integers(1, 6)), int(rng.integers(5, max(len(q) - 10, 6)))
        q = np.delete(q, np.arange(at, min(at + n, len(q))))
    for _ in range(ins):
        n, at = int(rng.integers(1, 6)), int(rng.integers(5, max(len(q) - 5, 6)))
        q = np.insert(q, at, rng.integers(0, 4, n).astype(np.uint8))
    return q


def random_jobs(idx, fwd, rng, n):
    """Reads of 30-150 bases from both strands of each contig, 50 bases
    clear of its ends, with substitutions, short indels and flanks."""
    offs, lens = idx._offsets, np.asarray([a.length for a in idx.packed.anns])
    jobs = []
    for _ in range(n):
        c = int(rng.integers(0, len(offs)))
        L = int(rng.integers(30, 151))
        beg = int(offs[c] + rng.integers(50, lens[c] - L - 50))
        core = mutate(rng, fwd[beg : beg + L], int(rng.integers(0, 4)), int(rng.integers(0, 2)),
                      int(rng.integers(0, 2)))
        flank = (int(rng.integers(0, 3)) * int(rng.integers(0, 8)),
                 int(rng.integers(0, 3)) * int(rng.integers(0, 8)))
        jobs.append(job(idx, fwd, rng, beg, core, L, int(rng.integers(0, 2)), flank))
    return jobs


def edge_jobs(rng):
    """The K3/K4 edge set (ops/problems.py) as hits: the targets laid out
    with random spacers in a genome of two contigs, each problem's query
    against its target's window on both strands."""
    qs, ts, ws = edge_global_problems(7, 36, 96, 160)
    q2, t2, w2 = repeat_insertion_problem()
    qs, ts, ws = qs + q2, ts + t2, list(ws) + list(w2)
    contigs, starts = [[], []], []
    for k, t in enumerate(ts):
        c = contigs[k % 2]
        c.append(rng.integers(0, 4, 60).astype(np.uint8))
        starts.append((k % 2, sum(map(len, c))))
        c.append(np.asarray(t, np.uint8))
    contigs = [np.concatenate(c + [rng.integers(0, 4, 60).astype(np.uint8)]) for c in contigs]
    idx = index_of(contigs)
    fwd = unpack_2bit(idx.packed.pac, 0, idx.l_pac)
    jobs = []
    for (c, s), q, t, w in zip(starts, qs, ts, ws):
        beg = int(idx._offsets[c]) + s
        for strand in (0, 1):
            jobs.append(job(idx, fwd, rng, beg, np.asarray(q, np.uint8), len(t), strand,
                            (int(rng.integers(0, 6)), int(rng.integers(0, 6))), w=int(w) + 1))
    return idx, jobs


def shortcut_jobs(idx, fwd, rng):
    """Equal lengths and a score close to the read's length: infer_bw
    gives 0 and gen_cigar_prepare scores the window without a DP."""
    out = []
    for k in range(24):
        beg = int(rng.integers(60, 4000))
        core = mutate(rng, fwd[beg : beg + 100], k % 3)
        out.append(job(idx, fwd, rng, beg, core, 100, k % 2, (k % 4, k % 3), truesc=100))
    return out


def fail_jobs(idx, fwd, rng):
    """Windows the spec fails on, each still a mapped MemAln: across
    l_pac, empty, past the end of the fwd-rev text, and an empty query."""
    lp, q = idx.l_pac, fwd[100:200]
    return [
        (q, region(idx, lp - 50, lp + 50, 0, 100, rng)),
        (q, region(idx, 500, 500, 0, 100, rng)),
        (q, region(idx, 2 * lp - 40, 2 * lp + 60, 0, 100, rng)),
        (q, region(idx, 700, 800, 30, 30, rng)),
        (q, region(idx, 800, 900, 10, 90, rng)),   # a mapped hit among them
        (q, AlnReg(rb=-1, re=100)),                # unmapped: rb < 0
        (q, None),                                 # unmapped: no region
    ]


def squeeze_jobs(idx, fwd, rng):
    """Reads that lack the window's first bases, its last, or both: the
    global alignment starts or ends with a deletion, which reg2aln
    squeezes; where it does both, only the leading one."""
    out = []
    for k in range(24):
        beg, n = int(rng.integers(60, 4000)), 3 + k % 5
        t = fwd[beg : beg + 120]
        core = (t[n:], t[:-n], t[n:-n])[k % 3]
        out.append(job(idx, fwd, rng, beg, core, 120, (k // 3) % 2, truesc=120))
    return out


def clip_jobs(idx, fwd, rng):
    out = []
    for k in range(16):
        beg = int(rng.integers(60, 4000))
        core = mutate(rng, fwd[beg : beg + 90], 1, k % 2, (k + 1) % 2)
        out.append(job(idx, fwd, rng, beg, core, 90, k % 2, (1 + k % 7, 2 + k % 5)))
    return out


def doubling_jobs(idx, fwd, rng):
    """A 10-base insertion and a 10-base deletion 40 bases apart: the path
    leaves the diagonal by 10, so with w = 5 the score grows as the band
    doubles, 5, 10 and 4w = 20."""
    out = []
    for k in range(8):
        beg = int(rng.integers(60, 4000))
        t = fwd[beg : beg + 120]
        core = np.concatenate([t[:30], rng.integers(0, 4, 10).astype(np.uint8), t[30:70], t[80:]])
        out.append(job(idx, fwd, rng, beg, core, 120, k % 2, truesc=100, w=5))
    return out


def assert_same(engine, jobs):
    """The native path, the batched Python path and the scalar reg2aln,
    job by job; returns the native MemAln."""
    got = engine.reg2aln_batch(jobs)
    py = engine._reg2aln_python(jobs)
    scalar = [reg2aln(engine.idx, engine.opt, q, ar, engine.mat) for q, ar in jobs]
    assert len(got) == len(jobs)
    for k, (g, p, s) in enumerate(zip(got, py, scalar)):
        assert repr(g) == repr(p) == repr(s), k
    return got


CASES = ("edge set", "no-gap shortcut", "fail", "squeezed deletions", "soft clips",
         "w2 doubling to 4w", "random batch")


@pytest.mark.parametrize("case", CASES)
def test_native_reg2aln_is_the_python_path_and_the_scalar_one(small, case, monkeypatch):
    idx, fwd = small
    rng = np.random.default_rng(CASES.index(case) + 100)
    cfg = CFG
    if case == "edge set":
        idx, jobs = edge_jobs(rng)
    elif case == "w2 doubling to 4w":
        cfg = dataclasses.replace(CFG, mem=dataclasses.replace(OPT, w=5))
        jobs = doubling_jobs(idx, fwd, rng)
    else:
        make = {"no-gap shortcut": shortcut_jobs, "fail": fail_jobs,
                "squeezed deletions": squeeze_jobs, "soft clips": clip_jobs,
                "random batch": lambda *a: random_jobs(*a, 300)}[case]
        jobs = make(idx, fwd, rng)
    engine = TorchEngine(idx, cfg, device="cpu")
    waves = []
    run = BatchGlobal.run
    monkeypatch.setattr(BatchGlobal, "run", lambda self: waves.append(run(self)) or waves[-1])
    got = assert_same(engine, jobs)
    assert all(isinstance(w, GlobalResults) for w in waves)
    mapped = [(a, ar) for a, (_, ar) in zip(got, jobs) if ar is not None and ar.rb >= 0]
    # each case reaches what it is for
    if case == "edge set":
        assert {a.is_rev for a, _ in mapped} == {False, True}
        assert sum(a.NM == -1 for a, _ in mapped) == 2 * 4      # tlen = 0: empty windows
    elif case == "no-gap shortcut":
        assert not waves and all(a.cigar[len(a.cigar) > 0 and a.cigar[0][0] == OP_S][0] == 0
                                 for a, _ in mapped)
    elif case == "fail":
        assert [a.NM for a in got[:4]] == [-1] * 4 and got[4].NM >= 0
        assert [a.flag for a in got][-2:] == [4, 4]
    elif case == "squeezed deletions":
        # a squeezed deletion leaves the window's bases outside the CIGAR
        ref_len = lambda a: sum(n for op, n in a.cigar if op in (0, OP_D))
        for rev in (False, True):
            assert sum(ref_len(a) < ar.re - ar.rb for a, ar in mapped if a.is_rev == rev) >= 4
        assert all(a.cigar[0][0] != OP_D for a, _ in mapped)
        assert any(a.cigar[-1][0] == OP_D for a, _ in mapped)   # kept beside a leading one
    elif case == "soft clips":
        for rev in (False, True):
            cigs = [a.cigar for a, _ in mapped if a.is_rev == rev]
            assert cigs and all(c[0][0] == OP_S and c[-1][0] == OP_S for c in cigs)
    elif case == "w2 doubling to 4w":
        # three waves on each batched path, the third at w2 = 4w
        assert len(waves) == 6
        assert all({1, 2} <= {op for op, _ in a.cigar} for a, _ in mapped)
    elif case == "random batch":
        assert len(waves) >= 1 and {a.is_rev for a, _ in mapped} == {False, True}


def test_native_reg2aln_reads_the_2bit_pac_without_the_forward_cache(small, monkeypatch):
    """A fresh index with ARACHNE_UNPACK_MAX=0 keeps no forward cache, so
    the windows come from the 2-bit pac; the records are the cached
    index's."""
    idx, fwd = small
    jobs = random_jobs(idx, fwd, np.random.default_rng(5), 120)
    cached = TorchEngine(idx, CFG, device="cpu").reg2aln_batch(jobs)
    monkeypatch.setenv("ARACHNE_UNPACK_MAX", "0")
    bare = FMIndex(idx.packed, idx.fm)
    assert bare._fwd_codes() is None
    got = assert_same(TorchEngine(bare, CFG, device="cpu"), jobs)
    assert [repr(a) for a in got] == [repr(a) for a in cached]


def test_native_decode_is_decode_traceback_ops_on_the_edge_set():
    """K4's plain walk over the edge set and the repeat insertion: the
    native decode gives decode_traceback_ops' CIGAR for every lane, and
    [(M, qlen)] for a problem without a lane."""
    qs, ts, ws = edge_global_problems(11, 45, 96, 160)
    q2, t2, w2 = repeat_insertion_problem()
    qs, ts, ws = qs + q2, ts + t2, np.concatenate([ws, w2])
    qmax, tmax = 192, 320
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (padded_codes(qs, qmax), padded_codes(ts, tmax), lengths(qs), lengths(ts), ws)]
    _, z = global_batch_torch(*args, torch.as_tensor(MAT, dtype=torch.int32), **GAPS,
                              want_z=True)
    ops, fi, fk = (x.numpy() for x in traceback_torch(z, *args[2:], max_steps=qmax + tmax))
    want = [decode_traceback_ops(ops[:, b], int(fi[b]), int(fk[b])) for b in range(len(qs))]
    # lanes in reverse, and two problems the screen settled
    lane = np.concatenate([np.arange(len(qs))[::-1], [-1, -1]])
    qlen = np.concatenate([lengths(qs)[::-1], [7, 150]])
    cig, off = native.global_decode_native(lane, qlen, ops, fi, fk)
    got = [[tuple(p) for p in cig[a:b].tolist()] for a, b in zip(off[:-1], off[1:])]
    assert got == want[::-1] + [[(0, 7)], [(0, 150)]]
    assert any((2, 1) == (a[0], b[0]) for c in want for a, b in zip(c, c[1:]))


def test_batch_global_native_results_are_its_python_paths(monkeypatch):
    """BatchGlobal.run with the library returns GlobalResults, which reads
    and compares as the Python path's list of (score, cigar)."""
    rng = np.random.default_rng(9)
    qs, ts, ws = edge_global_problems(3, 27, 96, 160)
    probs = list(zip(qs, ts, ws.tolist()))
    for i in range(30):
        t = rng.integers(0, 4, int(rng.integers(40, 150))).astype(np.uint8)
        probs.append((mutate(rng, t, 2, i % 2, (i + 1) % 3), t, int(rng.integers(3, 40))))
    bg = BatchGlobal(OPT, torch.device("cpu"))
    monkeypatch.setattr(BatchGlobal, "CHUNK", 16)
    monkeypatch.setattr(BatchGlobal, "CHUNK_Z", 8)
    for p in probs:
        bg.submit(*p)
    got = bg.run()
    assert isinstance(got, GlobalResults) and len(got) == len(probs)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    for p in probs:
        bg.submit(*p)
    want = bg.run()
    assert isinstance(want, list) and got == want and list(got) == want
    assert got[-1] == want[-1] and got[2] == want[2]


def test_native_mapq_and_band_are_the_specs_bit_for_bit():
    """approx_mapq_se's float expression and infer_bw, both branches of
    the mapq (mapQ_coef_len > 0 and 0), against the scalar spec on random
    regions, frac_rep included."""
    rng = np.random.default_rng(21)
    for opt in (OPT, dataclasses.replace(OPT, mapQ_coef_len=0)):
        regs = []
        for _ in range(4000):
            qb = int(rng.integers(0, 20))
            qe = qb + int(rng.integers(1, 250))
            rb = int(rng.integers(0, 10**6))
            re = rb + max(1, qe - qb + int(rng.integers(-15, 16)))
            score = int(rng.integers(0, qe - qb + 1))
            regs.append(AlnReg(
                rb=rb, re=re, qb=qb, qe=qe, score=score, truesc=int(rng.integers(0, qe - qb + 1)),
                sub=int(rng.integers(0, score + 5)) * int(rng.integers(0, 2)),
                csub=int(rng.integers(0, score + 5)), sub_n=int(rng.integers(0, 6)),
                w=int(rng.integers(0, 300)), seedcov=int(rng.integers(1, 250)),
                secondary=int(rng.integers(-1, 2)), frac_rep=float(rng.random()) * rng.integers(0, 2),
            ))
        cols = [[getattr(r, f) for r in regs] for f in (
            "qb", "qe", "rb", "re", "truesc", "w", "secondary", "score", "sub", "csub", "sub_n",
            "seedcov")]
        mapq, w2 = native.cigar_init_native(np.array(cols, np.int64).T,
                                            np.array([r.frac_rep for r in regs]), opt)
        want_mapq = [approx_mapq_se(opt, r) if r.secondary < 0 else 0 for r in regs]
        want_w2 = []
        for r in regs:
            w = max(infer_bw(r.qe - r.qb, r.re - r.rb, r.truesc, opt.a, opt.o_del, opt.e_del),
                    infer_bw(r.qe - r.qb, r.re - r.rb, r.truesc, opt.a, opt.o_ins, opt.e_ins))
            want_w2.append(min(w, r.w) if w > opt.w else w)
        assert mapq.tolist() == want_mapq
        assert w2.tolist() == want_w2
        assert len(set(want_mapq)) > 20


def test_a_traced_superbatch_counts_the_hits_run_natively(small, monkeypatch):
    """hits_native equals hits with the library and is 0 on the loader's
    fallback, with the same records either way."""
    from test_torch_engine import make_reads

    from arachne_tpu_torch.rfa.engine import WORK_COUNTS, process_barcodes
    from arachne_tpu_torch.runtime.timers import TIMERS

    idx, fwd = small
    rng = np.random.default_rng(41)
    sets = []
    for bi in range(3):
        recs = make_reads(fwd, rng, n_pairs=4, indel=bi == 1)
        for r in recs:
            r.barcode = f"N{bi:02d}".encode()
        sets.append((recs, True))
    assert "hits_native" in WORK_COUNTS

    def traced():
        TIMERS.trace(True)
        try:
            with TIMERS.in_superbatch(0):
                res = process_barcodes(idx, CFG, sets, TorchEngine(idx, CFG, "cpu"))
        finally:
            TIMERS.trace(False)
        (sb,) = [r for r in TIMERS.spans() if r.name == "superbatch"]
        recs = [[(a.contig, a.pos, a.cigar, a.mapq, a.mismatches) for a in x]
                for r in res for x in r.alignments]
        return sb.attrs, recs

    attrs, recs = traced()
    assert attrs["hits"] > 0 and attrs["hits_native"] == attrs["hits"]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.cigar_batch_available()
    attrs_off, recs_off = traced()
    assert attrs_off["hits_native"] == 0 and attrs_off["hits"] == attrs["hits"]
    assert recs_off == recs


SANITIZED = """
import sys
import numpy as np
sys.path[:0] = [{repo!r}, {tests!r}]
from arachne_tpu_torch import native
native.lib_path = lambda: {so!r}      # the sanitized build
native._lib, native._tried = None, False
from arachne_tpu_torch.config import ArachneConfig
from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
from arachne_tpu_torch.ops.engine import TorchEngine
from test_torch_cigar_native import edge_jobs, fail_jobs, random_jobs

assert native.cigar_batch_available(), "the sanitized library did not load"
rng = np.random.default_rng(8)
packed = pack_reference([("a", "", "".join("ACGT"[i] for i in rng.integers(0, 4, 6000))),
                         ("b", "", "".join("ACGT"[i] for i in rng.integers(0, 4, 3000)))])
idx = FMIndex(packed, build_fmindex(packed))
fwd = unpack_2bit(packed.pac, 0, packed.l_pac)
eidx, ejobs = edge_jobs(rng)
for ix, jobs in ((idx, random_jobs(idx, fwd, rng, 150) + fail_jobs(idx, fwd, rng)),
                 (eidx, ejobs)):
    eng = TorchEngine(ix, ArachneConfig(), device="cpu")
    got = eng.reg2aln_batch(jobs)
    assert [repr(a) for a in got] == [repr(a) for a in eng._reg2aln_python(jobs)]
print("SANITIZED_OK")
"""


def test_native_cigar_stage_under_asan_ubsan(tmp_path):
    """cigarbatch.cpp built with -fsanitize=address,undefined and driven
    through the engine on random, failing and edge-set hits in a
    subprocess (ASan preloaded): any overflow of a buffer the Python side
    sized, or undefined behaviour, aborts it."""
    p = subprocess.run(["gcc", "-print-file-name=libasan.so"], capture_output=True, text=True)
    asan = p.stdout.strip()
    if not (os.path.isabs(asan) and os.path.exists(asan)):
        pytest.skip("libasan unavailable")
    so = str(tmp_path / "_arachne_native_asan.so")
    # the ABI symbol, SA-IS for the index, and the CIGAR stage
    subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
         "-shared", "-fPIC", "-pthread", "-o", so]
        + [os.path.join(NATIVE, s) for s in ("ropebwt.cpp", "sais.cpp", "cigarbatch.cpp")],
        check=True, capture_output=True, timeout=600,
    )
    program = tmp_path / "sanitized_cigar.py"
    program.write_text(SANITIZED.format(repo=REPO, tests=os.path.join(REPO, "tests"), so=so))
    env = dict(os.environ, PYTHONPATH=REPO, LD_PRELOAD=asan,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=1")
    p = subprocess.run([sys.executable, str(program)], env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "SANITIZED_OK" in p.stdout
