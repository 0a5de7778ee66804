"""The port's CUDA kernels against their plain PyTorch versions on the card,
and device seeding against the host C++ collector.

Every test here needs a CUDA device and skips without one.  The module
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs: tolerance 0.  Each launch through a kernel wrapper must
add exactly one to that kernel's launch count.
"""

import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from arachne_tpu_torch.align.ksw import MINUS_INF
from arachne_tpu_torch.config import ArachneConfig, MemOptions
from arachne_tpu_torch.ops.problems import (
    EDGE_GLOBAL_KINDS, edge_global_problems, extend_problems, global_problems, local_problems,
    on_device, repeat_insertion_problem, sideways_z,
)

OPT = MemOptions()
GAPS = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins, e_ins=OPT.e_ins)
MAT = OPT.scoring_matrix()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def mat_on(dev):
    return torch.as_tensor(OPT.scoring_matrix(), dtype=torch.int32, device=dev)


def edge_extend_problems(seed, B, qmax, tmax):
    """The main path's K1 problems with the edge cases of the
    warp-per-problem design mixed in, so that neighbouring warps, two to a
    block, hold different kinds: w = 0, h0 = 0, problems that die on row 0 (h0 = 1 against a
    target that mismatches every query base), tlen = 0, one-base queries
    on two-base targets, and problems as long as qmax and tmax allow."""
    qs, ts, ws, h0s = extend_problems(seed, B, qmax, tmax, OPT)
    rng = np.random.default_rng(seed)
    for b in range(B):
        kind = b % 7
        if kind == 0:
            ws[b] = 0
        elif kind == 1:
            h0s[b] = 0
        elif kind == 2:
            qs[b] = np.zeros(max(len(qs[b]), 1), np.int8)
            ts[b] = np.ones(len(ts[b]), np.int8)
            h0s[b] = 1
        elif kind == 3:
            ts[b] = ts[b][:0]
        elif kind == 4:
            qs[b], ts[b] = qs[b][:1], ts[b][:2]
        elif kind == 5:
            ts[b] = rng.integers(0, 4, tmax).astype(np.int8)
            qs[b] = ts[b][:qmax].copy()
            ws[b], h0s[b] = 100, 60
    return qs, ts, ws, h0s


@pytest.mark.cuda
@pytest.mark.parametrize("qmax,tmax", [(64, 128), (192, 512), (256, 400), (1024, 1100)])
def test_extend_kernel_edges_match_plain(dev, qmax, tmax):
    from arachne_tpu_torch.ops.cuda_extend import extend_cuda
    from arachne_tpu_torch.ops.sw_extend import extend_batch_torch

    qs, ts, ws, h0s = edge_extend_problems(31 + qmax, 70, qmax, tmax)
    args = on_device(dev, qs, ts, qmax, tmax, ws, h0s)
    kw = dict(GAPS, zdrop=OPT.zdrop)
    got = extend_cuda(*args, mat_on(dev), **kw)
    want = extend_batch_torch(*args, mat_on(dev), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    tle = want[2].cpu().numpy()
    assert (tle[2::7] == 0).all()                  # died on row 0
    assert (tle[5::7] > qmax // 2).all()           # ran long


@pytest.mark.cuda
@pytest.mark.parametrize("qmax,tmax", [(64, 160), (192, 768), (256, 600), (1024, 2100),
                                       (192, 8192), (64, 30720)])
def test_local_kernel_edges_match_plain(dev, qmax, tmax):
    """qmax 64 to 1024; tlen = 0, one-base queries, early stops on the
    first positive row, lengths that differ from warp to warp; tmax 8192
    needs 64 KB of row maxima for a block of two warps, above the 48 KB a
    launch gets without opting in, and tmax 30720 needs 240 KB for two,
    above the 227 KB a block may have, so the launcher runs one warp per
    block."""
    from arachne_tpu_torch.ops.cuda_local import local_cuda
    from arachne_tpu_torch.ops.sw_local import NEVER, local_sw_full_torch

    B = 12 if tmax > 10000 else 40 if tmax > 2000 else 90
    qs, ts = local_problems(41 + qmax, B, qmax, tmax)
    rng = np.random.default_rng(qmax)
    ends = np.full(B, NEVER, np.int32)
    for b in range(B):
        kind = b % 6
        if kind == 0:
            ts[b] = ts[b][:0]
        elif kind == 1:
            qs[b] = qs[b][:1]
        elif kind == 2:
            ends[b] = 1
        elif kind == 3:
            ends[b] = int(rng.integers(20, 80))
        elif kind == 4:
            qs[b], ts[b] = qs[b][:5], ts[b][:9]
    args = on_device(dev, qs, ts, qmax, tmax, ends, np.full(B, 19, np.int32))
    kw = dict(GAPS, max_mat=1)
    got = local_cuda(*args, mat_on(dev), **kw)
    want = local_sw_full_torch(*args, mat_on(dev), **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (want[1].cpu().numpy()[0::6] == -1).all()    # tlen 0: no row


@pytest.mark.cuda
def test_extend_kernel_matches_plain(dev):
    from arachne_tpu_torch.ops.cuda_extend import extend_cuda
    from arachne_tpu_torch.ops.sw_extend import extend_batch, extend_batch_torch

    qs, ts, ws, h0s = extend_problems(21, 300, 192, 512, OPT)
    args = on_device(dev, qs, ts, 192, 512, ws, h0s)
    kw = dict(GAPS, zdrop=OPT.zdrop)
    before = extend_cuda.launches
    got = extend_batch(*args, mat_on(dev), **kw)
    assert extend_cuda.launches == before + 1
    assert torch.equal(got, extend_batch_torch(*args, mat_on(dev), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("problems", ["main", "edges"])
def test_extend_kernel_counts_the_plain_versions_cells(dev, problems):
    """K1's counter (``count_cells``: a seventh row of its output, each
    problem's DP cells) equals extend_batch_torch's, problem for problem,
    on the main path's problems (chip_smoke.py's K1 line) and on the edge
    cases; without it K1 writes the six rows it always wrote."""
    from arachne_tpu_torch.ops.cuda_extend import extend_cuda
    from arachne_tpu_torch.ops.problems import MAIN
    from arachne_tpu_torch.ops.sw_extend import extend_batch_torch

    if problems == "main":
        seed, B, qmax, tmax = MAIN["K1"]
        qs, ts, ws, h0s = extend_problems(seed, B, qmax, tmax, OPT)
    else:
        B, qmax, tmax = 70, 256, 400
        qs, ts, ws, h0s = edge_extend_problems(33, B, qmax, tmax)
    args = on_device(dev, qs, ts, qmax, tmax, ws, h0s)
    kw = dict(GAPS, zdrop=OPT.zdrop)
    got = extend_cuda(*args, mat_on(dev), **kw, count_cells=True)
    stats = {}
    want = extend_batch_torch(*args, mat_on(dev), **kw, stats=stats, count_cells=True)
    torch.cuda.synchronize()
    assert got.shape == (7, B) and torch.equal(got, want)
    assert int(got[6].sum()) == stats["cells"] > 0
    assert torch.equal(extend_cuda(*args, mat_on(dev), **kw), want[:6])


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_seed_kernels_count_the_plain_versions_rank_rows(dev, seeding_genome, wide):
    """S1's and S3's counters (``count_rows``: out_n's second row, each
    read's occ4 rows) equal smem_pass_torch's and pass3_torch's, read for
    read, for pass 1, pass 2's jobs and pass 3 of a superbatch of reads."""
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex
    from arachne_tpu_torch.ops.fm_seed import (
        pad_reads, pass1_seeds, pass2_inputs, pass3, pass3_torch, seed_buffers, smem_pass,
        smem_pass_torch,
    )

    idx, reads = seeding_genome
    fm = DeviceFMIndex.from_host(idx, dev, wide=wide)
    qs, qlens = pad_reads(reads, dev)
    R, L = qs.shape
    MAXC = MAXS = seed_buffers(L)
    ones = torch.ones(R, dtype=torch.int32, device=dev)
    p1 = (qs, qlens, ones * 0, ones, False, MAXC, MAXS)
    got1 = smem_pass(fm, *p1, count_rows=True)
    want1 = smem_pass_torch(fm, *p1, count_rows=True)
    assert got1[1].shape == (2, R) and all(torch.equal(a, b) for a, b in zip(got1, want1))
    out1, n1, ovf1 = (t.cpu().numpy() for t in smem_pass(fm, *p1))
    assert np.array_equal(n1, want1[1][0].cpu().numpy())
    _, jobs = pass1_seeds(out1, n1, ovf1.copy(), len(reads), OPT)
    _, *job_args = pass2_inputs(jobs, qs, qlens)
    assert len(job_args[0])
    p2 = (*job_args, True, MAXC, MAXS)
    got2, want2 = smem_pass(fm, *p2, count_rows=True), smem_pass_torch(fm, *p2, count_rows=True)
    assert all(torch.equal(a, b) for a, b in zip(got2, want2))
    p3 = (qs, qlens, OPT.min_seed_len, OPT.max_mem_intv, MAXS)
    stats = {}
    got3 = pass3(fm, *p3, count_rows=True)
    want3 = pass3_torch(fm, *p3, count_rows=True, stats=stats)
    assert all(torch.equal(a, b) for a, b in zip(got3, want3))
    assert int(got3[1][1].sum()) == stats["rank_rows"] > 0


def int16_top(qmax, opt=OPT):
    from arachne_tpu_torch.ops.sw_extend import int16_max_h0

    return int16_max_h0(qmax, opt.scoring_matrix(), opt.e_ins, o_del=opt.o_del,
                        e_del=opt.e_del, o_ins=opt.o_ins)


# other scores for K1 with int16 state: a custom matrix, and free
# insertions, under which a row's H is flat from its max to the band's end
# (the row max ties within a pair and across pairs)
INT16_SCORES = {
    "default": OPT,
    "custom matrix": MemOptions(a=2, b=3, o_del=5, e_del=2, o_ins=4, e_ins=1, zdrop=60),
    "free insertions": MemOptions(o_ins=0, e_ins=0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("scores", list(INT16_SCORES))
@pytest.mark.parametrize("qmax,tmax", [(33, 80), (64, 128), (128, 200), (192, 512), (256, 400),
                                       (384, 420), (512, 560), (768, 800), (1024, 1100)])
def test_extend16_kernel_matches_plain_and_int32(dev, qmax, tmax, scores):
    """K1 with int16 state on every strip width (qmax 33 to 1024: strips of
    2 to 32 columns), on the edge set of the int32 kernel's test: equal to
    the plain int16 version and to the int32 kernel, one launch of its own
    and none of the int32 kernel's for each call."""
    from arachne_tpu_torch.ops.cuda_extend import extend16_cuda, extend_cuda
    from arachne_tpu_torch.ops.sw_extend import extend_batch, extend_batch_torch

    opt = INT16_SCORES[scores]
    qs, ts, ws, h0s = edge_extend_problems(37 + qmax, 70, qmax, tmax)
    args = on_device(dev, qs, ts, qmax, tmax, ws, h0s)
    mat = torch.as_tensor(opt.scoring_matrix(), dtype=torch.int32, device=dev)
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
              zdrop=opt.zdrop)
    want32 = extend_cuda(*args, mat, **kw)
    before = (extend_cuda.launches, extend16_cuda.launches)
    got = extend_batch(*args, mat, **kw, wide_state=False, max_h0=int(h0s.max()))
    assert (extend_cuda.launches, extend16_cuda.launches) == (before[0], before[1] + 1)
    want16 = extend_batch_torch(*args, mat, **kw, wide_state=False)
    torch.cuda.synchronize()
    assert torch.equal(got, want16) and torch.equal(got, want32)


@pytest.mark.cuda
@pytest.mark.parametrize("qmax,tmax", [(64, 128), (1024, 1100)])
def test_extend16_kernel_at_the_edge_of_its_range(dev, qmax, tmax):
    """Every h0 at the largest value the range proof accepts: the int16
    kernel still equals the int32 kernel; one more is refused on the card,
    and neither kernel launches."""
    from arachne_tpu_torch.ops.cuda_extend import extend16_cuda, extend_cuda
    from arachne_tpu_torch.ops.sw_extend import extend_batch

    top = int16_top(qmax)
    qs, ts, ws, _ = edge_extend_problems(43 + qmax, 40, qmax, tmax)
    kw = dict(GAPS, zdrop=OPT.zdrop)
    for h0 in (top, top + 1):
        args = on_device(dev, qs, ts, qmax, tmax, ws, np.full(len(qs), h0, np.int32))
        want = extend_cuda(*args, mat_on(dev), **kw)
        before = (extend_cuda.launches, extend16_cuda.launches)
        if h0 == top:
            got = extend_batch(*args, mat_on(dev), **kw, wide_state=False)
            assert torch.equal(got, want)
            assert int(want[0].max()) > top
            continue
        for max_h0 in (None, h0):
            with pytest.raises(ValueError, match="int16"):
                extend_batch(*args, mat_on(dev), **kw, wide_state=False, max_h0=max_h0)
        assert (extend_cuda.launches, extend16_cuda.launches) == before


@pytest.mark.cuda
def test_local_kernel_matches_plain(dev):
    from arachne_tpu_torch.ops.cuda_local import local_cuda
    from arachne_tpu_torch.ops.sw_local import NEVER, local_sw_full, local_sw_full_torch

    qs, ts = local_problems(22, 200, 192, 768)
    B = len(qs)
    ends = np.where(np.arange(B) % 3 == 0, 40, NEVER).astype(np.int32)   # early stops
    args = on_device(dev, qs, ts, 192, 768, ends, np.full(B, 19, np.int32))
    kw = dict(GAPS, max_mat=1)
    before = local_cuda.launches
    got = local_sw_full(*args, mat_on(dev), **kw)
    assert local_cuda.launches == before + 1
    assert torch.equal(got, local_sw_full_torch(*args, mat_on(dev), **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("max_indel", [0, 1, 12])
def test_global_kernels_match_plain(dev, max_indel):
    from arachne_tpu_torch.ops import cuda_global
    from arachne_tpu_torch.ops.sw_global import (
        global_batch_torch, global_score, global_z, traceback, traceback_torch,
    )

    qs, ts, ws = global_problems(23 + max_indel, 128, 192, 320, max_indel)
    args = on_device(dev, qs, ts, 192, 320, ws)
    launchers = (cuda_global.global_score_cuda, cuda_global.global_z_cuda,
                 cuda_global.traceback_cuda)
    before = [f.launches for f in launchers]
    score = global_score(*args, mat_on(dev), **GAPS)
    score_z, z = global_z(*args, mat_on(dev), **GAPS)
    tb = traceback(z, *args[2:], max_steps=512)
    assert [f.launches for f in launchers] == [n + 1 for n in before]
    ref_score, ref_z = global_batch_torch(*args, mat_on(dev), **GAPS, want_z=True)
    assert torch.equal(score, ref_score) and torch.equal(score_z, ref_score)
    assert torch.equal(z, ref_z)
    ref_tb = traceback_torch(z, *args[2:], max_steps=512)
    assert all(torch.equal(a, b) for a, b in zip(tb, ref_tb))


@pytest.mark.cuda
@pytest.mark.parametrize("qmax,tmax", [(64, 96), (192, 320), (256, 400), (1024, 1100)])
def test_global_kernel_edges_match_plain(dev, qmax, tmax):
    """Strips of 2, 6, 8 and 32 columns on the edge set: w = 0, w = 1, a
    band wider than the query, tlen = 0, one-base queries, problems as
    large as qmax and tmax allow, the corner cell on the band's edge, and
    runs of 36-40 deletions and insertions; neighbouring warps hold
    different kinds.  The deletions leave K4's 32 x 32 window by its top
    edge; ksw.global2's walk turns out of an insertion after one step, so
    ``sideways_z``'s walk leaves it by its left edge.  The walk is checked
    whole, with a step count that is no multiple of 32, and cut short
    after 37 steps; the whole walks, and that of ``REPEAT_INSERTION``, give
    the scalar ksw.global2's CIGARs."""
    from arachne_tpu_torch.ops.cuda_global import (
        global_score_cuda, global_z_cuda, traceback_cuda,
    )
    from arachne_tpu_torch.align import ksw
    from arachne_tpu_torch.ops.sw_global import (
        decode_traceback_ops, global_batch_torch, traceback_torch,
    )

    B = 72
    qs, ts, ws = edge_global_problems(51 + qmax, B, qmax, tmax)
    args = on_device(dev, qs, ts, qmax, tmax, ws)
    score = global_score_cuda(*args, mat_on(dev), **GAPS)
    score_z, z = global_z_cuda(*args, mat_on(dev), **GAPS)
    want_score, want_z = global_batch_torch(*args, mat_on(dev), **GAPS, want_z=True)
    torch.cuda.synchronize()
    assert torch.equal(score, want_score) and torch.equal(score_z, want_score)
    assert torch.equal(z, want_z)
    kinds = np.arange(B) % len(EDGE_GLOBAL_KINDS)
    sc = want_score.cpu().numpy()
    assert (sc[kinds == EDGE_GLOBAL_KINDS.index("tlen=0")] == MINUS_INF).all()
    assert (sc[kinds == EDGE_GLOBAL_KINDS.index("corner on the band's edge")] > MINUS_INF).all()
    for max_steps in (37, qmax + tmax - 13, qmax + tmax):
        got = traceback_cuda(z, *args[2:], max_steps=max_steps)
        want = traceback_torch(z, *args[2:], max_steps=max_steps)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), max_steps
    ops = want[0].cpu().numpy()                   # the whole walks
    for kind, op, seen in (("deletion run", 2, True), ("insertion run", 1, False)):
        for b in np.nonzero(kinds == EDGE_GLOBAL_KINDS.index(kind))[0]:
            runs = "".join(map(str, ops[:, b])).split(str(op) * (33 if seen else 2))
            assert (len(runs) > 1) == seen, (kind, b)   # 33 deletions, never 2 insertions
    fi, fk = (x.cpu().numpy() for x in want[1:])
    for b in np.nonzero(kinds != EDGE_GLOBAL_KINDS.index("tlen=0"))[0]:   # no row: MINUS_INF
        cig = decode_traceback_ops(ops[:, b], int(fi[b]), int(fk[b]))
        assert (int(sc[b]), cig) == ksw.global2(qs[b], ts[b], MAT, OPT.o_del, OPT.e_del,
                                                OPT.o_ins, OPT.e_ins, int(ws[b])), b
    zs, *rest = (torch.from_numpy(a).to(dev) for a in sideways_z(41, qmax, tmax))
    got = traceback_cuda(zs, *rest, max_steps=qmax + tmax)
    want = traceback_torch(zs, *rest, max_steps=qmax + tmax)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if qmax >= 150:
        rq, rt, rw = repeat_insertion_problem()
        r_args = on_device(dev, rq, rt, qmax, tmax, rw)
        r_sc, r_z = global_z_cuda(*r_args, mat_on(dev), **GAPS)
        r_ops, r_fi, r_fk = (x.cpu().numpy() for x in traceback_cuda(r_z, *r_args[2:],
                                                                     max_steps=qmax + tmax))
        assert (int(r_sc[0]), decode_traceback_ops(r_ops[:, 0], int(r_fi[0]), int(r_fk[0]))) == \
            ksw.global2(rq[0], rt[0], MAT, OPT.o_del, OPT.e_del, OPT.o_ins, OPT.e_ins, int(rw[0]))


@pytest.mark.cuda
def test_global_kernel_odd_widths_match_plain(dev):
    """A qmax that no store width divides and that the strips overhang
    (qmax 100: strips of 4 cover 128 columns), so the direction bytes go
    out one by one and stop at the row's end."""
    from arachne_tpu_torch.ops.cuda_global import global_z_cuda, traceback_cuda
    from arachne_tpu_torch.ops.sw_global import global_batch_torch, traceback_torch

    for qmax, tmax in ((100, 131), (50, 77), (321, 333)):
        qs, ts, ws = global_problems(61 + qmax, 41, qmax, tmax, 12)   # a block of one warp
        args = on_device(dev, qs, ts, qmax, tmax, ws)
        score, z = global_z_cuda(*args, mat_on(dev), **GAPS)
        want_score, want_z = global_batch_torch(*args, mat_on(dev), **GAPS, want_z=True)
        assert torch.equal(score, want_score) and torch.equal(z, want_z)
        got = traceback_cuda(z, *args[2:], max_steps=qmax + tmax)
        want = traceback_torch(z, *args[2:], max_steps=qmax + tmax)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_engine(dev):
    """TorchEngine with the kernels gives the same barcode results as with
    their plain versions, through the whole superbatch workflow."""
    from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
    from arachne_tpu_torch.rfa import FastQRecordView
    from arachne_tpu_torch.rfa.engine import process_barcodes
    from arachne_tpu_torch.ops.engine import TorchEngine

    rng = np.random.default_rng(24)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30_000)])
    packed = pack_reference([("chr1", "", seq)])
    idx = FMIndex(packed, build_fmindex(packed))
    fwd = unpack_2bit(packed.pac, 0, packed.l_pac)
    bases = np.array(list("ACGT"))
    sets = []
    for bi in range(4):
        recs = []
        for i in range(8):
            pos = int(rng.integers(0, len(fwd) - 400))
            r1 = fwd[pos : pos + 150].copy()
            r2 = (3 - fwd[pos + 200 : pos + 350][::-1]).astype(np.uint8)
            r1[rng.integers(0, 150, 2)] = rng.integers(0, 4, 2)
            if i % 3 == 0:
                r1 = np.concatenate([r1[:60], r1[62:], fwd[pos + 150 : pos + 152]])
            recs.append(FastQRecordView(
                read1="".join(bases[r1]).encode(), qual1=b"I" * 150,
                read2="".join(bases[r2]).encode(), qual2=b"I" * 150,
                barcode=f"B{bi:02d}".encode(), valid=True, read_info=f"b{bi}_{i}",
                read_group="",
            ))
        sets.append((recs, True))
    cfg = ArachneConfig()

    def snap(results):
        return [[[(a.contig, a.pos, a.score, a.mapq, tuple(a.cigar)) for a in al]
                 for al in r.alignments] for r in results]

    on_card = snap(process_barcodes(idx, cfg, sets, TorchEngine(idx, cfg, dev)))
    on_cpu = snap(process_barcodes(idx, cfg, sets, TorchEngine(idx, cfg, "cpu")))
    assert on_card == on_cpu


@pytest.fixture(scope="module")
def seeding_genome():
    """A 40 kbp random genome with a planted repeat, its index and 512
    reads of 150 bp from it."""
    from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
    from arachne_tpu_torch.seeding_bench import sample_reads

    rng = np.random.default_rng(25)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40_000)])
    seq = seq[:9000] + seq[2000:4000] + seq[9000:]
    packed = pack_reference([("chr1", "", seq)])
    idx = FMIndex(packed, build_fmindex(packed))
    return idx, sample_reads(unpack_2bit(packed.pac, 0, packed.l_pac), 512, seed=26)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_rank_kernel_matches_plain(dev, seeding_genome, wide):
    from arachne_tpu_torch.ops.cuda_rank import rank_cuda
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, occ4_device, occ4_torch
    from arachne_tpu_torch.seeding_bench import parity_rows, synthetic_table

    idx, _ = seeding_genome
    tables = [DeviceFMIndex.from_host(idx, dev, wide=wide)]
    # random words and counts over 4096 blocks, and over 2^20 blocks (64 MB:
    # beyond the 50 MB L2, where K5 takes a group of lanes per query)
    if wide:
        tables += [synthetic_table(dev, 4096), synthetic_table(dev, 1 << 20)]
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        n_blocks = 1 << 20
        tables.append(DeviceFMIndex.from_planar(
            torch.randint(0, n_blocks * 128, (n_blocks + 1, 4), dtype=torch.int32, device=dev,
                          generator=g),
            torch.randint(-(1 << 31), 1 << 31, (n_blocks * 8,), dtype=torch.int32, device=dev,
                          generator=g),
            torch.tensor([0, 1 << 25, 1 << 26, 3 << 25, 1 << 27], dtype=torch.int32, device=dev),
            n_blocks * 128 // 3, n_blocks * 128, n_blocks * 64))
    for fm in tables:
        # a whole number of blocks of 64 queries, then a last block of a
        # few groups, and one query (the edge rows come first)
        for n in (4096, 4089, 1):
            ks = parity_rows(fm, 4096)[:n]
            before = rank_cuda.launches
            got = occ4_device(fm, ks)
            assert rank_cuda.launches == before + 1
            assert torch.equal(got, occ4_torch(fm, ks))
            if fm.seq_len == idx.seq_len:
                assert np.array_equal(got.cpu().numpy(),
                                      idx.occ4(ks.cpu().numpy().astype(np.int64)))


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("bufs", [(12, 48), (2, 4), None], ids=["12x48", "2x4", "sized"])
def test_seed_kernels_match_plain(dev, seeding_genome, wide, bufs):
    from arachne_tpu_torch.ops.cuda_seed import pass3_cuda, smem_pass_cuda
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex
    from arachne_tpu_torch.ops.fm_seed import (
        pad_reads, pass1_seeds, pass2_inputs, pass3, pass3_torch, seed_buffers, smem_pass,
        smem_pass_torch,
    )

    idx, reads = seeding_genome
    fwd = seeding_genome_fwd(idx)
    # reads from the planted repeat carry many intervals backward, in counts
    # that the kernel's group of SEED_GROUP does not divide; then the edge
    # reads: all N, one base, and 192 bases (qlen = L once padded)
    reads = (reads[:224] + [fwd[9000 + 37 * k : 9150 + 37 * k].copy() for k in range(29)]
             + [np.full(150, 4, np.uint8), fwd[500:501].copy(), fwd[7000:7192].copy()])
    fm = DeviceFMIndex.from_host(idx, dev, wide=wide)
    # the small buffers make reads spin to the step cap: keep L at 64 there
    qs, qlens = pad_reads([r[:60] if bufs == (2, 4) else r for r in reads], dev)
    R, L = qs.shape
    # None: the buffers collect_seeds_device gives the kernels
    MAXC, MAXS = bufs or (seed_buffers(L),) * 2
    rng = np.random.default_rng(27)
    pivots = rng.integers(0, 1 << 20, R) % np.maximum(qlens.cpu().numpy(), 1)
    pivots = torch.from_numpy(pivots.astype(np.int32)).to(dev)
    minis = torch.from_numpy(rng.integers(1, 4, R).astype(np.int32)).to(dev)
    zeros, ones = torch.zeros_like(pivots), torch.ones_like(pivots)
    cases = [(False, qs, qlens, zeros, ones), (True, qs, qlens, pivots, minis)]
    for k, (single_sweep, q, ql, piv, mi) in enumerate(cases):
        before = smem_pass_cuda.launches
        got = smem_pass(fm, q, ql, piv, mi, single_sweep, MAXC, MAXS)
        assert smem_pass_cuda.launches == before + 1
        want = smem_pass_torch(fm, q, ql, piv, mi, single_sweep, MAXC, MAXS)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert bool(got[2].any()) == (MAXC == 2)
        if k == 0:   # pass 2 as collect_seeds_device runs it: every job at once
            out1, n1, ovf1 = (t.cpu().numpy() for t in got)
            _, jobs = pass1_seeds(out1, n1, ovf1.copy(), len(reads), OPT)
            _, *job_args = pass2_inputs(jobs, qs, qlens)
            if len(job_args[0]):
                cases.append((True, *job_args))
    before = pass3_cuda.launches
    got = pass3(fm, qs, qlens, OPT.min_seed_len, OPT.max_mem_intv, MAXS)
    assert pass3_cuda.launches == before + 1
    want = pass3_torch(fm, qs, qlens, OPT.min_seed_len, OPT.max_mem_intv, MAXS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def seeding_genome_fwd(idx):
    from arachne_tpu_torch.index import unpack_2bit

    return unpack_2bit(idx.packed.pac, 0, idx.packed.l_pac)


@pytest.mark.cuda
@pytest.mark.parametrize("bad_table", ["on 16 bytes", "on 4 bytes", "planar shape"])
def test_seed_launchers_refuse_misaligned_tables(dev, seeding_genome, bad_table):
    """rank.cuh reads a record as one aligned 64-byte line: a record table
    that starts 16 or 4 bytes into its allocation, or one shaped as the
    planar counts (n, 4), is refused by every launcher before it
    launches."""
    import dataclasses

    from arachne_tpu_torch.ops.cuda_rank import rank_cuda
    from arachne_tpu_torch.ops.cuda_seed import pass3_cuda, smem_pass_cuda
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex
    from arachne_tpu_torch.ops.fm_seed import pad_reads

    idx, reads = seeding_genome
    fm = DeviceFMIndex.from_host(idx, dev)
    t = fm.table
    if bad_table == "planar shape":
        bad, match = dataclasses.replace(fm, table=fm.occ.contiguous()), "shape"
    else:
        shift = 4 if bad_table == "on 16 bytes" else 1
        buf = torch.empty(t.numel() + shift, dtype=t.dtype, device=dev)
        shifted = buf[shift:].view(t.shape)
        shifted.copy_(t)
        bad, match = dataclasses.replace(fm, table=shifted), "not on 64 bytes"
    qs, qlens = pad_reads(reads[:64], dev)
    ones = torch.ones(64, dtype=torch.int32, device=dev)
    before = (rank_cuda.launches, smem_pass_cuda.launches, pass3_cuda.launches)
    for call in (lambda: rank_cuda(bad, qlens),
                 lambda: smem_pass_cuda(bad, qs, qlens, ones * 0, ones, False, 12, 48),
                 lambda: pass3_cuda(bad, qs, qlens, 19, 20, 48)):
        with pytest.raises(ValueError, match=match):
            call()
    assert (rank_cuda.launches, smem_pass_cuda.launches, pass3_cuda.launches) == before


@pytest.mark.cuda
def test_collect_seeds_device_on_card_matches_native(dev, seeding_genome):
    from arachne_tpu_torch.align.smem_native import collect_seeds_native, smem_available
    from arachne_tpu_torch.ops import fm_seed
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex

    if not smem_available():
        pytest.skip("the native host collector did not load")
    idx, reads = seeding_genome
    fm = DeviceFMIndex.from_host(idx, dev)
    before = fm_seed.overflow_redos
    got = fm_seed.collect_seeds_device(reads, OPT, fm)
    assert got == collect_seeds_native(idx, reads, OPT)
    assert fm_seed.overflow_redos == before
    # small buffers: overflowing reads are redone on the card and counted
    got = fm_seed.collect_seeds_device(reads[:64], OPT, fm, MAXC=2, MAXS=4)
    assert fm_seed.overflow_redos > before
    assert got == collect_seeds_native(idx, reads[:64], OPT)


@pytest.mark.cuda
def test_engine_on_the_card_seeds_on_it_by_default(dev, seeding_genome, monkeypatch):
    """With no argument and no ARACHNE_DEVICE_SEEDING, a TorchEngine on the
    card has the index's rank tables (device seeding, as the reference
    seeds on its chip); "0" still gives host seeding."""
    from arachne_tpu_torch.ops.engine import TorchEngine
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex

    idx, _ = seeding_genome
    monkeypatch.delenv("ARACHNE_DEVICE_SEEDING", raising=False)
    eng = TorchEngine(idx, ArachneConfig(), device=dev)
    assert isinstance(eng.dfm, DeviceFMIndex) and eng.dfm.device.type == "cuda"
    monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "0")
    assert TorchEngine(idx, ArachneConfig(), device=dev).dfm is None


@pytest.mark.cuda
def test_batchers_over_two_devices_equal_one(dev):
    """Chunks round-robined over [dev, dev] (ops/devicepool.py, pinned):
    the three batchers give what they give on [dev], and K1-K4 launch."""
    from arachne_tpu_torch.ops import devicepool
    from arachne_tpu_torch.ops.cuda_extend import extend_cuda
    from arachne_tpu_torch.ops.cuda_global import global_z_cuda, traceback_cuda
    from arachne_tpu_torch.ops.cuda_local import local_cuda
    from torch_pool_util import run_batchers

    dev = torch.device("cuda", torch.cuda.current_device())
    with devicepool.pinned([dev]):
        one = run_batchers(dev)
    launchers = (extend_cuda, local_cuda, global_z_cuda, traceback_cuda)
    before = [f.launches for f in launchers]
    with devicepool.pinned([dev, dev]):
        two = run_batchers(dev)
    assert two == one
    assert all(f.launches > b for f, b in zip(launchers, before))


@pytest.mark.cuda
def test_seed_kernels_on_rows_past_2_31(dev):
    """S1 (pass 1, and one sweep from a random pivot as pass 2 runs it) and
    S3 on a synthetic wide table of 2^31 + 2^27 rows: the int64 arithmetic
    of the state machines above 2^31 against their plain versions, out,
    out_n and the overflow flags alike (chip_smoke.py phase 7d)."""
    from arachne_tpu_torch.ops.cuda_seed import pass3_cuda, smem_pass_cuda
    from arachne_tpu_torch.seeding_bench import synthetic_table, wide_seeding_parity

    fm = synthetic_table(dev, n_blocks=(1 << 24) + (1 << 20))
    assert fm.seq_len > 1 << 31 and fm.idt == torch.int64
    before = smem_pass_cuda.launches, pass3_cuda.launches
    assert wide_seeding_parity(fm, 256) > 0
    assert (smem_pass_cuda.launches, pass3_cuda.launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_rank_kernel_on_an_index_beyond_the_l2(dev, tmp_path):
    """K5 on the int32 tables of a real index whose record table exceeds
    the L2 (a 56 Mbp genome of make_scale_genome, sampled suffix array), so
    that it takes its four-lane path: equal to the host index's occ4 and to
    the plain version, edge rows included (chip_smoke.py phase 7c)."""
    from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, parse_fasta
    from arachne_tpu_torch.ops.cuda_rank import rank_cuda
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, occ4_device, occ4_torch
    from arachne_tpu_torch.scripts.make_scale_genome import write_contig
    from arachne_tpu_torch.seeding_bench import parity_rows

    fasta = tmp_path / "g.fa"
    rng = np.random.default_rng(7)
    with open(fasta, "wb") as fh:
        for c in range(4):
            write_contig(fh, f"chr{c + 1}", 14_000_000, rng)
    packed = pack_reference(parse_fasta(str(fasta)))
    idx = FMIndex(packed, build_fmindex(packed, keep_full_sa=False))
    fm = DeviceFMIndex.from_host(idx, dev)
    assert fm.idt == torch.int32
    assert DeviceFMIndex.table_bytes(idx) > torch.cuda.get_device_properties(dev).L2_cache_size
    ks = parity_rows(fm, 4096)
    before = rank_cuda.launches
    got = occ4_device(fm, ks)
    assert rank_cuda.launches == before + 1
    assert torch.equal(got, occ4_torch(fm, ks))
    assert np.array_equal(got.cpu().numpy(), idx.occ4(ks.cpu().numpy().astype(np.int64)))


def beyond_l2_table(dev, wide):
    """Random words and counts over 2^20 blocks (64 MB: beyond the 50 MB
    L2, where K5 takes a group of lanes per query)."""
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex
    from arachne_tpu_torch.seeding_bench import synthetic_table

    n_blocks = 1 << 20
    if wide:
        return synthetic_table(dev, n_blocks)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    return DeviceFMIndex.from_planar(
        torch.randint(0, n_blocks * 128, (n_blocks + 1, 4), dtype=torch.int32, device=dev,
                      generator=g),
        torch.randint(-(1 << 31), 1 << 31, (n_blocks * 8,), dtype=torch.int32, device=dev,
                      generator=g),
        torch.tensor([0, 1 << 25, 1 << 26, 3 << 25, 1 << 27], dtype=torch.int32, device=dev),
        n_blocks * 128 // 3, n_blocks * 128, n_blocks * 64)


def sharded_cases(dev, fm):
    """fm's table split into 2 and 3 shards, all on ``dev`` ([card, card],
    [card, card, card]: how one card runs the mode), and across
    every visible card when there are several (ranges on other cards read
    over NVLink)."""
    from arachne_tpu_torch.ops.fm_rank import ShardedFMIndex

    cases = [ShardedFMIndex(fm, [dev] * n) for n in (2, 3)]
    if torch.cuda.device_count() > 1:
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        cases.append(ShardedFMIndex(fm, cards, device=dev))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_sharded_rank_kernel_matches_flat_and_plain(dev, seeding_genome, wide):
    """K5's sharded entry point (four lanes a query beyond the L2, one
    thread within) against the flat kernel and the plain versions on both
    tables, and the flat kernel's output against the host index's occ4:
    the flat instantiation is unchanged by the templated record access."""
    from arachne_tpu_torch.ops.cuda_rank import rank_cuda, rank_sharded_cuda
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, occ4_device, occ4_torch
    from arachne_tpu_torch.seeding_bench import parity_rows

    dev = torch.device("cuda", torch.cuda.current_device())
    idx, _ = seeding_genome
    for fm in (DeviceFMIndex.from_host(idx, dev, wide=wide), beyond_l2_table(dev, wide)):
        ks = parity_rows(fm, 4096)
        before = rank_cuda.launches
        flat = occ4_device(fm, ks)
        assert rank_cuda.launches == before + 1
        assert torch.equal(flat, occ4_torch(fm, ks))
        if fm.seq_len == idx.seq_len:
            assert np.array_equal(flat.cpu().numpy(), idx.occ4(ks.cpu().numpy().astype(np.int64)))
        for sharded in sharded_cases(dev, fm):
            for n in (4096, 4089, 1):
                before = rank_cuda.launches, rank_sharded_cuda.launches
                got = occ4_device(sharded, ks[:n])
                assert (rank_cuda.launches, rank_sharded_cuda.launches) == (before[0],
                                                                            before[1] + 1)
                assert got.dtype == flat.dtype and torch.equal(got, flat[:n])
            assert torch.equal(occ4_torch(sharded, ks), flat)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_sharded_seed_kernels_match_flat_and_plain(dev, seeding_genome, wide):
    """S1 (pass 1, then every pass-2 job in one launch) and S3 through the
    sharded entry points against the flat kernels and the plain versions
    on the sharded table, with the main path's buffers and with ones that
    overflow."""
    from arachne_tpu_torch.ops.cuda_seed import (
        pass3_cuda, pass3_sharded_cuda, smem_pass_cuda, smem_pass_sharded_cuda,
    )
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex
    from arachne_tpu_torch.ops.fm_seed import (
        pad_reads, pass1_seeds, pass2_inputs, pass3, pass3_torch, seed_buffers, smem_pass,
        smem_pass_torch,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    idx, reads = seeding_genome
    fm = DeviceFMIndex.from_host(idx, dev, wide=wide)
    counts = (smem_pass_cuda, smem_pass_sharded_cuda, pass3_cuda, pass3_sharded_cuda)
    for small in (False, True):
        # the small buffers make reads spin to the step cap: keep L at 64 there
        qs, qlens = pad_reads([r[:60] if small else r for r in reads[:256]], dev)
        R, L = qs.shape
        zeros = torch.zeros(R, dtype=torch.int32, device=dev)
        MAXC, MAXS = (2, 4) if small else (seed_buffers(L),) * 2
        p1 = (qs, qlens, zeros, zeros + 1, False, MAXC, MAXS)
        flat1 = smem_pass(fm, *p1)
        out1, n1, ovf1 = (t.cpu().numpy() for t in flat1)
        _, jobs = pass1_seeds(out1, n1, ovf1.copy(), R, OPT)
        _, *job_args = pass2_inputs(jobs, qs, qlens)
        p2 = (*job_args, True, MAXC, MAXS)
        flat2 = smem_pass(fm, *p2)
        p3 = (qs, qlens, OPT.min_seed_len, OPT.max_mem_intv, MAXS)
        flat3 = pass3(fm, *p3)
        assert bool(flat1[2].any()) == (MAXC == 2)
        for sharded in sharded_cases(dev, fm):
            before = [f.launches for f in counts]
            got = (smem_pass(sharded, *p1), smem_pass(sharded, *p2), pass3(sharded, *p3))
            # no pass-2 job, no launch (a read that overflowed pass 1 has none)
            jobs_launch = int(len(job_args[0]) > 0)
            assert [f.launches - b for f, b in zip(counts, before)] == [0, 1 + jobs_launch, 0, 1]
            want = (smem_pass_torch(sharded, *p1), smem_pass_torch(sharded, *p2),
                    pass3_torch(sharded, *p3))
            for g, f, w in zip(got, (flat1, flat2, flat3), want):
                assert all(torch.equal(a, b) for a, b in zip(g, f))
                assert all(torch.equal(a, b) for a, b in zip(g, w))


@pytest.mark.cuda
def test_sharded_collect_seeds_matches_native(dev, seeding_genome):
    """collect_seeds_device over a table sharded on [card, card]: the host
    collector's seeds, no read redone."""
    from arachne_tpu_torch.align.smem_native import collect_seeds_native, smem_available
    from arachne_tpu_torch.ops import fm_seed
    from arachne_tpu_torch.parallel.mesh import ShardedFMTables

    if not smem_available():
        pytest.skip("the native host collector did not load")
    dev = torch.device("cuda", torch.cuda.current_device())
    idx, reads = seeding_genome
    tab = ShardedFMTables(idx, [dev, dev])
    before = fm_seed.overflow_redos
    assert fm_seed.collect_seeds_device(reads, OPT, tab) == collect_seeds_native(idx, reads, OPT)
    assert fm_seed.overflow_redos == before
    ks = np.arange(-1, idx.seq_len + 1, 7, dtype=np.int64)
    np.testing.assert_array_equal(tab.occ4(ks), idx.occ4(ks))


@pytest.mark.cuda
def test_sharded_launchers_refuse_tables_they_cannot_read(dev, seeding_genome):
    """A shard on the CPU, a shard misaligned, and a shard on a card with no
    peer access: refused before any launch."""
    from arachne_tpu_torch.ops import cuda_rank
    from arachne_tpu_torch.ops.cuda_rank import rank_sharded_cuda
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, ShardedFMIndex

    dev = torch.device("cuda", torch.cuda.current_device())
    idx, _ = seeding_genome
    fm = DeviceFMIndex.from_host(idx, dev)
    good = ShardedFMIndex(fm, [dev, dev])
    ks = torch.arange(-1, 100, dtype=torch.int32, device=dev)

    def with_shards(shards):
        bad = copy.copy(good)
        bad.shards = shards
        return bad.on(dev)

    on_cpu = with_shards(good.shards[:1] + (good.shards[1].cpu(),))
    buf = torch.empty(good.shards[1].numel() + 4, dtype=torch.int32, device=dev)
    shifted = buf[4:].view(good.shards[1].shape)
    shifted.copy_(good.shards[1])
    misaligned = with_shards((good.shards[0], shifted))
    cases = [(on_cpu, "expected a CUDA device"), (misaligned, "not on 64 bytes")]
    if torch.cuda.device_count() > 1:
        other = torch.device("cuda", (dev.index + 1) % torch.cuda.device_count())
        far = ShardedFMIndex(fm, [dev, other], device=dev)
        cuda_rank._peers.discard((dev.index, other.index))
        cases.append((far, "no peer access"))
    before = rank_sharded_cuda.launches
    for bad, match in cases:
        with pytest.raises(ValueError, match=match):
            rank_sharded_cuda(bad, ks)
    assert rank_sharded_cuda.launches == before
    if torch.cuda.device_count() > 1:
        cuda_rank.enable_peer_access(dev, other)


@pytest.mark.cuda
def test_bench_gcups_line_on_card(dev):
    from arachne_tpu_torch import bench
    from arachne_tpu_torch.ops.cuda_extend import extend_cuda

    before = extend_cuda.launches
    line = bench.gcups_line(dev, B=512, reps=5)
    assert line["metric"] == "seed_extension_DP_GCUPS" and line["correct"] is True
    d = line["detail"]
    assert d["batch"] == 512 and d["cells"] == 512 * bench.band_cells(100, 250, d["band"])
    assert 0 < d["cells_needed"] <= d["cells"]
    assert line["value"] > 0 and d["batch_ms"] > 0 and line["vs_baseline"] > 1
    assert torch.cuda.get_device_name(dev) in d["device"]
    assert extend_cuda.launches > before


def compute_sanitizer() -> str:
    """The toolkit's compute-sanitizer, beside the nvcc that builds the kernels."""
    from arachne_tpu_torch.device import nvcc_path

    nvcc = nvcc_path()
    path = os.path.join(os.path.dirname(nvcc), "compute-sanitizer") if nvcc else None
    if path is None or not os.path.exists(path):
        pytest.fail(f"compute-sanitizer not found beside nvcc ({nvcc})")
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("tool", ["memcheck", "racecheck", "synccheck"])
def test_kernels_under_compute_sanitizer(dev, tool):
    """One small launch of every hand-written kernel (tests/torch_sanitize_util.py)
    in a subprocess under compute-sanitizer: memcheck on all of them,
    racecheck and synccheck on those that use shared memory.  The torch
    allocator's cache is off, so that every tensor is an allocation of its
    own whose bounds memcheck sees.  Any report, or a tool that does not
    start, fails the test with the tool's own words."""
    import torch_sanitize_util as su
    from arachne_tpu_torch.ops.build import get_lib

    get_lib()   # nvcc outside the tool; the subprocess loads the library built here
    names = list(su.KERNELS) if tool == "memcheck" else list(su.SHARED_MEMORY)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    cmd = [compute_sanitizer(), "--tool", tool, "--error-exitcode", "99",
           sys.executable, su.__file__, *names]
    p = subprocess.run(cmd, env=env, cwd=root, capture_output=True, text=True, timeout=600)
    # the tool's first lines say why it stopped; a fault's report ends its output
    out = p.stdout if len(p.stdout) <= 8000 else f"{p.stdout[:3000]}\n...\n{p.stdout[-5000:]}"
    words = f"exit code {p.returncode}\nstdout:\n{out}\nstderr:\n{p.stderr[-3000:]}"
    assert p.returncode == 0, words
    assert all(f"launched {name}" in p.stdout for name in names), words
    # the tool's own summary: it ran and instrumented the launches
    assert re.search(r"(ERROR SUMMARY: 0 errors|RACECHECK SUMMARY: 0 hazards)",
                     p.stdout + p.stderr), words
