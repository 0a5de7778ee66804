"""The port's tracer (arachne_tpu_torch/runtime/timers.py) and what reads
it, on the CPU: parent ids, superbatch ids across the worker pool, the
clocks, the off switch, the driver's and writer's spans in a tiny
``align --engine torch-cpu`` run, the ``--profile-dir`` export; the work
counters of the plain S1, S3 and K1 against counts of the scalar code;
the benchmark's readers of the spans (h100_bench/spans.py and six
metrics/*.py)."""

import contextlib
import filecmp
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from arachne_tpu_torch.runtime.timers import TIMERS, StageTimers
from torch_cli_util import REPO, make_fixture

torch.set_num_threads(1)

# several superbatches on the torch-cpu path: about five barcode sets each
READS_PER_BATCH = 20
# the spans with no parent in an align run: a worker's superbatch, the
# main thread's and the writer's own
ROOTS = {"superbatch", "driver.parse", "driver.wait", "driver.emit_blocked", "writer.idle",
         "io.write"}


def test_nested_stages_and_spans_give_parent_ids():
    t = StageTimers()
    t.trace(True)
    with t.stage("outer"):
        with t.span("inner", k=1):
            with t.stage("leaf"):
                pass
        with t.stage("sibling"):
            pass
    with t.span("root2"):
        pass
    t.trace(False)
    spans = t.spans()
    by = {r.name: r for r in spans}
    assert len(spans) == len({r.id for r in spans}) == 5
    assert by["outer"].parent is None and by["root2"].parent is None
    assert by["inner"].parent == by["outer"].id
    assert by["leaf"].parent == by["inner"].id
    assert by["sibling"].parent == by["outer"].id
    assert by["inner"].attrs == {"k": 1}
    # spans add nothing to the stage sums
    assert sorted(t.seconds) == ["leaf", "outer", "sibling"]


def test_a_workers_stages_fetches_and_launches_carry_its_superbatch(monkeypatch):
    """Through a ThreadPoolExecutor, as cli.run_align runs superbatches:
    every span a worker opens inside ``in_superbatch`` carries the id, and
    ``build.launch`` is a span named after its entry point, child of the
    stage that launched it."""
    from arachne_tpu_torch.ops import build

    def fake():
        pass

    fake.launches = 0
    monkeypatch.setattr(build, "get_lib", lambda: SimpleNamespace(arachne_fake=lambda *a: 0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))

    def work(sb):
        with TIMERS.in_superbatch(sb):
            with TIMERS.span("superbatch", sets=1):
                with TIMERS.stage("extend.device"):
                    build.launch(fake, "arachne_fake", torch.device("cpu"), 1, 2, problems=7)
                    launch = TIMERS.take_launch()
                    with TIMERS.span("fetch", family="extend"):
                        time.sleep(0.002)
        return launch

    TIMERS.trace(True)
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            launches = list(pool.map(work, range(6)))
        assert TIMERS.take_launch() is None          # none on this thread
    finally:
        TIMERS.trace(False)
    spans = TIMERS.spans()
    by_id = {r.id: r for r in spans}
    assert len(spans) == 4 * 6 and fake.launches == 6
    assert len({r.thread for r in spans}) == 2
    for r in spans:
        assert r.thread.startswith("ThreadPoolExecutor") and r.superbatch is not None
        if r.name == "superbatch":
            assert r.parent is None
        else:
            assert by_id[r.parent].superbatch == r.superbatch
    for sb, rec in enumerate(launches):
        assert rec.name == "arachne_fake" and rec.superbatch == sb
        assert rec.attrs == {"device": "cpu", "problems": 7}
        assert by_id[rec.parent].name == "extend.device"


def test_span_times_are_unix_ns_and_cpu_never_exceeds_wall():
    t = StageTimers()
    before = time.time_ns()
    t.trace(True)
    with t.stage("busy"):
        end = time.perf_counter() + 0.03
        while time.perf_counter() < end:
            pass
    with t.span("idle"):
        time.sleep(0.03)
    t.count("depth", 3)
    t.trace(False)
    after = time.time_ns()
    by = {r.name: r for r in t.spans()}
    for r in by.values():
        assert before <= r.t0 <= r.t1 <= after
        assert 0 <= r.cpu1 - r.cpu0 <= r.t1 - r.t0
    assert (by["busy"].cpu1 - by["busy"].cpu0) > 0.5 * (by["busy"].t1 - by["busy"].t0)
    assert (by["idle"].cpu1 - by["idle"].cpu0) < 0.5 * (by["idle"].t1 - by["idle"].t0)
    (name, ns, value), = t.counters()
    assert name == "depth" and value == 3 and by["idle"].t1 <= ns <= after


def test_with_the_trace_off_nothing_is_recorded_and_the_sums_are_the_same():
    def run(t):
        for _ in range(3):
            with t.stage("a"):
                with t.span("s", x=1):
                    pass
                with t.stage("b"):
                    pass
        with t.launch("arachne_x", problems=1) as rec:
            pass
        t.count("c", 1)
        return rec

    on, off = StageTimers(), StageTimers()
    on.trace(True)
    assert run(on) is not None
    on.trace(False)
    assert run(off) is None
    assert dict(on.calls) == dict(off.calls) == {"a": 3, "b": 3}
    assert sorted(on.seconds) == sorted(off.seconds)
    assert len(on.spans()) == 10 and len(on.counters()) == 1
    assert off.spans() == [] and off.counters() == [] and off.anchor is None
    assert off._threads == [] and off.take_launch() is None
    # switched off, the trace keeps its records and adds none
    run(on)
    assert len(on.spans()) == 10
    # switched on again, it starts a new trace
    on.trace(True)
    run(on)
    on.trace(False)
    assert len(on.spans()) == 10


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_fixture(tmp_path_factory.mktemp("torch_trace"))


def align_args(fx, out, threads=1):
    return ["align", out, fx["ref"], fx["r1"], fx["r2"], "--engine", "torch-cpu", "--sam",
            "-t", str(threads)]


def traced_align(fx, out, threads=1):
    from arachne_tpu_torch.cli import main

    TIMERS.trace(True)
    try:
        main(align_args(fx, out, threads))
    finally:
        TIMERS.trace(False)
    return TIMERS.spans()


def test_emit_blocked_only_where_the_writers_full_queue_blocks(fx, tmp_path, monkeypatch):
    """``driver.emit_blocked`` is the time a put to the writer's queue
    blocks: none where the queue has room; with the writer held back on its
    first set and a queue of one, the main thread blocks until it takes the
    next.  Holding the writer back changes no record."""
    from arachne_tpu_torch import cli
    from arachne_tpu_torch.io.bam import BAMWriters

    monkeypatch.setenv("ARACHNE_TEST_READS_PER_BATCH", str(READS_PER_BATCH))
    free = traced_align(fx, str(tmp_path / "free"))
    assert not [r for r in free if r.name == "driver.emit_blocked"]
    assert [r for r in free if r.name == "writer.idle" and r.thread == "bam-writer"]

    dump = BAMWriters.dump
    held = []

    def held_back(self, *a, **k):
        if not held:
            held.append(time.time_ns())
            time.sleep(0.5)
        return dump(self, *a, **k)

    monkeypatch.setattr(BAMWriters, "dump", held_back)
    monkeypatch.setattr(cli, "EMIT_QUEUE_ITEMS", 1)
    spans = traced_align(fx, str(tmp_path / "held"))
    blocked = [r for r in spans if r.name == "driver.emit_blocked"]
    assert blocked and held
    assert all(r.thread == "MainThread" and r.parent is None for r in blocked)
    assert max(r.t1 - r.t0 for r in blocked) > 0.1e9
    assert max(v for n, _, v in TIMERS.counters() if n == "emit_q.depth") <= 1
    for fn in os.listdir(tmp_path / "free"):
        assert filecmp.cmp(tmp_path / "free" / fn, tmp_path / "held" / fn, shallow=False), fn


def test_profile_dir_writes_the_spans_beside_the_profilers_trace(fx, tmp_path, monkeypatch):
    """``align --profile-dir`` writes ``arachne.spans.json``: Chrome trace
    events on the profiler trace's base time, every span but the roots
    with a parent, every span of a worker with its superbatch's id."""
    from arachne_tpu_torch.cli import main

    monkeypatch.setenv("ARACHNE_TEST_READS_PER_BATCH", str(READS_PER_BATCH))
    prof = tmp_path / "prof"
    before = time.time_ns()
    main(align_args(fx, str(tmp_path / "out"), threads=2) + ["--profile-dir", str(prof)])
    after = time.time_ns()
    assert not TIMERS.tracing
    with open(prof / "arachne.trace.json") as fh:
        trace = json.load(fh)
    with open(prof / "arachne.spans.json") as fh:
        spans = json.load(fh)
    assert spans["baseTimeNanoseconds"] == trace.get("baseTimeNanoseconds", 0)
    xs = [e for e in spans["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"superbatch", "driver.parse", "driver.wait", "writer.idle", "io.write", "fetch",
            "extend.device", "cigar", "rfa.host"} <= names
    by_id = {e["args"]["id"]: e for e in xs}
    threads = {e["tid"]: e["args"]["name"] for e in spans["traceEvents"] if e["ph"] == "M"}
    for e in xs:
        a = e["args"]
        assert a["cpu_us"] <= e["dur"] + 1e-3
        if e["name"] in ROOTS:
            assert a["parent"] is None, e
        else:
            assert by_id[a["parent"]]["tid"] == e["tid"], e
        if threads[e["tid"]].startswith("ThreadPoolExecutor"):
            assert a["superbatch"] is not None, e
            if a["parent"] is not None:
                assert by_id[a["parent"]]["args"]["superbatch"] == a["superbatch"]
    sbs = sorted(e["args"]["superbatch"] for e in xs if e["name"] == "superbatch")
    assert sbs == list(range(len(sbs))) and len(sbs) > 1
    assert {e["name"] for e in spans["traceEvents"] if e["ph"] == "C"} == {"emit_q.depth"}
    # one clock: the spans' and the profiler's events are Unix times of the run
    for events in (xs, [e for e in trace["traceEvents"] if e.get("ph") == "X"]):
        unix_us = [spans["baseTimeNanoseconds"] / 1e3 + e["ts"] for e in events]
        assert unix_us and before / 1e3 <= min(unix_us) <= max(unix_us) <= after / 1e3


# -- the work counters' plain versions against the scalar code ----------


@pytest.fixture(scope="module")
def seeding():
    from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex
    from arachne_tpu_torch.seeding_bench import sample_reads

    rng = np.random.default_rng(41)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 30_000)])
    seq = seq[:9000] + seq[2000:3500] + seq[9000:]        # a repeat
    packed = pack_reference([("chr1", "", seq)])
    idx = FMIndex(packed, build_fmindex(packed))
    reads = sample_reads(unpack_2bit(packed.pac, 0, packed.l_pac), 40, seed=42)
    reads[3] = reads[3].copy()
    reads[3][60:64] = 4                                    # N runs
    reads[7] = reads[7][:30].copy()
    return idx, DeviceFMIndex.from_host(idx, "cpu"), reads


class CountingIndex:
    """The FM-index with each bwt_extend counted: two occ4 rows a call."""

    def __init__(self, idx):
        self.idx, self.rows = idx, 0

    def extend(self, *a, **k):
        self.rows += 2
        return self.idx.extend(*a, **k)

    def __getattr__(self, name):
        return getattr(self.idx, name)


@pytest.mark.parametrize("kernel", ["S1 pass 1", "S1 single sweeps", "S3"])
def test_plain_seeding_rank_rows_equal_the_scalar_extends(seeding, kernel):
    """stats["rank_rows"] and the per-read counter row of smem_pass_torch /
    pass3_torch equal two occ4 rows for each bwt_extend that
    align/smem.py's smem1a / seed_strategy1 make on the same reads; the
    device seeding glue puts a pass's sum on its launch span."""
    from arachne_tpu_torch.align.smem import seed_strategy1, smem1a
    from arachne_tpu_torch.config import MemOptions
    from arachne_tpu_torch.ops.fm_seed import _fetch, pad_reads, pass3_torch, seed_buffers
    from arachne_tpu_torch.ops.fm_seed import smem_pass_torch

    idx, dfm, reads = seeding
    opt = MemOptions()
    qs, qlens = pad_reads(reads, "cpu")
    R, L = qs.shape
    n = len(reads)
    want = np.zeros(R, np.int64)
    stats = {}
    if kernel == "S3":
        res = pass3_torch(dfm, qs, qlens, opt.min_seed_len, opt.max_mem_intv, seed_buffers(L),
                          stats=stats, count_rows=True)
        for r, q in enumerate(reads):
            c, x = CountingIndex(idx), 0
            while x < len(q):
                x = seed_strategy1(c, q, x, opt.min_seed_len, opt.max_mem_intv)[0] \
                    if q[x] < 4 else x + 1
            want[r] = c.rows
    else:
        single = kernel == "S1 single sweeps"
        rng = np.random.default_rng(43)
        pivots = np.zeros(R, np.int32)
        minis = np.ones(R, np.int32)
        if single:
            # pivots on a base (pass 2's lie inside an SMEM), min_intv as pass 2's
            for r, q in enumerate(reads):
                pivots[r] = rng.choice(np.flatnonzero(q < 4))
            minis[:n] = rng.integers(1, 5, n)
        res = smem_pass_torch(dfm, qs, qlens, torch.from_numpy(pivots), torch.from_numpy(minis),
                              single, seed_buffers(L), seed_buffers(L), stats=stats,
                              count_rows=True)
        for r, q in enumerate(reads):
            c = CountingIndex(idx)
            if single:
                smem1a(c, q, int(pivots[r]), int(minis[r]), 0)
            else:
                x = 0
                while x < len(q):
                    x = smem1a(c, q, x, 1, 0)[0] if q[x] < 4 else x + 1
            want[r] = c.rows
    out_n = res[1]
    assert out_n.shape == (2, R)
    assert out_n[1].tolist() == want.tolist() and stats["rank_rows"] == want.sum() > 0
    t = StageTimers()
    t.trace(True)
    with t.launch("arachne_smem_pass") as launch:
        pass
    _fetch(res, launch)
    assert launch.attrs["rank_rows"] == want.sum()


def test_plain_extension_cells_equal_the_scalar_count():
    """stats["cells"] and the per-problem counter row of extend_batch_torch
    equal the band cells align/ksw.py's extend2 counts row by row, on the
    main path's problems and on problems that die early."""
    from arachne_tpu_torch.align import ksw
    from arachne_tpu_torch.config import MemOptions
    from arachne_tpu_torch.ops.problems import extend_problems, on_device
    from arachne_tpu_torch.ops.sw_extend import extend_batch_torch

    opt = MemOptions()
    mat = opt.scoring_matrix()
    qs, ts, ws, h0s = extend_problems(5, 48, 64, 160, opt)
    for b in range(0, 48, 6):            # no match at all: dies on its first rows
        qs[b] = np.full(len(qs[b]), 0, np.int8)
        ts[b] = np.full(len(ts[b]), 1, np.int8)
        h0s[b] = 1
    args = on_device("cpu", qs, ts, 64, 160, ws, h0s)
    gaps = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins)
    stats = {}
    out = extend_batch_torch(*args, torch.as_tensor(mat, dtype=torch.int32), **gaps,
                             zdrop=opt.zdrop, stats=stats, count_cells=True)
    want = []
    for b in range(48):
        st = {}
        got = ksw.extend2(qs[b], ts[b], mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                          int(ws[b]), opt.pen_clip5, opt.zdrop, int(h0s[b]), stats=st)
        assert tuple(out[:6, b].tolist()) == got
        want.append(st["cells"])
    assert out[6].tolist() == want and stats["cells"] == sum(want)
    assert min(want[::6]) < 3 * 64 < max(want)


# -- the benchmark's readers ----------------------------------------------


def hand_built_run(with_spans=True):
    """A traced run's record with the program's spans: a window of 10 s
    from 1 s and 2,000 pairs."""
    def span(name, start, end, cpu_s=0.0, thread="MainThread", **attrs):
        return dict(name=name, id=0, parent=None, superbatch=None, thread=thread, start=start,
                    end=end, cpu_s=cpu_s, attrs=attrs)

    from h100_bench.devtrace import kernel_of

    names = {"extend_kernel", "smem_pass_kernel"}
    k1 = "void (anonymous namespace)::extend_kernel<6>(int*)"
    s1 = "void (anonymous namespace)::smem_pass_kernel<int, 2>(int*)"
    run = {"threads": 2, "pairs": 2000, "window": (1.0, 11.0), "window_s": 10.0,
           "stages_s": {}, "batch_spans": [], "global_cells": None,
           "card": "NVIDIA H100 80GB HBM3", "max_sm_mhz": 1980.0,
           "device": {"events": [(k1, 3.0, 3.001), (s1, 4.0, 4.0001), (k1, 20.0, 20.1)],
                      "port_kernels": names, "kernel_of": lambda n: kernel_of(n, names)}}
    if with_spans:
        run["spans"] = [
            span("driver.parse", 0.5, 1.5), span("driver.parse", 2.0, 2.5),    # 0.5 + 0.5 s
            span("driver.emit_blocked", 3.0, 4.0),                            # 10% of 10 s
            span("superbatch", 0.0, 2.0, 1.0, "w0"),                          # half inside
            span("superbatch", 2.0, 10.0, 4.0, "w1"),
            span("io.write", 5.0, 6.0, 0.25, "bam-writer"),
            span("arachne_extend", 3.0, 3.0001, cells=1_000_000),
            span("arachne_extend", 0.5, 0.5001, cells=999),                   # before the window
            span("arachne_smem_pass", 4.0, 4.0001, rank_rows=1_000_000),
        ]
    return run


READINGS = {
    "driver.parse_ms_per_kpair": 500.0,
    "writer.backpressure_pct": 10.0,
    "workers.on_cpu_pct": 100.0 * (0.5 + 4.0) / (1.0 + 8.0),
    "writer.on_cpu_pct": 25.0,
    # 5e6 instructions at 132 x 64 lanes x 1980 MHz, over 1 ms
    "K1_roofline": 100.0 * 5e6 / (132 * 64 * 1980e6) / 1e-3,
    # 64 MB at 3.35 TB/s over 0.1 ms
    "S1_roofline": 100.0 * 64e6 / 3.35e12 / 1e-4,
}


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_span_readers_on_a_hand_built_run_and_none_without_spans(metric):
    from h100_bench import catalog

    read = catalog.reader(REPO, metric)
    assert read(hand_built_run()) == pytest.approx(READINGS[metric], rel=1e-9)
    assert metric in {m["name"] for m in catalog.metrics_of(catalog.load(REPO), "scale64m.indel",
                                                             "per_layer")}
    # a program that traced nothing (or has no tracer): nothing to read
    TIMERS.trace(True)
    TIMERS.trace(False)
    assert read(hand_built_run(with_spans=False)) is None


def test_the_benchmark_reads_the_programs_own_spans_on_its_clock():
    """Without spans in the run's record, h100_bench/spans.py reads the
    program's tracer and moves its Unix times to the perf_counter clock."""
    from h100_bench import spans

    TIMERS.trace(True)
    try:
        t0 = time.perf_counter()
        with TIMERS.launch("arachne_extend", problems=2) as rec:
            rec.attrs["cells"] = 40
        with TIMERS.span("driver.parse"):
            time.sleep(0.01)
        t1 = time.perf_counter()
    finally:
        TIMERS.trace(False)
    run = {"window": (t0, t1), "window_s": t1 - t0, "pairs": 1000}
    got = spans.of(run)
    assert [s["name"] for s in got] == ["arachne_extend", "driver.parse"]
    for s in got:
        assert t0 - 1e-3 <= s["start"] <= s["end"] <= t1 + 1e-3
    assert spans.launch_work(run, ["arachne_extend"], "cells") == 40
    assert 0.009 < spans.seconds_in_window(run, "driver.parse") < t1 - t0


# -- the work counts on the superbatch span --------------------------------


@pytest.fixture(scope="module")
def repeats(tmp_path_factory):
    """A 60 kbp genome whose 6 kb segment at 10 kb lies twice more at 99%
    identity, its index, and 6 barcode sets of the benchmark's simulator
    with 1-bp indels: reads with several hits, mates rescued."""
    from arachne_tpu_torch.cli import main
    from h100_bench import genomes, library

    d = tmp_path_factory.mktemp("repeats")
    ref, r1, r2 = str(d / "ref.fa"), str(d / "r1.fq"), str(d / "r2.fq")
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 60_000, dtype=np.uint8)
    for at in (30_000, 45_000):
        copy = g[10_000:16_000].copy()
        genomes.mutate(copy, 0.01, rng)
        g[at : at + 6_000] = copy
    with open(ref, "w") as fh:
        fh.write(">chrR\n" + genomes.BASES[g].tobytes().decode() + "\n")
    main(["index", ref])
    sim = library.SimConfig(n_barcodes=6, molecules_per_barcode=2, pairs_per_molecule=5,
                            molecule_len=20_000, indel_rate=0.1, vary_quals=True)
    library.simulate(genomes.read_contigs(ref), r1, r2, sim, [7, 0], 0)
    return {"ref": ref, "r1": r1, "r2": r2}


def test_a_traced_superbatch_carries_its_work_counts(repeats, monkeypatch):
    """process_barcodes' ``superbatch`` span carries the six work counts,
    each equal to a count taken by hand from the same run: the seed
    occurrences of the SMEMs (at most max_occ each), the chains the
    chainer keeps, the regions interpreted as hits, the rescue windows
    aligned in the batch or on the host and the regions they placed, the
    alignments handed to the RFA tail.  Untraced, nothing is recorded and
    the results are the same."""
    from arachne_tpu_torch.align import ksw
    from arachne_tpu_torch.align.chain_native import mem_chain_batch_native
    from arachne_tpu_torch.align.pipeline import seq_to_codes
    from arachne_tpu_torch.align.smem_native import collect_seeds_native
    from arachne_tpu_torch.cli import load_or_build_index
    from arachne_tpu_torch.config import ArachneConfig
    from arachne_tpu_torch.io.fastq import iter_barcode_sets
    from arachne_tpu_torch.ops import engine as ops_engine
    from arachne_tpu_torch.ops.engine import TorchEngine
    from arachne_tpu_torch.ops.sw_local import BatchLocalSW
    from arachne_tpu_torch.rfa import engine as rfa_engine

    idx = load_or_build_index(repeats["ref"])
    cfg = ArachneConfig()
    sets = list(iter_barcode_sets(repeats["r1"], repeats["r2"]))
    pairs = [(seq_to_codes(r.read1), seq_to_codes(r.read2)) for recs, _ in sets for r in recs]
    reads = [c for p in pairs for c in p]

    seen = dict.fromkeys(("windows", "host", "placed"), 0)

    def counted(key, fn):
        def wrapper(*a, **k):
            seen[key] += 1
            return fn(*a, **k)
        return wrapper

    run_align2 = BatchLocalSW.run_align2

    def windows(self):
        out = run_align2(self)
        seen["windows"] += len(out)
        return out

    monkeypatch.setattr(BatchLocalSW, "run_align2", windows)
    monkeypatch.setattr(ksw, "align2", counted("host", ksw.align2))
    monkeypatch.setattr(ops_engine, "AlnReg", counted("placed", ops_engine.AlnReg))

    TIMERS.trace(True)
    try:
        with TIMERS.in_superbatch(0):
            traced = rfa_engine.process_barcodes(idx, cfg, sets, TorchEngine(idx, cfg, "cpu"))
    finally:
        TIMERS.trace(False)
    (sb,) = [r for r in TIMERS.spans() if r.name == "superbatch"]
    # the traced run's; the candidates are the alignments the tail kept
    tally = dict(seen, candidates=sum(len(x) for r in traced for x in r.alignments))

    mems = collect_seeds_native(idx, reads, cfg.mem)
    hits = TorchEngine(idx, cfg, "cpu").align_pairs(pairs)
    want = {
        "seeds": sum(min(m.s, cfg.mem.max_occ) for ms in mems for m in ms),
        "chains": sum(map(len, mem_chain_batch_native(idx, reads, cfg.mem, mems))),
        "hits": sum(len(a) + len(b) for a, b in hits),
        "rescue_attempts": tally["windows"] + tally["host"],
        "rescue_placed": tally["placed"],
        "candidates": tally["candidates"],
    }
    assert {k: sb.attrs[k] for k in rfa_engine.WORK_COUNTS} == want
    assert sb.attrs["pairs"] == len(pairs) and sb.superbatch == 0
    # reads with several hits: more occurrences than chains, rescue at work
    assert want["seeds"] > want["chains"] > len(reads) / 2
    assert want["hits"] > len(reads) and want["rescue_placed"] > 0

    untraced = rfa_engine.process_barcodes(idx, cfg, sets, TorchEngine(idx, cfg, "cpu"))
    assert [r.name for r in TIMERS.spans()].count("superbatch") == 1   # the traced run's
    assert [[[(a.contig, a.pos, a.cigar, a.mapq) for a in x] for x in r.alignments]
            for r in untraced] == \
        [[[(a.contig, a.pos, a.cigar, a.mapq) for a in x] for x in r.alignments] for r in traced]


def counted_run(with_counts=True):
    """A traced run's record (window 1-11 s) with three superbatches, the
    middle one alone ending in the window, and the stages inside each."""
    def span(name, sb, start, end, **attrs):
        return dict(name=name, id=0, parent=None, superbatch=sb, thread="w", start=start,
                    end=end, cpu_s=0.0, attrs=attrs)

    counts = dict(seeds=4000, chains=1000, hits=500, rescue_attempts=200, rescue_placed=50,
                  candidates=400)
    run = {"window": (1.0, 11.0), "window_s": 10.0, "pairs": 2000, "spans": []}
    for sb, (a, b) in enumerate([(0.0, 1.5), (1.5, 9.0), (9.0, 12.0)]):
        run["spans"] += [
            span("superbatch", sb, a, b, sets=1, pairs=100, **(counts if with_counts else {})),
            span("chain.host", sb, a, a + 0.5),
            span("cigar", sb, a + 0.5, a + 0.75),
            span("rfa.host", sb, a + 0.75, a + 1.15),
            span("rescue", sb, a + 0.25, a + 0.35),
        ]
    return run


COUNT_READINGS = {
    "seeding.chain_us_per_seed": 0.5e6 / 4000,
    "engine.cigar_us_per_hit": 0.25e6 / 500,
    "rfa.us_per_candidate": 0.4e6 / 400,
    "rescue.us_per_attempt": 0.1e6 / 200,
}


@pytest.mark.parametrize("metric", sorted(COUNT_READINGS))
def test_work_count_readers_on_a_hand_built_run_and_none_without_counts(metric):
    """Each reader of a stage's time over a work count takes both from the
    superbatches whose span ends in the window; a run without the counts
    (no trace, or a program that does not count) gives None."""
    from h100_bench import catalog

    read = catalog.reader(REPO, metric)
    assert read(counted_run()) == pytest.approx(COUNT_READINGS[metric], rel=1e-9)
    assert metric in {m["name"] for m in catalog.metrics_of(catalog.load(REPO), "human256m.indel",
                                                             "per_layer")}
    assert read(counted_run(with_counts=False)) is None
    TIMERS.trace(True)
    TIMERS.trace(False)
    assert read({"window": (1.0, 11.0), "window_s": 10.0, "pairs": 2000}) is None
