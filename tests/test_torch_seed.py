"""The port's device seeding (arachne_tpu_torch/ops/fm_seed.py) on the CPU,
where kernels S1 and S3 run as their plain lockstep versions:

  * the raw out / out_n / overflow of both against the JAX package's jitted
    programs (arachne_tpu/ops/fm_seed.py), narrow and wide, with the
    production buffers and with MAXC=2, MAXS=4, which overflow;
  * collect_seeds_device against the JAX collect_seeds_device and the
    scalar collector on the read families of tests/test_fm_seed.py;
  * batch_align_single with and without device seeding.

Integer outputs: tolerance 0."""

import contextlib
from dataclasses import astuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arachne_tpu import config as ref_config
from arachne_tpu import index as ref_index
from arachne_tpu.align.smem import collect_seeds
from arachne_tpu.ops import fm_rank as jfm
from arachne_tpu.ops import fm_seed as jfs
from arachne_tpu_torch.config import MemOptions
from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
from arachne_tpu_torch.ops import fm_rank as tfm
from arachne_tpu_torch.ops import fm_seed as tfs
from arachne_tpu_torch.ops.cuda_seed import pass3_cuda, smem_pass_cuda

torch.set_num_threads(1)
OPT = MemOptions()
REF_OPT = ref_config.MemOptions()
FAMILIES = ("clean", "mutated_n", "repeat", "edge")


@pytest.fixture(scope="module")
def genome(small_reference):
    """The port's own index of the reference sequence and its forward
    strand."""
    packed = pack_reference(small_reference)
    idx = FMIndex(packed, build_fmindex(packed))
    return idx, unpack_2bit(packed.pac, 0, packed.l_pac)


@pytest.fixture(scope="module")
def ref_idx(small_reference):
    """The JAX package's index of the same sequence."""
    packed = ref_index.pack_reference(small_reference)
    return ref_index.FMIndex(packed, ref_index.build_fmindex(packed))


def fields(smems):
    """SMEMs as plain tuples: the port's and the JAX package's SMEM are
    distinct classes with the same fields."""
    return [astuple(s) for s in smems]


@pytest.fixture(scope="module")
def families(genome):
    """The read families of tests/test_fm_seed.py:47-95, from a fixed seed."""
    idx, fwd = genome
    rng = np.random.default_rng(47)
    clean = []
    for _ in range(20):
        pos = int(rng.integers(0, len(fwd) - 130))
        r = fwd[pos : pos + 120].copy()
        clean.append((3 - r[::-1]).astype(np.uint8) if rng.integers(0, 2) else r)
    mutated = []
    for _ in range(25):
        pos = int(rng.integers(0, len(fwd) - 160))
        r = fwd[pos : pos + 150].copy()
        for _ in range(int(rng.integers(0, 8))):
            j = int(rng.integers(0, 150))
            r[j] = (r[j] + 1) % 4
        if rng.integers(0, 3) == 0:
            r[int(rng.integers(0, 150))] = 4   # N
        mutated.append(r)
    repeat = [fwd[400 + 30 * i : 400 + 30 * i + 100].copy() for i in range(8)]
    edge = [fwd[:25].copy(), fwd[-40:].copy(), np.full(30, 4, np.uint8), fwd[100:119].copy()]
    return dict(zip(FAMILIES, (clean, mutated, repeat, edge)))


def all_reads(families):
    return [r for f in FAMILIES for r in families[f]]


def family_slice(families, name):
    start = sum(len(families[f]) for f in FAMILIES[: FAMILIES.index(name)])
    return slice(start, start + len(families[name]))


@contextlib.contextmanager
def both_tables(ref_idx, idx, wide):
    """(JAX DeviceFMIndex of the JAX package's index, port DeviceFMIndex of
    the port's index, on the CPU); wide JAX tables turn jax_enable_x64 on
    process-wide, so it is turned off again after."""
    try:
        yield jfm.DeviceFMIndex.from_host(ref_idx, wide=wide), tfm.DeviceFMIndex.from_host(
            idx, "cpu", wide=wide)
    finally:
        jax.config.update("jax_enable_x64", False)


def assert_same(port, ref):
    for p, r in zip(port, ref):
        r = np.asarray(r)
        assert p.shape == r.shape
        assert np.array_equal(p.numpy(), r)


def batch(families, short):
    """The reads padded as collect_seeds_device pads them; ``short`` cuts
    every read to 60 bases (L = 64), which keeps the overflow cases, whose
    spinning reads run to the step cap, quick."""
    reads = all_reads(families)
    if short:
        reads = [r[:60] for r in reads]
    return tfs.pad_reads(reads, "cpu")


S1_CASES = [(ss, wide, bufs) for bufs in ((12, 48), (2, 4))
            for wide in (False, True) for ss in (False, True)]


@pytest.mark.parametrize(
    "single_sweep,wide,bufs", S1_CASES,
    ids=[f"{'pass2' if s else 'pass1'}-{'wide' if w else 'narrow'}-{b[0]}x{b[1]}"
         for s, w, b in S1_CASES])
def test_smem_pass_matches_jax(genome, ref_idx, families, single_sweep, wide, bufs):
    idx, _ = genome
    MAXC, MAXS = bufs
    qs, qlens = batch(families, short=MAXC == 2)
    R, L = qs.shape
    rng = np.random.default_rng(48)
    if single_sweep:   # one sweep from a random pivot with min_intv 1..3
        pivots = (rng.integers(0, 1 << 20, R) % np.maximum(qlens.numpy(), 1)).astype(np.int32)
        minis = rng.integers(1, 4, R).astype(np.int32)
    else:
        pivots, minis = np.zeros(R, np.int32), np.ones(R, np.int32)
    before = smem_pass_cuda.launches
    with both_tables(ref_idx, idx, wide) as (jd, td):
        port = tfs.smem_pass(td, qs, qlens, torch.from_numpy(pivots), torch.from_numpy(minis),
                             single_sweep, MAXC, MAXS)
        ref = jfs._smem_pass_kernel(
            jd.occ, jd.words, jd.L2, jd.primary, jd.seq_len, jnp.asarray(qs.numpy()),
            jnp.asarray(qlens.numpy()), jnp.asarray(pivots), jnp.asarray(minis),
            single_sweep, R, L, MAXC, MAXS)
    assert_same(port, ref)
    assert smem_pass_cuda.launches == before
    assert port[0].dtype == td.idt and int(port[1].sum()) > 0
    assert bool(port[2].any()) == (MAXC == 2)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("MAXS", [48, 4])
def test_pass3_matches_jax(genome, ref_idx, families, wide, MAXS):
    idx, _ = genome
    qs, qlens = batch(families, short=False)
    R, L = qs.shape
    before = pass3_cuda.launches
    with both_tables(ref_idx, idx, wide) as (jd, td):
        port = tfs.pass3(td, qs, qlens, OPT.min_seed_len, OPT.max_mem_intv, MAXS)
        ref = jfs._pass3_kernel(
            jd.occ, jd.words, jd.L2, jd.primary, jd.seq_len, jnp.asarray(qs.numpy()),
            jnp.asarray(qlens.numpy()), OPT.min_seed_len, OPT.max_mem_intv, R, L, MAXS)
    assert_same(port, ref)
    assert pass3_cuda.launches == before
    assert int(port[1].sum()) > 0
    assert bool(port[2].any()) == (MAXS == 4)


@pytest.fixture(scope="module", params=[False, True], ids=["narrow", "wide"])
def collected(request, genome, ref_idx, families):
    """collect_seeds_device of the port and of the JAX package on all the
    families at once (one batch: R = 64, L = 192)."""
    idx, _ = genome
    reads = all_reads(families)
    with both_tables(ref_idx, idx, request.param) as (jd, td):
        port = tfs.collect_seeds_device(reads, OPT, td)
        ref = jfs.collect_seeds_device(ref_idx, reads, REF_OPT, dfm=jd)
    return port, ref


@pytest.mark.parametrize("family", FAMILIES)
def test_collect_seeds_device_matches_jax_and_scalar(ref_idx, families, collected, family):
    port, ref = collected
    sl = family_slice(families, family)
    for read, p, r in zip(families[family], port[sl], ref[sl]):
        assert fields(p) == fields(r)
        assert fields(p) == fields(collect_seeds(ref_idx, read, REF_OPT))


def test_overflowing_reads_fall_back_to_the_host(genome, ref_idx, families):
    """With MAXC=2, MAXS=4 many reads overflow; they are redone on the same
    device with buffers of seed_buffers size (never by a host collector),
    counted, and their seeds equal the scalar collector's."""
    idx, _ = genome
    reads = [r[:60] for r in all_reads(families)]
    td = tfm.DeviceFMIndex.from_host(idx, "cpu")
    before = tfs.overflow_redos
    got = tfs.collect_seeds_device(reads, OPT, td, MAXC=2, MAXS=4)
    assert tfs.overflow_redos - before > 0
    for read, g in zip(reads, got):
        assert fields(g) == fields(collect_seeds(ref_idx, read, REF_OPT))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_seed_buffers_hold_every_read(genome, families, wide):
    """At seed_buffers(L) no read of any family overflows: pass 1, one
    sweep from random pivots with min_intv 1..3, and pass 3."""
    idx, _ = genome
    qs, qlens = batch(families, short=False)
    R, L = qs.shape
    B = tfs.seed_buffers(L)
    rng = np.random.default_rng(49)
    pivots = (rng.integers(0, 1 << 20, R) % np.maximum(qlens.numpy(), 1)).astype(np.int32)
    minis = rng.integers(1, 4, R).astype(np.int32)
    td = tfm.DeviceFMIndex.from_host(idx, "cpu", wide=wide)
    zeros, ones = torch.zeros(R, dtype=torch.int32), torch.ones(R, dtype=torch.int32)
    for piv, mi, single in ((zeros, ones, False), (torch.from_numpy(pivots), torch.from_numpy(minis), True)):
        out, n, ovf = tfs.smem_pass(td, qs, qlens, piv, mi, single, B, B)
        assert not bool(ovf.any()) and int(n.sum()) > 0
    out, n, ovf = tfs.pass3(td, qs, qlens, OPT.min_seed_len, OPT.max_mem_intv, B)
    assert not bool(ovf.any()) and int(n.sum()) > 0


def test_overflow_at_seed_buffers_raises(genome, families, monkeypatch):
    """A read that overflows buffers of seed_buffers size is a fault, not a
    case to patch up on the host: collect_seeds_device raises."""
    idx, _ = genome
    td = tfm.DeviceFMIndex.from_host(idx, "cpu")
    monkeypatch.setattr(tfs, "seed_buffers", lambda L: 2)
    before = tfs.overflow_redos
    with pytest.raises(RuntimeError, match="overflowed"):
        tfs.collect_seeds_device([r[:60] for r in families["clean"][:4]], OPT, td)
    assert tfs.overflow_redos == before


def test_batch_align_single_with_device_seeding(genome, families):
    from arachne_tpu_torch.ops.batch import batch_align_single
    from arachne_tpu_torch.ops.sw_extend import BatchExtender

    idx, _ = genome
    reads = families["mutated_n"][:10] + families["repeat"][:4] + families["clean"][:4]
    ext = BatchExtender(OPT, torch.device("cpu"))
    host = batch_align_single(idx, OPT, reads, ext)
    dev = batch_align_single(idx, OPT, reads, ext,
                             dfm=tfm.DeviceFMIndex.from_host(idx, "cpu"))
    assert dev == host
    assert sum(len(r) for r in dev) >= len(reads)


def test_pass2_runs_every_job_in_one_launch(genome, ref_idx, monkeypatch):
    """Reads of 0, 1, 2 and 3 pass-2 jobs (an all-N read; a clean read, one
    long SMEM; one and two substitutions, two and three): pass 2 is one S1
    launch over all the jobs, and collect_seeds_device still equals the
    JAX package's, the native collector's and the scalar collector's."""
    from arachne_tpu_torch.align.smem_native import collect_seeds_native

    idx, fwd = genome
    reads = [np.full(150, 4, np.uint8), fwd[2000:2150].copy()]
    for at, subs in ((5600, (75,)), (6200, (50, 100)), (2600, (40, 80)), (3200, (70,))):
        r = fwd[at : at + 150].copy()
        r[list(subs)] = (r[list(subs)] + 1) % 4
        reads.append(r)
    td = tfm.DeviceFMIndex.from_host(idx, "cpu")
    qs, qlens = tfs.pad_reads(reads, "cpu")
    R = qs.shape[0]
    B = tfs.seed_buffers(qs.shape[1])
    out1, n1, ovf = (t.numpy() for t in tfs.smem_pass(
        td, qs, qlens, torch.zeros(R, dtype=torch.int32), torch.ones(R, dtype=torch.int32),
        False, B, B))
    _, jobs = tfs.pass1_seeds(out1, n1, ovf.copy(), len(reads), OPT)
    # the jobs as the reference makes them, read by read (fm_seed.py:495-511)
    split_len = int(OPT.min_seed_len * OPT.split_factor + 0.499)
    want = [[((qb + qe) >> 1, s + 1) for k, l, s, qb, qe in out1[r, : n1[r]].tolist()
             if qe - qb >= max(OPT.min_seed_len, split_len) and s <= OPT.split_width]
            for r in range(len(reads))]
    assert sorted({len(j) for j in want}) == [0, 1, 2, 3]
    read_of, qs_j, qlens_j, piv, mi = tfs.pass2_inputs(jobs, qs, qlens)
    assert read_of.tolist() == [r for r, jl in enumerate(want) for _ in jl]
    assert [(int(p), int(m)) for p, m in zip(piv, mi)] == [j for jl in want for j in jl]
    assert torch.equal(qs_j, qs[torch.from_numpy(read_of)])

    calls = []
    smem_pass = tfs.smem_pass

    def counted(*a, **k):
        calls.append(a[1].shape[0])
        return smem_pass(*a, **k)

    monkeypatch.setattr(tfs, "smem_pass", counted)
    got = tfs.collect_seeds_device(reads, OPT, td)
    assert calls == [R, len(read_of)]            # pass 1, then every job at once
    with both_tables(ref_idx, idx, False) as (jd, _):
        ref = jfs.collect_seeds_device(ref_idx, reads, REF_OPT, dfm=jd)
    native = collect_seeds_native(idx, reads, OPT)
    for read, g, r, nat in zip(reads, got, ref, native):
        assert fields(g) == fields(r) == fields(nat) == fields(collect_seeds(ref_idx, read, REF_OPT))
