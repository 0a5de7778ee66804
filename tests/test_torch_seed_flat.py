"""Device seeding's flat form (arachne_tpu_torch/ops/fm_seed.py
``collect_seeds_device_flat`` and ``SeedBatch``) and its entry into the
native chainer (align/chain_native.py ``mem_chain_flat_native``) on the CPU,
where kernels S1 and S3 run as their plain versions:

  * the flat seeds, as per-read lists, against the JAX package's
    collect_seeds_device, the port's native collector and the scalar
    collector, narrow and wide, on reads with no SMEM, with many pass-2
    jobs and with pass-1 and pass-3 seeds that tie in (qb, qe);
  * the redo path of undersized buffers (MAXC=2, MAXS=4);
  * the host collector's flat entry against its lists, overflowing reads
    included (MAXS=4);
  * mem_chain_flat_native on a SeedBatch against mem_chain_batch_native on
    its lists, and batch_align_single with each seeder;
  * the default of resolve_device_seeding on each kind of device.

Integer outputs: tolerance 0."""

from dataclasses import astuple

import jax
import numpy as np
import pytest
import torch

from arachne_tpu import config as ref_config
from arachne_tpu import index as ref_index
from arachne_tpu.align.smem import collect_seeds
from arachne_tpu.ops import fm_rank as jfm
from arachne_tpu.ops import fm_seed as jfs
from arachne_tpu_torch.align import chain_native
from arachne_tpu_torch.align.smem_native import (
    collect_seeds_native, collect_seeds_native_flat, smem_available,
)
from arachne_tpu_torch.config import MemOptions
from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference
from arachne_tpu_torch.ops import fm_rank as tfm
from arachne_tpu_torch.ops import fm_seed as tfs

torch.set_num_threads(1)
OPT = MemOptions()
REF_OPT = ref_config.MemOptions()
BASES = np.array(list("ACGT"))
# a 30-base unit in 25 copies, 5 of them followed by "AC": a read of the
# unit, "A" and then "G" has the pass-1 SMEM [0, 31) (5 hits), and pass 3,
# whose interval first falls below max_mem_intv (20) at that base, seeds
# the same [0, 31)
UNIT_COPIES, UNIT_AC = 25, 5


def text(codes):
    return "".join(BASES[codes])


@pytest.fixture(scope="module")
def contigs():
    rng = np.random.default_rng(151)
    unit = rng.integers(0, 4, 30)
    parts = [text(rng.integers(0, 4, 4000))]
    for c in range(UNIT_COPIES):
        parts.append(text(unit) + ("AC" if c < UNIT_AC else "G") + text(rng.integers(0, 4, 24)))
    parts.append(text(rng.integers(0, 4, 2000)))
    return [("chrA", "", "".join(parts)), ("chrB", "", text(rng.integers(0, 4, 3000)))], unit


@pytest.fixture(scope="module")
def indexes(contigs):
    seqs, _ = contigs
    packed = pack_reference(seqs)
    ref_packed = ref_index.pack_reference(seqs)
    return (FMIndex(packed, build_fmindex(packed)),
            ref_index.FMIndex(ref_packed, ref_index.build_fmindex(ref_packed)))


@pytest.fixture(scope="module")
def reads(contigs):
    """Reads of every kind the merge must get right, from a fixed seed."""
    seqs, unit = contigs
    fwd = np.array(["ACGT".index(b) for b in seqs[0][2]], np.uint8)
    rng = np.random.default_rng(152)
    out = []
    # no SMEM: all N, shorter than min_seed_len, random bases
    out += [np.full(120, 4, np.uint8), fwd[100:112].copy(),
            rng.integers(0, 4, 150).astype(np.uint8)]
    # many pass-2 jobs: 250 bases with a substitution every 31
    for at in (300, 1700):
        r = fwd[at : at + 250].copy()
        r[31::31] = (r[31::31] + 1) % 4
        out.append(r)
    # pass 1 and pass 3 tie on (0, 31): the unit, "A", then "G" and more
    for tail in (40, 80):
        out.append(np.concatenate([unit, [0, 2], rng.integers(0, 4, tail)]).astype(np.uint8))
    # plain reads, some mutated, some reverse-complemented, one with an N
    for i in range(16):
        at = int(rng.integers(0, len(fwd) - 160))
        r = fwd[at : at + 150].copy()
        r[rng.integers(0, 150, int(rng.integers(0, 5)))] = rng.integers(0, 4)
        if i == 3:
            r[70] = 4
        out.append(np.where(r < 4, 3 - r, 4)[::-1].astype(np.uint8) if i % 2 else r)
    return out


def fields(smems):
    return [astuple(s) for s in smems]


@pytest.fixture(scope="module", params=[False, True], ids=["narrow", "wide"])
def flat(request, indexes, reads):
    """The port's flat seeds and the JAX package's collect_seeds_device on
    the same reads; wide JAX tables turn jax_enable_x64 on process-wide,
    so it is turned off again after."""
    idx, ref_idx = indexes
    try:
        td = tfm.DeviceFMIndex.from_host(idx, "cpu", wide=request.param)
        ref = jfs.collect_seeds_device(ref_idx, reads, REF_OPT,
                                       dfm=jfm.DeviceFMIndex.from_host(ref_idx, wide=request.param))
    finally:
        jax.config.update("jax_enable_x64", False)
    return tfs.collect_seeds_device_flat(reads, OPT, td), ref


def test_flat_seeds_match_jax_native_and_scalar(indexes, reads, flat):
    idx, ref_idx = indexes
    got, ref = flat
    assert got.off.shape == (len(reads) + 1,) and got.off[0] == 0 and got.off[-1] == len(got.k)
    assert np.all(np.diff(got.off) >= 0)
    assert [a.dtype for a in (got.off, got.k, got.l, got.s, got.qb, got.qe)] == [np.int64] * 4 + [
        np.int32] * 2
    lists = got.to_lists()
    assert smem_available()
    native = collect_seeds_native(idx, reads, OPT)
    for read, g, r, nat in zip(reads, lists, ref, native):
        assert fields(g) == fields(r) == fields(nat) == fields(collect_seeds(ref_idx, read, REF_OPT))
    # the kinds of read the fixture promises are there
    assert [len(m) for m in lists[:3]] == [0, 0, 0]
    for m in lists[5:7]:
        spans = [(s.qb, s.qe) for s in m]
        assert spans.count((0, 31)) == 2
    assert lists[4] and sum(len(m) for m in lists) > 3 * len(reads)


def test_reads_with_many_pass2_jobs(indexes, reads):
    """The 250-base reads give pass 2 five jobs or more each, in one S1
    launch with every other read's."""
    idx, _ = indexes
    td = tfm.DeviceFMIndex.from_host(idx, "cpu")
    qs, qlens = tfs.pad_reads(reads, "cpu")
    R, L = qs.shape
    B = tfs.seed_buffers(L)
    out1, n1, ovf = (t.numpy() for t in tfs.smem_pass(
        td, qs, qlens, torch.zeros(R, dtype=torch.int32), torch.ones(R, dtype=torch.int32),
        False, B, B))
    _, jobs = tfs.pass1_seeds(out1, n1, ovf, len(reads), OPT)
    per_read = np.bincount(jobs.read, minlength=len(reads))
    assert per_read[3] >= 5 and per_read[4] >= 5
    assert np.all(np.diff(jobs.read) >= 0)


def test_flat_redo_path_with_small_buffers(indexes, reads):
    """MAXC=2, MAXS=4: overflowed reads are redone at seed_buffers size,
    counted, and spliced back into the batch in read order."""
    idx, ref_idx = indexes
    short = [r[:60] for r in reads]
    td = tfm.DeviceFMIndex.from_host(idx, "cpu")
    before = tfs.overflow_redos
    got = tfs.collect_seeds_device_flat(short, OPT, td, MAXC=2, MAXS=4)
    assert tfs.overflow_redos - before > 0
    sized = tfs.collect_seeds_device_flat(short, OPT, td)
    for name in ("off", "k", "l", "s", "qb", "qe"):
        assert np.array_equal(getattr(got, name), getattr(sized, name)), name
    for read, g in zip(short, got.to_lists()):
        assert fields(g) == fields(collect_seeds(ref_idx, read, REF_OPT))


def test_flat_of_no_reads():
    got = tfs.collect_seeds_device_flat([], OPT, None)
    assert got.off.tolist() == [0] and got.to_lists() == []


def chain_fields(c):
    win = None if c.win_seq is None else c.win_seq.tolist()
    return (c.pos, c.rid, [astuple(s) for s in c.seeds], c.w, c.kept, c.first, c.is_alt,
            c.frac_rep, win, c.win_rmax0)


def test_chain_flat_entry_equals_list_entry(indexes, reads, flat):
    idx, _ = indexes
    got, _ = flat
    by_flat = chain_native.mem_chain_flat_native(idx, reads, OPT, got.k, got.s, got.qb, got.qe,
                                                 got.off)
    by_lists = chain_native.mem_chain_batch_native(idx, reads, OPT, got.to_lists())
    assert by_flat is not None and by_lists is not None
    assert [[chain_fields(c) for c in cs] for cs in by_flat] == [
        [chain_fields(c) for c in cs] for cs in by_lists]
    assert sum(map(len, by_flat)) >= len(reads) - 3


def test_host_flat_entry_is_the_native_lists_flattened(indexes, reads):
    """collect_seeds_native_flat gives, row for row, the flat arrays of
    collect_seeds_native's lists, with MAXS=4 so that reads overflow and
    the scalar collector's rows are spliced in at their place."""
    idx, _ = indexes
    for MAXS in (4, 256):
        read, rows = collect_seeds_native_flat(idx, reads, OPT, MAXS=MAXS)
        lists = collect_seeds_native(idx, reads, OPT, MAXS=MAXS)
        k, s, qb, qe, off = chain_native._flatten_mems(lists)
        assert read.dtype == rows.dtype == np.int64 and rows.shape == (len(k), 5)
        assert np.array_equal(np.bincount(read, minlength=len(reads)), np.diff(off))
        assert np.all(np.diff(read) >= 0)
        for got, want in zip((rows[:, 0], rows[:, 2], rows[:, 3], rows[:, 4]), (k, s, qb, qe)):
            assert np.array_equal(got, want)
        assert rows[:, 1].tolist() == [m.l for ms in lists for m in ms]
        batch = tfs.SeedBatch.of_rows(len(reads), read, rows)
        assert [fields(m) for m in batch.to_lists()] == [fields(m) for m in lists]
    # the reads that overflow four seeds hold more than four
    assert max(len(m) for m in lists) > 4


@pytest.mark.parametrize("device_seeds", [True, False], ids=["device-seeds", "host-seeds"])
def test_batch_align_single_by_each_route(indexes, reads, device_seeds):
    """The flat device seeds and the host collector's flat seeds go through
    the one native chainer call: the regions of the scalar mem_align1_core
    (align.pipeline.align_single), the same either way."""
    from arachne_tpu_torch.align.pipeline import align_single
    from arachne_tpu_torch.ops.batch import batch_align_single
    from arachne_tpu_torch.ops.sw_extend import BatchExtender

    idx, _ = indexes
    some = reads[:8]
    ext = BatchExtender(OPT, torch.device("cpu"))
    dfm = tfm.DeviceFMIndex.from_host(idx, "cpu") if device_seeds else None
    got = batch_align_single(idx, OPT, some, ext, dfm=dfm)
    assert got == [align_single(idx, OPT, r) for r in some]
    assert sum(len(r) for r in got) >= len(some) - 3


@pytest.mark.parametrize("device,default", [(torch.device("cuda"), True),
                                            (torch.device("cuda", 0), True),
                                            ("cuda", True),
                                            (torch.device("cpu"), False),
                                            (None, False)])
def test_device_seeding_default_follows_the_device(monkeypatch, device, default):
    """Unset, the variable leaves the choice to the device: on for a CUDA
    device, off for the CPU or none; "0"/"1" and an explicit argument
    override it on every device, and any other value raises."""
    from arachne_tpu_torch.ops.engine import resolve_device_seeding

    monkeypatch.delenv("ARACHNE_DEVICE_SEEDING", raising=False)
    assert resolve_device_seeding(None, device) is default
    assert resolve_device_seeding(True, device) is True
    assert resolve_device_seeding(False, device) is False
    for env, want in (("0", False), ("1", True)):
        monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", env)
        assert resolve_device_seeding(None, device) is want
        assert resolve_device_seeding(not want, device) is (not want)
    monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "on")
    with pytest.raises(ValueError, match="ARACHNE_DEVICE_SEEDING"):
        resolve_device_seeding(None, device)
