"""The port's CUDA kernels against their plain PyTorch versions on the card,
and device seeding against the host C++ collector.

Every test here needs a CUDA device and skips without one.  The module
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Integer outputs: tolerance 0.  Each launch through a kernel wrapper must
add exactly one to that kernel's launch count.
"""

import numpy as np
import pytest
import torch

from arachne_tpu.config import ArachneConfig, MemOptions
from chip_smoke import extend_problems, global_problems, local_problems, on_device

OPT = MemOptions()
GAPS = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins, e_ins=OPT.e_ins)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def mat_on(dev):
    return torch.as_tensor(OPT.scoring_matrix(), dtype=torch.int32, device=dev)


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
def test_engine_on_card_matches_cpu_engine(dev):
    """TorchEngine with the kernels gives the same barcode results as with
    their plain versions, through the whole superbatch workflow."""
    from arachne_tpu.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
    from arachne_tpu.rfa import FastQRecordView
    from arachne_tpu.rfa.engine import process_barcodes
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
    from arachne_tpu.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
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
    if wide:   # random words and counts over 4096 blocks
        tables.append(synthetic_table(dev, 4096))
    for fm in tables:
        ks = parity_rows(fm, 4096)
        before = rank_cuda.launches
        got = occ4_device(fm, ks)
        assert rank_cuda.launches == before + 1
        assert torch.equal(got, occ4_torch(fm, ks))
        if fm.seq_len == idx.seq_len:
            assert np.array_equal(got.cpu().numpy(), idx.occ4(ks.cpu().numpy().astype(np.int64)))


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("bufs", [(12, 48), (2, 4), None], ids=["12x48", "2x4", "sized"])
def test_seed_kernels_match_plain(dev, seeding_genome, wide, bufs):
    from arachne_tpu_torch.ops.cuda_seed import pass3_cuda, smem_pass_cuda
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex
    from arachne_tpu_torch.ops.fm_seed import (
        pad_reads, pass3, pass3_torch, seed_buffers, smem_pass, smem_pass_torch,
    )

    idx, reads = seeding_genome
    fm = DeviceFMIndex.from_host(idx, dev, wide=wide)
    # the small buffers make reads spin to the step cap: keep L at 64 there
    qs, qlens = pad_reads([r[:60] if bufs == (2, 4) else r for r in reads[:256]], dev)
    R, L = qs.shape
    # None: the buffers collect_seeds_device gives the kernels
    MAXC, MAXS = bufs or (seed_buffers(L),) * 2
    rng = np.random.default_rng(27)
    pivots = rng.integers(0, 1 << 20, R) % np.maximum(qlens.cpu().numpy(), 1)
    pivots = torch.from_numpy(pivots.astype(np.int32)).to(dev)
    minis = torch.from_numpy(rng.integers(1, 4, R).astype(np.int32)).to(dev)
    zeros, ones = torch.zeros_like(pivots), torch.ones_like(pivots)
    for single_sweep, piv, mi in ((False, zeros, ones), (True, pivots, minis)):
        before = smem_pass_cuda.launches
        got = smem_pass(fm, qs, qlens, piv, mi, single_sweep, MAXC, MAXS)
        assert smem_pass_cuda.launches == before + 1
        want = smem_pass_torch(fm, qs, qlens, piv, mi, single_sweep, MAXC, MAXS)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert bool(got[2].any()) == (MAXC == 2)
    before = pass3_cuda.launches
    got = pass3(fm, qs, qlens, OPT.min_seed_len, OPT.max_mem_intv, MAXS)
    assert pass3_cuda.launches == before + 1
    want = pass3_torch(fm, qs, qlens, OPT.min_seed_len, OPT.max_mem_intv, MAXS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_collect_seeds_device_on_card_matches_native(dev, seeding_genome):
    from arachne_tpu.align.smem_native import collect_seeds_native, smem_available
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
