"""The port's FM-index rank layer (arachne_tpu_torch/ops/fm_rank.py) on the
CPU, where occ4_device runs kernel K5's plain version, against the JAX
package's (arachne_tpu/ops/fm_rank.py) and the host index, with narrow
(int32) and wide (int64) tables.  Integer outputs: tolerance 0."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arachne_tpu import index as ref_index
from arachne_tpu.ops import fm_rank as jfm
from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference
from arachne_tpu_torch.ops import fm_rank as tfm
from arachne_tpu_torch.ops.cuda_rank import rank_cuda

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def idx(small_reference):
    """The port's own index of the reference sequence."""
    packed = pack_reference(small_reference)
    return FMIndex(packed, build_fmindex(packed))


@pytest.fixture(scope="module")
def ref_idx(small_reference):
    """The JAX package's index of the same sequence."""
    packed = ref_index.pack_reference(small_reference)
    return ref_index.FMIndex(packed, ref_index.build_fmindex(packed))


@contextlib.contextmanager
def both_tables(ref_idx, idx, wide):
    """(JAX DeviceFMIndex of the JAX package's index, port DeviceFMIndex of
    the port's index, on the CPU).  Wide JAX tables turn jax_enable_x64 on
    process-wide; it is turned off again after."""
    try:
        yield jfm.DeviceFMIndex.from_host(ref_idx, wide=wide), tfm.DeviceFMIndex.from_host(
            idx, "cpu", wide=wide)
    finally:
        jax.config.update("jax_enable_x64", False)


def edge_rows(idx):
    return [-1, 0, 1, idx.seq_len - 1, idx.seq_len, idx.primary, idx.primary - 1,
            idx.primary + 1]


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_occ4_matches_jax_and_host(idx, ref_idx, wide):
    rng = np.random.default_rng(31)
    ks = np.concatenate([rng.integers(-1, idx.seq_len + 1, 600), edge_rows(idx)])
    ks = ks.astype(np.int64 if wide else np.int32)
    before = rank_cuda.launches
    with both_tables(ref_idx, idx, wide) as (jd, td):
        assert td.idt == (torch.int64 if wide else torch.int32)
        got = tfm.occ4_device(td, torch.from_numpy(ks))
        want = np.asarray(jfm.occ4_device(jd, jnp.asarray(ks)))
    assert got.dtype == td.idt and got.shape == (len(ks), 4)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), idx.occ4(ks.astype(np.int64)))
    assert rank_cuda.launches == before    # CPU tensors never reach the kernel


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("is_back", [False, True], ids=["forward", "backward"])
def test_extend_matches_jax(idx, ref_idx, wide, is_back):
    rng = np.random.default_rng(32 + is_back)
    n = 400
    it = np.int64 if wide else np.int32
    x0 = rng.integers(1, idx.seq_len, n)
    x1 = rng.integers(1, idx.seq_len, n)
    x2 = np.minimum(rng.integers(0, 60, n), idx.seq_len + 1 - x0)
    # intervals that hold the primary row, and the whole BWT
    x0[:3] = [idx.primary - 2, idx.primary, 1]
    x2[:3] = [5, 1, idx.seq_len]
    if is_back:
        x0, x1 = x1, x0
    args = [a.astype(it) for a in (x0, x1, x2)]
    with both_tables(ref_idx, idx, wide) as (jd, td):
        want = jfm.extend_device(jd, *(jnp.asarray(a) for a in args), is_back=is_back)
        want = [np.asarray(w) for w in want]
        # the K5 wrapper's route and the plain one of the lockstep S1/S3
        for extend in (tfm.extend_device, tfm.extend_torch):
            got = extend(td, *(torch.from_numpy(a) for a in args), is_back=is_back)
            for g, w in zip(got, want):
                assert g.dtype == td.idt
                assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_rank_kernel_plain_version_on_interior_rows(idx, ref_idx, wide):
    """The parity the reference's microbenchmark holds its Pallas rank
    kernel to (scripts/seeding_microbench.py:102-108): 2048 interior rows
    against occ4_device.  The port's K5 takes edge rows too (above)."""
    rng = np.random.default_rng(33)
    ks = rng.integers(1, idx.seq_len - 1, 2048).astype(np.int64 if wide else np.int32)
    with both_tables(ref_idx, idx, wide) as (jd, td):
        got = tfm.occ4_torch(td, torch.from_numpy(ks))
        want = np.asarray(jfm.occ4_device(jd, jnp.asarray(ks)))
    assert np.array_equal(got.numpy(), want)


def test_table_bytes_and_layout(idx):
    """The record table as uploaded: one 64-byte record per block and one
    past the end, (n, 16) int32 or (n, 8) int64; ``occ`` and ``words`` are
    views into it (no second copy) that keep the host index's counts and
    the words' bit patterns; table_bytes counts what from_host puts on the
    device."""
    n = idx.fm.occ.shape[0]
    for wide in (False, True):
        td = tfm.DeviceFMIndex.from_host(idx, "cpu", wide=wide)
        assert td.table.shape == ((n, 8) if wide else (n, 16)) and td.table.is_contiguous()
        assert td.table.dtype == td.idt == (torch.int64 if wide else torch.int32)
        assert td.occ.data_ptr() == td.table.data_ptr()
        assert td.words.data_ptr() == td.table.data_ptr() + (32 if wide else 16)
        assert np.array_equal(td.words.numpy()[:-1].reshape(-1).view(np.uint32),
                              idx.fm.bwt_words)
        assert np.array_equal(td.occ.numpy(), idx.fm.occ)
        nbytes = td.table.numel() * td.table.element_size()
        assert tfm.DeviceFMIndex.table_bytes(idx) == nbytes == n * 64
    assert not tfm.DeviceFMIndex.is_wide(idx)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_record_table_holds_the_host_tables(idx, wide):
    """Record by record: the counts first, then the block's eight words
    (after 16 bytes for int32, 32 for int64), then for int32 16 bytes of
    zero padding; the record past the end holds the one-past-the-end
    counts and zero words."""
    td = tfm.DeviceFMIndex.from_host(idx, "cpu", wide=wide)
    rec = td.table.numpy().view(np.uint32).reshape(-1, 16)
    n = rec.shape[0]
    occ = idx.fm.occ.astype(np.int64)
    if wide:
        counts = rec[:, 0:8].astype(np.int64)
        counts = counts[:, 0::2] | (counts[:, 1::2] << 32)
        words = rec[:, 8:16]
    else:
        counts = rec[:, 0:4].astype(np.int64)
        words = rec[:, 4:12]
        assert not rec[:, 12:16].any()
    assert np.array_equal(counts, occ)
    assert np.array_equal(words[: n - 1].reshape(-1), idx.fm.bwt_words)
    assert not words[n - 1].any()


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_from_planar_equals_from_host(idx, wide):
    """The constructor from planar tensors (the warm-up's and the tests'
    hand-made tables) builds the same record table as from_host."""
    td = tfm.DeviceFMIndex.from_host(idx, "cpu", wide=wide)
    it = np.int64 if wide else np.int32
    tp = tfm.DeviceFMIndex.from_planar(
        torch.from_numpy(idx.fm.occ.astype(it)),
        torch.from_numpy(idx.fm.bwt_words.view(np.int32)),
        torch.from_numpy(np.asarray(idx.fm.L2).astype(it)), idx.primary, idx.seq_len, idx.l_pac)
    assert torch.equal(tp.table, td.table) and torch.equal(tp.L2, td.L2)
    assert (tp.primary, tp.seq_len, tp.l_pac) == (td.primary, td.seq_len, td.l_pac)
    with pytest.raises(ValueError, match="words"):
        tfm.DeviceFMIndex.from_planar(tp.occ, torch.zeros(8, dtype=torch.int32), tp.L2,
                                      tp.primary, tp.seq_len, tp.l_pac)


def test_synthetic_wide_table_matches_jax():
    """seeding_bench's GRCh38-sized stand-in, cut to 512 blocks: random
    words and int64 counts written straight into the record table, ranked
    by the port's plain version and by the JAX package's occ4_device on
    the planar arrays of the same records."""
    from arachne_tpu_torch import seeding_bench

    td = seeding_bench.synthetic_table("cpu", 512, seed=4)
    assert td.idt == torch.int64 and td.seq_len == 512 * 128
    assert td.table.shape == (513, 8) and not td.words[-1].any()
    ks = seeding_bench.parity_rows(td, 1024)
    assert {-1, 0, td.seq_len, td.primary}.issubset(set(ks.tolist()))
    assert seeding_bench.rank_parity(td, 1024) == 0
    try:
        jax.config.update("jax_enable_x64", True)
        jd = jfm.DeviceFMIndex(
            occ=jnp.asarray(td.occ.numpy()),
            words=jnp.asarray(td.words[:-1].reshape(-1).numpy().view(np.uint32)),
            L2=jnp.asarray(td.L2.numpy()), primary=td.primary, seq_len=td.seq_len, l_pac=td.l_pac)
        want = np.asarray(jfm.occ4_device(jd, jnp.asarray(ks.numpy())))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert np.array_equal(tfm.occ4_device(td, ks).numpy(), want)


def test_rank_bytes_counts_the_query_and_the_result():
    """K5's bound (seeding_bench.rank_bytes): a query's row read, its
    block's counts and 32 bytes of words, its four counts written."""
    from arachne_tpu_torch import seeding_bench

    wide = seeding_bench.synthetic_table("cpu", 4)
    assert seeding_bench.rank_bytes(wide, 1 << 20) == 104 << 20
    narrow = tfm.DeviceFMIndex.from_planar(
        torch.zeros((2, 4), dtype=torch.int32), torch.zeros(8, dtype=torch.int32),
        torch.zeros(5, dtype=torch.int32), 1, 128, 64)
    assert seeding_bench.rank_bytes(narrow, 10) == 680


def test_seeding_bench_needs_the_card(monkeypatch):
    from arachne_tpu_torch import seeding_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        seeding_bench.main(["--wide-blocks", "0"])
