"""The port's wide_device_check (arachne_tpu_torch/scripts/wide_device_check.py)
on the CPU, on a small index whose tables are forced wide (int64): its
checks pass there, its rank rows give the JAX package's wide occ4, and its
command line refuses an index below 2^31 rows.  On the CPU the kernels'
plain versions stand in for K5, S1 and S3.  Integers: tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arachne_tpu import index as ref_index
from arachne_tpu.ops import fm_rank as jfm
from arachne_tpu_torch.index import FMIndex, build_index_files, load_index
from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, occ4_device
from arachne_tpu_torch.scripts import wide_device_check as wdc
from arachne_tpu_torch.scripts.make_scale_genome import write_contig

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scale_index(tmp_path_factory):
    """A 2 x 40 kbp genome of make_scale_genome (planted repeats, N runs),
    indexed by the port, and the path of its .arx.npz."""
    fasta = str(tmp_path_factory.mktemp("wide") / "genome.fa")
    rng = np.random.default_rng(7)
    with open(fasta, "wb") as fh:
        for c in range(2):
            write_contig(fh, f"chr{c + 1}", 40_000, rng)
    arx = build_index_files(fasta)
    return FMIndex(*load_index(arx)), arx


def test_checks_pass_on_tables_forced_wide(scale_index):
    idx, _ = scale_index
    dfm = DeviceFMIndex.from_host(idx, "cpu", wide=True)
    assert dfm.idt == torch.int64
    res = wdc.check(idx, dfm, n_reads=48)
    assert res["reads"] == 48 and res["seeds"] > 48
    # the edge rows that lie in the index, and no row at 2^31 in so small a one
    assert res["rank_rows"] == 2 * 2048 + 4 and res["rank_rows_wide"] == 0


def test_rank_rows_give_the_jax_packages_wide_occ4(scale_index):
    idx, arx = scale_index
    ks = wdc.rank_rows(idx.seq_len, idx.primary)
    assert ks.min() == -1 and ks.max() == idx.seq_len and idx.primary in ks
    port = occ4_device(DeviceFMIndex.from_host(idx, "cpu", wide=True), torch.from_numpy(ks))
    try:
        ref_idx = ref_index.FMIndex(*ref_index.load_index(arx))
        jd = jfm.DeviceFMIndex.from_host(ref_idx, wide=True)
        assert jd.idt == jnp.int64
        want = np.asarray(jfm.occ4_device(jd, jnp.asarray(ks)))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert port.dtype == torch.int64 and np.array_equal(port.numpy(), want)


def test_rank_rows_on_a_wide_index_reach_past_2_31():
    seq_len = 2_400_000_000
    ks = wdc.rank_rows(seq_len, 1_234_567_890)
    assert (ks >= 1 << 31).sum() >= 2048 + 2
    assert {-1, 0, seq_len, (1 << 31) - 1, 1 << 31} <= set(ks.tolist())
    assert ks.max() == seq_len


def test_cli_refuses_an_index_below_2_31_rows(scale_index, capsys):
    _, arx = scale_index
    with pytest.raises(SystemExit, match="below 2\\^31"):
        wdc.main([arx])


def test_wide_seeding_parity_refuses_a_narrow_table(scale_index):
    from arachne_tpu_torch.seeding_bench import wide_seeding_parity

    idx, _ = scale_index
    with pytest.raises(ValueError, match="2\\^31"):
        wide_seeding_parity(DeviceFMIndex.from_host(idx, "cpu", wide=True), 4)
