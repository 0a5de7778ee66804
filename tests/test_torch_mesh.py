"""The port's block-sharded FM-index (arachne_tpu_torch/parallel/mesh.py
ShardedFMTables, ops/fm_rank.py ShardedFMIndex) and the engine's placement
rule on the CPU, twins of tests/test_parallel.py: each against the JAX
package's ShardedFMTables on the 8-device CPU mesh that tests/conftest.py
forces, and against the host index's occ4 and the replicated path.  The
port's shards are CPU tensors, so occ4, S1 and S3 run their plain
versions, each block's record gathered from its shard.  Integer outputs:
tolerance 0."""

import contextlib
import filecmp
import io
import os

import jax
import numpy as np
import pytest
import torch

from arachne_tpu import index as ref_index
from arachne_tpu.align import ksw as ref_ksw
from arachne_tpu.align.smem import collect_seeds as ref_collect_seeds
from arachne_tpu.cli import main as reference_main
from arachne_tpu.config import ArachneConfig as RefConfig, MemOptions as RefMemOptions
from arachne_tpu.config import PipelineOptions as RefPipelineOptions
from arachne_tpu.ops import fm_seed as ref_fm_seed
from arachne_tpu.ops.engine import TpuEngine
from arachne_tpu.parallel import mesh as ref_mesh
from arachne_tpu_torch.cli import main as port_main
from arachne_tpu_torch.config import ArachneConfig, MemOptions, PipelineOptions
from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
from arachne_tpu_torch.ops import devicepool, engine as engine_mod
from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, ShardedFMIndex, occ4_device
from arachne_tpu_torch.ops.fm_seed import collect_seeds_device
from arachne_tpu_torch.ops.sw_extend import clamp_band
from arachne_tpu_torch.parallel import mesh
from torch_cli_util import make_fixture

OPT = MemOptions()
REF_OPT = RefMemOptions()
CPU = torch.device("cpu")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def idx(small_reference):
    packed = pack_reference(small_reference)
    return FMIndex(packed, build_fmindex(packed))


@pytest.fixture(scope="module")
def ref_idx(small_reference):
    packed = ref_index.pack_reference(small_reference)
    return ref_index.FMIndex(packed, ref_index.build_fmindex(packed))


@contextlib.contextmanager
def x64_restored():
    """Wide JAX tables turn jax_enable_x64 on process-wide: off again
    after."""
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def mutated_reads(idx, rng, n=24, L=140):
    """tests/test_parallel.py's reads: n windows of the forward strand with
    0-5 substitutions, a third of them with one N."""
    fwd = unpack_2bit(idx.packed.pac, 0, idx.l_pac)
    reads = []
    for _ in range(n):
        p = int(rng.integers(0, len(fwd) - L - 1))
        r = fwd[p : p + L].copy()
        for _ in range(int(rng.integers(0, 6))):
            j = int(rng.integers(0, L))
            r[j] = (r[j] + 1) % 4
        if rng.integers(0, 3) == 0:
            r[int(rng.integers(0, L))] = 4
        reads.append(r)
    return reads


def key(mems):
    return [(m.k, m.l, m.s, m.qb, m.qe) for m in mems]


def rows(idx, n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(-1, idx.seq_len + 1, n),
                           [-1, 0, idx.seq_len, idx.primary, idx.primary - 1]]).astype(np.int64)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_occ4_matches_jax_and_host(idx, ref_idx, n):
    """1, 2, 3 and 8 shards: the records split into ceil(rows / n) a
    shard, the last padded with zero records."""
    tab = mesh.ShardedFMTables(idx, [CPU] * n)
    records = idx.fm.occ.shape[0]
    assert len(tab.shards) == n and tab.per == -(-records // n) and not tab.wide
    pad = tab.per * n - records
    assert pad == 0 or not tab.shards[-1][-pad:].any()
    ks = rows(idx, 300, 40 + n)
    got = tab.occ4(ks)
    np.testing.assert_array_equal(got, idx.occ4(ks))
    jtab = ref_mesh.ShardedFMTables(ref_idx, ref_mesh.make_mesh(n))
    np.testing.assert_array_equal(got, jtab.occ4(ks))


def test_device_seeding_against_sharded_index(idx, ref_idx):
    """The three-pass seeding over 8 shards equals the scalar collector,
    the replicated tables and the JAX package's sharded run."""
    reads = mutated_reads(idx, np.random.default_rng(5))
    got = collect_seeds_device(reads, OPT, mesh.ShardedFMTables(idx, [CPU] * 8))
    repl = collect_seeds_device(reads, OPT, DeviceFMIndex.from_host(idx, CPU))
    jtab = ref_mesh.ShardedFMTables(ref_idx, ref_mesh.make_mesh(8))
    want = ref_fm_seed.collect_seeds_device(ref_idx, reads, REF_OPT, dfm=jtab)
    for r, read in enumerate(reads):
        assert key(got[r]) == key(repl[r]) == key(want[r]), r
        assert key(got[r]) == key(ref_collect_seeds(ref_idx, read, REF_OPT)), r


def test_replicated_and_sharded_seeding_agree(idx):
    reads = mutated_reads(idx, np.random.default_rng(6), n=16)
    repl = collect_seeds_device(reads, OPT, DeviceFMIndex.from_host(idx, CPU))
    for n in (2, 3):
        shrd = collect_seeds_device(reads, OPT, mesh.ShardedFMTables(idx, [CPU] * n))
        assert [key(a) for a in repl] == [key(b) for b in shrd]


def test_wide_sharded_occ4_and_seeding(idx, ref_idx):
    """int64 tables, sharded and forced: occ4 and seeding equal the host
    index, the scalar collector and the JAX package's wide sharded run."""
    tab = mesh.ShardedFMTables(idx, [CPU] * 8, wide=True)
    assert tab.wide and tab.idt == torch.int64
    ks = rows(idx, 200, 7)
    reads = mutated_reads(idx, np.random.default_rng(7), n=12)
    got = collect_seeds_device(reads, OPT, tab)
    with x64_restored():
        jtab = ref_mesh.ShardedFMTables(ref_idx, ref_mesh.make_mesh(), wide=True)
        assert jtab.wide
        np.testing.assert_array_equal(tab.occ4(ks), jtab.occ4(ks))
        want = ref_fm_seed.collect_seeds_device(ref_idx, reads, REF_OPT, dfm=jtab)
    np.testing.assert_array_equal(tab.occ4(ks), idx.occ4(ks))
    for r, read in enumerate(reads):
        assert key(got[r]) == key(want[r]) == key(ref_collect_seeds(ref_idx, read, REF_OPT)), r


def test_sharded_extend_matches_jax_and_scalar(rng):
    """tests/test_parallel.py's problems over 3 devices (16 problems: the
    batch is padded to 18 and trimmed back)."""
    from arachne_tpu.ops.sw_extend import clamp_band as ref_clamp_band

    B, qlen, tlen = 16, 64, 96
    ts = rng.integers(0, 4, (B, tlen)).astype(np.int8)
    qs = np.full((B, qlen), 4, np.int8)
    qs[:, :50] = ts[:, :50]
    w = clamp_band(OPT, 50, 100, 5, 1)
    assert w == ref_clamp_band(REF_OPT, 50, 100, 5, 1)
    args = (qs, ts, np.full(B, 50, np.int32), np.full(B, tlen, np.int32),
            np.full(B, w, np.int32), np.full(B, 19, np.int32))
    got = mesh.sharded_extend([CPU] * 3, OPT, *args)
    want = ref_mesh.sharded_extend(ref_mesh.make_mesh(8), REF_OPT, *args)
    assert len(got) == 6
    for g, e in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(e))
    mat = REF_OPT.scoring_matrix()
    for i in range(B):
        exp = ref_ksw.extend2(qs[i, :50].astype(np.uint8), ts[i].astype(np.uint8), mat,
                              6, 1, 6, 1, w, 5, 100, 19)
        assert tuple(int(o[i]) for o in got[:len(exp)]) == exp


def test_two_seeding_devices_share_one_sharded_table(idx, ref_idx):
    """The 2-D mesh's counterpart: one table sharded over 4 devices,
    queried from two seeding devices (data-parallel readers), each equal to
    the host index, the JAX package's (data, index) mesh and the
    replicated seeding."""
    from jax.sharding import Mesh

    base = mesh.ShardedFMTables(idx, [CPU] * 4)
    ks = rows(idx, 200, 8)
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "index"))
    want = ref_mesh.ShardedFMTables(ref_idx, jmesh, index_axis="index").occ4(ks)
    reads = mutated_reads(idx, np.random.default_rng(9), n=8)
    repl = collect_seeds_device(reads, OPT, DeviceFMIndex.from_host(idx, CPU))
    for dev in (CPU, torch.device("cpu", 0)):
        tab = base.on(dev)
        # one copy of the records, whichever device reads them
        assert all(a is b for a, b in zip(tab.shards, base.shards))
        k = torch.from_numpy(ks).to(dev, tab.idt)
        np.testing.assert_array_equal(occ4_device(tab, k).numpy(), want)
        assert [key(m) for m in collect_seeds_device(reads, OPT, tab)] == [key(m) for m in repl]
    np.testing.assert_array_equal(want, idx.occ4(ks))


def test_make_mesh_and_pad_to_multiple():
    assert mesh.make_mesh() == [CPU]
    pair = [CPU, torch.device("cpu", 0)]
    with devicepool.pinned(pair):
        assert mesh.make_mesh() == pair and mesh.make_mesh(1) == [CPU]
    x = np.arange(10, dtype=np.int32).reshape(5, 2)
    for m in (1, 3, 5):
        np.testing.assert_array_equal(mesh.pad_to_multiple(x, m, 7),
                                      ref_mesh.pad_to_multiple(x, m, 7))


def test_replicated_index_arrays_go_through_the_engine(idx, monkeypatch):
    monkeypatch.setattr(engine_mod, "_tables", engine_mod.weakref.WeakKeyDictionary())
    a, b = mesh.replicated_index_arrays([CPU, torch.device("cpu", 0)], idx)
    assert isinstance(a, DeviceFMIndex) and torch.equal(a.table, b.table)
    assert mesh.replicated_index_arrays([CPU], idx)[0] is a


PLACEMENTS = [(mode, n, budget) for mode in ("auto", "replicated", "sharded")
              for n in (1, 8) for budget in ("1", str(1 << 40))]


@pytest.mark.parametrize("mode,n,budget", PLACEMENTS,
                         ids=[f"{m}-{n}dev-budget{b}" for m, n, b in PLACEMENTS])
def test_placement_rule_matches_the_reference_engine(idx, ref_idx, monkeypatch, mode, n,
                                                     budget):
    """arachne_tpu/ops/engine.py:74-110's rule: auto shards exactly when
    there is more than one device and the tables exceed ARACHNE_HBM_BUDGET;
    sharded on one device is replicated; tables that fit neither way make
    the reference seed on the host and the port raise."""
    monkeypatch.setenv("ARACHNE_HBM_BUDGET", budget)
    for cache in ("_tables", "_sharded", "_placement"):
        monkeypatch.setattr(engine_mod, cache, engine_mod.weakref.WeakKeyDictionary())
    cfg = RefConfig(pipeline=RefPipelineOptions(index_mode=mode))
    devs = jax.devices()[:n]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devs)
    with contextlib.redirect_stdout(io.StringIO()):
        ref = TpuEngine(ref_idx, cfg, device_seeding=True).dfm
    want = ("host" if ref is None else
            "sharded" if isinstance(ref, ref_mesh.ShardedFMTables) else "replicated")
    with devicepool.pinned([CPU] * n):
        if want == "host":
            with pytest.raises(RuntimeError, match="over the budget"):
                engine_mod.rank_tables(idx, CPU, mode)
            return
        got = engine_mod.rank_tables(idx, CPU, mode)
        assert got is engine_mod.rank_tables(idx, CPU, mode)   # built once
    assert ("sharded" if isinstance(got, ShardedFMIndex) else "replicated") == want
    if want == "sharded":
        assert len(got.shards) == n and got.device == CPU


@pytest.mark.parametrize("n", [1, 8], ids=["1dev", "8dev"])
def test_budget_between_48_and_64_bytes_a_block(idx, ref_idx, monkeypatch, n):
    """A deliberate difference: the reference counts a narrow index at 48
    bytes a block, planar occ and words (arachne_tpu/ops/engine.py:81); the
    port counts the 64-byte records it uploads (DeviceFMIndex.table_bytes).
    At a budget between the two the reference replicates; the port's auto
    shards on 8 devices and raises on one."""
    blocks = -(-idx.seq_len // 128)
    narrow, records = 48 * blocks, DeviceFMIndex.table_bytes(idx)
    assert narrow < records
    monkeypatch.setenv("ARACHNE_HBM_BUDGET", str((narrow + records) // 2))
    for cache in ("_tables", "_sharded", "_placement"):
        monkeypatch.setattr(engine_mod, cache, engine_mod.weakref.WeakKeyDictionary())
    cfg = RefConfig(pipeline=RefPipelineOptions(index_mode="auto"))
    devs = jax.devices()[:n]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devs)
    with contextlib.redirect_stdout(io.StringIO()):
        ref = TpuEngine(ref_idx, cfg, device_seeding=True).dfm
    assert ref is not None and not isinstance(ref, ref_mesh.ShardedFMTables)
    with devicepool.pinned([CPU] * n):
        if n == 1:
            with pytest.raises(RuntimeError, match="over the budget"):
                engine_mod.rank_tables(idx, CPU, "auto")
            return
        got = engine_mod.rank_tables(idx, CPU, "auto")
    assert isinstance(got, ShardedFMIndex) and len(got.shards) == n


def test_auto_placement_is_decided_once(idx, monkeypatch):
    """Under auto, the placement of an index on a device list is decided on
    the first call and kept: once the first engine's upload has shrunk the
    free memory below the tables, a later engine gets the same tables, not
    a second copy in the other placement."""
    for cache in ("_tables", "_sharded", "_placement"):
        monkeypatch.setattr(engine_mod, cache, engine_mod.weakref.WeakKeyDictionary())
    need = DeviceFMIndex.table_bytes(idx)
    with devicepool.pinned([CPU, CPU]):
        monkeypatch.setattr(engine_mod, "hbm_budget", lambda device: 2 * need)
        first = engine_mod.rank_tables(idx, CPU, "auto")
        monkeypatch.setattr(engine_mod, "hbm_budget", lambda device: need - 1)
        assert engine_mod.rank_tables(idx, CPU, "auto") is first
    assert isinstance(first, DeviceFMIndex) and not engine_mod._sharded.get(idx)
    # decided the other way on a fresh start, and kept once more
    monkeypatch.setattr(engine_mod, "_placement", engine_mod.weakref.WeakKeyDictionary())
    with devicepool.pinned([CPU, CPU]):
        tab = engine_mod.rank_tables(idx, CPU, "auto")
        monkeypatch.setattr(engine_mod, "hbm_budget", lambda device: 2 * need)
        assert isinstance(tab, ShardedFMIndex) and engine_mod.rank_tables(idx, CPU, "auto") is tab


def test_engine_takes_its_index_mode(idx, monkeypatch):
    """TorchEngine seeds against rank_tables(idx, device, index_mode); an
    unknown mode raises."""
    from arachne_tpu_torch.ops.engine import TorchEngine

    monkeypatch.delenv("ARACHNE_HBM_BUDGET", raising=False)
    monkeypatch.setattr(engine_mod, "_sharded", engine_mod.weakref.WeakKeyDictionary())
    cfg = ArachneConfig(pipeline=PipelineOptions(index_mode="sharded"))
    with devicepool.pinned([CPU, CPU]):
        eng = TorchEngine(idx, cfg, device="cpu", device_seeding=True)
    assert isinstance(eng.dfm, mesh.ShardedFMTables) and len(eng.dfm.shards) == 2
    with pytest.raises(ValueError, match="index mode"):
        engine_mod.rank_tables(idx, CPU, "striped")


def test_sharded_align_writes_the_reference_bytes(tmp_path, monkeypatch):
    """``align --index-mode sharded`` with device seeding on torch-cpu,
    the pool pinned to [cpu, cpu] (two shards), against the JAX package's
    ``align --engine tpu --index-mode sharded`` in this process, where the
    8-device CPU mesh makes it shard too (a subprocess would see one
    device and replicate).  Both must really have sharded, and the SAM
    bytes must be equal."""
    from arachne_tpu_torch.parallel import mesh as port_mesh

    f = make_fixture(tmp_path)
    built = {"port": 0, "ref": 0}

    class CountedPort(port_mesh.ShardedFMTables):
        def __init__(self, *a, **k):
            built["port"] += 1
            super().__init__(*a, **k)

    class CountedRef(ref_mesh.ShardedFMTables):
        def __init__(self, *a, **k):
            built["ref"] += 1
            super().__init__(*a, **k)

    monkeypatch.setattr(port_mesh, "ShardedFMTables", CountedPort)
    monkeypatch.setattr(ref_mesh, "ShardedFMTables", CountedRef)
    monkeypatch.setattr(engine_mod, "_sharded", engine_mod.weakref.WeakKeyDictionary())
    monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "1")
    outs = {}
    for name, main, engine in (("ref", reference_main, "tpu"), ("port", port_main, "torch-cpu")):
        outs[name] = str(tmp_path / f"out_{name}")
        args = ["align", outs[name], f["ref"], f["r1"], f["r2"], "--engine", engine,
                "--index-mode", "sharded", "--sam", "-t", "1"]
        with contextlib.redirect_stdout(io.StringIO()):
            if name == "port":
                with devicepool.pinned([CPU, CPU]):
                    main(args)
            else:
                main(args)
    assert built["port"] >= 1 and built["ref"] >= 1
    names = sorted(os.listdir(outs["ref"]))
    assert names and sorted(os.listdir(outs["port"])) == names
    for fn in names:
        assert filecmp.cmp(os.path.join(outs["ref"], fn), os.path.join(outs["port"], fn),
                           shallow=False), fn
