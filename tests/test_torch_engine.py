"""TorchEngine (arachne_tpu_torch/ops/engine.py) on the CPU, where its
kernels run as their plain PyTorch versions, inside the port's own RFA
workflow, must produce barcode results identical to the JAX package's
scalar oracle engine across the whole DoRFAForOneBarcode workflow (the
port's twin of tests/test_engine_equivalence.py).  Each side runs on its
own package's index, records and options."""

import numpy as np
import pytest
import torch

from arachne_tpu import config as ref_config
from arachne_tpu import index as ref_index
from arachne_tpu import rfa as ref_rfa
from arachne_tpu_torch.config import ArachneConfig
from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
from arachne_tpu_torch.rfa import FastQRecordView, do_rfa_for_one_barcode
from arachne_tpu_torch.rfa.engine import process_barcodes
from arachne_tpu_torch.ops import sw_global
from arachne_tpu_torch.ops.engine import TorchEngine

torch.set_num_threads(1)
CFG = ArachneConfig()
REF_CFG = ref_config.ArachneConfig()
BASES = np.array(list("ACGT"))


def to_str(codes):
    return "".join(BASES[codes])


@pytest.fixture(scope="module")
def genome(small_reference):
    packed = pack_reference(small_reference)
    idx = FMIndex(packed, build_fmindex(packed))
    return idx, unpack_2bit(packed.pac, 0, packed.l_pac)


@pytest.fixture(scope="module")
def ref_idx(small_reference):
    """The JAX package's index of the same sequence."""
    packed = ref_index.pack_reference(small_reference)
    return ref_index.FMIndex(packed, ref_index.build_fmindex(packed))


@pytest.fixture(scope="module")
def engine(genome):
    return TorchEngine(genome[0], CFG, device="cpu")


def record(r1, r2, name, barcode=b"A01C02B03D04"):
    return FastQRecordView(
        read1=to_str(r1).encode(), qual1=b"I" * len(r1),
        read2=to_str(r2).encode(), qual2=b"I" * len(r2),
        barcode=barcode, valid=True, read_info=name, read_group="",
    )


def make_reads(fwd, rng, n_pairs=8, with_mutations=True, indel=False, inserted=0):
    recs = []
    for i in range(n_pairs):
        pos = int(rng.integers(0, len(fwd) - 320))
        frag = fwd[pos : pos + 300]
        r1 = frag[:100].copy()
        r2 = (3 - frag[200:300][::-1]).astype(np.uint8)
        if with_mutations and rng.integers(0, 2):
            for _ in range(int(rng.integers(1, 4))):
                j = int(rng.integers(0, 100))
                r1[j] = (r1[j] + 1) % 4
        if indel and i % 2 == 0:
            r1 = np.concatenate([r1[:40], r1[43:], frag[100:103]])
        if inserted and i % 2 == 0:
            extra = rng.integers(0, 4, inserted).astype(r1.dtype)
            r1 = np.concatenate([r1[:50], extra, r1[50 : 100 - inserted]])
        recs.append(record(r1, r2, f"pair{i}"))
    return recs


def snapshot(res):
    return [
        [
            (
                a.contig, a.pos, a.aend, a.score, a.mapq, a.reversed_,
                a.active, a.is_proper, a.duplicate, tuple(a.cigar),
                a.mismatches, a.matches, a.indels, a.soft_clipped,
                tuple(a.mismatch_locs), round(a.log_alignment_probability, 9),
                a.molecule_id, a.active_molecule,
            )
            for a in alist
        ]
        for alist in res.alignments
    ]


def as_ref(recs):
    """The same records as the JAX package's FastQRecordView."""
    return [ref_rfa.FastQRecordView(**vars(r)) for r in recs]


def assert_same_as_oracle(idx, ref_idx, recs, engine):
    ref = ref_rfa.do_rfa_for_one_barcode(ref_idx, REF_CFG, as_ref(recs), unique_barcode=True)
    got = do_rfa_for_one_barcode(idx, CFG, recs, unique_barcode=True, extender=engine)
    assert ref.ran_rfa == got.ran_rfa
    assert snapshot(ref) == snapshot(got)
    return got


@pytest.mark.parametrize(
    "seed,n_pairs,indel",
    [(11, 8, False), (5, 2, False), (13, 8, True), (21, 8, "ins5"), (22, 8, "ins5")],
)
def test_barcode_identical_to_oracle(genome, ref_idx, engine, seed, n_pairs, indel):
    """``indel`` True: 3-base deletions; "ins5": 5 inserted bases, where the
    scalar oracle's ksw.global2 walk turns out of the insertion into a
    deletion and the batched walk (K4's plain version) must take the same
    turns."""
    idx, fwd = genome
    recs = make_reads(fwd, np.random.default_rng(seed), n_pairs=n_pairs, indel=indel is True,
                      inserted=5 if indel == "ins5" else 0)
    before = sw_global.traceback_fetches
    got = assert_same_as_oracle(idx, ref_idx, recs, engine)
    assert got.ran_rfa == (n_pairs > 2)
    if indel:
        assert sw_global.traceback_fetches > before
    if indel == "ins5":
        # a turn: a D right before an I (bridge encoding, I = 1, D = 2)
        ops = [a.cigar[::2] for alist in got.alignments for a in alist]
        assert any(any((a, b) == (2, 1) for a, b in zip(o, o[1:])) for o in ops)


def test_repeat_heavy_barcode_identical(genome, ref_idx, engine):
    """Reads inside the planted repeat exercise multi-hit + rescue."""
    idx, fwd = genome
    recs = []
    for i, pos in enumerate([350, 420, 480, 540, 600, 1250]):
        frag = fwd[pos : pos + 260]
        r2 = (3 - frag[170:260][::-1]).astype(np.uint8)
        recs.append(record(frag[:90].copy(), r2, f"rep{i}", b"A09C08B07D06"))
    assert_same_as_oracle(idx, ref_idx, recs, engine)


def test_mutated_mate_rescue_identical(genome, ref_idx, engine):
    idx, fwd = genome
    recs = make_reads(fwd, np.random.default_rng(7), n_pairs=5, with_mutations=False)
    # wreck one R2's seeds so it needs rescue
    r2 = np.frombuffer(recs[2].read2, dtype=np.uint8).copy()
    for i in range(0, len(r2), 12):
        r2[i : i + 1] = ord("A") if r2[i] != ord("A") else ord("C")
    recs[2].read2 = r2.tobytes()
    assert_same_as_oracle(idx, ref_idx, recs, engine)


def test_process_barcodes_identical(genome, ref_idx, engine):
    idx, fwd = genome
    rng = np.random.default_rng(33)
    sets = []
    for bi in range(4):
        recs = make_reads(fwd, rng, n_pairs=int(rng.integers(2, 9)))
        for r in recs:
            r.barcode = f"B{bi:02d}".encode()
            r.read_info = f"b{bi}_{r.read_info}"
        sets.append((recs, True))
    singles = [ref_rfa.do_rfa_for_one_barcode(ref_idx, REF_CFG, as_ref(recs), uniq)
               for recs, uniq in sets]
    batched = process_barcodes(idx, CFG, sets, engine)
    assert len(batched) == len(singles)
    for a, b in zip(singles, batched):
        assert a.ran_rfa == b.ran_rfa
        assert snapshot(a) == snapshot(b)


def test_warmup_on_cpu_is_a_no_op(engine):
    from arachne_tpu_torch.ops.cuda_extend import extend_cuda
    from arachne_tpu_torch.ops.engine import warmup

    before = extend_cuda.launches
    warmup(engine.device)
    assert extend_cuda.launches == before


def test_device_seeding_resolution(monkeypatch):
    """An explicit argument wins, then ARACHNE_DEVICE_SEEDING ("0"/"1"); any
    other value raises rather than being ignored; unset means host seeding."""
    from arachne_tpu_torch.ops.engine import resolve_device_seeding

    monkeypatch.delenv("ARACHNE_DEVICE_SEEDING", raising=False)
    assert resolve_device_seeding() is False
    assert resolve_device_seeding(True) is True
    monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "1")
    assert resolve_device_seeding() is True
    assert resolve_device_seeding(False) is False
    monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "0")
    assert resolve_device_seeding() is False
    assert resolve_device_seeding(True) is True
    for bad in ("true", "yes", "", "2"):
        monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", bad)
        with pytest.raises(ValueError, match="ARACHNE_DEVICE_SEEDING"):
            resolve_device_seeding()
        with pytest.raises(ValueError):
            TorchEngine(None, CFG, device="cpu")
        assert resolve_device_seeding(True) is True


def test_engines_share_one_table_upload(genome, monkeypatch):
    from arachne_tpu_torch.ops import engine as engine_mod

    idx, _ = genome
    monkeypatch.delenv("ARACHNE_DEVICE_SEEDING", raising=False)
    uploads = []
    real = engine_mod.DeviceFMIndex.from_host
    monkeypatch.setattr(engine_mod.DeviceFMIndex, "from_host",
                        staticmethod(lambda *a, **k: uploads.append(a) or real(*a, **k)))
    monkeypatch.setattr(engine_mod, "_tables", engine_mod.weakref.WeakKeyDictionary())
    a = TorchEngine(idx, CFG, device="cpu", device_seeding=True)
    b = TorchEngine(idx, CFG, device="cpu", device_seeding=True)
    assert a.dfm is b.dfm and len(uploads) == 1
    assert TorchEngine(idx, CFG, device="cpu").dfm is None


def test_device_seeding_raises_when_the_tables_do_not_fit(genome, monkeypatch):
    """No silent switch to host seeding: a card without room for the
    replicated tables refuses device seeding (sharding them takes a second
    device: tests/test_torch_mesh.py)."""
    from arachne_tpu_torch.ops import engine as engine_mod

    idx, _ = genome
    monkeypatch.setattr(engine_mod, "_tables", engine_mod.weakref.WeakKeyDictionary())
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1024, 1 << 34))
    with pytest.raises(RuntimeError, match="rank tables need"):
        engine_mod.device_tables(idx, torch.device("cuda", 0))


def test_device_seeded_barcode_identical_to_oracle(genome, ref_idx):
    idx, fwd = genome
    eng = TorchEngine(idx, CFG, device="cpu", device_seeding=True)
    assert eng.dfm is not None
    recs = make_reads(fwd, np.random.default_rng(17), n_pairs=6, indel=True)
    assert_same_as_oracle(idx, ref_idx, recs, eng)
