"""The port's bench (arachne_tpu_torch.bench) against the repository's root
bench.py and the JAX package, on the CPU at tiny sizes: each fixture
function equals the reference's fixture code run through the JAX package's
simulator with the same arguments; lines b-f through the kernels' plain
versions (engine "torch-cpu") write the bytes of ``python -m
arachne_tpu.cli align --engine oracle`` on the same fixtures and carry the
reference's metric names, units and detail keys; line a's problems, plain
K1 and cell count equal the reference's; a wrong recorded digest makes the
bench exit 1; ``seeding_bench.device_parts_ms`` refuses a profile that lost
a launch."""

import contextlib
import functools
import gzip
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arachne_tpu import cli as ref_cli
from arachne_tpu.index import build_index_files as ref_build_index_files
from arachne_tpu.index import parse_fasta as ref_parse_fasta
from arachne_tpu.io import simulate as ref_simulate
from arachne_tpu.ops.sw_extend import extend_batch_kernel
from arachne_tpu_torch import bench, device, measure, seeding_bench
from arachne_tpu_torch.config import MemOptions
from arachne_tpu_torch.ops.cuda_seed import pass3_cuda, smem_pass_cuda
from arachne_tpu_torch.ops.sw_extend import extend_batch_torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the tiny fixtures: the reference's functions with smaller sizes
TINY = {
    "repeat": dict(genome_bp=200_000, families=2, copies=4, barcodes=8, mean_pairs=4,
                   big_barcode_pairs=200, invalid_every=3),
    "hard": dict(genome_bp=200_000, families=2, copies=4, barcodes=6, mean_pairs=6,
                 invalid_every=3),
    "indel": dict(genome_bp=60_000, barcodes=2, molecules=2, pairs=10),
    "headline": dict(genome_bp=60_000, barcodes=2, molecules=1, pairs=12),
}


def reference_bench():
    """The root bench.py as a module, with the JAX compile cache left off
    (an empty JAX_COMPILATION_CACHE_DIR)."""
    old = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = ""
    try:
        spec = importlib.util.spec_from_file_location("reference_bench",
                                                      os.path.join(ROOT, "bench.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if old is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR")
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = old
    return mod


def write_ref_fasta(path, contig, seq):
    # the reference's FASTA writer (bench.py:100-104)
    with open(path, "w") as fh:
        fh.write(f">{contig}\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i : i + 70] + "\n")


def reference_fixture(kind, work, a):
    """The reference's fixture code (bench.py:87-124, 127-172, 189-206,
    300-344) at the sizes ``a``, through the JAX package's simulator and
    index: returns (ref, r1, r2)."""
    os.makedirs(work)
    ref = os.path.join(work, "ref.fa")
    if kind in ("headline", "indel"):
        rng = np.random.default_rng(20260820)
        write_ref_fasta(ref, "chr_bench",
                        "".join("ACGT"[i] for i in rng.integers(0, 4, a["genome_bp"])))
    else:
        repeat = kind == "repeat"
        seq = ref_simulate.make_repeat_genome(
            a["genome_bp"], n_families=a["families"], copies=a["copies"],
            unit_len=1000 if repeat else 2000, identity=0.95 if repeat else 0.999,
            seed=20260821)
        write_ref_fasta(ref, "chr_repeat" if repeat else "chr_hard", seq)
    ref_build_index_files(ref)
    r1, r2 = os.path.join(work, "R1.fq.gz"), os.path.join(work, "R2.fq.gz")
    if kind == "headline":
        cfg = ref_simulate.SimConfig(n_barcodes=a["barcodes"], molecules_per_barcode=a["molecules"],
                                     pairs_per_molecule=a["pairs"], seed=7)
    elif kind == "indel":
        cfg = ref_simulate.SimConfig(n_barcodes=a["barcodes"], molecules_per_barcode=a["molecules"],
                                     pairs_per_molecule=a["pairs"], indel_rate=0.1,
                                     vary_quals=True, seed=2)
    elif kind == "repeat":
        counts = ref_simulate.skewed_pair_counts(
            np.random.default_rng(11), a["barcodes"], mean_pairs=a["mean_pairs"], sigma=1.2,
            big_barcode_pairs=a["big_barcode_pairs"])
        cfg = ref_simulate.SimConfig(n_barcodes=a["barcodes"], pair_counts=counts,
                                     pairs_per_molecule=25, invalid_every=a["invalid_every"],
                                     seed=9)
    else:
        counts = ref_simulate.skewed_pair_counts(
            np.random.default_rng(23), a["barcodes"], mean_pairs=a["mean_pairs"], sigma=1.1)
        cfg = ref_simulate.SimConfig(n_barcodes=a["barcodes"], pair_counts=counts,
                                     pairs_per_molecule=25, error_rate=0.01, indel_rate=0.1,
                                     vary_quals=True, invalid_every=a["invalid_every"], seed=31)
    ref_simulate.simulate_linked_reads(ref_parse_fasta(ref), r1, r2, cfg)
    return ref, r1, r2


def oracle_digests(lib, out):
    """The shards' SHA-256 of the JAX package's ``align --engine oracle``."""
    old = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    os.environ["JAX_COMPILATION_CACHE_DIR"] = ""
    try:
        with measure.quiet(out + ".log"):
            ref_cli.main(["align", "--engine", "oracle", "--sam", "-t", "1", out, *lib])
    finally:
        if old is None:
            os.environ.pop("JAX_COMPILATION_CACHE_DIR")
        else:
            os.environ["JAX_COMPILATION_CACHE_DIR"] = old
    return measure.shard_digests(out)


@contextlib.contextmanager
def tiny_bench(reference):
    """bench with the tiny fixtures and ``reference`` as its recorded digests."""
    with pytest.MonkeyPatch.context() as mp:
        for kind, a in TINY.items():
            mp.setitem(bench.FIXTURES, kind, functools.partial(bench.FIXTURES[kind], **a))
        path = os.path.join(os.path.dirname(reference["cache"]), "reference.json")
        with open(path, "w") as fh:
            json.dump({"fixtures": reference["fixtures"]}, fh)
        mp.setattr(bench, "REFERENCE", path)
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The tiny fixtures as each package makes them, the JAX oracle's
    digests of each, and one run of bench lines b-f on torch-cpu."""
    tmp = tmp_path_factory.mktemp("bench")
    cache = str(tmp / "cache")
    libs, refs, fixtures = {}, {}, {}
    for kind, a in TINY.items():
        libs[kind] = bench.FIXTURES[kind](cache, **a)
        refs[kind] = reference_fixture(kind, str(tmp / f"ref_{kind}"), a)
        fixtures[kind] = {"fixture_sha256": bench.fixture_sha256(refs[kind]),
                          "output_sha256": oracle_digests(refs[kind], str(tmp / f"oracle_{kind}"))}
    reference = {"cache": cache, "fixtures": fixtures}
    with tiny_bench(reference):
        lines = bench.main(["--only", "repeat", "indel", "calibration", "device_seeded",
                            "headline", "--trials", "2", "--cache", cache], engine="torch-cpu")
    return dict(libs=libs, refs=refs, reference=reference, lines=lines, tmp=tmp)


@pytest.mark.parametrize("kind", list(TINY))
def test_fixture_equals_reference_fixture(world, kind):
    port, ref = world["libs"][kind], world["refs"][kind]
    with open(port[0], "rb") as a, open(ref[0], "rb") as b:
        assert a.read() == b.read()
    for p, r in zip(port[1:], ref[1:]):
        with gzip.open(p, "rb") as a, gzip.open(r, "rb") as b:
            text = a.read()
            assert text and text == b.read()
    assert bench.fixture_sha256(port) == bench.fixture_sha256(ref)


def test_repeat_fixture_has_its_hard_paths(world):
    with gzip.open(world["libs"]["repeat"][1], "rt") as fh:
        heads = fh.read().splitlines()[::4]
    barcodes = [h.split("BX:Z:")[1].split()[0] for h in heads]
    # one giant barcode first; every third barcode invalid
    assert barcodes.count(barcodes[0]) == TINY["repeat"]["big_barcode_pairs"]
    assert any("VX:i:0" in h for h in heads) and any("VX:i:1" in h for h in heads)


# the reference's metric names, units and detail keys (bench.py:160-558);
# the port adds the keys in PORT_KEYS to every end-to-end line
REFERENCE_LINES = {
    "repeat": ("repeat_genome_pairs_per_sec", "pairs/s/chip",
               {"pairs", "barcodes", "elapsed_s", "accuracy_overall", "accuracy_csv",
                "fixture"}),
    "indel": ("indel_e2e_pairs_per_sec", "pairs/s/chip",
              {"pairs", "accuracy_overall", "gapped_records", "stage_seconds", "fixture"}),
    "calibration": ("mapq_expected_calibration_error",
                    "|empirical-claimed| err, record-weighted",
                    {"pairs", "pairs_per_sec", "accuracy_overall", "calibration", "fixture"}),
    "device_seeded": ("end_to_end_device_seeded_pairs_per_sec", "pairs/s/chip",
                      {"pairs", "barcodes", "elapsed_s", "stage_seconds", "fixture"}),
    "headline": ("end_to_end_pairs_per_sec", "pairs/s/chip",
                 {"pairs", "barcodes", "elapsed_s", "trial_pairs_per_sec", "warmup_s_excluded",
                  "engine", "device", "baseline", "stage_seconds", "repeat_genome", "indel_e2e",
                  "mapq_calibration", "end_to_end_device_seeded"}),
}
PORT_KEYS = {"output_sha256", "fixture_sha256", "launches", "peak_device_bytes", "engine",
             "device", "card_after"}


@pytest.mark.parametrize("name", list(REFERENCE_LINES))
def test_line_names_units_and_keys(world, name):
    line = world["lines"][name]
    metric, unit, keys = REFERENCE_LINES[name]
    assert list(world["lines"]) == list(REFERENCE_LINES)     # the reference's order
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "correct", "detail"}
    assert (line["metric"], line["unit"]) == (metric, unit)
    assert keys | PORT_KEYS <= set(line["detail"])
    assert line["detail"]["engine"] == "torch-cpu" and line["detail"]["device"] == "cpu"
    assert np.isfinite(line["value"]) and line["value"] >= 0
    if name in ("device_seeded", "headline"):
        assert line["vs_baseline"] is None       # the reference's baseline was a TPU figure
    else:
        assert line["vs_baseline"] == line["detail"]["accuracy_overall"] > 0.9


@pytest.mark.parametrize("name", list(REFERENCE_LINES))
def test_line_writes_the_oracle_bytes(world, name):
    line = world["lines"][name]
    kind = bench.LINES[name][0]
    assert line["correct"] is True
    assert line["detail"]["output_sha256"] == world["reference"]["fixtures"][kind]["output_sha256"]
    assert line["detail"]["fixture_sha256"] == world["reference"]["fixtures"][kind]["fixture_sha256"]
    assert line["detail"]["pairs"] > 0 and not any(line["detail"]["launches"].values())


def test_device_seeded_equals_headline(world):
    e, f = world["lines"]["device_seeded"], world["lines"]["headline"]
    assert e["detail"]["output_sha256"] == f["detail"]["output_sha256"]
    assert f["detail"]["end_to_end_device_seeded"] == {"pairs_per_sec": e["value"],
                                                       "shards_equal_headline": True}
    assert len(f["detail"]["trial_pairs_per_sec"]) == 2
    assert "ARACHNE_DEVICE_SEEDING" not in os.environ


def test_gapped_records_and_calibration(world):
    ind, cal = world["lines"]["indel"], world["lines"]["calibration"]
    assert ind["detail"]["gapped_records"] > 0
    summary = world["lines"]["headline"]["detail"]
    assert summary["indel_e2e"]["gapped_records"] == ind["detail"]["gapped_records"]
    assert summary["mapq_calibration"]["expected_calibration_error"] == cal["value"]
    rows = cal["detail"]["calibration"]
    assert rows and sum(r["n"] for r in rows) > 0
    assert cal["value"] == pytest.approx(
        sum(r["n"] * abs(r["empirical_err"] - r["claimed_err"]) for r in rows)
        / sum(r["n"] for r in rows))


def test_wrong_digest_exits_1(world, capsys):
    fixtures = json.loads(json.dumps(world["reference"]["fixtures"]))
    shard = sorted(fixtures["headline"]["output_sha256"])[0]
    fixtures["headline"]["output_sha256"][shard] = "0" * 64
    reference = dict(world["reference"], fixtures=fixtures)
    with tiny_bench(reference), pytest.raises(SystemExit) as e:
        bench.main(["--only", "headline", "--trials", "1", "--cache", reference["cache"]],
                   engine="torch-cpu")
    assert e.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "end_to_end_pairs_per_sec" and line["correct"] is False


def test_gcups_line_needs_the_card(tmp_path):
    with pytest.raises(ValueError, match="on the card"):
        bench.main(["--only", "gcups", "--cache", str(tmp_path)], engine="torch-cpu")
    with pytest.raises(ValueError, match="on the card"):
        bench.gcups_line(torch.device("cpu"), B=8)


def test_gcups_problems_plain_k1_and_cells_match_reference():
    ref = reference_bench()
    opt = MemOptions()
    B, qlen, tlen = 64, 100, 250
    (qs, ts, qlens, tlens, ws, h0s), w = bench.gcups_problems(B, qlen, tlen)
    want_qs, want_ts = ref.make_problems(np.random.default_rng(0), B, qlen, tlen)
    np.testing.assert_array_equal(qs, want_qs)
    np.testing.assert_array_equal(ts, want_ts)
    assert w == ref.clamp_band(ref.MemOptions(), qlen, opt.w, opt.pen_clip5, 1)
    assert (h0s == 19).all() and (ws == w).all()
    mat = opt.scoring_matrix()
    gaps = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins)
    got = extend_batch_torch(*[torch.from_numpy(a) for a in (qs, ts, qlens, tlens, ws, h0s)],
                             torch.as_tensor(mat, dtype=torch.int32), zdrop=opt.zdrop, **gaps)
    want = extend_batch_kernel(*[jnp.asarray(a) for a in (qs, ts, qlens, tlens, ws, h0s)],
                               jnp.asarray(mat, jnp.int32), qmax=qlen, tmax=tlen,
                               zdrop=opt.zdrop, **gaps)
    np.testing.assert_array_equal(got.numpy(), np.stack([np.asarray(o) for o in want]))
    # the reference's count of in-band cells (bench.py:491-497)
    cells_per = 0
    for i in range(tlen):
        beg = max(0, i - w)
        end = min(qlen, i + w + 1)
        cells_per += max(0, end - beg)
    assert bench.band_cells(qlen, tlen, w) == cells_per


class _Event:
    def __init__(self, key, us, count):
        self.key, self.self_device_time_total, self.count = key, us, count


class _Profile:
    """torch.profiler.profile's stand-in: its records are ``events``
    whatever the call launched."""
    events = []
    made = 0

    def __init__(self, **kw):
        type(self).made += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def step(self):
        pass

    def key_averages(self):
        return list(self.events)


def launching(s1, s3):
    def call():
        smem_pass_cuda.launches += s1
        pass3_cuda.launches += s3
    return call


def test_device_parts_ms_refuses_a_profile_missing_a_launch(monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(smem_pass_cuda, "launches", 0)
    monkeypatch.setattr(pass3_cuda, "launches", 0)
    lost = device.lost_profiles
    # two S1 launches and one S3, but the records hold one S1 launch
    monkeypatch.setattr(_Profile, "events", [
        _Event("smem_pass_kernel", 500.0, 1), _Event("pass3_kernel", 100.0, 1),
        _Event("Memcpy HtoD", 50.0, 3)])
    _Profile.made = 0
    assert seeding_bench.device_parts_ms(launching(2, 1)) is None
    assert _Profile.made == device.PROFILE_TRIES
    assert device.lost_profiles == lost + device.PROFILE_TRIES
    # whole records: the parts, in ms
    monkeypatch.setattr(_Profile, "events", [
        _Event("smem_pass_kernel", 500.0, 2), _Event("pass3_kernel", 100.0, 1),
        _Event("Memcpy HtoD", 50.0, 3), _Event("fill", 5.0, 1)])
    assert seeding_bench.device_parts_ms(launching(2, 1)) == {
        "s1": 0.5, "s3": 0.1, "copies": 0.05, "other": 0.005}
    # no launch at all reads none, not 0.0 for a kernel that ran
    monkeypatch.setattr(_Profile, "events", [_Event("Memcpy HtoD", 50.0, 3)])
    assert seeding_bench.device_parts_ms(launching(1, 1)) is None


def test_bench_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["--only", "headline", "--cache", str(tmp_path)])
