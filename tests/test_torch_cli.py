"""The port's CLI beyond a plain align, held to the reference's CLI on the
CPU: checkpoint, crash (ARACHNE_CRASH_AFTER_SETS) and exactly-once resume,
then ``merge``; ``status``; ``--stats-json``, ``--profile-dir`` and
``--index-mode``; ``standardize`` -> ``sort`` -> ``align``; ``index
--bwa-format --sampled-sa``.  Every comparison is exact: SAM bytes,
decompressed FASTQ bytes, index files byte for byte."""

import filecmp
import gzip
import json
import os
import re

import numpy as np
import pytest
import torch

from arachne_tpu.cli import main as reference_main
from arachne_tpu_torch.cli import main as port_main
from torch_cli_util import PORT_CLI, REF_CLI, make_fixture, run_cli

torch.set_num_threads(1)

# several superbatches on the torch-cpu path: about three barcode sets each
READS_PER_BATCH = 20


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    f = make_fixture(tmp_path_factory.mktemp("torch_cli"))
    f["single"] = str(f["dir"] / "ref_single")
    reference_main(["align", f["single"], f["ref"], f["r1"], f["r2"],
                    "--engine", "oracle", "--sam", "-t", "1"])
    return f


def align_args(f, out, engine, *extra):
    return ["align", out, f["ref"], f["r1"], f["r2"], "--engine", engine, "--sam", "-t", "1",
            *extra]


def crash_resume_merge(f, out, ckpt, engine, module, main, resume_extra=()):
    """Crash a subprocess of ``module``'s CLI after 7 barcode sets with a
    manifest every 4, so the shard holds records of sets the manifest does
    not claim (three sets outgrow the writer's buffer); then resume and
    merge in this process through ``main``."""
    args = align_args(f, out, engine, "--checkpoint", ckpt)
    p = run_cli(args, module=module, check=False, ARACHNE_CRASH_AFTER_SETS=7,
                ARACHNE_CHECKPOINT_EVERY=4, ARACHNE_TEST_READS_PER_BATCH=READS_PER_BATCH)
    assert p.returncode == 17, p.stdout + p.stderr
    with open(ckpt) as fh:
        offsets = json.load(fh)["offsets"]
    shard = "bc_sorted_bam.sam"
    assert os.path.getsize(os.path.join(out, shard)) > offsets[shard], "nothing to truncate"
    os.environ["ARACHNE_TEST_READS_PER_BATCH"] = str(READS_PER_BATCH)
    try:
        main(args + list(resume_extra))
    finally:
        del os.environ["ARACHNE_TEST_READS_PER_BATCH"]
    main(["merge", out])


def assert_same_shards(a, b):
    names = sorted(os.listdir(a))
    assert sorted(os.listdir(b)) == names and "bc_sorted_bam.sam" in names
    for fn in names:
        assert filecmp.cmp(os.path.join(a, fn), os.path.join(b, fn), shallow=False), fn


@pytest.fixture(scope="module")
def reference_resumed(fx):
    out = str(fx["dir"] / "ref_resumed")
    crash_resume_merge(fx, out, str(fx["dir"] / "ref.ckpt"), "oracle", REF_CLI, reference_main)
    return out


@pytest.mark.parametrize("engine", ["torch-cpu", "oracle"])
def test_crash_resume_merge_equals_uninterrupted_and_reference(fx, reference_resumed, engine,
                                                              tmp_path):
    uninterrupted = str(tmp_path / "single")
    port_main(align_args(fx, uninterrupted, engine))
    assert_same_shards(fx["single"], uninterrupted)

    out, ckpt = str(tmp_path / "resumed"), str(tmp_path / "run.ckpt")
    stats_json, prof = str(tmp_path / "stats.json"), str(tmp_path / "prof")
    crash_resume_merge(fx, out, ckpt, engine, PORT_CLI, port_main,
                       ["--stats-json", stats_json, "--profile-dir", prof])
    assert_same_shards(uninterrupted, out)
    assert_same_shards(reference_resumed, out)
    # the resumed run ran the 6 sets past the manifest's 4
    with open(stats_json) as fh:
        assert json.load(fh)["barcodes"] == 6
    with open(os.path.join(prof, "arachne.trace.json")) as fh:
        assert "traceEvents" in json.load(fh)


def _status(main, args, capsys):
    with pytest.raises(SystemExit) as e:
        main(["status", *args])
    text = re.sub(r"\d+s", "Ns", capsys.readouterr().out)
    return e.value.code, text


def test_status_matches_reference(fx, tmp_path, capsys):
    out, ckpt = str(tmp_path / "out"), str(tmp_path / "s.ckpt")
    p = run_cli(align_args(fx, out, "oracle", "--checkpoint", ckpt), check=False,
                ARACHNE_CRASH_AFTER_SETS=3, ARACHNE_CHECKPOINT_EVERY=1)
    assert p.returncode == 17
    cases = [[ckpt], [ckpt, "--stale-after", "0"], [str(tmp_path / "absent.ckpt")]]
    got = [_status(port_main, c, capsys) for c in cases]
    assert got == [_status(reference_main, c, capsys) for c in cases]
    assert [rc for rc, _ in got] == [0, 1, 1]
    assert "g0 h0/1: 3 sets" in got[0][1] and "STALE" in got[1][1]


def test_stats_json_keys_and_values_match_reference(fx, tmp_path):
    from arachne_tpu.runtime.timers import TIMERS as REF_TIMERS
    from arachne_tpu_torch.runtime.timers import TIMERS

    # both CLIs add to their process's stage timers run after run
    REF_TIMERS.reset()
    TIMERS.reset()
    want, got = str(tmp_path / "ref.json"), str(tmp_path / "port.json")
    reference_main(align_args(fx, str(tmp_path / "r"), "oracle", "--stats-json", want))
    port_main(align_args(fx, str(tmp_path / "p"), "oracle", "--stats-json", got,
                         "--index-mode", "replicated"))
    with open(want) as fh:
        want = json.load(fh)
    with open(got) as fh:
        got = json.load(fh)
    assert sorted(got) == sorted(want)
    assert sorted(got["stage_times"]) == sorted(want["stage_times"])
    timed = ("elapsed_s", "pairs_per_s", "stage_times")
    assert {k: v for k, v in got.items() if k not in timed} == {
        k: v for k, v in want.items() if k not in timed}


def test_index_mode_sharded_refused(fx, tmp_path, monkeypatch):
    """``--index-mode sharded`` is refused only where its tables fit
    nowhere.  Seeding on the device with one device, the mode falls back
    to replicated (the reference's rule): over ARACHNE_HBM_BUDGET that is
    refused (the reference would seed on the host); within it, the run is
    accepted and its shards are the reference's single-process oracle
    run's (tests/test_torch_mesh.py shards across two devices)."""
    from arachne_tpu_torch.ops import engine as engine_mod

    monkeypatch.setenv("ARACHNE_DEVICE_SEEDING", "1")
    monkeypatch.setenv("ARACHNE_HBM_BUDGET", "1")
    with pytest.raises(RuntimeError, match="over the budget"):
        port_main(align_args(fx, str(tmp_path / "refused"), "torch-cpu", "--index-mode",
                             "sharded"))
    monkeypatch.delenv("ARACHNE_HBM_BUDGET")
    placed = []
    real = engine_mod.rank_tables
    monkeypatch.setattr(engine_mod, "rank_tables",
                        lambda *a, **k: placed.append(a[2:]) or real(*a, **k))
    out = str(tmp_path / "o")
    port_main(align_args(fx, out, "torch-cpu", "--index-mode", "sharded"))
    assert placed and set(placed) == {("sharded",)}
    names = sorted(os.listdir(fx["single"]))
    assert sorted(os.listdir(out)) == names
    for fn in names:
        assert filecmp.cmp(os.path.join(fx["single"], fn), os.path.join(out, fn),
                           shallow=False), fn


def _fastq_text(path):
    with gzip.open(path, "rt") as fh:
        return fh.read()


def _native_fastq(std1, std2, raw1, raw2, fmt):
    """Rewrite BX:Z headers in the stLFR (#x_y_z) or TELLseq (:ACGT) form
    (tests/test_e2e.py::TestStandardizeThenAlign)."""
    bases = ["AACCGGTT", "ACGTACGT", "TTGGCCAA", "TGCATGCA"]
    for src, dst in ((std1, raw1), (std2, raw2)):
        with gzip.open(src, "rt") as fi, gzip.open(dst, "wt") as fo:
            bcmap = {}
            while True:
                h = fi.readline()
                if not h:
                    break
                body = [fi.readline() for _ in range(3)]
                name, rest = h.rstrip("\n").split("\t", 1)
                bc = rest.split("BX:Z:")[1].split("\t")[0]
                if fmt == "stlfr":
                    code = "#" + bcmap.setdefault(
                        bc, f"{len(bcmap) + 1}_{len(bcmap) + 2}_{len(bcmap) + 3}")
                else:
                    code = ":" + bcmap.setdefault(bc, bases[len(bcmap) % 4])
                base = name.split("/")[0]
                suff = "/" + name.split("/")[1] if "/" in name else ""
                fo.write(f"{base}{code}{suff}\n" + "".join(body))


@pytest.mark.parametrize("fmt", ["stlfr", "tellseq"])
def test_standardize_sort_align_matches_reference(tmp_path, fmt):
    rng = np.random.default_rng(77)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 60_000)])
    ref = str(tmp_path / "ref.fa")
    with open(ref, "w") as fh:
        fh.write(">chrS\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i : i + 70] + "\n")
    std1, std2 = str(tmp_path / "std.R1.fq.gz"), str(tmp_path / "std.R2.fq.gz")
    port_main(["simulate", ref, "--out-r1", std1, "--out-r2", std2, "--barcodes", "4",
               "--molecules", "2", "--pairs", "8", "--seed", "5"])
    raw1, raw2 = str(tmp_path / "native.R1.fq.gz"), str(tmp_path / "native.R2.fq.gz")
    _native_fastq(std1, std2, raw1, raw2, fmt)
    port_main(["index", ref])
    outs = {}
    for side, main, engine in (("ref", reference_main, "oracle"),
                               ("port", port_main, "torch-cpu")):
        d = tmp_path / side
        d.mkdir()
        conv = [str(d / "conv.R1.fq.gz"), str(d / "conv.R2.fq.gz")]
        srt = [str(d / "sorted.R1.fq.gz"), str(d / "sorted.R2.fq.gz")]
        main(["standardize", raw1, raw2, "--out-r1", conv[0], "--out-r2", conv[1]])
        main(["sort", *conv, "--out-r1", srt[0], "--out-r2", srt[1]])
        main(["align", str(d / "out"), ref, *srt, "--engine", engine, "--sam", "-t", "1"])
        outs[side] = [_fastq_text(p) for p in conv + srt], str(d / "out")
    assert outs["port"][0] == outs["ref"][0]
    assert outs["port"][0][2].count("BX:Z:") > 0
    assert_same_shards(outs["ref"][1], outs["port"][1])


def test_index_bwa_format_and_sampled_sa_match_reference(tmp_path):
    rng = np.random.default_rng(12)
    text = ">chrA\n" + "".join("ACGT"[i] for i in rng.integers(0, 4, 30_000)) + "\n"
    paths = {}
    for side, main in (("ref", reference_main), ("port", port_main)):
        (tmp_path / side).mkdir()
        fa = str(tmp_path / side / "g.fa")
        with open(fa, "w") as fh:
            fh.write(text)
        main(["index", fa, "--bwa-format", "--sampled-sa"])
        paths[side] = fa
    for ext in (".bwt", ".sa", ".pac", ".ann", ".amb"):
        assert filecmp.cmp(paths["ref"] + ext, paths["port"] + ext, shallow=False), ext
    want, got = np.load(paths["ref"] + ".arx.npz"), np.load(paths["port"] + ".arx.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert np.array_equal(got[k], want[k]), k
    assert got["sa"].size == 0 and got["sa_sampled"].size > 0   # --sampled-sa kept no full SA
