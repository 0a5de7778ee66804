"""The port's multi-process runs (parallel/distributed.py on
torch.distributed with gloo) on the CPU: twins of tests/test_distributed.py
on the port's CLI.  Two processes on localhost partition the barcode sets;
the union of their shards must equal the reference's single-process oracle
run record for record, through hard kills, resumes with another process
count and a host that dies while its peer finishes.  Every subprocess has
its own timeout, and ARACHNE_COLLECTIVE_TIMEOUT bounds every collective."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from arachne_tpu.cli import main as reference_main
from arachne_tpu_torch.parallel import distributed
from arachne_tpu_torch.runtime.checkpoint import Checkpoint, CheckpointedStream, Claim
from torch_cli_util import (
    DEAD_PEER_TIMEOUT, all_records, free_port, make_fixture, run_cli, sam_header, sam_records,
    spawn_pair, totals,
)


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    f = make_fixture(tmp_path_factory.mktemp("torch_dist"))
    f["single"] = str(f["dir"] / "out_single")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        reference_main(["align", f["single"], f["ref"], f["r1"], f["r2"],
                        "--engine", "oracle", "--sam", "-t", "1"])
    f["totals"] = totals(log.getvalue())
    f["records"] = sorted(sam_records(os.path.join(f["single"], "bc_sorted_bam.sam")))
    assert f["totals"] and f["records"]
    return f


def align(f, out, engine="oracle", *extra):
    return ["align", out, f["ref"], f["r1"], f["r2"], "--engine", engine, "--sam", "-t", "1",
            *extra]


def fleet(f, out, port, engine="oracle", *extra):
    def args_for(pid):
        return align(f, out, engine, *extra, "--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", "2", "--process-id", str(pid))
    return args_for


def host_records(out):
    return sorted(sam_records(os.path.join(out, "bc_sorted_bam.host000.sam"))
                  + sam_records(os.path.join(out, "bc_sorted_bam.host001.sam")))


@pytest.mark.parametrize("engine,device_seeding", [("oracle", None), ("torch-cpu", "1")],
                         ids=["oracle", "torch-cpu-device-seeding"])
def test_union_of_host_shards_equals_single_process(fx, tmp_path, engine, device_seeding):
    """Two processes, each on its share of the barcode sets: the union of
    the host shards is the single-process output, each header is its
    header, and both logs print the merged totals.  The torch-cpu case
    (tests/test_distributed.py:268's) also seeds on the engine's device."""
    out = str(tmp_path / "out")
    env = {"ARACHNE_DEVICE_SEEDING": device_seeding} if device_seeding else {}
    outs = spawn_pair(fleet(fx, out, free_port(), engine), extra_env_for=lambda pid: env)
    for rc, log in outs:
        assert rc == 0, log
        assert fx["totals"] in log, log
    assert host_records(out) == fx["records"]
    header = sam_header(os.path.join(fx["single"], "bc_sorted_bam.sam"))
    for host in ("host000", "host001"):
        assert sam_header(os.path.join(out, f"bc_sorted_bam.{host}.sam")) == header


def test_kill_both_and_resume_is_exactly_once(fx, tmp_path):
    """Both processes die hard after 3 sets with a manifest every 2; the
    same topology resumes; merged output equals the single-process run."""
    out, ckpt = str(tmp_path / "out"), str(tmp_path / "fault.ckpt")
    outs = spawn_pair(
        fleet(fx, out, free_port(), "oracle", "--checkpoint", ckpt),
        extra_env_for=lambda pid: {"ARACHNE_CRASH_AFTER_SETS": 3, "ARACHNE_CHECKPOINT_EVERY": 2},
    )
    for rc, log in outs:
        assert rc != 0, log
    for rc, log in spawn_pair(fleet(fx, out, free_port(), "oracle", "--checkpoint", ckpt)):
        assert rc == 0, log
        assert "Resuming: skipping" in log
    run_cli(["merge", out])
    assert host_records(out) == fx["records"]


def test_unclaimed_records_are_not_duplicated(fx, tmp_path):
    """One process crashes with records on disk past its last manifest;
    the resume truncates them before re-running their sets."""
    out, ckpt = str(tmp_path / "out"), str(tmp_path / "crash1.ckpt")
    args = align(fx, out, "torch-cpu", "--checkpoint", ckpt)
    # three sets past the last manifest outgrow the writer's buffer
    p = run_cli(args, check=False, ARACHNE_CRASH_AFTER_SETS=7, ARACHNE_CHECKPOINT_EVERY=4)
    assert p.returncode == 17
    with open(ckpt) as fh:
        claimed = json.load(fh)["offsets"]["bc_sorted_bam.sam"]
    assert os.path.getsize(os.path.join(out, "bc_sorted_bam.sam")) > claimed
    run_cli(args)
    run_cli(["merge", out])
    assert sorted(sam_records(os.path.join(out, "bc_sorted_bam.sam"))) == fx["records"]


def test_crash_two_processes_resume_with_one(fx, tmp_path):
    """A two-process fleet dies hard; one process resumes, replays both
    hosts' claims and finishes the residue exactly once."""
    out, ckpt = str(tmp_path / "out"), str(tmp_path / "topo.ckpt")
    outs = spawn_pair(
        fleet(fx, out, free_port(), "oracle", "--checkpoint", ckpt),
        extra_env_for=lambda pid: {"ARACHNE_CRASH_AFTER_SETS": 2, "ARACHNE_CHECKPOINT_EVERY": 1},
    )
    for rc, log in outs:
        assert rc != 0, log
    run_cli(align(fx, out, "oracle", "--checkpoint", ckpt))
    run_cli(["merge", out])
    assert all_records(out) == fx["records"]


def test_one_host_dies_survivor_finishes_then_single_resume(fx, tmp_path):
    """Host 1 dies mid-run; host 0 must not wedge in the final stats
    collective: it finishes its share and exits 0 with a warning; a
    one-process re-run then completes host 1's residue exactly once."""
    out, ckpt = str(tmp_path / "out"), str(tmp_path / "survivor.ckpt")

    def env_for(pid):
        return {"ARACHNE_CHECKPOINT_EVERY": 1, "ARACHNE_COLLECTIVE_TIMEOUT": DEAD_PEER_TIMEOUT,
                **({"ARACHNE_CRASH_AFTER_SETS": 2} if pid else {})}

    (rc0, log0), (rc1, log1) = spawn_pair(
        fleet(fx, out, free_port(), "oracle", "--checkpoint", ckpt), extra_env_for=env_for)
    assert rc1 == 17, log1
    assert rc0 == 0 and "completed successfully" in log0, log0
    assert "WARNING: final stats allreduce did not complete" in log0
    run_cli(align(fx, out, "oracle", "--checkpoint", ckpt))
    run_cli(["merge", out])
    assert all_records(out) == fx["records"]


def test_missing_peer_fails_start_up(fx, tmp_path):
    """A coordinator whose peer never starts: the process raises within
    the collective timeout, never runs as a single process."""
    p = run_cli(align(fx, str(tmp_path / "out"), "oracle", "--coordinator",
                      f"127.0.0.1:{free_port()}", "--num-processes", "2", "--process-id", "0"),
                check=False, ARACHNE_COLLECTIVE_TIMEOUT=3, timeout=120)
    assert p.returncode != 0
    assert "completed successfully" not in p.stdout and not os.path.exists(tmp_path / "out")


def test_init_without_coordinator_is_single_process(monkeypatch):
    monkeypatch.delenv("ARACHNE_COORDINATOR", raising=False)
    ctx = distributed.init_distributed(None, None, None)
    assert (ctx.process_index, ctx.process_count, ctx.initialized) == (0, 1, False)
    assert distributed.shard_suffix(ctx) == ""
    v = np.arange(4, dtype=np.int64)
    assert distributed.allreduce_stats(v, ctx) is v
    assert distributed.allreduce_max_int(7, ctx) == 7
    distributed.assert_uniform_int(3, ctx, "x")
    assert list(distributed.partition_work(range(5), ctx)) == [0, 1, 2, 3, 4]
    two = distributed.DistContext(process_index=1, process_count=2, initialized=True)
    assert list(distributed.partition_work(range(5), two)) == [1, 3]
    assert distributed.shard_suffix(two) == ".host001"
    for n, i in ((None, 0), (2, None), (2, 2), (0, 0)):
        with pytest.raises(ValueError):
            distributed.init_distributed("127.0.0.1:1", n, i)


def test_digest_reflects_visible_claims(tmp_path):
    """Digest agreement guards resuming fleets against divergent manifest
    visibility (the assert_uniform_int call in cli.py)."""
    r1, r2 = "a.fq", "b.fq"
    Checkpoint(r1=r1, r2=r2, claims=[Claim(0, 0, 2, 7), Claim(0, 1, 2, 5)]).save(
        str(tmp_path / "m.json.host000"))
    Checkpoint(r1=r1, r2=r2, claims=[Claim(0, 0, 2, 7)]).save(str(tmp_path / "m2.json.host000"))
    # host A sees both manifests; host B's glob (another base) sees one
    a = CheckpointedStream(r1, r2, str(tmp_path / "m.json.host001"))
    b = CheckpointedStream(r1, r2, str(tmp_path / "m2.json.host001"))
    assert a.claims_digest() != b.claims_digest()
    a2 = CheckpointedStream(r1, r2, str(tmp_path / "m.json.host002"))
    assert a.claims_digest() == a2.claims_digest()


def test_with_timeout_bounds_and_surfaces_failures(capsys):
    import threading

    from arachne_tpu.parallel.distributed import _with_timeout as ref_with_timeout

    assert distributed._with_timeout(lambda: 42, 5.0, "t") == 42
    gate = threading.Event()
    assert distributed._with_timeout(gate.wait, 0.2, "slow") is None
    gate.set()
    assert distributed._with_timeout(lambda: 1 // 0, 5.0, "div") is None
    out = capsys.readouterr().out
    assert "slow did not complete (timeout)" in out and "div did not complete: " in out
    # the reference's helper says the same
    assert ref_with_timeout(lambda: 1 // 0, 5.0, "div") is None
    assert capsys.readouterr().out == out.split("\n", 1)[1]
