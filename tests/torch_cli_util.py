"""Shared by the port's CLI tests (tests/test_torch_cli.py,
test_torch_distributed.py, test_torch_devicepool.py): the fixture genome
and reads, and the port's and the reference's CLIs run in subprocesses,
each with its own timeout."""

import os
import re
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CLI = "arachne_tpu_torch.cli"
REF_CLI = "arachne_tpu.cli"
# seconds any collective may take in a run whose peers all live: the final
# stats merge waits for the slower peer to finish its share (six test
# workers on one host can slow one process far more than its peer), well
# inside each subprocess's timeout
COLLECTIVE_TIMEOUT = 120
# a test that wants a dead peer fails its collective in this many seconds
DEAD_PEER_TIMEOUT = 20
RUN_TIMEOUT = 240


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def cli_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["ARACHNE_COLLECTIVE_TIMEOUT"] = str(COLLECTIVE_TIMEOUT)
    for k in ("ARACHNE_CRASH_AFTER_SETS", "ARACHNE_CHECKPOINT_EVERY", "ARACHNE_DEVICE_SEEDING",
              "ARACHNE_COORDINATOR", "ARACHNE_NUM_PROCESSES", "ARACHNE_PROCESS_ID"):
        env.pop(k, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_cli(args, module=PORT_CLI, check=True, timeout=RUN_TIMEOUT, **extra_env):
    p = subprocess.run(
        [sys.executable, "-m", module] + args, env=cli_env(**extra_env), cwd=REPO,
        capture_output=True, text=True, timeout=timeout,
    )
    if check and p.returncode != 0:
        raise AssertionError(
            f"{module} failed rc={p.returncode}\nstdout:\n{p.stdout}\nstderr:\n{p.stderr}"
        )
    return p


def spawn_pair(args_for, extra_env_for=None, module=PORT_CLI, timeout=RUN_TIMEOUT):
    """Two CLI processes forming one process group; [(rc, output)] by id."""
    procs = []
    for pid in (0, 1):
        extra = dict(extra_env_for(pid)) if extra_env_for else {}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module] + args_for(pid), env=cli_env(**extra), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def sam_records(path):
    with open(path) as fh:
        return [line for line in fh if not line.startswith("@")]


def sam_header(path):
    with open(path) as fh:
        return [line for line in fh if line.startswith("@")]


def all_records(out_dir):
    got = []
    for fn in os.listdir(out_dir):
        if fn.startswith("bc_sorted_bam") and fn.endswith(".sam"):
            got += sam_records(os.path.join(out_dir, fn))
    return sorted(got)


def totals(log: str) -> str:
    m = re.search(r"completed successfully: (\d+ read pairs, \d+ barcodes)", log)
    return m.group(1) if m else ""


SIM_ARGS = ("--barcodes", "10", "--molecules", "2", "--pairs", "2", "--seed", "4")


def make_fixture(d, sim_args=SIM_ARGS):
    """A 120 kbp reference with its index and simulated linked reads, by
    default 10 barcodes x 2 molecules x 2 pairs (the fixture of
    tests/test_distributed.py with fewer pairs), made by the port's own
    CLI."""
    from arachne_tpu_torch.cli import main

    rng = np.random.default_rng(99)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 120_000))
    ref = str(d / "ref.fa")
    with open(ref, "w") as fh:
        fh.write(">chrD\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i : i + 70] + "\n")
    main(["index", ref])
    r1, r2 = str(d / "r1.fq.gz"), str(d / "r2.fq.gz")
    main(["simulate", ref, "--out-r1", r1, "--out-r2", r2, *sim_args])
    return {"dir": d, "ref": ref, "r1": r1, "r2": r2}
