"""The port's native C++ library under ASan and UBSan, and its threaded
align pipeline at two worker counts: the twin of
tests/test_native_sanitizers.py for arachne_tpu_torch.  It imports no
JAX.

The sanitized library is built from arachne_tpu_torch/native/*.cpp (which
differ from the reference's since the port's smem.cpp refuses an
interval that is not a power of two and keeps the parallel SA walk's flag
and counters in std::atomic) and driven in a subprocess: SA-IS, the
three-pass seed collector on four threads, the incremental build with
its progress reporter, and the refused interval.  Any heap overflow or
undefined behaviour aborts the subprocess.  The align runs compare
``-t 1`` with ``-t 4`` on ``--engine torch-cpu``, seeded on the host and
on the device (the kernels' plain versions), byte for byte.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "arachne_tpu_torch", "native")
SOURCES = ("sais.cpp", "smem.cpp", "chain.cpp", "ropebwt.cpp", "rfa_tail.cpp")


def _asan_lib():
    p = subprocess.run(["gcc", "-print-file-name=libasan.so"], capture_output=True, text=True)
    path = p.stdout.strip()
    return path if os.path.isabs(path) and os.path.exists(path) else None


PROGRAM = """
import ctypes, io, contextlib, sys
import numpy as np
sys.path.insert(0, {repo!r})
from arachne_tpu_torch import native
# point the loader at the sanitized build
native.lib_path = lambda: {so!r}
native._lib = None
native._tried = False
from arachne_tpu_torch.align.smem import collect_seeds
from arachne_tpu_torch.align.smem_native import collect_seeds_native
from arachne_tpu_torch.config import MemOptions
from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
from arachne_tpu_torch.index.build import build_fmindex_incremental, codes2_packed

assert native.get_lib() is not None, "the sanitized library did not load"
rng = np.random.default_rng(3)
seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 80_000))
packed = pack_reference([("c", "", seq)])
fm = build_fmindex(packed)   # SA-IS through the sanitized library
idx = FMIndex(packed, fm)
fwd = unpack_2bit(packed.pac, 0, packed.l_pac)
opt = MemOptions()
reads = []
for _ in range(300):
    p = int(rng.integers(0, len(fwd) - 160))
    r = fwd[p : p + 150].copy()
    for _ in range(int(rng.integers(0, 8))):
        j = int(rng.integers(0, 150))
        r[j] = (r[j] + 1) % 4
    if rng.integers(0, 4) == 0:
        r[int(rng.integers(0, 150))] = 4
    reads.append(r)
got = collect_seeds_native(idx, reads, opt, n_threads=4)
key = lambda lst: [(m.k, m.l, m.s, m.qb, m.qe) for m in lst]
for i in (0, 57, 123, 299):
    assert key(got[i]) == key(collect_seeds(idx, reads[i], opt)), i
# the incremental build: B+-tree inserts, splits, emission, then the
# parallel SA walk with its progress reporter thread
with contextlib.redirect_stdout(io.StringIO()):
    fm_inc = build_fmindex_incremental(packed, progress=True)
assert np.array_equal(fm_inc.bwt_words, fm.bwt_words)
assert fm_inc.primary == fm.primary
assert np.array_equal(fm_inc.sa_sampled, fm.sa_sampled)
args = (np.ascontiguousarray(fm.bwt_words, np.uint32), np.ascontiguousarray(fm.occ, np.int64),
        np.ascontiguousarray(fm.L2, np.int64), int(fm.primary), int(fm.seq_len))
pac2, _ = codes2_packed(packed)
prog = np.zeros(1, np.int64)
par = native.sa_sample_walk_native(*args, 32, pac2=pac2, progress=prog, n_chunks=8)
assert prog[0] == fm.seq_len
assert np.array_equal(par, native.sa_sample_walk_native(*args, 32))
# an interval that is not a power of two is refused (-1), not walked
lib = native.get_lib()
words, occ, L2, primary, n = args
u32p, i64p = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int64)
ptrs = (words.ctypes.data_as(u32p), len(words), occ.ctypes.data_as(i64p),
        L2.ctypes.data_as(i64p), primary, n)
out = np.zeros(n + 1, np.int64)
assert lib.sa_sample_walk(*ptrs, 24, out.ctypes.data_as(i64p)) == -1
assert lib.sa_sample_walk_par(*ptrs, 24, out.ctypes.data_as(i64p),
                              pac2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 4, 2,
                              None) == -1
assert not out.any()
print("SANITIZED_OK")
"""


class TestNativeSanitized:
    def test_smem_and_sais_under_asan_ubsan(self, tmp_path):
        """Build the port's native library with -fsanitize=address,undefined
        and drive SA-IS, the three-pass collector on four threads, the
        incremental build and the refused interval through it in a
        subprocess (ASan preloaded)."""
        asan = _asan_lib()
        if asan is None:
            pytest.skip("libasan unavailable")
        so = str(tmp_path / "_arachne_native_asan.so")
        subprocess.run(
            ["g++", "-O1", "-g", "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
             "-shared", "-fPIC", "-pthread", "-o", so] + [os.path.join(NATIVE, s) for s in SOURCES],
            check=True, capture_output=True, timeout=600,
        )
        program = tmp_path / "sanitized_run.py"
        program.write_text(PROGRAM.format(repo=REPO, so=so))
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["LD_PRELOAD"] = asan
        # python itself leaks by ASan's standards; UB/overflow still aborts
        env["ASAN_OPTIONS"] = "detect_leaks=0:abort_on_error=1"
        p = subprocess.run([sys.executable, str(program)], env=env, capture_output=True, text=True,
                           timeout=600)
        assert p.returncode == 0, p.stdout + p.stderr
        assert "SANITIZED_OK" in p.stdout


@pytest.fixture(scope="module")
def threaded_fixture(tmp_path_factory):
    """The reference test's library: a 100 kb genome and 12 barcodes x 2
    molecules x 12 pairs, indexed and simulated by the port's CLI."""
    from torch_cli_util import run_cli

    d = tmp_path_factory.mktemp("threads")
    rng = np.random.default_rng(21)
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, 100_000))
    ref = str(d / "ref.fa")
    with open(ref, "w") as fh:
        fh.write(">chrT\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i : i + 70] + "\n")
    run_cli(["index", ref])
    r1, r2 = str(d / "r1.fq.gz"), str(d / "r2.fq.gz")
    run_cli(["simulate", ref, "--out-r1", r1, "--out-r2", r2, "--barcodes", "12",
             "--molecules", "2", "--pairs", "12", "--seed", "2"])
    return d, ref, r1, r2


@pytest.mark.parametrize("seeding", ["0", "1"], ids=["host-seeded", "device-seeded"])
def test_worker_count_does_not_change_output(threaded_fixture, seeding):
    """The superbatch thread pool (a TorchEngine per worker over shared
    device tables, in-order result consumption, backpressure) writes the
    same SAM bytes at -t 1 and -t 4; small superbatches keep several in
    flight."""
    from torch_cli_util import run_cli

    d, ref, r1, r2 = threaded_fixture
    outs = {}
    for t in ("1", "4"):
        out = str(d / f"out_s{seeding}_t{t}")
        run_cli(["align", out, ref, r1, r2, "--engine", "torch-cpu", "--sam", "-t", t],
                timeout=900, ARACHNE_TEST_READS_PER_BATCH=48, ARACHNE_DEVICE_SEEDING=seeding)
        with open(os.path.join(out, "bc_sorted_bam.sam"), "rb") as fh:
            outs[t] = fh.read()
    assert outs["1"] == outs["4"] and outs["1"].count(b"\n") > 2 * 12 * 2 * 12


def test_compute_sanitizer_program_on_the_cpu(capsys):
    """The program tests/test_torch_cuda.py runs under compute-sanitizer on
    the card, here with the kernels' plain versions on both sides: every
    launch it names is built with the shapes and arguments its wrapper
    takes."""
    import torch
    import torch_sanitize_util as su

    torch.set_num_threads(1)
    su.main(["--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert printed == [f"launched {name}" for name in su.KERNELS]
    assert set(su.SHARED_MEMORY) < set(su.KERNELS)
