#!/usr/bin/env python3
"""Smoke test of the arachne_tpu_torch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

  1. probe the card, build the CUDA kernels from ops/csrc with nvcc, log
     the L2's fetch granularity and measure the L2 and HBM copy rates;
  2. kernel parity at the main path's shapes: K1 extension (4096 x 192 x
     512), and K1 with int16 DP state on the same problems (the
     reference's wide_state=False; also held to the int32 kernel, its
     launch counted here, since the main path keeps int32 state), K2 local
     SW + score2 (1024 x 192 x 768), K3 global score (1024 x
     192 x 320), K3 direction bytes + K4 traceback (128 x 192 x 320, gapped).
     Each kernel must equal its plain PyTorch version on the card exactly
     (integer outputs: tolerance 0) and the scalar ksw oracle
     (arachne_tpu_torch/align/ksw.py) on 256 problems (all 128 for the z
     batches); both are timed with CUDA events (``ms``: the wrapper's
     calls in a row, host work between launches included) and the kernel
     also by torch.profiler (``device_ms``: the card's own time per call,
     the zeroing of an output included; null where no profiler run kept
     every call's records), and each gets its bound,
     the least time the card could take for the work these inputs need
     (the problems: arachne_tpu_torch/ops/problems.py).  K3 and K4 are
     also held to their plain versions, untimed, on the edge problems
     (w = 0, 1 and wider than the query, tlen = 0, one-base queries, the
     corner cell on the band's edge, long indel runs) at 64 x 96 and 1024
     x 1100, where a lane's strip is 2 and 32 columns wide instead of 6;
  then the library: a 2 Mbp genome, its index and 19,200 simulated
  linked-read pairs of 150 bp (indel rate 0.1); the native C++ host
  library must load;
  2b. seeding kernels: K5 rank queries on the library's index and on a
     synthetic GRCh38-sized wide table (2048 rows each, edge rows
     included; one thread a query on the index, which fits the L2, a group
     of four lanes on the wide table, which does not); S1 (pass 1, and pass 2: every job of pass 1's SMEMs in one
     launch, as collect_seeds_device runs it) and S3 on one superbatch of
     the library (4096 pairs, 8192 reads of 150 bp), with the main path's
     buffers (seed_buffers of the padded width: no read may overflow) and
     with MAXC=2, MAXS=4, which overflow.  Each must equal its plain version
     on the card exactly (out, out_n and the overflow flags); both are
     timed with CUDA events, and the kernels also by torch.profiler
     (``device_ms``, the zeroing of out included; S1 on its pass-1 and on
     its pass-2 launch; K5 on 2^20 uniform rows of the wide table, and also
     by CUDA events around a CUDA graph of 20 launches, ``graph_ms``: the
     two readings are flagged in the log when they differ by over 10%).
     Then K5's own path, ``python -m arachne_tpu_torch.seeding_bench`` on
     the library's index: rank queries/s at three batch sizes on both
     tables, and device against host seeding on 4096 reads;
  3. the host-seeded path, pinned: ``arachne_tpu_torch.cli align --engine
     cuda`` on the library with ARACHNE_DEVICE_SEEDING=0; every kernel
     K1-K4 must have launched in that run, S1 and S3 never, and accuracy
     must reach 0.99; its shards are what phases 5-6 are held to;
  4. byte identity of the SAM shards of the default run (device seeding)
     with the scalar oracle engine on a 300-pair fixture;
  5. the main path as a user runs it, with no ARACHNE_DEVICE_SEEDING: it
     seeds on the card, so S1, S3 and K1-K4 must have launched, no read may
     have been redone after an overflow, accuracy must reach 0.99, and
     every SAM shard must be byte-identical to phase 3's.  The kernel
     table's launches of K1-K4, S1 and S3 are this run's;
     5b. three trials in turns of phase 3's host-seeded run and phase 5's
         default run on the library (host, default, host, ...): each
         one's pairs/s and its seed.* and chain.host stage seconds are
         logged, and its shards must equal phase 3's;
  6. the main path's other routes, each on phase 3's library and command
     line, each shard set held to phase 3's:
     6a. ``python -m arachne_tpu_torch.cli align --checkpoint`` killed by
         ARACHNE_CRASH_AFTER_SETS=160 (manifests every 50 sets) must exit
         17; ``status`` must exit 0 and name the claim; the same command
         resumes with --stats-json and --profile-dir; after ``merge`` every
         shard must be byte-identical to phase 3's, the stats JSON must
         parse, the profiler trace must name extend_kernel and the
         program's spans beside it (arachne.spans.json) must hold K1
         launches with their DP cells;
     6b. two processes on the card (--coordinator 127.0.0.1:<free port>
         --num-processes 2): the sorted union of their records must equal
         phase 3's, each header phase 3's header, and both logs must print
         the merged totals; nvidia-smi's memory in use is sampled through
         the run;
     6c. the align command in this process with the device pool pinned to
         [card, card] (ops/devicepool.py): K1-K4 must launch and every
         shard must be byte-identical to phase 3's.
     Every subprocess has a timeout and is killed if it outlives it, and
     each seeds on the card (the default), so in 6b each process uploads
     its own rank tables;
  7. genome scale, at config 3's size:
     7a. a 4 x 16 Mbp genome of ``python -m
         arachne_tpu_torch.scripts.make_scale_genome`` (seed 7: planted
         repeat families, N runs), indexed by ``python -m
         arachne_tpu_torch.cli index`` in a subprocess as ``measure
         --reference`` indexes (measure.reference_library): the build's
         seconds, peak RSS, bytes and build-mode line are logged; its
         1.28e8 rows must give a sampled suffix array and a record table
         larger than the L2;
     7b. phase 3's library shape on it, host-seeded and then device-seeded
         (phase 3's and phase 5's checks: launches counted from zero,
         accuracy, no read redone, identical shards), each logged beside
         the same seeding's pairs/s on the 2 Mbp genome (phases 3 and 5);
     7c. S1 (passes 1 and 2) and S3 on one superbatch of it against their
         plain versions on the card, on its int32 tables (in HBM) and on
         the same tables forced wide (equal to the int32 results, cast); K5
         against the host index's occ4 on 4096 rows; their device times
         beside phase 2b's, with bounds at phase 1's HBM copy rate; then
         ``seeding_bench`` on this index;
     7d. S1 and S3 against their plain versions on random reads over the
         synthetic GRCh38-sized table, whose rows pass 2^31;
  8. the port's bench: ``python -m arachne_tpu_torch.bench --trials 1`` in
     a subprocess (fixtures cached under build/bench_cache; every line but
     the device-seeded one pins host seeding), which must
     exit 0 with its six lines in the reference's order, each correct (the
     end-to-end lines' output shards at the SHA-256 that
     arachne_tpu_torch/bench_reference.json records from the JAX
     package's run on the same fixture); each line is logged.  Then the
     repeat-genome and MAPQ-calibration fixtures through the main path with
     ARACHNE_DEVICE_SEEDING=1, counted from zero: K1-K4, S1 and S3 must
     launch, no read may be redone, and the shards must have the recorded
     digests;
  9. the block-sharded index (arachne_tpu_torch/parallel/mesh.py), its
     shards all on the one card (shards on other cards are read over
     NVLink; one card cannot show that):
     9a. the synthetic GRCh38-sized table (6.2e9 rows, int64, 3.1 GB) split
         into 2 and then 4 shards: K5's sharded entry point on 2^20 rows
         (edge rows included), S1 (pass 1, and a sweep from random pivots:
         pass 1 leaves random reads no pass-2 job; 9b runs real ones) and
         S3 on 1,024 random reads, each equal to the flat kernel on
         the whole table and to its plain version on the shards (tolerance
         0), and timed beside the flat kernel;
     9b. phase 7b's library and 64 Mbp index through ``align --index-mode
         sharded`` with no ARACHNE_DEVICE_SEEDING (seeding on the card, its
         default) and the pool pinned to [card, card] (two shards),
         counted from zero: K1-K4 and the sharded S1 and S3 must
         launch and the flat S1 and S3 must not, no read may be redone, and
         every shard must be byte-identical to 7b's device-seeded run's;
         its pairs/s beside 7b's.  Then the sharded tables' host occ4
         (``ShardedFMTables.occ4``, K5's sharded entry point, counted from
         zero) against the host index on 4096 rows, and S1 and S3 on one
         superbatch of the library against their plain versions, their
         device times beside phase 7c's flat ones.

The log also gives ``seeding_bench``'s reads/s of device seeding as the
main path runs it (flat seed arrays), as per-read lists, and of the
native host collector.

The last three lines of standard output are the kernel table (one JSON
object, with each kernel's bound and, where one PyTorch call computes the
same function, that call's time: none does; launches of K1-K4, S1 and S3
from phase 5's run, K1 int16's from phase 2, K5's from phase 2b's
seeding_bench, the sharded kernels' from phase 9), the card's name and power
limit as nvidia-smi gives them, and ``{"ok": true, "device": {...}}``.
Without a card, or outside a checkout, it exits non-zero.  It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import filecmp
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SAMPLE = 256        # problems per kernel checked against the scalar oracle
PHASES = []         # (name, seconds)

# A kernel's bound is the least time the card could take for the work
# these inputs need: the larger of the bytes it must move over the rate of
# the memory that holds them and its integer instructions over the card's
# peak int32 rate (132 SMs x 64 lanes per clock at nvidia-smi's maximum SM
# clock).  Bytes in HBM move at 3.35 TB/s (NVIDIA's H100 SXM data sheet);
# bytes of a table that sits in the 50 MB L2 at the L2 rate this run
# measures (``l2_rate``).  No PyTorch call computes any of these kernels'
# functions, so none has a library time.
HBM_BYTES_PER_S = 3.35e12
INT32_LANES = 132 * 64
# The fewest instructions a DP cell takes on sm_90: M = H(i-1, j-1) + s
# (IADD); H = max(M, E, F), for local SW also with 0 (one DPX VIMNMX3);
# t = H - o - e (IADD); E = max(E - e, t) and F = max(F - e, t) (one DPX
# VIADDMNMX each).  The score lookup is a load, not an integer
# instruction.  NVIDIA publishes no issue rate for the DPX instructions:
# they are taken at the int32 rate (were they faster, the bound would be
# lower still).
DP_INSTR_PER_CELL = 5
# a traceback step: the z address, the byte's shift and mask, the op, the
# two coordinate updates
TRACEBACK_OPS_PER_STEP = 6
# an occ4 row of S1/S3 reads its block's 64-byte record (checkpoint counts
# and BWT words, rank.cuh); K5's bound also counts its query's read and its
# result's write (seeding_bench.rank_bytes)
RANK_ROW_BYTES = 64
# graph-timed and profiled device times of K5 that differ by more than this
# share are flagged in the log
K5_READINGS_APART = 0.10
CLOCKS = {}         # nvidia-smi's SM clocks in MHz, read in phase 1
RATES = {}          # bytes/s: "l2" and "hbm", measured in phase 1


def bound(ops=0, nbytes=0, bytes_per_s=HBM_BYTES_PER_S):
    t_ops = ops / (INT32_LANES * CLOCKS["max_sm"] * 1e6) * 1e3
    t_bytes = nbytes / bytes_per_s * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


def band_cells(qlens, tlens, ws):
    """Cells of the banded global DP (K3): every row of the target, the
    columns within w of the diagonal inside the query."""
    total = 0
    for ql, tl, w in zip(qlens.tolist(), tlens.tolist(), ws.tolist()):
        i = np.arange(tl)
        total += int(np.clip(np.minimum(ql, i + w + 1) - np.maximum(0, i - w), 0, None).sum())
    return total


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name):
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            log(f"== {name}")
            out = fn(*a, **k)
            dt = time.perf_counter() - t0
            PHASES.append((name, dt))
            log(f"== {name}: ok in {dt:.1f} s")
            return out
        return run
    return wrap


# ----------------------------------------------------------------------
# comparison
# ----------------------------------------------------------------------

def max_abs_err(pairs):
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        err = max(err, int((a.long() - b.long()).abs().max().item()) if a.numel() else 0)
    return err


def require_equal(name, pairs):
    err = max_abs_err(pairs)
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from its plain version (max abs err {err})")
    return err


def copy_ms(dev, nbytes, copies):
    """Best of five replays of a CUDA graph holding ``copies``
    device-to-device copies of ``nbytes``, in milliseconds."""
    import torch

    src = torch.ones(nbytes // 4, dtype=torch.int32, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            dst.copy_(src)
    return min(timed(graph.replay)[1] for _ in range(5))


def l2_rate(dev, copies=20):
    """Bytes per second the L2 moves for device-to-device copies: the
    slope of the time of ``copies`` copies of 8 MiB and of 16 MiB (source
    and destination fit in the 50 MB L2 together), each copy reading and
    writing its bytes; the slope drops what a copy costs whatever its
    size.  A copy does not reach the L2's peak, so this is a lower
    estimate of it, and a bound taken at it an upper estimate."""
    small, large = 8 << 20, 16 << 20
    dt = copy_ms(dev, large, copies) - copy_ms(dev, small, copies)
    return 2 * (large - small) * copies / (dt * 1e-3)


def timed(fn):
    """(fn(), its milliseconds on the current CUDA device by CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def require_oracle(name, bad, n):
    log(f"   {name}: {n - len(bad)}/{n} equal the scalar ksw oracle")
    if bad:
        raise AssertionError(f"{name}: oracle mismatch at problems {bad[:10]}")


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

@phase("1 probe + build")
def probe_and_build():
    import torch

    from arachne_tpu_torch.device import probe, sm_clocks_mhz
    from arachne_tpu_torch.ops import build

    info = probe()
    for k, v in info.items():
        log(f"   {k}: {v}")
    CLOCKS.update(sm_clocks_mhz())
    log(f"   SM clocks (MHz): {CLOCKS}")
    if not CLOCKS["max_sm"]:
        raise RuntimeError("nvidia-smi gave no maximum SM clock: no bound can be computed")
    lib_t0 = time.perf_counter()
    lib = build.get_lib()
    log(f"   kernels: {build.BUILD_INFO['path']}")
    gran = ctypes.c_longlong(0)
    lib.arachne_l2_fetch_granularity.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    rc = lib.arachne_l2_fetch_granularity(ctypes.byref(gran))
    log(f"   cudaLimitMaxL2FetchGranularity: {gran.value} bytes (rc {rc})")
    log(f"   nvcc build {build.BUILD_INFO['seconds']:.1f} s "
        f"(load {time.perf_counter() - lib_t0:.1f} s)")
    for line in str(build.BUILD_INFO["log"]).splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"   ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    RATES["l2"] = l2_rate(dev)
    RATES["hbm"] = hbm_copy = 2 * (1 << 30) * 4 / (copy_ms(dev, 1 << 30, 4) * 1e-3)
    log(f"   copy rates: {RATES['l2'] / 1e12:.3f} TB/s in L2 (the bound's rate for "
        f"L2-resident tables), {hbm_copy / 1e12:.3f} TB/s on 1 GiB in HBM (phase 7's rate "
        f"for the tables of its index, beyond the L2; data sheet "
        f"{HBM_BYTES_PER_S / 1e12:.2f})")
    return info, dev


@phase("2 kernel parity")
def kernel_parity(dev):
    from arachne_tpu_torch.align import ksw
    from arachne_tpu_torch.config import MemOptions
    from arachne_tpu_torch.device import cuda_ms, device_ms
    from arachne_tpu_torch.ops.cuda_extend import extend16_cuda, extend_cuda
    from arachne_tpu_torch.ops.cuda_global import (
        global_score_cuda, global_z_cuda, traceback_cuda,
    )
    from arachne_tpu_torch.ops.cuda_local import local_cuda
    from arachne_tpu_torch.ops.params import kernel_params
    from arachne_tpu_torch.ops.problems import (
        MAIN, edge_global_problems, extend_problems, global_problems, local_problems, on_device,
    )
    from arachne_tpu_torch.ops.sw_extend import extend_batch, extend_batch_torch, int16_max_h0
    from arachne_tpu_torch.ops.sw_global import (
        decode_traceback_ops, global_batch_torch, traceback_torch,
    )
    from arachne_tpu_torch.ops.sw_local import NEVER, local_sw_full_torch

    opt = MemOptions()
    p = kernel_params(opt, dev)
    g = p.gaps()
    mat = opt.scoring_matrix()
    rows = {}

    def sample(B):
        return np.random.default_rng(99).choice(B, SAMPLE, replace=False)

    def kernel_times(fn):
        # ms: ten calls of the wrapper in a row, host work between the
        # launches included; device_ms: the card's own time per call
        return dict(ms=cuda_ms(fn, 10), device_ms=device_ms(fn, 10))

    # K1 -----------------------------------------------------------------
    seed, B, qmax, tmax = MAIN["K1"]
    qs_l, ts_l, ws, h0s = extend_problems(seed, B, qmax, tmax, opt)
    args = on_device(dev, qs_l, ts_l, qmax, tmax, ws, h0s)
    kw = dict(g, zdrop=p.zdrop)
    got = extend_cuda(*args, p.mat, **kw)
    st = {}
    ref = extend_batch_torch(*args, p.mat, **kw, stats=st)
    err = require_equal("K1", [(got, ref)])
    got_h = got.cpu().numpy()
    bad = [int(b) for b in sample(B) if tuple(got_h[:, b]) != tuple(ksw.extend2(
        qs_l[b], ts_l[b], mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        int(ws[b]), opt.pen_clip5, opt.zdrop, int(h0s[b])))]
    require_oracle("K1", bad, SAMPLE)
    rows["K1"] = dict(
        err=err,
        **kernel_times(lambda: extend_cuda(*args, p.mat, **kw)),
        plain_ms=cuda_ms(lambda: extend_batch_torch(*args, p.mat, **kw), 1),
        cells=st["cells"], **bound(ops=st["cells"] * DP_INSTR_PER_CELL),
    )

    # K1 int16 -----------------------------------------------------------
    # The same problems with the DP state in int16 (the reference's
    # wide_state=False), whose range sw_extend.int16_state_fits proves from
    # the batch's max h0.  The main path keeps int32 state, so the kernel's
    # launches are this phase's: its count set to 0, then one call of the
    # wrapper a user calls; the comparisons and timings come after.
    max_h0 = int(h0s.max())
    kw16 = dict(kw, wide_state=False, max_h0=max_h0)
    extend16_cuda.launches = 0
    got16 = extend_batch(*args, p.mat, **kw16)
    launches16 = extend16_cuda.launches
    if launches16 != 1:
        raise AssertionError(f"K1 int16: {launches16} launches of its kernel, not 1")
    ref16 = extend_batch_torch(*args, p.mat, **kw16)
    err16 = require_equal("K1 int16", [(got16, ref16), (got16, got)])
    got_h = got16.cpu().numpy()
    bad = [int(b) for b in sample(B) if tuple(got_h[:, b]) != tuple(ksw.extend2(
        qs_l[b], ts_l[b], mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        int(ws[b]), opt.pen_clip5, opt.zdrop, int(h0s[b])))]
    require_oracle("K1 int16", bad, SAMPLE)
    log(f"   K1 int16: equals the plain int16 version and the int32 kernel; max h0 {max_h0}, "
        f"the range proof's largest {int16_max_h0(qmax, mat, **g)}")
    # two cells' max-plus step per s16x2 instruction, at the int32 rate
    rows["K1 int16"] = dict(
        err=err16, launches=launches16, launches_in="phase 2",
        **kernel_times(lambda: extend_cuda(*args, p.mat, **kw16)),
        plain_ms=cuda_ms(lambda: extend_batch_torch(*args, p.mat, **kw16), 1),
        cells=st["cells"], **bound(ops=st["cells"] * DP_INSTR_PER_CELL / 2),
    )

    # K2 -----------------------------------------------------------------
    seed, B, qmax, tmax = MAIN["K2"]
    qs_l, ts_l = local_problems(seed, B, qmax, tmax)
    minsc = opt.min_seed_len * opt.a
    args = on_device(dev, qs_l, ts_l, qmax, tmax,
                     np.full(B, NEVER, np.int32), np.full(B, minsc, np.int32))
    kw = dict(g, max_mat=p.max_mat)
    got = local_cuda(*args, p.mat, **kw)
    ref = local_sw_full_torch(*args, p.mat, **kw)
    err = require_equal("K2", [(got, ref)])
    got_h = got.cpu().numpy()
    bad = []
    for b in sample(B):
        r = ksw.local_sw(qs_l[b], ts_l[b], mat, opt.o_del, opt.e_del, opt.o_ins,
                         opt.e_ins, minsc, NEVER)
        if (r.score, r.te, r.qe, r.score2, r.te2) != tuple(got_h[:, b]):
            bad.append(int(b))
    require_oracle("K2", bad, SAMPLE)
    # no early stop (endsc NEVER): every problem runs all its rows
    cells = int((args[2].long() * args[3].long().clamp(max=tmax)).sum())
    rows["K2"] = dict(
        err=err,
        **kernel_times(lambda: local_cuda(*args, p.mat, **kw)),
        plain_ms=cuda_ms(lambda: local_sw_full_torch(*args, p.mat, **kw), 1),
        cells=cells, **bound(ops=cells * DP_INSTR_PER_CELL),
    )

    # K3 score -----------------------------------------------------------
    seed, B, qmax, tmax = MAIN["K3 score"]
    qs_l, ts_l, ws = global_problems(seed, B, qmax, tmax, max_indel=0)
    args = on_device(dev, qs_l, ts_l, qmax, tmax, ws)
    got = global_score_cuda(*args, p.mat, **g)
    ref, _ = global_batch_torch(*args, p.mat, **g, want_z=False)
    err = require_equal("K3 score", [(got, ref)])
    got_h = got.cpu().numpy()
    bad = [int(b) for b in sample(B) if int(got_h[b]) != ksw.global2(
        qs_l[b], ts_l[b], mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        int(ws[b]), want_cigar=False)[0]]
    require_oracle("K3 score", bad, SAMPLE)
    cells = band_cells(*(a.cpu().numpy() for a in args[2:]))
    rows["K3 score"] = dict(
        err=err,
        **kernel_times(lambda: global_score_cuda(*args, p.mat, **g)),
        plain_ms=cuda_ms(lambda: global_batch_torch(*args, p.mat, **g, want_z=False), 1),
        cells=cells, **bound(ops=cells * DP_INSTR_PER_CELL),
    )

    # K3 z + K4 ----------------------------------------------------------
    # Two gapped sets at 128 x 192 x 320, single-base indels (the
    # simulator's, and the reference tests' own) and indels of 1-12 bases,
    # held to the scalar oracle in full: K4 takes ksw.global2's turn out of
    # an insertion (csrc/global.cu), so the walks agree on longer
    # insertions too.
    _, B, qmax, tmax = MAIN["K3 z"]
    steps = qmax + tmax
    for label, max_indel in (("1-base indels", 1), ("indels of 1-12 bases", 12)):
        qs_l, ts_l, ws = global_problems(4 + max_indel, B, qmax, tmax, max_indel)
        args = on_device(dev, qs_l, ts_l, qmax, tmax, ws)
        _, _, ql, tl, wt = args
        sc_k, z_k = global_z_cuda(*args, p.mat, **g)
        sc_p, z_p = global_batch_torch(*args, p.mat, **g, want_z=True)
        err_z = require_equal("K3 z", [(sc_k, sc_p), (z_k, z_p)])
        ops_k, fi_k, fk_k = traceback_cuda(z_k, ql, tl, wt, max_steps=steps)
        ops_p, fi_p, fk_p = traceback_torch(z_k, ql, tl, wt, max_steps=steps)
        err_tb = require_equal("K4", [(ops_k, ops_p), (fi_k, fi_p), (fk_k, fk_p)])
        ops_h, fi_h, fk_h, sc_h = (x.cpu().numpy() for x in (ops_k, fi_k, fk_k, sc_k))
        bad = []
        n_gapped = 0
        for b in range(B):   # all of them: the batch is smaller than the sample
            cig = decode_traceback_ops(ops_h[:, b], int(fi_h[b]), int(fk_h[b]))
            n_gapped += any(op != 0 for op, _ in cig)
            ref_sc, ref_cig = ksw.global2(qs_l[b], ts_l[b], mat, opt.o_del, opt.e_del,
                                          opt.o_ins, opt.e_ins, int(ws[b]))
            if int(sc_h[b]) != ref_sc or cig != ref_cig:
                bad.append(b)
        require_oracle(f"K3 z + K4, {label} (score and CIGAR)", bad, B)
        log(f"   K4, {label}: {n_gapped}/{B} CIGARs carry I/D ops")
    # the edge problems at two other strip widths, untimed
    for e_qmax, e_tmax in ((64, 96), (1024, 1100)):
        e_qs, e_ts, e_ws = edge_global_problems(e_qmax, 72, e_qmax, e_tmax)
        e_args = on_device(dev, e_qs, e_ts, e_qmax, e_tmax, e_ws)
        e_sc, e_z = global_z_cuda(*e_args, p.mat, **g)
        want_sc, want_z = global_batch_torch(*e_args, p.mat, **g, want_z=True)
        err_z = max(err_z, require_equal(f"K3 z, edge problems at {e_qmax} x {e_tmax}",
                                         [(e_sc, want_sc), (e_z, want_z)]))
        rows["K3 score"]["err"] = max(rows["K3 score"]["err"], require_equal(
            f"K3 score, edge problems at {e_qmax} x {e_tmax}",
            [(global_score_cuda(*e_args, p.mat, **g), want_sc)]))
        for e_steps in (e_qmax + e_tmax, e_qmax + e_tmax - 13):
            err_tb = max(err_tb, require_equal(
                f"K4, edge problems at {e_qmax} x {e_tmax}",
                zip(traceback_cuda(e_z, *e_args[2:], max_steps=e_steps),
                    traceback_torch(e_z, *e_args[2:], max_steps=e_steps))))
        log(f"   K3 score, K3 z, K4: equal their plain versions on 72 edge problems at "
            f"{e_qmax} x {e_tmax}")
    # timed on the last (longer-indel) set; K3 z writes its whole (B, tmax,
    # qmax) byte array, K4 reads one z byte per step of each walk and
    # writes (max_steps, B) ops and two int32 per problem
    cells = band_cells(ql.cpu().numpy(), tl.cpu().numpy(), wt.cpu().numpy())
    rows["K3 z"] = dict(
        err=err_z,
        **kernel_times(lambda: global_z_cuda(*args, p.mat, **g)),
        plain_ms=cuda_ms(lambda: global_batch_torch(*args, p.mat, **g, want_z=True), 1),
        cells=cells, **bound(ops=cells * DP_INSTR_PER_CELL, nbytes=z_k.numel() + 4 * B),
    )
    walk = int((ops_k != 3).sum())
    rows["K4"] = dict(
        err=err_tb,
        **kernel_times(lambda: traceback_cuda(z_k, ql, tl, wt, max_steps=steps)),
        plain_ms=cuda_ms(lambda: traceback_torch(z_k, ql, tl, wt, max_steps=steps), 1),
        steps=walk, **bound(ops=walk * TRACEBACK_OPS_PER_STEP,
                            nbytes=walk + ops_k.numel() + 8 * B),
    )
    log_rows(rows)
    return rows


def on_card(ms) -> str:
    """A device time as logged; None where the profiler lost records."""
    return f"{ms:.4f} ms on the card" if ms is not None else "on the card: not measured"


def log_rows(rows):
    for name, r in rows.items():
        card = f" ({on_card(r.get('device_ms'))})"
        if "pass2_ms" in r:
            card += (f"; pass 2 ({r['pass2_jobs']} jobs) {r['pass2_ms']:.3f} ms "
                     f"({on_card(r['pass2_device_ms'])})")
        log(f"   {name}: kernel {r['ms']:.3f} ms{card}, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err {r['err']} "
            "(tolerance 0)")


@phase("library")
def library(work):
    from arachne_tpu_torch.align.smem_native import smem_available
    from arachne_tpu_torch.measure import make_library

    # 2 Mbp genome, 320 barcodes x 3 molecules x 20 pairs, indel rate 0.1
    ref, r1, r2, n, t_index, t_sim = make_library(work)
    log(f"   index of 2 Mbp built in {t_index:.1f} s")
    log(f"   simulated {n} pairs in {t_sim:.1f} s")
    loaded = smem_available()
    log(f"   native host library loaded: {loaded}")
    if not loaded:
        raise RuntimeError("the native C++ host library did not load: the main path "
                           "would seed and chain on numpy fallbacks")
    return ref, r1, r2, n


MAIN_LAUNCHERS = ("K1", "K2", "K3 score", "K3 z", "K4")


def launchers():
    from arachne_tpu_torch import bench
    from arachne_tpu_torch.ops.cuda_extend import extend16_cuda
    from arachne_tpu_torch.ops.cuda_rank import rank_cuda, rank_sharded_cuda
    from arachne_tpu_torch.ops.cuda_seed import pass3_sharded_cuda, smem_pass_sharded_cuda

    return dict(bench.launchers(), K5=rank_cuda, **{"K1 int16": extend16_cuda,
                                                    "K5 sharded": rank_sharded_cuda,
                                                    "S1 sharded": smem_pass_sharded_cuda,
                                                    "S3 sharded": pass3_sharded_cuda})


def reset_counts():
    from arachne_tpu_torch.runtime.timers import TIMERS
    from arachne_tpu_torch.ops import fm_seed, sw_global

    for fn in launchers().values():
        fn.launches = 0
    sw_global.traceback_fetches = 0
    fm_seed.overflow_redos = 0
    TIMERS.reset()


def seeding_kernels_on(fm, qs, qlens, opt, MAXC, MAXS, tag):
    """S1 pass 1, S1 pass 2 (every job of pass 1's long SMEMs in one
    launch, as collect_seeds_device runs it) and S3 on ``fm`` with buffers
    of MAXC intervals and MAXS SMEMs; each must equal its plain version on
    the card, out, out_n and the overflow flags alike.  Returns each
    kernel's outputs, its arguments, its reads' overflow flags, the occ4
    rows each pass needs, the plain versions' ms (one run each) and the
    max abs errors of S1 and S3 (0)."""
    import torch

    from arachne_tpu_torch.ops.fm_seed import (
        pass1_seeds, pass2_inputs, pass3, pass3_torch, smem_pass, smem_pass_torch,
    )

    R, L = qs.shape
    zeros = torch.zeros(R, dtype=torch.int32, device=qs.device)
    p1 = (qs, qlens, zeros, zeros + 1, False, MAXC, MAXS)
    st1, st2, st3 = {}, {}, {}
    got1 = smem_pass(fm, *p1)
    want1, plain1_ms = timed(lambda: smem_pass_torch(fm, *p1, stats=st1))
    err1 = require_equal(f"S1 pass 1, {tag}", zip(got1, want1))
    out1, n1, ovf1 = (t.cpu().numpy() for t in got1)
    _, jobs = pass1_seeds(out1, n1, ovf1, R, opt)
    _, *job_args = pass2_inputs(jobs, qs, qlens)
    p2 = (*job_args, True, MAXC, MAXS)
    got2 = smem_pass(fm, *p2)
    want2, plain2_ms = timed(lambda: smem_pass_torch(fm, *p2, stats=st2))
    err1 = max(err1, require_equal(f"S1 pass 2, {tag}", zip(got2, want2)))
    p3 = (qs, qlens, opt.min_seed_len, opt.max_mem_intv, MAXS)
    got3 = pass3(fm, *p3)
    want3, plain3_ms = timed(lambda: pass3_torch(fm, *p3, stats=st3))
    err3 = require_equal(f"S3, {tag}", zip(got3, want3))
    flags = [int(g[2].sum()) for g in (got1, got2, got3)]
    log(f"   S1/S3, {tag}: equal on {R} reads (L {L}); {p2[0].shape[0]} pass-2 jobs; "
        f"overflow flags pass 1 / pass 2 / pass 3: {flags}")
    return dict(outs=(got1, got2, got3), p1=p1, p2=p2, p3=p3, flags=flags,
                rank_rows=tuple(st.get("rank_rows", 0) for st in (st1, st2, st3)),
                plain_ms=(plain1_ms, plain2_ms, plain3_ms), err=(err1, err3))


@phase("2b seeding kernels")
def seeding_parity(dev, lib, work):
    import torch

    from arachne_tpu_torch.config import MemOptions, PipelineOptions
    from arachne_tpu_torch.index import FMIndex, load_index
    from arachne_tpu_torch import device, seeding_bench
    from arachne_tpu_torch.device import cuda_ms, device_ms, graph_ms
    from arachne_tpu_torch.measure import library_reads
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, occ4_device
    from arachne_tpu_torch.ops.fm_seed import pad_reads, pass3, seed_buffers, smem_pass

    ref, r1, r2, _ = lib
    opt = MemOptions()
    idx = FMIndex(*load_index(ref + ".arx.npz"))
    fm = DeviceFMIndex.from_host(idx, dev)
    rows = {}

    # K5 ---------------------------------------------------------------
    err_k5 = seeding_bench.rank_parity(fm)
    wide = seeding_bench.synthetic_table(dev)
    err_k5 = max(err_k5, seeding_bench.rank_parity(wide))
    log(f"   K5: 2048 rows each on the index ({fm.seq_len} rows, int32) and the "
        f"GRCh38-sized table ({wide.seq_len} rows, int64) equal the plain version")

    # S1 and S3 on one superbatch of the library's reads -----------------
    # The main path seeds a superbatch (reads_per_batch pairs) at a time
    # with buffers of seed_buffers(L), which no read can overflow; MAXC=2,
    # MAXS=4 overflow, so the flags are compared too.  The plain versions
    # are timed on their comparison run (one run each).
    reads = library_reads(r1, r2, PipelineOptions().reads_per_batch)
    qs, qlens = pad_reads(reads, dev)
    R, L = qs.shape
    err_s1 = err_s3 = 0
    for MAXC, MAXS in ((seed_buffers(L),) * 2, (2, 4)):
        tag = f"MAXC={MAXC}, MAXS={MAXS}"
        run = seeding_kernels_on(fm, qs, qlens, opt, MAXC, MAXS, tag)
        err_s1, err_s3 = max(err_s1, run["err"][0]), max(err_s3, run["err"][1])
        flags = run["flags"]
        if MAXC == 2:
            if not (flags[0] and flags[2]):
                raise AssertionError(f"{tag} should overflow in passes 1 and 3: {flags}")
            continue
        if any(flags):
            raise AssertionError(f"{tag}: reads overflowed the main path's buffers: {flags}")
        p1, p2, p3 = run["p1"], run["p2"], run["p3"]
        s1, s1_pass2, s3 = ((lambda: smem_pass(fm, *p1)), (lambda: smem_pass(fm, *p2)),
                            (lambda: pass3(fm, *p3)))
        rows["S1"] = dict(err=err_s1, ms=cuda_ms(s1, 10), device_ms=device_ms(s1, 10),
                          pass2_ms=cuda_ms(s1_pass2, 10), pass2_device_ms=device_ms(s1_pass2, 10),
                          pass2_jobs=int(p2[0].shape[0]),
                          plain_ms=run["plain_ms"][0], rank_rows=run["rank_rows"][0],
                          **bound(nbytes=run["rank_rows"][0] * RANK_ROW_BYTES,
                                  bytes_per_s=RATES["l2"]))
        rows["S3"] = dict(err=err_s3, ms=cuda_ms(s3, 10), device_ms=device_ms(s3, 10),
                          plain_ms=run["plain_ms"][2], rank_rows=run["rank_rows"][2],
                          **bound(nbytes=run["rank_rows"][2] * RANK_ROW_BYTES,
                                  bytes_per_s=RATES["l2"]))
    rows["S1"]["err"], rows["S3"]["err"] = err_s1, err_s3
    # K5's device time at the rank benchmark's largest batch (2^20 uniform
    # rows of the wide table, drawn as the benchmark draws them), measured
    # here as S1's and S3's are
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    ks = torch.randint(0, wide.seq_len, (seeding_bench.BATCHES[-1],), dtype=wide.idt,
                       device=dev, generator=g)
    k5_device_ms = device_ms(lambda: occ4_device(wide, ks), 10)
    k5_graph_ms = graph_ms(lambda: occ4_device(wide, ks), 20)
    flag = ""
    if k5_device_ms is None:
        flag = "; FLAG: no profiler reading to hold the graph's against"
    elif abs(k5_graph_ms - k5_device_ms) > K5_READINGS_APART * k5_device_ms:
        flag = f"; FLAG: the two readings differ by more than {K5_READINGS_APART:.0%}"
    log(f"   K5 at {ks.numel()} rows of the wide table: {k5_graph_ms:.4f} ms by CUDA events "
        f"around a graph of 20 launches, {on_card(k5_device_ms)} by the profiler{flag}")
    del wide, ks

    # K5's own path: the rank benchmark, counted from zero ----------------
    reset_counts()
    bench = seeding_bench.main(["--index", ref + ".arx.npz", "--reads", "4096",
                                "--out", os.path.join(work, "seeding_bench.json")])
    k5_launches = launchers()["K5"].launches
    if k5_launches <= 0:
        raise AssertionError("K5 never launched in seeding_bench")
    at = {name: t["batches"][-1] for name, t in bench["tables"].items()}
    for name, b in at.items():
        log(f"   K5 in seeding_bench, {name}, {b['B']} rows: {b['graph_ms']:.4f} ms by a graph, "
            f"{on_card(b['device_ms'])} by the profiler, {b['bytes']} bytes to move")
    rows["K5"] = dict(err=err_k5, ms=at["grch38_sized"]["ms"],
                      device_ms=k5_device_ms, graph_ms=k5_graph_ms,
                      plain_ms=at["grch38_sized"]["plain_ms"],
                      rank_rows=at["grch38_sized"]["B"],
                      **bound(nbytes=at["grch38_sized"]["bytes"]),
                      rank_qps={name: b["rank_qps"] for name, b in at.items()},
                      plain_rank_qps={name: b["plain_rank_qps"] for name, b in at.items()})
    log_rows(rows)
    log(f"   profiler runs thrown away for lost device records: {device.lost_profiles}")
    return rows, {"K5": k5_launches}, bench["seeding"]


@phase("3 host-seeded path (pinned)")
def host_seeded_path(work, dev, lib):
    return host_seeded_run(work, dev, lib)


def host_seeded_run(work, dev, lib):
    """``align --engine cuda`` with host seeding pinned
    (ARACHNE_DEVICE_SEEDING=0) on ``lib``, its launches counted from zero:
    K1-K4 must launch, S1 and S3 must not, and accuracy reach 0.99.
    Returns K1-K4's launches, the output directory, the stage seconds and
    the pairs/s."""
    import torch

    from arachne_tpu_torch.runtime.accuracy import evaluate_sam
    from arachne_tpu_torch.runtime.timers import TIMERS
    from arachne_tpu_torch import cli
    from arachne_tpu_torch.bench import seeding_env
    from arachne_tpu_torch.ops import sw_global
    from arachne_tpu_torch.measure import quiet
    from arachne_tpu_torch.ops.engine import warmup

    ref, r1, r2, n = lib
    # the kernels are built and warmed before the counts start, so every
    # launch counted below is one the main path made
    warmup(dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    out = os.path.join(work, "out_host_seeded")
    t0 = time.perf_counter()
    with seeding_env("0"), quiet(os.path.join(work, "host_seeded.log")):
        stats = cli.main(["align", "--engine", "cuda", "--sam", "-t", "2", out, ref, r1, r2])
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in launchers().items()}
    fetches = sw_global.traceback_fetches
    log(f"   launches in the host-seeded path: {launches}; traceback problems {fetches}")
    if not all(launches[k] > 0 for k in MAIN_LAUNCHERS) or fetches <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if launches["S1"] or launches["S3"]:
        raise AssertionError(f"ARACHNE_DEVICE_SEEDING=0 still seeded on the card: {launches}")
    log(f"   {stats.reads} pairs, {stats.reads / stats.elapsed:.1f} pairs/s "
        f"(align loop {stats.elapsed:.2f} s, whole call {wall:.2f} s)")
    log(f"   peak device memory {torch.cuda.max_memory_allocated(dev)} bytes")
    stages = {k: v["seconds"] for k, v in TIMERS.as_dict().items()}
    log("   stage seconds: " + json.dumps(stages, sort_keys=True))
    acc = evaluate_sam(os.path.join(out, "bc_sorted_bam.sam"))
    ratio = acc.correct / max(acc.total, 1)
    log(f"   accuracy {acc.correct}/{acc.total} = {ratio:.4f}")
    if stats.reads != n or acc.total < 2 * n * 0.95 or ratio < 0.99:
        raise AssertionError(f"main path output wrong: {stats.reads} pairs, accuracy {ratio}")
    return ({k: launches[k] for k in MAIN_LAUNCHERS}, out, stages,
            stats.reads / stats.elapsed)


@phase("4 byte identity with the oracle")
def byte_identity(work, ref):
    from arachne_tpu_torch.index import parse_fasta
    from arachne_tpu_torch.io.simulate import SimConfig, simulate_linked_reads
    from arachne_tpu_torch import cli
    from arachne_tpu_torch.measure import quiet

    r1, r2 = os.path.join(work, "s.R1.fq.gz"), os.path.join(work, "s.R2.fq.gz")
    simulate_linked_reads(
        parse_fasta(ref), r1, r2,
        SimConfig(n_barcodes=5, molecules_per_barcode=3, pairs_per_molecule=20,
                  indel_rate=0.1, vary_quals=True, seed=8),
    )
    dirs = {}
    for engine in ("cuda", "oracle"):
        dirs[engine] = os.path.join(work, f"out_{engine}")
        with quiet(os.path.join(work, f"identity_{engine}.log")):
            stats = cli.main(["align", "--engine", engine, "--sam", "-t", "2", dirs[engine],
                              ref, r1, r2])
        log(f"   --engine {engine}: {stats.reads} pairs, {stats.reads / stats.elapsed:.1f} pairs/s")
    names = sorted(os.listdir(dirs["oracle"]))
    if sorted(os.listdir(dirs["cuda"])) != names:
        raise AssertionError("the engines wrote different shard sets")
    for f in names:
        same = filecmp.cmp(os.path.join(dirs["cuda"], f), os.path.join(dirs["oracle"], f),
                           shallow=False)
        log(f"   {f}: {'identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{f} differs between --engine cuda and --engine oracle")


@phase("5 the main path (default: device-seeded)")
def device_seeded_path(work, dev, lib, host_out, host_stages):
    return device_seeded_run(work, dev, lib, host_out, host_stages)


def device_seeded_run(work, dev, lib, host_out, host_stages):
    """``align --engine cuda`` on ``lib`` with no ARACHNE_DEVICE_SEEDING,
    as a user runs it, its launches counted from zero: it seeds on the
    card, so S1, S3 and K1-K4 must launch, no read may be redone, accuracy
    must reach 0.99 and every shard must equal the host-seeded run's in
    ``host_out``.  Returns the launches of K1-K4, S1 and S3, the stage
    seconds and the pairs/s."""
    import torch

    from arachne_tpu_torch.runtime.accuracy import evaluate_sam
    from arachne_tpu_torch.runtime.timers import TIMERS
    from arachne_tpu_torch import cli
    from arachne_tpu_torch.measure import quiet, same_shards
    from arachne_tpu_torch.ops import fm_seed

    ref, r1, r2, n = lib
    if "ARACHNE_DEVICE_SEEDING" in os.environ:
        raise AssertionError("the default run needs ARACHNE_DEVICE_SEEDING unset")
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    out = os.path.join(work, "out_device_seeding")
    with quiet(os.path.join(work, "device_seeding.log")):
        stats = cli.main(["align", "--engine", "cuda", "--sam", "-t", "2", out, ref, r1, r2])
    launches = {k: fn.launches for k, fn in launchers().items()}
    log(f"   launches in the default (device-seeded) path: {launches}")
    if not all(launches[k] > 0 for k in MAIN_LAUNCHERS + ("S1", "S3")):
        raise AssertionError(f"a kernel of the device-seeded path never launched: {launches}")
    stages = {k: v["seconds"] for k, v in TIMERS.as_dict().items()}
    log(f"   {stats.reads} pairs, {stats.reads / stats.elapsed:.1f} pairs/s "
        f"(align loop {stats.elapsed:.2f} s)")
    log(f"   seed.device {stages.get('seed.device')} s against phase 3's seed.host "
        f"{host_stages.get('seed.host')} s; {fm_seed.overflow_redos} reads redone after "
        f"an overflow")
    if fm_seed.overflow_redos:
        raise AssertionError(f"{fm_seed.overflow_redos} reads overflowed the seeding buffers")
    log(f"   peak device memory {torch.cuda.max_memory_allocated(dev)} bytes")
    log("   stage seconds: " + json.dumps(stages, sort_keys=True))
    acc = evaluate_sam(os.path.join(out, "bc_sorted_bam.sam"))
    ratio = acc.correct / max(acc.total, 1)
    log(f"   accuracy {acc.correct}/{acc.total} = {ratio:.4f}")
    if stats.reads != n or acc.total < 2 * n * 0.95 or ratio < 0.99:
        raise AssertionError(f"device-seeded output wrong: {stats.reads} pairs, accuracy {ratio}")
    same = same_shards(host_out, out)
    log(f"   shards byte-identical to phase 3's: {same}")
    if not all(same.values()):
        raise AssertionError(f"device seeding changed the output: {same}")
    return ({k: launches[k] for k in MAIN_LAUNCHERS + ("S1", "S3")}, stages,
            stats.reads / stats.elapsed)


# trials of each seeding in phase 5b
SEEDING_TRIALS = 3
SEEDING_STAGES = ("seed.host", "seed.device", "seed.device.redo", "chain.host")


@phase("5b host against device seeding, in turns")
def seeding_in_turns(work, dev, lib, host_out):
    """Phase 3's host-seeded run and phase 5's default run, in turns,
    SEEDING_TRIALS of each: pairs/s and the seeding and chaining stage
    seconds (summed over the workers), every shard set equal to phase
    3's."""
    from arachne_tpu_torch.runtime.timers import TIMERS
    from arachne_tpu_torch import cli
    from arachne_tpu_torch.bench import seeding_env
    from arachne_tpu_torch.measure import quiet, same_shards

    ref, r1, r2, n = lib
    rows = {"host": [], "default": []}
    for trial in range(SEEDING_TRIALS):
        for name in ("host", "default"):
            out = os.path.join(work, f"out_turns_{name}{trial}")
            TIMERS.reset()
            seeding = seeding_env("0") if name == "host" else contextlib.nullcontext()
            with seeding, quiet(os.path.join(work, f"turns_{name}{trial}.log")):
                stats = cli.main(["align", "--engine", "cuda", "--sam", "-t", "2", out, ref, r1,
                                  r2])
            stages = {k: v["seconds"] for k, v in TIMERS.as_dict().items()}
            same = same_shards(host_out, out)
            if stats.reads != n or not all(same.values()):
                raise AssertionError(f"5b {name} trial {trial}: output differs from phase 3's")
            row = dict(pairs_per_s=stats.reads / stats.elapsed,
                       **{k: stages.get(k) for k in SEEDING_STAGES})
            rows[name].append(row)
            log(f"   5b trial {trial}, {name} seeding: {row['pairs_per_s']:.2f} pairs/s; "
                + ", ".join(f"{k} {row[k]}" for k in SEEDING_STAGES if row[k] is not None))
            shutil.rmtree(out, ignore_errors=True)
    log("   5b pairs/s in turns: host " + " ".join(f"{r['pairs_per_s']:.2f}" for r in rows["host"])
        + "; default (device seeding) "
        + " ".join(f"{r['pairs_per_s']:.2f}" for r in rows["default"]))
    return rows


# seconds any one align subprocess of phase 6 may take (each takes about
# 20-40 s on the card, start-up and the index load included)
SUBPROCESS_TIMEOUT = 300
CRASH_AFTER_SETS, CHECKPOINT_EVERY = 160, 50


def cli_command(*args):
    return [sys.executable, "-m", "arachne_tpu_torch.cli", *args]


def cli_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("ARACHNE_CRASH_AFTER_SETS", "ARACHNE_CHECKPOINT_EVERY", "ARACHNE_DEVICE_SEEDING",
              "ARACHNE_COORDINATOR", "ARACHNE_NUM_PROCESSES", "ARACHNE_PROCESS_ID"):
        env.pop(k, None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_logged(cmds, logs, env, timeout=SUBPROCESS_TIMEOUT):
    """Start every command at once, each writing to its log; wait for all
    within ``timeout`` seconds, killing any left; return their exit codes
    and logs' text."""
    procs = []
    try:
        for cmd, path, e in zip(cmds, logs, env):
            with open(path, "w") as fh:
                procs.append(subprocess.Popen(cmd, cwd=ROOT, env=e, stdout=fh,
                                              stderr=subprocess.STDOUT))
        t0 = time.monotonic()
        deadline = t0 + timeout
        rcs = []
        for p, path in zip(procs, logs):
            rcs.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
            log(f"   {os.path.basename(path)}: exit code {rcs[-1]} after "
                f"{time.monotonic() - t0:.1f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for path in logs:
        with open(path) as fh:
            texts.append(fh.read())
    return rcs, texts


def require_rc(what, rc, want, text):
    if rc != want:
        raise AssertionError(f"{what}: exit code {rc}, expected {want}; log ends:\n{text[-3000:]}")


def pairs_per_s(text):
    m = re.search(r"completed successfully: (\d+) read pairs, (\d+) barcodes, ([\d.]+) pairs/s",
                  text)
    if m is None:
        raise AssertionError(f"no completion line in the log; it ends:\n{text[-3000:]}")
    return int(m.group(1)), int(m.group(2)), float(m.group(3))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sam_records(path):
    with open(path) as fh:
        lines = fh.readlines()
    return [ln for ln in lines if not ln.startswith("@")], [ln for ln in lines if ln.startswith("@")]


class CardMemory:
    """nvidia-smi's memory in use on the card, sampled every 0.2 s on a
    thread between start() and stop(): the peak in MiB."""

    def __init__(self):
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def read(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        return int(out.stdout.split()[0])

    def _run(self):
        while not self._stop.is_set():
            self.samples.append(self.read())
            self._stop.wait(0.2)

    def start(self):
        self.baseline = self.read()
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)
        return max(self.samples, default=self.baseline)


@phase("6 checkpoint, resume, two processes, two-device dispatch")
def other_routes(work, dev, lib, host_out):
    from arachne_tpu_torch import cli
    from arachne_tpu_torch.measure import quiet, same_shards
    from arachne_tpu_torch.ops import devicepool

    ref, r1, r2, n = lib
    align = ("align", "--engine", "cuda", "--sam", "-t", "2")
    host_records, host_header = sam_records(os.path.join(host_out, "bc_sorted_bam.sam"))
    host_records.sort()
    runs = {}

    # 6a: crash, status, resume, merge ------------------------------------
    t0 = time.perf_counter()
    out, ckpt = os.path.join(work, "out_resumed"), os.path.join(work, "ckpt", "run.ckpt")
    stats_json, prof_dir = os.path.join(work, "resume_stats.json"), os.path.join(work, "profile")
    os.makedirs(os.path.dirname(ckpt))
    cmd = cli_command(*align, "--checkpoint", ckpt, out, ref, r1, r2)
    (rc,), (text,) = run_logged([cmd], [os.path.join(work, "crash.log")], [cli_env(
        ARACHNE_CRASH_AFTER_SETS=CRASH_AFTER_SETS, ARACHNE_CHECKPOINT_EVERY=CHECKPOINT_EVERY)])
    require_rc("6a crash", rc, 17, text)
    claimed = CRASH_AFTER_SETS // CHECKPOINT_EVERY * CHECKPOINT_EVERY
    # the shard holds records of sets past the last manifest: the resume
    # must cut them off, or they would be written twice
    with open(ckpt) as fh:
        offset = json.load(fh)["offsets"]["bc_sorted_bam.sam"]
    on_disk = os.path.getsize(os.path.join(out, "bc_sorted_bam.sam"))
    if on_disk <= offset:
        raise AssertionError(f"6a: the crash left nothing past the manifest ({on_disk} bytes)")
    with quiet(os.path.join(work, "status.log")):
        try:
            cli.main(["status", ckpt])
            rc = None
        except SystemExit as e:
            rc = e.code
    with open(os.path.join(work, "status.log")) as fh:
        status = fh.read()
    require_rc("6a status", rc, 0, status)
    if f"g0 h0/1: {claimed} sets" not in status:
        raise AssertionError(f"6a status does not name the claim of {claimed} sets: {status}")
    log(f"   crashed with exit code 17 after {CRASH_AFTER_SETS} sets, bc_sorted_bam.sam "
        f"{on_disk} bytes against the manifest's {offset}; status: {status.strip()}")
    (rc,), (text,) = run_logged(
        [cmd + ["--stats-json", stats_json, "--profile-dir", prof_dir]],
        [os.path.join(work, "resume.log")], [cli_env(ARACHNE_CHECKPOINT_EVERY=CHECKPOINT_EVERY)])
    require_rc("6a resume", rc, 0, text)
    if f"Resuming: skipping {claimed} completed barcode sets" not in text:
        raise AssertionError("6a: the resumed run did not skip the claimed sets")
    runs["6a resume"] = pairs_per_s(text)[::2]
    with quiet(os.path.join(work, "merge.log")):
        cli.main(["merge", out])
    same = same_shards(host_out, out)
    log(f"   merged shards byte-identical to phase 3's: {same}")
    if not all(same.values()):
        raise AssertionError(f"6a: crash, resume and merge changed the output: {same}")
    with open(stats_json) as fh:
        stats = json.load(fh)
    trace_path = os.path.join(prof_dir, "arachne.trace.json")
    with open(trace_path) as fh:
        trace = fh.read()
    json.loads(trace)
    if "extend_kernel" not in trace:
        raise AssertionError(f"6a: the profiler trace {trace_path} names no extend_kernel")
    with open(os.path.join(prof_dir, "arachne.spans.json")) as fh:
        spans = json.load(fh)["traceEvents"]
    k1 = [e for e in spans if e["name"] == "arachne_extend" and e["args"].get("cells")]
    if not k1:
        raise AssertionError("6a: the program's spans hold no K1 launch with its cells")
    log(f"   resumed run: {stats['reads']} pairs, {stats['barcodes']} barcodes, stats JSON with "
        f"{len(stats['stage_times'])} stages; trace ({len(trace)} bytes) names extend_kernel "
        f"{trace.count('extend_kernel')} times; {len(spans)} span events, {len(k1)} K1 "
        f"launches with {sum(e['args']['cells'] for e in k1)} cells")
    log(f"   6a in {time.perf_counter() - t0:.1f} s")

    # 6b: two processes on the one card -----------------------------------
    t0 = time.perf_counter()
    out = os.path.join(work, "out_fleet")
    coord = f"127.0.0.1:{free_port()}"
    cmds = [cli_command(*align, "--coordinator", coord, "--num-processes", "2",
                        "--process-id", str(i), out, ref, r1, r2) for i in (0, 1)]
    mem = CardMemory()
    mem.start()
    try:
        rcs, texts = run_logged(cmds, [os.path.join(work, f"fleet{i}.log") for i in (0, 1)],
                                [cli_env(), cli_env()])
    finally:
        peak = mem.stop()
    for i, (rc, text) in enumerate(zip(rcs, texts)):
        require_rc(f"6b process {i}", rc, 0, text)
        reads, _, rate = pairs_per_s(text)
        if reads != n:
            raise AssertionError(f"6b process {i} printed {reads} merged pairs, expected {n}")
        own = int(re.search(r"\(host \d+: (\d+) pairs\)", text).group(1))
        runs[f"6b process {i} (its share)"] = (own, rate)
    records = []
    for i in (0, 1):
        recs, header = sam_records(os.path.join(out, f"bc_sorted_bam.host{i:03d}.sam"))
        if header != host_header:
            raise AssertionError(f"6b: host{i:03d}'s header differs from phase 3's")
        records += recs
    if sorted(records) != host_records:
        raise AssertionError("6b: the two processes' records are not phase 3's")
    log(f"   two processes: union of {len(records)} records equals phase 3's; both printed "
        f"the merged {n} read pairs; card memory in use (nvidia-smi) {mem.baseline} MiB "
        f"before, peak {peak} MiB during ({peak - mem.baseline} MiB for the two processes, "
        "each seeding on the card with its own rank tables)")
    log(f"   6b in {time.perf_counter() - t0:.1f} s")

    # 6c: the device pool pinned to [card, card], counted from zero -------
    t0 = time.perf_counter()
    out = os.path.join(work, "out_pool")
    reset_counts()
    with devicepool.pinned([dev, dev]), quiet(os.path.join(work, "pool.log")):
        st = cli.main([*align, out, ref, r1, r2])
    launches = {k: fn.launches for k, fn in launchers().items()}
    log(f"   launches with the pool pinned to [{dev}, {dev}]: {launches}")
    if not all(launches[k] > 0 for k in MAIN_LAUNCHERS):
        raise AssertionError(f"6c: a kernel of the main path never launched: {launches}")
    same = same_shards(host_out, out)
    log(f"   shards byte-identical to phase 3's: {same}")
    if not all(same.values()):
        raise AssertionError(f"6c: two-device dispatch changed the output: {same}")
    runs["6c pool"] = (st.reads, st.reads / st.elapsed)
    log(f"   6c in {time.perf_counter() - t0:.1f} s")
    for name, (reads, rate) in runs.items():
        log(f"   {name}: {reads} pairs at {rate:.1f} pairs/s")
    return dict(runs=runs, fleet_peak_mib=peak, fleet_baseline_mib=mem.baseline)


# Phase 7's genome: config 3's size, 4 contigs x 16 Mbp (seed 7), with the
# planted repeat families and N runs of make_scale_genome.  Its 1.28e8 rows
# are above IndexOptions.sa_full_max_len (2^26), so the suffix array is
# sampled, and its record table (64 MB) is beyond the 50 MB L2, so S1, S3
# and K5 read HBM.  Any cut must keep both.
SCALE_CONTIGS, SCALE_CONTIG_LEN, SCALE_SEED = 4, 16_000_000, 7
# seconds the genome and the index builds may take (the build takes about a
# minute; the smoke's limit is 1200 s in all)
SCALE_GENOME_TIMEOUT, SCALE_INDEX_TIMEOUT = 120, 400
# 7d: random reads on the synthetic GRCh38-sized table
WIDE_READS = 1024


@phase("7 genome scale")
def genome_scale(work, dev, l2_rows, rates):
    import torch

    from arachne_tpu_torch import seeding_bench
    from arachne_tpu_torch.config import MemOptions, PipelineOptions
    from arachne_tpu_torch.device import device_ms, graph_ms
    from arachne_tpu_torch.index import FMIndex, load_index
    from arachne_tpu_torch.measure import library_reads, reference_library
    from arachne_tpu_torch.ops.engine import device_tables
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, occ4_device
    from arachne_tpu_torch.ops.fm_seed import pad_reads, pass3, seed_buffers, smem_pass

    opt = MemOptions()
    res = {}
    # 7a: the genome and its index, built as measure --reference builds it
    t0 = time.perf_counter()
    fasta = os.path.join(work, "scale.fa")
    (rc,), (text,) = run_logged(
        [[sys.executable, "-m", "arachne_tpu_torch.scripts.make_scale_genome", fasta,
          "--contigs", str(SCALE_CONTIGS), "--contig-len", str(SCALE_CONTIG_LEN),
          "--seed", str(SCALE_SEED)]],
        [os.path.join(work, "scale_genome.log")], [cli_env()], SCALE_GENOME_TIMEOUT)
    require_rc("7a make_scale_genome", rc, 0, text)
    log(f"   7a: genome of {SCALE_CONTIGS} x {SCALE_CONTIG_LEN} bp (seed {SCALE_SEED}) in "
        f"{time.perf_counter() - t0:.1f} s")
    ref, r1, r2, n, build, t_sim = reference_library(work, fasta, timeout=SCALE_INDEX_TIMEOUT)
    log(f"   7a: index built by `cli index` in {build['build_s']} s, peak RSS "
        f"{build['peak_rss_bytes']} bytes, build-mode auto line: {build['build_mode_line']!r}, "
        f"{build['index_bytes']} bytes on disk, {build['seq_len']} rows, sa_intv "
        f"{build['sa_intv']}, sampled SA {build['sa_sampled']}, wide {build['wide']}")
    log(f"   7a: simulated {n} pairs in {t_sim:.1f} s")
    idx = FMIndex(*load_index(ref + ".arx.npz"))
    if not build["sa_sampled"] or idx.fm.sa is not None or not idx.fm.sa_sampled.size:
        raise AssertionError("7a: the index does not keep a sampled suffix array")
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    table_bytes = DeviceFMIndex.table_bytes(idx)
    log(f"   7a: record table {table_bytes} bytes against the L2's {l2}")
    if table_bytes <= l2:
        raise AssertionError("7a: the index's tables fit the L2: nothing here reads HBM")
    res["build"] = build

    # 7b: the library through the main path, host-seeded then device-seeded
    lib = (ref, r1, r2, n)
    _, host_out, host_stages, host_rate = host_seeded_run(work, dev, lib)
    _, dev_stages, dev_rate = device_seeded_run(work, dev, lib, host_out, host_stages)
    keys = ("seed.host", "seed.device", "chain.host", "cigar", "rfa.host", "io.write")
    for name, stages, rate in (("host-seeded", host_stages, host_rate),
                               ("device-seeded", dev_stages, dev_rate)):
        log(f"   7b {name}: {rate:.1f} pairs/s (the 2 Mbp genome {name}, in this call: "
            f"{rates[name]:.1f}); " + ", ".join(f"{k} {stages.get(k)}" for k in keys))
    res.update(device_rate=dev_rate,
               lib=lib, device_out=os.path.join(work, "out_device_seeding"))

    # 7c: the seeding kernels on this index's tables, which lie in HBM
    fm = device_tables(idx, dev)
    reads = library_reads(r1, r2, PipelineOptions().reads_per_batch)
    qs, qlens = pad_reads(reads, dev)
    MAX = seed_buffers(qs.shape[1])
    narrow = seeding_kernels_on(fm, qs, qlens, opt, MAX, MAX, "int32 tables beyond the L2")
    wide_fm = DeviceFMIndex.from_host(idx, dev, wide=True)
    wide = seeding_kernels_on(wide_fm, qs, qlens, opt, MAX, MAX,
                              "the same index's tables forced wide")
    if any(narrow["flags"] + wide["flags"]):
        raise AssertionError("7c: reads overflowed the main path's buffers")
    for name, a, b in zip(("S1 pass 1", "S1 pass 2", "S3"), narrow["outs"], wide["outs"]):
        if b[0].dtype != torch.int64:
            raise AssertionError(f"7c {name}: the wide tables gave {b[0].dtype}")
        require_equal(f"{name}, wide against int32, cast", zip(a, b))
    log("   7c: the wide tables' outputs equal the int32 ones, cast")
    del wide_fm
    ks = seeding_bench.parity_rows(fm, 4096)
    got = occ4_device(fm, ks).cpu().numpy()
    if not np.array_equal(got, idx.occ4(ks.cpu().numpy().astype(np.int64))):
        raise AssertionError("7c: K5 differs from the host occ4 on the index beyond the L2")
    log(f"   7c: K5 (four lanes a query: the table exceeds the L2) equals idx.occ4 on "
        f"{ks.numel()} rows, edge rows included")
    # the kernels' device times beside phase 2b's on the 2 Mbp index in the
    # L2; bounds: 64 bytes an occ4 row at the HBM rate phase 1 measured
    times = {}
    for i, name in enumerate(("S1", "S1 pass 2", "S3")):
        args = (narrow["p1"], narrow["p2"], narrow["p3"])[i]
        fn = (lambda a=args: smem_pass(fm, *a)) if i < 2 else (lambda a=args: pass3(fm, *a))
        rows = narrow["rank_rows"][i]
        times[name] = dict(device_ms=device_ms(fn, 10), graph_ms=graph_ms(fn, 10),
                           plain_ms=narrow["plain_ms"][i], rank_rows=rows,
                           **bound(nbytes=rows * RANK_ROW_BYTES, bytes_per_s=RATES["hbm"]))
    l2_ms = {"S1": l2_rows["S1"]["device_ms"], "S1 pass 2": l2_rows["S1"]["pass2_device_ms"],
             "S3": l2_rows["S3"]["device_ms"]}
    for name, t in times.items():
        log(f"   7c {name}: {on_card(t['device_ms'])} (graph {t['graph_ms']:.4f} ms), "
            f"{t['rank_rows']} occ4 rows, bound {t['bound_ms']:.4f} ms at the HBM copy rate; "
            f"phase 2b in the L2: {on_card(l2_ms[name])}; plain {t['plain_ms']:.1f} ms")
    res["seeding_kernels"] = times
    bench = seeding_bench.main(["--index", ref + ".arx.npz", "--wide-blocks", "0",
                                "--reads", "4096", "--out", os.path.join(work, "seeding7.json")])
    last = bench["tables"]["index"]["batches"][-1]
    k5_bound = bound(nbytes=last["bytes"], bytes_per_s=RATES["hbm"])
    log(f"   7c: K5 at {last['B']} rows of this index: {last['graph_ms']:.4f} ms by a graph, "
        f"bound {k5_bound['bound_ms']:.4f} ms at the HBM copy rate; seeding 4096 reads: "
        f"device flat {bench['seeding']['flat_reads_per_s']:.0f} reads/s, as lists "
        f"{bench['seeding']['device_reads_per_s']:.0f} reads/s, native "
        f"{bench['seeding']['native_reads_per_s']:.0f} reads/s")
    res.update(k5=dict(last, **k5_bound), seeding=bench["seeding"])
    del fm

    # 7d: S1/S3 on rows at and above 2^31, on the synthetic GRCh38-sized table
    big = seeding_bench.synthetic_table(dev)
    past = seeding_bench.wide_seeding_parity(big, WIDE_READS)
    log(f"   7d: S1 pass 1, S1 pass 2 and S3 equal their plain versions on {WIDE_READS} "
        f"random reads on the synthetic table ({big.seq_len} rows, int64); {past} of their "
        "k, l and s values are at or above 2^31")
    del big
    return res


# seconds the bench subprocess of phase 8 may take (about 4 minutes on the
# card: fixtures and their indexes, then six lines)
BENCH_TIMEOUT = 600
BENCH_METRICS = ["seed_extension_DP_GCUPS", "repeat_genome_pairs_per_sec",
                 "indel_e2e_pairs_per_sec", "mapq_expected_calibration_error",
                 "end_to_end_device_seeded_pairs_per_sec", "end_to_end_pairs_per_sec"]


@phase("8 bench")
def bench_phase(work, dev):
    from arachne_tpu_torch import bench
    from arachne_tpu_torch.ops import fm_seed

    cache = os.path.join(ROOT, "build", "bench_cache")
    (rc,), (text,) = run_logged(
        [[sys.executable, "-m", "arachne_tpu_torch.bench", "--trials", "1", "--cache", cache]],
        [os.path.join(work, "bench.log")], [cli_env()], BENCH_TIMEOUT)
    lines = [json.loads(ln) for ln in text.splitlines() if ln.startswith('{"metric"')]
    for line in lines:
        d = dict(line["detail"])
        for bulky in ("accuracy_csv", "calibration", "stage_seconds", "fixture_sha256",
                      "output_sha256"):
            d.pop(bulky, None)
        # the seeding and chaining stages only: the rest are in the bench's JSON
        d["stage_seconds"] = {k: v for k, v in line["detail"].get("stage_seconds", {}).items()
                              if k in SEEDING_STAGES}
        log(f"   {line['metric']} = {line['value']} {line['unit']}, vs_baseline "
            f"{line['vs_baseline']}, correct {line['correct']}; {json.dumps(d)}")
    require_rc("8 bench", rc, 0, text)
    if [line["metric"] for line in lines] != BENCH_METRICS:
        raise AssertionError(f"8: the bench printed {[ln['metric'] for ln in lines]}")
    if not all(line["correct"] is True for line in lines):
        raise AssertionError("8: a bench line is not correct")
    # device seeding on planted repeat families and a 15,000-pair barcode
    reference = bench.load_reference()
    rates = {}
    for name in ("repeat", "calibration"):
        kind = bench.LINES[name][0]
        lib = bench.FIXTURES[kind](cache)
        reset_counts()
        run = bench.aligned("cuda", lib, reference[kind], seeding="1")
        launches = {k: fn.launches for k, fn in launchers().items()}
        best = run["best"]
        log(f"   {name} fixture device-seeded: {best['pairs']} pairs, "
            f"{best['pairs_per_s']:.1f} pairs/s, accuracy {best['accuracy']:.4f}, launches "
            f"{launches}, {fm_seed.overflow_redos} reads redone, peak device memory "
            f"{best['peak_device_bytes']} bytes, shards at the recorded digests: {run['correct']}")
        if not all(launches[k] > 0 for k in MAIN_LAUNCHERS + ("S1", "S3")):
            raise AssertionError(f"8 {name}: a kernel of the path never launched: {launches}")
        if fm_seed.overflow_redos:
            raise AssertionError(f"8 {name}: {fm_seed.overflow_redos} reads were redone")
        if not run["correct"]:
            raise AssertionError(f"8 {name}: the device-seeded shards are not the reference's")
        rates[name] = best["pairs_per_s"]
    return lines, rates


# 9a: the synthetic GRCh38-sized table split into this many shards, all on
# the card; 9b: phase 7's index split in two
SHARD_COUNTS = (2, 4)


@phase("9 sharded index")
def sharded_index(work, dev, scale):
    import torch

    from arachne_tpu_torch import cli, seeding_bench
    from arachne_tpu_torch.config import MemOptions, PipelineOptions
    from arachne_tpu_torch.device import cuda_ms, device_ms, graph_ms
    from arachne_tpu_torch.index import FMIndex, load_index
    from arachne_tpu_torch.measure import library_reads, quiet, same_shards
    from arachne_tpu_torch.ops import devicepool, fm_seed
    from arachne_tpu_torch.ops.fm_seed import pad_reads, pass3, seed_buffers, smem_pass
    from arachne_tpu_torch.parallel.mesh import ShardedFMTables

    rows = {}
    # 9a: the sharded kernels on the GRCh38-sized table, against the flat
    # ones and the plain versions
    big = seeding_bench.synthetic_table(dev)
    runs = {}
    for n in SHARD_COUNTS:
        r = runs[n] = seeding_bench.sharded_parity(big, [dev] * n)
        k5 = r["K5"]
        log(f"   9a, {n} shards of {r['per']} records: K5 at {k5['rows']} rows "
            f"{k5['graph_ms']:.4f} ms by a graph (flat {k5['flat_graph_ms']:.4f}), "
            f"{on_card(k5['device_ms'])} (flat {on_card(k5['flat_device_ms'])}), plain "
            f"{k5['plain_ms']:.1f} ms; " + "; ".join(
                f"{p} on {r[p]['reads']} reads {on_card(r[p]['device_ms'])} (flat "
                f"{on_card(r[p]['flat_device_ms'])}), graph {r[p]['graph_ms']:.4f} (flat "
                f"{r[p]['flat_graph_ms']:.4f}) ms" for p in ("S1 pass 1", "S1 pass 2", "S3"))
            + "; all equal to the flat kernels and the plain versions (tolerance 0)")
    del big
    torch.cuda.empty_cache()
    k5 = runs[SHARD_COUNTS[0]]["K5"]
    rows["K5 sharded"] = dict(err=0, ms=k5["ms"], device_ms=k5["device_ms"],
                              graph_ms=k5["graph_ms"], plain_ms=k5["plain_ms"],
                              rank_rows=k5["rows"], **bound(nbytes=k5["bytes"]))

    # 9b: phase 7b's library over two shards on the card, seeded there as
    # the card's default
    ref, r1, r2, n = scale["lib"]
    reset_counts()
    out = os.path.join(work, "out_sharded")
    with devicepool.pinned([dev, dev]), quiet(os.path.join(work, "sharded.log")):
        stats = cli.main(["align", "--engine", "cuda", "--index-mode", "sharded", "--sam", "-t",
                          "2", out, ref, r1, r2])
    launches = {k: fn.launches for k, fn in launchers().items()}
    log(f"   9b launches in the sharded device-seeded path: {launches}")
    if (not all(launches[k] > 0 for k in MAIN_LAUNCHERS + ("S1 sharded", "S3 sharded"))
            or launches["S1"] or launches["S3"]):
        raise AssertionError(f"9b: the path did not seed through the sharded kernels: {launches}")
    if fm_seed.overflow_redos:
        raise AssertionError(f"9b: {fm_seed.overflow_redos} reads were redone")
    rate = stats.reads / stats.elapsed
    same = same_shards(scale["device_out"], out)
    log(f"   9b: {stats.reads} pairs at {rate:.1f} pairs/s (7b device-seeded on the whole table "
        f"in this call: {scale['device_rate']:.1f}); 0 reads redone; shards byte-identical to "
        f"7b's device-seeded run: {same}")
    if stats.reads != n or not all(same.values()):
        raise AssertionError(f"9b: the sharded run's output differs from 7b's: {same}")
    # K5's sharded entry point through the sharded tables' host occ4
    idx = FMIndex(*load_index(ref + ".arx.npz"))
    tab = ShardedFMTables(idx, [dev, dev])
    ks = seeding_bench.parity_rows(tab, 4096).cpu().numpy().astype(np.int64)
    reset_counts()
    got = tab.occ4(ks)
    k5_launches = launchers()["K5 sharded"].launches
    if k5_launches <= 0 or not np.array_equal(got, idx.occ4(ks)):
        raise AssertionError(f"9b: ShardedFMTables.occ4 differs from the host index's "
                             f"({k5_launches} sharded K5 launches)")
    log(f"   9b: ShardedFMTables.occ4 on {len(ks)} rows equals idx.occ4 ({k5_launches} "
        "sharded K5 launch)")
    # S1 and S3 on one superbatch over the two shards, beside 7c's flat times
    reads = library_reads(r1, r2, PipelineOptions().reads_per_batch)
    qs, qlens = pad_reads(reads, dev)
    MAX = seed_buffers(qs.shape[1])
    run = seeding_kernels_on(tab, qs, qlens, MemOptions(), MAX, MAX, "two shards on the card")
    if any(run["flags"]):
        raise AssertionError("9b: reads overflowed the main path's buffers")
    s1, s1_pass2, s3 = ((lambda: smem_pass(tab, *run["p1"])), (lambda: smem_pass(tab, *run["p2"])),
                        (lambda: pass3(tab, *run["p3"])))
    for name, fn, i in (("S1", s1, 0), ("S1 pass 2", s1_pass2, 1), ("S3", s3, 2)):
        # the bound at the card's HBM peak, as K5's: 64 MB of records lie
        # beyond the L2
        t = dict(device_ms=device_ms(fn, 10), graph_ms=graph_ms(fn, 10),
                 rank_rows=run["rank_rows"][i],
                 **bound(nbytes=run["rank_rows"][i] * RANK_ROW_BYTES))
        flat = scale["seeding_kernels"][name]
        log(f"   9b {name} sharded: {on_card(t['device_ms'])} (graph {t['graph_ms']:.4f} ms), "
            f"{t['rank_rows']} occ4 rows, bound {t['bound_ms']:.4f} ms at the HBM peak; flat in 7c "
            f"{on_card(flat['device_ms'])} (graph {flat['graph_ms']:.4f} ms)")
        if name == "S1":
            rows["S1 sharded"] = dict(err=run["err"][0], ms=cuda_ms(s1, 10),
                                      plain_ms=run["plain_ms"][0], pass2_ms=cuda_ms(s1_pass2, 10),
                                      pass2_jobs=int(run["p2"][0].shape[0]), **t)
        elif name == "S1 pass 2":
            rows["S1 sharded"].update(pass2_device_ms=t["device_ms"])
        else:
            rows["S3 sharded"] = dict(err=run["err"][1], ms=cuda_ms(s3, 10),
                                      plain_ms=run["plain_ms"][2], **t)
    log_rows({k: rows[k] for k in ("K5 sharded", "S1 sharded", "S3 sharded")})
    return rows, {"K5 sharded": k5_launches, "S1 sharded": launches["S1 sharded"],
                  "S3 sharded": launches["S3 sharded"]}


KERNELS = [
    ("K1", "extend_cuda", "arachne_tpu_torch/ops/csrc/extend.cu",
     "arachne_tpu/ops/pallas_extend.py:51"),
    # the same kernel with int16 DP state (sdt=jnp.int16, wide_state=False);
    # its launches are phase 2's, the main path keeping int32 state
    ("K1 int16", "extend16_cuda", "arachne_tpu_torch/ops/csrc/extend.cu",
     "arachne_tpu/ops/pallas_extend.py:326"),
    ("K2", "local_cuda", "arachne_tpu_torch/ops/csrc/local.cu",
     "arachne_tpu/ops/pallas_local.py:27"),
    ("K3 score", "global_score_cuda", "arachne_tpu_torch/ops/csrc/global.cu",
     "arachne_tpu/ops/pallas_global.py:127"),
    ("K3 z", "global_z_cuda", "arachne_tpu_torch/ops/csrc/global.cu",
     "arachne_tpu/ops/pallas_global.py:134"),
    ("K4", "traceback_cuda", "arachne_tpu_torch/ops/csrc/global.cu",
     "arachne_tpu/ops/sw_global.py:149"),
    ("K5", "rank_cuda", "arachne_tpu_torch/ops/csrc/rank.cu",
     "arachne_tpu/ops/pallas_gather.py:47"),
    ("S1", "smem_pass_cuda", "arachne_tpu_torch/ops/csrc/seed.cu",
     "arachne_tpu/ops/fm_seed.py:44"),
    ("S3", "pass3_cuda", "arachne_tpu_torch/ops/csrc/seed.cu",
     "arachne_tpu/ops/fm_seed.py:322"),
    # the same kernels on a table split across cards, where the reference
    # runs its shard-aware occ4 (psum of each shard's rows) and its seeding
    # programs under shard_map
    ("K5 sharded", "rank_sharded_cuda", "arachne_tpu_torch/ops/csrc/rank.cu",
     "arachne_tpu/ops/fm_rank.py:88"),
    ("S1 sharded", "smem_pass_sharded_cuda", "arachne_tpu_torch/ops/csrc/seed.cu",
     "arachne_tpu/parallel/mesh.py:203"),
    ("S3 sharded", "pass3_sharded_cuda", "arachne_tpu_torch/ops/csrc/seed.cu",
     "arachne_tpu/parallel/mesh.py:217"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a GPU is required",
              file=sys.stderr)
        return 2
    # the kernels are built from this checkout's sources, never from a
    # copy of the package found elsewhere on the path
    if not os.path.isdir(os.path.join(ROOT, "arachne_tpu_torch", "ops", "csrc")):
        print(f"chip_smoke: no arachne_tpu_torch sources beside {__file__}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    # the result line reports one card; pick one with CUDA_VISIBLE_DEVICES
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} cards visible; it runs on one "
              "(set CUDA_VISIBLE_DEVICES)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    info, dev = probe_and_build()
    rows = kernel_parity(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "build"))
    try:
        lib = library(work)
        seed_rows, launches, seeding = seeding_parity(dev, lib, work)
        rows.update(seed_rows)
        _, host_out, host_stages, host_rate = host_seeded_path(work, dev, lib)
        byte_identity(work, lib[0])
        main_launches, _, main_rate = device_seeded_path(work, dev, lib, host_out, host_stages)
        launches.update(main_launches)
        seeding_in_turns(work, dev, lib, host_out)
        other_routes(work, dev, lib, host_out)
        work7 = os.path.join(work, "scale")
        os.makedirs(work7)
        scale = genome_scale(work7, dev, seed_rows,
                             {"host-seeded": host_rate, "device-seeded": main_rate})
        bench_phase(work, dev)
        sharded_rows, sharded_launches = sharded_index(work, dev, scale)
        rows.update(sharded_rows)
        launches.update(sharded_launches)
        launches["K1 int16"] = rows["K1 int16"].pop("launches")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("phases: " + ", ".join(f"{n} {s:.1f} s" for n, s in PHASES))
    kernel_rate = seeding["kernel_reads_per_s"]
    log(f"seeding on {seeding['reads']} reads: collect_seeds_device_flat (the main path's) "
        f"{seeding['flat_reads_per_s']:.0f} reads/s (device time of all its S1/S3 "
        f"launches alone: "
        f"{'not measured' if kernel_rate is None else f'{kernel_rate:.0f} reads/s'}), "
        f"collect_seeds_device (per-read lists) {seeding['device_reads_per_s']:.0f} reads/s, "
        f"native collector {seeding['native_reads_per_s']:.0f} reads/s")
    table = {
        "kernels": [
            dict(
                {"name": f"{key} {fn}", "route": "cuda", "source": src, "replaces": rep,
                 "launches": launches[key], "max_abs_err": rows[key]["err"],
                 "ms": rows[key]["ms"], "plain_ms": rows[key]["plain_ms"],
                 "bound_ms": rows[key]["bound_ms"], "bound_by": rows[key]["bound_by"],
                 "library_ms": None},
                **{k: v for k, v in rows[key].items()
                   if k.endswith("rank_qps") or k.startswith("pass2_")
                   or k in ("cells", "rank_rows", "steps", "device_ms", "graph_ms",
                            "launches_in")},
            )
            for key, fn, src, rep in KERNELS
        ]
    }
    print(json.dumps(table))
    print(info["nvidia_smi"])
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
