"""Rank-query and seeding throughput of the port on one GPU.

    python -m arachne_tpu_torch.seeding_bench [--index REF.fa.arx.npz] [--reads 4096] \\
        [--wide-blocks 48400000] [--out seeding.json]

The port of scripts/seeding_microbench.py and the entry point of kernel K5.
On the given index (by default a 2 Mbp random genome, indexed in a
temporary directory) and on a synthetic table of GRCh38's size (48.4 M
64-byte records of a wide int64 table, about 3.1 GB of random words and
counts from a seeded generator on the card: seeding's rank gathers land
in a table of that size, not in the 50 MB L2), it

  * holds K5 to its plain version on 2048 rows, edge rows included
    (integers: tolerance 0);
  * times K5 and the plain version at B = 2^14, 2^17 and 2^20 uniformly
    random rows, with CUDA events, K5 also by CUDA events around a CUDA
    graph of its launches, and as device time from torch.profiler, in rank
    queries/s, beside the bytes the batch must move (``rank_bytes``);
  * on the index only: times seed collection on the same reads (150 bp
    from the genome, with a few substitutions) through
    ``collect_seeds_device_flat`` (kernels S1 and S3 and their bulk host
    glue: the main path's form) and ``collect_seeds_device`` (the same as
    per-read SMEM lists) against the host C++ collector
    ``collect_seeds_native``, in reads/s, and splits the device time of
    one flat call into S1 (pass 1, and pass 2 with every job in one
    launch), S3 and copies; the seeds must be identical read for read.

With ``--sharded-cards N`` it does something else: the synthetic table
split across the first N visible cards (seeded from card 0, each record
read from the card that holds it) and split into N ranges on card 0 alone,
each held to the flat kernels and the plain versions and timed beside them
(``sharded_parity``).

The reference's tunnel slope timing and its while-loop latency section are
not ported: they answered a question about the TPU.  The result is one
JSON object, written to ``--out`` and summarised on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import device
from .config import MemOptions
from .device import cuda_ms, device_ms, graph_ms, probe, resolve_device
from .ops.cuda_seed import pass3_cuda, pass3_sharded_cuda, smem_pass_cuda, smem_pass_sharded_cuda
from .ops.fm_rank import DeviceFMIndex, ShardedFMIndex, occ4_device, occ4_torch
from .ops.fm_seed import collect_seeds_device, collect_seeds_device_flat

# GRCh38 forward + reverse, ~6.2e9 rows, in blocks of 128
GRCH38_BLOCKS = 48_400_000
BATCHES = (1 << 14, 1 << 17, 1 << 20)


def synthetic_table(device, n_blocks: int = GRCH38_BLOCKS, seed: int = 0) -> DeviceFMIndex:
    """A wide (int64) record table of ``n_blocks`` blocks filled with
    random counts and words from a seeded generator on ``device``, in
    place: no planar copy, so the peak is the one table.  Ranks over it are
    meaningless but exactly defined, so K5 and its plain version must still
    agree."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    seq_len = n_blocks * 128
    table = torch.empty((n_blocks + 1, 8), dtype=torch.int64, device=device)
    table[:, 0:4].random_(0, seq_len, generator=g)
    table[:, 4:8].view(torch.int32).random_(-(1 << 31), 1 << 31, generator=g)
    table[-1, 4:8] = 0   # no block past the end
    L2 = torch.tensor([0, seq_len // 4, seq_len // 2, 3 * seq_len // 4, seq_len],
                      dtype=torch.int64, device=device)
    return DeviceFMIndex(table=table, L2=L2, primary=seq_len // 3, seq_len=seq_len,
                         l_pac=seq_len // 2)


def random_seeding_args(dev, n_reads: int, seed: int):
    """The arguments after the table of S1 pass 1, S1 pass 2 (one sweep
    from a random pivot with a random min_intv) and S3 on ``n_reads``
    random reads of 150 bases, with the main path's buffers, on ``dev``."""
    from .ops.fm_seed import pad_reads, seed_buffers

    opt = MemOptions()
    rng = np.random.default_rng(seed)
    qs, qlens = pad_reads([rng.integers(0, 4, 150).astype(np.uint8) for _ in range(n_reads)], dev)
    R, L = qs.shape
    MAX = seed_buffers(L)
    piv = torch.from_numpy(rng.integers(0, 150, R).astype(np.int32)).to(dev)
    minis = torch.from_numpy(rng.integers(1, 20, R).astype(np.int32)).to(dev)
    zeros = torch.zeros(R, dtype=torch.int32, device=dev)
    return {"S1 pass 1": (qs, qlens, zeros, zeros + 1, False, MAX, MAX),
            "S1 pass 2": (qs, qlens, piv, minis, True, MAX, MAX),
            "S3": (qs, qlens, opt.min_seed_len, opt.max_mem_intv, MAX)}


def _seed_fns(name: str):
    """(wrapper, plain version) of the seeding pass ``name``."""
    from .ops.fm_seed import pass3, pass3_torch, smem_pass, smem_pass_torch

    return (pass3, pass3_torch) if name == "S3" else (smem_pass, smem_pass_torch)


def _require_same(name: str, got, want, what: str) -> None:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not torch.equal(g.to(w.device), w):
            raise AssertionError(f"{name} differs from {what}")


def wide_seeding_parity(fm: DeviceFMIndex, n_reads: int, seed: int = 17) -> int:
    """S1 pass 1, S1 pass 2 and S3 (``random_seeding_args``) against their
    plain versions on a table of at least 2^31 rows (``synthetic_table``):
    the table is no index of the reads, but the state machines' contract
    holds on any table, and their intervals' rows reach past 2^31.  Raises
    unless out, out_n and the overflow flags are equal and some k, l or s
    written is at least 2^31; returns how many are."""
    if fm.seq_len < (1 << 31):
        raise ValueError(f"a table of {fm.seq_len} rows has no row at 2^31")
    dev = fm.device
    past = 0
    for name, args in random_seeding_args(dev, n_reads, seed).items():
        kernel, plain = _seed_fns(name)
        got = kernel(fm, *args)
        _require_same(name, got, plain(fm, *args), "its plain version on the wide table")
        MAX = args[-1]
        out, out_n, _ = got
        filled = torch.arange(MAX, device=dev)[None, :] < out_n[:, None]
        past += int((out[:, :, :3][filled] >= (1 << 31)).sum())
    if not past:
        raise AssertionError("no k, l or s written reached 2^31")
    return past


def sharded_parity(flat: DeviceFMIndex, devices, n_queries: int = 1 << 20,
                   n_reads: int = 1024, seed: int = 19) -> dict:
    """K5, S1 (pass 1, and pass 2 as ``random_seeding_args`` gives it: on
    random reads over a random table pass 1 leaves no pass-2 job) and S3
    on ``flat``'s table split across ``devices`` (fm_rank.ShardedFMIndex,
    seeded from flat's device, which holds the queries) against the flat
    kernels and the plain versions on the sharded table, on the same
    inputs: ``parity_rows`` of n_queries (edge rows included) and n_reads
    random reads.  Raises unless all are equal (integers: tolerance 0).
    Returns each kernel's time, sharded beside flat: K5 by CUDA events
    around 20 wrapper calls (``ms``), a CUDA graph of 20 launches and the
    profiler; S1 and S3 by the profiler and a graph of 10; the plain
    versions' ms (their one comparison run, by CUDA events)."""
    from .device import timed_ms

    dev = flat.device
    sharded = ShardedFMIndex(flat, devices, device=dev)
    res = {"shards": len(devices), "devices": [str(d) for d in devices], "per": sharded.per}
    ks = parity_rows(flat, n_queries)
    got, want = occ4_device(sharded, ks), occ4_device(flat, ks)
    _require_same("K5 sharded", got, want, "the flat kernel")
    plain, plain_ms = timed_ms(lambda: occ4_torch(sharded, ks))
    _require_same("K5 sharded", got, plain, "its plain version")
    k5 = {"rows": n_queries, "bytes": rank_bytes(flat, n_queries), "plain_ms": plain_ms}
    for tag, fm in (("", sharded), ("flat_", flat)):
        fn = (lambda f=fm: occ4_device(f, ks))
        k5.update({f"{tag}ms": cuda_ms(fn, 20), f"{tag}graph_ms": graph_ms(fn, 20),
                   f"{tag}device_ms": device_ms(fn, 10)})
    res["K5"] = k5
    for name, args in random_seeding_args(dev, n_reads, seed).items():
        kernel, plain_fn = _seed_fns(name)
        got = kernel(sharded, *args)
        _require_same(f"{name} sharded", got, kernel(flat, *args), "the flat kernel")
        want, plain_ms = timed_ms(lambda: plain_fn(sharded, *args))
        _require_same(f"{name} sharded", got, want, "its plain version")
        row = {"reads": n_reads, "plain_ms": plain_ms}
        for tag, fm in (("", sharded), ("flat_", flat)):
            fn = (lambda f=fm: kernel(f, *args))
            row.update({f"{tag}device_ms": device_ms(fn, 10), f"{tag}graph_ms": graph_ms(fn, 10)})
        res[name] = row
    return res


def parity_rows(fm: DeviceFMIndex, n: int = 2048, seed: int = 1) -> torch.Tensor:
    """n rows on fm's device: the edge rows (-1, 0, seq_len, and around
    the primary row and the end), the rest uniform in [-1, seq_len]."""
    S, P = fm.seq_len, fm.primary
    edges = [-1, 0, 1, P - 1, P, P + 1, S - 1, S]
    rng = np.random.default_rng(seed)
    ks = np.concatenate([edges, rng.integers(-1, S + 1, n - len(edges))])
    return torch.from_numpy(ks).to(fm.device, fm.idt)


def rank_parity(fm: DeviceFMIndex, n: int = 2048) -> int:
    """K5 against its plain version on ``parity_rows``; raises unless
    exactly equal, returns the max abs error (0)."""
    ks = parity_rows(fm, n)
    got, want = occ4_device(fm, ks), occ4_torch(fm, ks)
    err = int((got - want).abs().max().item())
    if err or got.dtype != want.dtype:
        raise AssertionError(f"K5 differs from its plain version (max abs err {err})")
    return err


def rank_bytes(fm: DeviceFMIndex, B: int) -> int:
    """The bytes K5 must move for B queries: each query's row read, the
    checkpoint counts and the 32 bytes of words of its block gathered, and
    its four counts written (104 bytes a query for int64 tables, 68 for
    int32; the int32 record's 16 bytes of padding are not needed)."""
    size = fm.table.element_size()
    return B * (size + 4 * size + 32 + 4 * size)


def time_rank(fm: DeviceFMIndex, B: int, seed: int = 2) -> Dict[str, float]:
    """K5 and its plain version on B uniform rows: CUDA events around 20
    calls (3 for the plain version), CUDA events around the replay of a
    CUDA graph of 20 launches (no host work between them), and the device
    time alone from torch.profiler (the first also counts the host's launch
    gaps, which bound small batches)."""
    g = torch.Generator(device=fm.device)
    g.manual_seed(seed)
    ks = torch.randint(0, fm.seq_len, (B,), dtype=fm.idt, device=fm.device, generator=g)
    kernel, plain = (lambda: occ4_device(fm, ks)), (lambda: occ4_torch(fm, ks))
    ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
    dev_ms, plain_dev_ms = device_ms(kernel, 20), device_ms(plain, 3)
    return {"B": B, "ms": ms, "plain_ms": plain_ms, "graph_ms": graph_ms(kernel, 20),
            "bytes": rank_bytes(fm, B),
            "rank_qps": B / ms * 1e3, "plain_rank_qps": B / plain_ms * 1e3,
            "device_ms": dev_ms, "plain_device_ms": plain_dev_ms,
            "device_rank_qps": B / dev_ms * 1e3 if dev_ms else None}


def sample_reads(fwd: np.ndarray, n: int, length: int = 150, seed: int = 3) -> List[np.ndarray]:
    """n reads of ``length`` codes from either strand of ``fwd``, each with
    0-3 substitutions."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        pos = int(rng.integers(0, len(fwd) - length))
        r = fwd[pos : pos + length].copy()
        at = rng.integers(0, length, int(rng.integers(0, 4)))
        r[at] = (r[at] + 1) % 4
        reads.append((3 - r[::-1]).astype(np.uint8) if rng.integers(0, 2) else r)
    return reads


def _s1_s3_launches():
    """S1's and S3's launches so far, on flat and sharded tables alike."""
    return (smem_pass_cuda.launches + smem_pass_sharded_cuda.launches,
            pass3_cuda.launches + pass3_sharded_cuda.launches)


def device_parts_ms(fn) -> Optional[Dict[str, float]]:
    """Device milliseconds of one call of ``fn`` from torch.profiler, split
    into S1 (every pass-1 and pass-2 launch), S3, copies and other device
    work (the fills of fresh buffers); None if no profiler run was whole.
    As in ``device.device_ms``, a warm call comes first in a step of its
    own, and a run whose S1 and S3 records are not as many as the call's
    launches (``_s1_s3_launches``) lost
    some and would read low: it is thrown away (counted in
    ``device.lost_profiles``) and made again, up to ``device.PROFILE_TRIES``
    runs in all."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(device.PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            s1_before, s3_before = _s1_s3_launches()
            fn()
            torch.cuda.synchronize()
            prof.step()
        s1_after, s3_after = _s1_s3_launches()
        want = {"s1": s1_after - s1_before, "s3": s3_after - s3_before}
        parts = {"s1": 0.0, "s3": 0.0, "copies": 0.0, "other": 0.0}
        seen = {"s1": 0, "s3": 0}
        for e in prof.key_averages():
            key = ("s1" if "smem_pass_kernel" in e.key else "s3" if "pass3_kernel" in e.key
                   else "copies" if "Memcpy" in e.key else "other")
            parts[key] += e.self_device_time_total / 1e3
            if key in seen:
                seen[key] += e.count
        if seen == want:
            return parts
        device.lost_profiles += 1
    return None


def ms_text(ms: Optional[float]) -> str:
    """A device time for the log: None (no whole profiler run) is "not
    measured"."""
    return "not measured" if ms is None else f"{ms:.3f} ms"


def seeding_rates(idx, fm: DeviceFMIndex, reads: List[np.ndarray], opt) -> Dict[str, float]:
    """Seed collection on the card, as the flat SeedBatch the main path
    chains (``collect_seeds_device_flat``) and as per-read SMEM lists
    (``collect_seeds_device``), against the host C++ collector on the same
    reads; raises unless their seeds are identical.  The device time of
    one flat call covers every launch it makes (pass 1, pass 2, pass 3)
    and its copies."""
    from .align.smem_native import collect_seeds_native, smem_available

    if not smem_available():
        raise RuntimeError("the native host collector did not load: nothing to compare with")
    collect_seeds_device(reads[:64], opt, fm)   # warm
    s1_before, s3_before = smem_pass_cuda.launches, pass3_cuda.launches
    t0 = time.perf_counter()
    flat = collect_seeds_device_flat(reads, opt, fm)
    t_flat = time.perf_counter() - t0
    s1_launches = smem_pass_cuda.launches - s1_before
    s3_launches = pass3_cuda.launches - s3_before
    t0 = time.perf_counter()
    dev_seeds = collect_seeds_device(reads, opt, fm)
    t_dev = time.perf_counter() - t0
    parts = device_parts_ms(lambda: collect_seeds_device_flat(reads, opt, fm)) or {}
    t0 = time.perf_counter()
    host_seeds = collect_seeds_native(idx, reads, opt)
    t_host = time.perf_counter() - t0
    for name, seeds in (("flat", flat.to_lists()), ("list", dev_seeds)):
        bad = [i for i, (a, b) in enumerate(zip(seeds, host_seeds)) if a != b]
        if bad:
            raise AssertionError(f"device seeds ({name}) differ from the native collector's: "
                                 f"reads {bad[:10]}")
    n = len(reads)
    kernel_ms = parts["s1"] + parts["s3"] if parts else None
    return {"reads": n, "s1_launches": s1_launches, "s3_launches": s3_launches,
            "s1_device_ms": parts.get("s1"), "s3_device_ms": parts.get("s3"),
            "copy_device_ms": parts.get("copies"), "other_device_ms": parts.get("other"),
            "kernel_reads_per_s": n / kernel_ms * 1e3 if kernel_ms else None,
            "flat_s": t_flat, "flat_reads_per_s": n / t_flat,
            "device_s": t_dev, "device_reads_per_s": n / t_dev,
            "native_s": t_host, "native_reads_per_s": n / t_host}


def table_result(name: str, fm: DeviceFMIndex) -> dict:
    """K5's parity and timings on one table, printed as they come."""
    row = {"seq_len": fm.seq_len, "wide": fm.idt == torch.int64,
           "bytes": fm.table.numel() * fm.table.element_size(),
           "max_abs_err": rank_parity(fm), "batches": []}
    for B in BATCHES:
        b = time_rank(fm, B)
        row["batches"].append(b)
        print(f"{name:>13} B={B:>8}: K5 {b['ms']:.4f} ms ({b['rank_qps'] / 1e6:.1f} M "
              f"rank queries/s), graph {b['graph_ms']:.4f} ms, device time "
              f"{b['device_ms']} ms; plain "
              f"{b['plain_ms']:.4f} ms ({b['plain_rank_qps'] / 1e6:.1f} M/s), device time "
              f"{b['plain_device_ms']} ms", flush=True)
    return row


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m arachne_tpu_torch.seeding_bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--index", help="an .arx.npz index (default: a 2 Mbp random genome)")
    ap.add_argument("--reads", type=int, default=4096)
    ap.add_argument("--wide-blocks", type=int, default=GRCH38_BLOCKS,
                    help="blocks of the synthetic wide table (0: skip it)")
    ap.add_argument("--sharded-cards", type=int, default=0,
                    help="only hold and time K5, S1 and S3 on the synthetic wide table split "
                    "across the first N visible cards and into N ranges on card 0")
    ap.add_argument("--out", help="write the JSON result here")
    args = ap.parse_args(argv)
    if args.sharded_cards:
        return sharded_main(args)

    from .index import FMIndex, build_index_files, load_index, unpack_2bit

    from .measure import write_genome

    dev = resolve_device("cuda")
    res = {"probe": probe(), "args": vars(args)}
    work = None
    try:
        if args.index is None:
            work = tempfile.mkdtemp(prefix="seeding_bench_")
            ref = os.path.join(work, "ref.fa")
            write_genome(ref, 2_000_000)
            args.index = build_index_files(ref)
        idx = FMIndex(*load_index(args.index))
    finally:
        if work is not None:
            shutil.rmtree(work, ignore_errors=True)
    fm = DeviceFMIndex.from_host(idx, dev)
    res["tables"] = {"index": table_result("index", fm)}
    if args.wide_blocks:
        res["tables"]["grch38_sized"] = table_result(
            "grch38_sized", synthetic_table(dev, args.wide_blocks))
    packed = idx.packed
    reads = sample_reads(unpack_2bit(packed.pac, 0, packed.l_pac), args.reads)
    res["seeding"] = seeding_rates(idx, fm, reads, MemOptions())
    s = res["seeding"]
    print(f"seeding {s['reads']} reads: collect_seeds_device_flat {s['flat_reads_per_s']:.0f} "
          f"reads/s, collect_seeds_device (lists) {s['device_reads_per_s']:.0f} reads/s, "
          f"native {s['native_reads_per_s']:.0f} reads/s, seeds identical; device "
          f"time of one call: S1 {ms_text(s['s1_device_ms'])} ({s['s1_launches']} launches) + "
          f"S3 {ms_text(s['s3_device_ms'])} ({s['s3_launches']}), copies "
          f"{ms_text(s['copy_device_ms'])}, other {ms_text(s['other_device_ms'])}", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return res


def sharded_main(args) -> dict:
    n = args.sharded_cards
    if torch.cuda.device_count() < n:
        raise SystemExit(f"--sharded-cards {n}: {torch.cuda.device_count()} cards visible")
    dev = torch.device("cuda", 0)
    res = {"probe": probe(), "args": vars(args), "runs": {}}
    big = synthetic_table(dev, args.wide_blocks)
    cards = [torch.device("cuda", i) for i in range(n)]
    for name, devices in (("one card", [dev] * n), ("across cards", cards)):
        r = sharded_parity(big, devices)
        res["runs"][name] = r
        k5 = r["K5"]
        print(f"{name}, {n} shards: K5 at {k5['rows']} rows {k5['graph_ms']:.4f} ms by a graph "
              f"(flat {k5['flat_graph_ms']:.4f}), device time {k5['device_ms']} (flat "
              f"{k5['flat_device_ms']}) ms; " + "; ".join(
                  f"{p} device time {ms_text(r[p]['device_ms'])} (flat "
                  f"{ms_text(r[p]['flat_device_ms'])}), graph {r[p]['graph_ms']:.4f} (flat "
                  f"{r[p]['flat_graph_ms']:.4f}) ms" for p in ("S1 pass 1", "S1 pass 2", "S3"))
              + "; all equal to the flat kernels and the plain versions", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return res


if __name__ == "__main__":
    main()
