"""Drive the port's wide (int64) device rank path on a real index of at
least 2^31 rows, past 2^32 where the index reaches it.

    python -m arachne_tpu_torch.scripts.wide_device_check GENOME.fa.arx.npz [--out check.json]

The twin of scripts/wide_device_check.py.  Build the index with
``python -m arachne_tpu_torch.scripts.make_scale_genome`` (its defaults
give 2.4e9 rows) and ``python -m arachne_tpu_torch.cli index``.  The
script refuses an index below 2^31 rows: there is nothing wide to check.
It uploads the tables through ``ops/engine.device_tables`` to the card and

  * holds K5 (``occ4_device``) to the host index's ``occ4`` on 2048 rows
    over the whole range, 2048 rows at or above 2^31, on an index of more
    than 2^32 rows (GRCh38's size) 2048 more at or above 2^32, and the edge
    rows -1, 0, seq_len, primary, 2^31 - 1, 2^31, 2^32 - 1 and 2^32 that
    lie in the index;
  * holds ``collect_seeds_device`` (kernels S1 and S3) to the native host
    collector, read for read, on one superbatch of 8192 reads of 120 bases
    sampled from the genome with two substitutions each, and counts the
    seeds whose interval rows lie at or above 2^31 and 2^32;
  * reports the device time of S1 and S3 in that superbatch
    (torch.profiler) and the wide rank queries/s at 2^16 and 2^20 uniform
    rows (CUDA events around a CUDA graph of the launches).

Integers throughout: tolerance 0.  ``check`` takes the index and its device
tables, so that the same checks run on a small index with tables forced
wide.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

WIDE_ROWS = 1 << 31
# rows past 32 bits: an index of GRCh38's size (6.2e9 rows) reaches them
ROWS_2_32 = 1 << 32
# read pairs per superbatch (PipelineOptions.reads_per_batch) times two
SUPERBATCH_READS = 8192
RATE_BATCHES = (1 << 16, 1 << 20)


def rank_rows(seq_len: int, primary: int, n: int = 2048, seed: int = 5) -> np.ndarray:
    """n uniform rows of [0, seq_len), n more from 2^31 up (from seq_len /
    2 up on an index below 2^31 rows), n more from 2^32 up on an index of
    more than 2^32 rows, then the edge rows that are rows of the index: -1,
    0, seq_len, primary, 2^31 - 1, 2^31, 2^32 - 1 and 2^32."""
    rng = np.random.default_rng(seed)
    edges = [k for k in (-1, 0, seq_len, primary, WIDE_ROWS - 1, WIDE_ROWS, ROWS_2_32 - 1,
                         ROWS_2_32) if k <= seq_len]
    upper = WIDE_ROWS if seq_len > WIDE_ROWS else seq_len // 2
    past_2_32 = [rng.integers(ROWS_2_32, seq_len, n)] if seq_len > ROWS_2_32 else []
    return np.concatenate([
        rng.integers(0, seq_len, n),
        rng.integers(upper, seq_len, n),
        *past_2_32,
        edges,
    ]).astype(np.int64)


def sample_reads(idx, n: int, length: int = 120, seed: int = 6):
    """n reads of ``length`` bases from the forward strand of the packed
    reference, each with two substitutions."""
    from ..index import unpack_2bit

    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        pos = int(rng.integers(0, idx.l_pac - length))
        r = unpack_2bit(idx.packed.pac, pos, pos + length).copy()
        at = rng.integers(0, length, 2)
        r[at] = (r[at] + 1) % 4
        reads.append(r)
    return reads


def check(idx, dfm, n_reads: int = SUPERBATCH_READS) -> dict:
    """K5 against the host index's occ4 on ``rank_rows``, then
    ``collect_seeds_device`` against the native collector on
    ``sample_reads``; raises unless both are exactly equal."""
    from ..align.smem_native import collect_seeds_native, smem_available
    from ..config import MemOptions
    from ..ops.fm_rank import occ4_device
    from ..ops.fm_seed import collect_seeds_device

    ks = rank_rows(idx.seq_len, idx.primary)
    got = occ4_device(dfm, torch.from_numpy(ks).to(dfm.device, dfm.idt)).cpu().numpy()
    want = idx.occ4(ks)
    if not np.array_equal(got, want):
        bad = np.flatnonzero((got != want).any(axis=1))
        raise AssertionError(f"K5 differs from the host occ4 at rows {ks[bad[:10]].tolist()}")
    if not smem_available():
        raise RuntimeError("the native host collector did not load: nothing to compare with")
    opt = MemOptions()
    reads = sample_reads(idx, n_reads)
    t0 = time.perf_counter()
    dev_seeds = collect_seeds_device(reads, opt, dfm)
    t_dev = time.perf_counter() - t0
    host_seeds = collect_seeds_native(idx, reads, opt)
    bad = [r for r, (a, b) in enumerate(zip(dev_seeds, host_seeds)) if a != b]
    if bad or len(dev_seeds) != len(host_seeds):
        raise AssertionError(f"device seeds differ from the native collector's: reads {bad[:10]}")
    rows = [max(m.k, m.l) for mems in dev_seeds for m in mems]
    return {"rank_rows": len(ks), "rank_rows_wide": int((ks >= WIDE_ROWS).sum()),
            "rank_rows_past_2_32": int((ks >= ROWS_2_32).sum()),
            "reads": len(reads), "seeds": len(rows),
            "seeds_past_2_31": sum(r >= WIDE_ROWS for r in rows),
            "seeds_past_2_32": sum(r >= ROWS_2_32 for r in rows),
            "collect_seeds_device_s": t_dev}


def rank_rates(dfm) -> dict:
    """Wide rank queries/s of K5 at each of RATE_BATCHES uniform rows, by
    ``device.graph_ms`` (a CUDA graph of 20 launches)."""
    from ..device import graph_ms
    from ..ops.fm_rank import occ4_device

    out = {}
    for B in RATE_BATCHES:
        g = torch.Generator(device=dfm.device)
        g.manual_seed(B)
        ks = torch.randint(0, dfm.seq_len, (B,), dtype=dfm.idt, device=dfm.device, generator=g)
        ms = graph_ms(lambda: occ4_device(dfm, ks), 20)
        out[str(B)] = {"graph_ms": ms, "rank_qps": B / ms * 1e3}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m arachne_tpu_torch.scripts.wide_device_check",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("index", help="an .arx.npz index of at least 2^31 rows")
    ap.add_argument("--out", help="write the JSON result here")
    args = ap.parse_args(argv)

    from ..config import MemOptions
    from ..device import probe, resolve_device
    from ..index import FMIndex, load_index
    from ..ops.engine import device_tables
    from ..ops.fm_rank import DeviceFMIndex
    from ..ops.fm_seed import collect_seeds_device
    from ..seeding_bench import device_parts_ms

    t0 = time.perf_counter()
    idx = FMIndex(*load_index(args.index))
    load_s = time.perf_counter() - t0
    print(f"index loaded in {load_s:.1f} s: seq_len {idx.seq_len:,} (2^31 = {WIDE_ROWS:,})",
          flush=True)
    if idx.seq_len < WIDE_ROWS:
        sys.exit(f"wide_device_check: {args.index} has {idx.seq_len} rows, below 2^31: "
                 "its tables are not wide, nothing to check")
    dev = resolve_device("cuda")
    res = {"probe": probe(), "index": args.index, "seq_len": idx.seq_len, "load_s": load_s}
    t0 = time.perf_counter()
    dfm = device_tables(idx, dev)
    torch.cuda.synchronize(dev)
    res["upload_s"] = time.perf_counter() - t0
    if dfm.idt != torch.int64:
        raise AssertionError(f"tables of {idx.seq_len} rows uploaded as {dfm.idt}")
    res["table_bytes"] = DeviceFMIndex.table_bytes(idx)
    print(f"device tables uploaded in {res['upload_s']:.1f} s: {res['table_bytes']} bytes "
          f"of int64 records", flush=True)
    res.update(check(idx, dfm))
    print(f"K5 equals the host occ4 on {res['rank_rows']} rows ({res['rank_rows_wide']} at or "
          f"above 2^31, {res['rank_rows_past_2_32']} at or above 2^32); collect_seeds_device "
          f"equals the native collector on {res['reads']} reads ({res['seeds']} seeds, "
          f"{res['seeds_past_2_31']} with rows at or above 2^31, {res['seeds_past_2_32']} at "
          f"or above 2^32) in {res['collect_seeds_device_s']:.2f} s", flush=True)
    reads = sample_reads(idx, SUPERBATCH_READS)
    res["superbatch_device_ms"] = device_parts_ms(
        lambda: collect_seeds_device(reads, MemOptions(), dfm))
    parts = res["superbatch_device_ms"]
    print(f"device time of one superbatch ({SUPERBATCH_READS} reads): "
          + (f"{json.dumps(parts)} ms" if parts else "not measured (no whole profiler run)"),
          flush=True)
    res["rank_rates"] = rank_rates(dfm)
    for B, r in res["rank_rates"].items():
        print(f"wide K5 at {B} rows: {r['graph_ms']:.4f} ms by a CUDA graph, "
              f"{r['rank_qps'] / 1e9:.2f} G rank queries/s", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
    return res


if __name__ == "__main__":
    main()
