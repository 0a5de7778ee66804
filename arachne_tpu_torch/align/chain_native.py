# Copy of arachne_tpu/align/chain_native.py, the JAX package's host code,
# but for one split: the body of mem_chain_batch_native after _flatten_mems
# is mem_chain_flat_native, which either seeder's flat seed arrays enter
# directly (ops/batch.py, as an ops/fm_seed.py SeedBatch); the output is
# the reference's.
"""Native (C++) seed chaining driver.

Wraps native/chain.cpp's `chain_batch`: mem_chain + mem_chain_flt
(bwamem.c:251-385 semantics) run in C++ over flat per-occurrence arrays,
one call per superbatch, with the GIL released.  The Python sorted-list
merge loop in align/chain.py was the single largest host stage (31% of
end-to-end wall time in BENCH_r02).

The SA walks and contig-interval checks for every seed occurrence are
still batched numpy (one `idx.sa` + one `idx.intv2rid` across the whole
superbatch), as is the occurrence expansion (the reference's max_occ
stride-sampling, bwamem.c:278-287) — those vectorize cleanly; only the
order-dependent merge/filter state machine needs C++.

Output: per read, the kept chains in mem_chain_flt's final order with the
mem_chain2aln extension window (rseq, rmax0) pre-fetched via one batched
`fetch_seq_batch` call, so neither the problem-builder nor the replay
fetches windows again.  Exact parity with the Python path is covered by
tests/test_align.py::test_chain_native_parity.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..config import MemOptions
from ..index.fmindex import FMIndex
from ..native import chain_available, native_threads, require_lib
from ..runtime.timers import TIMERS
from .chain import Chain, Seed

_i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
_i64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
_f64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _flatten_mems(all_mems) -> Tuple[np.ndarray, ...]:
    """List[List[SMEM]] -> flat (k, s, qb, qe) arrays + per-read offsets."""
    counts = np.fromiter((len(m) for m in all_mems), np.int64, len(all_mems))
    total = int(counts.sum())
    k = np.empty(total, np.int64)
    s = np.empty(total, np.int64)
    qb = np.empty(total, np.int32)
    qe = np.empty(total, np.int32)
    i = 0
    for mems in all_mems:
        for m in mems:
            k[i] = m.k
            s[i] = m.s
            qb[i] = m.qb
            qe[i] = m.qe
            i += 1
    off = np.zeros(len(all_mems) + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    return k, s, qb, qe, off


def expand_occurrences(k, s, qb, qe, max_occ: int):
    """Vectorized _occ_rows (bwamem.c:282-287): stride-sample every SMEM's
    SA rows down to max_occ occurrences.  Returns (rows, seg_id) where
    seg_id maps each occurrence back to its SMEM."""
    step = np.where(s > max_occ, s // max_occ, 1)
    n_occ = np.minimum((s + step - 1) // step, max_occ)
    total = int(n_occ.sum())
    seg_id = np.repeat(np.arange(len(s), dtype=np.int64), n_occ)
    starts = np.cumsum(n_occ) - n_occ
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, n_occ)
    rows = k[seg_id] + within * step[seg_id]
    return rows, seg_id, n_occ


def mem_chain_batch_native(
    idx: FMIndex,
    reads: List[np.ndarray],
    opt: MemOptions,
    all_mems,
    n_threads: Optional[int] = None,
) -> Optional[List[List[Chain]]]:
    """mem_chain + mem_chain_flt over many reads in native code; returns
    kept chains (with pre-fetched extension windows) or None when the
    native library is unavailable."""
    if not chain_available():
        return None
    return mem_chain_flat_native(idx, reads, opt, *_flatten_mems(all_mems), n_threads=n_threads)


def mem_chain_flat_native(
    idx: FMIndex,
    reads: List[np.ndarray],
    opt: MemOptions,
    mem_k: np.ndarray,
    mem_s: np.ndarray,
    mem_qb: np.ndarray,
    mem_qe: np.ndarray,
    mem_off: np.ndarray,
    n_threads: Optional[int] = None,
) -> List[List[Chain]]:
    """mem_chain_batch_native on SMEMs given as flat arrays: k, s int64,
    qb, qe int32 and per-read offsets (n + 1,) int64, read r's SMEMs at
    mem_off[r]:mem_off[r + 1] in its collector's order.  Raises without
    the native library."""
    if n_threads is None:
        n_threads = native_threads()
    lib = require_lib()
    n_reads = len(reads)
    if n_reads == 0:
        return []
    mem_k = np.ascontiguousarray(mem_k, np.int64)
    mem_s = np.ascontiguousarray(mem_s, np.int64)
    mem_qb = np.ascontiguousarray(mem_qb, np.int32)
    mem_qe = np.ascontiguousarray(mem_qe, np.int32)
    mem_off = np.ascontiguousarray(mem_off, np.int64)
    rows, seg_id, _ = expand_occurrences(mem_k, mem_s, mem_qb, mem_qe, opt.max_occ)
    TIMERS.add_to("superbatch", seeds=len(rows))
    occ_qbeg = mem_qb[seg_id].astype(np.int32)
    occ_len = (mem_qe[seg_id] - mem_qb[seg_id]).astype(np.int32)
    if len(rows):
        occ_rbeg = idx.sa(rows)
        occ_rid = idx.intv2rid(occ_rbeg, occ_rbeg + occ_len)
    else:
        occ_rbeg = occ_rid = np.empty(0, np.int64)
    # per-read occurrence offsets: occurrences inherit their SMEM's read
    occ_per_mem = np.zeros(len(mem_k), np.int64)
    if len(seg_id):
        np.add.at(occ_per_mem, seg_id, 1)
    occ_cum = np.zeros(len(mem_k) + 1, np.int64)
    np.cumsum(occ_per_mem, out=occ_cum[1:])
    occ_off = occ_cum[mem_off]
    n_occ_total = int(occ_off[-1])

    qlens = np.fromiter((len(r) for r in reads), np.int32, n_reads)
    occ_rbeg = np.ascontiguousarray(occ_rbeg, np.int64)
    occ_rid = np.ascontiguousarray(occ_rid, np.int64)
    cap = max(n_occ_total, 1)
    out_nchains = np.zeros(n_reads, np.int32)
    out_pos = np.empty(cap, np.int64)
    out_rid = np.empty(cap, np.int32)
    out_w = np.empty(cap, np.int32)
    out_kept = np.empty(cap, np.int32)
    # float64: mapq = int(mapq*(1-frac_rep)+.499) (cigar.py) can
    # differ by 1 on knife-edge values if this round-trips via f32
    out_frac = np.empty(cap, np.float64)
    out_nseeds = np.empty(cap, np.int32)
    out_rmax0 = np.empty(cap, np.int64)
    out_rmax1 = np.empty(cap, np.int64)
    out_seed_idx = np.empty(cap, np.int32)
    rc = lib.chain_batch(
        _i64p(mem_s), _i32p(np.ascontiguousarray(mem_qb)),
        _i32p(np.ascontiguousarray(mem_qe)), _i64p(mem_off),
        _i64p(occ_rbeg), _i64p(occ_rid),
        _i32p(occ_qbeg), _i32p(occ_len), _i64p(occ_off),
        _i32p(qlens),
        ctypes.c_int32(n_reads), ctypes.c_int64(idx.l_pac),
        ctypes.c_int32(opt.w), ctypes.c_int32(opt.max_chain_gap),
        ctypes.c_int64(opt.max_occ),
        ctypes.c_int32(opt.min_chain_weight), ctypes.c_int32(opt.min_seed_len),
        ctypes.c_int32(opt.max_chain_extend),
        ctypes.c_double(opt.mask_level), ctypes.c_double(opt.drop_ratio),
        ctypes.c_int32(opt.a), ctypes.c_int32(opt.o_del), ctypes.c_int32(opt.e_del),
        ctypes.c_int32(opt.o_ins), ctypes.c_int32(opt.e_ins),
        _i32p(out_nchains),
        _i64p(out_pos), _i32p(out_rid), _i32p(out_w), _i32p(out_kept),
        _f64p(out_frac), _i32p(out_nseeds),
        _i64p(out_rmax0), _i64p(out_rmax1), _i32p(out_seed_idx),
        ctypes.c_int32(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"chain_batch failed: {rc}")

    # ---- batched window fetch for every kept chain
    all_r0: List[int] = []
    all_r1: List[int] = []
    all_mid: List[int] = []
    for r in range(n_reads):
        base = int(occ_off[r])
        nc = int(out_nchains[r])
        seed_base = base
        for ci in range(nc):
            all_r0.append(int(out_rmax0[base + ci]))
            all_r1.append(int(out_rmax1[base + ci]))
            # mid = first seed's rbeg (appended order head)
            all_mid.append(int(occ_rbeg[base + int(out_seed_idx[seed_base])]))
            seed_base += int(out_nseeds[base + ci])
    if all_r0:
        seqs, rids_w, begs_w, _ends_w = idx.fetch_seq_batch(all_r0, all_mid, all_r1)
    else:
        seqs, begs_w = [], []

    out: List[List[Chain]] = []
    wi = 0
    for r in range(n_reads):
        base = int(occ_off[r])
        nc = int(out_nchains[r])
        chains: List[Chain] = []
        seed_base = base
        for ci in range(nc):
            ns = int(out_nseeds[base + ci])
            seeds = []
            for si in range(seed_base, seed_base + ns):
                gi = base + int(out_seed_idx[si])
                sl = int(occ_len[gi])
                seeds.append(
                    Seed(rbeg=int(occ_rbeg[gi]), qbeg=int(occ_qbeg[gi]), len=sl, score=sl)
                )
            seed_base += ns
            c = Chain(
                pos=int(out_pos[base + ci]),
                rid=int(out_rid[base + ci]),
                seeds=seeds,
                w=int(out_w[base + ci]),
                kept=int(out_kept[base + ci]),
                frac_rep=float(out_frac[base + ci]),
            )
            c.win_seq = seqs[wi]
            c.win_rmax0 = int(begs_w[wi])
            wi += 1
            chains.append(c)
        out.append(chains)
    return out


__all__ = ["mem_chain_batch_native", "mem_chain_flat_native", "expand_occurrences"]
