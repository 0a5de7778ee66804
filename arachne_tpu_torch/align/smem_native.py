# Copy of arachne_tpu/align/smem_native.py, the JAX package's host code,
# but for one split: the collector's rows before they become SMEM objects
# are collect_seeds_native_flat, which ops/batch.py hands the native chainer
# as one flat SeedBatch, as device seeding's; the output is the reference's.
"""Native (C++) SMEM seeding driver.

Wraps native/smem.cpp's `smem_collect_batch`: the full three-pass seed
collection (mem_collect_intv semantics) runs in C++ over the planar
occ/bwt_words arrays, releasing the GIL for the whole batch — the
reference's dense numpy engine spends most of its time in per-read Python
loops that serialize the CLI's superbatch thread pool.

Exact output vs the scalar collector (tests/test_fm_seed.py); reads whose
seed count exceeds MAXS fall back to the scalar path (rare: MAXS=256 vs
the typical handful of SMEMs per short read).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..config import MemOptions
from ..index.fmindex import FMIndex
from ..native import native_threads, require_lib, smem_available
from .smem import SMEM, collect_seeds


def collect_seeds_native_flat(
    idx: FMIndex,
    reads: List[np.ndarray],
    opt: MemOptions,
    MAXS: int = 256,
    n_threads: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Three-pass seed collection in native code, flat: each row's read
    (N,) int64 and its (k, l, s, qb, qe) rows (N, 5) int64, read by read in
    the collector's order; a read that overflows MAXS has the scalar
    collector's rows at its place."""
    if n_threads is None:
        n_threads = native_threads()
    n = len(reads)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros((0, 5), np.int64)
    lib = require_lib()
    L = max(1, max(len(r) for r in reads))
    qs = np.full((n, L), 4, np.uint8)
    qlens = np.zeros(n, np.int32)
    for i, r in enumerate(reads):
        qs[i, : len(r)] = r
        qlens[i] = len(r)
    words = np.ascontiguousarray(idx.fm.bwt_words, dtype=np.uint32)
    occ = np.ascontiguousarray(idx.fm.occ, dtype=np.int64)
    L2 = np.ascontiguousarray(idx.L2, dtype=np.int64)
    out = np.zeros((n, MAXS, 5), np.int64)
    out_n = np.zeros(n, np.int32)
    overflow = np.zeros(n, np.uint8)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    rc = lib.smem_collect_batch(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_int64(len(words)),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        L2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(int(idx.primary)),
        ctypes.c_int64(int(idx.seq_len)),
        qs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        qlens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(n),
        ctypes.c_int32(L),
        ctypes.c_int32(opt.min_seed_len),
        ctypes.c_int32(split_len),
        ctypes.c_int32(opt.split_width),
        ctypes.c_int64(opt.max_mem_intv),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        overflow.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(MAXS),
        ctypes.c_int32(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"smem_collect_batch failed: {rc}")
    over = overflow.astype(bool)
    read, t = np.nonzero((np.arange(MAXS)[None, :] < out_n[:, None]) & ~over[:, None])
    read, rows = read.astype(np.int64), out[read, t]
    if over.any():
        redo = [(r, collect_seeds(idx, reads[r], opt)) for r in np.flatnonzero(over)]
        read = np.concatenate([read] + [np.full(len(m), r, np.int64) for r, m in redo])
        rows = np.concatenate([rows] + [np.array([[s.k, s.l, s.s, s.qb, s.qe] for s in m],
                                                 np.int64).reshape(-1, 5) for _, m in redo])
        order = np.argsort(read, kind="stable")
        read, rows = read[order], rows[order]
    return read, rows


def collect_seeds_native(
    idx: FMIndex,
    reads: List[np.ndarray],
    opt: MemOptions,
    MAXS: int = 256,
    n_threads: Optional[int] = None,
) -> List[List[SMEM]]:
    """Three-pass seed collection in native code; exact scalar output."""
    read, rows = collect_seeds_native_flat(idx, reads, opt, MAXS, n_threads)
    mems = [SMEM(*m) for m in rows.tolist()]
    off = np.zeros(len(reads) + 1, np.int64)
    np.cumsum(np.bincount(read, minlength=len(reads)), out=off[1:])
    off = off.tolist()
    return [mems[a:b] for a, b in zip(off[:-1], off[1:])]


__all__ = ["collect_seeds_native", "collect_seeds_native_flat", "smem_available"]
