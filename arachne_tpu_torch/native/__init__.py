# Copy of arachne_tpu/native/__init__.py, the JAX package's host code, with
# its own loader: the library is built into build/, never into the package.
"""Native (C++) host components, loaded via ctypes.

Compiled on demand with g++ into a shared library under
``build/arachne_tpu_torch/native/<hash of sources, flags and CPU>/`` at the
root of the checkout.  The engine (ops/engine.TorchEngine) requires the
library, as it requires the CUDA kernels' (``require_lib``); the helpers
here that return None without it serve the index build and the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_DIR))
_LIB_NAME = "_arachne_native.so"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]
_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


_SOURCES = [
    "sais.cpp", "smem.cpp", "chain.cpp", "ropebwt.cpp", "rfa_tail.cpp",
    "cigarwalk.cpp", "cigarbatch.cpp",
]

# Expected ABI of the compiled library (ARACHNE_NATIVE_ABI in ropebwt.cpp).
# A cached .so that predates a signature change reports an older value (or
# lacks the symbol entirely) and is rejected rather than loaded with
# mismatched ctypes argtypes, which would corrupt memory silently.
_EXPECTED_ABI = 9


def _cpu_model() -> str:
    """-march=native ties the library to the CPU that built it."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def lib_path() -> str:
    """Where the library for these sources, flags and CPU lives."""
    h = hashlib.sha256((" ".join(_FLAGS) + "\0" + _cpu_model()).encode())
    for s in _SOURCES:
        h.update(s.encode())
        with open(os.path.join(_DIR, s), "rb") as fh:
            h.update(fh.read())
    return os.path.join(_ROOT, "build", "arachne_tpu_torch", "native", h.hexdigest()[:16], _LIB_NAME)


def _build(path: str) -> Optional[str]:
    """g++ into a temporary file tagged with the process id, then an atomic
    rename: processes building at once never see a half-written library."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++"] + _FLAGS + ["-o", tmp] + [os.path.join(_DIR, s) for s in _SOURCES],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, path)
        return path
    except (OSError, subprocess.CalledProcessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def _bind_cigar_batch(lib: ctypes.CDLL) -> None:
    """argtypes of native/cigarbatch.cpp's entry points."""
    i32 = ctypes.c_int32
    i64 = ctypes.c_int64
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.cigar_init_batch.argtypes = (
        [i64, i64p, ctypes.POINTER(ctypes.c_double)]
        + [i32] * 9 + [ctypes.c_double]                 # options
        + [i64p, i64p]                                  # mapq, w2
    )
    lib.cigar_prepare_batch.argtypes = (
        [i64, u8p, i64p, i64p, i64p, i64p, i64p]      # query, off, qb, qe, rb, re
        + [u8p, u8p, i64, i64, i8p] + [i32] * 4       # fwd, pac, l_pac, seq_len, mat
        + [u8p, u8p, i64p]                            # qbuf, rbuf, rbuf_off
        + [i32p, i32p, u8p, i64p, i32p]               # lq, rlen, ok, nogap, band
    )
    lib.cigar_finish_batch.argtypes = (
        [i64, u8p, i32p, i64p, i32p]                  # kind, cig, cig_start, cig_n
        + [u8p, i64p, i32p, u8p, i64p, i32p]          # qbuf, query_off, lq, rbuf, off, rlen
        + [i64p] * 4 + [i64, i64p, i64]               # qb qe rb re, l_pac, contigs
        + [i32p, i64p, u8p, i64p]                     # out cigar, off, md, md_off
        + [i64p, i64p, i64p, u8p]                     # nm, pos, rid, is_rev
    )
    lib.global_gather_batch.argtypes = [i64, i64p, u8p, i64p, i64, i8p]
    lib.global_nogap_batch.argtypes = [i64, i64p, u8p, i64p, u8p, i64p, i64p, i64p]
    lib.global_decode_batch.argtypes = [i64, i64p, i64p, i8p, i64, i64, i64p, i64p,
                                        i32p, i64p]


def get_lib() -> Optional[ctypes.CDLL]:
    with _lock:
        return _load()


def require_lib() -> ctypes.CDLL:
    """The library, built on first use; raises if it cannot be."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "the native host library did not load: g++ could not build "
            "arachne_tpu_torch/native/*.cpp, or the cached build has another ABI"
        )
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = lib_path()
    if not os.path.exists(path):
        path = _build(path)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        if not hasattr(lib, "arachne_native_abi"):
            return None  # pre-ABI stale .so: fall back to host paths
        lib.arachne_native_abi.restype = ctypes.c_int64
        if lib.arachne_native_abi() != _EXPECTED_ABI:
            return None  # stale .so with a different ABI: unsafe to bind
        lib.sais_u8_i64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.sais_u8_i64.restype = ctypes.c_int
        lib.sais_u8_i32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.sais_u8_i32.restype = ctypes.c_int
        try:
            lib.sais_ref_u8_i64.argtypes = lib.sais_u8_i64.argtypes
            lib.sais_ref_u8_i64.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so without the parity oracle
        try:
            lib.smem_collect_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint32),   # words
                ctypes.c_int64,                    # n_words
                ctypes.POINTER(ctypes.c_int64),    # occ
                ctypes.POINTER(ctypes.c_int64),    # L2
                ctypes.c_int64,                    # primary
                ctypes.c_int64,                    # seq_len
                ctypes.POINTER(ctypes.c_uint8),    # qs
                ctypes.POINTER(ctypes.c_int32),    # qlens
                ctypes.c_int32,                    # n_reads
                ctypes.c_int32,                    # L
                ctypes.c_int32,                    # min_seed_len
                ctypes.c_int32,                    # split_len
                ctypes.c_int32,                    # split_width
                ctypes.c_int64,                    # max_mem_intv
                ctypes.POINTER(ctypes.c_int64),    # out
                ctypes.POINTER(ctypes.c_int32),    # out_n
                ctypes.POINTER(ctypes.c_uint8),    # overflow
                ctypes.c_int32,                    # MAXS
                ctypes.c_int32,                    # n_threads
            ]
            lib.smem_collect_batch.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so without smem support; sais still usable
        try:
            u32p = ctypes.POINTER(ctypes.c_uint32)
            i64p_ = ctypes.POINTER(ctypes.c_int64)
            lib.sa_batch.argtypes = [
                u32p, ctypes.c_int64, i64p_, i64p_,       # words, n_words, occ, L2
                ctypes.c_int64, ctypes.c_int64,           # primary, seq_len
                i64p_, ctypes.c_int64,                    # sampled, sa_intv
                i64p_, ctypes.c_int64, i64p_,             # rows, n, out
                ctypes.c_int32,                           # n_threads
            ]
            lib.sa_batch.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so without sa support
        try:
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.chain_batch.argtypes = [
                i64p, i32p, i32p, i64p,          # mem_s/qb/qe, mem_off
                i64p, i64p, i32p, i32p, i64p,    # occ rbeg/rid/qbeg/len, occ_off
                i32p,                            # qlen
                ctypes.c_int32, ctypes.c_int64,  # n_reads, l_pac
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,   # w, gap, max_occ
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,   # min_w, min_seed, max_ext
                ctypes.c_double, ctypes.c_double,                  # mask, drop
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,   # a, o_del, e_del
                ctypes.c_int32, ctypes.c_int32,                    # o_ins, e_ins
                i32p,                            # out_nchains
                i64p, i32p, i32p, i32p, f64p, i32p,   # chain pos/rid/w/kept/frac/nseeds
                i64p, i64p, i32p,                # rmax0, rmax1, seed_idx
                ctypes.c_int32,                  # n_threads
            ]
            lib.chain_batch.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so without chain support
        try:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64pp = ctypes.POINTER(ctypes.c_int64)
            lib.rb_bwt_build.argtypes = [
                u8p, ctypes.c_int64, u8p, i64pp, i64pp,
            ]
            lib.rb_bwt_build.restype = ctypes.c_int
            lib.sa_sample_walk.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                i64pp, i64pp,                       # occ, L2
                ctypes.c_int64, ctypes.c_int64,     # primary, seq_len
                ctypes.c_int64, i64pp,              # sa_intv, out
            ]
            lib.sa_sample_walk.restype = ctypes.c_int
            lib.sa_sample_walk_par.argtypes = [
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
                i64pp, i64pp,                       # occ, L2
                ctypes.c_int64, ctypes.c_int64,     # primary, seq_len
                ctypes.c_int64, i64pp,              # sa_intv, out
                u8p,                                # pac2 (2-bit text)
                ctypes.c_int32, ctypes.c_int32,     # n_chunks, n_threads
                i64pp,                              # progress
            ]
            lib.sa_sample_walk_par.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so without incremental-build support
        try:
            i32 = ctypes.c_int32
            i32p_ = ctypes.POINTER(ctypes.c_int32)
            i64p2 = ctypes.POINTER(ctypes.c_int64)
            f64p2 = ctypes.POINTER(ctypes.c_double)
            u8p2 = ctypes.POINTER(ctypes.c_uint8)
            u64p2 = ctypes.POINTER(ctypes.c_uint64)
            lib.rfa_tail.argtypes = (
                [i32, i32]
                + [i64p2, i64p2, f64p2, f64p2]            # pos/aend/logp/score
                + [i32p_] * 5                              # mism/indels/sclip/slen/seqlen
                + [u8p2, i32p_, i32p_, i32p_]              # rev/contig/aln_id/read_of
                + [i64p2, i64p2, i64p2, i32p_, u64p2]      # locs/locs_off/aln_off/mate_of/jitter
                + [ctypes.c_double, ctypes.c_double, i32, i32, i32]
                + [i64p2, i64p2]                           # centromeres
                + [u8p2, u8p2, u8p2, i32p_, i32p_, u8p2]   # active/proper/pick/mapq/molid/amol
                + [f64p2, f64p2, f64p2, i32p_]             # mconf/mdiff/sum/mate
                + [i32p_, f64p2, u8p2, i32p_, f64p2]       # sb slot/score/proper/reads/conf
                + [i32p_] * 4                              # copies/in/out/uniq
                + [f64p2, i32p_, i32p_]                    # md_score/reads_in_mol/n_mol
            )
            lib.rfa_tail.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so without the RFA tail
        try:
            i32p_c = ctypes.POINTER(ctypes.c_int32)
            i64p_c = ctypes.POINTER(ctypes.c_int64)
            u8p_c = ctypes.POINTER(ctypes.c_uint8)
            lib.cigar_walk_batch.argtypes = [
                i32p_c, i64p_c,                 # cig, cig_off
                u8p_c, i64p_c,                  # ref, ref_off
                u8p_c, i64p_c,                  # read, read_off
                u8p_c, i64p_c, i64p_c,          # rev, ref_start, ref_end
                i32p_c,                         # edit_dist
                ctypes.c_int64,                 # n
                i32p_c, i64p_c, i32p_c, i32p_c, # counters, locs, rlocs, n
                ctypes.c_int32,                 # n_threads
            ]
            lib.cigar_walk_batch.restype = ctypes.c_int
        except AttributeError:
            pass  # stale .so without the cigar walk
        try:
            _bind_cigar_batch(lib)
        except AttributeError:
            pass  # a build without the CIGAR stage's host side
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def cigar_walk_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "cigar_walk_batch")


def cigar_walk_batch_native(
    cig: np.ndarray, cig_off: np.ndarray,
    ref: np.ndarray, ref_off: np.ndarray,
    read: np.ndarray, read_off: np.ndarray,
    rev: np.ndarray, ref_start: np.ndarray, ref_end: np.ndarray,
    edit_dist: np.ndarray, n_threads: int = 1,
):
    """Batched GetAlignments cigar walk (native/cigarwalk.cpp).

    Returns (counters (n,6) int32, mism_locs int64, mism_read_locs int32,
    mism_n (n,) int32); the locus arrays are indexed at each hit's
    read_off base.  None when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "cigar_walk_batch"):
        return None
    n = len(cig_off) - 1
    counters = np.zeros((n, 6), np.int32)
    mism_locs = np.zeros(int(read_off[-1]), np.int64)
    mism_read_locs = np.zeros(int(read_off[-1]), np.int32)
    mism_n = np.zeros(n, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.cigar_walk_batch(
        cig.ctypes.data_as(i32p), cig_off.ctypes.data_as(i64p),
        ref.ctypes.data_as(u8p), ref_off.ctypes.data_as(i64p),
        read.ctypes.data_as(u8p), read_off.ctypes.data_as(i64p),
        rev.ctypes.data_as(u8p), ref_start.ctypes.data_as(i64p),
        ref_end.ctypes.data_as(i64p), edit_dist.ctypes.data_as(i32p),
        np.int64(n),
        counters.ctypes.data_as(i32p), mism_locs.ctypes.data_as(i64p),
        mism_read_locs.ctypes.data_as(i32p), mism_n.ctypes.data_as(i32p),
        np.int32(n_threads),
    )
    if rc != 0:
        return None
    return counters, mism_locs, mism_read_locs, mism_n


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _arr(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype)


def cigar_init_native(reg: np.ndarray, frac_rep: np.ndarray, opt):
    """mapq (0 for secondary hits) and the first band w2 of mem_reg2aln
    for the rows of ``reg`` (m, 12) int64: qb, qe, rb, re, truesc, w,
    secondary, score, sub, csub, sub_n, seedcov."""
    reg = _arr(reg, np.int64)
    frac_rep = _arr(frac_rep, np.float64)
    m = len(reg)
    mapq = np.empty(m, np.int64)
    w2 = np.empty(m, np.int64)
    get_lib().cigar_init_batch(
        m, _ptr(reg, ctypes.c_int64), _ptr(frac_rep, ctypes.c_double),
        opt.a, opt.b, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.w, opt.min_seed_len,
        opt.mapQ_coef_len, float(opt.mapQ_coef_fac) if opt.mapQ_coef_len > 0 else 0.0,
        _ptr(mapq, ctypes.c_int64), _ptr(w2, ctypes.c_int64),
    )
    return mapq, w2


def cigar_prepare_native(query, query_off, qb, qe, rb, re, fwd, pac, l_pac, seq_len, mat, opt):
    """gen_cigar_prepare for every hit at once (cigarbatch.cpp
    ``cigar_prepare_batch``): returns (qbuf, rbuf, rbuf_off, lq, rlen, ok,
    nogap, band); hit i's oriented query is qbuf[query_off[i]:][:lq[i]]
    and its window rbuf[rbuf_off[i]:][:rlen[i]].  ``fwd`` is the index's
    forward code cache, or None to read the 2-bit ``pac``."""
    query, mat = _arr(query, np.uint8), _arr(mat, np.int8)
    query_off, qb, qe, rb, re = (_arr(x, np.int64) for x in (query_off, qb, qe, rb, re))
    m = len(qb)
    cap = np.clip(np.minimum(re, seq_len) - np.maximum(rb, 0), 0, None)
    rbuf_off = np.zeros(m + 1, np.int64)
    np.cumsum(cap, out=rbuf_off[1:])
    qbuf = np.empty(max(int(query_off[-1]), 1), np.uint8)
    rbuf = np.empty(max(int(rbuf_off[-1]), 1), np.uint8)
    lq = np.empty(m, np.int32)
    rlen = np.empty(m, np.int32)
    ok = np.empty(m, np.uint8)
    nogap = np.empty(m, np.int64)
    band = np.empty(m, np.int32)
    u8, i32, i64 = ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64
    get_lib().cigar_prepare_batch(
        m, _ptr(query, u8), _ptr(query_off, i64),
        _ptr(qb, i64), _ptr(qe, i64), _ptr(rb, i64), _ptr(re, i64),
        None if fwd is None else _ptr(fwd, u8), _ptr(pac, u8), l_pac, seq_len,
        _ptr(mat, ctypes.c_int8), opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
        _ptr(qbuf, u8), _ptr(rbuf, u8), _ptr(rbuf_off, i64),
        _ptr(lq, i32), _ptr(rlen, i32), _ptr(ok, u8), _ptr(nogap, i64), _ptr(band, i32),
    )
    return qbuf, rbuf, rbuf_off, lq, rlen, ok, nogap, band


def cigar_finish_native(kind, cig, cig_start, cig_n, prep, query_off, qb, qe, rb, re,
                        l_pac, contig_off):
    """gen_cigar_finish and mem_reg2aln's tail for every hit at once
    (cigarbatch.cpp ``cigar_finish_batch``) over ``prep``, what
    ``cigar_prepare_native`` returned.  Returns (cigar pairs (k, 2) int32,
    cigar offsets, MD bytes, MD offsets, NM, pos, rid, is_rev)."""
    qbuf, rbuf, rbuf_off, lq, rlen = prep[:5]
    kind, cig = _arr(kind, np.uint8), _arr(cig, np.int32)
    cig_start, query_off, qb, qe, rb, re, contig_off = (
        _arr(x, np.int64) for x in (cig_start, query_off, qb, qe, rb, re, contig_off))
    cig_n = _arr(cig_n, np.int32)
    m = len(kind)
    out_cig = np.empty((int(cig_n.sum()) + 3 * m, 2), np.int32)
    out_cig_off = np.empty(m + 1, np.int64)
    md = np.empty(int(3 * (lq.sum(dtype=np.int64) + rlen.sum(dtype=np.int64))) + 24 * m, np.uint8)
    md_off = np.empty(m + 1, np.int64)
    nm = np.empty(m, np.int64)
    pos = np.empty(m, np.int64)
    rid = np.empty(m, np.int64)
    is_rev = np.empty(m, np.bool_)
    u8, i32, i64 = ctypes.c_uint8, ctypes.c_int32, ctypes.c_int64
    get_lib().cigar_finish_batch(
        m, _ptr(kind, u8), _ptr(cig, i32), _ptr(cig_start, i64), _ptr(cig_n, i32),
        _ptr(qbuf, u8), _ptr(query_off, i64), _ptr(lq, i32),
        _ptr(rbuf, u8), _ptr(rbuf_off, i64), _ptr(rlen, i32),
        _ptr(qb, i64), _ptr(qe, i64), _ptr(rb, i64), _ptr(re, i64),
        l_pac, _ptr(contig_off, i64), len(contig_off),
        _ptr(out_cig, i32), _ptr(out_cig_off, i64), _ptr(md, u8), _ptr(md_off, i64),
        _ptr(nm, i64), _ptr(pos, i64), _ptr(rid, i64), _ptr(is_rev, u8),
    )
    return out_cig[: out_cig_off[-1]], out_cig_off, md[: md_off[-1]].tobytes(), md_off, \
        nm, pos, rid, is_rev


def global_gather_native(sel, flat, off, width) -> np.ndarray:
    """(len(sel), width) int8: problem sel[k]'s codes flat[off[j]:off[j+1]]
    in row k, padded with N (4), as ops/sw_extend.padded_codes."""
    sel, off, flat = _arr(sel, np.int64), _arr(off, np.int64), _arr(flat, np.uint8)
    out = np.empty((len(sel), width), np.int8)
    get_lib().global_gather_batch(
        len(sel), _ptr(sel, ctypes.c_int64), _ptr(flat, ctypes.c_uint8),
        _ptr(off, ctypes.c_int64), width, _ptr(out, ctypes.c_int8),
    )
    return out


def global_nogap_native(sel, qs, q_off, ts, t_off, mat) -> np.ndarray:
    """sum(mat[t, q]) of each problem sel[k] (query and target of one
    length): BatchGlobal's all-M screen."""
    sel, q_off, t_off, mat = (_arr(x, np.int64) for x in (sel, q_off, t_off, mat))
    qs, ts = _arr(qs, np.uint8), _arr(ts, np.uint8)
    out = np.empty(len(sel), np.int64)
    i64, u8 = ctypes.c_int64, ctypes.c_uint8
    get_lib().global_nogap_batch(
        len(sel), _ptr(sel, i64), _ptr(qs, u8), _ptr(q_off, i64), _ptr(ts, u8),
        _ptr(t_off, i64), _ptr(mat, i64), _ptr(out, i64),
    )
    return out


def global_decode_native(lane, qlen, ops, fi, fk):
    """Run-length CIGARs of BatchGlobal's problems (cigarbatch.cpp
    ``global_decode_batch``): [(M, qlen[i])] where lane[i] < 0, else the
    decode of K4's op stream in column lane[i] of ``ops`` (steps, lanes)
    with its trailing runs fi/fk.  Returns (pairs (k, 2) int32, offsets)."""
    lane, qlen, fi, fk = (_arr(x, np.int64) for x in (lane, qlen, fi, fk))
    ops = _arr(ops, np.int8)
    n = len(lane)
    steps, lanes = ops.shape
    out = np.empty(((steps + 2) * lanes + n, 2), np.int32)
    off = np.empty(n + 1, np.int64)
    i64 = ctypes.c_int64
    get_lib().global_decode_batch(
        n, _ptr(lane, i64), _ptr(qlen, i64), _ptr(ops, ctypes.c_int8), steps, lanes,
        _ptr(fi, i64), _ptr(fk, i64), _ptr(out, ctypes.c_int32), _ptr(off, i64),
    )
    return out[: off[-1]], off


def native_threads() -> int:
    """Worker threads for native batch calls: ARACHNE_NATIVE_THREADS, else
    the machine's cores (capped) — the old hardcoded 4 both oversubscribed
    small hosts and under-used big ones."""
    import os as _os

    env = _os.environ.get("ARACHNE_NATIVE_THREADS")
    if env:
        return max(1, int(env))
    return max(1, min(_os.cpu_count() or 4, 16))


def smem_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "smem_collect_batch")


def chain_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "chain_batch")


def sais_available() -> bool:
    return get_lib() is not None


def ropebwt_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "rb_bwt_build")


def rb_bwt_build_native(
    pac2: np.ndarray, n: int, progress: Optional[np.ndarray] = None
) -> Optional[tuple]:
    """Incremental BWT of an n-symbol 2-bit-packed text (ropebwt.cpp).

    Returns (bwt_pac2, primary) with the stored BWT in the same 4-per-byte
    high-first packing, or None when the native library is unavailable.
    ``progress`` may be a 1-element int64 array the builder updates with the
    number of processed symbols (poll it from another thread; the ctypes
    call releases the GIL)."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "rb_bwt_build"):
        return None
    out = np.zeros((n + 3) // 4, dtype=np.uint8)
    primary = np.zeros(1, dtype=np.int64)
    if progress is None:
        progress = np.zeros(1, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.rb_bwt_build(
        pac2.ctypes.data_as(u8p),
        np.int64(n),
        out.ctypes.data_as(u8p),
        primary.ctypes.data_as(i64p),
        progress.ctypes.data_as(i64p),
    )
    if rc != 0:
        return None
    return out, int(primary[0])


def sa_sample_walk_native(
    bwt_words: np.ndarray,
    occ: np.ndarray,
    L2: np.ndarray,
    primary: int,
    seq_len: int,
    sa_intv: int,
    pac2: Optional[np.ndarray] = None,
    progress: Optional[np.ndarray] = None,
    n_chunks: int = 64,
) -> Optional[np.ndarray]:
    """Sampled SA via the LF-cycle walk (bwt_cal_sa, bwt.c:62-84).

    With ``pac2`` (the 2-bit fwd+rev text) the parallel anchored version
    runs: chunk-boundary suffix rows found by backward search, segments
    walked concurrently with interleaved prefetched chains
    (sa_sample_walk_par; identical output, parity-tested).  Without it,
    the serial single-chain walk."""
    if sa_intv <= 0 or sa_intv & (sa_intv - 1):
        raise ValueError(f"sa_intv {sa_intv}: the SA-sampling walk needs a power of two")
    lib = get_lib()
    if lib is None or not hasattr(lib, "sa_sample_walk"):
        return None
    out = np.zeros(seq_len // sa_intv + 1, dtype=np.int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p2 = ctypes.POINTER(ctypes.c_uint8)
    occ_c = np.ascontiguousarray(occ, dtype=np.int64)
    L2_c = np.ascontiguousarray(L2, dtype=np.int64)
    if pac2 is not None and hasattr(lib, "sa_sample_walk_par"):
        if progress is None:
            progress = np.zeros(1, dtype=np.int64)
        rc = lib.sa_sample_walk_par(
            bwt_words.ctypes.data_as(u32p),
            np.int64(len(bwt_words)),
            occ_c.ctypes.data_as(i64p),
            L2_c.ctypes.data_as(i64p),
            np.int64(primary),
            np.int64(seq_len),
            np.int64(sa_intv),
            out.ctypes.data_as(i64p),
            pac2.ctypes.data_as(u8p2),
            np.int32(n_chunks),
            np.int32(native_threads()),
            progress.ctypes.data_as(i64p),
        )
        if rc == 0:
            return out
    rc = lib.sa_sample_walk(
        bwt_words.ctypes.data_as(u32p),
        np.int64(len(bwt_words)),
        occ_c.ctypes.data_as(i64p),
        L2_c.ctypes.data_as(i64p),
        np.int64(primary),
        np.int64(seq_len),
        np.int64(sa_intv),
        out.ctypes.data_as(i64p),
    )
    if rc != 0:
        return None
    return out


def suffix_array_native(codes: np.ndarray) -> Optional[np.ndarray]:
    """SA of codes+sentinel via native SA-IS; None if unavailable.

    Matches index.build.suffix_array: returns SA of length n+1 over the
    string codes$ with $ smallest."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(codes)
    s = np.empty(n + 1, dtype=np.uint8)
    s[:n] = codes
    s[:n] += 1  # in place: `codes + 1` would cost a second n-byte temporary
    s[n] = 0
    if n + 1 < (1 << 31):
        sa = np.empty(n + 1, dtype=np.int32)
        rc = lib.sais_u8_i32(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.int32(n + 1),
            np.int32(6),
        )
        if rc != 0:
            return None
        return sa.astype(np.int64)
    sa = np.empty(n + 1, dtype=np.int64)
    rc = lib.sais_u8_i64(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.int64(n + 1),
        np.int64(6),
    )
    if rc != 0:
        return None
    return sa
