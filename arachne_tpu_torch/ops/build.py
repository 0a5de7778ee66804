"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``, all
at once, and linked into one shared library with a plain C interface, at
first use, under
``build/arachne_tpu_torch/<hash of sources and flags>/`` at the root of the
checkout, and loaded with ``ctypes``.  PyTorch's headers are never
included, so a build takes seconds rather than the minutes a
``torch.utils.cpp_extension`` build of the same sources costs.

Each C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()`` after its launch; ``launch`` raises on
anything but 0.  A failed build raises too: there is no fallback.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

from ..device import nvcc_path
from ..runtime.timers import TIMERS

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
ROOT = os.path.dirname(os.path.dirname(_HERE))
LIB_NAME = "libarachne_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# this checkout's library: its path, the seconds the nvcc build of this
# process took (0.0 when it was already built) and nvcc's own output
BUILD_INFO: Dict[str, object] = {"seconds": None, "path": None, "log": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of csrc/*.cu: pointers and the stream as void*, ints as int,
# row coordinates as long long
_SIGNATURES = {
    # table, L2, primary, seq_len, wide, ks, n, out, stream
    "arachne_rank": [_P] * 2 + [_LL, _LL, _I, _P, _LL, _P, _P],
    # table, L2, primary, seq_len, wide, qs, qlens, pivots0, min_intvs,
    # single_sweep, R, L, MAXC, MAXS, ws, out, out_n, overflow, rows (each
    # read's occ4 rows, or NULL), stream
    "arachne_smem_pass": [_P] * 2 + [_LL, _LL, _I] + [_P] * 4 + [_I] * 5 + [_P] * 6,
    # table, L2, primary, seq_len, wide, qs, qlens, min_seed_len, max_intv,
    # R, L, MAXS, out, out_n, overflow, rows, stream
    "arachne_seed_pass3": [_P] * 2 + [_LL, _LL, _I, _P, _P, _LL, _LL] + [_I] * 3 + [_P] * 5,
    # the same three on a table split across cards: its shards' addresses
    # (an array on the launching card) and the records a shard holds in
    # place of the table
    "arachne_rank_sharded": [_P, _LL, _P, _LL, _LL, _I, _P, _LL, _P, _P],
    "arachne_smem_pass_sharded": [_P, _LL, _P, _LL, _LL, _I] + [_P] * 4 + [_I] * 5 + [_P] * 6,
    "arachne_seed_pass3_sharded": [_P, _LL, _P, _LL, _LL, _I, _P, _P, _LL, _LL] + [_I] * 3
    + [_P] * 5,
    # device, peer
    "arachne_enable_peer_access": [_I, _I],
    # qs, ts, qlens, tlens, ws, h0s, mat, B, qmax, tmax,
    # o_del, e_del, o_ins, e_ins, zdrop, out, cells (each problem's DP
    # cells, or NULL), stream
    "arachne_extend": [_P] * 7 + [_I] * 8 + [_P] * 3,
    # the same with int16 DP state, without cells
    "arachne_extend16": [_P] * 7 + [_I] * 8 + [_P, _P],
    # qs, ts, qlens, tlens, endscs, minscs, mat, B, qmax, tmax,
    # o_del, e_del, o_ins, e_ins, max_mat, out, stream
    "arachne_local": [_P] * 7 + [_I] * 8 + [_P, _P],
    # qs, ts, qlens, tlens, ws, mat, B, qmax, tmax,
    # o_del, e_del, o_ins, e_ins, score, z (NULL for score only), stream
    "arachne_global": [_P] * 6 + [_I] * 7 + [_P, _P, _P],
    # z, qlens, tlens, ws, B, qmax, tmax, max_steps, ops, fi, fk, stream
    "arachne_traceback": [_P] * 4 + [_I] * 4 + [_P] * 4,
}


def sources(csrc: str = CSRC) -> List[str]:
    return sorted(
        os.path.join(csrc, f)
        for f in os.listdir(csrc)
        if f.endswith((".cu", ".cuh"))
    )


def build_dir(csrc: str = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(csrc):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(ROOT, "build", "arachne_tpu_torch", h.hexdigest()[:16])


def _run(cmds: List[List[str]], log: List[str]) -> None:
    """Run the commands concurrently, appending their output to ``log``;
    raise if any fails."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    failed = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"rc {proc.returncode}: {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed (" + "\n".join(failed) + ")")


def _compile(lib_path: str, csrc: str) -> str:
    """One nvcc per source, all started together, then one link; returns
    nvcc's output."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cu = [p for p in sources(csrc) if p.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(p) + f".{tag}.o") for p in cu]
    log: List[str] = []
    _run([
        [nvcc] + NVCC_FLAGS + ["-Xptxas", "-v", "-I", csrc, "-c", src, "-o", obj]
        for src, obj in zip(cu, objs)
    ], log)
    tmp = f"{lib_path}.{tag}"
    _run([[nvcc] + NVCC_FLAGS[:2] + ["-shared", "-o", tmp] + objs], log)
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, lib_path)
    return "".join(log)


def build_library(csrc: str, info: Optional[Dict[str, object]] = None) -> ctypes.CDLL:
    """Build (unless built) and load the library of the sources in
    ``csrc``, with the C signatures bound; ``info``, when given, receives
    its path, the build's seconds (0.0 when it was already built) and
    nvcc's output.  ``get_lib`` builds this checkout's; ``python -m
    arachne_tpu_torch.ab`` builds another checkout's to time its kernels
    beside these."""
    lib_path = os.path.join(build_dir(csrc), LIB_NAME)
    t0 = time.perf_counter()
    log = "" if os.path.exists(lib_path) else _compile(lib_path, csrc)
    if info is not None:
        info.update(path=lib_path, log=log,
                    seconds=time.perf_counter() - t0 if log else 0.0)
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        # another checkout's library may predate an entry point; calling
        # one it lacks raises in ``launch``
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.arachne_error_string.argtypes = [ctypes.c_int]
    lib.arachne_error_string.restype = ctypes.c_char_p
    return lib


def get_lib() -> ctypes.CDLL:
    """The kernel library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = build_library(CSRC, BUILD_INFO)
        return _lib


@contextlib.contextmanager
def routed_to(lib: ctypes.CDLL):
    """Send every launch of this process to ``lib``, another checkout's
    build of the same entry points, while the block runs (an A/B timing of
    two versions of a kernel through the same wrappers)."""
    global _lib
    get_lib()
    with _lock:
        saved, _lib = _lib, lib
    try:
        yield
    finally:
        with _lock:
            _lib = saved


_count_lock = threading.Lock()


def launch(wrapper, entry: str, device: torch.device, *args, problems: Optional[int] = None
           ) -> None:
    """Call the C entry point ``entry`` with ``args`` and the device's
    current stream; raise on a nonzero ``cudaGetLastError()``, else add one
    to ``wrapper.launches`` (worker threads launch concurrently).  With the
    trace on, the call is a span named ``entry`` (runtime/timers.py
    ``TIMERS.launch``) with the device and the launch's ``problems``."""
    lib = get_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        if TIMERS.tracing:
            with TIMERS.launch(entry, device=str(device), problems=problems):
                rc = getattr(lib, entry)(*args, stream)
        else:
            rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.arachne_error_string(rc).decode()
        raise RuntimeError(f"{wrapper.__name__}: CUDA error {rc} ({msg})")
    with _count_lock:
        wrapper.launches += 1


def check_problems(name: str, qs, ts, mat, **per_problem) -> tuple:
    """Raise unless qs (B, qmax) and ts (B, tmax) int8, every per-problem
    tensor (B,) int32 and mat (5, 5) int32 are contiguous on one CUDA
    device, with qmax within the kernels' 1024 columns; returns (device, B,
    qmax, tmax)."""
    dev = qs.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected a CUDA device")
    B, qmax = qs.shape
    tmax = ts.shape[1]
    block_threads(qmax)
    require(qs, "qs", torch.int8, (B, qmax), dev)
    require(ts, "ts", torch.int8, (B, tmax), dev)
    for key, t in per_problem.items():
        require(t, key, torch.int32, (B,), dev)
    require(mat, "mat", torch.int32, (5, 5), dev)
    return dev, B, qmax, tmax


def require(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of this dtype and shape on
    ``device`` (the kernels read raw pointers)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def require_aligned(t: torch.Tensor, name: str, nbytes: int) -> None:
    """Raise unless ``t``'s data starts on a multiple of ``nbytes`` (kernels
    that read it as vectors of that size; torch's allocations are aligned
    far beyond, a view that starts inside one may not be)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data at {t.data_ptr():#x}, not on {nbytes} bytes")


def block_threads(qmax: int) -> int:
    """qmax rounded up to a warp; raises above 1024 columns, the widest
    query the DP kernels' 32 lanes cover with their widest strip (32)."""
    n = -(-max(qmax, 1) // 32) * 32
    if n > 1024:
        raise ValueError(f"qmax {qmax}: the DP kernels cover at most 1024 query columns")
    return n
