"""Batched banded global alignment for CIGARs (ksw_global2, ksw.c:504-607).

``global_batch_torch`` is the plain PyTorch version of the reference's XLA
``global_batch_kernel`` (arachne_tpu/ops/sw_global.py) and
``traceback_torch`` of its scalar walk (``ksw.global2``).  Direction
bytes keep the reference's device bit layout (bits 0-1 H source
0=M/1=E/2=F, bit 2 E-continuation, bit 5 F-continuation, as ksw.c) in the
port's own (B, tmax, qmax) layout.  The scalar ``ksw.global2`` keeps the
F-continuation at bit 4, so its walk, in the insertion state, reads a set
continuation as 1 and turns to a deletion, where the reference's device
walk ``traceback_device`` stays in the insertion; the port's walk takes the
scalar turn, so its CIGARs are the scalar path's.  ``global_score`` / ``global_z`` / ``traceback``
are the wrappers of kernels K3 and K4 (csrc/global.cu): plain versions for
CPU tensors, kernels for CUDA tensors.

``BatchGlobal`` screens equal-length problems with the score-only pass and
its provable all-M shortcut, and sends the rest through K3's z variant and
the K4 walk; only the op stream comes back to the host.
"""

from __future__ import annotations

import threading
from collections.abc import Sequence
from typing import List, Tuple

import numpy as np
import torch

from .. import native
from ..align.ksw import MINUS_INF, _push_cigar
from ..config import MemOptions
from ..runtime.timers import TIMERS

from .cuda_global import global_score_cuda, global_z_cuda, traceback_cuda
from .devicepool import dispatch_devices, put
from .params import ParamsByDevice
from .sw_extend import bucket64

# Number of problems that went through the direction bytes + backtrack walk
# (i.e. were NOT settled by the all-M shortcut in BatchGlobal.run), so e2e
# runs can show the gapped path fired.
traceback_fetches = 0
_fetch_lock = threading.Lock()


def global_batch_torch(qs, ts, qlens, tlens, ws, mat, *, o_del, e_del, o_ins, e_ins, want_z: bool):
    """Plain version of K3.  Returns (score (B,) int32, z) with z
    (B, tmax, qmax) uint8 when ``want_z`` else None."""
    dev = qs.device
    B, qmax = qs.shape
    tmax = ts.shape[1]
    i32 = torch.int32
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    NEG = MINUS_INF
    qlens, tlens, ws = (x.to(dev, i32) for x in (qlens, tlens, ws))
    mat = mat.to(dev, i32)
    qi = qs.long()
    jidx = torch.arange(qmax, dtype=i32, device=dev)[None, :]
    valid_q = jidx < qlens[:, None]

    # first row: H(-1, j) = -(o_ins + e_ins*(j+1)) within the band
    H = torch.where(
        (jidx + 1 <= ws[:, None]) & valid_q, -(o_ins + e_ins * (jidx + 1)), NEG
    ).to(i32)
    E = torch.full((B, qmax), NEG, dtype=i32, device=dev)
    score = torch.full((B,), NEG, dtype=i32, device=dev)
    z = torch.zeros((B, tmax, qmax), dtype=torch.uint8, device=dev) if want_z else None
    neg_f = torch.full((B, 1), NEG, dtype=i32, device=dev)
    last = (qlens - 1).clamp_min(0).long()[:, None]
    n_rows = min(tmax, int(tlens.max())) if B else 0
    for i in range(n_rows):
        row_live = i < tlens
        tcode = torch.where(row_live, ts[:, i].long(), 4)
        q_row = mat[tcode[:, None], qi]
        in_band = (jidx >= (i - ws)[:, None]) & (jidx < (i + ws + 1)[:, None]) & valid_q
        if i == 0:
            bound_prev = torch.zeros(B, dtype=i32, device=dev)
        else:
            bound_prev = torch.where((i - 1) <= ws, -(o_del + e_del * i), NEG).to(i32)
        Hdiag = torch.cat([bound_prev[:, None], H[:, :-1]], dim=1)
        M = Hdiag + q_row
        # F scan with -inf init: F(j) = max_k<j (M(k) - oe_ins - (j-1-k)e_ins)
        v = torch.where(in_band, (M - oe_ins) + jidx * e_ins, NEG)
        run = torch.cummax(v, dim=1).values
        F = torch.cat([neg_f, run[:, :-1] - (jidx[:, 1:] - 1) * e_ins], dim=1)
        d = torch.where(M >= E, 0, 1).to(torch.uint8)
        Hn = torch.maximum(M, E)
        d = torch.where(Hn >= F, d, 2).to(torch.uint8)
        Hn = torch.maximum(Hn, F)
        d = d | (((E - e_del) > (M - oe_del)).to(torch.uint8) << 2)
        d = d | (((F - e_ins) > (M - oe_ins)).to(torch.uint8) << 5)
        En = torch.maximum(E - e_del, M - oe_del)
        Hn = torch.where(in_band, Hn, NEG)
        En = torch.where(in_band, En, NEG)
        if want_z:
            z[:, i, :] = torch.where(in_band & row_live[:, None], d, 0)
        # score: H at (tlen-1, qlen-1)
        h_last = Hn.gather(1, last)[:, 0]
        score = torch.where(tlens - 1 == i, h_last, score)
        keep = row_live[:, None]
        H = torch.where(keep, Hn, H)
        E = torch.where(keep, En, E)
    return score, z


def traceback_torch(z, qlens, tlens, ws, *, max_steps: int):
    """Plain version of K4: the backtrack walk (ksw.c:588-602, with
    ``ksw.global2``'s turn out of an insertion) for all lanes at once over
    z (B, tmax, qmax).  Returns (ops (max_steps, B) int8
    with 0=M, 2=D, 1=I and 3 after the lane finished, fi (B,), fk (B,))."""
    dev = z.device
    B, tmax, qmax = z.shape
    i32 = torch.int32
    zf = z.reshape(B, tmax * qmax)
    qlens, tlens, ws = (x.to(dev, i32) for x in (qlens, tlens, ws))
    i = tlens - 1
    k = torch.minimum(i + ws + 1, qlens) - 1
    which = torch.zeros(B, dtype=i32, device=dev)
    ops = torch.full((max_steps, B), 3, dtype=torch.int8, device=dev)
    for s in range(max_steps):
        active = (i >= 0) & (k >= 0)
        if s % 32 == 0 and not bool(active.any()):
            break
        idx = i.clamp(0, tmax - 1) * qmax + k.clamp(0, qmax - 1)
        zv = zf.gather(1, idx.long()[:, None])[:, 0].to(i32)
        nw = (zv >> (which << 1)) & 3
        # ksw.global2 reads an insertion's continuation (bit 5 here, bit 4
        # there) as 1: the walk turns to a deletion
        nw = torch.where((which == 2) & (nw == 2), 1, nw)
        # host semantics: nw==0 -> M (i-1,k-1); ==1 -> D (i-1); >=2 -> I (k-1)
        op = torch.where(nw == 0, 0, torch.where(nw == 1, 2, 1)).to(torch.int8)
        ops[s] = torch.where(active, op, 3).to(torch.int8)
        i = torch.where(active & (nw <= 1), i - 1, i)
        k = torch.where(active & (nw != 1), k - 1, k)
        # the RAW 2-bit value (3 included) is the next read's shift state
        which = torch.where(active, nw, which)
    return ops, i, k


def global_score(qs, ts, qlens, tlens, ws, mat, **gaps):
    """K3 score-only wrapper: plain version on CPU, kernel on CUDA."""
    if qs.device.type == "cpu":
        return global_batch_torch(qs, ts, qlens, tlens, ws, mat, **gaps, want_z=False)[0]
    return global_score_cuda(qs, ts, qlens, tlens, ws, mat, **gaps)


def global_z(qs, ts, qlens, tlens, ws, mat, **gaps):
    """K3 direction-byte wrapper: plain version on CPU, kernel on CUDA."""
    if qs.device.type == "cpu":
        return global_batch_torch(qs, ts, qlens, tlens, ws, mat, **gaps, want_z=True)
    return global_z_cuda(qs, ts, qlens, tlens, ws, mat, **gaps)


def traceback(z, qlens, tlens, ws, *, max_steps: int):
    """K4 wrapper: plain version on CPU, kernel on CUDA."""
    if z.device.type == "cpu":
        return traceback_torch(z, qlens, tlens, ws, max_steps=max_steps)
    return traceback_cuda(z, qlens, tlens, ws, max_steps=max_steps)


def decode_traceback_ops(ops_col: np.ndarray, fi: int, fk: int) -> List[Tuple[int, int]]:
    """Host-side finish of the walk for one lane: reverse the op stream,
    append the trailing D/I runs, run-length encode (the inverse order +
    merge of the host ``traceback``)."""
    seq = ops_col[ops_col != 3]
    cigar: List[Tuple[int, int]] = []
    tail: List[Tuple[int, int]] = []
    if fi >= 0:
        tail.append((2, fi + 1))
    if fk >= 0:
        tail.append((1, fk + 1))
    full = list(seq) + [op for op, n in tail for _ in range(n)]
    for op in reversed(full):
        _push_cigar(cigar, int(op), 1)
    return cigar


class BatchGlobal:
    """Batched bwa-style global alignment returning (score, cigar)."""

    CHUNK = 1024    # score-only problems per launch
    CHUNK_Z = 128   # direction-byte problems per launch (tmax*qmax bytes each)
    QMAX, TMAX = 192, 320  # width floors, as in BatchExtender

    def __init__(self, opt: MemOptions, device: torch.device):
        self.opt = opt
        self.device = torch.device(device)
        self.params_on = ParamsByDevice(opt)
        self.mat_np = opt.scoring_matrix().astype(np.int64)
        self.reset()

    def reset(self):
        self.problems: List[Tuple[np.ndarray, np.ndarray, int]] = []

    def submit(self, query: np.ndarray, target: np.ndarray, w: int) -> int:
        self.problems.append((query, target, w))
        return len(self.problems) - 1

    def _chunks(self, lens, pad, chunk):
        """tlen-sorted chunks of device tensors, chunk ci on the pool's
        device ci (mod its size), of the problems whose (qlens, tlens, ws)
        are ``lens``; ``pad(order, qmax, tmax)`` gives the padded int8
        query and target codes of problems ``order``, one row each.  Yields
        (idx, qmax, tmax, the chunk's KernelParams, (qs, ts, qlens, tlens,
        ws))."""
        qlens, tlens, ws = lens
        order = np.argsort(tlens, kind="stable")
        qmax = bucket64(int(qlens.max()), self.QMAX)
        tmax = bucket64(int(tlens.max()), self.TMAX)
        host = (*pad(order, qmax, tmax), qlens[order].astype(np.int32),
                tlens[order].astype(np.int32), ws[order])
        devs = dispatch_devices(self.device)
        for ci, c0 in enumerate(range(0, len(order), chunk)):
            dev = devs[ci % len(devs)]
            rows = slice(c0, c0 + chunk)
            yield (order[rows], qmax, tmax, self.params_on[dev],
                   [put(x[rows], dev) for x in host])

    def _scores(self, lens, pad) -> np.ndarray:
        out = np.empty(len(lens[0]), np.int64)
        pending = []
        for idx, qmax, tmax, p, args in self._chunks(lens, pad, self.CHUNK):
            pending.append((idx, qmax, tmax, global_score(*args, p.mat, **p.gaps())))
        for idx, qmax, tmax, score in pending:
            with TIMERS.span("fetch", family="global", qmax=qmax, tmax=tmax):
                out[idx] = score.cpu().numpy()
        return out

    def _traceback_on_device(self, lens, pad):
        """K3's direction bytes and the K4 walk on the device for gapped
        problems; only the op stream reaches the host.  Returns each
        chunk's (idx, (score, fi, fk) (3, B), ops (steps, B)) on the host."""
        pending = []
        for idx, qmax, tmax, p, args in self._chunks(lens, pad, self.CHUNK_Z):
            _, _, qlens, tlens, ws = args
            score, z = global_z(*args, p.mat, **p.gaps())
            ops, fi, fk = traceback(z, qlens, tlens, ws, max_steps=qmax + tmax)
            pending.append((idx, qmax, tmax, torch.stack([score, fi, fk]), ops))
        fetched = []
        for idx, qmax, tmax, meta, ops in pending:
            with TIMERS.span("fetch", family="traceback", qmax=qmax, tmax=tmax):
                fetched.append((idx, meta.cpu().numpy(), ops.cpu().numpy()))
        return fetched

    @staticmethod
    def _count_fetches(n: int) -> None:
        global traceback_fetches
        with _fetch_lock:
            traceback_fetches += n

    def run(self) -> "GlobalResults":
        """Two-phase: score-only first; full traceback only for problems
        whose optimum is not provably the all-M alignment.

        If rlen == qlen and the global score equals the no-gap score
        sum(mat[t, q]), the traceback is exactly [(M, qlen)] (the
        reference's BatchGlobal.run explains why); length-mismatched
        problems go straight to the traceback.  The host side runs in
        native/cigarbatch.cpp: the padded launch buffers, the all-M screen
        and the op streams' decode, each one call over flat code
        buffers."""
        problems = self.problems
        self.reset()
        n = len(problems)
        if not n:
            return GlobalResults(np.zeros(0, np.int64), np.zeros((0, 2), np.int32),
                                 np.zeros(1, np.int64))
        qs = [p[0] for p in problems]
        ts = [p[1] for p in problems]
        qlens = np.fromiter(map(len, qs), np.int64, n)
        tlens = np.fromiter(map(len, ts), np.int64, n)
        ws = np.fromiter((p[2] for p in problems), np.int32, n)
        q_off = np.zeros(n + 1, np.int64)
        t_off = np.zeros(n + 1, np.int64)
        np.cumsum(qlens, out=q_off[1:])
        np.cumsum(tlens, out=t_off[1:])
        q_flat = np.concatenate(qs).astype(np.uint8, copy=False)
        t_flat = np.concatenate(ts).astype(np.uint8, copy=False)

        def pad(sel):
            return lambda order, qmax, tmax: (
                native.global_gather_native(sel[order], q_flat, q_off, qmax),
                native.global_gather_native(sel[order], t_flat, t_off, tmax),
            )

        score = np.empty(n, np.int64)
        need_tb = qlens != tlens
        screened = np.flatnonzero(~need_tb)
        if screened.size:
            sc = self._scores((qlens[screened], tlens[screened], ws[screened]), pad(screened))
            score[screened] = sc
            nogap = native.global_nogap_native(screened, q_flat, q_off, t_flat, t_off, self.mat_np)
            need_tb[screened[sc != nogap]] = True
        lane = np.full(n, -1, np.int64)
        tb = np.flatnonzero(need_tb)
        ops = np.zeros((0, 0), np.int8)
        fi = fk = np.zeros(0, np.int64)
        if tb.size:
            self._count_fetches(len(tb))
            fetched = self._traceback_on_device((qlens[tb], tlens[tb], ws[tb]), pad(tb))
            order = np.concatenate([idx for idx, _, _ in fetched])
            meta = np.concatenate([m for _, m, _ in fetched], axis=1)
            ops = np.concatenate([o for _, _, o in fetched], axis=1)
            score[tb[order]] = meta[0]
            lane[tb[order]] = np.arange(len(tb))
            fi, fk = meta[1], meta[2]
        cig, off = native.global_decode_native(lane, qlens, ops, fi, fk)
        return GlobalResults(score, cig, off)


class GlobalResults(Sequence):
    """The (score, cigar) of each problem of a ``BatchGlobal.run``: score
    (n,) int64 and the run-length CIGARs as flat (op, len) int32 pairs
    ``cig`` with offsets ``cig_off`` (n + 1).  As a sequence it gives
    (score, [(op, len), ...]) a problem, and compares equal to a list of
    those."""

    __slots__ = ("score", "cig", "cig_off")

    def __init__(self, score: np.ndarray, cig: np.ndarray, cig_off: np.ndarray):
        self.score, self.cig, self.cig_off = score, cig, cig_off

    def __len__(self) -> int:
        return len(self.score)

    def __getitem__(self, i: int):
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        i %= len(self)
        a, b = self.cig_off[i], self.cig_off[i + 1]
        return int(self.score[i]), [tuple(p) for p in self.cig[a:b].tolist()]

    def __eq__(self, other) -> bool:
        return isinstance(other, (list, tuple, GlobalResults)) and list(self) == list(other)

    __hash__ = None
