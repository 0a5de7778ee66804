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
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..align.ksw import MINUS_INF, _push_cigar
from ..config import MemOptions
from ..runtime.timers import TIMERS

from .cuda_global import global_score_cuda, global_z_cuda, traceback_cuda
from .devicepool import dispatch_devices, put
from .params import ParamsByDevice
from .sw_extend import bucket64, lengths, padded_codes

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

    def _chunks(self, problems, chunk):
        """tlen-sorted chunks of device tensors, chunk ci on the pool's
        device ci (mod its size): yields (order slice, qmax, tmax, the
        chunk's KernelParams, (qs, ts, qlens, tlens, ws))."""
        order = sorted(range(len(problems)), key=lambda i: len(problems[i][1]))
        qmax = bucket64(max(len(q) for q, _, _ in problems), self.QMAX)
        tmax = bucket64(max(len(t) for _, t, _ in problems), self.TMAX)
        devs = dispatch_devices(self.device)
        for ci, c0 in enumerate(range(0, len(order), chunk)):
            dev = devs[ci % len(devs)]
            idx = order[c0 : c0 + chunk]
            qs_l = [problems[i][0] for i in idx]
            ts_l = [problems[i][1] for i in idx]
            host = (
                padded_codes(qs_l, qmax), padded_codes(ts_l, tmax),
                lengths(qs_l), lengths(ts_l),
                np.fromiter((problems[i][2] for i in idx), np.int32, len(idx)),
            )
            yield idx, qmax, tmax, self.params_on[dev], [put(x, dev) for x in host]

    def _scores(self, problems) -> np.ndarray:
        out = np.empty(len(problems), np.int64)
        pending = []
        for idx, qmax, tmax, p, args in self._chunks(problems, self.CHUNK):
            pending.append((idx, qmax, tmax, global_score(*args, p.mat, **p.gaps())))
        for idx, qmax, tmax, score in pending:
            with TIMERS.span("fetch", family="global", qmax=qmax, tmax=tmax):
                out[idx] = score.cpu().numpy()
        return out

    def _traceback_on_device(self, problems):
        """(score, cigar) for gapped problems: K3's direction bytes and the
        K4 walk on the device; only the op stream reaches the host."""
        pending = []
        for idx, qmax, tmax, p, args in self._chunks(problems, self.CHUNK_Z):
            _, _, qlens, tlens, ws = args
            score, z = global_z(*args, p.mat, **p.gaps())
            ops, fi, fk = traceback(z, qlens, tlens, ws, max_steps=qmax + tmax)
            pending.append((idx, qmax, tmax, torch.stack([score, fi, fk]), ops))
        results: List[Optional[Tuple[int, List[Tuple[int, int]]]]] = [None] * len(problems)
        for idx, qmax, tmax, meta, ops in pending:
            with TIMERS.span("fetch", family="traceback", qmax=qmax, tmax=tmax):
                meta_h = meta.cpu().numpy()
                ops_h = ops.cpu().numpy()
            for c, i in enumerate(idx):
                cig = decode_traceback_ops(ops_h[:, c], int(meta_h[1, c]), int(meta_h[2, c]))
                results[i] = (int(meta_h[0, c]), cig)
        return results

    def run(self, want_cigar: bool = True):
        """Two-phase: score-only first; full traceback only for problems
        whose optimum is not provably the all-M alignment.

        If rlen == qlen and the global score equals the no-gap score
        sum(mat[t, q]), the traceback is exactly [(M, qlen)] (the
        reference's BatchGlobal.run explains why); length-mismatched
        problems go straight to the traceback."""
        global traceback_fetches
        if not self.problems:
            return []
        problems = self.problems
        self.reset()
        out: List[Optional[Tuple[int, Optional[List[Tuple[int, int]]]]]] = [None] * len(problems)
        need_tb = []
        screened = [
            i for i, (q, t, w) in enumerate(problems) if not want_cigar or len(q) == len(t)
        ]
        if screened:
            score = self._scores([problems[i] for i in screened])
            for k, i in enumerate(screened):
                q, t, w = problems[i]
                sc = int(score[k])
                if not want_cigar:
                    out[i] = (sc, None)
                elif sc == int(self.mat_np[t, q].sum()):
                    out[i] = (sc, [(0, len(q))])
                else:
                    need_tb.append(i)
        if want_cigar:
            need_tb += [i for i, (q, t, w) in enumerate(problems) if len(q) != len(t)]
            need_tb.sort()
        if need_tb:
            with _fetch_lock:
                traceback_fetches += len(need_tb)
            for k, res in zip(need_tb, self._traceback_on_device([problems[i] for i in need_tb])):
                out[k] = res
        return out
