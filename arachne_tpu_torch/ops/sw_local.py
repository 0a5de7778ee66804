"""Batched local Smith-Waterman for mate rescue (ksw_align2, ksw.c:111-365).

``local_sw_batch_torch`` and ``score2_scan_torch`` are the plain PyTorch
versions of the reference's XLA ``local_sw_batch_kernel`` and
``score2_scan`` (arachne_tpu/ops/sw_local.py), with the same outputs and
the same (tmax, B) row-max layout; ``local_sw_full_torch`` chains them as
kernel K2 (csrc/local.cu) fuses them.  ``local_sw_full`` is K2's wrapper:
the plain version for CPU tensors, the kernel for CUDA tensors.

``BatchLocalSW`` runs ksw_align2's forward pass and its reverse pass for
(qb, tb), each as one batch.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..align.ksw import KswResult
from ..config import MemOptions
from ..runtime.timers import TIMERS

from .cuda_local import local_cuda
from .devicepool import dispatch_devices, put
from .params import ParamsByDevice
from .sw_extend import bucket64, lengths, padded_codes

NEVER = 0x10000  # an endsc / minsc no score reaches


def local_sw_batch_torch(qs, ts, qlens, tlens, endscs, mat, *, o_del, e_del, o_ins, e_ins):
    """Forward local SW.  Returns (gmax, te, qe, row_max) with row_max
    (tmax, B) int32, zero for rows a lane never ran."""
    dev = qs.device
    B, qmax = qs.shape
    tmax = ts.shape[1]
    i32 = torch.int32
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qlens, tlens, endscs = (x.to(dev, i32) for x in (qlens, tlens, endscs))
    mat = mat.to(dev, i32)
    qi = qs.long()
    jidx = torch.arange(qmax, dtype=i32, device=dev)[None, :]
    valid_q = jidx < qlens[:, None]
    H = torch.zeros((B, qmax), dtype=i32, device=dev)
    E = torch.zeros_like(H)
    Hmax = torch.zeros_like(H)
    gmax = torch.zeros(B, dtype=i32, device=dev)
    te = torch.full((B,), -1, dtype=i32, device=dev)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    row_max = torch.zeros((tmax, B), dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    n_rows = min(tmax, int(tlens.max())) if B else 0
    for i in range(n_rows):
        in_t = i < tlens
        row_live = alive & in_t
        if i % 32 == 0 and not bool(row_live.any()):
            break
        tcode = torch.where(in_t, ts[:, i].long(), 4)
        q_row = mat[tcode[:, None], qi]
        Hdiag = torch.cat([zcol, H[:, :-1]], dim=1)
        Hpre = torch.where(valid_q, torch.maximum((Hdiag + q_row).clamp_min(0), E), 0)
        # F scan: F(0)=0; F(j)=max(0, F(j-1)-e_ins, Hpre(j-1)-oe_ins)
        run = torch.cummax((Hpre - oe_ins) + jidx * e_ins, dim=1).values
        F = torch.zeros_like(Hpre)
        F[:, 1:] = (run[:, :-1] - (jidx[:, 1:] - 1) * e_ins).clamp_min(0)
        Hn = torch.where(valid_q, torch.maximum(Hpre, F), 0)
        En = torch.where(valid_q, torch.maximum(E - e_del, Hn - oe_del).clamp_min(0), 0)
        imax = Hn.max(dim=1).values
        upd = row_live & (imax > gmax)
        gmax = torch.where(upd, imax, gmax)
        te = torch.where(upd, i, te)
        Hmax = torch.where(upd[:, None], Hn, Hmax)
        # early stop AFTER recording this row (ksw.c:205)
        die = upd & (gmax >= endscs)
        row_max[i] = torch.where(row_live, imax, 0)
        keep = row_live[:, None]
        H = torch.where(keep, Hn, H)
        E = torch.where(keep, En, E)
        alive = alive & ~die
    # qe: smallest query index achieving the Hmax row's max
    col_max = Hmax.max(dim=1).values
    qe = torch.where(Hmax == col_max[:, None], jidx, 1 << 30).min(dim=1).values
    qe = torch.where(col_max > 0, qe, -1)
    return gmax, te, qe, row_max


def score2_scan_torch(row_max, tlens, gmax, te, minscs, max_mat: int):
    """The b-array second best (ksw.c:192-227) as one scan over target
    rows, vectorized across the batch; the reference's score2_scan, whose
    docstring explains the one-row-memory merge automaton."""
    tmax, B = row_max.shape
    dev = row_max.device
    i32 = torch.int32
    tlens, gmax, te, minscs = (x.to(dev, i32) for x in (tlens, gmax, te, minscs))
    rng = torch.div(gmax + max_mat - 1, max_mat, rounding_mode="floor")
    low, high = te - rng, te + rng
    qual_prev = torch.zeros(B, dtype=torch.bool, device=dev)
    absorb_prev = torch.zeros_like(qual_prev)
    open_ = torch.zeros_like(qual_prev)
    ent_val = torch.zeros(B, dtype=i32, device=dev)
    ent_row = torch.full((B,), -1, dtype=i32, device=dev)
    best2 = ent_row.clone()
    te2 = ent_row.clone()

    def emit(best2, te2, do):
        better = do & ((ent_row < low) | (ent_row > high)) & (ent_val > best2)
        return torch.where(better, ent_val, best2), torch.where(better, ent_row, te2)

    # rows at or past every lane's tlen never qualify: stop there
    n_rows = min(tmax, int(tlens.max())) if B else 0
    for i in range(n_rows):
        v = row_max[i]
        qual = (v >= minscs) & (i < tlens)
        start = qual & (~qual_prev | absorb_prev)
        cont = qual & qual_prev & ~absorb_prev
        improve = cont & (v > ent_val)
        # a new entry supersedes the open one -> the old entry is final
        best2, te2 = emit(best2, te2, start & open_)
        upd = start | improve
        ent_val = torch.where(upd, v, ent_val)
        ent_row = torch.where(upd, i, ent_row)
        open_ = open_ | start
        qual_prev = qual
        absorb_prev = cont & ~improve
    return emit(best2, te2, open_)


def local_sw_full_torch(qs, ts, qlens, tlens, endscs, minscs, mat, *, o_del, e_del, o_ins, e_ins, max_mat):
    """Plain version of K2: (5, B) int32 (gmax, te, qe, score2, te2)."""
    gmax, te, qe, row_max = local_sw_batch_torch(
        qs, ts, qlens, tlens, endscs, mat, o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins
    )
    s2, t2 = score2_scan_torch(row_max, tlens, gmax, te, minscs, max_mat)
    return torch.stack([gmax, te, qe, s2, t2])


def local_sw_full(qs, ts, qlens, tlens, endscs, minscs, mat, **kw):
    """K2's wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (which launches or raises)."""
    if qs.device.type == "cpu":
        return local_sw_full_torch(qs, ts, qlens, tlens, endscs, minscs, mat, **kw)
    return local_cuda(qs, ts, qlens, tlens, endscs, minscs, mat, **kw)


class BatchLocalSW:
    """Batched ksw_align2: forward pass + reverse pass for coordinates."""

    CHUNK = 1024  # problems per launch
    QMAX, TMAX = 192, 768  # width floors, as in BatchExtender

    def __init__(self, opt: MemOptions, device: torch.device):
        self.opt = opt
        self.device = torch.device(device)
        self.params_on = ParamsByDevice(opt)
        self.reset()

    def reset(self):
        self.problems: List[Tuple[np.ndarray, np.ndarray, int]] = []

    def submit(self, query: np.ndarray, target: np.ndarray, minsc: int) -> int:
        self.problems.append((query, target, minsc))
        return len(self.problems) - 1

    def _run_kernel(self, qs_list, ts_list, endscs, minscs):
        """Dispatch problems; returns (5, B) int64 numpy rows
        (gmax, te, qe, score2, te2) in input order."""
        B = len(qs_list)
        qmax = bucket64(max(len(q) for q in qs_list), self.QMAX)
        tmax = bucket64(max(len(t) for t in ts_list), self.TMAX)
        order = sorted(range(B), key=lambda i: len(ts_list[i]))
        qs_list = [qs_list[i] for i in order]
        ts_list = [ts_list[i] for i in order]
        endscs = np.asarray(endscs, np.int32)[order]
        minscs = np.asarray(minscs, np.int32)[order]
        devs = dispatch_devices(self.device)
        pending = []
        for ci, c0 in enumerate(range(0, B, self.CHUNK)):
            c1 = min(c0 + self.CHUNK, B)
            dev = devs[ci % len(devs)]
            p = self.params_on[dev]
            host = (
                padded_codes(qs_list[c0:c1], qmax), padded_codes(ts_list[c0:c1], tmax),
                lengths(qs_list[c0:c1]), lengths(ts_list[c0:c1]),
                endscs[c0:c1], minscs[c0:c1],
            )
            args = [put(x, dev) for x in host]
            pending.append(local_sw_full(*args, p.mat, **p.gaps(), max_mat=p.max_mat))
        parts = []
        for out in pending:
            with TIMERS.span("fetch", family="local", qmax=qmax, tmax=tmax):
                parts.append(out.cpu().numpy())
        merged = np.concatenate(parts, axis=1)
        inv = np.empty(B, np.int64)
        inv[np.asarray(order)] = np.arange(B)
        return merged[:, inv]

    def run_align2(self) -> List[KswResult]:
        """Full ksw_align2 semantics (XSUBO|XSTART) for all problems."""
        if not self.problems:
            return []
        problems = self.problems
        self.reset()
        gmax, te, qe, score2, te2 = self._run_kernel(
            [p[0] for p in problems], [p[1] for p in problems],
            [NEVER] * len(problems), [p[2] for p in problems],
        )
        results = []
        rev_q, rev_t, rev_stop, rev_ids = [], [], [], []
        for i, (q, t, minsc) in enumerate(problems):
            r = KswResult()
            r.score = int(gmax[i])
            r.te = int(te[i])
            r.qe = int(qe[i])
            r.score2 = int(score2[i])
            r.te2 = int(te2[i])
            results.append(r)
            if r.score >= minsc and r.qe >= 0 and r.te >= 0:
                rev_q.append(q[: r.qe + 1][::-1].copy())
                rev_t.append(t[: r.te + 1][::-1].copy())
                rev_stop.append(r.score)
                rev_ids.append(i)
        if rev_ids:
            g2, t2, q2, _, _ = self._run_kernel(rev_q, rev_t, rev_stop, [NEVER] * len(rev_ids))
            for k, i in enumerate(rev_ids):
                r = results[i]
                if int(g2[k]) == r.score:
                    r.tb = r.te - int(t2[k])
                    r.qb = r.qe - int(q2[k])
        return results
