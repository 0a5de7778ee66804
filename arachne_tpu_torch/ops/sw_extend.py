"""Batched banded seed extension (ksw_extend2, ksw.c:380-479).

``extend_batch_torch`` is the plain PyTorch version, written step for step
from the reference's XLA formulation (arachne_tpu/ops/sw_extend.py::
extend_batch_kernel): ``lax.cummax`` becomes ``torch.cummax`` and the
``fori_loop`` over target rows a Python loop, which stops at the batch's
longest live target (dead and finished lanes never update state, so the
outputs are the same).  Layout: problems on dim 0, query positions on
dim 1.

``extend_batch`` is the kernel wrapper: the plain version for CPU tensors,
kernel K1 (csrc/extend.cu) for CUDA tensors, nothing else.
``BatchExtender`` pads, sorts and chunks submitted problems for it.

``wide_state=False`` is the reference's int16 DP state
(pallas_extend.py's ``sdt=jnp.int16``): H, E, M, u and the running max in
int16, every per-problem scalar and the row reductions in int32, the same
outputs wherever ``int16_state_fits`` proves the range; both wrappers
raise where it does not.  The batcher keeps int32, as the reference's
dispatcher does.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import MemOptions
from ..runtime.timers import TIMERS

from .cuda_extend import extend_cuda
from .devicepool import dispatch_devices, put
from .params import ParamsByDevice


INT16_MAX = (1 << 15) - 1
# the reference's int16 identity of its prefix-max scan (pallas_extend.py,
# ``NEG_S``)
INT16_SCAN_IDENT = -(1 << 13)


def int16_max_h0(qmax: int, mat, e_ins: int, *, o_del: int, e_del: int, o_ins: int) -> int:
    """The largest max(h0) for which ``int16_state_fits`` holds at these
    widths and scores (-1 where none does).  ``mat`` is the (5, 5) scoring
    matrix, on the host or on a device (read once per tensor: see
    ``matrix_range``)."""
    lo, hi = matrix_range(mat)
    a = max(hi, 0)
    lowest = min(min(lo, 0) - max(o_del + e_del, o_ins + e_ins), -2 * e_ins,
                 INT16_SCAN_IDENT - (qmax - 1) * e_ins)
    if lowest < -(1 << 15):
        return -1
    return INT16_MAX - a * qmax - qmax * e_ins


def int16_state_fits(max_h0: int, qmax: int, mat, e_ins: int, *, o_del: int, e_del: int,
                     o_ins: int) -> bool:
    """Does every value of the int16 DP state stay within int16, for every
    h0 in [0, max_h0] (h0 is a seed's score: never negative), qmax query
    columns, gap penalties >= 0 and the scores of ``mat`` (at most a =
    max(mat, 0), at least min(mat))?  The bound follows the recurrences as
    the reference's ``_extend_kernel`` computes them, row i, column j < qmax:

      - H(-1, j) = max(h0 - oe_ins - j*e_ins, 0) <= h0, the column -1 boundary
        <= h0, M(i, j) = H(i-1, j-1) + s, E <= max(M) - oe_del and F <= max(u)
        <= max(M), so by induction over j, M(i, j) and H(i, j) <=
        h0 + a*(j + 1): every H <= max_h0 + a*qmax;
      - the scan input u(j) + j*e_ins <= H + qmax*e_ins, and so is its prefix
        max;
      - the lowest values are M - oe (M >= min(mat, 0), as H >= 0), F - 2*e_ins
        (the kernel steps F two columns at a time) and the scan's identity
        ``NEG_S`` = -2^13, less (qmax - 1)*e_ins in ``Fv``.

    So it holds iff

      max_h0 + a*qmax + qmax*e_ins <= 2^15 - 1, and
      min(min(mat, 0) - max(o_del + e_del, o_ins + e_ins), -2*e_ins,
          -2^13 - (qmax - 1)*e_ins) >= -2^15.

    At the main path's shapes (``MemOptions``: a = 1, b = 4, gaps 6 + 1,
    e_ins 1; qmax 192, up to 1024 for reads that long; h0 a seed's score,
    at most the read's length) the largest max_h0 it accepts is 32,383 at
    qmax 192 and 30,719 at qmax 1024, against h0 <= 150 for 150 bp reads;
    the lower side reaches -(2^13 + 1023) = -9,215 of -32,768."""
    return 0 <= max_h0 <= int16_max_h0(qmax, mat, e_ins, o_del=o_del, e_del=e_del, o_ins=o_ins)


def matrix_range(mat) -> tuple:
    """(min, max) of a scoring matrix: a numpy array, a list or a tensor.  A
    tensor's pair is kept on it, keyed by its version counter, so that a
    card's matrix is read (a synchronisation) once, not at every launch."""
    if not isinstance(mat, torch.Tensor):
        m = np.asarray(mat)
        return int(m.min()), int(m.max())
    kept = getattr(mat, "_arachne_range", None)
    if kept is None or kept[0] != mat._version:
        host = mat.detach().cpu()
        kept = (mat._version, int(host.min()), int(host.max()))
        mat._arachne_range = kept
    return kept[1:]


def require_int16_state(name, h0s, max_h0: Optional[int], qmax: int, mat, *, o_del, e_del,
                        o_ins, e_ins) -> None:
    """Raise ValueError unless ``int16_state_fits`` holds.  ``max_h0`` is the
    caller's bound on every h0 (and its promise that none is negative);
    without it the h0s are read, which on a card is a synchronisation."""
    if max_h0 is None:
        lo, hi = (int(x) for x in torch.aminmax(h0s)) if h0s.numel() else (0, 0)
        if lo < 0:
            raise ValueError(f"{name}: int16 DP state needs h0 >= 0 (min h0 {lo})")
        max_h0 = hi
    if not int16_state_fits(max_h0, qmax, mat, e_ins, o_del=o_del, e_del=e_del, o_ins=o_ins):
        top = int16_max_h0(qmax, mat, e_ins, o_del=o_del, e_del=e_del, o_ins=o_ins)
        raise ValueError(f"{name}: int16 DP state cannot be proven to fit at max h0 {max_h0}, "
                         f"qmax {qmax} (largest max h0 it can hold here: {top}); use "
                         "wide_state=True")


def extend_batch_torch(qs, ts, qlens, tlens, ws, h0s, mat, *, o_del, e_del, o_ins, e_ins, zdrop,
                       stats=None, wide_state=True, max_h0=None, count_cells=False):
    """Plain version of K1.  qs (B, qmax) / ts (B, tmax) codes 0..4, the
    rest (B,) int32, mat (5, 5) int32, all on one device.  Returns (6, B)
    int32: maxv, qle, tle, gtle, gscore, max_off.  The DP cells these
    inputs need are the in-band cells of every row a problem reaches before
    it dies or ends: with a dict ``stats`` their sum is added to
    ``stats["cells"]``, and ``count_cells`` adds a seventh row, each
    problem's (K1's counter).
    ``wide_state=False`` keeps H, E, M, u and the running max in int16 (the
    per-problem scalars and the row reductions stay int32), after
    ``require_int16_state`` with ``max_h0``."""
    dev = qs.device
    B, qmax = qs.shape
    i32 = torch.int32
    sdt = i32 if wide_state else torch.int16
    if not wide_state:
        require_int16_state("extend_batch_torch", h0s, max_h0, qmax, mat, o_del=o_del,
                            e_del=e_del, o_ins=o_ins, e_ins=e_ins)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    qlens, tlens, ws, h0s = (x.to(dev, i32) for x in (qlens, tlens, ws, h0s))
    mat = mat.to(dev, i32)
    qi = qs.long()
    jidx = torch.arange(qmax, dtype=i32, device=dev)[None, :]
    jidx_s = jidx.to(sdt)
    valid_q = jidx < qlens[:, None]

    # H(-1, j) = max(h0 - oe_ins - j*e_ins, 0) inside the query
    H = torch.where(valid_q, (h0s[:, None] - oe_ins - jidx * e_ins).clamp_min(0), 0).to(sdt)
    E = torch.zeros_like(H)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    end = qlens.clone()
    maxv = h0s.clone()
    max_i = torch.full((B,), -1, dtype=i32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros(B, dtype=i32, device=dev)
    slot_idx = torch.arange(qmax + 1, dtype=i32, device=dev)[None, :]
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    counting = stats is not None or count_cells
    cells = torch.zeros(B, dtype=i32, device=dev)
    n_rows = min(ts.shape[1], int(tlens.max())) if B else 0
    for i in range(n_rows):
        in_t = i < tlens
        row_live = alive & in_t
        if i % 32 == 0 and not bool(row_live.any()):
            break
        tcode = torch.where(in_t, ts[:, i].long(), 4)
        q_row = mat[tcode[:, None], qi].to(sdt)
        # adaptive end (ksw.c:417-418,468-469)
        end_used = torch.minimum(torch.minimum(end, i + ws + 1), qlens)
        in_band = (jidx >= (i - ws)[:, None]) & (jidx < end_used[:, None]) & valid_q
        h1_init = torch.where(
            i - ws <= 0, (h0s - (o_del + e_del * (i + 1))).clamp_min(0), 0
        )
        # H(i-1, -1): h0 on the first row, else the first-column boundary
        if i == 0:
            bound_prev = h0s
        else:
            bound_prev = torch.where(
                (i - 1) - ws <= 0, (h0s - (o_del + e_del * i)).clamp_min(0), 0
            )
        Hdiag = torch.cat([bound_prev[:, None].to(sdt), H[:, :-1]], dim=1)
        M = torch.where(Hdiag != 0, Hdiag + q_row, 0)       # the M-zero quirk
        u = (M - oe_ins).clamp_min(0)
        run = torch.cummax(u + jidx_s * e_ins, dim=1).values
        F = torch.zeros_like(M)
        F[:, 1:] = (run[:, :-1] - (jidx_s[:, 1:] - 1) * e_ins).clamp_min(0)
        if counting:
            cells += (in_band & row_live[:, None]).sum(dim=1, dtype=i32)
        Hs = torch.where(in_band, torch.maximum(torch.maximum(M, E), F), 0)
        Es = torch.where(in_band, torch.maximum(E - e_del, (M - oe_del).clamp_min(0)), 0)
        # the row's reductions in int32
        Hn, En = Hs.to(i32), Es.to(i32)

        m = Hn.max(dim=1).values
        # mj: largest j attaining m (ties -> later j, ksw.c:437)
        is_max = (Hn == m[:, None]) & in_band
        mj = torch.where(is_max, jidx, -1).max(dim=1).values

        # gscore: the window reached the end of the query this row
        ends_q = (end_used == qlens) & in_t & row_live
        h_last = Hn.gather(1, (qlens - 1).clamp_min(0).long()[:, None])[:, 0]
        # ksw.c:451-452: max_ie updates on ties (gscore > h1 keeps old)
        max_ie = torch.where(ends_q & ~(gscore > h_last), i, max_ie)
        gscore = torch.where(ends_q, torch.maximum(gscore, h_last), gscore)

        improved = m > maxv
        diag_i = i - max_i
        diag_j = mj - max_j
        if zdrop > 0:
            drop_del = maxv - m - (diag_i - diag_j) * e_del > zdrop
            drop_ins = maxv - m - (diag_j - diag_i) * e_ins > zdrop
            zdropped = torch.where(diag_i > diag_j, drop_del, drop_ins)
        else:
            zdropped = torch.zeros_like(improved)
        die = row_live & ((m == 0) | (~improved & zdropped))

        upd = row_live & improved
        maxv = torch.where(upd, m, maxv)
        max_i = torch.where(upd, i, max_i)
        max_j = torch.where(upd, mj, max_j)
        max_off = torch.where(upd, torch.maximum(max_off, (mj - i).abs()), max_off)

        # adaptive end update: slot s holds H(i, s-1) and E(i+1, s)
        slot_h = torch.cat([h1_init[:, None], Hn], dim=1)
        slot_e = torch.cat([En, zcol], dim=1)
        nonzero = ((slot_h != 0) | (slot_e != 0)) & (slot_idx <= end_used[:, None])
        jstar = torch.where(nonzero, slot_idx, -1).max(dim=1).values
        end = torch.where(row_live & ~die, torch.minimum(jstar + 2, qlens), end)

        keep = row_live[:, None]
        H = torch.where(keep, Hs, H)
        E = torch.where(keep, Es, E)
        alive = alive & ~die
    if stats is not None:
        stats["cells"] = stats.get("cells", 0) + int(cells.sum())
    rows = [maxv, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off]
    return torch.stack(rows + [cells] if count_cells else rows)


def extend_batch(qs, ts, qlens, tlens, ws, h0s, mat, **kw):
    """K1's wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (which launches or raises).  ``wide_state`` (default True)
    and ``max_h0`` pass on to either; with ``wide_state=False`` both raise
    ValueError where ``int16_state_fits`` does not hold."""
    if qs.device.type == "cpu":
        return extend_batch_torch(qs, ts, qlens, tlens, ws, h0s, mat, **kw)
    return extend_cuda(qs, ts, qlens, tlens, ws, h0s, mat, **kw)


def clamp_band(opt: MemOptions, qlen: int, w: int, end_bonus: int, max_mat: int) -> int:
    """The per-problem w clamp at the top of ksw_extend2 (ksw.c:399-407)."""
    max_ins = int((qlen * max_mat + end_bonus - opt.o_ins) / opt.e_ins + 1.0)
    w = min(w, max(max_ins, 1))
    max_del = int((qlen * max_mat + end_bonus - opt.o_del) / opt.e_del + 1.0)
    return min(w, max(max_del, 1))


def bucket64(n: int, floor: int) -> int:
    """Padded width: ``floor``, or ``n`` rounded up to a multiple of 64."""
    return max(floor, -(-n // 64) * 64)


def padded_codes(seqs: List[np.ndarray], width: int) -> np.ndarray:
    """(len(seqs), width) int8 codes, padded with N (4)."""
    out = np.full((len(seqs), width), 4, np.int8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out


def lengths(seqs: List[np.ndarray]) -> np.ndarray:
    return np.fromiter((len(s) for s in seqs), np.int32, len(seqs))


class BatchExtender:
    """Pads and dispatches extension problems to K1 (or its plain version
    on the CPU).

    Call ``submit`` repeatedly, then ``run`` to execute the whole batch;
    results come back as ksw_extend2 6-tuples in submission order."""

    CHUNK = 4096  # problems per launch
    # width floors: what 150 bp reads give, so every wave of a run has the
    # one shape that chip_smoke.py checks; longer inputs widen it
    QMAX, TMAX = 192, 512

    def __init__(self, opt: MemOptions, device: torch.device):
        self.opt = opt
        self.device = torch.device(device)
        self.params_on = ParamsByDevice(opt)
        self.params = self.params_on[self.device]
        self.reset()

    def reset(self):
        self.queries = []
        self.targets = []
        self.ws = []
        self.h0s = []

    def submit(self, query: np.ndarray, target: np.ndarray, w: int, end_bonus: int, h0: int) -> int:
        w = clamp_band(self.opt, len(query), w, end_bonus, self.params.max_mat)
        self.queries.append(query)
        self.targets.append(target)
        self.ws.append(w)
        self.h0s.append(h0)
        return len(self.queries) - 1

    def run(self):
        B = len(self.queries)
        if B == 0:
            return []
        qmax = bucket64(max(len(q) for q in self.queries), self.QMAX)
        tmax = bucket64(max(len(t) for t in self.targets), self.TMAX)
        # sort by target length: a chunk's plain row loop stops at its own
        # longest target; results are unsorted back to submission order
        order = sorted(range(B), key=lambda i: len(self.targets[i]))
        queries = [self.queries[i] for i in order]
        targets = [self.targets[i] for i in order]
        ws = np.asarray(self.ws, np.int32)[order]
        h0s = np.asarray(self.h0s, np.int32)[order]
        self.reset()
        devs = dispatch_devices(self.device)
        pending = []
        for ci, c0 in enumerate(range(0, B, self.CHUNK)):
            c1 = min(c0 + self.CHUNK, B)
            dev = devs[ci % len(devs)]
            p = self.params_on[dev]
            host = (
                padded_codes(queries[c0:c1], qmax), padded_codes(targets[c0:c1], tmax),
                lengths(queries[c0:c1]), lengths(targets[c0:c1]), ws[c0:c1], h0s[c0:c1],
            )
            args = [put(x, dev) for x in host]
            # traced, K1 counts its cells into a seventh row of its output,
            # fetched with it and put on its launch span
            count = TIMERS.tracing and dev.type == "cuda"
            out = extend_batch(*args, p.mat, **p.gaps(), zdrop=p.zdrop, count_cells=count)
            pending.append((out, TIMERS.take_launch()))
        results = []
        for out, launch in pending:
            with TIMERS.span("fetch", family="extend", qmax=qmax, tmax=tmax):
                arr = out.cpu().numpy()
            if launch is not None and len(arr) > 6:
                launch.attrs["cells"] = int(arr[6].sum())
            results.extend(map(tuple, arr[:6].T.tolist()))
        unsorted = [None] * B
        for k, i in enumerate(order):
            unsorted[i] = results[k]
        return unsorted
