"""Device-side SMEM seeding: the three-pass seed collection on the device.

The port of arachne_tpu/ops/fm_seed.py.  Pass 1 follows each read's pivot
chain with bwt_smem1a sweeps, pass 2 re-seeds long SMEMs with one sweep per
(pivot, min_intv) job, pass 3 is bwt_seed_strategy1 (bwamem.c:114-162).
``smem_pass_torch`` and ``pass3_torch`` are the plain versions: the
reference's lockstep while-loops translated op for op, where every read
advances one step per iteration.  ``smem_pass`` and ``pass3`` are the
wrappers of kernels S1 and S3 (csrc/seed.cu), which run one read per thread
and must write exactly what the lockstep versions write.

Fixed-size buffers replace the reference's growable vectors:
  * MAXC: carried intervals per sweep (curr/prev, bwt.c:304-345);
  * MAXS: SMEMs recorded per read per pass.
A read that overflows one is flagged.  ``collect_seeds_device_flat`` sizes
them by ``seed_buffers`` so that no read can overflow; reads that overflow
smaller buffers a caller asks for are redone on the same device at that
size, counted in ``overflow_redos`` and timed as the stage
``seed.device.redo``.  Its output is always the scalar collector's, as one
``SeedBatch`` of flat rows built from the kernels' output buffers with
numpy, no loop over reads or jobs: the native chainer takes it as it is
(align/chain_native.py ``mem_chain_flat_native``).  ``collect_seeds_device``
gives the same seeds as per-read SMEM lists.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..align.smem import SMEM
from ..config import MemOptions
from ..runtime.timers import TIMERS

from .cuda_seed import pass3_cuda, pass3_sharded_cuda, smem_pass_cuda, smem_pass_sharded_cuda
from .fm_rank import RankTables, ShardedFMIndex, extend_torch

# reads redone at ``seed_buffers`` size after overflowing a caller's
# smaller buffers (process-wide; worker threads seed concurrently)
overflow_redos = 0
_redo_lock = threading.Lock()

# phases
PH_PIVOT = 0   # looking for the next pivot (skip Ns / check end)
PH_FWD = 1     # forward sweep
PH_BACK = 2    # backward sweep
PH_DONE = 3


def _pick(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[r, idx[r]] for every row r."""
    return a.gather(1, idx.long()[:, None])[:, 0]


def _codes(qsT: torch.Tensor, qlens: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q[x] per read, 4 (N) outside [0, qlen)."""
    L = qsT.shape[1]
    code = _pick(qsT, x.clamp(0, L - 1))
    return torch.where((x >= 0) & (x < qlens), code, 4)


def _put(buf: torch.Tensor, slot: torch.Tensor, do: torch.Tensor, item: torch.Tensor):
    """buf[r, slot[r]] = item[r] where do[r] (a one-hot masked write)."""
    cols = torch.arange(buf.shape[1], device=buf.device)
    upd = (cols[None, :] == slot[:, None]) & do[:, None]
    return torch.where(upd[:, :, None], item[:, None, :], buf)


def smem_pass_torch(fm: RankTables, qs, qlens, pivots0, min_intvs, single_sweep: bool,
                    MAXC: int, MAXS: int, stats=None, count_rows=False):
    """Plain version of S1 (the reference's _smem_pass_program): qs (R, L)
    int8 codes, qlens / pivots0 / min_intvs (R,).  Returns out (R, MAXS, 5)
    of (k, l, s, qb, qe), out_n (R,) and overflow (R,) bool.  The occ4 rows
    the reads need are two per forward step of a live read and per interval
    a backward step extends: with a dict ``stats`` their sum is added to
    ``stats["rank_rows"]``, and ``count_rows`` makes out_n (2, R), its
    second row each read's (S1's counter)."""
    I = fm.idt
    dev = qs.device
    R, L = qs.shape
    qsT = qs.to(I)
    qlens = qlens.to(I)
    min_intvs = min_intvs.to(I)
    L2 = fm.L2
    arC = torch.arange(MAXC, device=dev)

    phase = torch.full((R,), PH_PIVOT, dtype=I, device=dev)
    x = pivots0.to(I)
    i = torch.zeros(R, dtype=I, device=dev)
    ik = torch.zeros((R, 4), dtype=I, device=dev)            # k, l, s, info
    curr = torch.zeros((R, MAXC, 4), dtype=I, device=dev)
    curr_n = torch.zeros(R, dtype=I, device=dev)
    prev = torch.zeros((R, MAXC, 4), dtype=I, device=dev)
    prev_n = torch.zeros(R, dtype=I, device=dev)
    sweep_mem = torch.zeros((R, MAXS, 5), dtype=I, device=dev)  # qb descending
    sweep_n = torch.zeros(R, dtype=I, device=dev)
    out = torch.zeros((R, MAXS, 5), dtype=I, device=dev)
    out_n = torch.zeros(R, dtype=I, device=dev)
    overflow = torch.zeros(R, dtype=torch.bool, device=dev)
    counting = stats is not None or count_rows
    rows = torch.zeros(R, dtype=I, device=dev)
    pivot_keep = pivots0.to(I)

    def push_curr(curr, curr_n, overflow, do, item):
        ovf = do & (curr_n >= MAXC)
        ok = do & ~ovf
        curr = _put(curr, curr_n.clamp(0, MAXC - 1), ok, item)
        return curr, torch.where(ok, curr_n + 1, curr_n), overflow | ovf

    steps = 0
    while steps < 16 * L + 64 and bool((phase != PH_DONE).any()):
        in_pivot = phase == PH_PIVOT
        pivot_keep = torch.where(in_pivot, x, pivot_keep)

        # ---- PH_PIVOT: find the next pivot / finish the read ----
        c_at_x = _codes(qsT, qlens, x)
        past_end = x >= qlens
        is_n = (c_at_x >= 4) & ~past_end
        phase = torch.where(in_pivot & past_end, PH_DONE, phase)
        x = torch.where(in_pivot & is_n, x + 1, x)
        ready = in_pivot & ~past_end & ~is_n
        c = _codes(qsT, qlens, x).clamp(0, 3).long()
        ik0 = torch.stack([L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c], x + 1], dim=1)
        ik = torch.where(ready[:, None], ik0, ik)
        i = torch.where(ready, x + 1, i)
        curr_n = torch.where(ready, 0, curr_n)
        sweep_n = torch.where(ready, 0, sweep_n)
        phase = torch.where(ready, PH_FWD, phase)

        # ---- PH_FWD: one forward step ----
        in_fwd = phase == PH_FWD
        ci = _codes(qsT, qlens, i)
        terminal = in_fwd & ((i >= qlens) | (ci >= 4))
        live_f = in_fwd & ~terminal
        comp = 3 - ci.clamp(0, 3)
        o0, o1, osz = extend_torch(fm, ik[:, 0], ik[:, 1], ik[:, 2], is_back=False)
        n0, n1, ns = _pick(o0, comp), _pick(o1, comp), _pick(osz, comp)
        if counting:
            rows += 2 * live_f
        changed = live_f & (ns != ik[:, 2])
        curr, curr_n, overflow = push_curr(curr, curr_n, overflow, changed | terminal, ik)
        too_small = changed & (ns < min_intvs)
        advance = live_f & ~too_small
        ik = torch.where(advance[:, None], torch.stack([n0, n1, ns, i + 1], dim=1), ik)
        i = torch.where(advance, i + 1, i)
        hit_len = advance & (i >= qlens)   # reached the end: push the final interval
        curr, curr_n, overflow = push_curr(curr, curr_n, overflow, hit_len, ik)
        to_back = terminal | too_small | hit_len
        # prev = curr reversed; the next pivot is the last push's info
        ret = _pick(curr[:, :, 3], (curr_n - 1).clamp(0, MAXC - 1))
        rev_idx = (curr_n[:, None] - 1 - arC[None, :]).clamp(0, MAXC - 1)
        prev_rev = curr.gather(1, rev_idx.long()[:, :, None].expand(R, MAXC, 4))
        prev = torch.where(to_back[:, None, None], prev_rev, prev)
        prev_n = torch.where(to_back, curr_n, prev_n)
        x = torch.where(to_back, ret, x)
        phase = torch.where(to_back, PH_BACK, phase)
        i = torch.where(to_back, pivot_keep - 1, i)

        # ---- PH_BACK: one backward step over all carried intervals ----
        in_back = phase == PH_BACK
        cb = _codes(qsT, qlens, i)
        c_ok = in_back & (i >= 0) & (cb < 4)
        if counting:
            rows += 2 * torch.where(c_ok, prev_n, 0)
        # items past every read's prev_n change nothing: extend and scan the
        # first m only
        m = min(MAXC, int(torch.where(in_back, prev_n, 0).max()))
        b0, b1, bs = extend_torch(
            fm, prev[:, :m, 0].reshape(-1), prev[:, :m, 1].reshape(-1),
            prev[:, :m, 2].reshape(-1).clamp_min(0), is_back=True,
        )
        sel = cb.clamp(0, 3).long()[:, None].expand(R, m).reshape(-1, 1)
        nb0 = b0.gather(1, sel).reshape(R, m)
        nb1 = b1.gather(1, sel).reshape(R, m)
        nbs = bs.gather(1, sel).reshape(R, m)

        # the items in order, as the reference's scan over the MAXC axis
        ncurr = torch.zeros(R, dtype=I, device=dev)
        last_s = torch.full((R,), -1, dtype=I, device=dev)
        new_curr = torch.zeros((R, MAXC, 4), dtype=I, device=dev)
        mem, memn = sweep_mem, sweep_n
        ovf = overflow
        for j in range(m):
            valid = in_back & (j < prev_n)
            pj = prev[:, j]
            oks = nbs[:, j]
            keep = ~c_ok | (oks < min_intvs)
            # an SMEM ends here unless curr is alive or a longer one covers it
            last_qb = _pick(mem[:, :, 3], (memn - 1).clamp(0, MAXS - 1))
            no_contain = (memn == 0) | (i + 1 < last_qb)
            do_mem = valid & keep & (ncurr == 0) & no_contain
            memovf = do_mem & (memn >= MAXS)
            mem_item = torch.stack([pj[:, 0], pj[:, 1], pj[:, 2], i + 1, pj[:, 3]], dim=1)
            mem = _put(mem, memn.clamp(0, MAXS - 1), do_mem & ~memovf, mem_item)
            memn = torch.where(do_mem & ~memovf, memn + 1, memn)
            # the extension kept the interval alive with a new size
            do_curr = valid & ~keep & ((ncurr == 0) | (oks != last_s))
            currovf = do_curr & (ncurr >= MAXC)
            curr_item = torch.stack([nb0[:, j], nb1[:, j], oks, pj[:, 3]], dim=1)
            new_curr = _put(new_curr, ncurr.clamp(0, MAXC - 1), do_curr & ~currovf, curr_item)
            ncurr = torch.where(do_curr & ~currovf, ncurr + 1, ncurr)
            last_s = torch.where(do_curr, oks, last_s)
            ovf = ovf | memovf | currovf
        sweep_mem = torch.where(in_back[:, None, None], mem, sweep_mem)
        sweep_n = torch.where(in_back, memn, sweep_n)
        overflow = ovf

        sweep_done = in_back & ((ncurr == 0) | (i - 1 < -1))
        cont = in_back & ~sweep_done
        prev = torch.where(cont[:, None, None], new_curr, prev)
        prev_n = torch.where(cont, ncurr, prev_n)
        i = torch.where(cont, i - 1, i)

        # sweep finished: out[n_out + t] = sweep_mem[sn - 1 - t] while it fits
        arS = torch.arange(MAXS, device=dev)
        src = (sweep_n[:, None] - 1 - arS[None, :]).clamp(0, MAXS - 1)
        rev = sweep_mem.gather(1, src.long()[:, :, None].expand(R, MAXS, 5))
        dst = out_n[:, None] + arS[None, :]
        can = sweep_done[:, None] & (arS[None, :] < sweep_n[:, None]) & (dst < MAXS)
        # gather the source t of each destination d (t = d - n_out)
        t_of_d = (arS[None, :] - out_n[:, None]).clamp(0, MAXS - 1)
        written = can.gather(1, t_of_d.long()) & (arS[None, :] >= out_n[:, None])
        vals = rev.gather(1, t_of_d.long()[:, :, None].expand(R, MAXS, 5))
        out = torch.where(written[:, :, None], vals, out)
        overflow = overflow | (sweep_done & (out_n + sweep_n > MAXS))
        out_n = torch.where(sweep_done, torch.clamp(out_n + sweep_n, max=MAXS), out_n)
        phase = torch.where(sweep_done, PH_DONE if single_sweep else PH_PIVOT, phase)
        steps += 1
    return out, _counted(out_n, rows, stats, count_rows), overflow


def _counted(out_n, rows, stats, count_rows):
    """out_n, or with ``count_rows`` out_n and each read's occ4 rows as
    (2, R); their sum added to ``stats["rank_rows"]`` with a dict ``stats``."""
    if stats is not None:
        stats["rank_rows"] = stats.get("rank_rows", 0) + int(rows.sum())
    return torch.stack([out_n, rows]) if count_rows else out_n


def pass3_torch(fm: RankTables, qs, qlens, min_seed_len: int, max_intv: int, MAXS: int,
                stats=None, count_rows=False):
    """Plain version of S3 (the reference's _pass3_program, the
    bwt_seed_strategy1 pivot chains of bwt.c:358-379, in lockstep).  The
    occ4 rows the reads need, two per forward step of a live read, go to
    ``stats`` and ``count_rows`` as in ``smem_pass_torch``."""
    I = fm.idt
    dev = qs.device
    R, L = qs.shape
    qsT = qs.to(I)
    qlens = qlens.to(I)
    L2 = fm.L2
    x = torch.zeros(R, dtype=I, device=dev)
    i = torch.zeros(R, dtype=I, device=dev)
    ik = torch.zeros((R, 3), dtype=I, device=dev)
    scanning = torch.zeros(R, dtype=torch.bool, device=dev)
    done = torch.zeros(R, dtype=torch.bool, device=dev)
    out = torch.zeros((R, MAXS, 5), dtype=I, device=dev)
    out_n = torch.zeros(R, dtype=I, device=dev)
    overflow = torch.zeros(R, dtype=torch.bool, device=dev)
    counting = stats is not None or count_rows
    rows = torch.zeros(R, dtype=I, device=dev)

    steps = 0
    while steps < 8 * L + 64 and not bool(done.all()):
        # idle reads look for a pivot
        idle = ~scanning & ~done
        cx = _codes(qsT, qlens, x)
        past = x >= qlens
        done = done | (idle & past)
        x = torch.where(idle & ~past & (cx >= 4), x + 1, x)
        start = idle & ~past & (cx < 4)
        c = cx.clamp(0, 3).long()
        ik0 = torch.stack([L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c]], dim=1)
        ik = torch.where(start[:, None], ik0, ik)
        i = torch.where(start, x + 1, i)
        scanning = scanning | start

        # scanning reads take one forward step
        ci = _codes(qsT, qlens, i)
        at_end = scanning & (i >= qlens)
        hit_n = scanning & ~at_end & (ci >= 4)
        live = scanning & ~at_end & ~hit_n
        comp = 3 - ci.clamp(0, 3)
        o0, o1, osz = extend_torch(fm, ik[:, 0], ik[:, 1], ik[:, 2], is_back=False)
        n0, n1, ns = _pick(o0, comp), _pick(o1, comp), _pick(osz, comp)
        if counting:
            rows += 2 * live
        emit = live & (ns < max_intv) & (i - x >= min_seed_len)
        do_push = emit & (ns > 0)
        ovf = do_push & (out_n >= MAXS)
        item = torch.stack([n0, n1, ns, x, i + 1], dim=1)
        out = _put(out, out_n.clamp(0, MAXS - 1), do_push & ~ovf, item)
        out_n = torch.where(do_push & ~ovf, out_n + 1, out_n)
        overflow = overflow | ovf
        adv = live & ~emit
        ik = torch.where(adv[:, None], torch.stack([n0, n1, ns], dim=1), ik)
        i = torch.where(adv, i + 1, i)
        # stop on emit / N / end of read: the next pivot is i + 1 (or qlen)
        stop = at_end | hit_n | emit
        x = torch.where(stop, torch.where(at_end, qlens, i + 1), x)
        scanning = scanning & ~stop
        steps += 1
    return out, _counted(out_n, rows, stats, count_rows), overflow


def smem_pass(fm: RankTables, qs, qlens, pivots0, min_intvs, single_sweep: bool,
              MAXC: int, MAXS: int, count_rows=False):
    """S1 wrapper: plain version for CPU tensors, the kernel for CUDA (its
    sharded entry point for a ShardedFMIndex)."""
    if qs.device.type == "cpu":
        return smem_pass_torch(fm, qs, qlens, pivots0, min_intvs, single_sweep, MAXC, MAXS,
                               count_rows=count_rows)
    kernel = smem_pass_sharded_cuda if isinstance(fm, ShardedFMIndex) else smem_pass_cuda
    return kernel(fm, qs, qlens, pivots0, min_intvs, single_sweep, MAXC, MAXS, count_rows)


def pass3(fm: RankTables, qs, qlens, min_seed_len: int, max_intv: int, MAXS: int,
          count_rows=False):
    """S3 wrapper: plain version for CPU tensors, the kernel for CUDA (its
    sharded entry point for a ShardedFMIndex)."""
    if qs.device.type == "cpu":
        return pass3_torch(fm, qs, qlens, min_seed_len, max_intv, MAXS, count_rows=count_rows)
    kernel = pass3_sharded_cuda if isinstance(fm, ShardedFMIndex) else pass3_cuda
    return kernel(fm, qs, qlens, min_seed_len, max_intv, MAXS, count_rows)


def pad_reads(reads: List[np.ndarray], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """qs (R, L) int8 codes padded with N and qlens (R,) int32 on
    ``device``: R a multiple of 64, L a multiple of 64 and at least 64.  L
    sets the step caps (16 * L + 64, 8 * L + 64), so it is padded as the
    reference pads it."""
    n = len(reads)
    lens = np.fromiter(map(len, reads), np.int64, n)
    R = -(-max(n, 1) // 64) * 64
    L = max(64, -(-int(lens.max(initial=0)) // 64) * 64)
    qs = np.full((R, L), 4, np.int8)
    if lens.sum():
        starts = np.cumsum(lens) - lens
        cols = np.arange(int(lens.sum())) - np.repeat(starts, lens)
        qs[np.repeat(np.arange(n), lens), cols] = np.concatenate(reads)
    qlens = np.zeros(R, np.int32)
    qlens[:n] = lens
    return torch.from_numpy(qs).to(device), torch.from_numpy(qlens).to(device)


def seed_buffers(L: int) -> int:
    """MAXC and MAXS that no read of padded width L can overflow.  A sweep
    pushes at most one interval per forward step, plus the final one (at
    most L + 1), and a backward step keeps at most as many.  A read's SMEMs
    (of one sweep and of all of them) and its pass-3 seeds each have
    distinct ends in 1..L."""
    return L + 2


@dataclass
class SeedBatch:
    """Every read's SMEMs as flat rows: read r's are rows off[r]:off[r+1],
    in its final order (qb, then qe).  k, l, s int64 (rows of a wide index
    pass 2^32), qb, qe int32: what the native chainer takes."""

    off: np.ndarray
    k: np.ndarray
    l: np.ndarray
    s: np.ndarray
    qb: np.ndarray
    qe: np.ndarray

    @classmethod
    def of_rows(cls, n: int, read: np.ndarray, rows: np.ndarray) -> "SeedBatch":
        """The batch of ``n`` reads from rows (N, 5) of (k, l, s, qb, qe)
        sorted by their reads ``read`` (N,), each read's in its order."""
        off = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(read, minlength=n), out=off[1:])
        rows = rows.astype(np.int64, copy=False)
        return cls(off, *(np.ascontiguousarray(rows[:, c]) for c in range(3)),
                   *(rows[:, c].astype(np.int32) for c in (3, 4)))

    def reads(self) -> np.ndarray:
        """Each row's read."""
        return np.repeat(np.arange(len(self.off) - 1), np.diff(self.off))

    def rows(self) -> np.ndarray:
        """(N, 5) int64 rows of (k, l, s, qb, qe)."""
        return np.stack([self.k, self.l, self.s, self.qb, self.qe], axis=1)

    def to_lists(self) -> List[List[SMEM]]:
        """The per-read SMEM lists of ``align.smem.collect_seeds``."""
        mems = [SMEM(*m) for m in self.rows().tolist()]
        off = self.off.tolist()
        return [mems[a:b] for a, b in zip(off[:-1], off[1:])]


class Jobs(NamedTuple):
    """Pass 2's jobs, read-major and in SMEM order within a read
    (bwamem.c:130-145): one single sweep each from ``pivot`` with
    ``min_intv``."""

    read: np.ndarray
    pivot: np.ndarray
    min_intv: np.ndarray


def _kept(out: np.ndarray, cnt: np.ndarray, ok: np.ndarray, min_len: int):
    """The rows t < cnt[r] of every r with ok[r] whose qe - qb >= min_len,
    row-major: their r (N,) and their values (N, 5)."""
    t = np.arange(out.shape[1])
    mask = (t[None, :] < cnt[:, None]) & ok[:, None]
    mask &= out[:, :, 4] - out[:, :, 3] >= min_len
    r, t = np.nonzero(mask)
    return r, out[r, t]


def pass1_seeds(out1, n1, overflow, n: int, opt: MemOptions):
    """Pass 1's SMEMs of at least min_seed_len of the first ``n`` reads
    that did not overflow, as (read, rows (N, 5)), and the pass-2 jobs of
    the long ones that occur rarely enough (bwamem.c:130-145)."""
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    read, rows = _kept(out1[:n], n1[:n], ~np.asarray(overflow[:n], bool), opt.min_seed_len)
    k, l, s, qb, qe = rows.T
    job = (qe - qb >= split_len) & (s <= opt.split_width)
    jobs = Jobs(read[job], ((qb[job] + qe[job]) >> 1).astype(np.int32),
                (s[job] + 1).astype(np.int32))
    return (read, rows), jobs


def pass2_inputs(jobs: Jobs, qs: torch.Tensor, qlens: torch.Tensor):
    """Pass 2 as one S1 launch: one row per job, in the jobs' order.
    Returns read_of (J,) int64 numpy, the job's read, then qs (J, L),
    qlens, pivots and min_intvs (J,) int32, on qs's device."""
    dev = qs.device
    sel = torch.from_numpy(jobs.read).to(dev)
    return (jobs.read, qs.index_select(0, sel), qlens.index_select(0, sel),
            torch.from_numpy(jobs.pivot).to(dev), torch.from_numpy(jobs.min_intv).to(dev))


def _fetch(res, launch=None):
    """A pass's out (only the slots some read filled), out_n and overflow
    flags on the host.  Where the pass counted occ4 rows (out_n (2, R)),
    their sum goes on its ``launch`` span as ``rank_rows``."""
    out, cnt, ovf = res
    cnt = cnt.cpu().numpy()
    if cnt.ndim == 2:
        cnt, rows = cnt
        if launch is not None:
            launch.attrs["rank_rows"] = int(rows.sum())
    used = int(cnt.max())
    return out[:, :used].cpu().numpy(), cnt, ovf.cpu().numpy()


def collect_seeds_device_flat(
    reads: List[np.ndarray],
    opt: MemOptions,
    dfm: RankTables,
    MAXC: Optional[int] = None,
    MAXS: Optional[int] = None,
) -> SeedBatch:
    """Three-pass seed collection with the sweeps on dfm's device (a
    DeviceFMIndex, or a ShardedFMIndex's seeding device), gathered from
    the kernels' output buffers in bulk: the seeds of
    align.smem.collect_seeds, read for read, as one SeedBatch.

    MAXC and MAXS default to ``seed_buffers`` of the padded width, which no
    read can overflow (an overflow there raises); reads that overflow
    smaller ones are redone on the same device at that size and counted in
    ``overflow_redos``."""
    global overflow_redos
    n = len(reads)
    empty = np.zeros((0, 5), np.int64)
    if n == 0:
        return SeedBatch.of_rows(0, np.zeros(0, np.int64), empty)
    dev = dfm.device
    qs, qlens = pad_reads(reads, dev)
    R, L = qs.shape
    sized = MAXC is None and MAXS is None
    MAXC = seed_buffers(L) if MAXC is None else MAXC
    MAXS = seed_buffers(L) if MAXS is None else MAXS

    # pass 1, and pass 3, which needs nothing of passes 1-2, launched before
    # the host first waits on the device; traced, S1 and S3 count each
    # read's occ4 rows into a second row of out_n, fetched with it and put
    # on their launch spans
    count = TIMERS.tracing and dev.type == "cuda"
    ones = torch.ones(R, dtype=torch.int32, device=dev)
    res1 = smem_pass(dfm, qs, qlens, ones * 0, ones, False, MAXC, MAXS, count)
    launch1 = TIMERS.take_launch()
    res3 = pass3(dfm, qs, qlens, opt.min_seed_len, opt.max_mem_intv, MAXS, count) \
        if opt.max_mem_intv > 0 else None
    launch3 = TIMERS.take_launch()
    out1, n1, ovf1 = _fetch(res1, launch1)
    overflow = ovf1[:n].astype(bool)
    (read1, rows1), jobs = pass1_seeds(out1, n1, overflow, n, opt)

    # pass 2: every job a single sweep of its own, all in one launch
    read2, rows2 = np.zeros(0, np.int64), empty
    if len(jobs.read):
        read_of, *job_args = pass2_inputs(jobs, qs, qlens)
        res2 = smem_pass(dfm, *job_args, True, MAXC, MAXS, count)
        o2, c2, ov2 = _fetch(res2, TIMERS.take_launch())
        overflow[read_of[ov2.astype(bool)]] = True
        j, rows2 = _kept(o2, c2, np.ones(len(read_of), bool), opt.min_seed_len)
        read2 = read_of[j]

    read3, rows3 = np.zeros(0, np.int64), empty
    if res3 is not None:
        o3, c3, ov3 = _fetch(res3, launch3)
        overflow |= ov3[:n].astype(bool)
        read3, rows3 = _kept(o3[:n], c3[:n], np.ones(n, bool), 0)

    # merge: passes 1, 2, 3 in that order, then a stable sort by read and
    # (qb << 32) | qe, as collect_seeds sorts pass1 + pass2 + pass3
    read = np.concatenate([read1, read2, read3])
    rows = np.concatenate([rows1, rows2, rows3]).astype(np.int64)
    keep = ~overflow[read]
    read, rows = read[keep], rows[keep]
    order = np.lexsort(((rows[:, 3] << 32) | rows[:, 4], read))
    read, rows = read[order], rows[order]

    redo = np.flatnonzero(overflow)
    if len(redo):
        if sized:
            raise RuntimeError(f"collect_seeds_device: {len(redo)} reads overflowed buffers "
                               f"of {MAXC} intervals / {MAXS} SMEMs at width {L}")
        with _redo_lock:
            overflow_redos += len(redo)
        with TIMERS.stage("seed.device.redo"):
            again = collect_seeds_device_flat([reads[r] for r in redo], opt, dfm)
        read = np.concatenate([read, redo[again.reads()]])
        rows = np.concatenate([rows, again.rows()])
        order = np.argsort(read, kind="stable")
        read, rows = read[order], rows[order]
    return SeedBatch.of_rows(n, read, rows)


def collect_seeds_device(
    reads: List[np.ndarray],
    opt: MemOptions,
    dfm: RankTables,
    MAXC: Optional[int] = None,
    MAXS: Optional[int] = None,
) -> List[List[SMEM]]:
    """``collect_seeds_device_flat`` as per-read SMEM lists: identical
    per-read output to align.smem.collect_seeds."""
    return collect_seeds_device_flat(reads, opt, dfm, MAXC, MAXS).to_lists()
