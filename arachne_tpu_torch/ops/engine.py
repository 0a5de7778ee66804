"""TorchEngine: barcode-level batched candidate generation on one device.

The port of the reference's TpuEngine (arachne_tpu/ops/engine.py): all
reads of a superbatch run through seeding (on the device with kernels S1
and S3 when device seeding is on, the default on a card; else on the
host) and device-batched extension (ops.batch, kernel K1), wave-batched
mate rescue (ops.sw_local, K2) and wave-batched CIGAR finalization
(ops.sw_global, K3 + K4).  Output
is identical to the oracle engine: every sequential decision (rescue skip
windows, dedup after each rescue, reg2aln's w2-doubling loop) is replayed
on the host with the device results in hand.  It plugs into the RFA
workflow through ``align_pairs`` / ``reg2aln_batch``.
"""

from __future__ import annotations

import operator
import os
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..align import ksw
from ..align.cigar import MemAln
from ..align.extend import AlnReg, sort_dedup_patch
from ..align.pairing import infer_dir
from ..align.pipeline import EasyAlignment, interpret_align
from ..config import ArachneConfig
from ..index.fmindex import FMIndex
from ..runtime.timers import TIMERS

from ..device import resolve_device
from .batch import batch_align_single
from .devicepool import dispatch_devices
from .fm_rank import DeviceFMIndex, RankTables, ShardedFMIndex, occ4_device
from .fm_seed import pass3, seed_buffers, smem_pass
from .params import kernel_params
from .sw_extend import BatchExtender, extend_batch
from .sw_global import BatchGlobal, global_score, global_z, traceback
from .sw_local import NEVER, BatchLocalSW, local_sw_full

# the AlnReg fields reg2aln_batch reads: the integers the native set-up
# takes (cigarbatch.cpp cigar_init_batch), then frac_rep, is_alt, alt_sc
_REG_FIELDS = operator.attrgetter(
    "qb", "qe", "rb", "re", "truesc", "w", "secondary", "score", "sub", "csub", "sub_n",
    "seedcov", "frac_rep", "is_alt", "alt_sc",
)

_warm_lock = threading.Lock()
_warmed: set = set()

# the rank tables of each index on each device, and its sharded tables on
# each (device list, seeding device), uploaded once however many engines
# (one per worker thread) use them
_tables_lock = threading.Lock()
_tables: "weakref.WeakKeyDictionary[FMIndex, Dict[torch.device, DeviceFMIndex]]" = (
    weakref.WeakKeyDictionary()
)
_sharded: "weakref.WeakKeyDictionary[FMIndex, Dict[tuple, ShardedFMIndex]]" = (
    weakref.WeakKeyDictionary()
)
# the placement ``auto`` chose for each index on each device list, decided
# once: the first engine's upload shrinks the free memory a later one reads
_placement: "weakref.WeakKeyDictionary[FMIndex, Dict[tuple, str]]" = weakref.WeakKeyDictionary()
INDEX_MODES = ("auto", "replicated", "sharded")


def resolve_device_seeding(device_seeding: Optional[bool] = None, device=None) -> bool:
    """Seed on the device?  An explicit argument wins; else the environment
    variable ARACHNE_DEVICE_SEEDING, "1" or "0", where any other value
    raises; else yes on a CUDA device, as the reference seeds on its chip,
    and no on any other device or none.  (The reference seeds on the
    device on the CPU platform too; here the CPU runs S1/S3 as their plain
    lockstep versions, an oracle, not a path, so the CPU seeds on the
    host.)"""
    if device_seeding is not None:
        return bool(device_seeding)
    env = os.environ.get("ARACHNE_DEVICE_SEEDING")
    if env is None:
        return device is not None and torch.device(device).type == "cuda"
    if env not in ("0", "1"):
        raise ValueError(f"ARACHNE_DEVICE_SEEDING={env!r}: expected '0' or '1'")
    return env == "1"


def hbm_budget(device: torch.device) -> Optional[int]:
    """Bytes the rank tables may take on ``device``: ARACHNE_HBM_BUDGET when
    it is set, else the card's free memory; None (no bound) for a CPU
    device without the variable.  (The reference's default of 8 GB is a
    16 GB TPU's figure.)"""
    env = os.environ.get("ARACHNE_HBM_BUDGET")
    if env is not None:
        return int(env)
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return None


def device_tables(idx: FMIndex, device: torch.device) -> DeviceFMIndex:
    """The index's rank tables on ``device``, uploaded on the first call
    for that (index, device).  Raises if they exceed ``hbm_budget``: no
    silent switch to host seeding."""
    device = torch.device(device)
    with _tables_lock:
        per_device = _tables.setdefault(idx, {})
        dfm = per_device.get(device)
        if dfm is None:
            need = DeviceFMIndex.table_bytes(idx)
            budget = hbm_budget(device)
            if budget is not None and need > budget:
                raise RuntimeError(
                    f"device seeding: the index's rank tables need {need} bytes, over the "
                    f"budget of {budget} on {device} (with more than one card, --index-mode "
                    "sharded or auto splits them across the cards; ARACHNE_DEVICE_SEEDING=0 "
                    "seeds on the host)"
                )
            dfm = DeviceFMIndex.from_host(idx, device)
            per_device[device] = dfm
        return dfm


def sharded_tables(idx: FMIndex, devices, device: torch.device) -> ShardedFMIndex:
    """The index's rank tables split across ``devices`` and seeded from
    ``device`` (parallel/mesh.py ShardedFMTables), built on the first call
    for that (index, devices, device)."""
    from ..parallel.mesh import ShardedFMTables

    key = (tuple(torch.device(d) for d in devices), torch.device(device))
    with _tables_lock:
        per_key = _sharded.setdefault(idx, {})
        tab = per_key.get(key)
        if tab is None:
            tab = ShardedFMTables(idx, key[0], device=key[1])
            per_key[key] = tab
        return tab


def rank_tables(idx: FMIndex, device: torch.device, mode: str = "auto") -> RankTables:
    """Where device seeding finds the index's rank tables: the placement
    rule of arachne_tpu/ops/engine.py:74-110 over the process's devices
    (devicepool.dispatch_devices of the engine's device, or the pinned
    list).  ``auto`` shards exactly when there is more than one device and
    the record table exceeds ``hbm_budget``, decided on the first call for
    that (index, devices) and kept; ``sharded`` with one device falls back
    to replicated; tables that fit neither way raise (the reference seeds
    on the host instead)."""
    if mode not in INDEX_MODES:
        raise ValueError(f"index mode {mode!r}: expected one of {INDEX_MODES}")
    device = torch.device(device)
    devices = dispatch_devices(device)
    if mode == "auto":
        with _tables_lock:
            chosen = _placement.setdefault(idx, {})
            key = tuple(devices)
            if key not in chosen:
                budget = hbm_budget(device)
                over = budget is not None and DeviceFMIndex.table_bytes(idx) > budget
                chosen[key] = "sharded" if len(devices) > 1 and over else "replicated"
            mode = chosen[key]
    if mode == "sharded" and len(devices) > 1:
        return sharded_tables(idx, devices, device)
    return device_tables(idx, device)


def warmup(device: torch.device) -> None:
    """Build the kernels and launch each once on ``device`` (once per
    process and device), so that the nvcc build and the first launches
    fall outside the timed run.  Calls the kernel wrappers directly, not
    the batchers, so no stage timer books it.  A CPU device has nothing to
    build and is left alone."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    with _warm_lock:
        if device in _warmed:
            return
        p = kernel_params(ArachneConfig().mem, device)
        one = torch.ones(1, dtype=torch.int32, device=device)
        qs = torch.zeros((1, 32), dtype=torch.int8, device=device)
        ts = torch.zeros((1, 64), dtype=torch.int8, device=device)
        ql = torch.full((1,), 32, dtype=torch.int32, device=device)
        tl = torch.full((1,), 33, dtype=torch.int32, device=device)
        never = torch.full((1,), NEVER, dtype=torch.int32, device=device)
        extend_batch(qs, ts, ql, tl, one, one * 32, p.mat, **p.gaps(), zdrop=p.zdrop)
        local_sw_full(qs, ts, ql, tl, never, never, p.mat, **p.gaps(), max_mat=p.max_mat)
        global_score(qs, ts, ql, tl, one, p.mat, **p.gaps())
        _, z = global_z(qs, ts, ql, tl, one, p.mat, **p.gaps())
        traceback(z, ql, tl, one, max_steps=96)
        # a one-block table of As and one read of 32 As
        fm = DeviceFMIndex.from_planar(
            torch.zeros((2, 4), dtype=torch.int32, device=device),
            torch.zeros(8, dtype=torch.int32, device=device),
            torch.tensor([0, 128, 128, 128, 128], dtype=torch.int32, device=device),
            primary=64, seq_len=128, l_pac=64,
        )
        occ4_device(fm, ql)
        smem_pass(fm, qs, ql, one * 0, one, False, seed_buffers(32), seed_buffers(32))
        pass3(fm, qs, ql, 19, 20, seed_buffers(32))
        torch.cuda.synchronize(device)
        _warmed.add(device)


class TorchEngine:
    """Batched device engine bound to one index, config and device.

    ``device_seeding`` as ``resolve_device_seeding`` reads it for the
    engine's device (on by default on a card); when on, seeding runs on
    the device against the index's shared rank tables, placed by
    ``rank_tables`` under ``cfg.pipeline.index_mode``.  Raises without the
    native host library (native/*.cpp): host seeding, chaining and the
    CIGAR stage's host side run in it, with no Python fallback."""

    def __init__(self, idx: FMIndex, cfg: ArachneConfig, device="cuda",
                 device_seeding: Optional[bool] = None):
        self.idx = idx
        self.cfg = cfg
        self.opt = cfg.mem
        self.device = resolve_device(device)
        native.require_lib()
        self.mat = cfg.mem.scoring_matrix()
        self.extender = BatchExtender(cfg.mem, self.device)
        self.local = BatchLocalSW(cfg.mem, self.device)
        self.global_ = BatchGlobal(cfg.mem, self.device)
        self.dfm = (
            rank_tables(idx, self.device, cfg.pipeline.index_mode)
            if resolve_device_seeding(device_seeding, self.device) else None
        )

    # ------------------------------------------------------------------
    # batched GoBwaMemMateSW over all pairs of a superbatch
    # ------------------------------------------------------------------

    def align_pairs(
        self, pairs: List[Tuple[np.ndarray, np.ndarray]]
    ) -> List[Tuple[List[EasyAlignment], List[EasyAlignment]]]:
        idx, opt = self.idx, self.opt
        flat_reads: List[np.ndarray] = []
        for r1, r2 in pairs:
            flat_reads.append(r1)
            flat_reads.append(r2)
        regs_flat = batch_align_single(
            idx, opt, flat_reads, self.extender, self.mat, dfm=self.dfm
        )
        regs1 = [regs_flat[2 * i] for i in range(len(pairs))]
        regs2 = [regs_flat[2 * i + 1] for i in range(len(pairs))]
        best1 = [max((r.score for r in rs), default=0) for rs in regs1]
        best2 = [max((r.score for r in rs), default=0) for rs in regs2]
        delta = self.cfg.rfa.chain_score_delta
        # rescue read1 around read2's hits, then read2 around read1's
        with TIMERS.stage("rescue"):
            self._rescue_wave(pairs, regs2, regs1, best2, side=0, score_delta=delta)
            self._rescue_wave(pairs, regs1, regs2, best1, side=1, score_delta=delta)
        return [
            (
                [interpret_align(idx, r) for r in regs1[i]],
                [interpret_align(idx, r) for r in regs2[i]],
            )
            for i in range(len(pairs))
        ]

    def _rescue_wave(
        self,
        pairs,
        anchor_regs: List[List[AlnReg]],
        mate_regs: List[List[AlnReg]],
        best_anchor: List[int],
        side: int,
        score_delta: int,
    ) -> None:
        """mem_matesw (bwamem_pair.c:111-180 + gobwa.go:286-324) with ONE
        device batch for the whole side.

        The set of attempted anchors is fully determined by the pre-rescue
        snapshot; every attempt's SW window (a pure function of the anchor)
        is computed up front and batched, then the sequential skip/insert/
        dedup semantics are replayed on the host.  The pre-rescue skip hint
        only filters the batch: where the evolved mate list disagrees (dedup
        removed the proper mate), the replay runs the reference's own exact
        ksw.align2 for that one attempt."""
        idx, opt = self.idx, self.opt
        l_pac = idx.l_pac

        attempts: List[List[AlnReg]] = []
        for pi in range(len(pairs)):
            lst: List[AlnReg] = []
            mate_seq = pairs[pi][side]
            if mate_seq is not None and len(mate_seq) > 0:
                for a in anchor_regs[pi]:
                    if len(lst) >= opt.max_matesw:
                        break
                    if a.score < best_anchor[pi] - score_delta:
                        continue
                    lst.append(a)
            attempts.append(lst)

        windows: Dict[Tuple[int, int], Optional[Tuple]] = {}
        batch_keys = []
        for pi, lst in enumerate(attempts):
            mate_seq = pairs[pi][side]
            hint_regs = mate_regs[pi]
            for ai, a in enumerate(lst):
                if self._matesw_skip(a, hint_regs):
                    continue
                win = self._matesw_window(a, mate_seq)
                windows[(pi, ai)] = win
                if win is not None:
                    batch_keys.append((pi, ai))
        results: Dict[Tuple[int, int], object] = {}
        if batch_keys:
            for key in batch_keys:
                seq, rb, ref = windows[key]
                self.local.submit(seq, ref, opt.min_seed_len * opt.a)
            with TIMERS.stage("rescue.device"):
                out = self.local.run_align2()
            results = dict(zip(batch_keys, out))

        # replay the sequential skip/insert/dedup bookkeeping
        replayed = placed = 0
        for pi, lst in enumerate(attempts):
            mate_seq = pairs[pi][side]
            for ai, a in enumerate(lst):
                if self._matesw_skip(a, mate_regs[pi]):
                    continue
                if (pi, ai) in windows:
                    win = windows[(pi, ai)]
                else:
                    win = self._matesw_window(a, mate_seq)
                if win is None:
                    continue  # window invalid -> no SW, attempt still counted
                seq, rb, ref = win
                aln = results.get((pi, ai))
                l_ms = len(mate_seq)
                if aln is None:
                    xtra = (
                        ksw.KSW_XSUBO
                        | ksw.KSW_XSTART
                        | (ksw.KSW_XBYTE if l_ms * opt.a < 250 else 0)
                        | (opt.min_seed_len * opt.a)
                    )
                    aln = ksw.align2(
                        seq, ref, self.mat, opt.o_del, opt.e_del,
                        opt.o_ins, opt.e_ins, xtra,
                    )
                    replayed += 1
                if aln.score >= opt.min_seed_len and aln.qb >= 0:
                    b = AlnReg()
                    b.rid = a.rid
                    b.is_alt = a.is_alt
                    # FR rescue is always is_rev=True (gobwa Pes model)
                    b.qb = l_ms - (aln.qe + 1)
                    b.qe = l_ms - aln.qb
                    b.rb = (l_pac << 1) - (rb + aln.te + 1)
                    b.re = (l_pac << 1) - (rb + aln.tb)
                    b.score = aln.score
                    b.csub = aln.score2
                    b.secondary = -1
                    b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
                    regs = mate_regs[pi]
                    ins = len(regs)
                    for i in range(len(regs)):
                        if regs[i].score < b.score:
                            ins = i
                            break
                    regs.insert(ins, b)
                    placed += 1
                # dedup after every attempt (mem_matesw tail)
                deduped = list(sort_dedup_patch(opt, mate_regs[pi]))
                mate_regs[pi].clear()
                mate_regs[pi].extend(deduped)
        TIMERS.add_to("superbatch", rescue_attempts=len(batch_keys) + replayed,
                      rescue_placed=placed)

    def _matesw_skip(self, anchor: AlnReg, mate_regs: List[AlnReg]) -> bool:
        """mem_matesw's skip[] check for the FR orientation: a mate already
        properly placed relative to the anchor makes the attempt free."""
        pes = self.cfg.pes
        l_pac = self.idx.l_pac
        for m in mate_regs:
            r, dist = infer_dir(l_pac, anchor.rb, m.rb)
            if r == 1 and pes.low <= dist <= pes.high:
                return True
        return False

    def _matesw_window(self, anchor: AlnReg, mate_seq: np.ndarray):
        """The SW window of one rescue attempt, a pure function of the
        anchor (FR orientation): (rev_seq, rb, ref), or None if the attempt
        does no SW."""
        idx, opt, pes = self.idx, self.opt, self.cfg.pes
        l_pac = idx.l_pac
        l_ms = len(mate_seq)
        m = np.asarray(mate_seq)[::-1]
        seq = np.where(m < 4, 3 - m, 4).astype(np.uint8)
        rb = max((anchor.rb + pes.low) - l_ms, 0)
        re = min(anchor.rb + pes.high, l_pac << 1)
        if rb >= re:
            return None
        ref, rid, rb, re = idx.fetch_seq(rb, (rb + re) >> 1, re)
        if anchor.rid != rid or re - rb < opt.min_seed_len:
            return None
        return (seq, rb, ref)

    # ------------------------------------------------------------------
    # batched mem_reg2aln over many hits
    # ------------------------------------------------------------------

    def reg2aln_batch(
        self, jobs: List[Tuple[np.ndarray, Optional[AlnReg]]]
    ) -> List[MemAln]:
        """mem_reg2aln (bwamem.c:1086-1156) with the w2-doubling loop run
        as waves of batched global alignments and every per-hit step in
        native/cigarbatch.cpp: one call sets up mapq and the bands, one
        fetches and orients every window, each wave's DP problems go
        through ``BatchGlobal`` as flat results, and one call writes NM/MD,
        the squeeze, the clips and the coordinates.  Python keeps the
        waves' control, over arrays."""
        idx, opt = self.idx, self.opt
        mapped = [k for k, (_, ar) in enumerate(jobs)
                  if ar is not None and ar.rb >= 0 and ar.re >= 0]
        if not mapped:
            return [MemAln(flag=0x4) for _ in jobs]
        regs = [jobs[k][1] for k in mapped]
        queries = [jobs[k][0] for k in mapped]
        m = len(regs)
        cols = list(zip(*map(_REG_FIELDS, regs)))
        reg = np.array(cols[:12], np.int64).T.copy()
        qb, qe, rb, re, truesc = (reg[:, c] for c in range(5))
        secondary = reg[:, 6]
        mapq, w2 = native.cigar_init_native(reg, np.array(cols[12], np.float64), opt)

        query_off = np.zeros(m + 1, np.int64)
        np.cumsum(np.fromiter(map(len, queries), np.int64, m), out=query_off[1:])
        prep = native.cigar_prepare_native(
            np.concatenate(queries), query_off, qb, qe, rb, re, idx._fwd_codes(),
            idx.packed.pac, idx.l_pac, idx.seq_len, self.mat, opt,
        )
        qbuf, rbuf, rbuf_off, lq, rlen, ok, nogap, band = prep
        ok = ok.astype(bool)

        # the w2-doubling loop (mem_reg2aln :1101-1116), a wave a turn; a
        # hit whose window fails keeps kind 0 and score 0 throughout
        kind = np.zeros(m, np.uint8)          # 0 failed, 1 no-gap shortcut, 2 DP
        score = np.zeros(m, np.int64)
        cig_start = np.zeros(m, np.int64)
        cig_n = np.zeros(m, np.int32)
        cig_parts, cig_base = [], 0
        last_sc = np.full(m, -(1 << 30), np.int64)
        iters = np.zeros(m, np.int64)
        w_max = opt.w * 4
        active = np.arange(m)
        while active.size:
            w2[active] = np.minimum(w2[active], w_max)
            ok_a = ok[active]
            short = ok_a & (lq[active] == rlen[active]) & (w2[active] == 0)
            dp = active[ok_a & ~short]
            kind[active[short]] = 1
            score[active[short]] = nogap[active[short]]
            if dp.size:
                d = np.abs(rlen[dp] - lq[dp])
                w_eff = np.maximum(np.minimum(band[dp], w2[dp]), d + 3).tolist()
                for q0, nq, r0, nr, w in zip(query_off[dp].tolist(), lq[dp].tolist(),
                                             rbuf_off[dp].tolist(), rlen[dp].tolist(), w_eff):
                    self.global_.submit(qbuf[q0 : q0 + nq], rbuf[r0 : r0 + nr], w)
                with TIMERS.stage("cigar.device"):
                    res = self.global_.run()
                kind[dp] = 2
                score[dp] = res.score
                cig_start[dp] = cig_base + res.cig_off[:-1]
                cig_n[dp] = np.diff(res.cig_off)
                cig_parts.append(res.cig)
                cig_base += len(res.cig)
            sc = score[active]
            go = (sc != last_sc[active]) & (w2[active] != w_max)
            cont = active[go]
            last_sc[cont] = score[cont]
            w2[cont] <<= 1
            iters[cont] += 1
            active = cont[(iters[cont] < 3) & (score[cont] < truesc[cont] - opt.a)]

        cig_all = np.concatenate(cig_parts) if cig_parts else np.zeros((0, 2), np.int32)
        out_cig, cig_off, md, md_off, nm, pos, rid, is_rev = native.cigar_finish_native(
            kind, cig_all, cig_start, cig_n, prep, query_off, qb, qe, rb, re, idx.l_pac,
            idx._offsets,
        )
        pairs = list(zip(out_cig[:, 0].tolist(), out_cig[:, 1].tolist()))
        offs = cig_off.tolist()
        cigars = [pairs[a:b] for a, b in zip(offs, offs[1:])]
        md = md.decode("ascii")
        offs = md_off.tolist()
        mds = [md[a:b] for a, b in zip(offs, offs[1:])]
        sub = list(map(max, cols[8], cols[9]))
        flags = np.where(secondary >= 0, 0x100, 0).tolist()
        done = list(map(
            MemAln, pos.tolist(), rid.tolist(), flags, is_rev.tolist(), cols[13],
            mapq.tolist(), nm.tolist(), cigars, mds, cols[7], sub, cols[14],
        ))
        if len(mapped) == len(jobs):
            return done
        out: List[Optional[MemAln]] = [None] * len(jobs)
        for k, a in zip(mapped, done):
            out[k] = a
        return [a if a is not None else MemAln(flag=0x4) for a in out]
