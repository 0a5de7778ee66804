"""Numpy models of the CUDA kernels K3 and K4 (arachne_tpu_torch/ops/csrc/
global.cu), written from the source step for step, against the plain
PyTorch versions ``global_batch_torch`` and ``traceback_torch``.

The kernels are compiled and run only on a card.  The models carry their
arithmetic to the CPU: a warp is an axis of 32 lanes, a lane's registers an
axis of S columns, a shuffle a shift along the lane axis, and the steps
follow the kernels' order (the wave of lanes, each a row behind the lane to
its left, the strip's F recurrence handed from lane to lane, band skipping;
the 32 x 32 window and the 32-step walk).
Score, every direction byte, the op stream and the final (i, k) must equal
the plain versions': integers, tolerance 0.  The models compute in int64
and check that no value leaves int32, as the kernels compute in int32.
"""

import numpy as np
import pytest
import torch

from arachne_tpu_torch.config import MemOptions
from arachne_tpu_torch.ops.problems import (
    EDGE_GLOBAL_KINDS, edge_global_problems, global_problems,
)
from arachne_tpu_torch.ops.sw_extend import lengths, padded_codes
from arachne_tpu_torch.ops.sw_global import global_batch_torch, traceback_torch

torch.set_num_threads(1)
OPT = MemOptions()
GAPS = dict(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins, e_ins=OPT.e_ins)
MAT = OPT.scoring_matrix().astype(np.int64)
NEG = -0x40000000                       # ARACHNE_MINUS_INF
INT_MIN = -(1 << 31)
LANES = 32
UNWRITTEN = 77                          # an op byte the kernel never stored


def arachne_strip(qmax):
    """common.cuh: the narrowest strip covering qmax columns with 32 lanes."""
    need = (max(qmax, 1) + 31) // 32
    return next(s for s in (2, 4, 6, 8, 12, 16, 24, 32) if s >= need)


def shfl_up(x, d):
    """__shfl_up_sync along the lane axis (axis 1): lanes below d keep
    their own value."""
    y = x.copy()
    y[:, d:] = x[:, :-d]
    return y


def model_global(qs, ts, qlens, tlens, ws, want_z, *, stale_diag=True, mask_cells=True):
    """global_kernel<S, WANT_Z>: one warp per problem (axis 0), lane l
    (axis 1) owning columns l*S .. l*S + S - 1 (axis 2); at step t lane l
    works on row t - l.  The two keyword arguments break the model on
    purpose, to show that the tests notice: taking H(i-1, j0-1) from this
    step's shuffle (which already holds row i) instead of the last step's,
    and not resetting a working strip's cells outside the band (the score
    may be read from one)."""
    o_del, e_del, o_ins, e_ins = (GAPS[k] for k in ("o_del", "e_del", "o_ins", "e_ins"))
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    B, qmax = qs.shape
    tmax = ts.shape[1]
    S = arachne_strip(qmax)
    lane = np.arange(LANES)[None, :]
    j0 = lane * S
    kk = np.arange(S)[None, None, :]
    j = j0[:, :, None] + kk
    qlen = np.minimum(qlens, qmax).astype(np.int64)[:, None]
    tlen = np.minimum(tlens, tmax).astype(np.int64)[:, None]
    w = ws.astype(np.int64)[:, None]
    rows = np.arange(B)[:, None]
    low = [0]

    def seen(x):
        low[0] = min(low[0], int(x.min()))
        return x

    def load_scores(tcode):
        return MAT[tcode[:, :, None], qc]

    fetched = {}

    def target_code(i):
        """common.cuh: 32 codes fetched when i reaches a multiple of 32, one
        per lane, row i's broadcast by shuffle."""
        if i & 31 == 0:
            r = i + lane
            fetched["codes"] = np.where(r < tlen, ts[rows, np.minimum(r, tmax - 1)], 4)
        return fetched["codes"][:, i & 31][:, None]

    qpad = np.full((B, LANES * S), 4, np.int64)
    qpad[:, :qmax] = qs
    qc = qpad.reshape(B, LANES, S)
    H = np.where((j + 1 <= w[:, :, None]) & (j < qlen[:, :, None]),
                 -(o_ins + e_ins * (j + 1)), NEG)
    E = np.full((B, LANES, S), NEG, np.int64)
    z = np.zeros((B, tmax, qmax), np.uint8)      # the caller's zeroed memory
    last = np.where(qlen > 0, (qlen - 1) // S, 0)
    steps = np.where(tlen > 0, tlen + last, 0)
    diag = np.full((B, LANES), NEG, np.int64)
    Fout = np.full((B, LANES), NEG, np.int64)
    tc = np.where(lane == 0, target_code(0), 4)
    sc = load_scores(tc)
    for t in range(int(steps.max()) if B else 0):
        running = t < steps                      # (B, 1): the warp's own loop bound
        i = t - lane
        valid = (i >= 0) & (i < tlen) & running
        hl = shfl_up(H[:, :, S - 1], 1)
        fl = shfl_up(Fout, 1)
        tl = shfl_up(tc, 1)
        t0 = target_code(t + 1)
        lo = np.maximum(i - w, 0)
        hi = np.minimum(i + w + 1, qlen)
        bound_prev = np.where(i == 0, 0, np.where(i - 1 <= w, -(o_del + e_del * i), NEG))
        active = np.maximum(j0, lo) < np.minimum(j0 + S, hi)
        in_band = (kk >= (lo - j0)[:, :, None]) & (kk < (hi - j0)[:, :, None])
        F = np.where(lane == 0, NEG + e_ins, fl)
        Hd = np.where(lane == 0, bound_prev, diag if stale_diag else hl)

        # a working strip: M from the row above, F along the strip
        M = seen(np.concatenate([Hd[:, :, None], H[:, :, :-1]], axis=2) + sc)
        Fk = np.empty((B, LANES, S), np.int64)      # F as column k sees it
        Fa = F
        for k in range(S):
            Fk[:, :, k] = np.where(lane == 0, NEG, Fa) if k == 0 else Fa
            Fa = np.maximum(seen(Fa - e_ins), np.where(in_band[:, :, k], M[:, :, k] - oe_ins, INT_MIN))
        Hn = np.maximum(np.maximum(M, E), Fk)
        d = np.where(M >= E, 0, 1)
        d = np.where(np.maximum(M, E) >= Fk, d, 2)
        d = d | np.where(seen(E - e_del) > M - oe_del, 4, 0)
        d = d | np.where(seen(Fk - e_ins) > M - oe_ins, 32, 0)
        En = np.maximum(E - e_del, M - oe_del)
        work = (valid & active)[:, :, None]
        idle = (valid & ~active)[:, :, None]     # no DP: H = E = -inf, F falls, no z
        kept = in_band if mask_cells else np.ones_like(in_band)
        H = np.where(work, np.where(kept, Hn, NEG), np.where(idle, NEG, H))
        E = np.where(work, np.where(kept, En, NEG), np.where(idle, NEG, E))
        Fout = np.where(valid, np.where(active, Fa, seen(F - S * e_ins)), Fout)
        if want_z:
            zrow = np.where(in_band, d, 0).astype(np.uint8)
            bi, li, ki = np.nonzero(work & (j < qmax))
            z[bi, i[0, li], li * S + ki] = zrow[bi, li, ki]
        diag = hl
        tc = np.where(lane == 0, t0, tl)
        sc = load_scores(tc)

    cell = (j == (qlen - 1)[:, :, None]) & (tlen > 0)[:, :, None]
    score = np.where(cell, H, NEG).max(axis=(1, 2))
    assert low[0] >= -(1 << 31), "a value left int32"
    return score, (z if want_z else None)


def model_traceback(z, qlens, tlens, ws, max_steps):
    """traceback_kernel: one warp per problem, a 32 x 32 window of z in
    shared memory per 32 steps, lane s keeping the op of step s."""
    B, tmax, qmax = z.shape
    lane = np.arange(LANES)
    ops = np.full((max_steps, B), UNWRITTEN, np.int8)
    fi = np.zeros(B, np.int32)
    fk = np.zeros(B, np.int32)
    for b in range(B):
        i = int(tlens[b]) - 1
        k = min(i + int(ws[b]) + 1, int(qlens[b])) - 1
        which = 0
        s0 = 0
        while s0 < max_steps and i >= 0 and k >= 0:
            col = np.clip(k - 31 + lane, 0, qmax - 1)
            win = np.empty(LANES * LANES, np.int64)
            for r in range(LANES):
                win[32 * r + lane] = z[b, min(max(i - r, 0), tmax - 1), col]
            n = min(32, max_steps - s0)
            pos, op = 31, np.full(LANES, 3, np.int8)
            s = 0
            while s < n and i >= 0 and k >= 0:
                nw = (int(win[pos]) >> (which << 1)) & 3
                op[s] = 0 if nw == 0 else (2 if nw == 1 else 1)
                if nw <= 1:
                    i -= 1
                    pos += 32
                if nw != 1:
                    k -= 1
                    pos -= 1
                which = nw
                s += 1
            ops[s0 + lane[lane < n], b] = op[:n]
            s0 += 32
        for first in range(s0, max_steps, 32):
            s = first + lane
            ops[s[s < max_steps], b] = 3
        fi[b], fk[b] = i, k
    return ops, fi, fk


# qmax -> (tmax, problems): strips of 2, 6 and 32 columns
SHAPES = {64: (96, 36), 192: (320, 27), 1024: (1100, 18)}
SETS = ["indel0", "indel1", "indel12", "edges"]


def problem_set(name, qmax):
    tmax, B = SHAPES[qmax]
    if name == "edges":
        qs, ts, ws = edge_global_problems(50 + qmax, B, qmax, tmax)
    else:
        qs, ts, ws = global_problems(60 + qmax, B, qmax, tmax, int(name[5:]))
    return (padded_codes(qs, qmax), padded_codes(ts, tmax), lengths(qs), lengths(ts), ws), tmax


def corner_outside(arrs):
    """Every third problem with the corner cell one column (or row) outside
    the band, where the score is -inf."""
    qlens, tlens, ws = arrs[2:]
    ws[::3] = np.maximum(np.abs(qlens[::3] - tlens[::3]) - 1, 0)
    return arrs


def plain(arrs, want_z=True):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    score, z = global_batch_torch(*t, torch.from_numpy(MAT).int(), **GAPS, want_z=want_z)
    return score.numpy(), (z.numpy() if want_z else None)


@pytest.mark.parametrize("qmax", list(SHAPES))
@pytest.mark.parametrize("name", SETS)
def test_global_model_matches_plain(name, qmax):
    arrs, _ = problem_set(name, qmax)
    want_score, want_z = plain(arrs)
    score, z = model_global(*arrs, want_z=True)
    np.testing.assert_array_equal(score, want_score)
    np.testing.assert_array_equal(z, want_z)
    if name == "edges":
        kinds = np.arange(len(score)) % len(EDGE_GLOBAL_KINDS)
        assert (score[kinds == EDGE_GLOBAL_KINDS.index("tlen=0")] == NEG).all()
        assert (score[kinds == EDGE_GLOBAL_KINDS.index("corner on the band's edge")] > NEG).all()


@pytest.mark.parametrize("qmax", [64, 192])
def test_global_model_score_only_matches_plain(qmax):
    arrs = corner_outside(problem_set("indel12", qmax)[0])
    score, z = model_global(*arrs, want_z=False)
    assert z is None
    np.testing.assert_array_equal(score, plain(arrs, want_z=False)[0])
    assert (score == NEG).any() and (score > NEG).any()


@pytest.mark.parametrize("qmax", list(SHAPES))
@pytest.mark.parametrize("name", SETS)
def test_traceback_model_matches_plain(name, qmax):
    arrs, tmax = problem_set(name, qmax)
    _, z = plain(arrs)
    qlens, tlens, ws = arrs[2:]
    # whole walks, a step count that is no multiple of 32, and walks cut short
    for max_steps in (qmax + tmax, qmax + tmax - 13, 37):
        want = traceback_torch(torch.from_numpy(z), *[torch.from_numpy(a) for a in (qlens, tlens, ws)],
                               max_steps=max_steps)
        got = model_traceback(z, qlens, tlens, ws, max_steps)
        for label, g, r in zip(("ops", "fi", "fk"), got, want):
            np.testing.assert_array_equal(g, r.numpy(), err_msg=f"{label}, max_steps {max_steps}")


def longest_run(col, op):
    best = run = 0
    for x in col:
        run = run + 1 if x == op else 0
        best = max(best, run)
    return best


def test_edge_set_walks_leave_a_window_by_its_top_and_left_edges():
    """The deletion and insertion problems of the edge set walk more than
    32 steps up, and more than 32 steps left, without a diagonal step."""
    arrs, tmax = problem_set("edges", 192)
    _, z = plain(arrs)
    ops, _, _ = model_traceback(z, *arrs[2:], 192 + tmax)
    kinds = np.arange(ops.shape[1]) % len(EDGE_GLOBAL_KINDS)
    for kind, op in (("deletion run", 2), ("insertion run", 1)):
        cols = np.nonzero(kinds == EDGE_GLOBAL_KINDS.index(kind))[0]
        assert len(cols) and all(longest_run(ops[:, b], op) > 32 for b in cols), kind


@pytest.mark.parametrize("broken", ["stale_diag", "mask_cells"])
def test_model_notices_a_broken_trap(broken):
    """Two of the kernel's traps, broken in the model: H(i-1, j0-1) is the
    left lane's last H as it stood a step ago, not as this step's shuffle
    brings it, and a working strip must reset its cells outside the band,
    or the score of a corner there is not -inf."""
    arrs = corner_outside(problem_set("indel12", 192)[0])
    want_score, want_z = plain(arrs)
    kw = {broken: False}
    score, z = model_global(*arrs, want_z=True, **kw)
    assert not (np.array_equal(score, want_score) and np.array_equal(z, want_z))
