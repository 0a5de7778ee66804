"""Numpy models of the CUDA kernels K3 and K4 (arachne_tpu_torch/ops/csrc/
global.cu), written from the source step for step, against the plain
PyTorch versions ``global_batch_torch`` and ``traceback_torch``; of K1 with
int16 state (csrc/extend.cu ``extend16_kernel``, its packed s16x2 pairs)
against ``extend_batch_torch``; and of K5, S1 and S3 (below).

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
    EDGE_GLOBAL_KINDS, edge_global_problems, extend_problems, global_problems, sideways_z,
)
from arachne_tpu_torch.ops.sw_extend import (
    extend_batch_torch, int16_max_h0, lengths, padded_codes,
)
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
                if which == 2 and nw == 2:
                    nw = 1
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
    """The deletion problems of the edge set walk more than 32 steps up
    without a diagonal step.  ksw.global2's walk never takes two insertion
    steps in a row (its insertion problems turn to deletions), so the left
    edge is left by ``sideways_z``'s walk, alternate insertion and
    diagonal steps, 32 columns every 32 steps; the model equals the plain
    walk on it."""
    arrs, tmax = problem_set("edges", 192)
    _, z = plain(arrs)
    ops, _, _ = model_traceback(z, *arrs[2:], 192 + tmax)
    kinds = np.arange(ops.shape[1]) % len(EDGE_GLOBAL_KINDS)
    for kind, op, runs in (("deletion run", 2, lambda n: n > 32), ("insertion run", 1, lambda n: n == 1)):
        cols = np.nonzero(kinds == EDGE_GLOBAL_KINDS.index(kind))[0]
        assert len(cols) and all(runs(longest_run(ops[:, b], op)) for b in cols), kind
    zs, qlens, tlens, ws = sideways_z(3, 192, 320)
    got = model_traceback(zs, qlens, tlens, ws, 192 + 320)
    want = traceback_torch(torch.from_numpy(zs), *[torch.from_numpy(a) for a in (qlens, tlens, ws)],
                           max_steps=192 + 320)
    for label, g, r in zip(("ops", "fi", "fk"), got, want):
        np.testing.assert_array_equal(g, r.numpy(), err_msg=label)
    walk = got[0][:, 0]
    np.testing.assert_array_equal(walk[:64], np.tile([1, 0], 32))


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


# ----------------------------------------------------------------------
# K1 with int16 DP state (csrc/extend.cu, extend16_kernel) against
# extend_batch_torch.  Words are uint32 holding two int16 halves (the even
# column low, the odd high), as the kernel's registers do; every DPX step,
# byte permute and mask is the kernel's, on the words, with two's-complement
# wrap-around per half (counted in WRAPS: the tests require none).
# ----------------------------------------------------------------------

WRAPS = [0]


def wrap16(x):
    """x (int64) as int16, counting the values that do not fit."""
    y = ((x + 32768) & 0xFFFF) - 32768
    WRAPS[0] += int((y != x).sum())
    return y


def halves(v):
    """(low, high) halves of uint32 words as signed ints."""
    v = np.asarray(v, np.uint32).astype(np.int64)
    return ((v & 0xFFFF) ^ 0x8000) - 0x8000, (((v >> 16) & 0xFFFF) ^ 0x8000) - 0x8000


def join(lo, hi):
    return ((np.asarray(lo, np.int64) & 0xFFFF) | ((np.asarray(hi, np.int64) & 0xFFFF) << 16)
            ).astype(np.uint32)


def per_half(fn, *words):
    parts = [halves(w) for w in words]
    return join(fn(*(p[0] for p in parts)), fn(*(p[1] for p in parts)))


def pack2(x):
    return join(x, x)


def viaddmax(a, b, c, relu=False):
    """__viaddmax_s16x2[_relu]: max(a + b, c[, 0]) per half."""
    floor = 0 if relu else -32768
    return per_half(lambda x, y, z: np.maximum(np.maximum(wrap16(x + y), z), floor), a, b, c)


def add2(a, b):
    return viaddmax(a, b, np.uint32(0x80008000))


def vimax3(a, b, c):
    return per_half(lambda x, y, z: np.maximum(np.maximum(x, y), z), a, b, c)


def vimin_relu(a, b):
    return per_half(lambda x, y: np.maximum(np.minimum(x, y), 0), a, b)


def vibmax(a, b):
    """__vibmax_s16x2: (max(a, b), a >= b in the high half, in the low)."""
    (alo, ahi), (blo, bhi) = halves(a), halves(b)
    return join(np.maximum(alo, blo), np.maximum(ahi, bhi)), ahi >= bhi, alo >= blo


def perm5432(x, y):
    """__byte_perm(x, y, 0x5432): x's high half low, y's low half high."""
    return (x >> np.uint32(16)) | ((y & np.uint32(0xFFFF)) << np.uint32(16))


def warp_excl_prefix_max(x, ident):
    """common.cuh: lane l gets the max of lanes < l, lane 0 ``ident``."""
    v = shfl_up(x, 1)
    v[:, 0] = ident
    lane = np.arange(LANES)[None, :]
    for d in (1, 2, 4, 8, 16):
        v = np.where(lane >= d, np.maximum(v, shfl_up(v, d)), v)
    return v


def model_extend16(qs, ts, qlens, tlens, ws, h0s, mat, *, o_del, e_del, o_ins, e_ins, zdrop,
                   ties_to_odd=True, quirk=True):
    """extend16_kernel<S>: one warp per problem (axis 0), lane l (axis 1)
    owning the pairs of columns l*S + 2p, l*S + 2p + 1 (one word of each
    list below).  A problem stops at its death or its tlen.  The two
    keyword arguments break the model on purpose, to show that the tests
    notice: equal halves of the row max going to the even column, and no
    M-zero mask."""
    B, qmax = qs.shape
    S = arachne_strip(qmax)
    P = S // 2
    i64 = np.int64
    lane = np.arange(LANES)[None, :]
    j0 = lane * S
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    m5 = np.asarray(mat, i64).reshape(25)
    x = np.arange(125)
    pmat = join(m5[5 * (x // 25) + x % 5], m5[5 * (x // 25) + (x // 5) % 5])
    qlen, tlen = qlens.astype(i64), np.minimum(tlens, ts.shape[1]).astype(i64)
    w, h0 = ws.astype(i64), h0s.astype(i64)
    owner = np.where(qlen > 0, (qlen - 1) // S, 0)
    hc = qlen[:, None] - 1 - j0
    hp = hc >> 1
    n_oe_ins, n_oe_del, n_e_del, n_e_ins, n_2e_ins = (
        pack2(-v) for v in (oe_ins, oe_del, e_del, e_ins, 2 * e_ins))

    def code(j):
        jj = np.broadcast_to(j, (B, LANES))
        return np.where(jj < qmax, qs[:, np.minimum(jj[0], qmax - 1)].astype(i64), 4)

    qp, H, E, M, U = [], [], [], [], []
    for p in range(P):
        j = j0 + 2 * p
        qp.append(code(j) + 5 * code(j + 1))
        col = [np.where(jj < qlen[:, None], np.maximum(h0[:, None] - oe_ins - jj * e_ins, 0), 0)
               for jj in (j, j + 1)]
        H.append(join(*col))
        E.append(np.zeros((B, LANES), np.uint32))
        M.append(np.zeros((B, LANES), np.uint32))
        U.append(np.zeros((B, LANES), np.uint32))
    end = qlen.copy()
    maxv = h0.copy()
    max_i, max_j, max_ie, gscore = (np.full(B, -1, i64) for _ in range(4))
    max_off = np.zeros(B, i64)
    live = np.ones(B, bool)
    rows = np.arange(B)
    for i in range(int(tlen.max()) if B else 0):
        go = live & (i < tlen)
        if not go.any():
            break
        tcode = np.where(i < tlen, ts[:, i].astype(i64), 4)[:, None]
        end_used = np.minimum(np.minimum(end, i + w + 1), qlen)
        lo = np.maximum(i - w, 0)
        h1_init = np.where(i - w <= 0, np.maximum(h0 - (o_del + e_del * (i + 1)), 0), 0)
        bound_prev = h0 if i == 0 else np.where(i - 1 - w <= 0,
                                               np.maximum(h0 - (o_del + e_del * i), 0), 0)
        Hleft = shfl_up(H[P - 1], 1)
        Hleft[:, 0] = join(0, bound_prev)
        active = (j0 < end_used[:, None]) & (j0 + S > lo[:, None])

        # M, u and the strip's G (its even and odd columns' chains)
        Gp = np.zeros((B, LANES), np.uint32)
        for p in range(P):
            Hd = perm5432(Hleft if p == 0 else H[p - 1], H[p])
            nz = (vimin_relu(Hd, np.uint32(0x00010001)).astype(np.uint64) * 0xFFFF
                  ).astype(np.uint32) if quirk else np.uint32(0xFFFFFFFF)
            M[p] = np.where(active, add2(Hd, pmat[25 * tcode + qp[p]]) & nz, M[p])
            U[p] = np.where(active, viaddmax(M[p], n_oe_ins, np.uint32(0), relu=True), U[p])
            Gp = viaddmax(Gp, n_2e_ins, U[p])
        glo, ghi = halves(Gp)
        tot = np.where(active, np.maximum(glo - e_ins, ghi) + (j0 + S - 1) * e_ins, 0)
        run_in = warp_excl_prefix_max(tot, 0)

        # H and E, F two columns a step, the lane's reductions
        F0 = np.where(lane == 0, 0, np.maximum(run_in - (j0 - 1) * e_ins, 0))
        F = join(F0, np.maximum(F0 - e_ins, halves(U[0])[0]))
        kb, ke = lo[:, None] - j0, end_used[:, None] - j0
        run = np.zeros((B, LANES), np.uint32)
        ilo = np.full((B, LANES), -1, i64)
        ihi = ilo.copy()
        Hn, En = [], []
        for p in range(P):
            in_band = (np.where((2 * p >= kb) & (2 * p < ke), 0xFFFF, 0)
                       | np.where((2 * p + 1 >= kb) & (2 * p + 1 < ke), 0xFFFF0000, 0)
                       ).astype(np.uint32)
            Hn.append(vimax3(M[p], E[p], F) & in_band)
            En.append(viaddmax(E[p], n_e_del, add2(M[p], n_oe_del), relu=True) & in_band)
            if p + 1 < P:
                F = viaddmax(F, n_2e_ins, viaddmax(U[p], n_e_ins, perm5432(U[p], U[p + 1])))
            run, ge_hi, ge_lo = vibmax(Hn[p], run)
            ilo = np.where(ge_lo, p, ilo)
            ihi = np.where(ge_hi, p, ihi)
        rl, rh = halves(run)
        odd = (rh > rl) | ((rh == rl) & (ihi >= ilo) & ties_to_odd)
        lm = np.where(active, np.where(odd, rh, rl), 0)
        lj = np.where(active, np.where(odd, j0 + 2 * ihi + 1, j0 + 2 * ilo), -1)
        last = np.full((B, LANES), -1, i64)
        last_w = np.zeros((B, LANES), np.uint32)
        for p in range(P):
            sw = Hn[p] | perm5432(En[p], En[p + 1] if p + 1 < P else np.uint32(0))
            last = np.where(sw != 0, p, last)
            last_w = np.where(sw != 0, sw, last_w)
        js = np.where(last >= 0, j0 + 2 * last + 1 + (last_w > 0xFFFF),
                      np.where(En[0] & np.uint32(0xFFFF), j0, -1))
        js = np.where(active, js, -1)
        hw = np.zeros((B, LANES), np.uint32)
        for p in range(P):
            hw = np.where(hp == p, Hn[p], hw)
        hl = np.where(active, np.where(hc & 1, hw >> np.uint32(16), hw & np.uint32(0xFFFF)), 0)
        for p in range(P):
            keep = go[:, None]
            H[p] = np.where(keep, np.where(active, Hn[p], 0), H[p]).astype(np.uint32)
            E[p] = np.where(keep, np.where(active, En[p], 0), E[p]).astype(np.uint32)

        # the warp's reductions and the problem's scalars, as in int32
        m = lm.max(axis=1)
        mj = np.where(lm == m[:, None], lj, -1).max(axis=1)
        js = js.max(axis=1)
        js = np.where(h1_init != 0, np.maximum(js, 0), js)
        hl = hl[rows, owner].astype(i64)
        ends_q = go & (end_used == qlen)
        max_ie = np.where(ends_q & ~(gscore > hl), i, max_ie)
        gscore = np.where(ends_q, np.maximum(gscore, hl), gscore)
        improved = m > maxv
        di, dj = i - max_i, mj - max_j
        zdropped = (np.where(di > dj, maxv - m - (di - dj) * e_del > zdrop,
                             maxv - m - (dj - di) * e_ins > zdrop) if zdrop > 0 else False)
        die = (m == 0) | (~improved & zdropped)
        upd = go & improved
        maxv = np.where(upd, m, maxv)
        max_i = np.where(upd, i, max_i)
        max_j = np.where(upd, mj, max_j)
        max_off = np.where(upd, np.maximum(max_off, np.abs(mj - i)), max_off)
        end = np.where(go & ~die, np.minimum(js + 2, qlen), end)
        live &= ~(go & die)
    return np.stack([maxv, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off])


# qmax -> (strip width S, tmax, problems): each of the kernel's strip widths
EXTEND16_SHAPES = {64: (2, 96, 30), 128: (4, 160, 30), 192: (6, 260, 24), 256: (8, 300, 20),
                   384: (12, 420, 16), 512: (16, 540, 12), 768: (24, 800, 10),
                   1024: (32, 1060, 8)}


def extend16_problems(qmax):
    """K1 problems (``extend_problems``) with the edges of the warp-per-problem
    design: w = 0, h0 = 0, a problem that dies on row 0, tlen = 0, a
    one-base query, a query as long as qmax, and runs of N in the query,
    whose equal scores make ties within a pair."""
    _, tmax, B = EXTEND16_SHAPES[qmax]
    qs, ts, ws, h0s = extend_problems(70 + qmax, B, qmax, tmax, OPT)
    rng = np.random.default_rng(qmax)
    for b in range(B):
        kind = b % 8
        if kind == 0:
            ws[b] = 0
        elif kind == 1:
            h0s[b] = 0
        elif kind == 2:
            qs[b] = np.zeros(max(len(qs[b]), 1), np.int8)
            ts[b] = np.ones(len(ts[b]), np.int8)
            h0s[b] = 1
        elif kind == 3:
            ts[b] = ts[b][:0]
        elif kind == 4:
            qs[b], ts[b] = qs[b][:1], ts[b][:2]
        elif kind == 5:
            ts[b] = rng.integers(0, 4, tmax).astype(np.int8)
            qs[b] = ts[b][:qmax].copy()
            ws[b], h0s[b] = 100, 60
        elif kind == 6 and len(qs[b]) > 12:
            at = int(rng.integers(0, len(qs[b]) - 10))
            qs[b] = qs[b].copy()
            qs[b][at: at + 9] = 4
    return [padded_codes(qs, qmax), padded_codes(ts, tmax), lengths(qs), lengths(ts), ws, h0s]


def plain_extend(arrs, opt=OPT, wide_state=True):
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    mat = torch.as_tensor(opt.scoring_matrix(), dtype=torch.int32)
    return extend_batch_torch(*t, mat, o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                              e_ins=opt.e_ins, zdrop=opt.zdrop, wide_state=wide_state).numpy()


def run_model16(arrs, opt=OPT, **kw):
    """The model's outputs and the number of halves that wrapped."""
    WRAPS[0] = 0
    got = model_extend16(*arrs, opt.scoring_matrix(), o_del=opt.o_del, e_del=opt.e_del,
                         o_ins=opt.o_ins, e_ins=opt.e_ins, zdrop=opt.zdrop, **kw)
    return got, WRAPS[0]


@pytest.mark.parametrize("qmax", list(EXTEND16_SHAPES))
def test_extend16_model_matches_plain(qmax):
    """Every strip width S (2, 4, 6, 8, 12, 16, 24, 32), against the int32
    and the int16 plain versions; no half wraps."""
    assert arachne_strip(qmax) == EXTEND16_SHAPES[qmax][0]
    arrs = extend16_problems(qmax)
    want = plain_extend(arrs)
    np.testing.assert_array_equal(plain_extend(arrs, wide_state=False), want)
    got, wraps = run_model16(arrs)
    np.testing.assert_array_equal(got, want)
    assert wraps == 0


# other scores: a custom matrix (match 2, mismatch -3, gaps 5+2 and 4+1, so
# that e_ins differs from e_del), and free insertions, under which every
# row's H is flat from its max to the band's end: the row max ties across
# pairs and within them
OTHER_SCORES = {
    "custom matrix": MemOptions(a=2, b=3, o_del=5, e_del=2, o_ins=4, e_ins=1, zdrop=60),
    "free insertions": MemOptions(o_ins=0, e_ins=0),
}


@pytest.mark.parametrize("scores", list(OTHER_SCORES))
def test_extend16_model_with_other_scores(scores):
    arrs = extend16_problems(192)
    opt = OTHER_SCORES[scores]
    got, wraps = run_model16(arrs, opt)
    np.testing.assert_array_equal(got, plain_extend(arrs, opt))
    assert wraps == 0


def test_extend16_model_at_the_largest_h0_it_accepts():
    """Every h0 at int16_max_h0, where H and the scan input come within a
    few units of 2^15 - 1: the model still equals int32 and nothing wraps."""
    arrs = extend16_problems(64)
    top = int16_max_h0(64, OPT.scoring_matrix(), OPT.e_ins, o_del=OPT.o_del, e_del=OPT.e_del,
                       o_ins=OPT.o_ins)
    arrs[5] = np.full_like(arrs[5], top)
    got, wraps = run_model16(arrs)
    np.testing.assert_array_equal(got, plain_extend(arrs))
    assert wraps == 0 and got[0].max() > 32_600


@pytest.mark.parametrize("broken", ["ties_to_odd", "quirk"])
def test_extend16_model_notices_a_broken_pair(broken):
    """The two traps of a packed pair, broken in the model: equal halves of
    the row max must go to the odd (later) column, and the M-zero quirk must
    mask each half on its own."""
    arrs = extend16_problems(192)
    opt = OTHER_SCORES["free insertions"] if broken == "ties_to_odd" else OPT
    got, _ = run_model16(arrs, opt, **{broken: False})
    assert not np.array_equal(got, plain_extend(arrs, opt))


# ----------------------------------------------------------------------
# K5's occ4 routine (csrc/rank.cuh), read from the 64-byte record table,
# K5's group of four lanes a query (csrc/rank.cu), and the seeding state
# machines S1 and S3 (csrc/seed.cu) that inline the routine, against
# occ4_torch, smem_pass_torch and pass3_torch.  A thread runs one read, so the models run one read at a
# time, in rounds as the kernels do: a round is one round trip of rank
# loads (a forward extend, or one group of G carried intervals of a
# backward step).  The kernels' workspace is modelled by two interval
# buffers that swap roles, the first read in reverse after a forward sweep.
# ----------------------------------------------------------------------

M32 = 0xFFFFFFFF
BASE_LANE = 0x55555555


def popc(v):
    """__popc of 32-bit values held in int64."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


class Tabs:
    """A DeviceFMIndex's record table, or a ShardedFMIndex's shards, as
    numpy: each 64-byte record as 16 uint32 (held in int64), and the
    block's counts and words read from it as rank.cuh reads them (chunk 0,
    or chunks 0-1 for int64, then two chunks of words)."""

    def __init__(self, fm):
        from arachne_tpu_torch.ops.fm_rank import ShardedFMIndex

        def records(t):
            return t.numpy().view(np.uint32).reshape(-1, 16).astype(np.int64)

        # the table as ranges of ``per`` records: a flat table is one range
        if isinstance(fm, ShardedFMIndex):
            self.ranges, self.per = np.stack([records(t) for t in fm.shards]), fm.per
        else:
            self.ranges = records(fm.table)[None]
            self.per = self.ranges.shape[1]
        self.cc = 2 if fm.idt == torch.int64 else 1   # arachne_count_chunks
        self.L2 = fm.L2.numpy().astype(np.int64)
        self.primary, self.seq_len = int(fm.primary), int(fm.seq_len)

    def record(self, block):
        """arachne_record: record block % per of range block / per."""
        s = block // self.per
        return self.ranges[s, block - s * self.per]

    def counts(self, rec):
        """(..., 4) checkpoint counts of records rec (..., 16)."""
        if self.cc == 1:
            return rec[..., 0:4]
        return rec[..., 0:8:2] | (rec[..., 1:8:2] << 32)

    def words(self, rec):
        """(..., 8) words of records rec (..., 16)."""
        return rec[..., 4 * self.cc : 4 * self.cc + 8]


def word_masks(j, x):
    """arachne_word_mask of words x for rows at base j of their block."""
    wi, p = j >> 4, j & 15
    part = ~((1 << (2 * (15 - p))) - 1) & M32
    return np.where(x < wi, M32, np.where(x == wi, part, 0))


def count_pairs(v):
    """arachne_count_pair over words v (..., 2m): C, G and T counted two
    words to a popcount, the second on the odd bits; returns (c1, c2, c3)."""
    lo = (v[..., 0::2] & BASE_LANE) | ((v[..., 1::2] & BASE_LANE) << 1)
    hi = ((v[..., 0::2] >> 1) & BASE_LANE) | (((v[..., 1::2] >> 1) & BASE_LANE) << 1)
    t = popc(lo & hi)
    return (popc(lo) - t).sum(-1), (popc(hi) - t).sum(-1), t.sum(-1)


def occ4_finish(tab, k, j, base, c1, c2, c3):
    """arachne_occ4_finish for c = 0..3: the counts on the checkpoint row,
    A the rest of the j + 1 bases; the -1 and seq_len edges by selects."""
    out = base + np.stack([j + 1 - c1 - c2 - c3, c1, c2, c3], axis=-1)
    out = np.where((k == -1)[..., None], 0, out)
    return np.where((k == tab.seq_len)[..., None], tab.L2[1:] - tab.L2[:-1], out)


def model_occ4(tab, k):
    """arachne_occ4_count(arachne_occ4_load(k)) for every row of k (...,):
    returns (..., 4).  The query's record is loaded whole; each word is
    masked by a select (whole below the row's word, bases 0..p in it,
    nothing above); the -1 and seq_len edges are selects after the
    loads."""
    k = np.asarray(k, np.int64)
    kk = np.clip(k - (k >= tab.primary), 0, tab.seq_len - 1)
    rec = tab.record(kk >> 7)
    j = kk & 127
    v = tab.words(rec) & word_masks(j[..., None], np.arange(8))
    return occ4_finish(tab, k, j, tab.counts(rec), *count_pairs(v))


def model_rank_group(tab, ks):
    """rank_group_kernel of rank.cu for queries ks (n,): lane l of a query's
    group of four holds chunk l of its record (nothing past the query's
    chunks); the lanes that hold words count C, G and T in their four
    words (every other lane's masks are 0), packed ten bits apiece; two
    xor shuffles (1, then 2) sum the packs over the group; lanes below the
    count chunks finish the query from their own chunk's counts, two for
    int64 (lane h counts 2h and 2h + 1), four for int32.  Returns (n, 4)."""
    k = np.asarray(ks, np.int64)
    kk = np.clip(k - (k >= tab.primary), 0, tab.seq_len - 1)
    j = kk & 127
    rec = tab.record(kk >> 7)
    lane = np.arange(4)
    chunk = np.where((lane < tab.cc + 2)[:, None], rec.reshape(-1, 4, 4), 0)   # (n, lane, 4)
    h = lane - tab.cc
    x = 4 * h[:, None] + np.arange(4)                                          # (lane, 4)
    masks = np.where(((h == 0) | (h == 1))[:, None], word_masks(j[:, None, None], x), 0)
    c1, c2, c3 = count_pairs(chunk & masks)                                    # (n, lane)
    packed = c1 | (c2 << 10) | (c3 << 20)
    packed = packed + packed[:, lane ^ 1]
    packed = packed + packed[:, lane ^ 2]
    out = np.zeros((len(k), 4), np.int64)
    for l in range(tab.cc):
        p, c = packed[:, l], chunk[:, l]
        cols = slice(0, 4) if tab.cc == 1 else slice(2 * l, 2 * l + 2)
        base = np.zeros((len(k), 4), np.int64)
        base[:, cols] = c if tab.cc == 1 else np.stack([c[:, 0] | (c[:, 1] << 32),
                                                        c[:, 2] | (c[:, 3] << 32)], axis=-1)
        out[:, cols] = occ4_finish(tab, k, j, base, p & 1023, (p >> 10) & 1023, p >> 20)[:, cols]
    return out


def model_extend(tab, xb, x2, xo, is_back, c):
    """Tables::issue then Tables::finish of seed.cu, for arrays of extends
    (one round's loads all issued before any count)."""
    tk, tl = model_occ4(tab, np.stack([xb - 1, xb - 1 + x2]))
    hit = ((xb <= tab.primary) & (xb + x2 - 1 >= tab.primary)).astype(np.int64)
    o = xo + hit
    for d in (1, 2, 3):
        o = o + np.where(d > c, tl[..., d] - tk[..., d], 0)
    b = tab.L2[c] + 1 + tk[..., c]
    s = tl[..., c] - tk[..., c]
    return (b, o, s) if is_back else (o, b, s)


def code_at(q, qlen, x):
    return int(q[x]) if 0 <= x < qlen else 4


PH_PIVOT, PH_FWD, PH_BACK, PH_DONE = range(4)


class S1Thread:
    """smem_pass_kernel<T, G> as one thread runs it on one read; ``rounds``
    lists the extends of each of its rounds (one round trip each)."""

    def __init__(self, tab, q, qlen, pivot0, min_intv, single_sweep, L, MAXC, MAXS, G):
        self.tab, self.q, self.qlen, self.min_intv = tab, q, qlen, min_intv
        self.single_sweep, self.MAXC, self.MAXS, self.G = single_sweep, MAXC, MAXS, G
        self.cap = 16 * L + 64
        self.bufs = [[None] * MAXC, [None] * MAXC]
        self.cur, self.prv = 0, 1               # which buffer is curr, which prev
        self.mem = [None] * MAXS                # this sweep's SMEMs, qb descending
        self.out = []
        self.curr_n = self.prev_n = self.mem_n = 0
        self.prev_rev = self.ovf = False
        self.phase = PH_PIVOT
        self.x = self.pivot = pivot0
        self.i = 0
        self.ik = (0, 0, 0, 0)                  # k, l, s, info
        self.rounds = []                        # extends of each round

    def code(self, x):
        return int(self.q[x]) if 0 <= x < self.qlen else 4

    def push_curr(self, item):
        if self.curr_n >= self.MAXC:
            self.ovf = True
        else:
            self.bufs[self.cur][self.curr_n] = tuple(item)
            self.curr_n += 1

    def begin_back_step(self):
        self.cb = self.code(self.i)
        self.c_ok = self.i >= 0 and self.cb < 4
        self.j0, self.ncurr, self.last_s = 0, 0, -1

    def turn_back(self):
        last = min(max(self.curr_n - 1, 0), self.MAXC - 1)
        self.x = self.bufs[self.cur][last][3]
        self.cur, self.prv = self.prv, self.cur
        self.prev_n, self.prev_rev = self.curr_n, True
        self.i = self.pivot - 1
        self.phase = PH_BACK
        self.begin_back_step()

    def run(self):
        step = 0
        while True:
            while self.phase == PH_PIVOT and step < self.cap:
                x = self.x
                self.pivot = x
                c = self.code(x)
                if x >= self.qlen:
                    self.phase = PH_DONE
                    step += 1
                elif c >= 4:
                    self.x = x + 1
                    step += 1
                else:
                    L2 = self.tab.L2
                    self.ik = (L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c], x + 1)
                    self.i, self.curr_n, self.mem_n = x + 1, 0, 0
                    self.phase = PH_FWD
            if self.phase == PH_DONE or step >= self.cap:
                return self.out, self.ovf
            self.rounds.append(1 if self.phase == PH_FWD else min(self.G, self.prev_n - self.j0))
            if self.phase == PH_FWD:
                if self.forward():
                    self.turn_back()        # the step goes on backward
                else:
                    step += 1
            elif self.back_group():
                step += 1

    def forward(self):
        """One forward step; True when the sweep turns back."""
        i, ik = self.i, self.ik
        ci = self.code(i)
        if i >= self.qlen or ci >= 4:
            self.push_curr(ik)               # terminal
            return True
        n0, n1, ns = (int(v) for v in model_extend(
            self.tab, np.int64(ik[1]), np.int64(ik[2]), np.int64(ik[0]), False, 3 - ci))
        changed = ns != ik[2]
        if changed:
            self.push_curr(ik)
        if changed and ns < self.min_intv:  # too small
            return True
        self.ik = (n0, n1, ns, i + 1)
        self.i = i + 1
        if self.i >= self.qlen:             # reached the end
            self.push_curr(self.ik)
            return True
        return False

    def back_group(self):
        """The next group of up to G carried intervals of the backward
        step; True when the step is over."""
        i, G = self.i, self.G
        n = min(G, self.prev_n - self.j0)
        slots = [self.prev_n - 1 - (self.j0 + g) if self.prev_rev else self.j0 + g
                 for g in range(max(n, 0))]
        items = [self.bufs[self.prv][s] for s in slots]
        if items:                           # the group's queries, all at once
            pk, pl, ps = (np.array([it[f] for it in items], np.int64) for f in range(3))
            ext = model_extend(self.tab, pk, np.maximum(ps, 0), pl, True, self.cb & 3)
        for g, it in enumerate(items):      # then the bookkeeping, in order
            nb0 = nb1 = nbs = 0
            keep = True
            if self.c_ok:
                nb0, nb1, nbs = (int(e[g]) for e in ext)
                keep = nbs < self.min_intv
            if keep:
                no_contain = self.mem_n == 0 or i + 1 < self.mem[min(self.mem_n - 1, self.MAXS - 1)][3]
                if self.ncurr == 0 and no_contain:
                    if self.mem_n >= self.MAXS:
                        self.ovf = True
                    else:
                        self.mem[self.mem_n] = (it[0], it[1], it[2], i + 1, it[3])
                        self.mem_n += 1
            elif self.ncurr == 0 or nbs != self.last_s:
                if self.ncurr >= self.MAXC:
                    self.ovf = True
                else:
                    self.bufs[self.cur][self.ncurr] = (nb0, nb1, nbs, it[3])
                    self.ncurr += 1
                self.last_s = nbs
        self.j0 += max(n, 0)
        if self.j0 < self.prev_n:
            return False
        if self.ncurr != 0 and i >= 0:      # the new intervals become prev
            self.cur, self.prv = self.prv, self.cur
            self.prev_n, self.prev_rev = self.ncurr, False
            self.i = i - 1
            self.begin_back_step()
        else:                               # sweep done: append, ascending qb
            n_out = len(self.out)
            self.out += [self.mem[self.mem_n - 1 - t]
                         for t in range(min(self.mem_n, self.MAXS - n_out))]
            self.ovf |= n_out + self.mem_n > self.MAXS
            self.phase = PH_DONE if self.single_sweep else PH_PIVOT
        return True


def model_pass3_read(tab, q, qlen, min_seed_len, max_intv, L, MAXS):
    """pass3_kernel for one read: (out rows, overflow, extends)."""
    def code(x):
        return int(q[x]) if 0 <= x < qlen else 4

    x = i = 0
    ik = (0, 0, 0)
    scanning = done = ovf = False
    out = []
    extends = 0
    step = 0
    while step < 8 * L + 64 and not done:
        if not scanning:
            cx = code(x)
            if x >= qlen:
                done = True
            elif cx >= 4:
                x += 1
            else:
                ik = (tab.L2[cx] + 1, tab.L2[3 - cx] + 1, tab.L2[cx + 1] - tab.L2[cx])
                i, scanning = x + 1, True
        if scanning:
            extends += 1                    # its loads go out before the code is read
            ci = code(i)
            at_end = i >= qlen
            hit_n = not at_end and ci >= 4
            emit = False
            if not at_end and not hit_n:
                n0, n1, ns = (int(v) for v in model_extend(
                    tab, np.int64(ik[1]), np.int64(ik[2]), np.int64(ik[0]), False, 3 - ci))
                emit = ns < max_intv and i - x >= min_seed_len
                if emit and ns > 0:
                    if len(out) >= MAXS:
                        ovf = True
                    else:
                        out.append((n0, n1, ns, x, i + 1))
                if not emit:
                    ik = (n0, n1, ns)
                    i += 1
            if at_end or hit_n or emit:
                x = qlen if at_end else i + 1
                scanning = False
        step += 1
    return out, ovf, extends


def as_outputs(rows, ovfs, MAXS):
    """Per-read rows as the kernels' (out (R, MAXS, 5), out_n, overflow)."""
    out = np.zeros((len(rows), MAXS, 5), np.int64)
    for r, rr in enumerate(rows):
        if rr:
            out[r, : len(rr)] = rr
    return out, np.array([len(rr) for rr in rows]), np.array(ovfs)


def model_smem_pass(tab, qs, qlens, pivots0, min_intvs, single_sweep, MAXC, MAXS, G):
    L = qs.shape[1]
    threads = [S1Thread(tab, qs[r], int(qlens[r]), int(pivots0[r]), int(min_intvs[r]),
                        single_sweep, L, MAXC, MAXS, G) for r in range(len(qs))]
    res = [t.run() for t in threads]
    return as_outputs([o for o, _ in res], [v for _, v in res], MAXS), [t.rounds for t in threads]


def model_pass3(tab, qs, qlens, min_seed_len, max_intv, MAXS):
    L = qs.shape[1]
    res = [model_pass3_read(tab, qs[r], int(qlens[r]), min_seed_len, max_intv, L, MAXS)
           for r in range(len(qs))]
    return as_outputs([o for o, _, _ in res], [v for _, v, _ in res], MAXS), [e for _, _, e in res]


@pytest.fixture(scope="module")
def seed_index():
    """A 40 kbp random genome with a planted 2 kbp repeat (reads from it
    carry many intervals backward), its index and its forward strand."""
    from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit

    rng = np.random.default_rng(25)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40_000)])
    seq = seq[:9000] + seq[2000:4000] + seq[9000:]
    packed = pack_reference([("chr1", "", seq)])
    return FMIndex(packed, build_fmindex(packed)), unpack_2bit(packed.pac, 0, packed.l_pac)


def seed_reads(fwd, n, seed):
    """n reads of 150 bases, every third with 1-3 Ns and every fourth from
    the planted repeat, then the edge reads: all N, one base, and 192
    bases (qlen = L once padded)."""
    from arachne_tpu_torch.seeding_bench import sample_reads

    rng = np.random.default_rng(seed)
    reads = sample_reads(fwd, n, seed=seed)
    for r, read in enumerate(reads):
        if r % 4 == 1:
            at = 2000 + int(rng.integers(0, 1850))
            read[:] = fwd[at : at + 150]
        if r % 3 == 0:
            read[rng.integers(0, 150, int(rng.integers(1, 4)))] = 4
    return reads + [np.full(150, 4, np.uint8), fwd[500:501].copy(), fwd[7000:7192].copy()]


_PLAIN = {}


def seed_case(seed_index, wide, small, shards=1):
    """(Tabs, DeviceFMIndex, qs, qlens, pass-2 pivots, min_intvs) on the
    CPU; ``small`` cuts 12 reads to 30 bases at a width L of 32, for
    buffers that overflow, whose reads spin to the step cap (16 L + 64).
    With ``shards`` > 1 the Tabs read the table split into that many
    ranges (ShardedFMIndex), the DeviceFMIndex stays whole."""
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, ShardedFMIndex
    from arachne_tpu_torch.ops.fm_seed import pad_reads

    idx, fwd = seed_index
    reads = seed_reads(fwd, 24, 27)
    if small:
        reads = [r[:30] for r in reads[:9] + reads[-3:]]
    fm = DeviceFMIndex.from_host(idx, "cpu", wide=wide)
    qs, qlens = pad_reads(reads, "cpu")
    qs, qlens = qs[: len(reads), : 32 if small else None].contiguous(), qlens[: len(reads)]
    rng = np.random.default_rng(28)
    pivots = (rng.integers(0, 1 << 20, len(reads)) % np.maximum(qlens.numpy(), 1)).astype(np.int32)
    minis = rng.integers(1, 4, len(reads)).astype(np.int32)
    tab = Tabs(fm if shards == 1 else ShardedFMIndex(fm, ["cpu"] * shards))
    return tab, fm, qs, qlens, pivots, minis


def plain_smem(seed_index, wide, small, single_sweep, MAXC, MAXS):
    from arachne_tpu_torch.ops.fm_seed import smem_pass_torch

    key = (wide, small, single_sweep, MAXC, MAXS)
    if key not in _PLAIN:
        _, fm, qs, qlens, pivots, minis = seed_case(seed_index, wide, small)
        R = len(qs)
        piv = torch.from_numpy(pivots) if single_sweep else torch.zeros(R, dtype=torch.int32)
        mi = torch.from_numpy(minis) if single_sweep else torch.ones(R, dtype=torch.int32)
        _PLAIN[key] = [t.numpy() for t in smem_pass_torch(fm, qs, qlens, piv, mi, single_sweep,
                                                          MAXC, MAXS)]
    return _PLAIN[key]


def model_table(seed_index, table):
    """(the plain version's DeviceFMIndex, the model's Tabs): the seed
    index narrow or wide, or 64 blocks of random words and counts; "in n
    shards" splits the model's table into n ranges (ShardedFMIndex), the
    last padded."""
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, ShardedFMIndex
    from arachne_tpu_torch.seeding_bench import synthetic_table

    kind, _, n = table.partition(" in ")
    if kind == "random words":
        fm = synthetic_table("cpu", 64)
    else:
        fm = DeviceFMIndex.from_host(seed_index[0], "cpu", wide=kind == "wide")
    shards = int(n.split()[0]) if n else 1
    return fm, Tabs(fm if shards == 1 else ShardedFMIndex(fm, ["cpu"] * shards))


MODEL_TABLES = ["narrow", "wide", "random words", "narrow in 3 shards", "wide in 2 shards",
                "random words in 8 shards"]


@pytest.mark.parametrize("table", MODEL_TABLES)
def test_occ4_model_matches_plain_on_every_row(seed_index, table):
    """Every row from -1 to seq_len (so 0, primary - 1, primary, primary +
    1, seq_len - 1 and seq_len among them) of the index, narrow and wide,
    and of 64 blocks of random words and counts, each also read through a
    shard table."""
    from arachne_tpu_torch.ops.fm_rank import occ4_torch

    fm, tab = model_table(seed_index, table)
    ks = np.arange(-1, fm.seq_len + 1, dtype=np.int64)
    want = occ4_torch(fm, torch.from_numpy(ks).to(fm.idt)).numpy()
    np.testing.assert_array_equal(model_occ4(tab, ks), want)


@pytest.mark.parametrize("table", MODEL_TABLES)
def test_rank_group_model_matches_plain_on_every_row(seed_index, table):
    """K5's four lanes a query, on every row from -1 to seq_len of the seed
    index, narrow and wide, and of 64 blocks of random words and counts,
    each also read through a shard table."""
    from arachne_tpu_torch.ops.fm_rank import occ4_torch

    fm, tab = model_table(seed_index, table)
    ks = np.arange(-1, fm.seq_len + 1, dtype=np.int64)
    want = occ4_torch(fm, torch.from_numpy(ks).to(fm.idt)).numpy()
    np.testing.assert_array_equal(model_rank_group(tab, ks), want)


S1_MODEL_CASES = (
    [(G, ss, "sized", False, 1) for G in (1, 2, 3, 4, 16) for ss in (False, True)]
    + [(3, False, "2x4", False, 1), (3, True, "2x4", False, 1), (16, False, "2x4", False, 1)]
    + [(4, ss, "sized", True, 1) for ss in (False, True)]
    + [(2, ss, "sized", w, n) for ss in (False, True) for w, n in ((False, 3), (True, 2))]
    + [(2, False, "2x4", False, 3)]
)


@pytest.mark.parametrize(
    "G,single_sweep,bufs,wide,shards", S1_MODEL_CASES,
    ids=[f"G{G}-{'pass2' if s else 'pass1'}-{b}-{'wide' if w else 'narrow'}"
         + (f"-{n}shards" if n > 1 else "") for G, s, b, w, n in S1_MODEL_CASES])
def test_smem_model_matches_plain(seed_index, G, single_sweep, bufs, wide, shards):
    """S1 with its backward steps in groups of G against smem_pass_torch:
    pass 1 (pivot 0, min_intv 1) and single sweeps from random pivots with
    min_intv 1..3, at seed_buffers(L) and at MAXC 2 / MAXS 4, which
    overflow and make reads spin to the step cap; at the kernel's group of
    2 also with the table read through a shard table."""
    from arachne_tpu_torch.ops.fm_seed import seed_buffers

    small = bufs == "2x4"
    tab, _, qs, qlens, pivots, minis = seed_case(seed_index, wide, small, shards)
    R, L = qs.shape
    MAXC, MAXS = (2, 4) if small else (seed_buffers(L),) * 2
    piv = pivots if single_sweep else np.zeros(R, np.int32)
    mi = minis if single_sweep else np.ones(R, np.int32)
    got, rounds = model_smem_pass(tab, qs.numpy(), qlens.numpy(), piv, mi, single_sweep,
                                  MAXC, MAXS, G)
    want = plain_smem(seed_index, wide, small, single_sweep, MAXC, MAXS)
    for label, g, w in zip(("out", "out_n", "overflow"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=label)
    assert bool(want[2].any()) == small and int(want[1].sum()) > 0


@pytest.mark.parametrize("wide,MAXS,shards", [(False, None, 1), (True, None, 1), (False, 4, 1),
                                               (False, None, 3), (True, None, 2)],
                         ids=["narrow-sized", "wide-sized", "narrow-MAXS4", "narrow-sized-3shards",
                              "wide-sized-2shards"])
def test_pass3_model_matches_plain(seed_index, wide, MAXS, shards):
    from arachne_tpu_torch.ops.fm_seed import pass3_torch, seed_buffers

    tab, fm, qs, qlens, _, _ = seed_case(seed_index, wide, False, shards)
    MAXS = MAXS or seed_buffers(qs.shape[1])
    got, _ = model_pass3(tab, qs.numpy(), qlens.numpy(), OPT.min_seed_len, OPT.max_mem_intv, MAXS)
    want = pass3_torch(fm, qs, qlens, OPT.min_seed_len, OPT.max_mem_intv, MAXS)
    for label, g, w in zip(("out", "out_n", "overflow"), got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=label)
    assert bool(want[2].any()) == (MAXS == 4)


def warp_cost(rounds, lanes=32):
    """(loop iterations, extend slots) of each warp of ``lanes`` consecutive
    reads, from S1Thread.rounds: the warp's threads take their rounds side
    by side, and an iteration counts its largest group's extends one after
    another, so it costs that many slots."""
    cost = []
    for w in range(0, len(rounds), lanes):
        lanes_ = rounds[w : w + lanes]
        n = max(len(r) for r in lanes_)
        cost.append((n, sum(max(r[t] if t < len(r) else 0 for r in lanes_) for t in range(n))))
    return cost


def test_warp_cost_takes_the_largest_group_of_each_iteration():
    assert warp_cost([[1, 1, 3], [1, 2], [1]], lanes=2) == [(3, 1 + 2 + 3), (1, 1)]


if __name__ == "__main__":
    # python tests/test_torch_kernel_model.py [G ...]: the slowest warp's
    # iterations and extend slots for S1's pass 1 on the first 1,024 reads
    # of the main path's library (measure.make_library)
    import sys
    import tempfile

    from arachne_tpu_torch.index import FMIndex, load_index
    from arachne_tpu_torch.measure import library_reads, make_library
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex
    from arachne_tpu_torch.ops.fm_seed import pad_reads, seed_buffers

    with tempfile.TemporaryDirectory() as work:
        ref, r1, r2, *_ = make_library(work)
        tab = Tabs(DeviceFMIndex.from_host(FMIndex(*load_index(ref + ".arx.npz")), "cpu"))
        reads = library_reads(r1, r2, 512)
    qs, qlens = pad_reads(reads, "cpu")
    n, B = len(reads), seed_buffers(qs.shape[1])
    for G in [int(g) for g in sys.argv[1:]] or [1, 2, 4, 8, 16]:
        _, rounds = model_smem_pass(tab, qs.numpy()[:n], qlens.numpy()[:n], np.zeros(n, np.int32),
                                    np.ones(n, np.int32), False, B, B, G)
        cost = warp_cost(rounds)
        print(f"G {G}: slowest warp {max(c[0] for c in cost)} iterations, "
              f"{max(c[1] for c in cost)} extend slots", flush=True)
