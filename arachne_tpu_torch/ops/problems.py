"""Random DP problems for the kernels K1-K4, made with numpy from a seed.

``chip_smoke.py`` checks and times each kernel on them at the main path's
shapes (``MAIN``), the card tests in ``tests/test_torch_cuda.py`` mix edge
cases into them, and ``python -m arachne_tpu_torch.ab`` times two
checkouts' kernels on them.
"""

from __future__ import annotations

import numpy as np

# kernel -> (seed, problems, qmax, tmax) at the shapes the main path's
# batchers give the kernel (chunk size and width floors); K3 z and K4 on
# the set with indels of 1-12 bases (``global_problems(..., 12)``)
MAIN = {
    "K1": (1, 4096, 192, 512),
    "K2": (2, 1024, 192, 768),
    "K3 score": (3, 1024, 192, 320),
    "K3 z": (16, 128, 192, 320),
    "K4": (16, 128, 192, 320),
}


def _mutate(rng, seq, n_sub, indel_len):
    s = seq.copy()
    if n_sub and len(s):
        at = rng.integers(0, len(s), n_sub)
        s[at] = rng.integers(0, 5, n_sub)          # code 4 = N
    if indel_len and len(s) > 2:
        pos = int(rng.integers(1, len(s) - 1))
        if rng.random() < 0.5:
            s = np.delete(s, np.arange(pos, min(pos + indel_len, len(s) - 1)))
        else:
            s = np.insert(s, pos, rng.integers(0, 4, indel_len).astype(s.dtype))
    return s


def extend_problems(seed, B, qmax, tmax, opt):
    """K1 problems: (qs, ts, ws, h0s), the query a mutated prefix of the
    target, bands clamped as the batcher clamps them."""
    from .sw_extend import clamp_band

    rng = np.random.default_rng(seed)
    qs, ts, ws, h0s = [], [], [], []
    max_mat = int(opt.scoring_matrix().max())
    for _ in range(B):
        t = rng.integers(0, 4, int(rng.integers(20, tmax + 1))).astype(np.int8)
        q = _mutate(rng, t[: int(rng.integers(15, qmax + 1))], int(rng.integers(0, 8)),
                    int(rng.integers(0, 6)) if rng.random() < 0.3 else 0)[:qmax]
        qs.append(q)
        ts.append(t)
        w = 100 if rng.random() < 0.7 else int(rng.integers(1, 120))
        ws.append(clamp_band(opt, len(q), w, opt.pen_clip5, max_mat))
        h0s.append(int(rng.integers(19, 120)))
    return qs, ts, np.asarray(ws, np.int32), np.asarray(h0s, np.int32)


def local_problems(seed, B, qmax, tmax):
    """K2 problems: (qs, ts), the query a mutated window of the target, or
    random (no true hit) for about 15% of them."""
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(B):
        t = rng.integers(0, 4, int(rng.integers(tmax // 2, tmax + 1))).astype(np.int8)
        ql = int(rng.integers(60, qmax + 1))
        if rng.random() < 0.15:                       # no true hit
            q = rng.integers(0, 4, ql).astype(np.int8)
        else:
            at = int(rng.integers(0, len(t) - ql))
            q = _mutate(rng, t[at : at + ql], int(rng.integers(0, 12)),
                        int(rng.integers(1, 8)) if rng.random() < 0.3 else 0)[:qmax]
        qs.append(q)
        ts.append(t)
    return qs, ts


def global_problems(seed, B, qmax, tmax, max_indel):
    """CIGAR-stage problems: t is q with substitutions and, for
    ``max_indel`` > 0, indels of 1..max_indel bases (one indel per problem
    when ``max_indel`` is 1, as the simulator makes them; else one to
    three)."""
    rng = np.random.default_rng(seed)
    qs, ts, ws = [], [], []
    for _ in range(B):
        q = rng.integers(0, 4, int(rng.integers(40, qmax + 1))).astype(np.int8)
        t = _mutate(rng, q, int(rng.integers(0, 6)), 0)
        n_indels = 0 if not max_indel else 1 if max_indel == 1 else int(rng.integers(1, 4))
        for _ in range(n_indels):
            t = _mutate(rng, t, 0, int(rng.integers(1, max_indel + 1)))
        t = t[:tmax]
        qs.append(q)
        ts.append(t)
        ws.append(int(rng.integers(max(1, abs(len(q) - len(t))), 101)))
    return qs, ts, np.asarray(ws, np.int32)


# the kinds of ``edge_global_problems``, problem b being of kind b % 9: an
# odd count, so the two warps of a block never hold the same kind
EDGE_GLOBAL_KINDS = (
    "w=0", "w=1", "w>=qmax", "tlen=0", "one-base query", "full size",
    "corner on the band's edge", "deletion run", "insertion run",
)
BAND_CAP = 400      # the widest band the engine gives the CIGAR stage


def edge_global_problems(seed, B, qmax, tmax):
    """K3/K4 problems (qs, ts, ws) at the edges of the warp-per-problem
    kernels, kind by kind (``EDGE_GLOBAL_KINDS``): w = 0 (the band lies
    inside one strip) and w = 1 (it straddles two lanes on some rows); a
    band wider than the query, up to ``BAND_CAP``; tlen = 0; a one-base
    query; qlen = qmax with tlen = tmax; |qlen - tlen| = w, so that the
    corner cell sits on the band's edge; and a deletion and an insertion
    of 36-40 bases, whose walks leave a 32 x 32 window of direction bytes
    by its top and by its left edge."""
    rng = np.random.default_rng(seed)
    span = min(qmax, tmax)
    qs, ts, ws = [], [], []
    for b in range(B):
        kind = EDGE_GLOBAL_KINDS[b % len(EDGE_GLOBAL_KINDS)]
        q = rng.integers(0, 4, int(rng.integers(min(45, span), span + 1))).astype(np.int8)
        t = _mutate(rng, q, int(rng.integers(0, 6)), 0)
        w = int(rng.integers(1, 101))
        if kind == "w=0":
            w = 0
        elif kind == "w=1":
            t, w = _mutate(rng, t, 0, 1)[:tmax], 1
        elif kind == "w>=qmax":
            t = _mutate(rng, t, 0, int(rng.integers(1, 13)))[:tmax]
            w = int(rng.integers(min(qmax, BAND_CAP), BAND_CAP + 1))
        elif kind == "tlen=0":
            t = t[:0]
        elif kind == "one-base query":
            q, t, w = q[:1], t[: int(rng.integers(1, 4))], int(rng.integers(2, 5))
        elif kind == "full size":
            q = rng.integers(0, 4, qmax).astype(np.int8)
            t = np.concatenate([_mutate(rng, q, 3, 0), rng.integers(0, 4, tmax).astype(np.int8)])
            t, w = t[:tmax], min(abs(tmax - qmax) + int(rng.integers(0, 8)), BAND_CAP)
        else:
            n = int(rng.integers(1, 13)) if kind.startswith("corner") else int(rng.integers(36, 41))
            n = min(n, len(q) - 4)
            at = int(rng.integers(2, len(q) - n - 1))
            if kind == "insertion run" or (kind.startswith("corner") and b % 2):
                t = np.delete(q, np.arange(at, at + n))       # the query holds n more bases
            else:
                q, t = np.delete(q, np.arange(at, at + n)), q
            w = n if kind.startswith("corner") else n + int(rng.integers(0, 8))
        qs.append(q)
        ts.append(t)
        ws.append(w)
    return qs, ts, np.asarray(ws, np.int32)


# A read of a simple repeat against a copy of it in the benchmark's
# human-composition genome (``human256m``), as the CIGAR stage gets it:
# ksw.c's walk gives 65M5I80M, the reference's scalar ksw.global2
# 6I47M1D1I15M2D1I80M, and the read's second-best placement, its XS and
# its XC follow the CIGAR.
REPEAT_INSERTION = (
    "ACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCAAACTCACACTCACAATCCACTC"
    "ACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACAGTCACA",
    "ACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACT"
    "CACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACACTCACAGTCACA",
    12,
)


def repeat_insertion_problem():
    """``REPEAT_INSERTION`` as ([q], [t], ws): int8 codes, one problem."""
    q, t, w = REPEAT_INSERTION
    codes = lambda s: np.frombuffer(s.encode(), np.uint8).copy()
    lut = np.full(256, 4, np.int8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.int8)
    return [lut[codes(q)]], [lut[codes(t)]], np.asarray([w], np.int32)


def sideways_z(B, qmax, tmax):
    """Direction bytes of 2 (H from F, no continuation) in every cell: the
    walk alternates insertion and diagonal steps, 32 columns and 16 rows
    every 32 steps, so it leaves K4's 32 x 32 window by its left edge,
    which no walk of ksw.global2 over a DP's bytes does with insertions
    alone (it never takes two in a row).  Returns (z, qlens, tlens, ws)."""
    z = np.full((B, tmax, qmax), 2, np.uint8)
    full = lambda n: np.full(B, n, np.int32)
    return z, full(qmax), full(tmax), full(max(qmax, tmax))


def on_device(dev, qs, ts, qmax, tmax, *per_problem):
    """The problems as the kernels take them, on ``dev``: (B, qmax) and
    (B, tmax) int8 codes padded with N, their lengths, then each
    per-problem int32 array."""
    import torch

    from .sw_extend import lengths, padded_codes

    arrs = (padded_codes(qs, qmax), padded_codes(ts, tmax), lengths(qs), lengths(ts)) + per_problem
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrs]
