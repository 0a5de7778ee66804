"""The reference's own FM-index over forward + reverse complement.

Built here from the genome, independently of the program's index: a suffix
array by prefix doubling in numpy (27 bases a key to start, then only the
groups that are still tied), the BWT with the $ row removed (bwt.c
conventions: ``primary`` is the row of the whole text), occurrence
checkpoints every 128 rows, and the full suffix array kept for lookups
(the sampled-SA walk of bwt.c:86-96 returns exactly SA[k] for every row
but 0, which no seed reaches).  Rank queries are scalar and run on a
``bytes`` copy of the BWT (``bytes.count`` over at most 128 rows), which
is what the scalar seeding of align/smem.py asks for.  The coordinate
functions below are copied from the program's index/fmindex.py.
"""

from __future__ import annotations

import bisect
import json
import os
from array import array
from typing import List, Tuple

import numpy as np

from .build import ContigAnn, AmbHole, PackedReference, pack_reference, parse_fasta, unpack_2bit

OCC_INTERVAL = 128
KEY_BASES = 27          # bases in one base-5 uint64 key (5**27 < 2**63)
_CHARS = (b"\x00", b"\x01", b"\x02", b"\x03")


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """SA (int64, n + 1 entries) of codes$ where $ sorts first."""
    n = len(codes)
    c = np.zeros(n + KEY_BASES, np.uint64)
    c[:n] = codes.astype(np.uint64) + 1
    key = np.zeros(n + 1, np.uint64)
    for j in range(KEY_BASES):
        key *= np.uint64(5)
        key += c[j : j + n + 1]
    del c
    order = np.argsort(key)
    sk = key[order]
    del key
    m = n + 1
    idx = np.arange(m, dtype=np.int64)
    new = np.ones(m, bool)
    new[1:] = sk[1:] != sk[:-1]
    del sk
    start = np.maximum.accumulate(np.where(new, idx, 0))
    rank = np.empty(m, np.int64)
    rank[order] = start
    # sorted-order indices whose group holds more than one suffix
    size_next = np.zeros(m, bool)
    size_next[:-1] = ~new[1:]
    tied = size_next | ~new
    del new, idx
    todo = np.flatnonzero(tied)
    h = KEY_BASES
    while todo.size:
        pos = order[todo]
        g = rank[pos]
        sec = rank[np.minimum(pos + h, m - 1)]
        sec[pos + h >= m] = -1
        perm = np.lexsort((sec, g))
        pos, g, sec = pos[perm], g[perm], sec[perm]
        order[todo] = pos
        brk = np.ones(len(todo), bool)
        brk[1:] = (g[1:] != g[:-1]) | (sec[1:] != sec[:-1])
        first = np.maximum.accumulate(np.where(brk, np.arange(len(todo)), 0))
        rank[pos] = todo[first]
        single = brk.copy()
        single[:-1] &= brk[1:]
        todo = todo[~single]
        h <<= 1
    return order


def build(fasta: str, out_dir: str) -> None:
    """Build the index of ``fasta`` into ``out_dir`` (written into a
    temporary directory beside it and renamed into place when whole)."""
    contigs = parse_fasta(fasta)
    packed = pack_reference(contigs)
    del contigs
    fwd = unpack_2bit(packed.pac, 0, packed.l_pac)
    codes2 = np.concatenate([fwd, (3 - fwd[::-1]).astype(np.uint8)])
    del fwd
    n = len(codes2)
    L2 = np.zeros(5, np.int64)
    np.cumsum(np.bincount(codes2, minlength=4), out=L2[1:])
    sa = suffix_array(codes2)
    primary = int(np.flatnonzero(sa == 0)[0])
    bwt = np.empty(n, np.uint8)
    body = np.delete(sa, primary)
    bwt[:] = codes2[body - 1]
    del body, codes2
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL + 1
    padded = np.full(n_blocks * OCC_INTERVAL, 255, np.uint8)
    padded[:n] = bwt
    blocks = padded.reshape(n_blocks, OCC_INTERVAL)
    occ = np.zeros((n_blocks, 4), np.int64)
    for ch in range(4):
        np.cumsum((blocks == ch).sum(axis=1), out=occ[:, ch])
    occ[1:] = occ[:-1].copy()
    occ[0] = 0
    del padded, blocks
    tmp = f"{out_dir}.partial"
    os.makedirs(tmp, exist_ok=True)
    np.save(os.path.join(tmp, "sa.npy"), sa.astype(np.int32 if n < (1 << 31) else np.int64))
    np.save(os.path.join(tmp, "bwt.npy"), bwt)
    np.save(os.path.join(tmp, "occ.npy"), occ)
    np.save(os.path.join(tmp, "pac.npy"), packed.pac)
    meta = {
        "seq_len": n, "primary": primary, "L2": L2.tolist(), "l_pac": packed.l_pac,
        "anns": [[a.name, a.offset, a.length, a.n_ambs, a.anno] for a in packed.anns],
        "ambs": [[h.offset, h.length, h.amb] for h in packed.ambs],
    }
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp, out_dir)


class FMIndex:
    """The reference's index, loaded from ``build``'s directory."""

    def __init__(self, index_dir: str):
        with open(os.path.join(index_dir, "meta.json")) as fh:
            meta = json.load(fh)
        anns = [ContigAnn(name=a[0], offset=a[1], length=a[2], n_ambs=a[3], anno=a[4])
                for a in meta["anns"]]
        ambs = [AmbHole(offset=h[0], length=h[1], amb=h[2]) for h in meta["ambs"]]
        pac = np.load(os.path.join(index_dir, "pac.npy"))
        self.packed = PackedReference(pac=pac, l_pac=meta["l_pac"], anns=anns, ambs=ambs)
        self.l_pac = meta["l_pac"]
        self.seq_len = meta["seq_len"]
        self.primary = meta["primary"]
        self.L2 = np.asarray(meta["L2"], np.int64)
        self._L2 = [int(v) for v in meta["L2"]]
        self._bwt = np.load(os.path.join(index_dir, "bwt.npy")).tobytes()
        self._occ = array("q", np.load(os.path.join(index_dir, "occ.npy")).tobytes())
        self._sa = np.load(os.path.join(index_dir, "sa.npy"), mmap_mode="r")
        self._offsets = packed_offsets = self.packed.contig_offsets()
        self._offsets_list = packed_offsets.tolist()
        self._lengths = np.array([a.length for a in anns], dtype=np.int64)
        self._name_to_rid = {a.name: i for i, a in enumerate(anns)}
        self._fwd_cache = unpack_2bit(pac, 0, self.l_pac)

    # -- rank queries, scalar (bwt.c:107-220 semantics) ------------------

    def occ4(self, k: int) -> Tuple[int, int, int, int]:
        """Occurrences of each base in BWT rows [0, k] (k == -1: none;
        k == seq_len: all)."""
        if k == -1:
            return (0, 0, 0, 0)
        L2 = self._L2
        if k == self.seq_len:
            return (L2[1] - L2[0], L2[2] - L2[1], L2[3] - L2[2], L2[4] - L2[3])
        kk = k - (k >= self.primary)
        b = kk >> 7
        seg = self._bwt[b << 7 : kk + 1]
        o = self._occ
        i = b * 4
        return (o[i] + seg.count(_CHARS[0]), o[i + 1] + seg.count(_CHARS[1]),
                o[i + 2] + seg.count(_CHARS[2]), o[i + 3] + seg.count(_CHARS[3]))

    def set_intv1(self, c: int) -> Tuple[int, int, int]:
        """bwt_set_intv: the interval of the single base c."""
        L2 = self._L2
        return L2[c] + 1, L2[3 - c] + 1, L2[c + 1] - L2[c]

    def extend1(self, x0: int, x1: int, x2: int, is_back: bool, c: int) -> Tuple[int, int, int]:
        """bwt_extend (bwt.c:262-275) of the bi-interval (x0, x1, x2) by
        base c: returns the new (x0, x1, x2)."""
        xb = x0 if is_back else x1
        tk = self.occ4(xb - 1)
        tl = self.occ4(xb - 1 + x2)
        s = [tl[i] - tk[i] for i in range(4)]
        ok_b = self._L2[c] + 1 + tk[c]
        hit = 1 if xb <= self.primary <= xb + x2 - 1 else 0
        ok_o = (x1 if is_back else x0) + hit
        for i in range(3, c, -1):
            ok_o += s[i]
        if is_back:
            return ok_b, ok_o, s[c]
        return ok_o, ok_b, s[c]

    def sa(self, k: np.ndarray) -> np.ndarray:
        """SA values of BWT rows k."""
        return np.asarray(self._sa[np.asarray(k, dtype=np.int64)], dtype=np.int64)

    # -- reference-store coordinates: copied from the program's fmindex --

    def depos(self, pos: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """bns_depos: map forward-reverse coordinate to forward + strand."""
        pos = np.asarray(pos, dtype=np.int64)
        is_rev = pos >= self.l_pac
        fpos = np.where(is_rev, (self.l_pac << 1) - 1 - pos, pos)
        return fpos, is_rev

    def pos2rid(self, fpos: np.ndarray) -> np.ndarray:
        """bns_pos2rid: contig id for forward positions; -1 if >= l_pac."""
        fpos = np.asarray(fpos, dtype=np.int64)
        rid = np.searchsorted(self._offsets, fpos, side="right") - 1
        return np.where(fpos >= self.l_pac, -1, rid).astype(np.int64)

    def intv2rid(self, rb: np.ndarray, re: np.ndarray) -> np.ndarray:
        """bns_intv2rid: -2 if bridging strands, -1 if spanning contigs."""
        rb = np.asarray(rb, dtype=np.int64)
        re = np.asarray(re, dtype=np.int64)
        fb, _ = self.depos(rb)
        fe, _ = self.depos(np.maximum(re - 1, rb))
        rid_b = self.pos2rid(fb)
        rid_e = np.where(rb < re, self.pos2rid(fe), rid_b)
        out = np.where(rid_b == rid_e, rid_b, -1)
        bridging = (rb < self.l_pac) & (re > self.l_pac)
        return np.where(bridging, -2, out).astype(np.int64)

    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """bns_get_seq: base codes for [beg, end) on the fwd-rev coordinate.
        Returns empty if the interval bridges the strand boundary."""
        beg, end = int(beg), int(end)
        if end < beg:
            beg, end = end, beg
        end = min(end, self.seq_len)
        beg = max(beg, 0)
        if beg < self.l_pac < end:
            return np.empty(0, dtype=np.uint8)
        fwd = self._fwd_cache
        if beg >= self.l_pac:
            b, e = (self.l_pac << 1) - end, (self.l_pac << 1) - beg
            return (3 - fwd[b:e][::-1]).astype(np.uint8)
        return fwd[beg:end]

    def fetch_seq(self, beg: int, mid: int, end: int) -> Tuple[np.ndarray, int, int, int]:
        """bns_fetch_seq: clamp [beg,end) to the contig containing mid and
        return (seq, rid, clamped_beg, clamped_end)."""
        if end < beg:
            beg, end = end, beg
        mid = int(mid)
        two = self.l_pac << 1
        is_rev = mid >= self.l_pac
        fmid = (two - 1 - mid) if is_rev else mid
        rid = bisect.bisect_right(self._offsets_list, fmid) - 1
        ann = self.packed.anns[rid]
        far_beg = ann.offset
        far_end = far_beg + ann.length
        if is_rev:
            far_beg, far_end = two - far_end, two - far_beg
        beg = max(beg, far_beg)
        end = min(end, far_end)
        return self.get_seq(beg, end), rid, beg, end

    def get_contig_seq(self, chrom: str, start: int, end: int, reversed_: bool = False) -> np.ndarray:
        """GoBwaReference.GetSeq semantics (gobwa.go:50-80): fetch [start,
        end) of a contig by name; optionally reverse-complement."""
        rid = self._name_to_rid[chrom]
        off = self.packed.anns[rid].offset
        seq, _, b, e = self.fetch_seq(start + off, (2 * off + start + end) >> 1, end + off)
        if reversed_:
            return (3 - seq[::-1]).astype(np.uint8)
        return seq

    @property
    def contig_names(self) -> List[str]:
        return [a.name for a in self.packed.anns]

    def rid_of(self, name: str) -> int:
        return self._name_to_rid[name]
