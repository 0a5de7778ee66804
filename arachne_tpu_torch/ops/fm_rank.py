"""Device-resident FM-index rank queries (occ4 / bwt_extend) in PyTorch.

The port of arachne_tpu/ops/fm_rank.py.  The host index
(arachne_tpu_torch/index/build.py) is planar: ``occ`` (checkpoint counts
every 128 bases, one row per block plus one past the end) and
``bwt_words`` (16 bases per 32-bit word, first base in the top two bits).
On the device the two are interleaved as BWA interleaves them (bwt.h:
bwt_occ_intv): one 64-byte record per 128-base block, its four checkpoint
counts first and its eight words after them, so that a rank query reads
one aligned 64-byte line, not two lines gigabytes apart.  A rank query
gathers the block's record, masks the words to the position and counts
each base with the bit trick of bwt.c:98-105.

Row coordinates and counts are int32 for indexes under 2^31 rows
(forward + reverse) and int64 above (the "wide" tables: GRCh38 forward +
reverse is ~6.2e9 rows).  Everything downstream keys off the table's dtype.

For genomes whose table a device should not hold whole, ``ShardedFMIndex``
splits the records by block across devices (the port of the reference's
block-sharded tables, arachne_tpu/parallel/mesh.py ShardedFMTables).

``occ4_device`` is the wrapper of kernel K5 (csrc/rank.cu): the plain
version ``occ4_torch`` for CPU tensors, the kernel for CUDA tensors (its
sharded entry point for a ShardedFMIndex).
torch has no popcount and its CPU uint32 has no right shift, so the plain
version keeps the words' bit patterns as int32 and does the mask and count
arithmetic in int64 with a SWAR popcount.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..index.fmindex import FMIndex

from .cuda_rank import RECORD_BYTES, enable_peer_access, rank_cuda, rank_sharded_cuda

_LANE = 0x55555555
_M32 = 0xFFFFFFFF


def _words_view(table: torch.Tensor) -> torch.Tensor:
    """The (..., 8) int32 words of records (..., 16) int32 or (..., 8)
    int64: after the four int32 counts (and before 16 bytes of padding), or
    after the four int64 ones."""
    if table.dtype == torch.int64:
        return table[..., 4:8].view(torch.int32)
    return table[..., 4:12]


@dataclass(frozen=True)
class DeviceFMIndex:
    """An index's rank tables on one torch device: one 64-byte record per
    128-base block and one past the end, (n_blocks + 1, 16) int32 (four
    counts, eight words, four of padding) or (n_blocks + 1, 8) int64 (four
    counts, then the eight words in four int64).  The last record holds the
    one-past-the-end counts and zero words; no query reads those words."""

    table: torch.Tensor
    L2: torch.Tensor      # (5,) the table's dtype
    primary: int
    seq_len: int
    l_pac: int

    @property
    def occ(self) -> torch.Tensor:
        """(n_blocks + 1, 4) checkpoint counts: a view into the table."""
        return self.table[:, 0:4]

    @property
    def words(self) -> torch.Tensor:
        """(n_blocks + 1, 8) int32, the uint32 BWT words' bits: a view into
        the table (the last row zero)."""
        return _words_view(self.table)

    @property
    def idt(self) -> torch.dtype:
        """Row-coordinate dtype: int64 iff the tables are wide."""
        return self.table.dtype

    @property
    def device(self) -> torch.device:
        return self.table.device

    def records(self, block: torch.Tensor) -> torch.Tensor:
        """The records (..., 16) int32 or (..., 8) int64 of blocks (...,)."""
        return self.table[block]

    @staticmethod
    def is_wide(idx: FMIndex) -> bool:
        return idx.seq_len >= (1 << 31)

    @staticmethod
    def table_bytes(idx: FMIndex) -> int:
        """Device bytes of the record table ``from_host`` would upload, at
        either width."""
        return idx.fm.occ.shape[0] * RECORD_BYTES

    @staticmethod
    def record_table(occ: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
        """The record table of planar tables on their device: occ (n, 4)
        int32 or int64, words (8 * (n - 1),) int32."""
        n = occ.shape[0]
        if words.numel() != 8 * (n - 1):
            raise ValueError(f"{words.numel()} words for {n - 1} blocks")
        table = torch.zeros((n, RECORD_BYTES // occ.element_size()), dtype=occ.dtype,
                            device=occ.device)
        table[:, 0:4] = occ
        _words_view(table)[: n - 1] = words.reshape(n - 1, 8)
        return table

    @staticmethod
    def from_planar(occ, words, L2, primary: int, seq_len: int, l_pac: int) -> "DeviceFMIndex":
        """The index of planar tables (torch tensors on one device: occ (n,
        4), words (8 * (n - 1),) int32, L2 (5,) in occ's dtype)."""
        return DeviceFMIndex(table=DeviceFMIndex.record_table(occ, words), L2=L2,
                             primary=int(primary), seq_len=int(seq_len), l_pac=int(l_pac))

    @staticmethod
    def from_host(idx: FMIndex, device, wide: bool = None) -> "DeviceFMIndex":
        """Interleave the host index's planar tables into records on the
        host, then upload the one table."""
        if wide is None:
            wide = DeviceFMIndex.is_wide(idx)
        it = np.int64 if wide else np.int32
        dev = torch.device(device)
        host = DeviceFMIndex.from_planar(
            torch.from_numpy(idx.fm.occ.astype(it)),
            torch.from_numpy(np.ascontiguousarray(idx.fm.bwt_words).view(np.int32)),
            torch.from_numpy(np.asarray(idx.fm.L2).astype(it)),
            idx.primary, idx.seq_len, idx.l_pac,
        )
        return DeviceFMIndex(table=host.table.to(dev), L2=host.L2.to(dev), primary=host.primary,
                             seq_len=host.seq_len, l_pac=host.l_pac)


def split_records(table: torch.Tensor, devices: Sequence) -> Tuple[List[torch.Tensor], int]:
    """Record table ``table`` in ``len(devices)`` contiguous ranges of
    ``per = ceil(rows / n)`` records, range s copied onto devices[s], the
    last padded with zero records (as the reference pads its sharded occ
    and words, arachne_tpu/parallel/mesh.py:123-129); returns (shards,
    per).  The counts stay the whole index's, so the one shard that holds a
    block answers a query alone."""
    n = len(devices)
    rows = table.shape[0]
    per = -(-rows // n)
    shards = []
    for s, dev in enumerate(devices):
        part = table[s * per : (s + 1) * per]
        shard = torch.zeros((per, table.shape[1]), dtype=table.dtype, device=torch.device(dev))
        shard[: part.shape[0]].copy_(part)
        shards.append(shard)
    return shards, per


class ShardedFMIndex:
    """An index's rank tables split by block across devices: shard s holds
    records [s * per, (s + 1) * per) of ``dfm``'s table (split_records), a
    (per, 16) int32 or (per, 8) int64 table on devices[s].  Queries run on
    one device, the seeding device (``device``, devices[0] by default),
    which holds L2 and, when it is a card, the shards' addresses that
    kernels K5, S1 and S3 read records through, each from the card that
    holds it (over NVLink from another card: peer access is enabled here,
    and raises where a pair refuses it; a shard is never copied whole onto
    the seeding card).  It answers what a DeviceFMIndex answers
    (``device``, ``idt``, ``L2``, ``primary``, ``seq_len``, ``l_pac``,
    ``records``), so the seeding path takes either."""

    def __init__(self, dfm: DeviceFMIndex, devices: Sequence, device=None):
        shards, self.per = split_records(dfm.table, devices)
        self.shards = tuple(shards)
        self.primary, self.seq_len, self.l_pac = dfm.primary, dfm.seq_len, dfm.l_pac
        self._seed_from(dfm.L2, devices[0] if device is None else device)

    def _seed_from(self, L2: torch.Tensor, device) -> None:
        dev = torch.device(device)
        self.L2 = L2.to(dev)
        self.pointers = None
        if dev.type == "cuda":
            for shard in self.shards:
                if shard.device.type == "cuda":
                    enable_peer_access(dev, shard.device)
            self.pointers = torch.tensor([t.data_ptr() for t in self.shards], dtype=torch.int64,
                                         device=dev)

    def on(self, device) -> "ShardedFMIndex":
        """The same shards, seeded from ``device``."""
        other = copy.copy(self)
        other._seed_from(self.L2, device)
        return other

    @property
    def idt(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def wide(self) -> bool:
        return self.idt == torch.int64

    @property
    def device(self) -> torch.device:
        return self.L2.device

    def records(self, block: torch.Tensor) -> torch.Tensor:
        """The records of blocks (...,), each gathered from its shard onto
        the blocks' device."""
        dev = block.device
        s = block // self.per
        local = block - s * self.per
        out = torch.empty((*block.shape, self.shards[0].shape[1]), dtype=self.idt, device=dev)
        for i, shard in enumerate(self.shards):
            mine = s == i
            out[mine] = shard[local[mine].to(shard.device)].to(dev)
        return out

    def occ4(self, ks: np.ndarray) -> np.ndarray:
        """Host rank API (numpy in and out, as the reference's
        ShardedFMTables.occ4): K5 on the seeding device."""
        k = torch.from_numpy(np.asarray(ks).astype(np.int64)).to(self.device, self.idt)
        return occ4_device(self, k).cpu().numpy().astype(np.int64)


RankTables = Union[DeviceFMIndex, ShardedFMIndex]


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit values held in int64."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def occ4_torch(fm: RankTables, k: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: Occ(k, c) for all four bases; k (...,) on fm's
    device, returns (..., 4) in fm.idt.  The reference's row conventions:
    k == -1 -> 0, k == seq_len -> L2[c+1] - L2[c] (bwt.c:169-186).  A
    sharded table's records are gathered from their shards."""
    idt = fm.idt
    k = k.to(idt)
    at_end = k == fm.seq_len
    neg = k == -1
    kk = (k - (k >= fm.primary).to(idt)).clamp(0, fm.seq_len - 1).long()
    rec = fm.records(kk >> 7)
    base = rec[..., 0:4]                                           # (..., 4)
    widx = torch.arange(8, dtype=torch.int64, device=k.device)
    words = _words_view(rec).long() & _M32                         # (..., 8)
    j = kk & 127
    wi = (j >> 4)[..., None]
    p = (j & 15)[..., None]
    nvalid = torch.where(widx < wi, 16, torch.where(widx == wi, p + 1, 0))
    # in int64 a shift by 32 (nvalid 0) clears the word: no special case
    mask = (torch.full_like(nvalid, _M32) << ((16 - nvalid) * 2)) & _M32
    y = words & mask
    ny = y ^ _M32
    # base c matches where the high bit of each 2-bit lane is c & 2 and the
    # low bit c & 1: stacked for c = 0..3 on a new axis before the words
    sel_hi = torch.stack([ny, ny, y, y], dim=-2)
    sel_lo = torch.stack([ny, y, ny, y], dim=-2)
    cnt = _popcount32((sel_hi >> 1) & sel_lo & _LANE).sum(dim=-1)   # (..., 4)
    # masked-off bases read as A
    invalid = (16 - nvalid).sum(dim=-1)
    cnt = cnt - torch.stack([invalid] + [torch.zeros_like(invalid)] * 3, dim=-1)
    res = base + cnt.to(idt)
    res = torch.where(neg[..., None], torch.zeros_like(res), res)
    end_vals = (fm.L2[1:5] - fm.L2[0:4]).expand_as(res)
    return torch.where(at_end[..., None], end_vals, res)


def occ4_device(fm: RankTables, k: torch.Tensor) -> torch.Tensor:
    """K5 wrapper: plain version for CPU tensors, the kernel for CUDA (its
    sharded entry point for a ShardedFMIndex)."""
    if k.device.type == "cpu":
        return occ4_torch(fm, k)
    if isinstance(fm, ShardedFMIndex):
        return rank_sharded_cuda(fm, k)
    return rank_cuda(fm, k)


def _extend(fm: RankTables, x0, x1, x2, is_back: bool, occ4):
    xb = x0 if is_back else x1
    tk, tl = occ4(fm, torch.stack([xb - 1, xb - 1 + x2]))
    ok_b = fm.L2[:4] + 1 + tk
    ok_s = tl - tk
    hit_primary = ((xb <= fm.primary) & (xb + x2 - 1 >= fm.primary)).to(fm.idt)
    o3 = (x1 if is_back else x0).to(fm.idt) + hit_primary
    o2 = o3 + ok_s[..., 3]
    o1 = o2 + ok_s[..., 2]
    o0 = o1 + ok_s[..., 1]
    ok_o = torch.stack([o0, o1, o2, o3], dim=-1)
    if is_back:
        return ok_b, ok_o, ok_s
    return ok_o, ok_b, ok_s


def extend_device(
    fm: RankTables,
    x0: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    is_back: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bwt_extend (bwt.c:262-275) through the K5 wrapper; shapes (...,) ->
    three (..., 4)."""
    return _extend(fm, x0, x1, x2, is_back, occ4_device)


def extend_torch(
    fm: RankTables,
    x0: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    is_back: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """extend_device over the plain ``occ4_torch`` on any device: the rank
    arithmetic of the plain seeding versions, so that comparing them with
    kernels S1/S3 on the card shares no code with csrc/rank.cuh."""
    return _extend(fm, x0, x1, x2, is_back, occ4_torch)
