"""Device-resident FM-index rank queries (occ4 / bwt_extend) in PyTorch.

The port of arachne_tpu/ops/fm_rank.py.  The planar index layout
(arachne_tpu/index/build.py) uploads as it is: ``occ`` (checkpoint counts
every 128 bases, one row per block plus one past the end) and ``bwt_words``
(16 bases per 32-bit word, first base in the top two bits).  A rank query
gathers one checkpoint row and the block's words, masks the words to the
position and counts each base with the bit trick of bwt.c:98-105.

Row coordinates and counts are int32 for indexes under 2^31 rows
(forward + reverse) and int64 above (the "wide" tables: GRCh38 forward +
reverse is ~6.2e9 rows).  Everything downstream keys off ``occ``'s dtype.

``occ4_device`` is the wrapper of kernel K5 (csrc/rank.cu): the plain
version ``occ4_torch`` for CPU tensors, the kernel for CUDA tensors.
torch has no popcount and its CPU uint32 has no right shift, so the plain
version keeps the words' bit patterns as int32 and does the mask and count
arithmetic in int64 with a SWAR popcount.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from arachne_tpu.index.fmindex import FMIndex

from .cuda_rank import rank_cuda

_LANE = 0x55555555
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class DeviceFMIndex:
    """An index's rank tables on one torch device."""

    occ: torch.Tensor     # (n_blocks + 1, 4) int32, or int64 when wide
    words: torch.Tensor   # (n_blocks * 8,) int32: the uint32 BWT words' bits
    L2: torch.Tensor      # (5,) occ's dtype
    primary: int
    seq_len: int
    l_pac: int

    @property
    def idt(self) -> torch.dtype:
        """Row-coordinate dtype: int64 iff the tables are wide."""
        return self.occ.dtype

    @property
    def device(self) -> torch.device:
        return self.occ.device

    @staticmethod
    def is_wide(idx: FMIndex) -> bool:
        return idx.seq_len >= (1 << 31)

    @staticmethod
    def table_bytes(idx: FMIndex, wide: bool) -> int:
        """Device bytes of the occ and word tables ``from_host`` would upload."""
        return idx.fm.occ.size * (8 if wide else 4) + idx.fm.bwt_words.nbytes

    @staticmethod
    def from_host(idx: FMIndex, device, wide: bool = None) -> "DeviceFMIndex":
        if wide is None:
            wide = DeviceFMIndex.is_wide(idx)
        it = np.int64 if wide else np.int32
        dev = torch.device(device)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return DeviceFMIndex(
            occ=up(idx.fm.occ.astype(it)),
            words=up(idx.fm.bwt_words.view(np.int32)),
            L2=up(np.asarray(idx.fm.L2).astype(it)),
            primary=int(idx.primary),
            seq_len=int(idx.seq_len),
            l_pac=int(idx.l_pac),
        )


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit values held in int64."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def occ4_torch(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: Occ(k, c) for all four bases; k (...,) on fm's
    device, returns (..., 4) in fm.idt.  The reference's row conventions:
    k == -1 -> 0, k == seq_len -> L2[c+1] - L2[c] (bwt.c:169-186)."""
    idt = fm.idt
    k = k.to(idt)
    at_end = k == fm.seq_len
    neg = k == -1
    kk = (k - (k >= fm.primary).to(idt)).clamp(0, fm.seq_len - 1).long()
    block = kk >> 7
    base = fm.occ[block]                                           # (..., 4)
    widx = torch.arange(8, dtype=torch.int64, device=k.device)
    words = fm.words[(block * 8)[..., None] + widx].long() & _M32  # (..., 8)
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


def occ4_device(fm: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """K5 wrapper: plain version for CPU tensors, the kernel for CUDA."""
    if k.device.type == "cpu":
        return occ4_torch(fm, k)
    return rank_cuda(fm, k)


def _extend(fm: DeviceFMIndex, x0, x1, x2, is_back: bool, occ4):
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
    fm: DeviceFMIndex,
    x0: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    is_back: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """bwt_extend (bwt.c:262-275) through the K5 wrapper; shapes (...,) ->
    three (..., 4)."""
    return _extend(fm, x0, x1, x2, is_back, occ4_device)


def extend_torch(
    fm: DeviceFMIndex,
    x0: torch.Tensor,
    x1: torch.Tensor,
    x2: torch.Tensor,
    is_back: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """extend_device over the plain ``occ4_torch`` on any device: the rank
    arithmetic of the plain seeding versions, so that comparing them with
    kernels S1/S3 on the card shares no code with csrc/rank.cuh."""
    return _extend(fm, x0, x1, x2, is_back, occ4_torch)
