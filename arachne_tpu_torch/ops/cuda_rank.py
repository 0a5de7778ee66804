"""K5 launcher: the CUDA occ4 rank kernel (csrc/rank.cu).

Replaces arachne_tpu/ops/pallas_gather.py::_rank_kernel.  The plain
PyTorch version and the CPU/CUDA dispatch live in ``fm_rank``.
"""

from __future__ import annotations

import torch

from . import build


def check_tables(name: str, fm, dev: torch.device) -> int:
    """Raise unless fm's tables are contiguous on ``dev`` with one row dtype
    (int32 or int64), occ and words starting on 16 bytes (rank.cuh reads
    them as 16-byte vectors); returns 1 for wide (int64) tables, else 0."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected a CUDA device")
    idt = fm.occ.dtype
    if idt not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: occ dtype {idt}, expected int32 or int64")
    build.require(fm.occ, "occ", idt, (fm.occ.shape[0], 4), dev)
    build.require(fm.words, "words", torch.int32, (fm.words.shape[0],), dev)
    build.require(fm.L2, "L2", idt, (5,), dev)
    build.require_aligned(fm.occ, "occ", 16)
    build.require_aligned(fm.words, "words", 16)
    return int(idt == torch.int64)


def rank_cuda(fm, k: torch.Tensor) -> torch.Tensor:
    """Launch K5: occ4 of every row in ``k`` (any shape, on fm's device),
    edge rows included; returns (*k.shape, 4) in fm's row dtype."""
    dev = k.device
    wide = check_tables("rank_cuda", fm, dev)
    flat = k.reshape(-1).to(fm.occ.dtype).contiguous()
    n = flat.shape[0]
    out = torch.empty((n, 4), dtype=fm.occ.dtype, device=dev)
    if n:
        build.launch(
            rank_cuda, "arachne_rank", dev,
            fm.occ.data_ptr(), fm.words.data_ptr(), fm.L2.data_ptr(),
            fm.primary, fm.seq_len, wide, flat.data_ptr(), n, out.data_ptr(),
        )
    return out.reshape(*k.shape, 4)


rank_cuda.launches = 0
