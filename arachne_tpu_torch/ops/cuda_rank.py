"""K5 launcher: the CUDA occ4 rank kernel (csrc/rank.cu).

Replaces arachne_tpu/ops/pallas_gather.py::_rank_kernel.  The plain
PyTorch version and the CPU/CUDA dispatch live in ``fm_rank``.
"""

from __future__ import annotations

import torch

from . import build

# bytes of one block's record on the device (csrc/rank.cuh; fm_rank.DeviceFMIndex)
RECORD_BYTES = 64


def check_tables(name: str, fm, dev: torch.device) -> int:
    """Raise unless fm's record table is contiguous on ``dev``, (n, 16)
    int32 or (n, 8) int64 (64 bytes a record) and starts on 64 bytes
    (rank.cuh reads a record as one aligned line of 16-byte vectors), with
    L2 in its dtype; returns 1 for wide (int64) tables, else 0."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected a CUDA device")
    idt = fm.table.dtype
    if idt not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: table dtype {idt}, expected int32 or int64")
    per_record = RECORD_BYTES // fm.table.element_size()
    build.require(fm.table, "table", idt, (fm.table.shape[0], per_record), dev)
    build.require(fm.L2, "L2", idt, (5,), dev)
    build.require_aligned(fm.table, "table", RECORD_BYTES)
    return int(idt == torch.int64)


def rank_cuda(fm, k: torch.Tensor) -> torch.Tensor:
    """Launch K5: occ4 of every row in ``k`` (any shape, on fm's device),
    edge rows included; returns (*k.shape, 4) in fm's row dtype."""
    dev = k.device
    wide = check_tables("rank_cuda", fm, dev)
    flat = k.reshape(-1).to(fm.idt).contiguous()
    n = flat.shape[0]
    out = torch.empty((n, 4), dtype=fm.idt, device=dev)
    if n:
        build.launch(
            rank_cuda, "arachne_rank", dev,
            fm.table.data_ptr(), fm.L2.data_ptr(), fm.primary, fm.seq_len, wide,
            flat.data_ptr(), n, out.data_ptr(),
        )
    return out.reshape(*k.shape, 4)


rank_cuda.launches = 0
