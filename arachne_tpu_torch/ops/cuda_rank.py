"""K5 launcher: the CUDA occ4 rank kernel (csrc/rank.cu).

Replaces arachne_tpu/ops/pallas_gather.py::_rank_kernel, and, on a table
split across cards (``rank_sharded_cuda``), the shard-aware occ4 of
arachne_tpu/ops/fm_rank.py:88-142.  The plain PyTorch version and the
CPU/CUDA dispatch live in ``fm_rank``.
"""

from __future__ import annotations

import threading

import torch

from . import build

# bytes of one block's record on the device (csrc/rank.cuh; fm_rank.DeviceFMIndex)
RECORD_BYTES = 64

# (card, peer) index pairs whose peer access this process enabled
_peers: set = set()
_peers_lock = threading.Lock()


def enable_peer_access(dev: torch.device, peer: torch.device) -> None:
    """Let kernels launched on card ``dev`` read card ``peer``'s memory
    (csrc/rank.cu arachne_enable_peer_access); raises where the pair
    cannot.  A card needs none to read its own memory."""
    if dev.type != "cuda" or peer.type != "cuda":
        raise ValueError(f"peer access from {dev} to {peer}: both must be CUDA devices")
    if dev.index == peer.index:
        return
    with _peers_lock:
        if (dev.index, peer.index) in _peers:
            return
        lib = build.get_lib()
        rc = lib.arachne_enable_peer_access(dev.index, peer.index)
        if rc != 0:
            raise RuntimeError(f"peer access from {dev} to {peer} refused: CUDA error {rc} "
                               f"({lib.arachne_error_string(rc).decode()})")
        _peers.add((dev.index, peer.index))


def _check_record_table(label: str, table: torch.Tensor, rows: int, idt,
                        dev: torch.device) -> None:
    per_record = RECORD_BYTES // table.element_size()
    build.require(table, label, idt, (rows, per_record), dev)
    build.require_aligned(table, label, RECORD_BYTES)


def _row_dtype(name: str, idt) -> int:
    if idt not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: table dtype {idt}, expected int32 or int64")
    return int(idt == torch.int64)


def check_tables(name: str, fm, dev: torch.device) -> int:
    """Raise unless fm's record table is contiguous on ``dev``, (n, 16)
    int32 or (n, 8) int64 (64 bytes a record) and starts on 64 bytes
    (rank.cuh reads a record as one aligned line of 16-byte vectors), with
    L2 in its dtype; returns 1 for wide (int64) tables, else 0."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected a CUDA device")
    wide = _row_dtype(name, fm.table.dtype)
    _check_record_table("table", fm.table, fm.table.shape[0], fm.table.dtype, dev)
    build.require(fm.L2, "L2", fm.table.dtype, (5,), dev)
    return wide


def check_sharded_tables(name: str, fm, dev: torch.device) -> int:
    """check_tables for a table split across cards (fm_rank.ShardedFMIndex):
    every shard a record table of ``fm.per`` records on a card that ``dev``
    reads (itself, or one it enabled peer access to), and the shards'
    addresses and L2 on ``dev``; returns 1 for wide tables, else 0."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, expected a CUDA device")
    wide = _row_dtype(name, fm.idt)
    for s, shard in enumerate(fm.shards):
        if shard.device.type != "cuda":
            raise ValueError(f"{name}: shard {s} on {shard.device}, expected a CUDA device")
        if shard.device.index != dev.index and (dev.index, shard.device.index) not in _peers:
            raise ValueError(f"{name}: shard {s} on {shard.device}, which {dev} has no peer "
                             "access to")
        _check_record_table(f"shard {s}", shard, fm.per, fm.idt, shard.device)
    if fm.pointers is None:
        raise ValueError(f"{name}: the shards' addresses are not on {dev}")
    build.require(fm.pointers, "shard addresses", torch.int64, (len(fm.shards),), dev)
    build.require(fm.L2, "L2", fm.idt, (5,), dev)
    return wide


def table_args(name: str, fm, dev: torch.device, sharded: bool):
    """The C arguments that give a kernel fm's record table (its address,
    or its shards' addresses and ``per``) and its wide flag, after the
    checks."""
    if sharded:
        wide = check_sharded_tables(name, fm, dev)
        return [fm.pointers.data_ptr(), fm.per], wide
    wide = check_tables(name, fm, dev)
    return [fm.table.data_ptr()], wide


def _rank(wrapper, entry: str, sharded: bool, fm, k: torch.Tensor) -> torch.Tensor:
    dev = k.device
    table, wide = table_args(wrapper.__name__, fm, dev, sharded)
    flat = k.reshape(-1).to(fm.idt).contiguous()
    n = flat.shape[0]
    out = torch.empty((n, 4), dtype=fm.idt, device=dev)
    if n:
        build.launch(
            wrapper, entry, dev,
            *table, fm.L2.data_ptr(), fm.primary, fm.seq_len, wide,
            flat.data_ptr(), n, out.data_ptr(), problems=n,
        )
    return out.reshape(*k.shape, 4)


def rank_cuda(fm, k: torch.Tensor) -> torch.Tensor:
    """Launch K5: occ4 of every row in ``k`` (any shape, on fm's device),
    edge rows included; returns (*k.shape, 4) in fm's row dtype."""
    return _rank(rank_cuda, "arachne_rank", False, fm, k)


def rank_sharded_cuda(fm, k: torch.Tensor) -> torch.Tensor:
    """K5 on a table split across cards (fm_rank.ShardedFMIndex): each
    query's record is read from the card that holds it."""
    return _rank(rank_sharded_cuda, "arachne_rank_sharded", True, fm, k)


rank_cuda.launches = 0
rank_sharded_cuda.launches = 0
