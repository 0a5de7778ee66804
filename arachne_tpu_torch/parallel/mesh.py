"""Devices of one process, and the block-sharded FM-index across them.

The port of arachne_tpu/parallel/mesh.py.  The reference builds a
jax.sharding Mesh: read batches are data-parallel along it, and the
FM-index tables are either replicated (small genomes) or sharded by block
along it, each occ4 step a lookup on every shard merged by a psum inside
shard_map.  The port's "mesh" is the list of torch devices the process
uses (``make_mesh``).  Data parallelism is chunk dispatch
(ops/devicepool.py), and a sharded index (``ShardedFMTables``) is read in
place: the seeding kernels K5, S1 and S3 load each record from the card
that holds it, over NVLink from another card, so that S1 and S3 stay one
kernel each instead of breaking at every occ4 step for a collective.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import MemOptions
from ..index.fmindex import FMIndex
from ..ops.devicepool import dispatch_devices
from ..ops.fm_rank import DeviceFMIndex, ShardedFMIndex
from ..ops.sw_extend import extend_batch


def make_mesh(n_devices: Optional[int] = None) -> List[torch.device]:
    """The process's devices: the pinned list (devicepool.pinned), else
    every visible card in devicepool.dispatch_devices order (card 0
    first), else the CPU; the first ``n_devices`` of them when given."""
    first = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    devs = list(dispatch_devices(first))
    return devs if n_devices is None else devs[:n_devices]


def pad_to_multiple(x: np.ndarray, multiple: int, fill) -> np.ndarray:
    b = x.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return x
    pad = np.full((rem,) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0)


def sharded_extend(
    devices: Sequence[torch.device],
    opt: MemOptions,
    qs: np.ndarray,
    ts: np.ndarray,
    qlens: np.ndarray,
    tlens: np.ndarray,
    ws: np.ndarray,
    h0s: np.ndarray,
) -> Tuple[np.ndarray, ...]:
    """Run the extension batch data-parallel across ``devices``.

    Problems are padded to a multiple of the device count (as the
    reference pads them) and split into contiguous parts, one a device,
    each extended by kernel K1's wrapper there (all launched before any is
    fetched).  Returns the six host arrays (maxv, qle, tle, gtle, gscore,
    max_off) trimmed to the original batch size."""
    n = len(devices)
    B = qs.shape[0]
    padded = [pad_to_multiple(np.asarray(a), n, fill)
              for a, fill in zip((qs, ts, qlens, tlens, ws, h0s), (4, 4, 1, 0, 1, 1))]
    part = padded[0].shape[0] // n
    mat = torch.from_numpy(np.asarray(opt.scoring_matrix(), np.int32))
    gaps = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
                zdrop=opt.zdrop)
    outs = []
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        args = [torch.from_numpy(np.ascontiguousarray(a[i * part : (i + 1) * part])).to(dev)
                for a in padded]
        args[0], args[1] = args[0].to(torch.int8), args[1].to(torch.int8)
        args[2:] = [a.to(torch.int32) for a in args[2:]]
        outs.append(extend_batch(*args, mat.to(dev), **gaps))
    host = np.concatenate([o.cpu().numpy() for o in outs], axis=1)
    return tuple(host[j, :B] for j in range(host.shape[0]))


def replicated_index_arrays(devices: Sequence[torch.device], idx: FMIndex) -> List[DeviceFMIndex]:
    """The whole rank tables on each of ``devices`` (small-genome mode),
    through ops/engine.py device_tables: uploaded once per (index,
    device), and refused over the device's budget."""
    from ..ops.engine import device_tables

    return [device_tables(idx, d) for d in devices]


class ShardedFMTables(ShardedFMIndex):
    """Resident block-sharded FM-index, under the reference's name.

    Replaces the rank layer of bwt.c:262-351 for genomes too big to
    replicate: the index's record table (fm_rank.DeviceFMIndex's,
    int64 when ``wide``, which defaults to what the index needs) is
    interleaved on the host and uploaded ONCE, split by block across
    ``devices`` as fm_rank.ShardedFMIndex splits it, and queried from
    ``device`` (devices[0] by default).  It is what
    ops.fm_seed.collect_seeds_device takes as ``dfm``, so the whole
    three-pass seeding runs against the sharded index."""

    def __init__(self, idx: FMIndex, devices: Sequence[torch.device], wide: Optional[bool] = None,
                 device=None):
        super().__init__(DeviceFMIndex.from_host(idx, "cpu", wide=wide), devices, device)
