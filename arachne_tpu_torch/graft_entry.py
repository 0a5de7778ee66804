"""The port's graft entry points: the K1 path as a function with example
inputs, and a dry run of the pieces that dispatch over several cards.

    python -m arachne_tpu_torch.graft_entry [--device cuda] [--devices 2]

The jax-free twin of __graft_entry__.py.  ``entry()`` returns ``(fn,
args)``: ``ops/sw_extend.extend_batch`` (kernel K1 on CUDA tensors, its
plain version on CPU ones) with the scoring options bound, and the
reference's example batch, made with numpy from the same seed, as tensors
on the card unless the caller asks for the CPU.  ``dryrun_multichip(n)``
makes the reference's checks over a mesh of n entries of the device pool
(``devicepool.pinned([dev] * n)``, parallel/mesh.py): a 4096-base genome's
index replicated on each entry and sharded by block across them, K5 and
device seeding against the sharded tables held to the host, a tiny
extension batch through ``sharded_extend``, and ``BatchExtender`` over the
pool against the single-device dispatch.  Both run on the card by default
and raise without one.
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch


def _example_batch(batch=128, qmax=128, tmax=256, seed=0, device="cuda"):
    """The reference's example extension batch on ``device``: (qs, ts,
    qlens, tlens, ws, h0s, mat), the options, qmax and tmax."""
    from .config import MemOptions
    from .device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    opt = MemOptions()
    ts = rng.integers(0, 4, (batch, tmax)).astype(np.int8)
    qs = np.full((batch, qmax), 4, np.int8)
    for i in range(batch):
        q = ts[i, :100].copy()
        mut = rng.integers(0, 100, 3)
        q[mut] = (q[mut] + 1) % 4
        qs[i, :100] = q
    qlens = np.full(batch, 100, np.int32)
    tlens = np.full(batch, tmax, np.int32)
    ws = np.full(batch, 100, np.int32)
    h0s = np.full(batch, 19, np.int32)
    mat = np.asarray(opt.scoring_matrix(), np.int32)
    args = tuple(torch.from_numpy(a).to(dev) for a in (qs, ts, qlens, tlens, ws, h0s, mat))
    return args, opt, qmax, tmax


def entry(device="cuda"):
    """Returns (fn, example_args): the batched seed extension, the hot
    kernel of the aligner (K1), as a function of its tensors; ``fn(*args)``
    gives the (6, B) int32 maxv, qle, tle, gtle, gscore, max_off."""
    from .ops.sw_extend import extend_batch

    args, opt, _, _ = _example_batch(device=device)
    fn = functools.partial(extend_batch, o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                           e_ins=opt.e_ins, zdrop=opt.zdrop)
    return fn, args


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The reference's dry run over a mesh of ``n_devices`` pool entries on
    one card (or the CPU), with the batchers' chunks spread over them;
    raises on any mismatch."""
    from .align.smem import collect_seeds
    from .config import MemOptions
    from .device import resolve_device
    from .index import FMIndex, build_fmindex, pack_reference, unpack_2bit
    from .ops import devicepool
    from .ops.fm_rank import occ4_device
    from .ops.fm_seed import collect_seeds_device
    from .ops.sw_extend import BatchExtender
    from .parallel.mesh import (
        ShardedFMTables,
        make_mesh,
        replicated_index_arrays,
        sharded_extend,
    )

    dev = resolve_device(device)
    opt = MemOptions()
    rng = np.random.default_rng(0)

    # tiny reference and index, replicated and sharded layouts
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 4096)])
    packed = pack_reference([("c", "", genome)])
    idx = FMIndex(packed, build_fmindex(packed))
    ks = rng.integers(0, idx.seq_len, 64).astype(np.int64)
    fwd = unpack_2bit(packed.pac, 0, packed.l_pac)
    reads = [fwd[100 * i : 100 * i + 80].copy() for i in range(4)]

    # a tiny extension batch: a 32-base exact match on an h0 of 19; the
    # production batcher takes it in chunks of 8, round-robin over the
    # pool, and must be byte-identical to one device's dispatch
    B = 8 * max(n_devices, 1)
    tmax, qmax = 64, 48
    ts = rng.integers(0, 4, (B, tmax)).astype(np.int8)
    qs = np.full((B, qmax), 4, np.int8)
    qs[:, :32] = ts[:, :32]

    def batched():
        be = BatchExtender(opt, dev)
        be.CHUNK = 8
        for i in range(B):
            be.submit(qs[i, :32], ts[i], opt.w, opt.pen_clip5, 19)
        return be.run()

    with devicepool.pinned([dev] * n_devices):
        mesh = make_mesh(n_devices)
        for dfm in replicated_index_arrays(mesh, idx):
            k = torch.from_numpy(ks).to(dfm.device, dfm.idt)
            if not np.array_equal(occ4_device(dfm, k).cpu().numpy(), idx.occ4(ks)):
                raise AssertionError("replicated occ4 on the device differs from the host index")
        # the resident sharded rank layer: K5 and the seeding kernels read
        # each record from the entry that holds it
        tables = ShardedFMTables(idx, mesh)
        if not np.array_equal(tables.occ4(ks), idx.occ4(ks)):
            raise AssertionError("sharded occ4 differs from the host index")
        for r, got_seeds in zip(reads, collect_seeds_device(reads, opt, tables)):
            if got_seeds != collect_seeds(idx, r, opt):
                raise AssertionError("sharded device seeding differs from the scalar collector")
        # data-parallel extension batch: contiguous parts, one an entry
        out = sharded_extend(mesh, opt, qs, ts, np.full(B, 32, np.int32),
                             np.full(B, tmax, np.int32), np.full(B, 100, np.int32),
                             np.full(B, 19, np.int32))
        scores = out[0]
        if scores.shape != (B,) or int(scores[0]) != 19 + 32:
            raise AssertionError(f"unexpected extension scores {scores[:4]}")
        multi = batched()
    saved = os.environ.get("ARACHNE_DEVICE_DP")
    os.environ["ARACHNE_DEVICE_DP"] = "0"
    devicepool.reset_cache()
    try:
        single = batched()
    finally:
        if saved is None:
            del os.environ["ARACHNE_DEVICE_DP"]
        else:
            os.environ["ARACHNE_DEVICE_DP"] = saved
        devicepool.reset_cache()
    if multi != single:
        raise AssertionError("the batcher's output over the pool differs from one device's")
    print(f"dryrun_multichip OK on {n_devices} x {dev}; scores[:4]={scores[:4].tolist()}; "
          f"production batcher spread {-(-B // 8)} chunks over {n_devices} pool entries",
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m arachne_tpu_torch.graft_entry",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=2,
                    help="entries of the device pool in the dry run (the one card repeated)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device)
    out = fn(*fargs)
    print("entry() OK:", [o[:3].tolist() for o in out[:2].cpu()], flush=True)
    dryrun_multichip(args.devices, args.device)


if __name__ == "__main__":
    main()
