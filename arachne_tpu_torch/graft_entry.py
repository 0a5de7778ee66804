"""The port's graft entry points: the K1 path as a function with example
inputs, and a dry run of the pieces that dispatch over several cards.

    python -m arachne_tpu_torch.graft_entry [--device cuda] [--devices 2]

The jax-free twin of __graft_entry__.py.  ``entry()`` returns ``(fn,
args)``: ``ops/sw_extend.extend_batch`` (kernel K1 on CUDA tensors, its
plain version on CPU ones) with the scoring options bound, and the
reference's example batch, made with numpy from the same seed, as tensors
on the card unless the caller asks for the CPU.  ``dryrun_multichip(n)``
keeps the reference's checks but its mesh, which the port has none of
(the index is never sharded): K5 and device seeding on a 4096-base
genome's index against the host, a tiny extension batch, and
``BatchExtender`` over ``devicepool.pinned([dev] * n)`` against the
single-device dispatch.  Both run on the card by default and raise without
one.
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
    """The reference's dry run on one card (or the CPU) with the batchers'
    chunks spread over ``n_devices`` entries of the device pool; raises on
    any mismatch."""
    from .align.smem import collect_seeds
    from .config import MemOptions
    from .device import resolve_device
    from .index import FMIndex, build_fmindex, pack_reference, unpack_2bit
    from .ops import devicepool
    from .ops.fm_rank import DeviceFMIndex, occ4_device
    from .ops.fm_seed import collect_seeds_device
    from .ops.params import kernel_params
    from .ops.sw_extend import BatchExtender, extend_batch

    dev = resolve_device(device)
    opt = MemOptions()
    rng = np.random.default_rng(0)

    # tiny reference and index; its rank tables on the device
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 4096)])
    packed = pack_reference([("c", "", genome)])
    idx = FMIndex(packed, build_fmindex(packed))
    dfm = DeviceFMIndex.from_host(idx, dev)
    ks = rng.integers(0, idx.seq_len, 64).astype(np.int64)
    got = occ4_device(dfm, torch.from_numpy(ks).to(dev, dfm.idt)).cpu().numpy()
    if not np.array_equal(got, idx.occ4(ks)):
        raise AssertionError("occ4 on the device differs from the host index")
    # device seeding against the scalar collector
    fwd = unpack_2bit(packed.pac, 0, packed.l_pac)
    reads = [fwd[100 * i : 100 * i + 80].copy() for i in range(4)]
    for r, got_seeds in zip(reads, collect_seeds_device(reads, opt, dfm)):
        if got_seeds != collect_seeds(idx, r, opt):
            raise AssertionError("device seeding differs from the scalar collector")

    # a tiny extension batch: a 32-base exact match on an h0 of 19; a chunk
    # of 8 for each pool entry below
    B = 8 * max(n_devices, 1)
    tmax, qmax = 64, 48
    ts = rng.integers(0, 4, (B, tmax)).astype(np.int8)
    qs = np.full((B, qmax), 4, np.int8)
    qs[:, :32] = ts[:, :32]
    p = kernel_params(opt, dev)
    host = (qs, ts, np.full(B, 32, np.int32), np.full(B, tmax, np.int32),
            np.full(B, 100, np.int32), np.full(B, 19, np.int32))
    out = extend_batch(*(torch.from_numpy(a).to(dev) for a in host), p.mat, **p.gaps(),
                       zdrop=p.zdrop)
    scores = out[0].cpu().numpy()
    if scores.shape != (B,) or int(scores[0]) != 19 + 32:
        raise AssertionError(f"unexpected extension scores {scores[:4]}")

    # the production batcher over the pool: chunks of 8 round-robin over
    # n_devices entries, byte-identical to one device's dispatch
    def batched():
        be = BatchExtender(opt, dev)
        be.CHUNK = 8
        for i in range(B):
            be.submit(qs[i, :32], ts[i], opt.w, opt.pen_clip5, 19)
        return be.run()

    with devicepool.pinned([dev] * n_devices):
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
