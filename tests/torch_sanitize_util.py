"""One small launch of every hand-written kernel of the port, each held to
its plain version on the CPU: the program that tests/test_torch_cuda.py
runs under compute-sanitizer (memcheck on every kernel, racecheck and
synccheck on those that use shared memory).

    python tests/torch_sanitize_util.py [--device cuda|cpu] [NAME ...]

runs the named launches (all of KERNELS by default) and prints
"launched NAME" after each.  On a card each must add one to its
launcher's count; on the CPU the wrappers take the plain versions, which
rehearses the shapes and arguments.  It imports no JAX.
"""

import argparse
import dataclasses
import sys

import numpy as np
import torch

# name: the launcher whose count the launch moves
KERNELS = {
    "extend_kernel": "cuda_extend.extend_cuda",
    "extend16_kernel": "cuda_extend.extend16_cuda",
    "local_kernel": "cuda_local.local_cuda",
    "global_kernel score": "cuda_global.global_score_cuda",
    "global_kernel z": "cuda_global.global_z_cuda",
    "traceback_kernel": "cuda_global.traceback_cuda",
    "rank_kernel": "cuda_rank.rank_cuda",
    "rank_group_kernel": "cuda_rank.rank_cuda",
    "smem_pass_kernel": "cuda_seed.smem_pass_cuda",
    "smem_pass_kernel pass 2": "cuda_seed.smem_pass_cuda",
    "pass3_kernel": "cuda_seed.pass3_cuda",
    "rank sharded": "cuda_rank.rank_sharded_cuda",
    "rank_group sharded": "cuda_rank.rank_sharded_cuda",
    "smem_pass sharded": "cuda_seed.smem_pass_sharded_cuda",
    "pass3 sharded": "cuda_seed.pass3_sharded_cuda",
}
# the kernels that use shared memory: K1's (both forms) and K3's scoring matrix, K2's
# row maxima, K4's window, S1's and S3's occ4 rows filled by cp.async (K5
# keeps its records in registers)
SHARED_MEMORY = tuple(name for name in KERNELS if "rank" not in name)


def launcher(name):
    import importlib

    module, fn = KERNELS[name].split(".")
    return getattr(importlib.import_module(f"arachne_tpu_torch.ops.{module}"), fn)


def on_cpu(x):
    """x with every tensor (and a rank table's) moved to the CPU."""
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, ShardedFMIndex

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, DeviceFMIndex):
        return dataclasses.replace(x, table=x.table.cpu(), L2=x.L2.cpu())
    if isinstance(x, ShardedFMIndex):
        flat = DeviceFMIndex(table=torch.cat(x.shards).cpu(), L2=x.L2.cpu(), primary=x.primary,
                             seq_len=x.seq_len, l_pac=x.l_pac)
        return ShardedFMIndex(flat, ["cpu"] * len(x.shards))
    if isinstance(x, (tuple, list)):
        return type(x)(on_cpu(v) for v in x)
    return x


def cases(dev):
    """{name: (function, args, kwargs)} on ``dev``, at small shapes."""
    from arachne_tpu_torch.config import MemOptions
    from arachne_tpu_torch.index import FMIndex, build_fmindex, pack_reference, unpack_2bit
    from arachne_tpu_torch.ops.fm_rank import DeviceFMIndex, ShardedFMIndex, occ4_device
    from arachne_tpu_torch.ops.fm_seed import pad_reads, pass3, seed_buffers, smem_pass
    from arachne_tpu_torch.ops.problems import (
        extend_problems, global_problems, local_problems, on_device,
    )
    from arachne_tpu_torch.ops.sw_extend import extend_batch
    from arachne_tpu_torch.ops.sw_global import global_score, global_z, traceback
    from arachne_tpu_torch.ops.sw_local import NEVER, local_sw_full
    from arachne_tpu_torch.seeding_bench import parity_rows, sample_reads, synthetic_table

    opt = MemOptions()
    gaps = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins)
    mat = torch.as_tensor(opt.scoring_matrix(), dtype=torch.int32, device=dev)
    out = {}
    qs, ts, ws, h0s = extend_problems(31, 16, 64, 128, opt)
    out["extend_kernel"] = (extend_batch, (*on_device(dev, qs, ts, 64, 128, ws, h0s), mat),
                            dict(gaps, zdrop=opt.zdrop))
    out["extend16_kernel"] = (extend_batch, out["extend_kernel"][1],
                              dict(gaps, zdrop=opt.zdrop, wide_state=False, max_h0=int(h0s.max())))
    qs, ts = local_problems(32, 16, 64, 160)
    ends = np.where(np.arange(len(qs)) % 3 == 0, 40, NEVER).astype(np.int32)
    minscs = np.full(len(qs), 19, np.int32)
    out["local_kernel"] = (local_sw_full, (*on_device(dev, qs, ts, 64, 160, ends, minscs), mat),
                           dict(gaps, max_mat=1))
    qs, ts, ws = global_problems(33, 16, 64, 96, 12)
    args = on_device(dev, qs, ts, 64, 96, ws)
    out["global_kernel score"] = (global_score, (*args, mat), gaps)
    out["global_kernel z"] = (global_z, (*args, mat), gaps)
    _, z = global_z(*args, mat, **gaps)
    out["traceback_kernel"] = (traceback, (z, *args[2:]), dict(max_steps=256))

    # a 40 kbp genome with a planted repeat: its table lies in the L2 (K5's
    # thread a query), int32 for the flat kernels and int64 for the sharded
    # ones; a random table of 2^20 blocks (64 MB) lies beyond it (K5's
    # group of four lanes a query)
    rng = np.random.default_rng(25)
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 40_000)])
    packed = pack_reference([("chr1", "", seq[:9000] + seq[2000:4000] + seq[9000:])])
    idx = FMIndex(packed, build_fmindex(packed))
    fm = DeviceFMIndex.from_host(idx, dev)
    big = synthetic_table(dev, 1 << 20) if dev.type == "cuda" else synthetic_table(dev, 1 << 12)
    out["rank_kernel"] = (occ4_device, (fm, parity_rows(fm, 256)), {})
    out["rank_group_kernel"] = (occ4_device, (big, parity_rows(big, 256)), {})
    reads = sample_reads(unpack_2bit(packed.pac, 0, packed.l_pac), 60, seed=26)
    reads += [np.full(150, 4, np.uint8), reads[0][:1].copy()]
    q, qlens = pad_reads(reads, dev)
    R, L = q.shape
    MAX = seed_buffers(L)
    zeros = torch.zeros(R, dtype=torch.int32, device=dev)
    piv = torch.from_numpy(rng.integers(0, 150, R).astype(np.int32)).to(dev) % qlens.clamp(min=1)
    minis = torch.from_numpy(rng.integers(1, 4, R).astype(np.int32)).to(dev)
    p1 = (q, qlens, zeros, zeros + 1, False, MAX, MAX)
    p3 = (q, qlens, opt.min_seed_len, opt.max_mem_intv, MAX)
    out["smem_pass_kernel"] = (smem_pass, (fm, *p1), {})
    out["smem_pass_kernel pass 2"] = (smem_pass, (fm, q, qlens, piv, minis, True, MAX, MAX), {})
    out["pass3_kernel"] = (pass3, (fm, *p3), {})
    halves = ShardedFMIndex(DeviceFMIndex.from_host(idx, dev, wide=True), [dev, dev])
    out["rank sharded"] = (occ4_device, (halves, parity_rows(fm, 256).long()), {})
    out["rank_group sharded"] = (occ4_device, (ShardedFMIndex(big, [dev, dev]),
                                               parity_rows(big, 256)), {})
    out["smem_pass sharded"] = (smem_pass, (halves, *p1), {})
    out["pass3 sharded"] = (pass3, (halves, *p3), {})
    return out


def same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a.cpu(), b)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", metavar="NAME", help=f"of {list(KERNELS)}")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(KERNELS)
    if unknown:
        ap.error(f"unknown kernels {sorted(unknown)}")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device")
    todo = cases(dev)
    for name in args.names or list(KERNELS):
        fn, fargs, kw = todo[name]
        count = launcher(name)
        before = count.launches
        got = fn(*fargs, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            if count.launches != before + 1:
                raise AssertionError(f"{name}: {count.launches - before} launches, not 1")
        if not same(got, fn(*on_cpu(fargs), **kw)):
            raise AssertionError(f"{name} differs from its plain version")
        print(f"launched {name}", flush=True)


if __name__ == "__main__":
    main()
