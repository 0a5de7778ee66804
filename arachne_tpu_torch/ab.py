"""Time this checkout's DP kernels against another checkout's, on one card.

    python -m arachne_tpu_torch.ab PARENT [--kernels K1 K2] [--out FILE]

PARENT is the root of another checkout of the repo, for example the parent
commit unpacked with ``mkdir -p build/ab_parent && git archive HEAD~1 |
tar -x -C build/ab_parent``.  Its ``arachne_tpu_torch/ops/csrc`` is built
as a second kernel library, whose C entry points must take the same
arguments as this checkout's.  Each named kernel's wrapper is then called
on the same inputs (``ops.problems.MAIN``, the main path's shapes, as
``chip_smoke.py`` phase 2 checks them) with every launch routed to one
library or the other: both must give equal outputs, and they are timed in
turns (parent, this, this, parent) for five rounds, each turn the mean of
ten launches by CUDA events.  Those times hold the wrapper's host work too
(checks, allocations, the launch), which is all they show once a kernel
takes less than that: so each side's device time per call (the kernels'
own, by torch.profiler, the zeroing of an output included) is measured as
well, and the speedup is taken from it.  It prints one line per kernel
with the medians, the card's name and power limit, and the result as JSON
(also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np
import torch

from .config import MemOptions
from .device import cuda_ms, device_ms, probe, resolve_device
from .ops import build
from .ops.problems import MAIN, extend_problems, global_problems, local_problems, on_device

ROUNDS = 5      # of parent, this, this, parent
REPS = 10       # launches per turn


def case(name: str, dev: torch.device, opt: MemOptions):
    """(wrapper, args, kwargs) of kernel ``name`` on its MAIN problems."""
    from .ops.cuda_extend import extend_cuda
    from .ops.cuda_global import global_score_cuda, global_z_cuda, traceback_cuda
    from .ops.cuda_local import local_cuda
    from .ops.params import kernel_params
    from .ops.sw_local import NEVER

    p = kernel_params(opt, dev)
    g = p.gaps()
    seed, B, qmax, tmax = MAIN[name]
    if name == "K1":
        qs, ts, ws, h0s = extend_problems(seed, B, qmax, tmax, opt)
        return (extend_cuda, on_device(dev, qs, ts, qmax, tmax, ws, h0s) + [p.mat],
                dict(g, zdrop=p.zdrop))
    if name == "K2":
        qs, ts = local_problems(seed, B, qmax, tmax)
        per = (np.full(B, NEVER, np.int32), np.full(B, opt.min_seed_len * opt.a, np.int32))
        return (local_cuda, on_device(dev, qs, ts, qmax, tmax, *per) + [p.mat],
                dict(g, max_mat=p.max_mat))
    qs, ts, ws = global_problems(seed, B, qmax, tmax, 0 if name == "K3 score" else 12)
    args = on_device(dev, qs, ts, qmax, tmax, ws)
    if name == "K3 score":
        return global_score_cuda, args + [p.mat], g
    if name == "K3 z":
        return global_z_cuda, args + [p.mat], g
    _, z = global_z_cuda(*args, p.mat, **g)
    return traceback_cuda, [z] + args[2:], dict(max_steps=qmax + tmax)


def _tensors(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def compare(name: str, fn, args, kw, parent) -> dict:
    """Check that both libraries give equal outputs, then time them in
    turns; milliseconds per launch, one entry per turn."""
    this = build.get_lib()

    def run():
        return fn(*args, **kw)

    with build.routed_to(parent):
        want = _tensors(run())
    got = _tensors(run())
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: this checkout's kernel differs from the parent's")
    times = {"parent": [], "this": []}
    for _ in range(ROUNDS):
        for side in ("parent", "this", "this", "parent"):
            with build.routed_to(parent if side == "parent" else this):
                times[side].append(cuda_ms(run, REPS))
    med = {side: float(np.median(t)) for side, t in times.items()}
    dev = {}
    for side, lib in (("parent", parent), ("this", this)):
        with build.routed_to(lib):
            dev[side] = device_ms(run, REPS)
    if None in dev.values():
        raise RuntimeError(f"{name}: the profiler saw no device time")
    return dict(parent_ms=med["parent"], this_ms=med["this"],
                parent_device_ms=dev["parent"], this_device_ms=dev["this"],
                speedup=dev["parent"] / dev["this"], runs=times)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m arachne_tpu_torch.ab", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("parent", help="root of the other checkout")
    ap.add_argument("--kernels", nargs="+", default=["K1", "K2"], choices=list(MAIN))
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    csrc = os.path.join(a.parent, "arachne_tpu_torch", "ops", "csrc")
    if not os.path.isdir(csrc):
        raise SystemExit(f"no kernel sources under {csrc}")
    dev = resolve_device("cuda")
    card = probe()["nvidia_smi"]
    build.get_lib()
    info: dict = {}
    parent = build.build_library(csrc, info)
    print(f"parent kernels {info['path']} built in {info['seconds']:.1f} s", flush=True)
    opt = MemOptions()
    result = {"card": card, "rounds": ROUNDS, "reps": REPS, "kernels": {}}
    with torch.cuda.device(dev):
        for name in a.kernels:
            fn, args, kw = case(name, dev, opt)
            shape = MAIN[name][1:]
            r = dict(problems_qmax_tmax=list(shape),
                     **compare(name, fn, args, kw, parent))
            result["kernels"][name] = r
            print(f"{name} {'x'.join(map(str, shape))}: parent median {r['parent_ms']:.4f} ms "
                  f"{['%.4f' % t for t in r['runs']['parent']]}; this median "
                  f"{r['this_ms']:.4f} ms {['%.4f' % t for t in r['runs']['this']]}; device "
                  f"time {r['parent_device_ms']:.4f} against {r['this_device_ms']:.4f} ms, "
                  f"{r['speedup']:.2f}x", flush=True)
    print(card)
    print(json.dumps(result))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
