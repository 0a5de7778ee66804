"""Time this checkout's kernels against another checkout's, on one card.

    python -m arachne_tpu_torch.ab PARENT [--kernels K1 K2 "S1 pass 1" ...] [--out FILE]

PARENT is the root of another checkout of the repo, for example the parent
commit unpacked with ``mkdir -p build/ab_parent && git archive HEAD~1 |
tar -x -C build/ab_parent``.  Its ``arachne_tpu_torch/ops/csrc`` is built
as a second kernel library, whose C entry points must take the same
arguments as this checkout's (a variant of a kernel, such as seed.cu
with another SEED_GROUP, or rank.cu with one K5 design forced in
``launch_rank``, is timed as a copy of the tree with that line edited).
Each named kernel's wrapper is then called on the same inputs with every
launch routed to one library or the other: K1-K4 on
``ops.problems.MAIN``, the main path's shapes, as ``chip_smoke.py`` phase
2 checks them; S1 (pass 1 and pass 2), S3 and K5 on ``seeding_problems``,
the device-seeded path's (one superbatch of a 2 Mbp genome's library; K5
on 2^20 rows of a GRCh38-sized table, "K5 index" on 2^20 rows of the
library's own index); "K1 int16" is K1 with int16 DP state on K1's
problems, against the parent's int16 kernel or, where the parent has none
(``arachne_extend16``), against its int32 K1: the two forms in turns on
the same inputs.  One adapter: a parent whose seeding entry points
(K5, S1, S3) take the planar tables, occ and words apart (the layout
before the 64-byte record table), is called through ``planar_run``, which
hands it contiguous planar copies of the record table's views, since its
kernels cannot read the records.  Both must give equal outputs, and they
are timed in turns (parent, this, this, parent) for five rounds, each turn
the mean of ten launches by CUDA events.  Those times hold the wrapper's
host work too (checks, allocations, the launch), which is all they show
once a kernel takes less than that: so each side's device time per call
(the kernels' own, by torch.profiler, the zeroing of an output included)
is measured as well, and the speedup is taken from it; and so is the time
of a CUDA graph of ten calls (``device.graph_ms``: no host work between
the launches, no profiler), from which the speedup is taken where the
profiler lost a side's records.  It prints one line per kernel with the
medians, each build's registers and spills for the seeding kernels, the
card's name and power limit, and the result as JSON (also written to
``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from .config import MemOptions
from .device import cuda_ms, device_ms, graph_ms, probe, resolve_device
from .ops import build
from .ops.problems import MAIN, extend_problems, global_problems, local_problems, on_device

ROUNDS = 5      # of parent, this, this, parent
REPS = 10       # launches per turn


# the seeding kernels' cases (``seeding_problems``)
SEEDING = ("S1 pass 1", "S1 pass 2", "S3", "K5", "K5 index")
# another form of a kernel, on that kernel's MAIN problems
FORMS = {"K1 int16": "K1"}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of the seeding entry points of a parent that takes the planar
# tables: occ and words in place of the record table
PLANAR_SIGNATURES = {
    "arachne_rank": [_P] * 3 + [_LL, _LL, _I, _P, _LL, _P, _P],
    "arachne_smem_pass": [_P] * 3 + [_LL, _LL, _I] + [_P] * 4 + [_I] * 5 + [_P] * 5,
    "arachne_seed_pass3": [_P] * 3 + [_LL, _LL, _I, _P, _P, _LL, _LL] + [_I] * 3 + [_P] * 4,
}


def takes_planar_tables(csrc: str) -> bool:
    """Do the seeding entry points of the sources in ``csrc`` take occ and
    words apart?"""
    with open(os.path.join(csrc, "rank.cu")) as fh:
        return "const void* words" in fh.read()


def planar_run(name: str, lib: ctypes.CDLL, args):
    """A call of seeding kernel ``name`` (its wrapper's ``args``) through
    ``lib``'s planar entry point, on contiguous planar copies of the record
    table made once and held by the call, its outputs allocated as its
    launcher allocates them."""
    from .ops.cuda_seed import _outputs

    fm = args[0]
    occ, words = fm.occ.contiguous(), fm.words.contiguous()
    for entry, argtypes in PLANAR_SIGNATURES.items():
        getattr(lib, entry).argtypes = argtypes

    def check(entry, *a):
        tables = (occ.data_ptr(), words.data_ptr(), fm.L2.data_ptr(), fm.primary, fm.seq_len,
                  int(fm.idt == torch.int64))
        rc = getattr(lib, entry)(*tables, *a, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: the parent's {entry} gave CUDA error {rc}")

    if name.startswith("K5"):
        ks = args[1]

        def run():
            out = torch.empty((ks.numel(), 4), dtype=fm.idt, device=ks.device)
            check("arachne_rank", ks.data_ptr(), ks.numel(), out.data_ptr())
            return out
    elif name == "S3":
        _, qs, qlens, min_seed_len, max_intv, MAXS = args

        def run():
            out = _outputs(fm, qs.device, qs.shape[0], MAXS)
            check("arachne_seed_pass3", qs.data_ptr(), qlens.data_ptr(), min_seed_len, max_intv,
                  *qs.shape, MAXS, *(t.data_ptr() for t in out))
            return out
    else:
        _, qs, qlens, pivots0, min_intvs, single_sweep, MAXC, MAXS = args
        R = qs.shape[0]

        def run():
            out = _outputs(fm, qs.device, R, MAXS)
            ws = torch.empty(R * (8 * MAXC + 5 * MAXS), dtype=fm.idt, device=qs.device)
            check("arachne_smem_pass", qs.data_ptr(), qlens.data_ptr(), pivots0.data_ptr(),
                  min_intvs.data_ptr(), int(single_sweep), *qs.shape, MAXC, MAXS, ws.data_ptr(),
                  *(t.data_ptr() for t in out))
            return out
    return run


def seeding_problems(dev, genome_bp=2_000_000, n_pairs=4096, wide_blocks=None,
                     rank_rows=1 << 20, **library):
    """The seeding kernels' inputs on ``dev``, as the device-seeded path
    gives them: a genome of ``genome_bp`` bases (``measure.make_library``,
    built with its index in a temporary directory; ``library`` passes it
    other sizes) and the first ``n_pairs`` pairs of its reads, one superbatch
    (8192 reads of 150 bp by default).  S1 pass 1 (pivots 0, min_intv 1),
    S1 pass 2 (every job of pass 1's SMEMs in one launch, as
    ``collect_seeds_device`` makes it) and S3 (``MemOptions`` defaults) at
    buffers of ``seed_buffers(L)``; K5 on ``rank_rows`` uniform rows of a
    synthetic wide table of ``wide_blocks`` blocks (GRCh38's size by
    default), "K5 index" on as many of the library's index (int32, in the
    L2).  Returns {name: args} of the wrappers ``fm_seed.smem_pass``,
    ``fm_seed.pass3`` and ``fm_rank.occ4_device``, which their CUDA
    launchers take as they are."""
    from .index import FMIndex, load_index
    from .measure import library_reads, make_library
    from .ops.fm_rank import DeviceFMIndex
    from .ops.fm_seed import pad_reads, pass1_seeds, pass2_inputs, seed_buffers, smem_pass
    from .seeding_bench import GRCH38_BLOCKS, synthetic_table

    opt = MemOptions()
    with tempfile.TemporaryDirectory(prefix="seeding_problems_") as work:
        ref, r1, r2, *_ = make_library(work, genome_bp, **library)
        idx = FMIndex(*load_index(ref + ".arx.npz"))
        reads = library_reads(r1, r2, n_pairs)
    fm = DeviceFMIndex.from_host(idx, dev)
    qs, qlens = pad_reads(reads, dev)
    R, L = qs.shape
    B = seed_buffers(L)
    pass1 = (fm, qs, qlens, torch.zeros(R, dtype=torch.int32, device=dev),
             torch.ones(R, dtype=torch.int32, device=dev), False, B, B)
    out1, n1, ovf = (t.cpu().numpy() for t in smem_pass(*pass1))
    _, jobs = pass1_seeds(out1, n1, ovf, len(reads), opt)
    _, *job_args = pass2_inputs(jobs, qs, qlens)
    wide = synthetic_table(dev, wide_blocks or GRCH38_BLOCKS)
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    ks = torch.randint(0, wide.seq_len, (rank_rows,), dtype=wide.idt, device=dev, generator=g)
    ks_index = torch.randint(0, fm.seq_len, (rank_rows,), dtype=fm.idt, device=dev, generator=g)
    return {"S1 pass 1": pass1, "S1 pass 2": (fm, *job_args, True, B, B),
            "S3": (fm, qs, qlens, opt.min_seed_len, opt.max_mem_intv, B), "K5": (wide, ks),
            "K5 index": (fm, ks_index)}


def case(name: str, dev: torch.device, opt: MemOptions, seeding=None):
    """(wrapper, args, kwargs) of kernel ``name`` on its MAIN problems, or
    for a seeding kernel on ``seeding``, ``seeding_problems``' result."""
    from .ops.cuda_extend import extend16_cuda, extend_cuda
    from .ops.cuda_global import global_score_cuda, global_z_cuda, traceback_cuda
    from .ops.cuda_local import local_cuda
    from .ops.cuda_rank import rank_cuda
    from .ops.cuda_seed import pass3_cuda, smem_pass_cuda
    from .ops.params import kernel_params
    from .ops.sw_local import NEVER

    if name in SEEDING:
        fn = {"S3": pass3_cuda, "K5": rank_cuda, "K5 index": rank_cuda}.get(name, smem_pass_cuda)
        return fn, list(seeding[name]), {}
    if name == "K1 int16":
        _, args, kw = case("K1", dev, opt)
        return extend16_cuda, args, dict(kw, max_h0=int(args[5].max()))
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


def compare(name: str, run, parent, run_parent=None) -> dict:
    """Check that both libraries give equal outputs, then time them in
    turns; milliseconds per launch, one entry per turn.  ``run`` calls the
    kernel's wrapper, whose launches go to the library in use;
    ``run_parent``, when given, calls the parent's library in its stead."""
    this = build.get_lib()
    runs = {"parent": run_parent or run, "this": run}
    with build.routed_to(parent):
        want = _tensors(runs["parent"]())
    got = _tensors(run())
    if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: this checkout's kernel differs from the parent's")
    times = {"parent": [], "this": []}
    for _ in range(ROUNDS):
        for side in ("parent", "this", "this", "parent"):
            with build.routed_to(parent if side == "parent" else this):
                times[side].append(cuda_ms(runs[side], REPS))
    med = {side: float(np.median(t)) for side, t in times.items()}
    dev, graph = {}, {}
    for side, lib in (("parent", parent), ("this", this)):
        with build.routed_to(lib):
            dev[side] = device_ms(runs[side], REPS)
            graph[side] = graph_ms(runs[side], REPS)
    # the speedup by the profiler's device time; by the graph's where the
    # profiler lost a side's records
    by = dev if None not in dev.values() else graph
    return dict(parent_ms=med["parent"], this_ms=med["this"],
                parent_device_ms=dev["parent"], this_device_ms=dev["this"],
                parent_graph_ms=graph["parent"], this_graph_ms=graph["this"],
                speedup=by["parent"] / by["this"],
                speedup_by="device_ms" if by is dev else "graph_ms", runs=times)


def seed_kernel_resources(log: str) -> dict:
    """{kernel: ptxas's registers and spill line} of the seeding kernels
    (S1, S3, K5) in an nvcc log built with -Xptxas -v, each instantiation
    named by its row type and its table (flat, or sharded across cards;
    a build that predates the sharded table has only the flat one), and
    ", counted" for S1's and S3's forms that count occ4 rows (mangled
    ``Lb1E``; a build before the counters has none)."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # the mangled template argument: i for int, x for long long
            m = re.search(r"(smem_pass_kernel|pass3_kernel|rank_(?:group_)?kernel)I([ix])", line)
            table = "sharded" if "ArachneShardedTable" in line else "flat"
            counted = ", counted" if "Lb1E" in line else ""
            entry = (f"{m.group(1)}<{'int' if m.group(2) == 'i' else 'long long'}, {table}"
                     f"{counted}>" if m else None)
        elif entry and ("registers" in line or "spill" in line):
            out.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m arachne_tpu_torch.ab", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("parent", help="root of the other checkout")
    ap.add_argument("--kernels", nargs="+", default=["K1", "K2"],
                    choices=list(MAIN) + list(FORMS) + list(SEEDING))
    ap.add_argument("--out", default=None)
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    a = parser().parse_args(argv)
    csrc = os.path.join(a.parent, "arachne_tpu_torch", "ops", "csrc")
    if not os.path.isdir(csrc):
        raise SystemExit(f"no kernel sources under {csrc}")
    dev = resolve_device("cuda")
    card = probe()["nvidia_smi"]
    build.get_lib()
    info: dict = {}
    parent = build.build_library(csrc, info)
    planar = takes_planar_tables(csrc)
    print(f"parent kernels {info['path']} built in {info['seconds']:.1f} s"
          + ("; its seeding kernels take planar tables" if planar else ""), flush=True)
    opt = MemOptions()
    result = {"card": card, "rounds": ROUNDS, "reps": REPS, "kernels": {}}
    if any(name in SEEDING for name in a.kernels):
        result["resources"] = {side: seed_kernel_resources(str(i["log"]))
                               for side, i in (("parent", info), ("this", build.BUILD_INFO))}
        for side, res in result["resources"].items():
            for k, lines in res.items():
                print(f"{side} {k}: {'; '.join(lines)}", flush=True)
    with torch.cuda.device(dev):
        seeding = (seeding_problems(dev) if any(name in SEEDING for name in a.kernels)
                   else None)
        for name in a.kernels:
            fn, args, kw = case(name, dev, opt, seeding)
            shape = (MAIN[FORMS.get(name, name)][1:] if FORMS.get(name, name) in MAIN
                     else list(args[1].shape))
            run_parent = planar_run(name, parent, args) if planar and name in SEEDING else None
            if name == "K1 int16" and not hasattr(parent, "arachne_extend16"):
                from .ops.cuda_extend import extend_cuda

                print("the parent has no int16 K1: its side is its int32 K1", flush=True)
                run_parent = functools.partial(
                    extend_cuda, *args, **{k: v for k, v in kw.items() if k != "max_h0"})
            r = dict(shape=list(shape), **compare(
                name, lambda: fn(*args, **kw), parent, run_parent))
            result["kernels"][name] = r
            print(f"{name} {'x'.join(map(str, shape))}: parent median {r['parent_ms']:.4f} ms "
                  f"{['%.4f' % t for t in r['runs']['parent']]}; this median "
                  f"{r['this_ms']:.4f} ms {['%.4f' % t for t in r['runs']['this']]}; device "
                  f"time {r['parent_device_ms']} against {r['this_device_ms']} ms, graph "
                  f"{r['parent_graph_ms']:.4f} against {r['this_graph_ms']:.4f} ms; "
                  f"{r['speedup']:.2f}x by {r['speedup_by']}", flush=True)
    print(card)
    print(json.dumps(result))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
