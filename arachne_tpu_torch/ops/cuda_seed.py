"""S1 and S3 launchers: the CUDA seeding state machines (csrc/seed.cu).

S1 replaces arachne_tpu/ops/fm_seed.py::_smem_pass_program (passes 1 and
2) and S3 replaces ``_pass3_program`` (pass 3); both are XLA while-loops in
the reference, not Pallas.  ``smem_pass_sharded_cuda`` and
``pass3_sharded_cuda`` run them on a table split across cards, where the
reference runs them under shard_map (arachne_tpu/parallel/mesh.py
ShardedFMTables.run_pass / run_pass3).  The plain PyTorch versions and the
CPU/CUDA dispatch live in ``fm_seed``.
"""

from __future__ import annotations

import torch

from . import build
from .cuda_rank import table_args


def _check_reads(name, fm, qs, sharded, per_read):
    dev = qs.device
    table, wide = table_args(name, fm, dev, sharded)
    R, L = qs.shape
    build.require(qs, "qs", torch.int8, (R, L), dev)
    for key, t in per_read.items():
        build.require(t, key, torch.int32, (R,), dev)
    return dev, table, wide, R, L


def _outputs(fm, dev, R, MAXS, count_rows=False):
    """out (R, MAXS, 5) zeroed, out_n (R,), or (2, R) with a row for each
    read's occ4 rows, and overflow (R,)."""
    out = torch.zeros((R, MAXS, 5), dtype=fm.idt, device=dev)
    out_n = torch.empty((2, R) if count_rows else R, dtype=fm.idt, device=dev)
    overflow = torch.empty(R, dtype=torch.bool, device=dev)
    return out, out_n, overflow


def _rows_arg(out_n):
    """The kernels' rows pointer: out_n's second row, or NULL."""
    return out_n[1].data_ptr() if out_n.dim() == 2 else None


def _smem_pass(wrapper, entry, sharded, fm, qs, qlens, pivots0, min_intvs, single_sweep,
               MAXC, MAXS, count_rows):
    name = wrapper.__name__
    dev, table, wide, R, L = _check_reads(
        name, fm, qs, sharded, dict(qlens=qlens, pivots0=pivots0, min_intvs=min_intvs)
    )
    if MAXC < 1 or MAXS < 1:
        raise ValueError(f"{name}: MAXC {MAXC} / MAXS {MAXS} below 1")
    out, out_n, overflow = _outputs(fm, dev, R, MAXS, count_rows)
    # curr, prev (MAXC x 4 each) and the sweep's SMEMs (MAXS x 5) per read
    ws = torch.empty(R * (8 * MAXC + 5 * MAXS), dtype=fm.idt, device=dev)
    if R:
        build.launch(
            wrapper, entry, dev,
            *table, fm.L2.data_ptr(), fm.primary, fm.seq_len, wide,
            qs.data_ptr(), qlens.data_ptr(), pivots0.data_ptr(), min_intvs.data_ptr(),
            int(single_sweep), R, L, MAXC, MAXS, ws.data_ptr(), out.data_ptr(),
            out_n.data_ptr(), overflow.data_ptr(), _rows_arg(out_n), problems=R,
        )
    return out, out_n, overflow


def _pass3(wrapper, entry, sharded, fm, qs, qlens, min_seed_len, max_intv, MAXS, count_rows):
    name = wrapper.__name__
    dev, table, wide, R, L = _check_reads(name, fm, qs, sharded, dict(qlens=qlens))
    if MAXS < 1:
        raise ValueError(f"{name}: MAXS {MAXS} < 1")
    out, out_n, overflow = _outputs(fm, dev, R, MAXS, count_rows)
    if R:
        build.launch(
            wrapper, entry, dev,
            *table, fm.L2.data_ptr(), fm.primary, fm.seq_len, wide,
            qs.data_ptr(), qlens.data_ptr(), min_seed_len, max_intv, R, L, MAXS,
            out.data_ptr(), out_n.data_ptr(), overflow.data_ptr(), _rows_arg(out_n), problems=R,
        )
    return out, out_n, overflow


def smem_pass_cuda(fm, qs, qlens, pivots0, min_intvs, single_sweep: bool, MAXC: int, MAXS: int,
                   count_rows=False):
    """Launch S1 on CUDA tensors; returns (out (R, MAXS, 5), out_n (R,),
    overflow (R,) bool), out and out_n in fm's row dtype; with
    ``count_rows`` out_n is (2, R), its second row each read's occ4 rows as
    ``smem_pass_torch(count_rows=True)`` counts them."""
    return _smem_pass(smem_pass_cuda, "arachne_smem_pass", False, fm, qs, qlens, pivots0,
                      min_intvs, single_sweep, MAXC, MAXS, count_rows)


def smem_pass_sharded_cuda(fm, qs, qlens, pivots0, min_intvs, single_sweep: bool, MAXC: int,
                           MAXS: int, count_rows=False):
    """S1 on a table split across cards (fm_rank.ShardedFMIndex)."""
    return _smem_pass(smem_pass_sharded_cuda, "arachne_smem_pass_sharded", True, fm, qs, qlens,
                      pivots0, min_intvs, single_sweep, MAXC, MAXS, count_rows)


def pass3_cuda(fm, qs, qlens, min_seed_len: int, max_intv: int, MAXS: int, count_rows=False):
    """Launch S3 on CUDA tensors; returns (out, out_n, overflow) as S1."""
    return _pass3(pass3_cuda, "arachne_seed_pass3", False, fm, qs, qlens, min_seed_len,
                  max_intv, MAXS, count_rows)


def pass3_sharded_cuda(fm, qs, qlens, min_seed_len: int, max_intv: int, MAXS: int,
                       count_rows=False):
    """S3 on a table split across cards (fm_rank.ShardedFMIndex)."""
    return _pass3(pass3_sharded_cuda, "arachne_seed_pass3_sharded", True, fm, qs, qlens,
                  min_seed_len, max_intv, MAXS, count_rows)


smem_pass_cuda.launches = 0
smem_pass_sharded_cuda.launches = 0
pass3_cuda.launches = 0
pass3_sharded_cuda.launches = 0
