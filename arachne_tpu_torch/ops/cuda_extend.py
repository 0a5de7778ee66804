"""K1 launcher: the CUDA banded seed-extension kernel (csrc/extend.cu).

Replaces arachne_tpu/ops/pallas_extend.py::_extend_kernel, with its DP
state in int32 (``arachne_extend``) or, with ``wide_state=False``, in
int16 (``arachne_extend16``: the reference's ``sdt=jnp.int16``, packed
two columns to a register).  The plain PyTorch version and the CPU/CUDA
dispatch live in ``sw_extend``.
"""

from __future__ import annotations

import torch

from . import build


def extend_cuda(qs, ts, qlens, tlens, ws, h0s, mat, *, o_del, e_del, o_ins, e_ins, zdrop,
                wide_state=True, max_h0=None, count_cells=False):
    """Launch K1 on CUDA tensors; returns (6, B) int32
    (maxv, qle, tle, gtle, gscore, max_off), with ``count_cells`` (the
    int32 kernel only) a seventh row: each problem's DP cells, as
    ``extend_batch_torch(count_cells=True)`` counts them.
    ``wide_state=False`` launches the int16 kernel, counted in ``extend16_cuda.launches``, once
    ``sw_extend.require_int16_state`` has proven its range from ``max_h0``
    (the caller's bound on every h0; without it the h0s are read, a
    synchronisation); it raises ValueError where the range is not proven,
    and never launches the int32 kernel in its place.  Raises on a bad
    argument, a failed build or a refused launch."""
    dev, B, qmax, tmax = build.check_problems(
        "extend_cuda", qs, ts, mat, qlens=qlens, tlens=tlens, ws=ws, h0s=h0s
    )
    if not wide_state:
        from .sw_extend import require_int16_state      # sw_extend imports this module

        require_int16_state("extend_cuda", h0s, max_h0, qmax, mat, o_del=o_del, e_del=e_del,
                            o_ins=o_ins, e_ins=e_ins)
    if count_cells and not wide_state:
        raise ValueError("extend_cuda: the int16 kernel counts no cells")
    out = torch.empty((6 + bool(count_cells), B), dtype=torch.int32, device=dev)
    if B:
        if wide_state:
            # the cells go to the seventh row, or nowhere (NULL)
            wrapper, entry = extend_cuda, "arachne_extend"
            cells = (out[6].data_ptr() if count_cells else None,)
        else:
            wrapper, entry, cells = extend16_cuda, "arachne_extend16", ()
        build.launch(
            wrapper, entry, dev,
            qs.data_ptr(), ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
            ws.data_ptr(), h0s.data_ptr(), mat.data_ptr(), B, qmax, tmax,
            o_del, e_del, o_ins, e_ins, zdrop, out.data_ptr(), *cells, problems=B,
        )
    return out


def extend16_cuda(*args, **kw):
    """K1 with int16 DP state: ``extend_cuda(..., wide_state=False)``, whose
    launches this function's ``launches`` counts."""
    return extend_cuda(*args, wide_state=False, **kw)


extend_cuda.launches = 0
extend16_cuda.launches = 0
