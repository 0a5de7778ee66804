"""K2 launcher: the CUDA local Smith-Waterman kernel with the fused
second-best scan (csrc/local.cu).

Replaces arachne_tpu/ops/pallas_local.py::_local_kernel plus the XLA
sw_local.py::score2_scan fused after it.  The plain PyTorch version and the
CPU/CUDA dispatch live in ``sw_local``.
"""

from __future__ import annotations

import torch

from . import build


def local_cuda(qs, ts, qlens, tlens, endscs, minscs, mat, *, o_del, e_del, o_ins, e_ins, max_mat):
    """Launch K2 on CUDA tensors; returns (5, B) int32
    (gmax, te, qe, score2, te2)."""
    dev, B, qmax, tmax = build.check_problems(
        "local_cuda", qs, ts, mat, qlens=qlens, tlens=tlens, endscs=endscs, minscs=minscs
    )
    out = torch.empty((5, B), dtype=torch.int32, device=dev)
    if B:
        build.launch(
            local_cuda, "arachne_local", dev,
            qs.data_ptr(), ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
            endscs.data_ptr(), minscs.data_ptr(), mat.data_ptr(), B, qmax, tmax,
            o_del, e_del, o_ins, e_ins, max_mat, out.data_ptr(), problems=B,
        )
    return out


local_cuda.launches = 0
