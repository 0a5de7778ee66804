"""K3 and K4 launchers: the CUDA banded global alignment (score only, or
with direction bytes) and the backtrack walk over them (csrc/global.cu).

K3 replaces arachne_tpu/ops/pallas_global.py::_global_kernel_body (through
_score_kernel and _z_kernel); K4 replaces the XLA walk
arachne_tpu/ops/sw_global.py::traceback_device.  The plain PyTorch
versions and the CPU/CUDA dispatch live in ``sw_global``.
"""

from __future__ import annotations

import torch

from . import build


def _launch_global(wrapper, qs, ts, qlens, tlens, ws, mat, gaps, want_z):
    dev, B, qmax, tmax = build.check_problems(
        wrapper.__name__, qs, ts, mat, qlens=qlens, tlens=tlens, ws=ws
    )
    score = torch.empty(B, dtype=torch.int32, device=dev)
    # rows at or past a problem's tlen are not written: they stay zero
    z = torch.zeros((B, tmax, qmax), dtype=torch.uint8, device=dev) if want_z else None
    if B:
        build.launch(
            wrapper, "arachne_global", dev,
            qs.data_ptr(), ts.data_ptr(), qlens.data_ptr(), tlens.data_ptr(),
            ws.data_ptr(), mat.data_ptr(), B, qmax, tmax,
            gaps["o_del"], gaps["e_del"], gaps["o_ins"], gaps["e_ins"],
            score.data_ptr(), None if z is None else z.data_ptr(), problems=B,
        )
    return score, z


def global_score_cuda(qs, ts, qlens, tlens, ws, mat, **gaps):
    """Launch K3 score-only; returns score (B,) int32."""
    return _launch_global(global_score_cuda, qs, ts, qlens, tlens, ws, mat, gaps, False)[0]


def global_z_cuda(qs, ts, qlens, tlens, ws, mat, **gaps):
    """Launch K3 with direction bytes; returns (score (B,) int32,
    z (B, tmax, qmax) uint8, zero at and past each problem's tlen)."""
    return _launch_global(global_z_cuda, qs, ts, qlens, tlens, ws, mat, gaps, True)


def traceback_cuda(z, qlens, tlens, ws, *, max_steps: int):
    """Launch K4; returns (ops (max_steps, B) int8, fi (B,), fk (B,))."""
    dev = z.device
    if dev.type != "cuda":
        raise ValueError(f"traceback_cuda: z on {dev}, expected a CUDA device")
    B, tmax, qmax = z.shape
    build.require(z, "z", torch.uint8, (B, tmax, qmax), dev)
    for name, t in (("qlens", qlens), ("tlens", tlens), ("ws", ws)):
        build.require(t, name, torch.int32, (B,), dev)
    ops = torch.empty((max_steps, B), dtype=torch.int8, device=dev)
    fi = torch.empty(B, dtype=torch.int32, device=dev)
    fk = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        build.launch(
            traceback_cuda, "arachne_traceback", dev,
            z.data_ptr(), qlens.data_ptr(), tlens.data_ptr(), ws.data_ptr(),
            B, qmax, tmax, max_steps, ops.data_ptr(), fi.data_ptr(), fk.data_ptr(),
            problems=B,
        )
    return ops, fi, fk


global_score_cuda.launches = 0
global_z_cuda.launches = 0
traceback_cuda.launches = 0
