"""Kernel parameters carried across from the reference's options.

The kernels read the scoring matrix from a (5, 5) int32 tensor on their
device and the gap/z-drop scalars as ints.  The FM-index is not converted:
the port loads the same ``ref.fa.arx.npz`` through its own
``index.load_index``; device seeding uploads its rank tables
(ops/fm_rank.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from ..config import MemOptions


@dataclass(frozen=True)
class KernelParams:
    mat: torch.Tensor      # (5, 5) int32 on the kernels' device
    max_mat: int
    o_del: int
    e_del: int
    o_ins: int
    e_ins: int
    zdrop: int

    def gaps(self) -> Dict[str, int]:
        return dict(o_del=self.o_del, e_del=self.e_del, o_ins=self.o_ins, e_ins=self.e_ins)


def kernel_params(opt: MemOptions, device: torch.device) -> KernelParams:
    mat = opt.scoring_matrix()
    return KernelParams(
        mat=torch.as_tensor(mat, dtype=torch.int32).to(device).contiguous(),
        max_mat=int(mat.max()),
        o_del=opt.o_del,
        e_del=opt.e_del,
        o_ins=opt.o_ins,
        e_ins=opt.e_ins,
        zdrop=opt.zdrop,
    )


class ParamsByDevice(dict):
    """The KernelParams of one MemOptions on each device a batcher's
    chunks go to (ops/devicepool.py), made on first use: a kernel reads
    its scoring matrix from its own card."""

    def __init__(self, opt: MemOptions):
        super().__init__()
        self.opt = opt

    def __missing__(self, device: torch.device) -> KernelParams:
        p = self[device] = kernel_params(self.opt, device)
        return p
