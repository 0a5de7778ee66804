"""The card's side of a traced run, from torch.profiler (CUDA activity
only: the host's side comes from the benchmark's own spans).

Event times are the profiler's, in Unix nanoseconds; ``events`` turns
them into seconds on the run's ``perf_counter`` clock.  The port's own
kernels are the ``__global__`` functions of its CUDA sources, found by
name; a run whose trace holds fewer of them than the program's launch
counters counted lost records and is discarded (its trace metrics are
left out).
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Set, Tuple

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s+)?(\w+)\s*\(")


def port_kernel_names(csrc: str) -> Set[str]:
    names = set()
    for path in glob.glob(os.path.join(csrc, "*.cu")) + glob.glob(os.path.join(csrc, "*.cuh")):
        with open(path) as fh:
            names.update(_GLOBAL.findall(fh.read()))
    return names


def kernel_of(event_name: str, names: Set[str]):
    """The port kernel an event is a launch of, or None."""
    for tok in re.findall(r"\w+", event_name):
        if tok in names:
            return tok
    return None


class DeviceTrace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        import torch

        self.prof.start()
        # a first launch while the tracer comes up, so that none of the
        # run's is made just as tracing starts
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.prof.stop()
        return False

    def events(self, unix_minus_perf: float) -> List[Tuple[str, float, float]]:
        """(name, start, end) of every device activity, in perf_counter
        seconds."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                a = e.start_ns() / 1e9 - unix_minus_perf
                out.append((e.name(), a, a + e.duration_ns() / 1e9))
        return out
