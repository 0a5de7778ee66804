"""Device resolution and the card probe.

The device is always explicit: callers pass a ``torch.device`` (or the
name of one) down to every batcher.  Asking for CUDA where there is none
raises; nothing falls back to the CPU silently.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Optional, Union

import torch


def resolve_device(name: Union[str, torch.device]) -> torch.device:
    """``"cuda"`` / ``"cuda:N"`` / ``"cpu"`` -> ``torch.device``; raises if
    CUDA is requested and no card is visible."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls on the
    current CUDA device, after one warm call, with CUDA events around the
    whole run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> Optional[float]:
    """Mean milliseconds of device time per call of ``fn``, as
    torch.profiler reports the kernels' own time, after one warm call; None
    if the profiler saw no device time.  Unlike ``cuda_ms`` it leaves out
    the gaps in which the card waits for the host to launch the next
    kernel, which dominate a run of small launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / reps / 1e3 if us > 0 else None


def _first_line(cmd) -> Optional[str]:
    if shutil.which(cmd[0]) is None:
        return None
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        return None
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    return lines[-1].strip() if lines else None


def nvcc_path() -> Optional[str]:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME``
    (default ``/usr/local/cuda``, the toolkit's standard prefix)."""
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    return default if os.path.exists(default) else None


def probe() -> Dict[str, object]:
    """What the card and toolchain are: name, compute capability, the CUDA
    version torch was built for, the nvcc release line, and nvidia-smi's
    name and power limit (a card set below 700 W runs slower under load,
    so every timing is reported beside it)."""
    out: Dict[str, object] = {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_name": None,
        "capability": None,
        "device_count": 0,
        "nvcc": None,
        "nvidia_smi": _first_line(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
        ),
    }
    if out["cuda_available"]:
        out["device_name"] = torch.cuda.get_device_name(0)
        out["capability"] = "%d.%d" % torch.cuda.get_device_capability(0)
        out["device_count"] = torch.cuda.device_count()
    nvcc = nvcc_path()
    if nvcc:
        out["nvcc"] = _first_line([nvcc, "--version"])
    return out
