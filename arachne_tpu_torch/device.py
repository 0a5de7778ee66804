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


def timed_ms(fn):
    """(fn(), the milliseconds of that one call on the current CUDA device
    by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def graph_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the current CUDA device: CUDA
    events around the replay of a CUDA graph that holds ``reps`` calls,
    the best of three replays after a warm one.  The graph replays the
    launches back to back, with none of the host's work between them, so
    it reads the device time of a kernel that a run of wrapper calls would
    hide behind their host time, with no profiler."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = None
    for _ in range(3):
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / reps
        best = ms if best is None else min(best, ms)
    return best


# profiler runs that ``device_ms`` threw away because their device records
# were not the same for every call, and the runs it makes at most
lost_profiles = 0
PROFILE_TRIES = 3


def device_ms(fn, reps: int) -> Optional[float]:
    """Mean milliseconds of device time per call of ``fn`` over ``reps``
    calls, as torch.profiler reports the kernels' own time; None if the
    profiler saw no device time.  Unlike ``cuda_ms`` it leaves out the gaps
    in which the card waits for the host to launch the next kernel, which
    dominate a run of small launches.  A warm call comes first, in a
    warm-up step of its own: the tracer comes up during it, and a launch
    made just as tracing starts can go unrecorded.  Every call launches
    the same kernels, so a run whose device records are still not a
    multiple of ``reps`` lost some and would read low: it is thrown away
    (counted in ``lost_profiles``) and made again, up to ``PROFILE_TRIES``
    runs in all; None if none is whole."""
    global lost_profiles
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            prof.step()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans and len(spans) % reps == 0:
            return sum(spans) / reps / 1e3
        lost_profiles += 1
    return None


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


def sm_clocks_mhz() -> Dict[str, Optional[float]]:
    """nvidia-smi's current and maximum SM clocks in MHz (None where it
    cannot say); the maximum sets the card's peak integer rate."""
    line = _first_line(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                        "--format=csv,noheader,nounits"])
    vals = [v.strip() for v in line.split(",")] if line else []
    out: Dict[str, Optional[float]] = {"sm": None, "max_sm": None}
    for key, v in zip(out, vals):
        try:
            out[key] = float(v)
        except ValueError:
            pass
    return out


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
