"""The machine a run is on.  ``first_line``, ``max_sm_mhz`` and
``card_state`` are copies of arachne_tpu_torch/device.py's ``_first_line``
and ``sm_clocks_mhz`` and of arachne_tpu_torch/measure.py's
``card_state``.  ``cpu_sample`` reads the host's CPU counters, which a
run logs at both ends of its window."""

from __future__ import annotations

import shutil
import subprocess
from typing import Dict, Optional


def first_line(cmd) -> Optional[str]:
    if shutil.which(cmd[0]) is None:
        return None
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        return None
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    return lines[-1].strip() if lines else None


def max_sm_mhz() -> Optional[float]:
    """nvidia-smi's maximum SM clock in MHz, which sets the card's peak
    integer rate; None where it cannot say."""
    line = first_line(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"])
    try:
        return float(line) if line else None
    except ValueError:
        return None


def card_state() -> Optional[str]:
    """nvidia-smi's name, power limit, SM clock and power draw, or None."""
    return first_line(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
                       "--format=csv,noheader"])


def cpu_sample() -> Dict[str, float]:
    """The host's CPU time so far by kind, in clock ticks (/proc/stat's
    first line: user, nice, system, idle, iowait, irq, softirq, steal),
    and the mean clock of its cores in MHz (/proc/cpuinfo), where shown."""
    with open("/proc/stat") as fh:
        ticks = [float(v) for v in fh.readline().split()[1:9]]
    out = dict(zip(["user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal"],
                   ticks))
    try:
        with open("/proc/cpuinfo") as fh:
            mhz = [float(ln.split(":")[1]) for ln in fh if ln.startswith("cpu MHz")]
    except OSError:
        mhz = []
    if mhz:
        out["mhz"] = sum(mhz) / len(mhz)
    return out


def cpu_between(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    """Shares (%) of the host's CPU time between two samples: busy, steal
    and iowait, and the mean core clock at each end."""
    d = {k: b[k] - a[k] for k in a if k != "mhz"}
    total = sum(d.values()) or 1.0
    out = {"busy_pct": 100.0 * (total - d["idle"] - d["iowait"]) / total,
           "steal_pct": 100.0 * d["steal"] / total, "iowait_pct": 100.0 * d["iowait"] / total}
    if "mhz" in a and "mhz" in b:
        out.update(mhz_open=a["mhz"], mhz_close=b["mhz"])
    return out
