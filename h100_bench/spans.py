"""The program's own spans in a traced run, for the readers of the
metrics that read them (``program_span``, and the work counters that
``K1_roofline`` and ``S1_roofline`` take from launch spans).

The program records them itself (arachne_tpu_torch/runtime/timers.py)
while torch.profiler runs over its ``align``, as it does in a ``--trace
1`` run.  ``of(run)`` gives them on the run's ``perf_counter`` clock as
[dict(name, id, parent, superbatch, thread, start, end, cpu_s, attrs)]:
start and end in seconds, cpu_s the thread's CPU seconds inside the
span; a launch span is named after its C entry point
(``arachne_extend``, ...) and carries the work its kernel counted
(``cells``, ``rank_rows``).  They are taken from ``run["spans"]`` where
the record holds them, else from the program's tracer in this process
(its Unix nanoseconds moved to ``perf_counter`` by the pair of clocks it
read when its trace started).  None where there are none: a program
without the tracer, or a run it did not trace.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from . import window


def of(run) -> Optional[List[dict]]:
    if run.get("spans"):
        return run["spans"]
    try:
        from arachne_tpu_torch.runtime.timers import TIMERS
    except ImportError:
        return None
    anchor = getattr(TIMERS, "anchor", None)
    if anchor is None or not callable(getattr(TIMERS, "spans", None)):
        return None
    unix_ns, perf_ns = anchor

    def perf(ns):
        return (ns - unix_ns + perf_ns) / 1e9

    spans = [dict(name=r.name, id=r.id, parent=r.parent, superbatch=r.superbatch,
                  thread=r.thread, start=perf(r.t0), end=perf(r.t1),
                  cpu_s=(r.cpu1 - r.cpu0) / 1e9, attrs=dict(r.attrs or {}))
             for r in TIMERS.spans()]
    return spans or None


def named(run, names: Iterable[str]) -> Optional[List[dict]]:
    """The spans of any of ``names``; None without a trace."""
    spans = of(run)
    if spans is None:
        return None
    names = set(names)
    return [s for s in spans if s["name"] in names]


def seconds_in_window(run, name: str) -> Optional[float]:
    """Seconds of the spans named ``name`` inside the window, summed over
    threads; None without a trace."""
    spans = named(run, [name])
    if spans is None:
        return None
    lo, hi = run["window"]
    return sum(b - a for a, b in window.clip(((s["start"], s["end"]) for s in spans), lo, hi))


def on_cpu_pct(run, name: str) -> Optional[float]:
    """The thread-CPU share of the spans named ``name`` in the window: each
    span's CPU seconds prorated by the part of it inside the window, over
    the wall seconds of those parts; None where none lies in it."""
    spans = named(run, [name])
    if not spans:
        return None
    lo, hi = run["window"]
    cpu = wall = 0.0
    for s in spans:
        inside = min(s["end"], hi) - max(s["start"], lo)
        if inside > 0:
            cpu += s["cpu_s"] * inside / (s["end"] - s["start"])
            wall += inside
    return 100.0 * cpu / wall if wall else None


def launch_work(run, entries: Iterable[str], key: str) -> Optional[int]:
    """The ``key`` counts of the launches of ``entries`` that start in the
    window; None where none of them carries the count."""
    spans = named(run, entries)
    if spans is None:
        return None
    lo, hi = run["window"]
    counted = [s["attrs"][key] for s in spans if lo <= s["start"] <= hi and key in s["attrs"]]
    return sum(counted) if counted else None
