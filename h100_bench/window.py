"""The measured window's arithmetic, on plain numbers (no program, no card).

A run emits barcode sets in input order.  ``Emitted`` holds, for each set
in that order, when the writer emitted it, its pairs and whether it closes
its library.  The window opens at the first library boundary at which the
first ``threads`` superbatches have all been emitted, and closes at the
first library boundary at or after ``open + seconds``: both ends fall
between whole libraries.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple


def opens_at(index: int, closes_library: bool, batch_ends: Sequence[int], threads: int) -> bool:
    """True if the window opens after emitted set ``index`` (0-based): it
    closes its library, and at least ``threads`` superbatches (each given
    by the index of its last set) end at or before it."""
    return closes_library and sum(1 for e in batch_ends if e <= index) >= threads


def closes_at(now: float, opened: float, seconds: float, closes_library: bool) -> bool:
    return closes_library and now - opened >= seconds


def window_pairs(pairs: Sequence[int], first: int, last: int) -> int:
    """Pairs of the sets emitted after set ``first`` up to and including
    set ``last``: those the window holds."""
    return sum(pairs[first + 1 : last + 1])


def rate(pairs: int, t_open: float, t_close: float) -> float:
    return pairs / (t_close - t_open)


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of ``intervals`` inside [lo, hi]."""
    out = []
    for a, b in intervals:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the union of ``intervals`` covers."""
    total, end = 0.0, lo
    for a, b in sorted(clip(intervals, lo, hi)):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(clip(intervals, lo, hi)):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def busy_share(spans: Iterable[Tuple[float, float]], workers: int, lo: float, hi: float) -> float:
    """Sum of the spans' time inside [lo, hi] over ``workers`` x (hi - lo)."""
    return sum(b - a for a, b in clip(spans, lo, hi)) / (workers * (hi - lo))


def idle_by_stage(device: Sequence[Tuple[float, float]], stages: Sequence[Tuple[str, float, float]],
                  lo: float, hi: float) -> Dict[str, float]:
    """Idle seconds of the device in [lo, hi], by what the host was doing
    at the middle of each gap: the names of the stages open then (on any
    thread), sorted and joined by '+', or "none"."""
    events = sorted([(a, 1, n) for n, a, b in stages] + [(b, -1, n) for n, a, b in stages])
    active: Dict[str, int] = {}
    out: Dict[str, float] = {}
    i = 0
    for mid, length in sorted(((a + b) / 2, b - a) for a, b in gaps(device, lo, hi)):
        while i < len(events) and events[i][0] <= mid:
            _, d, name = events[i]
            active[name] = active.get(name, 0) + d
            i += 1
        key = "+".join(sorted(n for n, c in active.items() if c > 0)) or "none"
        out[key] = out.get(key, 0.0) + length
    return out
