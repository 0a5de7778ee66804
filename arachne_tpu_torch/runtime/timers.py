"""Stage timers and spans: the port's one tracer.

``TIMERS``, the process's one ``StageTimers``, does two things.

Stage sums, always on: ``stage(name)`` adds its wall seconds and one call
to ``seconds[name]`` and ``calls[name]``, summed over threads (so nested
stages and waits inside count in each); ``as_dict`` and ``summary``
report them (``align --stats-json``, ``ARACHNE_TIMERS``).

A trace, off by default: while ``trace(True)`` holds, every ``stage``
and every ``span``, ``launch`` and ``iter_spans`` step also appends a
``Span`` record to its own thread's list, with no lock: its name, an id,
the parent (the innermost span open on the thread, or None), the
superbatch its thread works on (``in_superbatch``), the thread's name,
start and end in Unix nanoseconds from ``time.time_ns()`` (torch.profiler's
kineto clock, so host spans line up with the card's kernels) and the
thread's CPU nanoseconds (``time.thread_time_ns()``) at both ends, and a
dict of attributes.  ``count(name, value)`` keeps a (name, Unix ns, value)
sample the same way; ``add_to(name, **counts)`` adds work counts to the
attributes of the innermost open span of that name.  ``spans()`` and
``counters()`` gather every
thread's; ``write_chrome_trace`` writes them as Chrome trace events
(``align --profile-dir`` writes ``arachne{sfx}.spans.json`` beside the
profiler's trace).  Spans (``span``, ``launch``) add nothing to the sums.
With the trace off a span or launch costs one attribute test: no record,
no clock read.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, Iterable, Iterator, List, Optional, Tuple


class Span:
    """One traced span; ``t1`` and ``cpu1`` stay None while it is open."""

    __slots__ = ("name", "id", "parent", "superbatch", "thread", "tid", "t0", "t1", "cpu0",
                 "cpu1", "attrs")

    def __init__(self, name, sid, parent, superbatch, thread, tid, attrs):
        self.name, self.id, self.parent, self.superbatch = name, sid, parent, superbatch
        self.thread, self.tid, self.attrs = thread, tid, attrs
        self.t1 = self.cpu1 = None
        # the CPU clock read inside the wall clock's interval, so that the
        # thread's CPU time never exceeds the span's wall time
        self.t0 = time.time_ns()
        self.cpu0 = time.thread_time_ns()


class _Thread:
    """One thread's part of one trace: its records, counter samples, the
    stack of its open spans and the superbatch it works on."""

    def __init__(self, gen: int):
        cur = threading.current_thread()
        self.gen, self.name, self.tid = gen, cur.name, threading.get_native_id()
        self.records: List[Span] = []
        self.counters: List[Tuple[str, int, float]] = []
        self.stack: List[Span] = []
        self.superbatch: Optional[int] = None
        self.last_launch: Optional[Span] = None


class _Opened:
    """The context of one traced span: yields its record, closes it."""

    __slots__ = ("timers", "rec")

    def __init__(self, timers, rec):
        self.timers, self.rec = timers, rec

    def __enter__(self) -> Span:
        return self.rec

    def __exit__(self, *exc):
        self.timers._close(self.rec)
        return False


# the context of a span while the trace is off: yields None
_OFF = nullcontext()


class StageTimers:
    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._tls = threading.local()
        self.tracing = False
        self._gen = 0
        self._threads: List[_Thread] = []
        self._ids = itertools.count(1)
        # (Unix ns, perf_counter ns) read together when the trace started
        self.anchor: Optional[Tuple[int, int]] = None

    # -- stage sums ------------------------------------------------------

    @contextmanager
    def stage(self, name: str):
        rec = self._open(name, None) if self.tracing else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += dt
                self.calls[name] += 1
            if rec is not None:
                self._close(rec)

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self.seconds[name] += dt
            self.calls[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: {"seconds": round(self.seconds[k], 4), "calls": self.calls[k]}
                for k in sorted(self.seconds)
            }

    def summary(self) -> str:
        d = self.as_dict()
        total = sum(v["seconds"] for v in d.values())
        lines = []
        for k, v in sorted(d.items(), key=lambda kv: -kv[1]["seconds"]):
            pct = 100.0 * v["seconds"] / total if total else 0.0
            lines.append(
                f"{k:24s} {v['seconds']:9.3f}s {pct:5.1f}%  x{v['calls']}"
            )
        return "\n".join(lines)

    # -- the trace -------------------------------------------------------

    def trace(self, on: bool) -> None:
        """Switch the trace on or off.  Switching it on from off starts a
        new trace (the last one's records are dropped); switching it off
        keeps the records for ``spans``/``counters``."""
        with self._lock:
            if on and not self.tracing:
                self._gen += 1
                self._threads = []
                self.anchor = (time.time_ns(), time.perf_counter_ns())
            self.tracing = bool(on)

    def _thread(self) -> _Thread:
        t = getattr(self._tls, "trace", None)
        if t is None or t.gen != self._gen:
            t = _Thread(self._gen)
            self._tls.trace = t
            with self._lock:
                self._threads.append(t)
        return t

    def _open(self, name: str, attrs: Optional[dict]) -> Span:
        t = self._thread()
        rec = Span(name, next(self._ids), t.stack[-1].id if t.stack else None, t.superbatch,
                   t.name, t.tid, attrs)
        t.stack.append(rec)
        t.records.append(rec)
        return rec

    def _close(self, rec: Span) -> None:
        rec.cpu1 = time.thread_time_ns()
        rec.t1 = time.time_ns()
        # this thread's open spans (a trace started since holds none of them)
        stack = self._tls.trace.stack
        if stack and stack[-1] is rec:
            stack.pop()

    def span(self, name: str, **attrs):
        """A traced span that adds nothing to the stage sums; as a context
        it yields its record, or None with the trace off."""
        if not self.tracing:
            return _OFF
        return _Opened(self, self._open(name, attrs))

    def launch(self, entry: str, **attrs):
        """``span(entry, **attrs)`` around a kernel launch; it is also the
        thread's last launch (``take_launch``)."""
        if not self.tracing:
            return _OFF
        rec = self._open(entry, attrs)
        self._thread().last_launch = rec
        return _Opened(self, rec)

    def take_launch(self) -> Optional[Span]:
        """The record of this thread's latest launch since the last take,
        or None: the caller that fetches a launch's results puts on it
        what they show (a kernel's work counters)."""
        if not self.tracing:
            return None
        t = self._thread()
        rec, t.last_launch = t.last_launch, None
        return rec

    @contextmanager
    def in_superbatch(self, superbatch: int):
        """Mark every span this thread opens inside as superbatch
        ``superbatch``'s."""
        if not self.tracing:
            yield
            return
        t = self._thread()
        saved, t.superbatch = t.superbatch, superbatch
        try:
            yield
        finally:
            t.superbatch = saved

    def iter_spans(self, name: str, items: Iterable) -> Iterator:
        """The items of ``items``, each ``next()`` inside a span ``name``
        while the trace is on."""
        it = iter(items)
        end = object()
        while True:
            if self.tracing:
                with self.span(name):
                    item = next(it, end)
            else:
                item = next(it, end)
            if item is end:
                return
            yield item

    def add_to(self, name: str, **counts) -> None:
        """Add ``counts`` to the attributes of the innermost span named
        ``name`` open on this thread (work counters onto the ``superbatch``
        span they count in), while tracing; nothing where none is open."""
        if not self.tracing:
            return
        for rec in reversed(self._thread().stack):
            if rec.name == name:
                if rec.attrs is None:
                    rec.attrs = {}
                for k, v in counts.items():
                    rec.attrs[k] = rec.attrs.get(k, 0) + v
                return

    def count(self, name: str, value: float) -> None:
        """A counter sample (name, Unix ns, value), kept while tracing."""
        if self.tracing:
            self._thread().counters.append((name, time.time_ns(), value))

    def spans(self) -> List[Span]:
        """Every thread's closed spans of the current (or last) trace, in
        order of start."""
        with self._lock:
            threads = list(self._threads)
        out = [r for t in threads for r in list(t.records) if r.t1 is not None]
        out.sort(key=lambda r: r.t0)
        return out

    def counters(self) -> List[Tuple[str, int, float]]:
        with self._lock:
            threads = list(self._threads)
        return sorted((c for t in threads for c in list(t.counters)), key=lambda c: c[1])

    def write_chrome_trace(self, path: str, base_ns: int = 0) -> None:
        """Write the trace as Chrome trace events: an ``X`` event a span
        (``id``, ``parent``, ``superbatch``, ``cpu_us`` and its attributes
        in ``args``), a ``C`` event a counter sample, and each thread's
        name; times in microseconds after ``base_ns`` Unix nanoseconds (the
        profiler's ``baseTimeNanoseconds``, so both files share a clock)."""
        pid = os.getpid()
        events = []
        names = {}
        for r in self.spans():
            names[r.tid] = r.thread
            args = {"id": r.id, "parent": r.parent, "superbatch": r.superbatch,
                    "cpu_us": (r.cpu1 - r.cpu0) / 1e3}
            args.update(r.attrs or {})
            events.append({"ph": "X", "name": r.name, "cat": "arachne", "pid": pid,
                           "tid": r.tid, "ts": (r.t0 - base_ns) / 1e3,
                           "dur": (r.t1 - r.t0) / 1e3, "args": args})
        for name, ns, value in self.counters():
            events.append({"ph": "C", "name": name, "cat": "arachne", "pid": pid,
                           "ts": (ns - base_ns) / 1e3, "args": {"value": value}})
        for tid, name in names.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": name}})
        with open(path, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base_ns}, fh)


# process-global registry used by the pipeline; bench/profiling resets it
TIMERS = StageTimers()
