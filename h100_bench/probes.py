"""The benchmark's hooks into one ``align`` run of the program.

Each wraps a program function for the length of the run and restores it
after:

  * the FASTQ barcode-set stream (``io.fastq.iter_barcode_sets``, which
    ``runtime.checkpoint.CheckpointedStream`` calls) is fed from the
    run's pool of libraries, one library after another, cycling, until the
    window has closed;
  * ``RunStats.note_barcode``, which the writer thread calls once for each
    barcode set it has written, in input order, stamps each set and opens
    and closes the window (window.py);
  * ``rfa.engine.process_barcodes`` gets a span: one superbatch on one
    worker;
  * with tracing on, ``TIMERS.stage`` spans (by the Unix clock, the
    profiler's) and each problem given to ``sw_global.BatchGlobal.submit``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import hostinfo, window


@dataclass
class FedSet:
    lib: int            # the pool library it came from
    index: int          # its number in that library (0-based, file order)
    pairs: int
    closes: bool        # the last set of its library
    names: List[str]
    emitted: Optional[float] = None   # perf_counter when written


@dataclass
class Probes:
    libraries: List[Tuple[str, str, int]]
    threads: int
    seconds: float
    trace: bool = False
    feed: List[FedSet] = field(default_factory=list)
    batches: List[Tuple[float, float, int]] = field(default_factory=list)  # (t0, t1, last set)
    libraries_fed: int = 0
    libraries_reused: int = 0
    emitted: int = 0
    opened: Optional[int] = None      # index of the set after which the window opens
    closed: Optional[int] = None
    t_open: Optional[float] = None    # perf_counter
    t_close: Optional[float] = None
    unix_open: Optional[float] = None
    cpu_open: float = 0.0             # process CPU seconds at the two ends
    cpu_close: float = 0.0
    host_open: Dict[str, float] = field(default_factory=dict)    # hostinfo.cpu_sample
    host_close: Dict[str, float] = field(default_factory=dict)
    stats: object = None              # the run's RunStats
    stages_open: Dict[str, float] = field(default_factory=dict)
    stages_close: Dict[str, float] = field(default_factory=dict)
    stage_spans: List[Tuple[str, int, int]] = field(default_factory=list)   # unix ns
    global_problems: List[Tuple[float, int, int, int]] = field(default_factory=list)
    stop: bool = False
    errors: List[str] = field(default_factory=list)

    def __post_init__(self):
        self._lock = threading.Lock()
        self._index_of: Dict[int, int] = {}
        self._saved = []

    # -- the hooks ------------------------------------------------------

    def _stream(self, original):
        def lookahead(it):
            prev = next(it, None)
            while prev is not None:
                nxt = next(it, None)
                yield prev, nxt is None
                prev = nxt

        def stream(_r1, _r2):
            while not self.stop:
                lib = self.libraries_fed % len(self.libraries)
                if self.libraries_fed >= len(self.libraries):
                    self.libraries_reused += 1
                self.libraries_fed += 1
                r1, r2, _ = self.libraries[lib]
                sets = original(r1, r2)
                try:
                    for k, ((records, unique), closes) in enumerate(lookahead(sets)):
                        with self._lock:
                            self._index_of[id(records)] = len(self.feed)
                            self.feed.append(FedSet(lib, k, len(records), closes,
                                                    [r.read_info for r in records]))
                        yield records, unique
                        if self.stop:
                            return
                finally:
                    sets.close()
        return stream

    def _process_barcodes(self, original):
        def process_barcodes(idx, cfg, barcode_sets, engine, centromeres=None):
            t0 = time.perf_counter()
            out = original(idx, cfg, barcode_sets, engine, centromeres)
            t1 = time.perf_counter()
            with self._lock:
                last = self._index_of[id(barcode_sets[-1][0])]
                self.batches.append((t0, t1, last))
            return out
        return process_barcodes

    def _note_barcode(self, original, timers):
        def note_barcode(stats, result):
            original(stats, result)
            now = time.perf_counter()
            self.stats = stats
            j = self.emitted
            self.emitted += 1
            fs = self.feed[j]
            fs.emitted = now
            if len(result.reads) != fs.pairs:
                self.errors.append(f"set {j} written with {len(result.reads)} pairs, fed {fs.pairs}")
            if self.opened is None:
                with self._lock:
                    ends = [b[2] for b in self.batches]
                if window.opens_at(j, fs.closes, ends, self.threads):
                    self.opened, self.t_open, self.unix_open = j, now, time.time()
                    self.cpu_open = time.process_time()
                    self.host_open = hostinfo.cpu_sample()
                    self.stages_open = timers()
            elif self.closed is None and window.closes_at(now, self.t_open, self.seconds, fs.closes):
                self.closed, self.t_close = j, now
                self.cpu_close = time.process_time()
                self.host_close = hostinfo.cpu_sample()
                self.stages_close = timers()
                self.stop = True
        return note_barcode

    def _stage(self, original):
        def stage(name):
            return _Span(original(name), name, self.stage_spans)
        return stage

    def _submit(self, original):
        def submit(batcher, query, target, w):
            self.global_problems.append((time.perf_counter(), len(query), len(target), int(w)))
            return original(batcher, query, target, w)
        return submit

    # -- install / remove -----------------------------------------------

    def __enter__(self):
        from arachne_tpu_torch.io import fastq
        from arachne_tpu_torch.ops import sw_global
        from arachne_tpu_torch.rfa import engine
        from arachne_tpu_torch.runtime.stats import RunStats
        from arachne_tpu_torch.runtime.timers import TIMERS

        def timers():
            with TIMERS._lock:
                return dict(TIMERS.seconds)

        self._saved = [
            (fastq, "iter_barcode_sets", fastq.iter_barcode_sets),
            (engine, "process_barcodes", engine.process_barcodes),
            (RunStats, "note_barcode", RunStats.note_barcode),
        ]
        fastq.iter_barcode_sets = self._stream(fastq.iter_barcode_sets)
        engine.process_barcodes = self._process_barcodes(engine.process_barcodes)
        RunStats.note_barcode = self._note_barcode(RunStats.note_barcode, timers)
        if self.trace:
            self._saved.append((sw_global.BatchGlobal, "submit", sw_global.BatchGlobal.submit))
            sw_global.BatchGlobal.submit = self._submit(sw_global.BatchGlobal.submit)
            TIMERS.stage = self._stage(TIMERS.stage)
            self._timers = TIMERS
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self._saved):
            setattr(owner, name, value)
        if self.trace:
            del self._timers.stage    # back to the class's method
        return False


class _Span:
    """A context manager around a TIMERS stage that also records its span
    (name, start, end) in Unix nanoseconds."""

    def __init__(self, inner, name, out):
        self.inner, self.name, self.out = inner, name, out

    def __enter__(self):
        self.t0 = time.time_ns()
        return self.inner.__enter__()

    def __exit__(self, *exc):
        try:
            return self.inner.__exit__(*exc)
        finally:
            self.out.append((self.name, self.t0, time.time_ns()))


def launch_wrappers():
    """The program's kernel launch wrappers: each function of an
    ``arachne_tpu_torch.ops.cuda_*`` module with a ``launches`` count."""
    import sys

    out = []
    for name, mod in list(sys.modules.items()):
        if name.startswith("arachne_tpu_torch.ops.cuda_") and mod is not None:
            for v in vars(mod).values():
                if callable(v) and isinstance(getattr(v, "launches", None), int):
                    out.append(v)
    return out


def launch_count() -> int:
    return sum(w.launches for w in launch_wrappers())
