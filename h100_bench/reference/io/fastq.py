# Frozen copy of arachne_tpu_torch/io/fastq.py (commit 881fc48), the benchmark's reference: it
# imports nothing of the program and loads no native library.
"""Paired FASTQ streaming with barcode grouping.

Reproduces src/fastqreader/reader.go semantics:

  * header parsing (ParseHeader, reader.go:95-123): strip the trailing
    "/1"/"/2", extract BX:Z:<bc> and VX:i:[01] tags;
  * barcode-set accumulation (ReadBarcodeSet, reader.go:208-291): up to
    30,000 records until the barcode changes, pending-record carryover,
    and the "abnormal break" that flags a non-unique barcode when the same
    barcode reappears after >=200 reads;
  * gzip input via a `gunzip -c` subprocess (zipread.go:62-85) when
    available, falling back to Python's zlib.

The reference's record-reading loop has an out-of-range write that panics
on every record (reader.go:162-180, SURVEY.md 2.4); we implement the
intended 4-line record parse.
"""

from __future__ import annotations

import io
import os
import re
import shutil
import subprocess
from dataclasses import dataclass
from typing import IO, List, Optional, Tuple

from ..rfa.candidates import FastQRecordView

BX_RE = re.compile(rb"BX:Z:(\S+)\s")
VX_RE = re.compile(rb"VX:i:([01])\s")


class TruncatedFastQError(ValueError):
    """Raised on truncated or malformed FASTQ input mid-stream."""


def open_maybe_gzip(path: str) -> IO[bytes]:
    """zipread.go: prefer the system gunzip subprocess for throughput."""
    if path.endswith(".gz"):
        if shutil.which("gunzip"):
            proc = subprocess.Popen(
                ["gunzip", "-c", path], stdout=subprocess.PIPE, bufsize=1 << 20
            )
            return proc.stdout  # type: ignore[return-value]
        import gzip

        return gzip.open(path, "rb")  # type: ignore[return-value]
    return open(path, "rb", buffering=1 << 20)


def parse_header(line: bytes) -> Tuple[str, bytes, bool]:
    """ParseHeader (reader.go:95-123): returns (read_info, barcode, valid).

    read_info is the first whitespace field with its last two characters
    ("/1" or "/2") removed, exactly as the reference does."""
    fields = line.split()
    if not fields:
        return "", b"", False
    first = fields[0]
    header = first[:-2] if len(first) >= 2 else first
    m = BX_RE.search(line)
    if not m:
        return "", b"", False
    barcode = m.group(1)
    valid = False
    vm = VX_RE.search(line)
    if vm:
        valid = vm.group(1) == b"1"
    return header.decode(), barcode, valid


class FastQReader:
    """Paired FASTQ reader (FastQReader, reader.go:54-84)."""

    def __init__(self, r1_path: str, r2_path: str):
        self.r1 = open_maybe_gzip(r1_path)
        self.r2 = open_maybe_gzip(r2_path)
        self.line = 0
        self.last_barcode: Optional[bytes] = None
        self.pending: Optional[FastQRecordView] = None
        self.deferred_eof = False

    def close(self):
        for f in (self.r1, self.r2):
            try:
                f.close()
            except Exception:
                pass

    def read_one(self) -> Optional[FastQRecordView]:
        """ReadOneLine (reader.go:128-190), with the intended 4-line parse.

        Truncated/malformed records raise instead of masquerading as EOF
        (the reference logged malformed input, reader.go:156-157; silently
        dropping the tail of a run is worse than either)."""
        while True:
            self.line += 1
            h1 = self.r1.readline()
            h2 = self.r2.readline()
            if not h1 and not h2:
                return None
            if not h1 or not h2:
                raise TruncatedFastQError(
                    f"paired FASTQ length mismatch at record line ~{self.line}: "
                    f"{'R1' if not h1 else 'R2'} ended first"
                )
            if h1.startswith(b"@"):
                break
        read_info, barcode, valid = parse_header(h1[1:])
        s1 = self.r1.readline().rstrip(b"\n")
        plus1 = self.r1.readline()
        q1 = self.r1.readline().rstrip(b"\n")
        s2 = self.r2.readline().rstrip(b"\n")
        plus2 = self.r2.readline()
        q2 = self.r2.readline().rstrip(b"\n")
        if not q1 or not q2:
            raise TruncatedFastQError(
                f"truncated FASTQ record '{read_info}' near line {self.line}: "
                f"{'R1' if not q1 else 'R2'} record is incomplete"
            )
        if len(s1) != len(q1) or len(s2) != len(q2):
            raise TruncatedFastQError(
                f"malformed FASTQ record '{read_info}' near line {self.line}: "
                "sequence/quality length mismatch"
            )
        return FastQRecordView(
            read1=s1,
            qual1=q1,
            read2=s2,
            qual2=q2,
            barcode=barcode,
            valid=valid,
            read_info=read_info,
            read_group="",
        )

    def read_barcode_set(self) -> Tuple[Optional[List[FastQRecordView]], bool]:
        """ReadBarcodeSet (reader.go:208-291): returns (records, unique).

        records is None at end of input.  unique=False marks an "abnormal
        break" — the same barcode continuing past a previous set (>=200
        reads) — which downstream disables BX attachment and RFA."""
        if self.deferred_eof and self.pending is None:
            return None, False
        records: List[FastQRecordView] = []
        if self.pending is not None:
            records.append(self.pending)
            self.pending = None
        new_barcode = False
        abnormal = False
        while len(records) < 30000:
            rec = self.read_one()
            if rec is None:
                self.deferred_eof = True
                break
            if records and rec.barcode != records[0].barcode:
                self.pending = rec
                new_barcode = True
                break
            records.append(rec)
            if (
                self.last_barcode is not None
                and records[0].barcode == self.last_barcode
                and len(records) >= 200
            ):
                abnormal = True
                break
        if not records:
            return None, False
        self.last_barcode = bytes(records[0].barcode)
        if abnormal:
            return records, False
        if not new_barcode and not self.deferred_eof:
            # hit the 30k cap mid-barcode: the continuation set will carry
            # the same barcode (non-unique), mirroring reader.go:283-288
            return records, False
        return records, True


def iter_barcode_sets(r1_path: str, r2_path: str):
    """Generator over (records, unique_barcode) barcode sets."""
    reader = FastQReader(r1_path, r2_path)
    try:
        while True:
            records, unique = reader.read_barcode_set()
            if records is None:
                break
            yield records, unique
    finally:
        reader.close()
