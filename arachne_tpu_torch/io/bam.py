# Copy of arachne_tpu/io/bam.py, the JAX package's host code, with each
# BAM record encoded once and no per-base interpreter loops.
"""Sharded BAM/SAM emission with the reference's record semantics.

Reproduces src/aligner/bamwriter.go:

  * CreateBAMs (:134-188): one barcode-sorted BAM plus position-bucketed
    BAMs per positionChunkSize chunk of each contig (small contigs packed
    together) plus ZZZ_unmapped_pos_bucketed.bam;
  * AppendBam (:283-568): flag assembly, unmapped demotion, TLEN, strand
    revcomp, soft->hard clipping for supplementary records, and the full
    tag set (AS, XS, XC, AC, XM, AM, XT, SA, debug tags, BX/VX/DM);
  * DoDumpToBam (:635-658): every read must have exactly one active
    alignment; supplementary (split) records ride along with the primary.

Each BAM record is encoded once (``encode_record``: bytes.translate and
bytes.fromhex, no per-base loop) and the same bytes written to
bc_sorted_bam and to the record's position bucket.

Deviation (documented): the reference only attaches BX:Z when the barcode
contains '-' (bamwriter.go:389,555), a 10x convention that drops barcode
tags for every format Arachne targets; we attach whenever attach_bx is set
and the barcode is non-empty (SURVEY.md 2.4 fix-list).
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass
from typing import Dict, IO, List, Optional, Tuple

from ..config import ArachneConfig
from ..index.fmindex import FMIndex
from ..rfa.scoring import is_pair
from ..rfa.types import Alignment
from .bgzf import BGZFWriter

# bridge cigar op -> BAM op (bamwriter.go:248-254): M I D -> 0 1 2, S -> 4, H -> 5
CIGARTABLE = [0, 1, 2, 4, 5]
CIGAR_CHARS = "MIDNSHP=X"
SAM_CIGAR_SOFT_CLIP = 3  # bridge encoding
SAM_CIGAR_HARD_CLIP = 4

SEQ_NIBBLE = {b: i for i, b in enumerate("=ACMGRSVTWYHKDBN")}
COMPLEMENT = bytes.maketrans(b"ACGTacgtNn", b"TGCATGCANN")


def revcomp_bytes(seq: bytes) -> bytes:
    return seq.translate(COMPLEMENT)[::-1]


# qual transcoding as 256-byte translate tables (the per-byte Python
# genexprs were the hottest lines of the writer)
_QUAL_MINUS33 = bytes(max(v - 33, 0) for v in range(256))   # ASCII -> phred
# phred -> ASCII, clamped at phred 93 ('~') like the binary path below, so
# malformed high quals stay printable ASCII (decode() would raise otherwise)
_QUAL_PLUS33 = bytes(min(v, 93) + 33 for v in range(256))
# phred clamped at 93, as BAM stores it
_QUAL_CLAMP = bytes(min(v, 93) for v in range(256))
# a base's 4-bit code as a hex digit, upper-cased, anything else 15:
# bytes.fromhex then packs two bases a byte, the first in the high nibble
_SEQ_HEX = bytes(b"0123456789abcdef"[SEQ_NIBBLE.get(chr(v).upper(), 15)] for v in range(256))


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if end < beg:
        end = beg
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _aux_string(tag: str, value: str) -> bytes:
    return tag.encode() + b"Z" + value.encode() + b"\x00"


def _aux_int(tag: str, value: int) -> bytes:
    return tag.encode() + b"i" + struct.pack("<i", value & 0xFFFFFFFF if value >= 0 else value)


def build_header_text(cfg: ArachneConfig, contigs: List[Tuple[str, int]], version: str = "0.1.0") -> str:
    """CreateBAM's header (bamwriter.go:49-125): @SQ per contig, @RG per
    read-group id (sample:library:gem:flowcell:lane), @PG arachne."""
    lines = ["@HD\tVN:1.6"]
    for name, length in contigs:
        lines.append(f"@SQ\tSN:{name}\tLN:{length}\tAS:{name}\tSP:NA")
    for rg_id in cfg.output.read_groups.split(","):
        fields = rg_id.split(":")
        if len(fields) < 5:
            continue
        lines.append(
            f"@RG\tID:{rg_id}\tLB:{fields[1]}.{fields[2]}\tPL:ILLUMINA\tPU:{rg_id}\tSM:{fields[0]}"
        )
    lines.append(f"@PG\tID:arachne\tPN:arachne\tVN:{version}")
    return "\n".join(lines) + "\n"


class BAMWriter:
    """One output file (BAM via BGZF, or SAM text when emit_sam)."""

    def __init__(self, path: str, header_text: str, contigs: List[Tuple[str, int]], emit_sam: bool):
        self.path = path
        self.contig_index = {name: i for i, (name, _) in enumerate(contigs)}
        self.contig_names = [name for name, _ in contigs]
        self.emit_sam = emit_sam
        if emit_sam:
            self.fh: IO = open(path, "w")
            self.fh.write(header_text)
            self.w = None
        else:
            self.fh = open(path, "wb")
            self.w = BGZFWriter(self.fh)
            text = header_text.encode()
            buf = b"BAM\x01" + struct.pack("<i", len(text)) + text
            buf += struct.pack("<i", len(contigs))
            for name, length in contigs:
                nm = name.encode() + b"\x00"
                buf += struct.pack("<i", len(nm)) + nm + struct.pack("<i", length)
            self.w.write(buf)

    def write_bam(self, records: bytes) -> None:
        """Encoded BAM records (``encode_record``), back to back."""
        self.w.write(records)

    def write_sam(
        self,
        name: str,
        flags: int,
        rid: int,
        pos: int,
        mapq: int,
        cigar_bam: List[Tuple[int, int]],
        seq: bytes,
        qual: bytes,
        mate_rid: int,
        mate_pos: int,
        tlen: int,
        aux: bytes,
    ) -> None:
        """One record as a SAM line."""
        rname = self.contig_names[rid] if 0 <= rid < len(self.contig_names) else "*"
        cig = "".join(f"{l}{CIGAR_CHARS[op]}" for op, l in cigar_bam) or "*"
        mname = "*"
        if mate_rid >= 0:
            mname = "=" if mate_rid == rid else self.contig_names[mate_rid]
        tags = _aux_to_sam(aux)
        self.fh.write(
            f"{name}\t{flags}\t{rname}\t{pos + 1}\t{mapq}\t{cig}\t{mname}\t"
            f"{mate_pos + 1}\t{tlen}\t{seq.decode() or '*'}\t"
            f"{qual.translate(_QUAL_PLUS33).decode() or '*'}"
            + ("\t" + tags if tags else "")
            + "\n"
        )

    def flush(self) -> None:
        if self.w is not None:
            self.w.flush()
        else:
            self.fh.flush()

    def close(self):
        if self.w is not None:
            self.w.close()
        else:
            self.fh.close()


def _aux_to_sam(aux: bytes) -> str:
    out = []
    i = 0
    while i < len(aux):
        tag = aux[i : i + 2].decode()
        typ = chr(aux[i + 2])
        if typ == "Z":
            end = aux.index(b"\x00", i + 3)
            out.append(f"{tag}:Z:{aux[i + 3 : end].decode()}")
            i = end + 1
        elif typ == "i":
            (v,) = struct.unpack("<i", aux[i + 3 : i + 7])
            out.append(f"{tag}:i:{v}")
            i += 7
        else:
            raise ValueError(f"unhandled aux type {typ}")
    return "\t".join(out)


class BAMWriters:
    """CreateBAMs (bamwriter.go:134-188): the sharded writer set."""

    def __init__(
        self,
        idx: FMIndex,
        base_path: str,
        cfg: ArachneConfig,
        version: str = "0.1.0",
        shard_suffix: str = "",
    ):
        contigs = [(a.name, a.length) for a in idx.packed.anns]
        self.cfg = cfg
        self.contigs = contigs
        header = build_header_text(cfg, contigs, version)
        ext = shard_suffix + (".sam" if cfg.output.emit_sam else ".bam")
        emit_sam = cfg.output.emit_sam
        os.makedirs(base_path, exist_ok=True)
        self.barcode_sorted = BAMWriter(
            os.path.join(base_path, "bc_sorted_bam" + ext), header, contigs, emit_sam
        )
        chunk = cfg.output.position_chunk_size
        self.chunk = chunk
        self.position_bucketed: Dict[str, List[BAMWriter]] = {}
        self._all_files: List[BAMWriter] = [self.barcode_sorted]
        last_writer = None
        running = 0
        for index, (name, length) in enumerate(contigs):
            n_chunks = max(1, math.ceil(length / chunk))
            idx_str = f"{index:06d}"
            if n_chunks > 1:
                ws = []
                for ci in range(n_chunks):
                    off = f"{ci * chunk:010d}"
                    w = BAMWriter(
                        os.path.join(base_path, f"{idx_str}-{name}_{off}_pos_bucketed{ext}"),
                        header, contigs, emit_sam,
                    )
                    ws.append(w)
                    self._all_files.append(w)
                self.position_bucketed[name] = ws
            else:
                if running == 0 or running + length > chunk:
                    last_writer = BAMWriter(
                        os.path.join(base_path, f"{idx_str}-{name}_0000000000_pos_bucketed{ext}"),
                        header, contigs, emit_sam,
                    )
                    self._all_files.append(last_writer)
                    running = length
                else:
                    running += length
                self.position_bucketed[name] = [last_writer]
        self.unmapped = BAMWriter(
            os.path.join(base_path, "ZZZ_unmapped_pos_bucketed" + ext), header, contigs, emit_sam
        )
        self._all_files.append(self.unmapped)

    def _bucket_for(self, aln: Alignment, unmapped: bool) -> BAMWriter:
        if unmapped or aln.contig not in self.position_bucketed:
            return self.unmapped
        buckets = self.position_bucketed[aln.contig]
        ci = min(max(int(aln.pos), 0) // self.chunk, len(buckets) - 1)
        return buckets[ci]

    def dump(self, alignments: List[List[Alignment]], attach_bx: bool) -> None:
        """DoDumpToBam (bamwriter.go:635-658): every record encoded once,
        written to bc_sorted_bam and to its position bucket."""
        records = []
        buckets: List[BAMWriter] = []
        contig_index = self.barcode_sorted.contig_index

        def add(aln: Alignment, primary: Alignment) -> None:
            records.append(encode_alignment(aln, primary, self.cfg, attach_bx, contig_index))
            # after the encoding, whose unmapped demotion moves the record
            buckets.append(self._bucket_for(aln, aln.is_unmapped()))

        for alignment_array in alignments:
            if not alignment_array:
                raise AssertionError("not all read_ids are spoken for")
            read_output = False
            for alignment in alignment_array:
                if alignment.active:
                    add(alignment, alignment)
                    if alignment.secondary is not None:
                        add(alignment.secondary, alignment)
                    read_output = True
            if not read_output:
                raise AssertionError("read_id has no active alignment")
        if self.barcode_sorted.emit_sam:
            for args, w in zip(records, buckets):
                self.barcode_sorted.write_sam(*args)
                w.write_sam(*args)
            return
        encoded = [encode_record(*r) for r in records]
        self.barcode_sorted.write_bam(b"".join(encoded))
        # each bucket its records in order, neighbours bound for the same
        # file joined into one write
        i, n = 0, len(records)
        while i < n:
            w, j = buckets[i], i + 1
            while j < n and buckets[j] is w:
                j += 1
            w.write_bam(b"".join(encoded[i:j]))
            i = j

    def flush(self) -> None:
        """Push all buffered records to the OS (BGZF block flush + file
        flush) so a checkpoint manifest can safely claim them as emitted."""
        for w in self._all_files:
            w.flush()

    def offsets(self) -> Dict[str, int]:
        """Durable byte offset of every shard file (call after flush).

        The checkpoint manifest stores these; on resume the files are
        truncated back to them, discarding any records written after the
        last manifest save — which makes resume exactly-once (no loss
        because the manifest only claims flushed sets, no duplicates
        because everything beyond the manifest is cut)."""
        out: Dict[str, int] = {}
        for w in self._all_files:
            out[os.path.basename(w.path)] = w.fh.tell()
        return out

    def close(self):
        for w in self._all_files:
            w.close()


def encode_record(
    name: str,
    flags: int,
    rid: int,
    pos: int,
    mapq: int,
    cigar_bam: List[Tuple[int, int]],
    seq: bytes,
    qual: bytes,
    mate_rid: int,
    mate_pos: int,
    tlen: int,
    aux: bytes,
) -> bytes:
    """One BAM record, its block_size first (SAM/BAM specification,
    section 4.2)."""
    nm = name.encode() + b"\x00"
    ncig = len(cigar_bam)
    lseq = len(seq)
    end = pos + sum(l for op, l in cigar_bam if op in (0, 2, 3, 7, 8))
    rec = struct.pack(
        "<iiBBHHHiiii",
        rid,
        pos,
        len(nm),
        mapq & 0xFF,
        reg2bin(max(pos, 0), max(end, pos + 1)) if pos >= 0 else 4680,
        ncig,
        flags & 0xFFFF,
        lseq,
        mate_rid,
        mate_pos,
        tlen,
    )
    rec += nm
    rec += struct.pack(f"<{ncig}I", *[(l << 4) | op for op, l in cigar_bam])
    rec += bytes.fromhex((seq.translate(_SEQ_HEX) + b"0" * (lseq & 1)).decode())
    rec += qual.translate(_QUAL_CLAMP) if qual else b"\xff" * lseq
    rec += aux
    return struct.pack("<i", len(rec)) + rec


def hard_clip(
    seq: bytes, qual: bytes, cigar: List[int]
) -> Tuple[bytes, bytes, List[int]]:
    """HardClip (bamwriter.go:664-689)."""
    start, end = 0, len(seq)
    newcigar = list(cigar)
    if len(newcigar) >= 2 and newcigar[0] == SAM_CIGAR_SOFT_CLIP:
        start = newcigar[1]
        newcigar[0] = SAM_CIGAR_HARD_CLIP
    if len(newcigar) >= 4 and newcigar[-2] == SAM_CIGAR_SOFT_CLIP:
        end -= newcigar[-1]
        newcigar[-2] = SAM_CIGAR_HARD_CLIP
    return seq[start:end], qual[start:end], newcigar


def encode_alignment(
    aln: Alignment,
    primary: Alignment,
    cfg: ArachneConfig,
    attach_bx: bool,
    contig_index: Dict[str, int],
):
    """AppendBam (bamwriter.go:283-568): flags, TLEN, tags -> record args."""
    flags = 0
    # unmapped demotion mutates the record (bamwriter.go:287-290)
    if not aln.is_proper and aln.score - 17 < 19:
        aln.pos = -1
        aln.mapq = 0
    mate_rid, mate_pos, tlen = -1, -1, 0
    pm = primary.mate_alignment
    if aln.mate_id >= 0:
        flags |= 1
        if aln.is_proper:
            if aln is primary:
                flags |= 0x2
            elif pm is not None and is_pair(aln, pm):
                flags |= 0x2
        if pm is None or pm.pos == -1 or (not primary.is_proper and pm.score - 17 < 19):
            flags |= 0x8
            mate_pos, mate_rid = -1, -1
        else:
            if pm.reversed_:
                flags |= 0x20
            mate_rid = contig_index.get(pm.contig, -1)
            mate_pos = int(pm.pos)
        if aln.read1:
            flags |= 0x40
        else:
            flags |= 0x80
        if aln.duplicate:
            flags |= 0x400
        if pm is None or pm.pos == -1:
            mate_rid = -1
            tlen = 0
        elif aln is primary:
            if aln.contig == pm.contig and (primary.is_proper or pm.score - 17 >= 19):
                if aln.reversed_:
                    tlen = -int(aln.aend - pm.pos)
                else:
                    tlen = int(pm.aend - aln.pos)
            else:
                tlen = 0
        else:
            tlen = 0
    if aln is not primary:
        flags |= 256
    rid = contig_index.get(aln.contig, -1)
    mapq = aln.mapq
    pos = int(aln.pos)
    if aln.pos == -1:
        flags |= 0x4
        mapq = 0
        rid = -1
    if aln.reversed_:
        flags |= 0x10
    name = aln.read_name.rstrip("\n")
    seq = bytes(aln.read_seq)
    qual_raw = bytes(aln.read_qual)
    cigar = list(aln.cigar)
    if aln.reversed_:
        seq = revcomp_bytes(seq)
        qual_raw = qual_raw[::-1]
    if primary is not aln:
        seq, qual_raw, cigar = hard_clip(seq, qual_raw, cigar)
    qual = qual_raw.translate(_QUAL_MINUS33)
    cigar_bam = [
        (CIGARTABLE[cigar[i]], cigar[i + 1]) for i in range(0, len(cigar), 2)
    ]

    aux = b""
    rg = aln.read_group
    if rg:
        aux += _aux_string("RG", rg)
    as_tag = _aux_int("AS", aln.score)
    md = aln.mapq_data
    if md is not None:
        aux += _aux_int("XS", int(md.second_best_score))
        as_tag = _aux_int("AS", int(md.score))
        xc = ""
        if md.second_best is not None:
            for rl, fl in zip(md.second_best.mismatch_read_locs, md.second_best.mismatch_locs):
                xc += f"{fl},{rl},1;"
        aux += _aux_string("XC", xc)
        ac = ""
        for rl, fl in zip(aln.mismatch_read_locs, aln.mismatch_locs):
            ac += f"{fl},{rl},1;"
        aux += _aux_string("AC", ac)
    aux += as_tag
    second_best_active = (
        1 if md is not None and md.second_best is not None and md.second_best.active_molecule else 0
    )
    aux += _aux_string("XM", str(second_best_active))
    aux += _aux_string("AM", "1" if aln.active_molecule else "0")
    tandem = (
        1
        if md is not None and md.second_best is not None and aln.molecule_id == md.second_best.molecule_id
        else 0
    )
    aux += _aux_int("XT", tandem)

    secondary = aln.secondary if aln.secondary is not None else aln.primary
    if secondary is not None and secondary.pos > -1:
        cigar_bytes = list(secondary.cigar)
        if secondary.reversed_:
            strand = "-"
            rev = []
            for i in range(0, len(cigar_bytes), 2):
                rev = [cigar_bytes[i], cigar_bytes[i + 1]] + rev
            cigar_bytes = rev
        else:
            strand = "+"
        cig_str = ""
        indel_len = 0
        for i in range(0, len(cigar_bytes), 2):
            op, ln = cigar_bytes[i], cigar_bytes[i + 1]
            ch = "H" if (op == 3 and aln.secondary is not None) else "MIDS"[op]
            if op in (1, 2):
                indel_len += ln
            cig_str += f"{ln}{ch}"
        sa_val = (
            f"{secondary.contig},{secondary.pos},{strand},{cig_str},"
            f"{secondary.mapq},{len(secondary.mismatch_locs) + indel_len};"
        )
        aux += _aux_string("SA", sa_val)

    if cfg.output.debug_tags and md is not None:
        aux += _debug_tags(aln, primary, md)

    bc = aln.barcode.decode() if isinstance(aln.barcode, bytes) else aln.barcode
    if bc and attach_bx:
        aux += _aux_string("BX", bc)
        aux += _aux_int("VX", 1)
        if aln.active_molecule:
            aux += _aux_string("DM", f"{aln.molecule_difference:.6f}")

    return (
        name, flags, rid, pos, mapq, cigar_bam, seq, qual, mate_rid, mate_pos, tlen, aux
    )


def _debug_tags(aln: Alignment, primary: Alignment, md) -> bytes:
    """Debug tag block (bamwriter.go:495-554)."""
    aux = b""
    pm = primary.mate_alignment
    if md.second_best is not None:
        sb = md.second_best
        if sb.mate_alignment is not None:
            aux += _aux_string("XM", f"{sb.mate_alignment.log_alignment_probability:.6f}")
            m = sb.mate_alignment
            aux += _aux_string(
                "XZ",
                f"Match:{m.matches}:Mismatches:{m.mismatches}:Indels:{m.indels}:soft_clipped:{m.soft_clipped}",
            )
        aux += _aux_string(
            "XX",
            f"Match:{sb.matches}:Mismatches:{sb.mismatches}:Indels:{sb.indels}:soft_clipped:{sb.soft_clipped}",
        )
        aux += _aux_string("XL", f"{sb.log_alignment_probability:.6f}")
        aux += _aux_string("XP", "true" if md.second_best_proper_pair else "false")
        aux += _aux_string("XR", str(md.second_best_molecule_reads))
        aux += _aux_string("XC", f"{md.second_best_molecule_confidence:.6f}")
    aux += _aux_string("AA", md.active_alignments_in_molecules)
    aux += _aux_string("CP", str(md.copies))
    aux += _aux_string("CM", str(md.copies_in_active_molecules))
    aux += _aux_string("CU", str(md.unique_molecules_active))
    aux += _aux_string("CS", str(md.copies_outside_active_molecules))
    aux += _aux_string("RD", str(md.reads_in_molecule))
    aux += _aux_string("MS", f"{aln.sum_move_probability_change:.6f}")
    aux += _aux_string("MC", f"{aln.molecule_confidence:.6f}")
    aux += _aux_string("PP", "true" if aln.is_proper else "false")
    if pm is not None:
        aux += _aux_string("PS", str(pm.score))
        aux += _aux_string("PL", f"{pm.log_alignment_probability:.6f}")
    aux += _aux_string(
        "AC",
        f"Match:{aln.matches}:Mismatches:{aln.mismatches}:Indels:{aln.indels}:soft_clipped:{aln.soft_clipped}",
    )
    if pm is not None:
        aux += _aux_string(
            "PC",
            f"Match:{pm.matches}:Mismatches:{pm.mismatches}:Indels:{pm.indels}:soft_clipped:{pm.soft_clipped}",
        )
    return aux
