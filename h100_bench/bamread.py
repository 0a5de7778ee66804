"""BAM files as the benchmark compares them: the header's bytes and each
record's bytes, as the file holds them (block_size first).  ``write_bam``
writes such a file for the control, which stands in the program's place.

``bgzf_decompress`` is copied from tests/bam_reader.py (an implementation
of SAMv1 section 4.1 that shares nothing with the program's writer)."""

import struct
import zlib
from typing import List, Tuple


def bgzf_decompress(path: str) -> bytes:
    """Concatenated inflate of every BGZF member, verifying the gzip magic,
    the BC extra subfield, each member's CRC32 + ISIZE, and the presence of
    the 28-byte EOF marker (SAMv1 4.1.2)."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    off = 0
    saw_eof = False
    while off < len(data):
        if data[off : off + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"bad BGZF member magic at offset {off}")
        xlen = struct.unpack("<H", data[off + 10 : off + 12])[0]
        extra = data[off + 12 : off + 12 + xlen]
        bsize = None
        e = 0
        while e + 4 <= len(extra):
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack("<H", extra[e + 2 : e + 4])[0]
            if si1 == 66 and si2 == 67:  # 'B','C'
                if slen != 2:
                    raise ValueError("BC subfield SLEN != 2")
                bsize = struct.unpack("<H", extra[e + 4 : e + 6])[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError("BGZF member missing BC subfield")
        cdata = data[off + 12 + xlen : off + bsize - 8]
        crc32, isize = struct.unpack("<II", data[off + bsize - 8 : off + bsize])
        raw = zlib.decompress(cdata, -15)
        if len(raw) != isize:
            raise ValueError(f"ISIZE mismatch: {len(raw)} != {isize}")
        if zlib.crc32(raw) & 0xFFFFFFFF != crc32:
            raise ValueError("CRC32 mismatch in BGZF member")
        if isize == 0 and off + bsize == len(data):
            saw_eof = True
        out.append(raw)
        off += bsize
    if not saw_eof:
        raise ValueError("missing BGZF EOF marker block")
    return b"".join(out)


def split_bam(data: bytes) -> Tuple[bytes, List[bytes]]:
    """(header bytes through the reference list, [record bytes])."""
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4 + l_name + 4
    header = data[:off]
    records = []
    while off < len(data):
        (size,) = struct.unpack_from("<i", data, off)
        records.append(data[off : off + 4 + size])
        off += 4 + size
    if off != len(data):
        raise ValueError("truncated BAM record")
    return header, records


def read_bam(path: str) -> Tuple[bytes, List[bytes]]:
    return split_bam(bgzf_decompress(path))


def qname(record: bytes) -> str:
    """A record's read name (SAMv1 4.2: l_read_name at byte 12 of the
    record after block_size, the name from byte 36)."""
    n = record[12]
    return record[36 : 36 + n - 1].decode()


BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")


def write_bam(path: str, header: bytes, records: List[bytes]) -> None:
    """A BGZF file of the header and the records (SAMv1 4.1): members of
    at most 65,280 bytes of input each, then the EOF marker."""
    data = header + b"".join(records)
    with open(path, "wb") as fh:
        for at in range(0, len(data), 65280):
            raw = data[at : at + 65280]
            comp = zlib.compressobj(6, zlib.DEFLATED, -15)
            cdata = comp.compress(raw) + comp.flush()
            fh.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
                     + struct.pack("<H", len(cdata) + 25) + cdata
                     + struct.pack("<II", zlib.crc32(raw) & 0xFFFFFFFF, len(raw)))
        fh.write(BGZF_EOF)
