"""For tests/test_torch_bam.py: BAM records (the 12-tuples
``io.bam.encode_alignment`` returns) that reach the encoder's edges, the
BAM record layout one base at a time as the spec the encoder is held to,
and ``BAMWriters.dump`` as it was before records were encoded once:
each record encoded twice, and written one at a time."""

import struct

from arachne_tpu_torch.io import bam
from arachne_tpu_torch.io.bam import SEQ_NIBBLE, hard_clip, reg2bin

# the bridge's CIGAR ops as BAM's (io/bam.py CIGARTABLE)
M, I, D, N, S, H, EQ, X = 0, 1, 2, 3, 4, 5, 7, 8
QUALS = bytes(range(0, 60))


def record(name="r", flags=0x41, rid=0, pos=100, mapq=60, cigar=((M, 6),), seq=b"ACGTAC",
           qual=None, mate_rid=0, mate_pos=300, tlen=350, aux=b"ASi\x06\x00\x00\x00"):
    qual = (QUALS * 5)[: len(seq)] if qual is None else qual
    return (name, flags, rid, pos, mapq, list(cigar), seq, qual, mate_rid, mate_pos, tlen, aux)


def supplementary():
    """A split read's supplementary record as ``encode_alignment`` makes it:
    the soft clips hard, the clipped bases and qualities gone."""
    seq = b"ACGTTGCAACGTTGCAAC"
    qual = bytes(range(30, 48))
    seq, qual, cig = hard_clip(seq, qual, [3, 4, 0, 10, 3, 4])
    cigar = [((M, I, D, S, H)[cig[i]], cig[i + 1]) for i in range(0, len(cig), 2)]
    return record(name="split/1", flags=0x41 | 0x800, pos=5000, cigar=cigar, seq=seq, qual=qual)


def reg2bin_edges():
    """Records whose span starts before and ends after each bin level's
    boundary, and spans that end just inside it."""
    out = []
    for shift in (14, 17, 20, 23, 26):
        edge = 1 << shift
        for pos, ln in ((edge - 3, 6), (edge - 6, 6), (edge, 1), (edge - 1, 1), (2 * edge - 2, 5)):
            out.append(record(name=f"bin{shift}_{pos}", pos=pos, cigar=[(M, ln)], seq=b"A" * ln))
    # spans that cross 2^26 itself fall in bin 0
    out.append(record(name="bin0", pos=(1 << 26) - 50, cigar=[(M, 20), (N, 100), (M, 20)],
                      seq=b"C" * 40))
    return out


CASES = {
    "n_lowercase_iupac": [
        record(seq=b"NNNNacgtnRYKMSWBDHV=", cigar=[(M, 20)]),
        record(seq=b"acgtACGTuU.-*x ", cigar=[(M, 15)]),
    ],
    "odd_and_even_lengths": [
        record(name=f"len{n}", seq=(b"ACGTN" * 40)[:n], cigar=[(M, n)]) for n in range(1, 14)
    ] + [record(name="len151", seq=(b"GATC" * 40)[:151], cigar=[(M, 151)])],
    "empty_sequence": [
        record(seq=b"", qual=b"", cigar=[]),
        record(seq=b"", qual=b"", cigar=[], pos=-1, rid=-1, flags=0x4),
    ],
    "empty_quality": [
        record(seq=b"ACGTA", qual=b"", cigar=[(M, 5)]),
        record(seq=b"ACGTAC", qual=b"", cigar=[(M, 6)]),
    ],
    "quality_above_93": [
        record(seq=b"ACGTACGT", qual=bytes([0, 92, 93, 94, 120, 127, 200, 255]), cigar=[(M, 8)]),
    ],
    "hard_clipped_supplementary": [supplementary()],
    "unmapped": [
        record(rid=-1, pos=-1, mapq=0, flags=0x4 | 0x1 | 0x80, cigar=[(M, 6)], mate_rid=-1,
               mate_pos=-1, tlen=0),
        record(rid=0, pos=-1, flags=0x4, cigar=[], tlen=0),
    ],
    "reg2bin_edges": reg2bin_edges(),
    "long_cigars": [
        record(cigar=[(S, 3)] + [(M, 7), (D, 2), (N, 500), (EQ, 4), (X, 1), (I, 2)] * 40
               + [(S, 2)], seq=b"A" * (3 + 14 * 40 + 2)),
        record(cigar=[(EQ, 1), (X, 1)] * 2000, seq=b"CG" * 2000),
    ],
    "empty_aux": [record(aux=b""), record(aux=b"", seq=b"A", cigar=[(M, 1)])],
    "names_of_many_lengths": [
        record(name="n" * k, pos=100 + k) for k in (0, 1, 2, 3, 7, 8, 63, 64, 127, 200, 253, 254)
    ],
    "mixed_buckets": [
        record(name=f"mix{i}", rid=rid, pos=pos)
        for i, (rid, pos) in enumerate(
            [(0, 10), (0, 10), (0, (1 << 24) + 5), (1, 40), (0, 20), (-1, -1), (2, 7), (0, 30),
             (0, (3 << 24) + 9), (0, (3 << 24) + 11), (-1, -1), (1, 50), (0, 40)]
        )
    ],
}


def edge_batch():
    """Every case's records in one batch."""
    return [r for recs in CASES.values() for r in recs]


def spec_record(name, flags, rid, pos, mapq, cigar_bam, seq, qual, mate_rid, mate_pos, tlen, aux):
    """One BAM record, block_size first, written field by field and base
    by base (SAM/BAM specification, section 4.2)."""
    nm = name.encode() + b"\x00"
    lseq = len(seq)
    end = pos + sum(l for op, l in cigar_bam if op in (M, D, N, EQ, X))
    rec = struct.pack(
        "<iiBBHHHiiii", rid, pos, len(nm), mapq & 0xFF,
        reg2bin(max(pos, 0), max(end, pos + 1)) if pos >= 0 else 4680,
        len(cigar_bam), flags & 0xFFFF, lseq, mate_rid, mate_pos, tlen,
    )
    rec += nm
    for op, l in cigar_bam:
        rec += struct.pack("<I", (l << 4) | op)
    packed = bytearray((lseq + 1) // 2)
    for i, b in enumerate(seq.decode()):
        nib = SEQ_NIBBLE.get(b.upper(), 15)
        if i % 2 == 0:
            packed[i // 2] = nib << 4
        else:
            packed[i // 2] |= nib
    rec += bytes(packed)
    rec += bytes(min(q, 93) for q in qual) if qual else b"\xff" * lseq
    rec += aux
    return struct.pack("<i", len(rec)) + rec


def dump_record_by_record(writers, alignments, attach_bx):
    """``BAMWriters.dump`` record by record: each record encoded by
    ``spec_record`` for bc_sorted_bam and again for its position bucket."""
    contig_index = writers.barcode_sorted.contig_index

    def append(aln, primary):
        args = bam.encode_alignment(aln, primary, writers.cfg, attach_bx, contig_index)
        writers.barcode_sorted.write_bam(spec_record(*args))
        writers._bucket_for(aln, aln.is_unmapped()).write_bam(spec_record(*args))

    for alignment_array in alignments:
        assert alignment_array, "not all read_ids are spoken for"
        read_output = False
        for alignment in alignment_array:
            if alignment.active:
                append(alignment, alignment)
                if alignment.secondary is not None:
                    append(alignment.secondary, alignment)
                read_output = True
        assert read_output, "read_id has no active alignment"
