"""The port's BAM encoding (arachne_tpu_torch/io/bam.py): each record
encoded once by ``encode_record`` and written to bc_sorted_bam and to its
position bucket, held byte for byte to the record layout written base by
base and to a dump that encodes and writes one record at a time
(tests/torch_bam_util.py), in single dumps and in whole ``align`` runs."""

import os
import struct
from types import SimpleNamespace

import pytest
import torch

from arachne_tpu_torch.config import ArachneConfig, OutputOptions
from arachne_tpu_torch.io import bam
from bam_reader import read_bam, reg2bin
from torch_bam_util import CASES, dump_record_by_record, edge_batch, record, spec_record
from torch_cli_util import make_fixture

torch.set_num_threads(1)

# c1 spans eight position buckets; c2 and c3 share one
CONTIGS = [("c1", 1 << 27), ("c2", 5_000), ("c3", 3_000)]
CHUNK = 1 << 24


def _record_by_record(m):
    """The dump that encodes each record twice and writes it a record at a
    time, as the writer did before."""
    m.setattr(bam.BAMWriters, "dump", dump_record_by_record)


class _Read:
    """What ``BAMWriters.dump`` reads of an alignment besides what
    ``encode_alignment`` (patched to return ``rec``) reads."""

    def __init__(self, rec, secondary=None):
        self.rec, self.secondary, self.active = rec, secondary, True
        self.contig = CONTIGS[rec[2]][0] if rec[2] >= 0 else "*"
        self.pos = rec[3]

    def is_unmapped(self):
        return self.pos == -1


def _dump(recs, out, m):
    """``recs`` through ``BAMWriters.dump`` as reads of a primary and its
    supplementary record each; the files' bytes and the offsets after a
    flush."""
    m.setattr(bam, "encode_alignment", lambda aln, *a: aln.rec)
    idx = SimpleNamespace(packed=SimpleNamespace(
        anns=[SimpleNamespace(name=n, length=ln) for n, ln in CONTIGS]))
    w = bam.BAMWriters(idx, out, ArachneConfig(output=OutputOptions(position_chunk_size=CHUNK)))
    reads = [[_Read(recs[i], _Read(recs[i + 1]) if i + 1 < len(recs) else None)]
             for i in range(0, len(recs), 2)]
    w.dump(reads, attach_bx=False)
    w.flush()
    offsets = w.offsets()
    routes = [os.path.basename(w._bucket_for(_Read(r), r[3] == -1).path) for r in recs]
    w.close()
    files = {}
    for fn in sorted(os.listdir(out)):
        with open(os.path.join(out, fn), "rb") as fh:
            files[fn] = fh.read()
    return files, offsets, routes


@pytest.mark.parametrize("case", sorted(CASES) + ["all_cases_in_one_batch"])
def test_encoder_writes_the_specs_bytes(case, tmp_path, monkeypatch):
    """Record by record, the encoder is the layout written base by base;
    through ``dump``, every file and offset is the same as when each record
    is encoded twice and written one at a time, and each bucket holds its
    records in order."""
    recs = edge_batch() if case not in CASES else CASES[case]
    assert [bam.encode_record(*r) for r in recs] == [spec_record(*r) for r in recs]

    with monkeypatch.context() as m:
        got, offsets, routes = _dump(recs, str(tmp_path / "once"), m)
    with monkeypatch.context() as m:
        _record_by_record(m)
        assert (got, offsets) == _dump(recs, str(tmp_path / "by_record"), m)[:2]
    by_file = {fn: read_bam(str(tmp_path / "once" / fn)).records for fn in got}
    assert [r.qname for r in by_file["bc_sorted_bam.bam"]] == [r[0] for r in recs]
    for fn, records in by_file.items():
        if fn != "bc_sorted_bam.bam":
            assert [r.qname for r in records] == [r[0] for r, to in zip(recs, routes) if to == fn]
    for got_rec, rec in zip(by_file["bc_sorted_bam.bam"], recs):
        assert (got_rec.rid, got_rec.pos, got_rec.flag) == (rec[2], rec[3], rec[1])
        if rec[3] >= 0:
            assert got_rec.bin == reg2bin(rec[3], rec[3] + max(got_rec.ref_span(), 1))
        else:
            assert got_rec.bin == 4680


@pytest.mark.parametrize("wide", [
    # 255 bytes with the NUL: past l_read_name's uint8
    record(name="x" * 255),
    # past 2^29, reg2bin's bin passes its uint16
    record(pos=(1 << 30) - 100),
], ids=["name", "bin"])
def test_a_field_too_wide_for_bam_raises(wide):
    """A field that does not fit its BAM width raises, as it always did."""
    with pytest.raises(struct.error):
        bam.encode_record(*wide)
    with pytest.raises(struct.error):
        spec_record(*wide)


def _blocks(data: bytes) -> int:
    """BGZF blocks in a file, by each block's BSIZE."""
    n = off = 0
    while off < len(data):
        off += struct.unpack("<H", data[off + 16 : off + 18])[0] + 1
        n += 1
    return n


def _align(fx, out, ckpt):
    from arachne_tpu_torch.cli import main

    main(["align", out, fx["ref"], fx["r1"], fx["r2"], "--engine", "torch-cpu", "-t", "2",
          "--partitions", "20000", "--checkpoint", ckpt])


def test_align_writes_the_same_files_and_offsets_as_record_by_record(tmp_path):
    """``align --engine torch-cpu -t 2`` on a 120 kbp genome in six
    position buckets, small superbatches and a manifest every seven sets:
    every output file, BGZF blocks included, and ``BAMWriters.offsets()``
    after every flush are the same as when each record is encoded twice
    and written one at a time."""
    fx = make_fixture(tmp_path, ("--barcodes", "8", "--molecules", "2", "--pairs", "8",
                                 "--seed", "5"))
    runs = {}
    for mode in ("once", "by_record"):
        flushed = []
        offsets = bam.BAMWriters.offsets

        def spy(self):
            flushed.append(offsets(self))
            return flushed[-1]

        with pytest.MonkeyPatch.context() as m:
            m.setenv("ARACHNE_TEST_READS_PER_BATCH", "24")
            m.setenv("ARACHNE_CHECKPOINT_EVERY", "7")
            m.setattr(bam.BAMWriters, "offsets", spy)
            if mode == "by_record":
                _record_by_record(m)
            _align(fx, str(tmp_path / mode), str(tmp_path / f"{mode}.ckpt"))
        files = {}
        for fn in sorted(os.listdir(tmp_path / mode)):
            with open(tmp_path / mode / fn, "rb") as fh:
                files[fn] = fh.read()
        runs[mode] = SimpleNamespace(files=files, flushed=flushed)
    once, by_record = runs["once"], runs["by_record"]
    assert len(once.files) == 8  # bc_sorted_bam, six buckets, unmapped
    assert once.files == by_record.files
    assert len(once.flushed) >= 3 and once.flushed == by_record.flushed
    # more BGZF blocks than flushes: the records between two flushes span
    # a block's end
    assert _blocks(once.files["bc_sorted_bam.bam"]) > len(once.flushed) + 1
    n = len(read_bam(str(tmp_path / "once" / "bc_sorted_bam.bam")).records)
    assert n >= 2 * 8 * 2 * 8
    buckets = sum(len(read_bam(str(tmp_path / "once" / fn)).records)
                  for fn in once.files if fn != "bc_sorted_bam.bam")
    assert buckets == n
