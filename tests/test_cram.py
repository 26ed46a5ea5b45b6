"""CRAM 3.0 reader/writer (io/cram*.py): codec roundtrips, container
roundtrips, reference-based decode, and pipeline equivalence.

No samtools/htslib/pysam exists in this environment, so cross-tool
fixtures are impossible: the writer is the spec-faithful counterpart
that validates the reader by round-trip (both implement the CRAM 3.0
spec text; io/cram.py's docstring records the scope)."""

import numpy as np
import pytest

from kbbq_tpu.io.bam import BamFile, build_record, machine_order_read
from kbbq_tpu.io.cram import CRAMError, read_cram
from kbbq_tpu.io.cram_codecs import (
    rans_compress_o0,
    rans_compress_o1,
    rans_uncompress,
    read_itf8,
    read_ltf8,
    write_itf8,
    write_ltf8,
)
from kbbq_tpu.io.cram_write import write_cram
from kbbq_tpu.pipeline import RecalConfig


@pytest.mark.parametrize("v", [0, 1, 127, 128, 16383, 16384, 2 ** 20,
                               2 ** 27, 2 ** 28 - 1, 2 ** 31 - 1,
                               0xFFFFFFFF])
def test_itf8_roundtrip(v):
    b = write_itf8(v)
    got, p = read_itf8(b, 0)
    assert (got & 0xFFFFFFFF) == (v & 0xFFFFFFFF) and p == len(b)


@pytest.mark.parametrize("v", [0, 127, 128, 2 ** 14, 2 ** 21, 2 ** 40,
                               2 ** 55, 2 ** 62])
def test_ltf8_roundtrip(v):
    b = write_ltf8(v)
    got, p = read_ltf8(b, 0)
    assert got == v and p == len(b)


def test_rans_roundtrip():
    rng = np.random.default_rng(1)
    cases = [b"", b"a", b"hello world" * 3,
             bytes(rng.integers(0, 4, 1000).astype(np.uint8)),
             bytes(rng.integers(0, 256, 5003).astype(np.uint8)),
             b"\x00" * 1000,
             bytes(rng.choice([65, 67, 71, 84], 10001,
                              p=[.4, .3, .2, .1]).astype(np.uint8))]
    for data in cases:
        assert rans_uncompress(rans_compress_o0(data)) == data
        assert rans_uncompress(rans_compress_o1(data)) == data


def _mixed_records(seed=5, n=50):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        L = int(rng.integers(20, 80))
        codes = rng.integers(0, 5, L).astype(np.int8)
        quals = rng.integers(0, 45, L).astype(np.uint8)
        flag = (0x10 if i % 3 == 1 else 0) | (0x1 | 0x80 if i % 2 else 0)
        if i % 7 == 3:
            flag |= 0x4  # unmapped
        rec = build_record(
            f"r{i}", codes, quals, flag=flag, rg=None,
            refid=0 if not flag & 0x4 else -1,
            pos=int(rng.integers(0, 100)) if not flag & 0x4 else -1,
            aux_extra=b"OQZ" + bytes((quals + 33).tolist()) + b"\x00")
        rec._rg_index = i % 2
        recs.append(rec)
    hdr = ("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:1000\n"
           "@RG\tID:g0\n@RG\tID:g1\n")
    return BamFile(hdr, [("chr1", 1000)], recs)


def test_cram_roundtrip_noref(tmp_path):
    bf = _mixed_records()
    p = tmp_path / "t.cram"
    write_cram(bf, str(p))
    bf2, _ = read_cram(str(p))
    assert len(bf2.records) == len(bf.records)
    for a, b in zip(bf.records, bf2.records):
        assert a.name == b.name and a.flag == b.flag
        assert (a.seq_codes() == b.seq_codes()).all(), a.name
        assert (a.quals() == b.quals()).all(), a.name
        assert b.get_zstr("RG") == (b"g0" if a._rg_index == 0 else b"g1")
        assert b.get_zstr("OQ") == a.get_zstr("OQ")


def test_cram_multiple_containers(tmp_path):
    bf = _mixed_records(n=37)
    p = tmp_path / "t.cram"
    write_cram(bf, str(p), records_per_container=10)
    bf2, _ = read_cram(str(p))
    assert [r.name for r in bf2.records] == [r.name for r in bf.records]


def _ref_records(seed=11):
    rng = np.random.default_rng(seed)
    ref_codes = rng.integers(0, 4, 500)
    ref_bytes = bytes(np.frombuffer(b"ACGT", np.uint8)[ref_codes]
                      .tobytes())
    recs = []
    for i in range(30):
        L = 60
        pos = int(rng.integers(0, 440))
        codes = ref_codes[pos:pos + L].astype(np.int8).copy()
        for j in rng.integers(0, L, 3):
            codes[j] = (codes[j] + 1) % 4
        if i % 3 == 0:
            # N runs force mixed b-span + ref-fill + X features in the
            # writer — the decode shape ADVICE round 4 flagged
            s = int(rng.integers(0, L - 5))
            codes[s:s + int(rng.integers(1, 5))] = 4
        if i % 11 == 5:
            codes[:] = 4          # whole-read N: single b span
        quals = rng.integers(0, 45, L).astype(np.uint8)
        rec = build_record(f"r{i}", codes, quals, flag=0, rg=None,
                           refid=0, pos=pos, cigar=[("M", L)])
        rec._rg_index = 0
        recs.append(rec)
    hdr = "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:500\n@RG\tID:g0\n"
    return BamFile(hdr, [("chr1", 500)], recs), ref_bytes


def test_cram_reference_based(tmp_path):
    bf, ref_bytes = _ref_records()
    # embedded reference: self-contained file
    p1 = tmp_path / "emb.cram"
    write_cram(bf, str(p1), ref={"chr1": ref_bytes}, embed_ref=True)
    got, _ = read_cram(str(p1))
    for a, b in zip(bf.records, got.records):
        assert (a.seq_codes() == b.seq_codes()).all(), a.name
        assert (a.quals() == b.quals()).all()
    # external FASTA
    p2 = tmp_path / "ext.cram"
    write_cram(bf, str(p2), ref={"chr1": ref_bytes})
    fa = tmp_path / "ref.fa"
    fa.write_text(">chr1\n" + ref_bytes.decode() + "\n")
    got2, _ = read_cram(str(p2), fasta_ref=str(fa))
    for a, b in zip(bf.records, got2.records):
        assert (a.seq_codes() == b.seq_codes()).all(), a.name
    # X features really were used (file smaller than verbatim bases)
    # and a missing reference is a clear error, not silent Ns
    with pytest.raises(CRAMError, match="fasta-ref"):
        read_cram(str(p2))


def test_recalibrate_cram_matches_bam_path(tmp_path):
    """kbbq recalibrate on a CRAM == the same reads through the BAM
    path, byte-for-byte on the machine-order quals."""
    from kbbq_tpu.io.bam import read_bam, serialize_bam
    from kbbq_tpu.pipeline.bam import recalibrate_bam, recalibrate_cram

    bf = _mixed_records(seed=9, n=120)
    cram = tmp_path / "in.cram"
    write_cram(bf, str(cram))
    # the same records as BAM (RG aux materialized like the reader does)
    bam_recs = []
    for rec in bf.records:
        import copy
        r2 = build_record(rec.name,
                          rec.seq_codes(),
                          rec.quals().astype(np.uint8), flag=rec.flag,
                          rg="g0" if rec._rg_index == 0 else "g1",
                          refid=rec.refid, pos=rec.pos,
                          aux_extra=b"OQZ" + rec.get_zstr("OQ") + b"\x00")
        bam_recs.append(r2)
    bam = tmp_path / "in.bam"
    bam.write_bytes(serialize_bam(
        BamFile(bf.header_text, bf.refs, bam_recs)))

    cfg = RecalConfig(k=16, coverage=12.0, batch_size=64)
    out_bam1 = tmp_path / "o1.bam"
    out_bam2 = tmp_path / "o2.bam"
    recalibrate_cram(str(cram), str(out_bam1), cfg)
    recalibrate_bam(str(bam), str(out_bam2), cfg)
    a = read_bam(str(out_bam1))
    b = read_bam(str(out_bam2))
    assert len(a.records) == len(b.records)
    for ra, rb in zip(a.records, b.records):
        assert ra.name == rb.name
        assert (ra.quals() == rb.quals()).all(), ra.name

    # CRAM -> CRAM output roundtrip: re-reading gives the same quals
    out_cram = tmp_path / "o.cram"
    recalibrate_cram(str(cram), str(out_cram), cfg, set_oq=True)
    rt, _ = read_cram(str(out_cram))
    for ra, rc in zip(a.records, rt.records):
        assert (ra.quals() == rc.quals()).all(), ra.name
        assert rc.get_zstr("OQ") is not None


def test_huffman_and_beta_decoders():
    """Hand-built encoding params + core bitstream: canonical Huffman
    (multi-symbol) and BETA decode per the spec's bit conventions."""
    from kbbq_tpu.io.cram import BitReader, Decoder
    from kbbq_tpu.io.cram_codecs import write_itf8

    # canonical Huffman: syms [5, 6, 7] lens [1, 2, 2]
    # -> codes: 5=0, 6=10, 7=11
    def arr(vals):
        out = write_itf8(len(vals))
        for v in vals:
            out += write_itf8(v)
        return out

    params = arr([5, 6, 7]) + arr([1, 2, 2])
    # bit stream for symbols 5,6,7,5: 0 10 11 0 -> 0101 1000
    core = BitReader(bytes([0b01011000]))
    dec = Decoder((3, params), {}, core)
    assert [dec.get_int() for _ in range(4)] == [5, 6, 7, 5]

    # BETA: offset 2, 3 bits; values 0b101=5 -> 5-2=3, 0b001=1 -> -1
    params_b = write_itf8(2) + write_itf8(3)
    core2 = BitReader(bytes([0b10100100]))
    dec2 = Decoder((6, params_b), {}, core2)
    assert dec2.get_int() == 3
    assert dec2.get_int() == -1


def test_byte_array_len_decoder():
    from kbbq_tpu.io.cram import Decoder, Stream, BitReader
    from kbbq_tpu.io.cram_codecs import write_itf8

    # lengths EXTERNAL(cid 1), values EXTERNAL(cid 2)
    def enc_ext(cid):
        p = write_itf8(cid)
        return write_itf8(1) + write_itf8(len(p)) + p

    le = enc_ext(1)
    ve = enc_ext(2)
    params = le + ve
    streams = {1: Stream(write_itf8(3) + write_itf8(2)),
               2: Stream(b"abcde")}
    dec = Decoder((4, params), streams, BitReader(b""))
    assert dec.get_bytes() == b"abc"
    assert dec.get_bytes() == b"de"


def test_cram_corrupt_inputs_fail_cleanly(tmp_path):
    """Truncated/corrupted CRAMs raise, never hang or return garbage
    silently (decoder robustness; the reference's htslib errors too)."""
    bf = _mixed_records(n=10)
    p = tmp_path / "ok.cram"
    write_cram(bf, str(p))
    blob = bytearray(p.read_bytes())

    bad = tmp_path / "bad.cram"
    # wrong magic
    bad.write_bytes(b"XRAM" + bytes(blob[4:]))
    with pytest.raises(Exception):
        read_cram(str(bad))
    # unsupported major version
    bad.write_bytes(b"CRAM" + bytes([9, 0]) + bytes(blob[6:]))
    with pytest.raises(CRAMError, match="version"):
        read_cram(str(bad))
    # truncations at several depths
    for cut in (30, 100, len(blob) // 2, len(blob) - 40):
        bad.write_bytes(bytes(blob[:cut]))
        with pytest.raises(Exception):
            read_cram(str(bad))
    # corrupted compressed payload
    flip = bytearray(blob)
    flip[len(flip) // 2] ^= 0xFF
    bad.write_bytes(bytes(flip))
    try:
        got, _ = read_cram(str(bad))
        # a lucky flip may land in slack space; if it decodes, records
        # must still be structurally sane
        for r in got.records:
            assert r.l_seq >= 0
    except Exception:
        pass


def test_huffman_canonical_ties_by_symbol():
    """Canonical code assignment must sort ties by SYMBOL VALUE (the
    htslib convention), not by transmission index: an alphabet stored
    out of ascending symbol order within a bit-length class must still
    decode to the symbol-sorted table (ADVICE round 3)."""
    from kbbq_tpu.io.cram import BitReader, Decoder
    from kbbq_tpu.io.cram_codecs import write_itf8

    def arr(vals):
        out = write_itf8(len(vals))
        for v in vals:
            out += write_itf8(v)
        return out

    # transmission order [7, 5, 6] with lens [2, 1, 2]: canonical by
    # (len, symbol) gives 5=0, 6=10, 7=11 — index-tied assignment would
    # swap 6 and 7
    params = arr([7, 5, 6]) + arr([2, 1, 2])
    # bit stream 0 10 11 -> 5, 6, 7
    core = BitReader(bytes([0b01011000]))
    dec = Decoder((3, params), {}, core)
    assert [dec.get_int() for _ in range(3)] == [5, 6, 7]


def test_cram_container_trailing_padding(tmp_path):
    """Containers may carry trailing slack after their n_blocks blocks
    (htslib reserves header-container space for in-place updates); the
    reader must skip it via n_blocks, not parse it as garbage blocks
    (ADVICE round 3)."""
    import struct

    from kbbq_tpu.io.cram import read_container_header

    bf = _mixed_records(n=12)
    p = tmp_path / "t.cram"
    write_cram(bf, str(p))
    blob = bytearray(p.read_bytes())

    # walk to the SECOND container (first data container) and insert
    # PAD zero bytes of slack at its end, bumping its length field
    buf = np.frombuffer(bytes(blob), np.uint8)
    pos = 26
    cont, _ = read_container_header(buf, pos)     # header container
    pos = cont.body_pos + cont.length
    c2_start = pos
    cont2, _ = read_container_header(buf, pos)
    c2_end = cont2.body_pos + cont2.length
    PAD = 37
    patched = (bytes(blob[:c2_start])
               + struct.pack("<i", cont2.length + PAD)
               + bytes(blob[c2_start + 4:c2_end])
               + b"\x00" * PAD
               + bytes(blob[c2_end:]))
    padded = tmp_path / "padded.cram"
    padded.write_bytes(patched)
    got, _ = read_cram(str(padded))
    assert [r.name for r in got.records] == [r.name for r in bf.records]
    for a, b in zip(bf.records, got.records):
        assert (a.seq_codes() == b.seq_codes()).all()


def test_cram_all_substitution_record_missing_ref_raises(tmp_path):
    """A reference-based record whose EVERY base is an X substitution
    never reaches fill_ref with a nonzero span; decoding it without a
    reference must still raise, not return silent Ns (ADVICE round 3)."""
    rng = np.random.default_rng(3)
    ref_codes = rng.integers(0, 4, 200)
    ref_bytes = np.frombuffer(b"ACGT", np.uint8)[ref_codes].tobytes()
    L = 40
    pos = 50
    codes = ((ref_codes[pos:pos + L] + 1) % 4).astype(np.int8)  # all X
    quals = rng.integers(0, 45, L).astype(np.uint8)
    rec = build_record("rX", codes, quals, flag=0, rg=None, refid=0,
                       pos=pos, cigar=[("M", L)])
    rec._rg_index = 0
    hdr = "@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:200\n@RG\tID:g0\n"
    bf = BamFile(hdr, [("chr1", 200)], [rec])
    p = tmp_path / "allx.cram"
    write_cram(bf, str(p), ref={"chr1": ref_bytes})
    with pytest.raises(CRAMError, match="fasta-ref"):
        read_cram(str(p))
    # sanity: with the reference it decodes exactly
    fa = tmp_path / "ref.fa"
    fa.write_text(">chr1\n" + ref_bytes.decode() + "\n")
    got, _ = read_cram(str(p), fasta_ref=str(fa))
    assert (got.records[0].seq_codes() == codes).all()


def test_cram_multi_slice_roundtrip(tmp_path):
    """Multiple slices per container (htslib's slices_per_container
    shape): shared compression header, per-slice block sets, landmark
    offsets — decode must match record-for-record."""
    from kbbq_tpu.io.cram import CramStream, split_slices

    bf = _mixed_records(seed=51, n=60)
    p = tmp_path / "ms.cram"
    write_cram(bf, str(p), records_per_container=30, records_per_slice=8)
    with CramStream(str(p)) as cs:
        per_cont = [len(split_slices(blocks))
                    for _, blocks, _ in cs.containers()]
    assert per_cont == [4, 4]          # 30 records -> 8+8+8+6
    bf2, _ = read_cram(str(p))
    assert len(bf2.records) == len(bf.records)
    for a, b in zip(bf.records, bf2.records):
        assert a.name == b.name and a.flag == b.flag
        assert (a.seq_codes() == b.seq_codes()).all(), a.name
        assert (a.quals() == b.quals()).all(), a.name
        assert b.get_zstr("OQ") == a.get_zstr("OQ")


def test_cram_multi_slice_ref_based_roundtrip(tmp_path):
    bf, ref_bytes = _ref_records(seed=53)
    for embed in (False, True):
        p = tmp_path / f"ms{embed}.cram"
        write_cram(bf, str(p), records_per_container=30,
                   records_per_slice=7, ref={"chr1": ref_bytes},
                   embed_ref=embed)
        if embed:
            got, _ = read_cram(str(p))
        else:
            fa = tmp_path / "ref.fa"
            fa.write_text(">chr1\n" + ref_bytes.decode() + "\n")
            got, _ = read_cram(str(p), fasta_ref=str(fa))
        for a, b in zip(bf.records, got.records):
            assert (a.seq_codes() == b.seq_codes()).all(), a.name
            assert (a.quals() == b.quals()).all()


def test_cram_bytes_do_not_depend_on_the_clock(tmp_path, monkeypatch):
    """Gzip-compressed blocks carry no timestamp: writing the same
    records at two different times gives the same file bytes."""
    import time

    bf = _mixed_records(seed=19, n=48)
    paths = []
    for i, now in enumerate((1.0e9, 2.0e9)):
        monkeypatch.setattr(time, "time", lambda now=now: now)
        p = tmp_path / f"at{i}.cram"
        write_cram(bf, str(p), records_per_container=16)
        paths.append(p)
    assert paths[0].read_bytes() == paths[1].read_bytes()
