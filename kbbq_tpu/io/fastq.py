"""Vectorized FASTQ reader/writer (plain or gzip).

Vectorized design (SURVEY.md §8.1 L0, H6): the whole file is scanned with
NumPy — newline offsets via a single pass, sequence/quality lines sliced by
offset arithmetic — no per-read Python loop on the hot path.  The writer
exploits the kbbq invariant that ONLY quality strings change
(SURVEY.md §1): output = input buffer with the quality-line byte ranges
overwritten, so names/sequences/comments are byte-identical by construction.

Reference analog: kseq-based FastqFile in htsiter.cc (pub:src/kbbq/
htsiter.cc, SURVEY.md §3.1 C6; mount empty, §0).
"""

from __future__ import annotations

import dataclasses
import gzip
import io as _io

import numpy as np

from ..constants import PHRED_OFFSET
from ..oracle.kmers import _ENCODE_LUT  # shared bit-exact encode LUT

_NL = 10  # ord('\n')


@dataclasses.dataclass
class FastqData:
    """Parsed FASTQ: flat buffer + per-record offsets (zero-copy slices).

    seq_starts[i]:seq_ends[i] and qual_starts[i]:qual_ends[i] index into
    `buf`.  Record i's name line is name_starts[i]:name_ends[i] (without
    the leading '@' or trailing newline).
    """

    buf: np.ndarray          # uint8 [filesize]
    name_starts: np.ndarray  # int64 [N]
    name_ends: np.ndarray
    seq_starts: np.ndarray
    seq_ends: np.ndarray
    qual_starts: np.ndarray
    qual_ends: np.ndarray

    @property
    def num_reads(self) -> int:
        return int(self.name_starts.shape[0])

    @property
    def lengths(self) -> np.ndarray:
        return self.seq_ends - self.seq_starts

    @property
    def max_len(self) -> int:
        return int(self.lengths.max()) if self.num_reads else 0

    def seq_bytes(self, i: int) -> bytes:
        return self.buf[self.seq_starts[i]:self.seq_ends[i]].tobytes()

    def qual_bytes(self, i: int) -> bytes:
        return self.buf[self.qual_starts[i]:self.qual_ends[i]].tobytes()

    def name_bytes(self, i: int) -> bytes:
        return self.buf[self.name_starts[i]:self.name_ends[i]].tobytes()

    def seconds_mask(self) -> np.ndarray:
        """Second-in-pair per DECISIONS.md D11: name (sans comment) ends '/2'."""
        out = np.zeros(self.num_reads, dtype=bool)
        buf = self.buf
        for i in range(self.num_reads):  # names are cold path
            s, e = int(self.name_starts[i]), int(self.name_ends[i])
            name = buf[s:e].tobytes().split()[0] if e > s else b""
            out[i] = name.endswith(b"/2")
        return out


def _load_bytes(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            data = gzip.decompress(f.read())
        else:
            data = f.read()
    return np.frombuffer(data, dtype=np.uint8).copy()


def parse_fastq_bytes(data: bytes | np.ndarray) -> FastqData:
    if isinstance(data, (bytes, bytearray)):
        buf = np.frombuffer(bytes(data), dtype=np.uint8).copy()
    else:
        buf = np.asarray(data, dtype=np.uint8)
    if buf.size and buf[-1] != _NL:
        buf = np.concatenate([buf, np.array([_NL], dtype=np.uint8)])

    # native memchr-based scanner when built (handles the same layout)
    from . import native_lib
    try:
        idx = native_lib.fastq_index(buf)
    except ValueError as e:
        raise ValueError(f"FASTQ parse error: {e}") from e
    if idx is not None:
        return FastqData(
            buf=buf,
            name_starts=idx[:, 0], name_ends=idx[:, 1],
            seq_starts=idx[:, 2], seq_ends=idx[:, 3],
            qual_starts=idx[:, 6], qual_ends=idx[:, 7],
        )
    nl = np.flatnonzero(buf == _NL)
    if nl.size % 4 != 0:
        raise ValueError(
            f"FASTQ parse error: {nl.size} lines is not a multiple of 4")
    n = nl.size // 4
    line_starts = np.concatenate([[0], nl[:-1] + 1]) if nl.size else nl
    line_ends = nl  # exclusive of newline
    ls = line_starts.reshape(n, 4) if n else line_starts.reshape(0, 4)
    le = line_ends.reshape(n, 4) if n else line_ends.reshape(0, 4)
    if n and not (buf[ls[:, 0]] == ord("@")).all():
        bad = int(np.flatnonzero(buf[ls[:, 0]] != ord("@"))[0])
        raise ValueError(f"FASTQ record {bad}: header does not start with '@'")
    if n and not ((le[:, 1] - ls[:, 1]) == (le[:, 3] - ls[:, 3])).all():
        bad = int(np.flatnonzero(
            (le[:, 1] - ls[:, 1]) != (le[:, 3] - ls[:, 3]))[0])
        raise ValueError(f"FASTQ record {bad}: seq/qual length mismatch")
    return FastqData(
        buf=buf,
        name_starts=ls[:, 0] + 1, name_ends=le[:, 0],
        seq_starts=ls[:, 1], seq_ends=le[:, 1],
        qual_starts=ls[:, 3], qual_ends=le[:, 3],
    )


def read_fastq(path: str) -> FastqData:
    return parse_fastq_bytes(_load_bytes(path))


def extract_padded_arrays(fq: FastqData, max_len: int | None = None):
    """Fixed-shape [N, Lmax] (codes int8, quals int8, mask bool) arrays.

    Vectorized: one fancy-gather per field using offset arithmetic; padding
    is code BASE_N / qual 0 / mask False.
    """
    n = fq.num_reads
    lens = fq.lengths.astype(np.int64)
    L = int(max_len or (lens.max() if n else 1) or 1)
    if n == 0:
        return (np.zeros((0, L), np.int8), np.zeros((0, L), np.int8),
                np.zeros((0, L), bool), lens)
    if int(lens.max(initial=0)) > L:
        raise ValueError(f"read length {int(lens.max())} exceeds max_len {L}")
    # native one-pass LUT decode (threads): the numpy path below
    # materializes two [N, L] int64 index arrays per chunk (~70 ns/base
    # measured; the hugepage fault storm of KNOWN_ISSUES #2 rides on
    # those fresh temporaries) — the C loop is ~2 ns/base
    from . import native_lib
    from ..utils.mem import hugepage_empty
    codes = hugepage_empty((n, L), np.int8)
    quals = hugepage_empty((n, L), np.int8)
    mask = hugepage_empty((n, L), np.uint8)
    if native_lib.fastq_extract(fq.buf, fq.seq_starts, fq.qual_starts,
                                lens, L, _ENCODE_LUT, codes, quals, mask):
        return codes, quals, mask.view(bool), lens
    pos = np.arange(L, dtype=np.int64)[None, :]
    mask = pos < lens[:, None]
    seq_idx = np.minimum(fq.seq_starts[:, None] + pos, fq.buf.size - 1)
    qual_idx = np.minimum(fq.qual_starts[:, None] + pos, fq.buf.size - 1)
    codes = _ENCODE_LUT[fq.buf[seq_idx]]
    codes = np.where(mask, codes, np.int8(4))
    quals = (fq.buf[qual_idx].astype(np.int16) - PHRED_OFFSET)
    quals = np.where(mask, np.clip(quals, 0, 93), 0).astype(np.int8)
    return codes, quals, mask, lens


def is_gz_path(p) -> bool:
    """True for a path-like sink named *.gz — those outputs must be
    compressed, never plain bytes under a .gz name (SURVEY.md C7: the
    reference writes through htslib/BGZF; round-4 VERDICT missing #3)."""
    import os
    if isinstance(p, os.PathLike):
        p = os.fspath(p)
    if isinstance(p, bytes):
        return p.endswith(b".gz")
    return isinstance(p, str) and p.endswith(".gz")


class GzipFastqSink:
    """File-like sink that BGZF-compresses everything written through
    the multithreaded native deflate.  BGZF is standard multi-member
    gzip, so `gzip.open`/zcat read the output directly."""

    def __init__(self, path, level: int | None = None):
        from .bam_stream import BGZFStreamWriter
        self.f = open(path, "wb")
        self.w = BGZFStreamWriter(self.f, level)

    def write(self, data) -> None:
        self.w.write(bytes(data))

    def flush(self) -> None:
        pass                      # buffered until close by design

    def close(self) -> None:
        self.w.close()
        self.f.close()


def open_fastq_sink(path):
    """Open a FASTQ output path: BGZF-compressing sink for *.gz names,
    plain binary file otherwise."""
    return GzipFastqSink(path) if is_gz_path(path) else open(path, "wb")


def _write_out(buf: bytes, path_or_file) -> None:
    import os
    if isinstance(path_or_file, os.PathLike):
        path_or_file = os.fspath(path_or_file)
    if isinstance(path_or_file, (str, bytes)):
        if is_gz_path(path_or_file):
            # same level as the streamed GzipFastqSink so the in-RAM
            # and streamed engines stay BYTE-identical on .gz sinks
            from . import bgzf
            from .bam_stream import DEFAULT_COMPRESS_LEVEL
            with open(path_or_file, "wb") as f:
                f.write(bgzf.compress(buf, DEFAULT_COMPRESS_LEVEL))
            return
        with open(path_or_file, "wb") as f:
            f.write(buf)
    else:
        path_or_file.write(buf)


def render_fastq_with_quals(fq: FastqData, new_quals: np.ndarray,
                            mask: np.ndarray) -> bytes:
    """The input FASTQ bytes with quality lines replaced (only-quals-
    change invariant) — the render half of write_fastq_with_quals, so
    pass-4 pipelines can run renders in parallel and keep sink writes
    ordered."""
    out = fq.buf.copy()
    n = fq.num_reads
    if n:
        L = new_quals.shape[1]
        mask = np.asarray(mask)
        # native row-copy write-back when every mask row is a prefix
        # (always true for extract_padded_arrays masks); the generic
        # numpy scatter below handles arbitrary masks
        from . import native_lib
        prefix = not (~mask[:, :-1] & mask[:, 1:]).any() if L > 1 else True
        if prefix:
            lens = mask.sum(axis=1).astype(np.int64)
            nq = np.asarray(new_quals, np.int8)
            if native_lib.fastq_write_quals(out, fq.qual_starts, lens, nq):
                return out.tobytes()
        pos = np.arange(L, dtype=np.int64)[None, :]
        idx = fq.qual_starts[:, None] + pos
        flat_idx = idx[mask]
        flat_q = (np.asarray(new_quals)[mask].astype(np.int64) + PHRED_OFFSET)
        out[flat_idx] = flat_q.astype(np.uint8)
    return out.tobytes()


def write_fastq_with_quals(fq: FastqData, new_quals: np.ndarray,
                           mask: np.ndarray, path_or_file) -> None:
    """Write the input FASTQ with quality lines replaced.  new_quals:
    int [N, Lmax] phred values; mask: bool [N, Lmax].  A *.gz output
    path is BGZF-compressed (gzip-readable)."""
    _write_out(render_fastq_with_quals(fq, new_quals, mask),
               path_or_file)
