"""ctypes bindings for the native IO codec (libkbbq_io.so).

Falls back to None if the library isn't built; callers (bgzf.py,
fastq.py) gracefully use the pure-Python/NumPy paths.  Build with
`make -C kbbq_tpu/io/native` (done automatically on first import when a
compiler is present).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "native")
_SO = os.path.join(_DIR, "libkbbq_io.so")
_lib = None
_tried = False


def _build() -> bool:
    try:
        r = subprocess.run(["make", "-C", _DIR], capture_output=True,
                           timeout=120)
        return r.returncode == 0 and os.path.exists(_SO)
    except Exception:
        return False


def _stale() -> bool:
    """True when the source is newer than the built library (a stale .so
    silently shadowing edited source was an ADVICE.md round-1 finding)."""
    try:
        so_m = os.path.getmtime(_SO)
        return any(os.path.getmtime(os.path.join(_DIR, f)) > so_m
                   for f in os.listdir(_DIR)
                   if f.endswith((".cc", ".h", ".hpp")) or f == "Makefile")
    except OSError:
        return True


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if (not os.path.exists(_SO) or _stale()) and not _build():
        if not os.path.exists(_SO):
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.kbbq_bgzf_size.restype = ctypes.c_int64
    lib.kbbq_bgzf_size.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.kbbq_bgzf_decompress.restype = ctypes.c_int32
    lib.kbbq_bgzf_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_int32]
    lib.kbbq_bgzf_compress.restype = ctypes.c_int64
    lib.kbbq_bgzf_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_size_t, ctypes.c_int32, ctypes.c_int32]
    lib.kbbq_fastq_index.restype = ctypes.c_int64
    lib.kbbq_fastq_index.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t]
    lib.kbbq_apply_recal.restype = None
    lib.kbbq_apply_recal.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32]
    lib.kbbq_byte_hist.restype = None
    lib.kbbq_byte_hist.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32]
    lib.kbbq_accum_cov.restype = None
    lib.kbbq_accum_cov.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
    for fn in (lib.kbbq_pack_lut2, lib.kbbq_pack_lut4):
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
    lib.kbbq_fastq_extract.restype = None
    lib.kbbq_fastq_extract.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
    lib.kbbq_fastq_write_quals.restype = None
    lib.kbbq_fastq_write_quals.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.kbbq_bam_offsets.restype = ctypes.c_int64
    lib.kbbq_bam_offsets.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.kbbq_rans_uncompress.restype = ctypes.c_int32
    lib.kbbq_rans_uncompress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.kbbq_rans_compress.restype = ctypes.c_int64
    lib.kbbq_rans_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int64]
    lib.kbbq_bam_decode.restype = None
    lib.kbbq_bam_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]
    _lib = lib
    return _lib


def byte_hist(arr: "np.ndarray") -> "np.ndarray | None":
    """Threaded 256-bin byte histogram of a contiguous array (palette
    detection off the GIL); None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr).view(np.uint8)
    out = np.zeros(256, np.int64)
    lib.kbbq_byte_hist(a.ctypes.data, a.size, out.ctypes.data,
                       default_threads())
    return out


def pack_lut(arr: "np.ndarray", lut: "np.ndarray",
             bits: int) -> "np.ndarray | None":
    """Fused LUT + plane pack of a [N, L] byte array (2- or 4-bit
    palette indices; layout of pipeline/resident.py::_pack_quarters on
    the LUT-mapped array).  None when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr).view(np.uint8)
    n, L = a.shape
    lut8 = np.ascontiguousarray(lut, dtype=np.uint8)
    assert lut8.size == 256
    if bits == 2:
        out = np.empty((n, (L + 3) // 4), np.uint8)
        lib.kbbq_pack_lut2(a.ctypes.data, n, L, lut8.ctypes.data,
                           out.ctypes.data, default_threads())
    else:
        assert bits == 4
        out = np.empty((n, (L + 1) // 2), np.uint8)
        lib.kbbq_pack_lut4(a.ctypes.data, n, L, lut8.ctypes.data,
                           out.ctypes.data, default_threads())
    return out


def default_threads() -> int:
    return max(1, (os.cpu_count() or 2) - 1)


def bgzf_decompress(data: bytes) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    size = lib.kbbq_bgzf_size(data, len(data))
    if size < 0:
        raise ValueError("native BGZF scan failed")
    out = np.empty(size, dtype=np.uint8)
    rc = lib.kbbq_bgzf_decompress(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), size,
        default_threads())
    if rc != 0:
        raise ValueError(f"native BGZF decompress failed (code {rc})")
    return out.tobytes()


def bgzf_compress(data: bytes, level: int = 6) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    cap = len(data) + (len(data) // 0xFF00 + 2) * 64 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.kbbq_bgzf_compress(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap,
        level, default_threads())
    if n < 0:
        raise ValueError(f"native BGZF compress failed ({n})")
    return out[:n].tobytes()


def apply_recal(recal, codes, quals, mask, rgs, seconds,
                min_usable_q: int, dinuc_invalid: int):
    """Native pass-4 gather -> int8 [N, L], or None if no native lib.

    Twin of ops/recal.py::apply_recal_table_host's NumPy body (which is
    itself the host twin of the device kernel); bit-identical, one fused
    pass instead of ~10 full-array temporaries.
    """
    lib = get_lib()
    if lib is None:
        return None
    trace = os.environ.get("KBBQ_P4_TRACE")
    if trace:
        import resource
        import sys
        import time as _t
        ru0 = resource.getrusage(resource.RUSAGE_SELF)
        t0 = _t.time()
    from ..utils.mem import hugepage_empty
    recal = np.ascontiguousarray(recal, dtype=np.int8)
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    quals = np.ascontiguousarray(quals, dtype=np.int8)
    # bool and uint8 share representation: view, don't astype-copy a
    # [N, L] array (fresh 60 MB first-touch is the pathology of
    # KNOWN_ISSUES #2)
    if mask.dtype == np.bool_ and mask.flags.c_contiguous:
        mask = mask.view(np.uint8)
    else:
        mask = np.ascontiguousarray(mask, dtype=np.uint8)
    rgs = np.ascontiguousarray(rgs, dtype=np.int32)
    seconds = np.ascontiguousarray(seconds, dtype=np.uint8)
    N, L = codes.shape
    nrg, nq, nc, nd = recal.shape
    out = hugepage_empty((N, L), np.int8)
    if trace:
        t1 = _t.time()
    cp = ctypes.c_void_p
    lib.kbbq_apply_recal(
        recal.ctypes.data_as(cp), nrg, nq, nc, nd,
        codes.ctypes.data_as(cp), quals.ctypes.data_as(cp),
        mask.ctypes.data_as(cp), rgs.ctypes.data_as(cp),
        seconds.ctypes.data_as(cp), N, L, min_usable_q, dinuc_invalid,
        out.ctypes.data_as(cp), os.cpu_count() or 1)
    if trace:
        t2 = _t.time()
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        print(f"[p4-native] conv+alloc {t1-t0:.3f}s call {t2-t1:.3f}s "
              f"minflt {ru1.ru_minflt-ru0.ru_minflt} "
              f"majflt {ru1.ru_majflt-ru0.ru_majflt} "
              f"usr {ru1.ru_utime-ru0.ru_utime:.2f} "
              f"sys {ru1.ru_stime-ru0.ru_stime:.2f}",
              file=sys.stderr, flush=True)
    return out


def accum_cov(codes, quals, mask, rgs, seconds, err_idx, tables,
              min_usable_q: int) -> bool:
    """Threaded host covariate accumulation over sparse error indices
    into the int64 `tables` (an oracle.covariate.CovariateTables, added
    in place).  Twin of ops/covariate.py::accumulate_covariates; False
    when the native lib is unavailable (callers use the NumPy twin in
    ops/covariate_host.py)."""
    lib = get_lib()
    if lib is None:
        return False
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    N, L = codes.shape
    if N * L >= 2**32:  # uint32 flat-index ABI; NumPy twin takes int64
        return False
    quals = np.ascontiguousarray(quals, dtype=np.int8)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    rgs = np.ascontiguousarray(rgs, dtype=np.int32)
    seconds = np.ascontiguousarray(seconds, dtype=np.uint8)
    err_idx = np.ascontiguousarray(err_idx, dtype=np.uint32)
    nrg, nq, nc = tables.cyc_total.shape
    nd = tables.din_total.shape[2]
    for t in (tables.cyc_total, tables.cyc_errors, tables.din_total,
              tables.din_errors):
        assert t.dtype == np.int64 and t.flags.c_contiguous
    cp = ctypes.c_void_p
    lib.kbbq_accum_cov(
        codes.ctypes.data_as(cp), quals.ctypes.data_as(cp),
        mask.ctypes.data_as(cp), rgs.ctypes.data_as(cp),
        seconds.ctypes.data_as(cp), err_idx.ctypes.data_as(cp),
        err_idx.size, N, L, nrg, nq, nc, nd, min_usable_q,
        tables.cyc_total.ctypes.data_as(cp),
        tables.cyc_errors.ctypes.data_as(cp),
        tables.din_total.ctypes.data_as(cp),
        tables.din_errors.ctypes.data_as(cp), os.cpu_count() or 1)
    return True


def fastq_extract(buf: np.ndarray, seq_starts, qual_starts, lens,
                  stride: int, enc_lut: np.ndarray,
                  codes: np.ndarray, quals: np.ndarray,
                  mask: np.ndarray) -> bool:
    """Padded-array FASTQ decode (codes/quals/mask written in place);
    False if no native lib."""
    lib = get_lib()
    if lib is None:
        return False
    import os
    cp = ctypes.c_void_p
    ss = np.ascontiguousarray(seq_starts, np.int64)
    qs = np.ascontiguousarray(qual_starts, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    lut = np.ascontiguousarray(enc_lut, np.int8)
    assert codes.flags.c_contiguous and quals.flags.c_contiguous
    assert mask.flags.c_contiguous
    lib.kbbq_fastq_extract(
        buf.ctypes.data_as(cp), ss.ctypes.data_as(cp),
        qs.ctypes.data_as(cp), ln.ctypes.data_as(cp), ss.size,
        int(stride), lut.ctypes.data_as(cp), codes.ctypes.data_as(cp),
        quals.ctypes.data_as(cp), mask.ctypes.data_as(cp),
        os.cpu_count() or 1)
    return True


def fastq_write_quals(out: np.ndarray, qual_starts, lens,
                      new_quals: np.ndarray) -> bool:
    """Overwrite FASTQ quality bytes in `out` from padded int8 phreds;
    False if no native lib."""
    lib = get_lib()
    if lib is None:
        return False
    import os
    cp = ctypes.c_void_p
    qs = np.ascontiguousarray(qual_starts, np.int64)
    ln = np.ascontiguousarray(lens, np.int64)
    q = np.ascontiguousarray(new_quals, np.int8)
    lib.kbbq_fastq_write_quals(
        out.ctypes.data_as(cp), qs.ctypes.data_as(cp),
        ln.ctypes.data_as(cp), q.ctypes.data_as(cp), qs.size,
        q.shape[1], os.cpu_count() or 1)
    return True


def bam_offsets(buf, start: int = 0):
    """Scan complete BAM records in buf[start:]: (offs, sizes, end) of
    int64 body offsets/sizes and the offset past the last complete
    record, or None if no native lib.  Raises on a malformed size."""
    lib = get_lib()
    if lib is None:
        return None
    arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
        else buf
    n = arr.size
    cap = max(1, (n - start) // 36 + 8)
    offs = np.empty(cap, np.int64)
    sizes = np.empty(cap, np.int64)
    end = ctypes.c_int64(0)
    cp = ctypes.c_void_p
    cnt = lib.kbbq_bam_offsets(
        arr.ctypes.data_as(cp), n, start, offs.ctypes.data_as(cp),
        sizes.ctypes.data_as(cp), cap, ctypes.byref(end))
    if cnt < 0:
        raise ValueError("native BAM scan: malformed record size")
    return offs[:cnt], sizes[:cnt], int(end.value)


def bam_decode(buf: np.ndarray, seq_off: np.ndarray, qual_off: np.ndarray,
               rev: np.ndarray, L: int, oq_mode: bool,
               out_codes: np.ndarray, out_quals: np.ndarray) -> bool:
    """Machine-order group decode of same-length records; False if no
    native lib.  out_codes/out_quals are int8 [n, stride] with the first
    L columns written."""
    lib = get_lib()
    if lib is None:
        return False
    import os
    cp = ctypes.c_void_p
    assert out_codes.dtype == np.int8 and out_codes.flags.c_contiguous
    assert out_quals.dtype == np.int8 and out_quals.flags.c_contiguous
    so = np.ascontiguousarray(seq_off, np.int64)
    qo = np.ascontiguousarray(qual_off, np.int64)
    rv = np.ascontiguousarray(rev, np.uint8)
    lib.kbbq_bam_decode(
        buf.ctypes.data_as(cp), so.ctypes.data_as(cp),
        qo.ctypes.data_as(cp), rv.ctypes.data_as(cp),
        so.size, int(L), 1 if oq_mode else 0,
        out_codes.ctypes.data_as(cp), out_quals.ctypes.data_as(cp),
        out_codes.shape[1], os.cpu_count() or 1)
    return True


def fastq_index(buf: np.ndarray):
    """-> int64 [N, 8] record offsets, or None if no native lib."""
    lib = get_lib()
    if lib is None:
        return None
    data = buf.tobytes() if isinstance(buf, np.ndarray) else bytes(buf)
    n = lib.kbbq_fastq_index(data, len(data), None, 0)
    if n < 0:
        raise ValueError("native FASTQ scan: malformed input")
    out = np.empty((int(n), 8), dtype=np.int64)
    n2 = lib.kbbq_fastq_index(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), int(n))
    assert n2 == n
    return out


def rans_uncompress(blob: bytes, n_out: int) -> bytes | None:
    """Native rANS 4x8 decode (order from the blob header); None when
    the library is unavailable (callers fall back to the NumPy twin)."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np
    out = np.empty(n_out, np.uint8)
    rc = lib.kbbq_rans_uncompress(bytes(blob), len(blob),
                                  out.ctypes.data, n_out)
    if rc != 0:
        raise ValueError(f"rANS: malformed blob (native rc={rc})")
    return out.tobytes()


def rans_compress(data: bytes, order: int) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np
    n = len(data)
    cap = n + (n >> 4) + (1 << 20)
    out = np.empty(cap, np.uint8)
    sz = lib.kbbq_rans_compress(bytes(data), n, order,
                                out.ctypes.data, cap)
    if sz < 0:
        raise ValueError(f"rANS: compress failed (native rc={sz})")
    return out[:sz].tobytes()
