// kbbq-tpu native IO codec: multithreaded BGZF + FASTQ scanning.
//
// Reference analog: htslib's bgzf.c / kseq (SURVEY.md §3.1 C7).  The
// reference links htslib; this is our own host-side implementation
// (no htslib in this environment, SURVEY.md H7).  Exposed as a C ABI for
// ctypes (no pybind11 in this environment).
//
// Build: make -C kbbq_tpu/io/native   ->  libkbbq_io.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------- BGZF

struct BgzfBlock {
  size_t in_off;     // offset of compressed payload
  size_t in_len;     // compressed payload length
  size_t out_off;    // offset in decompressed stream
  uint32_t isize;    // uncompressed size
  uint32_t crc;
};

// Scan BGZF blocks. Returns number of blocks, or -1 on parse error.
// Fills per-block arrays (caller allocates to capacity cap).
static int64_t scan_blocks(const uint8_t* in, size_t n,
                           std::vector<BgzfBlock>& blocks,
                           size_t* total_out) {
  static const uint8_t EOF_MARKER[28] = {
      0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00,
      0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0, 0, 0, 0, 0,
      0, 0, 0, 0};
  size_t off = 0, out = 0;
  while (off < n) {
    if (n - off >= 28 && memcmp(in + off, EOF_MARKER, 28) == 0) {
      off += 28;
      continue;
    }
    if (n - off < 18) return -1;
    if (in[off] != 31 || in[off + 1] != 139 || in[off + 2] != 8 ||
        !(in[off + 3] & 4))
      return -1;
    uint16_t xlen;
    memcpy(&xlen, in + off + 10, 2);
    size_t xoff = off + 12, xend = xoff + xlen;
    int64_t bsize = -1;
    while (xoff + 4 <= xend) {
      uint8_t si1 = in[xoff], si2 = in[xoff + 1];
      uint16_t slen;
      memcpy(&slen, in + xoff + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, in + xoff + 4, 2);
        bsize = (int64_t)bs + 1;
      }
      xoff += 4 + slen;
    }
    if (bsize < 0 || off + (size_t)bsize > n) return -1;
    BgzfBlock b;
    b.in_off = off + 12 + xlen;
    b.in_len = (size_t)bsize - 12 - xlen - 8;
    memcpy(&b.crc, in + off + bsize - 8, 4);
    memcpy(&b.isize, in + off + bsize - 4, 4);
    b.out_off = out;
    out += b.isize;
    blocks.push_back(b);
    off += bsize;
  }
  *total_out = out;
  return (int64_t)blocks.size();
}

// Pass 1: report decompressed size (-1 = error).
int64_t kbbq_bgzf_size(const uint8_t* in, size_t n) {
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (scan_blocks(in, n, blocks, &total) < 0) return -1;
  return (int64_t)total;
}

// Pass 2: decompress all blocks into out (must be kbbq_bgzf_size bytes).
// Returns 0 on success.
int32_t kbbq_bgzf_decompress(const uint8_t* in, size_t n, uint8_t* out,
                             size_t out_len, int32_t nthreads) {
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (scan_blocks(in, n, blocks, &total) < 0 || total != out_len) return -1;
  if (nthreads < 1) nthreads = 1;
  std::vector<int32_t> errs(nthreads, 0);
  auto work = [&](int t) {
    for (size_t i = t; i < blocks.size(); i += nthreads) {
      const BgzfBlock& b = blocks[i];
      z_stream zs;
      memset(&zs, 0, sizeof zs);
      if (inflateInit2(&zs, -15) != Z_OK) { errs[t] = 1; return; }
      zs.next_in = const_cast<Bytef*>(in + b.in_off);
      zs.avail_in = (uInt)b.in_len;
      zs.next_out = out + b.out_off;
      zs.avail_out = b.isize;
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END && !(r == Z_OK && b.isize == 0) &&
          !(r == Z_BUF_ERROR && b.isize == 0)) { errs[t] = 2; return; }
      if (crc32(0, out + b.out_off, b.isize) != b.crc) { errs[t] = 3; return; }
    }
  };
  std::vector<std::thread> ths;
  for (int t = 0; t < nthreads; t++) ths.emplace_back(work, t);
  for (auto& th : ths) th.join();
  for (int e : errs) if (e) return e;
  return 0;
}

// Compress into BGZF blocks (+ EOF). Caller provides out buffer of
// capacity out_cap; returns bytes written or -1 if out of space.
int64_t kbbq_bgzf_compress(const uint8_t* in, size_t n, uint8_t* out,
                           size_t out_cap, int32_t level,
                           int32_t nthreads) {
  const size_t CHUNK = 0xff00;
  size_t nblocks = (n + CHUNK - 1) / CHUNK;
  if (nblocks == 0) nblocks = 0;
  if (nthreads < 1) nthreads = 1;

  std::vector<std::vector<uint8_t>> outs(nblocks);
  std::vector<int32_t> errs(nthreads, 0);
  auto work = [&](int t) {
    for (size_t i = t; i < nblocks; i += nthreads) {
      size_t s = i * CHUNK;
      size_t len = (s + CHUNK <= n) ? CHUNK : n - s;
      uint8_t cbuf[0x11000];
      z_stream zs;
      memset(&zs, 0, sizeof zs);
      if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                       Z_DEFAULT_STRATEGY) != Z_OK) { errs[t] = 1; return; }
      zs.next_in = const_cast<Bytef*>(in + s);
      zs.avail_in = (uInt)len;
      zs.next_out = cbuf;
      zs.avail_out = sizeof cbuf;
      int r = deflate(&zs, Z_FINISH);
      size_t clen = sizeof cbuf - zs.avail_out;
      deflateEnd(&zs);
      if (r != Z_STREAM_END) { errs[t] = 2; return; }
      size_t bsize = clen + 12 + 6 + 8;
      std::vector<uint8_t>& o = outs[i];
      o.resize(bsize);
      uint8_t hdr[18] = {31, 139, 8, 4, 0, 0, 0, 0, 0, 255, 6, 0,
                         66, 67, 2, 0, 0, 0};
      uint16_t bs16 = (uint16_t)(bsize - 1);
      memcpy(hdr + 16, &bs16, 2);
      memcpy(o.data(), hdr, 18);
      memcpy(o.data() + 18, cbuf, clen);
      uint32_t crc = crc32(0, in + s, (uInt)len);
      uint32_t il = (uint32_t)len;
      memcpy(o.data() + 18 + clen, &crc, 4);
      memcpy(o.data() + 18 + clen + 4, &il, 4);
    }
  };
  std::vector<std::thread> ths;
  for (int t = 0; t < nthreads; t++) ths.emplace_back(work, t);
  for (auto& th : ths) th.join();
  for (int e : errs) if (e) return -2;

  static const uint8_t EOF_MARKER[28] = {
      0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00,
      0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0, 0, 0, 0, 0,
      0, 0, 0, 0};
  size_t pos = 0;
  for (auto& o : outs) {
    if (pos + o.size() > out_cap) return -1;
    memcpy(out + pos, o.data(), o.size());
    pos += o.size();
  }
  if (pos + 28 > out_cap) return -1;
  memcpy(out + pos, EOF_MARKER, 28);
  return (int64_t)(pos + 28);
}

// --------------------------------------------------------------- FASTQ

// Scan a FASTQ buffer for record line offsets.  Writes 8 int64 per
// record: name_start, name_end, seq_start, seq_end, plus_start(unused=0),
// 0, qual_start, qual_end.  Returns record count, or -1-errpos on error.
int64_t kbbq_fastq_index(const uint8_t* buf, size_t n, int64_t* out,
                         size_t cap_records) {
  size_t off = 0;
  int64_t nrec = 0;
  while (off < n) {
    if (buf[off] != '@') return -1;
    const uint8_t* p1 = (const uint8_t*)memchr(buf + off, '\n', n - off);
    if (!p1) return -1;
    size_t name_s = off + 1, name_e = p1 - buf;
    size_t seq_s = name_e + 1;
    const uint8_t* p2 = (const uint8_t*)memchr(buf + seq_s, '\n', n - seq_s);
    if (!p2) return -1;
    size_t seq_e = p2 - buf;
    size_t plus_s = seq_e + 1;
    if (plus_s >= n || buf[plus_s] != '+') return -1;
    const uint8_t* p3 = (const uint8_t*)memchr(buf + plus_s, '\n',
                                               n - plus_s);
    if (!p3) return -1;
    size_t qual_s = (p3 - buf) + 1;
    if (qual_s >= n) return -1;
    const uint8_t* p4 = (const uint8_t*)memchr(buf + qual_s, '\n',
                                               n - qual_s);
    size_t qual_e = p4 ? (size_t)(p4 - buf) : n;
    if (qual_e - qual_s != seq_e - seq_s) return -1;
    if ((size_t)nrec < cap_records) {
      int64_t* r = out + nrec * 8;
      r[0] = (int64_t)name_s; r[1] = (int64_t)name_e;
      r[2] = (int64_t)seq_s;  r[3] = (int64_t)seq_e;
      r[4] = 0;               r[5] = 0;
      r[6] = (int64_t)qual_s; r[7] = (int64_t)qual_e;
    }
    nrec++;
    off = qual_e + 1;
  }
  return nrec;
}

// ------------------------------------------------------- pass-4 recal
//
// Per-base recalibrated-quality gather (reference analog: the per-read
// qual rewrite in pub:src/kbbq/recalibrateutils.cc pass 4).  The device
// twin is ops/recal.py::apply_recal_table; the resident pipeline runs
// pass 4 on the host to avoid shipping [N, L] qualities back through the
// device link, and this native kernel replaces the NumPy fallback's ~10
// full-array temporaries with one fused pass (bit-identical by
// construction: all-integer math).
//
// recal: int8 [nrg, nq, nc, nd]; codes/quals int8 [N, L]; mask uint8
// [N, L]; rgs int32 [N]; seconds uint8 [N]; out int8 [N, L].
// min_usable_q / dinuc_invalid passed in so constants.py stays the
// single source of truth.
void kbbq_apply_recal(const int8_t* recal, int32_t nrg, int32_t nq,
                      int32_t nc, int32_t nd, const int8_t* codes,
                      const int8_t* quals, const uint8_t* mask,
                      const int32_t* rgs, const uint8_t* seconds,
                      int64_t N, int64_t L, int32_t min_usable_q,
                      int32_t dinuc_invalid, int8_t* out,
                      int32_t threads) {
  (void)nrg;
  if (threads < 1) threads = 1;
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; i++) {
      const int8_t* c = codes + i * L;
      const int8_t* q = quals + i * L;
      const uint8_t* m = mask + i * L;
      int8_t* o = out + i * L;
      int32_t sec = seconds[i] ? 1 : 0;
      const int8_t* tab_rg = recal + (int64_t)rgs[i] * nq * nc * nd;
      int32_t prev = 4;
      for (int64_t j = 0; j < L; j++) {
        int32_t cj = c[j], q0 = q[j];
        if (!m[j] || cj == 4 || q0 < min_usable_q) {
          o[j] = (int8_t)q0;
          prev = cj;
          continue;
        }
        int32_t qc = q0 < 0 ? 0 : (q0 > nq - 1 ? nq - 1 : q0);
        int32_t cyc = (int32_t)(j * 2) + sec;
        int32_t din = (j > 0 && prev != 4 && cj != 4) ? prev * 4 + cj
                                                      : dinuc_invalid;
        o[j] = tab_rg[((int64_t)qc * nc + cyc) * nd + din];
        prev = cj;
      }
    }
  };
  if (threads == 1 || N < 4096) {
    work(0, N);
    return;
  }
  std::vector<std::thread> pool;
  int64_t step = (N + threads - 1) / threads;
  for (int32_t t = 0; t < threads; t++) {
    int64_t r0 = t * step, r1 = r0 + step > N ? N : r0 + step;
    if (r0 >= r1) break;
    pool.emplace_back(work, r0, r1);
  }
  for (auto& th : pool) th.join();
}

// ------------------------------------------------- host->device packers
//
// The device-resident pipeline ships 2-bit/4-bit palette indices instead
// of raw bytes (pipeline/resident.py).  The numpy version of this pack
// (LUT fancy-index + four shifted slices) costs ~1 s over 60 MB and runs
// under the GIL, where it contends with the dispatch threads.  One fused
// multithreaded pass at memory bandwidth instead.

// 256-entry byte histogram (palette detection), threaded.
void kbbq_byte_hist(const uint8_t* in, int64_t n, int64_t* out,
                    int32_t threads) {
  if (threads < 1) threads = 1;
  std::vector<std::vector<int64_t>> part(threads,
                                         std::vector<int64_t>(256, 0));
  auto work = [&](int32_t t, int64_t r0, int64_t r1) {
    auto& h = part[t];
    for (int64_t i = r0; i < r1; i++) h[in[i]]++;
  };
  std::vector<std::thread> pool;
  int64_t step = (n + threads - 1) / threads;
  for (int32_t t = 0; t < threads; t++) {
    int64_t r0 = t * step, r1 = r0 + step > n ? n : r0 + step;
    if (r0 >= r1) break;
    pool.emplace_back(work, t, r0, r1);
  }
  for (auto& th : pool) th.join();
  for (int v = 0; v < 256; v++) {
    int64_t s = 0;
    for (auto& h : part) s += h[v];
    out[v] = s;
  }
}

// Fused LUT + quarter-plane 2-bit pack: out[i, j] = lut[in[i, j]]
//                                               | lut[in[i, j+Lq]] << 2
//                                               | lut[in[i, j+2Lq]] << 4
//                                               | lut[in[i, j+3Lq]] << 6
// where Lq = ceil(L/4) and columns past L read as 0 (same layout as
// pipeline/resident.py::_pack_quarters on the LUT-mapped array).
void kbbq_pack_lut2(const uint8_t* in, int64_t nrows, int64_t L,
                    const uint8_t* lut, uint8_t* out, int32_t threads) {
  if (threads < 1) threads = 1;
  int64_t Lq = (L + 3) / 4;
  auto get = [&](const uint8_t* row, int64_t j) -> uint8_t {
    return j < L ? lut[row[j]] : 0;
  };
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; i++) {
      const uint8_t* row = in + i * L;
      uint8_t* o = out + i * Lq;
      for (int64_t j = 0; j < Lq; j++)
        o[j] = (uint8_t)(get(row, j) | (get(row, j + Lq) << 2) |
                         (get(row, j + 2 * Lq) << 4) |
                         (get(row, j + 3 * Lq) << 6));
    }
  };
  if (threads == 1 || nrows < 4096) {
    work(0, nrows);
    return;
  }
  std::vector<std::thread> pool;
  int64_t step = (nrows + threads - 1) / threads;
  for (int32_t t = 0; t < threads; t++) {
    int64_t r0 = t * step, r1 = r0 + step > nrows ? nrows : r0 + step;
    if (r0 >= r1) break;
    pool.emplace_back(work, r0, r1);
  }
  for (auto& th : pool) th.join();
}

// Fused LUT + half-plane 4-bit pack: out[i, j] = lut[in[i, j]]
//                                            | lut[in[i, j+Lh]] << 4,
// Lh = ceil(L/2); columns past L read as 0.
void kbbq_pack_lut4(const uint8_t* in, int64_t nrows, int64_t L,
                    const uint8_t* lut, uint8_t* out, int32_t threads) {
  if (threads < 1) threads = 1;
  int64_t Lh = (L + 1) / 2;
  auto get = [&](const uint8_t* row, int64_t j) -> uint8_t {
    return j < L ? lut[row[j]] : 0;
  };
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t i = r0; i < r1; i++) {
      const uint8_t* row = in + i * L;
      uint8_t* o = out + i * Lh;
      for (int64_t j = 0; j < Lh; j++)
        o[j] = (uint8_t)(get(row, j) | (get(row, j + Lh) << 4));
    }
  };
  if (threads == 1 || nrows < 4096) {
    work(0, nrows);
    return;
  }
  std::vector<std::thread> pool;
  int64_t step = (nrows + threads - 1) / threads;
  for (int32_t t = 0; t < threads; t++) {
    int64_t r0 = t * step, r1 = r0 + step > nrows ? nrows : r0 + step;
    if (r0 >= r1) break;
    pool.emplace_back(work, r0, r1);
  }
  for (auto& th : pool) th.join();
}

// ------------------------------------------------ host covariate accum
//
// Pass-3 accumulate twin of ops/covariate.py::accumulate_covariates,
// run on the HOST over sparse device error indices so the [N, L]
// reported-quality array never crosses the device link at all (it would
// be the largest host->device transfer of the resident pipeline).
// All-integer +1 counts in int64: bit-identical to the device one-hot
// histogram under any order/threading (adds commute; SURVEY.md H5).
//
// err_idx: sorted unique flat indices i*L + j of walk-marked bases
// (n_err of them); tables are int64 [nrg, nq, nc] (cyc) and
// [nrg, nq, nd] (dinuc), zeroed by the caller.
void kbbq_accum_cov(const int8_t* codes, const int8_t* quals,
                    const uint8_t* mask, const int32_t* rgs,
                    const uint8_t* seconds, const uint32_t* err_idx,
                    int64_t n_err, int64_t N, int64_t L, int32_t nrg,
                    int32_t nq, int32_t nc, int32_t nd,
                    int32_t min_usable_q, int64_t* cyc_total,
                    int64_t* cyc_errors, int64_t* din_total,
                    int64_t* din_errors, int32_t threads) {
  if (threads < 1) threads = 1;
  const int64_t ncyc = (int64_t)nrg * nq * nc;
  const int64_t ndin = (int64_t)nrg * nq * nd;
  // per-thread partials; cap threads so partials stay under ~256 MB
  // when nrg is large
  while (threads > 1 &&
         (int64_t)threads * (ncyc + ndin) * 2 * 8 > (256LL << 20))
    threads--;
  if (N < 4096) threads = 1;
  std::vector<std::vector<int64_t>> part(
      threads, std::vector<int64_t>(2 * (ncyc + ndin), 0));
  auto work = [&](int32_t t, int64_t r0, int64_t r1) {
    int64_t* ct = part[t].data();
    int64_t* ce = ct + ncyc;
    int64_t* dt = ce + ncyc;
    int64_t* de = dt + ndin;
    // first error index at or past this thread's row range
    const uint32_t lo = (uint64_t)r0 * L > 0xFFFFFFFFull
                            ? 0xFFFFFFFFu
                            : (uint32_t)((uint64_t)r0 * L);
    int64_t e = std::lower_bound(err_idx, err_idx + n_err, lo) - err_idx;
    for (int64_t i = r0; i < r1; i++) {
      const int8_t* c = codes + i * L;
      const int8_t* q = quals + i * L;
      const uint8_t* m = mask + i * L;
      const int32_t sec = seconds[i] ? 1 : 0;
      const int64_t rq0 = (int64_t)rgs[i] * nq;
      int32_t prev = 4;
      const uint64_t base = (uint64_t)i * L;
      for (int64_t j = 0; j < L; j++) {
        const int32_t cj = c[j], q0 = q[j];
        bool iserr = false;
        if (e < n_err && err_idx[e] == base + (uint64_t)j) {
          iserr = true;
          e++;
        }
        if (!m[j] || cj == 4 || q0 < min_usable_q) {
          prev = cj;
          continue;
        }
        const int32_t qc = q0 < 0 ? 0 : (q0 > nq - 1 ? nq - 1 : q0);
        const int64_t rq = rq0 + qc;
        const int32_t cyc = (int32_t)(j * 2) + sec;
        ct[rq * nc + cyc]++;
        if (iserr) ce[rq * nc + cyc]++;
        if (j > 0 && prev != 4 && cj != 4) {
          const int32_t din = prev * 4 + cj;
          dt[rq * nd + din]++;
          if (iserr) de[rq * nd + din]++;
        }
        prev = cj;
      }
    }
  };
  if (threads == 1) {
    work(0, 0, N);
  } else {
    std::vector<std::thread> pool;
    int64_t step = (N + threads - 1) / threads;
    for (int32_t t = 0; t < threads; t++) {
      int64_t r0 = t * step, r1 = r0 + step > N ? N : r0 + step;
      if (r0 >= r1) break;
      pool.emplace_back(work, t, r0, r1);
    }
    for (auto& th : pool) th.join();
  }
  for (int32_t t = 0; t < threads; t++) {
    const int64_t* p = part[t].data();
    for (int64_t x = 0; x < ncyc; x++) cyc_total[x] += p[x];
    p += ncyc;
    for (int64_t x = 0; x < ncyc; x++) cyc_errors[x] += p[x];
    p += ncyc;
    for (int64_t x = 0; x < ndin; x++) din_total[x] += p[x];
    p += ndin;
    for (int64_t x = 0; x < ndin; x++) din_errors[x] += p[x];
  }
}

// Decode FASTQ records into padded [n, stride] arrays in one pass:
// codes via the caller's 256-entry encode LUT, quals = byte-33 clipped
// to [0,93], mask = j < len (padding: code 4 / qual 0 / mask 0).  The
// numpy path materialized two [n, stride] int64 index arrays per chunk
// (~70 ns/base); this is a straight LUT copy (~2 ns/base, threaded).
void kbbq_fastq_extract(const uint8_t* buf, const int64_t* seq_starts,
                        const int64_t* qual_starts, const int64_t* lens,
                        int64_t n, int32_t stride, const int8_t* enc_lut,
                        int8_t* codes, int8_t* quals, uint8_t* mask,
                        int32_t nthreads) {
  if (nthreads < 1 || n < 256) nthreads = 1;
  const int T = nthreads;
  auto work = [&](int t) {
    for (int64_t i = t; i < n; i += T) {
      const uint8_t* s = buf + seq_starts[i];
      const uint8_t* q = buf + qual_starts[i];
      int8_t* oc = codes + i * stride;
      int8_t* oq = quals + i * stride;
      uint8_t* om = mask + i * stride;
      int32_t L = (int32_t)lens[i];
      for (int32_t j = 0; j < L; j++) {
        oc[j] = enc_lut[s[j]];
        int v = (int)q[j] - 33;
        oq[j] = (int8_t)(v < 0 ? 0 : (v > 93 ? 93 : v));
        om[j] = 1;
      }
      for (int32_t j = L; j < stride; j++) {
        oc[j] = 4; oq[j] = 0; om[j] = 0;
      }
    }
  };
  if (T == 1) { work(0); return; }
  std::vector<std::thread> ths;
  for (int t = 0; t < T; t++) ths.emplace_back(work, t);
  for (auto& th : ths) th.join();
}

// Overwrite quality-line bytes in an output FASTQ buffer from padded
// [n, stride] int8 phred values (prefix-masked rows): the only-quals-
// change invariant's write side.
void kbbq_fastq_write_quals(uint8_t* out, const int64_t* qual_starts,
                            const int64_t* lens, const int8_t* new_quals,
                            int64_t n, int32_t stride, int32_t nthreads) {
  if (nthreads < 1 || n < 256) nthreads = 1;
  const int T = nthreads;
  auto work = [&](int t) {
    for (int64_t i = t; i < n; i += T) {
      uint8_t* o = out + qual_starts[i];
      const int8_t* q = new_quals + i * stride;
      int32_t L = (int32_t)lens[i];
      for (int32_t j = 0; j < L; j++) o[j] = (uint8_t)(q[j] + 33);
    }
  };
  if (T == 1) { work(0); return; }
  std::vector<std::thread> ths;
  for (int t = 0; t < T; t++) ths.emplace_back(work, t);
  for (auto& th : ths) th.join();
}

// ----------------------------------------------------------------- BAM

// Scan complete BAM records in buf[start..n): out_offs[i] = body offset,
// out_sizes[i] = body size.  Returns the record count (<= cap) and sets
// *end_out just past the last complete record.  Malformed size -> -1.
// (htslib walks this boundary per bam_read1 call; we index a whole
// decoded span at once so Python never loops per record.)
int64_t kbbq_bam_offsets(const uint8_t* buf, int64_t n, int64_t start,
                         int64_t* out_offs, int64_t* out_sizes,
                         int64_t cap, int64_t* end_out) {
  int64_t off = start, cnt = 0;
  while (off + 4 <= n && cnt < cap) {
    int32_t sz;
    memcpy(&sz, buf + off, 4);
    if (sz <= 0) return -1;
    if (off + 4 + sz > n) break;
    out_offs[cnt] = off + 4;
    out_sizes[cnt] = sz;
    off += 4 + (int64_t)sz;
    cnt++;
  }
  *end_out = off;
  return cnt;
}

// Decode a group of same-length BAM records' seq+qual into machine
// order (reverse-strand records reverse-complemented, quals reversed —
// kbbq's CReadData semantics, SURVEY.md C5).  seq_off/qual_off are
// per-record byte offsets into buf (qual_off may point at an OQ value
// when oq_mode=1: value bytes are phred+33).  Outputs are [nrec, L]
// int8 row-major with row stride out_stride.
void kbbq_bam_decode(const uint8_t* buf, const int64_t* seq_off,
                     const int64_t* qual_off, const uint8_t* rev,
                     int64_t nrec, int32_t L, int32_t oq_mode,
                     int8_t* out_codes, int8_t* out_quals,
                     int64_t out_stride, int32_t nthreads) {
  // 4-bit nibble -> 2-bit code (A=1,C=2,G=4,T=8 per SAM spec; else N=4)
  static const int8_t nib[16] = {4, 0, 1, 4, 2, 4, 4, 4,
                                 3, 4, 4, 4, 4, 4, 4, 4};
  if (nthreads < 1 || nrec < 1024) nthreads = 1;
  const int T = nthreads;
  auto work = [&](int t) {
    for (int64_t i = t; i < nrec; i += T) {
      const uint8_t* s = buf + seq_off[i];
      int8_t* oc = out_codes + i * out_stride;
      for (int32_t j = 0; j < L; j++) {
        uint8_t b = s[j >> 1];
        oc[j] = nib[(j & 1) ? (b & 0xF) : (b >> 4)];
      }
      const uint8_t* q = buf + qual_off[i];
      int8_t* oq = out_quals + i * out_stride;
      if (oq_mode) {
        for (int32_t j = 0; j < L; j++) {
          int v = (int)q[j] - 33;
          oq[j] = (int8_t)(v < 0 ? 0 : (v > 93 ? 93 : v));
        }
      } else {
        for (int32_t j = 0; j < L; j++)
          oq[j] = (int8_t)(q[j] > 93 ? 93 : q[j]);
      }
      if (rev[i]) {
        for (int32_t a = 0, b = L - 1; a < b; a++, b--) {
          int8_t c = oc[a]; oc[a] = oc[b]; oc[b] = c;
          c = oq[a]; oq[a] = oq[b]; oq[b] = c;
        }
        for (int32_t j = 0; j < L; j++)
          if (oc[j] < 4) oc[j] = (int8_t)(3 - oc[j]);
      }
    }
  };
  if (T == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> ths;
  for (int t = 0; t < T; t++) ths.emplace_back(work, t);
  for (auto& th : ths) th.join();
}

// ------------------------------------------------- rANS 4x8 (CRAM M4)
//
// Bit-exact twins of io/cram_codecs.py (the htslib rans_static 4x8
// wire format).  The pure-NumPy coder decodes ~0.3 MB/s on the order-1
// inner loop (20.9M Python calls per 30 MB QS block, profiled round
// 4); these run the same math at C speed.  Exactness matters both
// ways: encode must produce the identical byte stream (normalization
// tie-breaks included) so native/python outputs are interchangeable.

static const uint32_t RANS_L = 1u << 23;
static const int TF_SHIFT = 12;
static const uint32_t TOTFREQ = 1u << TF_SHIFT;

// counts[256] -> F[256] summing exactly TOTFREQ (twin: _normalize_freqs)
static void rans_normalize(const int64_t* counts, int64_t* F) {
  int64_t total = 0;
  for (int j = 0; j < 256; j++) total += counts[j];
  if (total == 0) { std::memset(F, 0, 256 * sizeof(int64_t)); return; }
  int64_t sum = 0;
  for (int j = 0; j < 256; j++) {
    double f = (double)counts[j] * (double)TOTFREQ / (double)total;
    F[j] = (int64_t)std::floor(f);
    if (counts[j] > 0 && F[j] == 0) F[j] = 1;
    sum += F[j];
  }
  int order[256];
  for (int j = 0; j < 256; j++) order[j] = j;
  std::stable_sort(order, order + 256, [&](int a, int b) {
    return counts[a] > counts[b];   // np.argsort(-counts): stable desc
  });
  int64_t diff = (int64_t)TOTFREQ - sum;
  int64_t i = 0;
  while (diff != 0) {
    int j = order[i % 256];
    if (counts[j] > 0 && (diff > 0 || F[j] > 1)) {
      F[j] += diff > 0 ? 1 : -1;
      diff += diff > 0 ? -1 : 1;
    }
    i++;
  }
}

// twin: _write_freq_table; returns bytes written
static int64_t rans_write_ft(const int64_t* F, uint8_t* out) {
  int64_t o = 0;
  int rle = 0;
  for (int j = 0; j < 256; j++) {
    if (!F[j]) continue;
    if (rle) {
      rle--;
    } else {
      out[o++] = (uint8_t)j;
      if (j && F[j - 1]) {
        int r = j + 1;
        while (r < 256 && F[r]) r++;
        rle = r - (j + 1);
        out[o++] = (uint8_t)rle;
      }
    }
    int64_t f = F[j];
    if (f < 128) {
      out[o++] = (uint8_t)f;
    } else {
      out[o++] = (uint8_t)(0x80 | (f >> 8));
      out[o++] = (uint8_t)(f & 0xFF);
    }
  }
  out[o++] = 0;
  return o;
}

// twin: _read_freq_table; returns new pos, or -1 on overrun
static int64_t rans_read_ft(const uint8_t* buf, int64_t pos, int64_t n,
                            int64_t* F) {
  std::memset(F, 0, 256 * sizeof(int64_t));
  int rle = 0;
  if (pos >= n) return -1;
  int j = buf[pos++];
  for (;;) {
    if (pos >= n) return -1;
    int64_t f = buf[pos++];
    if (f >= 128) {
      if (pos >= n) return -1;
      f = ((f & 0x7F) << 8) | buf[pos++];
    }
    F[j & 0xFF] = f;
    if (rle) {
      rle--;
      j++;
    } else {
      if (pos >= n) return -1;
      int nj = buf[pos++];
      if (nj == j + 1) {
        j = nj;
        if (pos >= n) return -1;
        rle = buf[pos++];
      } else {
        j = nj;
      }
    }
    if (j == 0 && rle == 0) break;
  }
  return pos;
}

static void rans_cumsum(const int64_t* F, int64_t* C) {
  int64_t c = 0;
  for (int s = 0; s < 256; s++) { C[s] = c; c += F[s]; }
}

// Decode an rANS 4x8 blob (order 0 or 1) into out[n_out].
// Returns 0 on success, negative on malformed input.
int32_t kbbq_rans_uncompress(const uint8_t* blob, int64_t blob_len,
                             uint8_t* out, int64_t n_out) {
  if (blob_len < 9) return -1;
  int order = blob[0];
  uint32_t n_declared;
  std::memcpy(&n_declared, blob + 5, 4);
  if ((int64_t)n_declared != n_out) return -2;
  if (n_out == 0) return 0;
  int64_t pos = 9;
  const int64_t n = blob_len;
  if (order == 0) {
    std::vector<int64_t> F(256), C(256);
    pos = rans_read_ft(blob, pos, n, F.data());
    if (pos < 0 || pos + 16 > n) return -3;
    rans_cumsum(F.data(), C.data());
    std::vector<uint8_t> lut(TOTFREQ);
    std::vector<uint32_t> Fs(256), Cs(256);
    for (int s = 0; s < 256; s++) {
      Fs[s] = (uint32_t)F[s];
      Cs[s] = (uint32_t)C[s];
      for (int64_t k = C[s]; k < C[s] + F[s]; k++) lut[k] = (uint8_t)s;
    }
    uint32_t x[4];
    for (int j = 0; j < 4; j++) { std::memcpy(&x[j], blob + pos, 4); pos += 4; }
    for (int64_t i = 0; i < n_out; i++) {
      int j = (int)(i & 3);
      uint32_t xi = x[j];
      uint32_t m = xi & (TOTFREQ - 1);
      uint8_t s = lut[m];
      out[i] = s;
      xi = Fs[s] * (xi >> TF_SHIFT) + m - Cs[s];
      while (xi < RANS_L && pos < n) xi = (xi << 8) | blob[pos++];
      x[j] = xi;
    }
    return 0;
  }
  if (order != 1) return -4;
  std::vector<int64_t> F2(256 * 256), C2(256 * 256);
  {
    // twin: _read_freq_table_o1 (context RLE over nested o0 tables)
    int rle = 0;
    if (pos >= n) return -3;
    int c = blob[pos++];
    for (;;) {
      pos = rans_read_ft(blob, pos, n, F2.data() + 256 * (c & 0xFF));
      if (pos < 0) return -3;
      if (rle) {
        rle--;
        c++;
      } else {
        if (pos >= n) return -3;
        int nc = blob[pos++];
        if (nc == c + 1) {
          c = nc;
          if (pos >= n) return -3;
          rle = blob[pos++];
        } else {
          c = nc;
        }
      }
      if (c == 0 && rle == 0) break;
    }
  }
  for (int c = 0; c < 256; c++) rans_cumsum(F2.data() + 256 * c,
                                            C2.data() + 256 * c);
  if (pos + 16 > n) return -3;
  uint32_t x[4];
  for (int j = 0; j < 4; j++) { std::memcpy(&x[j], blob + pos, 4); pos += 4; }
  std::vector<uint8_t> lut(256 * TOTFREQ);
  bool built[256] = {false};
  auto build = [&](int c) {
    uint8_t* t = lut.data() + (size_t)c * TOTFREQ;
    const int64_t* Fc = F2.data() + 256 * c;
    const int64_t* Cc = C2.data() + 256 * c;
    for (int s = 0; s < 256; s++)
      for (int64_t k = Cc[s]; k < Cc[s] + Fc[s]; k++) t[k] = (uint8_t)s;
    built[c] = true;
  };
  int ctx[4] = {0, 0, 0, 0};
  int64_t q = n_out >> 2;
  int64_t qs[4] = {0, q, 2 * q, 3 * q};
  auto get = [&](int j, int64_t dst) {
    int cc = ctx[j];
    if (!built[cc]) build(cc);
    uint32_t xi = x[j];
    uint32_t m = xi & (TOTFREQ - 1);
    uint8_t s = lut[(size_t)cc * TOTFREQ + m];
    out[dst] = s;
    xi = (uint32_t)F2[256 * cc + s] * (xi >> TF_SHIFT) + m
         - (uint32_t)C2[256 * cc + s];
    while (xi < RANS_L && pos < n) xi = (xi << 8) | blob[pos++];
    x[j] = xi;
    ctx[j] = s;
  };
  for (int64_t i = 0; i < q; i++)
    for (int j = 0; j < 4; j++) get(j, qs[j] + i);
  for (int64_t dst = qs[3] + q; dst < n_out; dst++) get(3, dst);
  return 0;
}

// Encode data[n] as rANS 4x8 (order 0 or 1).  Returns the blob size,
// or -1 if `cap` is too small.  Byte stream identical to the Python
// encoder's (tests assert it).
int64_t kbbq_rans_compress(const uint8_t* data, int64_t n, int32_t order,
                           uint8_t* out, int64_t cap) {
  // worst-case: tables (o1 <= 257*(2+3*256)+2) + 16 states + stream
  // (~n * 1.004 + 4*4 renorm tail) + 9 header
  std::vector<uint8_t> body;
  body.reserve((size_t)(n + (n >> 6) + (1 << 20)));
  std::vector<uint8_t> stream;
  stream.reserve((size_t)(n + (n >> 6) + 64));
  uint32_t x[4] = {RANS_L, RANS_L, RANS_L, RANS_L};
  const uint32_t xmax_mul = (RANS_L >> TF_SHIFT) << 8;

  if (order == 0) {
    int64_t counts[256] = {0};
    for (int64_t i = 0; i < n; i++) counts[data[i]]++;
    int64_t F[256], C[256];
    rans_normalize(counts, F);
    rans_cumsum(F, C);
    for (int64_t i = n - 1; i >= 0; i--) {
      uint8_t s = data[i];
      int j = (int)(i & 3);
      uint32_t f = (uint32_t)F[s];
      uint32_t xm = xmax_mul * f;
      while (x[j] >= xm) { stream.push_back(x[j] & 0xFF); x[j] >>= 8; }
      x[j] = ((x[j] / f) << TF_SHIFT) + (x[j] % f) + (uint32_t)C[s];
    }
    uint8_t ft[3 * 256 + 2];
    int64_t ftn = rans_write_ft(F, ft);
    body.insert(body.end(), ft, ft + ftn);
  } else if (order == 1) {
    std::vector<int64_t> counts(256 * 256, 0);
    int64_t q = n >> 2;
    int64_t qa[4] = {0, q, 2 * q, 3 * q};
    int64_t qb[4] = {q, 2 * q, 3 * q, n};
    for (int k = 0; k < 4; k++) {
      int prev = 0;
      for (int64_t i = qa[k]; i < qb[k]; i++) {
        counts[256 * prev + data[i]]++;
        prev = data[i];
      }
    }
    std::vector<int64_t> F2(256 * 256, 0), C2(256 * 256, 0);
    for (int c = 0; c < 256; c++) {
      int64_t tot = 0;
      for (int s = 0; s < 256; s++) tot += counts[256 * c + s];
      if (tot)
        rans_normalize(counts.data() + 256 * c, F2.data() + 256 * c);
      rans_cumsum(F2.data() + 256 * c, C2.data() + 256 * c);
    }
    auto put = [&](int j, int64_t i, int64_t a) {
      uint8_t s = data[i];
      int cc = i > a ? data[i - 1] : 0;
      uint32_t f = (uint32_t)F2[256 * cc + s];
      uint32_t xm = xmax_mul * f;
      while (x[j] >= xm) { stream.push_back(x[j] & 0xFF); x[j] >>= 8; }
      x[j] = ((x[j] / f) << TF_SHIFT) + (x[j] % f)
             + (uint32_t)C2[256 * cc + s];
    };
    for (int64_t i = n - 1; i >= qa[3] + q; i--) put(3, i, qa[3]);
    for (int64_t i = q - 1; i >= 0; i--)
      for (int j = 3; j >= 0; j--) put(j, qa[j] + i, qa[j]);
    // twin: _write_freq_table_o1
    int rle = 0;
    uint8_t ft[3 * 256 + 2];
    for (int c = 0; c < 256; c++) {
      int64_t tot = 0;
      for (int s = 0; s < 256; s++) tot += F2[256 * c + s];
      if (!tot) continue;
      if (rle) {
        rle--;
      } else {
        body.push_back((uint8_t)c);
        int64_t ptot = 0;
        if (c)
          for (int s = 0; s < 256; s++) ptot += F2[256 * (c - 1) + s];
        if (c && ptot) {
          int r = c + 1;
          while (r < 256) {
            int64_t rt = 0;
            for (int s = 0; s < 256; s++) rt += F2[256 * r + s];
            if (!rt) break;
            r++;
          }
          rle = r - (c + 1);
          body.push_back((uint8_t)rle);
        }
      }
      int64_t ftn = rans_write_ft(F2.data() + 256 * c, ft);
      body.insert(body.end(), ft, ft + ftn);
    }
    body.push_back(0);
  } else {
    return -2;
  }
  for (int j = 0; j < 4; j++) {
    uint32_t v = x[j];
    body.push_back(v & 0xFF);
    body.push_back((v >> 8) & 0xFF);
    body.push_back((v >> 16) & 0xFF);
    body.push_back((v >> 24) & 0xFF);
  }
  // stream is collected forward but transmitted reversed
  int64_t total = 9 + (int64_t)body.size() + (int64_t)stream.size();
  if (total > cap) return -1;
  out[0] = (uint8_t)order;
  uint32_t csize = (uint32_t)(body.size() + stream.size());
  uint32_t usize = (uint32_t)n;
  std::memcpy(out + 1, &csize, 4);
  std::memcpy(out + 5, &usize, 4);
  std::memcpy(out + 9, body.data(), body.size());
  uint8_t* o = out + 9 + body.size();
  for (int64_t i = (int64_t)stream.size() - 1; i >= 0; i--)
    *o++ = stream[i];
  return total;
}

}  // extern "C"
