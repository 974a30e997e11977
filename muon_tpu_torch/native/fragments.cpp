// BGZF + Tabix engine for 10x ATAC fragment files: the port's own copy of
// muon_tpu/native/fragments.cpp, built into muon_tpu_torch/_build/ by
// muon_tpu_torch/native/__init__.py (g++, linked with the system zlib, -lz).
//
// Replacement for the pysam/htslib (C) dependency the reference leans on
// for every fragment-level tool (reference call sites:
// muon/_atac/tools.py:666-675,849,1036,1154,1239). Capabilities:
//
//   - BGZF block decompression with virtual-offset seeks (zlib raw inflate)
//   - .tbi (tabix) index parsing and region queries (binning + linear index)
//   - barcode-dictionary record parsing: barcodes resolve to int32 row ids
//     in C++, so Python never loops over records (the reference's per-record
//     dict lookup, muon/_atac/tools.py:868-878, is its hot I/O loop)
//   - full-file streaming for nucleosome-signal style scans
//   - BGZF writer (its blocks compressed on every core; the same bytes as
//     the JAX package's one-thread writer) + tabix index builder
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kBgzfBlockMax = 65536;
constexpr int kBgzfPayloadMax = 65280;  // htslib's write payload cap
constexpr int kLinearShift = 14;        // 16 kb linear-index windows

// ---------------------------------------------------------------------------
// BGZF reader
// ---------------------------------------------------------------------------

struct BgzfReader {
  FILE* fp = nullptr;
  // current decompressed block
  std::vector<uint8_t> block;
  int64_t block_coffset = -1;  // compressed offset of current block
  int64_t next_coffset = 0;    // compressed offset of the following block
  size_t upos = 0;             // cursor within block
  bool eof = false;

  ~BgzfReader() {
    if (fp) fclose(fp);
  }

  bool open(const char* path) {
    fp = fopen(path, "rb");
    return fp != nullptr;
  }

  // Load the BGZF block starting at coffset. Returns false at EOF/error.
  bool load_block(int64_t coffset) {
    if (block_coffset == coffset && !block.empty()) return true;
    if (fseeko(fp, coffset, SEEK_SET) != 0) return false;
    uint8_t hdr[18];
    if (fread(hdr, 1, 18, fp) != 18) {
      eof = true;
      return false;
    }
    if (hdr[0] != 31 || hdr[1] != 139 || hdr[2] != 8 || !(hdr[3] & 4))
      return false;
    uint16_t xlen = hdr[10] | (hdr[11] << 8);
    // scan extra subfields for BC (BGZF block size)
    std::vector<uint8_t> extra(xlen);
    // first 6 bytes of the extra field were already read into hdr[12..17]
    size_t pre = std::min<size_t>(6, xlen);
    memcpy(extra.data(), hdr + 12, pre);
    if (xlen > 6 && fread(extra.data() + 6, 1, xlen - 6, fp) != (size_t)(xlen - 6))
      return false;
    int bsize = -1;
    for (size_t i = 0; i + 4 <= extra.size();) {
      uint8_t si1 = extra[i], si2 = extra[i + 1];
      uint16_t slen = extra[i + 2] | (extra[i + 3] << 8);
      if (si1 == 66 && si2 == 67 && slen == 2 && i + 6 <= extra.size()) {
        bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
        break;
      }
      i += 4 + slen;
    }
    if (bsize < 0) return false;
    // total block = 12 (gzip header) + xlen + cdata + 8 (CRC32 + ISIZE)
    int cdata_len = bsize - xlen - 20;
    if (cdata_len < 0) return false;  // corrupt header (bsize too small)
    std::vector<uint8_t> cdata(cdata_len);
    if (fseeko(fp, coffset + 12 + xlen, SEEK_SET) != 0) return false;
    if (cdata_len > 0 && fread(cdata.data(), 1, cdata_len, fp) != (size_t)cdata_len)
      return false;
    uint8_t tail[8];
    if (fread(tail, 1, 8, fp) != 8) return false;
    uint32_t isize =
        tail[4] | (tail[5] << 8) | (tail[6] << 16) | ((uint32_t)tail[7] << 24);
    if (isize > 65536) return false;  // BGZF spec caps ISIZE at 64 KiB

    block.resize(isize);
    if (isize > 0) {
      z_stream zs{};
      if (inflateInit2(&zs, -15) != Z_OK) return false;
      zs.next_in = cdata.data();
      zs.avail_in = cdata_len;
      zs.next_out = block.data();
      zs.avail_out = isize;
      int r = inflate(&zs, Z_FINISH);
      bool complete = (r == Z_STREAM_END) && (zs.total_out == isize);
      inflateEnd(&zs);
      if (!complete) return false;
    }
    block_coffset = coffset;
    next_coffset = coffset + bsize;
    upos = 0;
    if (isize == 0) {  // EOF marker block
      eof = true;
      return false;
    }
    return true;
  }

  bool seek_voffset(int64_t voffset) {
    int64_t coffset = voffset >> 16;
    size_t uoff = voffset & 0xFFFF;
    if (!load_block(coffset)) return false;
    if (uoff > block.size()) return false;
    upos = uoff;
    return true;
  }

  int64_t tell_voffset() const {
    if (upos == block.size()) return (next_coffset << 16);
    return (block_coffset << 16) | (int64_t)upos;
  }

  // Read one line (without trailing \n). Returns false at EOF.
  bool next_line(std::string& out) {
    out.clear();
    for (;;) {
      if (block_coffset < 0 || upos >= block.size()) {
        if (!load_block(block_coffset < 0 ? next_coffset : next_coffset))
          return !out.empty();
      }
      uint8_t* start = block.data() + upos;
      uint8_t* nl =
          (uint8_t*)memchr(start, '\n', block.size() - upos);
      if (nl) {
        out.append((char*)start, nl - start);
        upos = (nl - block.data()) + 1;
        return true;
      }
      out.append((char*)start, block.size() - upos);
      upos = block.size();
    }
  }
};

// ---------------------------------------------------------------------------
// Tabix index
// ---------------------------------------------------------------------------

struct Chunk {
  int64_t beg, end;
};

struct RefIndex {
  std::unordered_map<uint32_t, std::vector<Chunk>> bins;
  std::vector<int64_t> linear;  // 16kb window -> min voffset
};

struct TabixIndex {
  int32_t format = 0, col_seq = 1, col_beg = 2, col_end = 3;
  int32_t meta = '#', skip = 0;
  std::vector<std::string> names;
  std::unordered_map<std::string, int> name_to_tid;
  std::vector<RefIndex> refs;

  bool load(const char* path) {
    gzFile gz = gzopen(path, "rb");
    if (!gz) return false;
    std::vector<uint8_t> buf;
    uint8_t tmp[1 << 16];
    int n;
    while ((n = gzread(gz, tmp, sizeof(tmp))) > 0)
      buf.insert(buf.end(), tmp, tmp + n);
    gzclose(gz);
    // file-supplied counts are untrusted: every read is bounds-checked
    // against buf.size() so a truncated/corrupt .tbi fails cleanly instead
    // of overreading the heap (ADVICE r1 #3)
    size_t p = 0;
    bool ok = true;
    auto rd32 = [&]() -> int32_t {
      if (p + 4 > buf.size()) {
        ok = false;
        return 0;
      }
      int32_t v;
      memcpy(&v, buf.data() + p, 4);
      p += 4;
      return v;
    };
    auto rd64 = [&]() -> int64_t {
      if (p + 8 > buf.size()) {
        ok = false;
        return 0;
      }
      int64_t v;
      memcpy(&v, buf.data() + p, 8);
      p += 8;
      return v;
    };
    if (buf.size() < 36 || memcmp(buf.data(), "TBI\1", 4) != 0) return false;
    p = 4;
    int32_t n_ref = rd32();
    format = rd32();
    col_seq = rd32();
    col_beg = rd32();
    col_end = rd32();
    meta = rd32();
    skip = rd32();
    int32_t l_nm = rd32();
    if (!ok || n_ref < 0 || l_nm < 0 || p + (size_t)l_nm > buf.size())
      return false;
    size_t names_end = p + l_nm;
    while (p < names_end) {
      const char* s = (const char*)buf.data() + p;
      size_t len = strnlen(s, names_end - p);
      names.emplace_back(s, len);
      name_to_tid[names.back()] = (int)names.size() - 1;
      p += len + 1;
    }
    refs.resize(n_ref);
    for (int r = 0; r < n_ref; r++) {
      int32_t n_bin = rd32();
      if (!ok || n_bin < 0) return false;
      for (int b = 0; b < n_bin; b++) {
        uint32_t bin = (uint32_t)rd32();
        int32_t n_chunk = rd32();
        if (!ok || n_chunk < 0 || p + 16ull * (uint64_t)n_chunk > buf.size())
          return false;
        auto& v = refs[r].bins[bin];
        v.reserve(n_chunk);
        for (int c = 0; c < n_chunk; c++) {
          int64_t cb = rd64(), ce = rd64();
          v.push_back({cb, ce});
        }
      }
      int32_t n_intv = rd32();
      if (!ok || n_intv < 0 || p + 8ull * (uint64_t)n_intv > buf.size())
        return false;
      refs[r].linear.resize(n_intv);
      for (int i = 0; i < n_intv; i++) refs[r].linear[i] = rd64();
    }
    return ok;
  }
};

// standard UCSC binning (tabix paper / SAM spec)
static int reg2bin(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (beg >> 14);
  if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (beg >> 17);
  if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (beg >> 20);
  if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (beg >> 23);
  if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (beg >> 26);
  return 0;
}

static void reg2bins(int64_t beg, int64_t end, std::vector<uint32_t>& bins) {
  bins.clear();
  --end;
  bins.push_back(0);
  for (int64_t k = 1 + (beg >> 26); k <= 1 + (end >> 26); ++k) bins.push_back(k);
  for (int64_t k = 9 + (beg >> 23); k <= 9 + (end >> 23); ++k) bins.push_back(k);
  for (int64_t k = 73 + (beg >> 20); k <= 73 + (end >> 20); ++k)
    bins.push_back(k);
  for (int64_t k = 585 + (beg >> 17); k <= 585 + (end >> 17); ++k)
    bins.push_back(k);
  for (int64_t k = 4681 + (beg >> 14); k <= 4681 + (end >> 14); ++k)
    bins.push_back(k);
}

// ---------------------------------------------------------------------------
// Fragment record parsing
// ---------------------------------------------------------------------------

struct ParsedRec {
  const char* chrom;
  size_t chrom_len;
  int64_t start, end;
  const char* name;
  size_t name_len;
  int32_t score;
  bool ok;
};

static ParsedRec parse_line(const std::string& line) {
  ParsedRec r{};
  r.ok = false;
  const char* s = line.c_str();
  const char* tab1 = strchr(s, '\t');
  if (!tab1) return r;
  const char* tab2 = strchr(tab1 + 1, '\t');
  if (!tab2) return r;
  const char* tab3 = strchr(tab2 + 1, '\t');
  if (!tab3) return r;
  const char* tab4 = strchr(tab3 + 1, '\t');
  r.chrom = s;
  r.chrom_len = tab1 - s;
  r.start = strtoll(tab1 + 1, nullptr, 10);
  r.end = strtoll(tab2 + 1, nullptr, 10);
  r.name = tab3 + 1;
  r.name_len = (tab4 ? (size_t)(tab4 - tab3 - 1) : strlen(tab3 + 1));
  r.score = tab4 ? (int32_t)strtol(tab4 + 1, nullptr, 10) : 1;
  r.ok = true;
  return r;
}

// ---------------------------------------------------------------------------
// Handle
// ---------------------------------------------------------------------------

struct FragFile {
  BgzfReader bgzf;
  TabixIndex idx;
  std::unordered_map<std::string, int32_t> barcodes;
  // last result buffers
  std::vector<int64_t> starts, ends;
  std::vector<int32_t> cells, scores;
  std::vector<int32_t> name_offsets;  // offsets into name_buf (n+1 entries)
  std::string name_buf;
  std::string error;

  void clear_results() {
    starts.clear();
    ends.clear();
    cells.clear();
    scores.clear();
    name_offsets.clear();
    name_buf.clear();
    name_offsets.push_back(0);
  }

  void push(const ParsedRec& r) {
    starts.push_back(r.start);
    ends.push_back(r.end);
    scores.push_back(r.score);
    if (!barcodes.empty()) {
      auto it = barcodes.find(std::string(r.name, r.name_len));
      cells.push_back(it == barcodes.end() ? -1 : it->second);
    } else {
      cells.push_back(-1);
    }
    name_buf.append(r.name, r.name_len);
    name_offsets.push_back((int32_t)name_buf.size());
  }
};

}  // namespace

extern "C" {

FragFile* frag_open(const char* path) {
  auto* f = new FragFile();
  if (!f->bgzf.open(path)) {
    delete f;
    return nullptr;
  }
  std::string tbi = std::string(path) + ".tbi";
  if (!f->idx.load(tbi.c_str())) {
    // usable without an index for full-file streaming only
    f->idx.names.clear();
  }
  f->clear_results();
  return f;
}

void frag_close(FragFile* f) { delete f; }

int frag_n_contigs(FragFile* f) { return (int)f->idx.names.size(); }

const char* frag_contig_name(FragFile* f, int i) {
  if (i < 0 || i >= (int)f->idx.names.size()) return "";
  return f->idx.names[i].c_str();
}

// barcodes: n strings, each NUL-terminated, concatenated
void frag_set_barcodes(FragFile* f, const char* concat, int n) {
  f->barcodes.clear();
  const char* p = concat;
  for (int i = 0; i < n; i++) {
    size_t len = strlen(p);
    f->barcodes.emplace(std::string(p, len), i);
    p += len + 1;
  }
}

// Query a region; returns record count (or -1 on error).
long frag_fetch(FragFile* f, const char* chrom, long beg, long end) {
  f->clear_results();
  if (beg < 0) beg = 0;
  auto it = f->idx.name_to_tid.find(chrom);
  if (it == f->idx.name_to_tid.end()) return 0;
  const RefIndex& ref = f->idx.refs[it->second];

  int64_t min_off = 0;
  size_t w = (size_t)(beg >> kLinearShift);
  if (!ref.linear.empty()) {
    if (w >= ref.linear.size()) w = ref.linear.size() - 1;
    min_off = ref.linear[w];
  }

  std::vector<uint32_t> bins;
  reg2bins(beg, end, bins);
  std::vector<Chunk> chunks;
  for (uint32_t b : bins) {
    auto bit = ref.bins.find(b);
    if (bit == ref.bins.end()) continue;
    for (const Chunk& c : bit->second)
      if (c.end > min_off) chunks.push_back(c);
  }
  if (chunks.empty()) return 0;
  std::sort(chunks.begin(), chunks.end(),
            [](const Chunk& a, const Chunk& b) { return a.beg < b.beg; });
  // merge overlapping/adjacent chunk ranges
  std::vector<Chunk> merged;
  for (const Chunk& c : chunks) {
    if (!merged.empty() && c.beg <= merged.back().end) {
      merged.back().end = std::max(merged.back().end, c.end);
    } else {
      merged.push_back(c);
    }
  }

  std::string line;
  for (const Chunk& c : merged) {
    if (!f->bgzf.seek_voffset(std::max(c.beg, min_off))) continue;
    for (;;) {
      int64_t v = f->bgzf.tell_voffset();
      if (v >= c.end) break;
      if (!f->bgzf.next_line(line)) break;
      if (line.empty() || line[0] == (char)f->idx.meta) continue;
      ParsedRec r = parse_line(line);
      if (!r.ok) continue;
      if (strncmp(r.chrom, chrom, r.chrom_len) != 0 ||
          strlen(chrom) != r.chrom_len)
        continue;
      if (r.start >= end) goto done;  // records sorted by start
      if (r.end > beg) f->push(r);
    }
  }
done:
  return (long)f->starts.size();
}

// Batched region fetch: query n_regions at once (contig given by index
// into the .tbi contig table; see frag_contig_name). Results concatenate
// into the usual buffers; region_offsets (n_regions+1) marks boundaries.
// Returns total record count, or -1 on error.
long frag_fetch_many(FragFile* f, const int32_t* tids, const int64_t* begs,
                     const int64_t* ends, long n_regions,
                     int64_t* region_offsets) {
  // accumulate across per-region fetches without clearing
  std::vector<int64_t> starts, rends;
  std::vector<int32_t> cells, scores;
  std::string name_buf;
  std::vector<int32_t> name_offsets;
  name_offsets.push_back(0);

  for (long r = 0; r < n_regions; r++) {
    region_offsets[r] = (int64_t)starts.size();
    if (tids[r] < 0 || tids[r] >= (int32_t)f->idx.names.size()) continue;
    const char* chrom = f->idx.names[tids[r]].c_str();
    if (frag_fetch(f, chrom, (long)begs[r], (long)ends[r]) < 0) return -1;
    starts.insert(starts.end(), f->starts.begin(), f->starts.end());
    rends.insert(rends.end(), f->ends.begin(), f->ends.end());
    cells.insert(cells.end(), f->cells.begin(), f->cells.end());
    scores.insert(scores.end(), f->scores.begin(), f->scores.end());
    const int32_t base = (int32_t)name_buf.size();
    name_buf += f->name_buf;
    for (size_t i = 1; i < f->name_offsets.size(); i++)
      name_offsets.push_back(base + f->name_offsets[i]);
  }
  region_offsets[n_regions] = (int64_t)starts.size();

  f->starts.swap(starts);
  f->ends.swap(rends);
  f->cells.swap(cells);
  f->scores.swap(scores);
  f->name_buf.swap(name_buf);
  f->name_offsets.swap(name_offsets);
  return (long)f->starts.size();
}

// Stream up to n_max records from the start of the file (all contigs).
long frag_stream(FragFile* f, long n_max) {
  f->clear_results();
  if (!f->bgzf.load_block(0)) return -1;
  f->bgzf.upos = 0;
  std::string line;
  long n = 0;
  while (n < n_max && f->bgzf.next_line(line)) {
    if (line.empty() || line[0] == (char)f->idx.meta || line[0] == '#')
      continue;
    ParsedRec r = parse_line(line);
    if (!r.ok) continue;
    f->push(r);
    n++;
  }
  return n;
}

const int64_t* frag_starts(FragFile* f) { return f->starts.data(); }
const int64_t* frag_ends(FragFile* f) { return f->ends.data(); }
const int32_t* frag_cells(FragFile* f) { return f->cells.data(); }
const int32_t* frag_scores(FragFile* f) { return f->scores.data(); }
const int32_t* frag_name_offsets(FragFile* f) { return f->name_offsets.data(); }
const char* frag_name_buf(FragFile* f) { return f->name_buf.c_str(); }
long frag_name_buf_len(FragFile* f) { return (long)f->name_buf.size(); }

// ---------------------------------------------------------------------------
// BGZF writer + tabix index builder
// ---------------------------------------------------------------------------

// One BGZF block of `len` bytes of text (header, raw deflate at the default
// level, crc32, length) into `block`.
static bool make_bgzf_block(const uint8_t* data, int len, std::vector<uint8_t>& block) {
  block.resize(kBgzfBlockMax);
  z_stream zs{};
  if (deflateInit2(&zs, Z_DEFAULT_COMPRESSION, Z_DEFLATED, -15, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return false;
  zs.next_in = const_cast<uint8_t*>(data);
  zs.avail_in = len;
  zs.next_out = block.data() + 18;
  zs.avail_out = kBgzfBlockMax - 18 - 8;
  int r = deflate(&zs, Z_FINISH);
  int clen = (int)(kBgzfBlockMax - 18 - 8 - zs.avail_out);
  deflateEnd(&zs);
  if (r != Z_STREAM_END) return false;
  uint32_t crc = crc32(0, data, len);
  int bsize = clen + 25 + 1;  // header 18 + cdata + crc 4 + isize 4 = bsize+1
  uint8_t hdr[18] = {31, 139, 8,    4,    0, 0, 0, 0, 0,
                     255, 6,  0,    66,   67, 2, 0, 0, 0};
  hdr[16] = (bsize - 1) & 0xFF;
  hdr[17] = ((bsize - 1) >> 8) & 0xFF;
  memcpy(block.data(), hdr, 18);
  uint32_t ilen = (uint32_t)len;
  memcpy(block.data() + 18 + clen, &crc, 4);
  memcpy(block.data() + 18 + clen + 4, &ilen, 4);
  block.resize(18 + clen + 8);
  return true;
}

// Write `len` bytes of text as a BGZF file (with EOF marker block). The
// blocks are independent, so they are compressed on every core, a window of
// blocks at a time, and written in order: the same bytes as one thread.
int frag_write_bgzf(const char* path, const char* data, long len) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  const long n_blocks = (len + kBgzfPayloadMax - 1) / kBgzfPayloadMax;
  const int n_threads = (int)std::max<unsigned>(
      1, std::min<unsigned>(std::thread::hardware_concurrency(), 32));
  const long window = 64L * n_threads;
  std::vector<std::vector<uint8_t>> blocks(std::min(window, std::max(n_blocks, 1L)));
  for (long b0 = 0; b0 < n_blocks; b0 += window) {
    const long nb = std::min(window, n_blocks - b0);
    std::vector<char> ok(n_threads, 1);
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; t++) {
      pool.emplace_back([&, t]() {
        for (long i = t; i < nb; i += n_threads) {
          const long off = (b0 + i) * kBgzfPayloadMax;
          const int chunk = (int)std::min<long>(kBgzfPayloadMax, len - off);
          if (!make_bgzf_block((const uint8_t*)data + off, chunk, blocks[i])) ok[t] = 0;
        }
      });
    }
    for (auto& th : pool) th.join();
    for (int t = 0; t < n_threads; t++) {
      if (!ok[t]) {
        fclose(fp);
        return -1;
      }
    }
    for (long i = 0; i < nb; i++) {
      if (fwrite(blocks[i].data(), 1, blocks[i].size(), fp) != blocks[i].size()) {
        fclose(fp);
        return -1;
      }
    }
  }
  // standard 28-byte EOF marker (empty block)
  static const uint8_t eof_blk[28] = {
      0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
      0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
      0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};
  fwrite(eof_blk, 1, 28, fp);
  fclose(fp);
  return 0;
}

// Build <path>.tbi for a position-sorted BED-like bgzf file.
int tabix_build(const char* path) {
  BgzfReader rd;
  if (!rd.open(path)) return -1;
  if (!rd.load_block(0)) return -1;
  rd.upos = 0;

  struct RefBuild {
    std::map<uint32_t, std::vector<Chunk>> bins;
    std::vector<int64_t> linear;
  };
  std::vector<std::string> names;
  std::unordered_map<std::string, int> tid_of;
  std::vector<RefBuild> refs;

  std::string line;
  for (;;) {
    int64_t v0 = rd.tell_voffset();
    if (!rd.next_line(line)) break;
    if (line.empty() || line[0] == '#') continue;
    int64_t v1 = rd.tell_voffset();
    ParsedRec r = parse_line(line);
    if (!r.ok) continue;
    std::string chrom(r.chrom, r.chrom_len);
    auto it = tid_of.find(chrom);
    int tid;
    if (it == tid_of.end()) {
      tid = (int)names.size();
      tid_of[chrom] = tid;
      names.push_back(chrom);
      refs.emplace_back();
    } else {
      tid = it->second;
    }
    RefBuild& rb = refs[tid];
    uint32_t bin = (uint32_t)reg2bin(r.start, r.end);
    auto& chunks = rb.bins[bin];
    if (!chunks.empty() && chunks.back().end == v0) {
      chunks.back().end = v1;
    } else {
      chunks.push_back({v0, v1});
    }
    size_t w_beg = (size_t)(r.start >> kLinearShift);
    size_t w_end = (size_t)((std::max<int64_t>(r.end, r.start + 1) - 1) >>
                            kLinearShift);
    if (rb.linear.size() <= w_end) rb.linear.resize(w_end + 1, 0);
    for (size_t w = w_beg; w <= w_end; w++)
      if (rb.linear[w] == 0) rb.linear[w] = v0;
  }

  // fill empty linear slots with the next known offset (tabix convention is
  // the previous non-zero; using record start offsets keeps queries correct
  // since min_off only prunes)
  for (auto& rb : refs) {
    int64_t last = 0;
    for (auto& v : rb.linear) {
      if (v == 0)
        v = last;
      else
        last = v;
    }
  }

  std::string tbi_path = std::string(path) + ".tbi";
  gzFile gz = gzopen(tbi_path.c_str(), "wb");
  if (!gz) return -1;
  auto w32 = [&](int32_t v) { gzwrite(gz, &v, 4); };
  auto w64 = [&](int64_t v) { gzwrite(gz, &v, 8); };
  gzwrite(gz, "TBI\1", 4);
  w32((int32_t)names.size());
  w32(0x10000);  // generic format, zero-based (BED semantics)
  w32(1);        // col_seq
  w32(2);        // col_beg
  w32(3);        // col_end
  w32('#');
  w32(0);
  int32_t l_nm = 0;
  for (auto& n : names) l_nm += (int32_t)n.size() + 1;
  w32(l_nm);
  for (auto& n : names) gzwrite(gz, n.c_str(), (unsigned)n.size() + 1);
  for (auto& rb : refs) {
    w32((int32_t)rb.bins.size());
    for (auto& [bin, chunks] : rb.bins) {
      w32((int32_t)bin);
      w32((int32_t)chunks.size());
      for (auto& c : chunks) {
        w64(c.beg);
        w64(c.end);
      }
    }
    w32((int32_t)rb.linear.size());
    for (int64_t v : rb.linear) w64(v);
  }
  gzclose(gz);
  return 0;
}

}  // extern "C"
