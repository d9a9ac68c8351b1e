// TIFF's ZSTD compression (50000): one strip or tile is one Zstandard
// frame (RFC 8878), which libtiff 4.7.1's ZSTDDecode hands to libzstd
// 1.5.7's ZSTD_decompressStream until the strip's buffer is full, the
// frame ends or libzstd fails; any libzstd error fails the strip ("Error
// in ZSTD_decompressStream()"), and so does a frame that ends short ("Not
// enough data"). A frame ending returns 0 and ends libtiff's loop: a second
// frame in the strip, or one after a leading skippable frame, is never
// read.
//
// ZSTD_decompressStream takes one of two paths, and they differ:
//   - single pass, where the frame states its content size, the strip's
//     buffer holds it and the whole frame (block sizes walked, checksum
//     included) lies in the strip: the frame is decoded whole, so an error
//     anywhere in it fails the strip, and the window size is not checked;
//   - streaming otherwise: the window (at least 1 KiB) may not pass 2^27 + 1
//     bytes, blocks are decoded one at a time into a buffer of window + 2
//     blocks + 64 bytes (or the content size, if smaller) and copied out,
//     and decoding stops once the strip's buffer cannot take a block's bytes
//     (a block that exactly fills it is followed by one more block, or the
//     checksum, which can still fail it). A block of size 0 is skipped
//     there (the single pass fails on it), and a block's data may reach
//     back only over the buffer's current and previous segments
//     (ZSTD_checkContinuity's extDict).
//
// What a block checks is libzstd's: the literals section (raw, RLE,
// Huffman in 1 or 4 streams, treeless; sizes against the block maximum
// and the room left), Huffman weights (direct, or FSE-coded with two
// interleaved states), FSE table descriptions (FSE_readNCount, bit for
// bit), the sequences' tables (predefined, RLE, FSE, repeat), their
// bitstream to the exact bit, offsets within the history and the repeat
// offsets, the block size limit, the frame content size and the XXH64
// checksum. Dictionary IDs fail (no dictionary is loaded).
//
// Included by native_runtime.cpp inside its anonymous namespace.

// ------------------------------------------------------------ XXH64
struct Xxh64 {
  static constexpr uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
                            P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
                            P5 = 0x27D4EB2F165667C5ull;
  uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
  uint8_t mem[32];
  size_t fill = 0;
  uint64_t total = 0;
  static uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
  static uint64_t le64(const uint8_t* p) {
    uint64_t x = 0;
    for (int i = 7; i >= 0; --i) x = (x << 8) | p[i];
    return x;
  }
  static uint64_t round(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
  static uint64_t merge(uint64_t acc, uint64_t val) { return (acc ^ round(0, val)) * P1 + P4; }
  void update(const uint8_t* p, size_t n) {
    total += n;
    for (size_t i = 0; i < n; ++i) {
      mem[fill++] = p[i];
      if (fill == 32) {
        for (int k = 0; k < 4; ++k) v[k] = round(v[k], le64(mem + 8 * k));
        fill = 0;
      }
    }
  }
  uint64_t digest() const {
    uint64_t h;
    if (total >= 32) {
      h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
      for (int k = 0; k < 4; ++k) h = merge(h, v[k]);
    } else {
      h = v[2] + P5;
    }
    h += total;
    size_t i = 0;
    for (; i + 8 <= fill; i += 8) h = rotl(h ^ round(0, le64(mem + i)), 27) * P1 + P4;
    if (i + 4 <= fill) {
      const uint64_t w = (uint64_t)mem[i] | (uint64_t)mem[i + 1] << 8 | (uint64_t)mem[i + 2] << 16 |
                         (uint64_t)mem[i + 3] << 24;
      h = rotl(h ^ (w * P1), 23) * P2 + P3;
      i += 4;
    }
    for (; i < fill; ++i) h = rotl(h ^ (mem[i] * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
  }
};

// ------------------------------------------------- backward bitstream
// the `nbits` (at most 32) bits of p below bit `top`, most significant
// first; bits below bit 0 read as zeros
inline uint32_t zstd_bits_below(const uint8_t* p, int64_t top, int nbits) {
  if (nbits == 0 || top <= 0) return 0;
  const int64_t lo = top - nbits;
  const int64_t from = lo < 0 ? 0 : lo;
  const int64_t first = from >> 3, last = (top - 1) >> 3;
  uint64_t w = 0;
  for (int64_t i = last; i >= first; --i) w = (w << 8) | p[i];
  w >>= from & 7;
  const int got = (int)(top - from);
  const uint64_t v = w & ((got >= 64 ? 0 : (1ull << got)) - 1);
  return (uint32_t)(lo < 0 ? v << (-lo) : v);
}

// BIT_DStream: read from the last byte's marker bit down; `left` the bits
// not yet consumed (below 0: overflow, read as zeros)
struct ZstdBits {
  const uint8_t* p = nullptr;
  int64_t left = 0;
  bool init(const uint8_t* src, size_t n) {
    if (n == 0 || src[n - 1] == 0) return false;
    p = src;
    int hb = 7;
    while (!(src[n - 1] >> hb)) --hb;
    left = (int64_t)(n - 1) * 8 + hb;
    return true;
  }
  uint32_t peek(int nbits) const { return zstd_bits_below(p, left, nbits); }
  uint32_t read(int nbits) {
    const uint32_t v = peek(nbits);
    left -= nbits;
    return v;
  }
  bool overflow() const { return left < 0; }
  bool done() const { return left == 0; }
};

// --------------------------------------------------------------- FSE
// FSE_readNCount, bit for bit; returns the header's size or 0 on error
size_t zstd_read_ncount(const uint8_t* hb, size_t hb_size, int16_t* norm, unsigned& max_sv,
                        unsigned& table_log) {
  if (hb_size < 8) {
    uint8_t buf[8] = {0};
    std::memcpy(buf, hb, hb_size);
    const size_t n = zstd_read_ncount(buf, 8, norm, max_sv, table_log);
    return n > hb_size ? 0 : n;
  }
  const uint8_t* istart = hb;
  const uint8_t* iend = hb + hb_size;
  const uint8_t* ip = istart;
  auto le32 = [](const uint8_t* q) {
    return (uint32_t)q[0] | (uint32_t)q[1] << 8 | (uint32_t)q[2] << 16 | (uint32_t)q[3] << 24;
  };
  const unsigned max_sv1 = max_sv + 1;
  std::fill(norm, norm + max_sv1, 0);
  uint32_t stream = le32(ip);
  int nbits = (int)(stream & 0xF) + 5;
  if (nbits > 15) return 0;
  stream >>= 4;
  int count_bits = 4;
  table_log = (unsigned)nbits;
  int remaining = (1 << nbits) + 1, threshold = 1 << nbits;
  ++nbits;
  unsigned charnum = 0;
  bool previous0 = false;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
      ip += count_bits >> 3;
      count_bits &= 7;
    } else {
      count_bits -= (int)(8 * (iend - 4 - ip));
      count_bits &= 31;
      ip = iend - 4;
    }
    stream = le32(ip) >> count_bits;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~stream | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          count_bits -= (int)(8 * (iend - 7 - ip));
          count_bits &= 31;
          ip = iend - 4;
        }
        stream = le32(ip) >> count_bits;
        repeats = __builtin_ctz(~stream | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      stream >>= 2 * repeats;
      count_bits += 2 * repeats;
      charnum += stream & 3;
      count_bits += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    {
      const int mx = (2 * threshold - 1) - remaining;
      int count;
      if ((int)(stream & (threshold - 1)) < mx) {
        count = (int)(stream & (threshold - 1));
        count_bits += nbits - 1;
      } else {
        count = (int)(stream & (2 * threshold - 1));
        if (count >= threshold) count -= mx;
        count_bits += nbits;
      }
      --count;
      if (count >= 0) remaining -= count;
      else remaining += count;
      norm[charnum++] = (int16_t)count;
      previous0 = count == 0;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nbits = 31 - __builtin_clz((uint32_t)remaining) + 1;
        threshold = 1 << (nbits - 1);
      }
      if (charnum >= max_sv1) break;
      advance();
    }
  }
  if (remaining != 1) return 0;
  if (charnum > max_sv1) return 0;
  if (count_bits > 32) return 0;
  max_sv = charnum - 1;
  ip += (count_bits + 7) >> 3;
  return (size_t)(ip - istart);
}

struct ZstdFseEntry {
  uint16_t symbol, next;  // next: the state's baseline
  uint8_t nbits;
};

// FSE_buildDTable / ZSTD_buildFSETable's spread and states
void zstd_build_fse(const int16_t* norm, unsigned max_sv, unsigned table_log,
                    std::vector<ZstdFseEntry>& table) {
  const uint32_t size = 1u << table_log;
  table.assign(size, {});
  std::vector<uint32_t> next(max_sv + 1);
  uint32_t high = size - 1;
  for (unsigned s = 0; s <= max_sv; ++s) {
    if (norm[s] == -1) {
      table[high--].symbol = (uint16_t)s;
      next[s] = 1;
    } else {
      next[s] = (uint32_t)std::max<int16_t>(norm[s], 0);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (unsigned s = 0; s <= max_sv; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      table[pos].symbol = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  for (uint32_t u = 0; u < size; ++u) {
    const uint32_t s = table[u].symbol, ns = next[s]++;
    const int nb = (int)table_log - (31 - __builtin_clz(ns));
    table[u].nbits = (uint8_t)nb;
    table[u].next = (uint16_t)((ns << nb) - size);
  }
}

// FSE_decompress_wksp of Huffman weights: at most 255, two interleaved states
bool zstd_fse_weights(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  int16_t norm[256];
  unsigned max_sv = 255, table_log;
  const size_t hs = zstd_read_ncount(src, n, norm, max_sv, table_log);
  if (!hs || table_log > 6) return false;
  // HUF_readStats' workspace holds the table of a 6-bit log over weights
  // 0-11 (FSE_DECOMPRESS_WKSP_SIZE_U32(6, 11) = 219 words)
  const size_t tsize = (size_t)1 << table_log;
  if ((1 + tsize) + 1 + (2 * (max_sv + 1) + tsize + 8 + 3) / 4 + 128 + 1 > 219) return false;
  std::vector<ZstdFseEntry> table;
  zstd_build_fse(norm, max_sv, table_log, table);
  ZstdBits bits;
  if (!bits.init(src + hs, n - hs)) return false;
  uint32_t s1 = bits.read((int)table_log), s2 = bits.read((int)table_log);
  if (bits.overflow()) return false;
  out.clear();
  uint32_t* st[2] = {&s1, &s2};
  for (int k = 0;; k ^= 1) {
    if (out.size() > 253) return false;  // "dstSize_tooSmall"
    uint32_t& s = *st[k];
    out.push_back((uint8_t)table[s].symbol);
    s = table[s].next + bits.read(table[s].nbits);
    if (bits.overflow()) {
      out.push_back((uint8_t)table[*st[k ^ 1]].symbol);
      return true;
    }
  }
}

// ----------------------------------------------------------- Huffman
struct ZstdHuff {
  int log = 0;
  bool x2 = false;  // the DTable's type: HUF_selectDecoder's choice when it was read
  std::vector<uint8_t> sym, nbits;  // by the next `log` bits
};

// HUF_readStats and the X1 table; returns the description's size or 0
size_t zstd_read_huffman(const uint8_t* src, size_t n, ZstdHuff& h) {
  if (n == 0) return 0;
  std::vector<uint8_t> w;
  size_t isize = src[0];
  if (isize >= 128) {
    const size_t osize = isize - 127;
    isize = (osize + 1) / 2;
    if (isize + 1 > n) return 0;
    for (size_t i = 0; i < osize; i += 2) {
      w.push_back(src[1 + i / 2] >> 4);
      w.push_back(src[1 + i / 2] & 15);
    }
    w.resize(osize);
  } else {
    if (isize + 1 > n) return 0;
    if (!zstd_fse_weights(src + 1, isize, w)) return 0;
  }
  uint32_t rank[13] = {0}, total = 0;
  for (uint8_t x : w) {
    if (x > 12) return 0;
    ++rank[x];
    total += (1u << x) >> 1;
  }
  if (total == 0) return 0;
  const int log = 31 - __builtin_clz(total) + 1;
  if (log > 12) return 0;
  const uint32_t rest = (1u << log) - total;
  const int hb = 31 - __builtin_clz(rest);
  if ((1u << hb) != rest) return 0;
  w.push_back((uint8_t)(hb + 1));
  ++rank[hb + 1];
  if (rank[1] < 2 || (rank[1] & 1)) return 0;
  h.log = log;
  h.sym.assign((size_t)1 << log, 0);
  h.nbits.assign((size_t)1 << log, 0);
  size_t pos = 0;
  for (int weight = 1; weight <= log; ++weight)
    for (size_t s = 0; s < w.size(); ++s)
      if (w[s] == weight) {
        const size_t k = (size_t)1 << (weight - 1);
        std::fill(h.sym.begin() + pos, h.sym.begin() + pos + k, (uint8_t)s);
        std::fill(h.nbits.begin() + pos, h.nbits.begin() + pos + k, (uint8_t)(log + 1 - weight));
        pos += k;
      }
  return isize + 1;
}

// a Huffman stream read as BIT_DStream reads it: from `left` bits above
// `base` down, zeros below base while bitsConsumed < 64, and past that the
// 64-bit container at base read again from its top (`wrap`: its shift
// count taken mod 64, where a reader never stops at base)
struct ZstdHuffReader {
  const uint8_t* base;
  int64_t left;
  bool wrap;
  uint32_t peek(int nbits) const {
    int64_t top = left;
    if (top < 0 && wrap) top = 64 - ((-top) & 63);
    return zstd_bits_below(base, top, nbits);
  }
};

int zstd_huff_log(const ZstdHuff& h) { return std::max(h.log, 11); }

// one stream of `count` symbols, to its exact end (HUF_decompress1X1, the
// 4X1 fallback); `x2`: an X2 table's last symbol, whose second code may
// run past the end (bitsConsumed then clamped to the end: it passes)
bool zstd_huff_stream(const ZstdHuff& h, const uint8_t* src, size_t n, uint8_t* out, size_t count,
                      bool x2) {
  ZstdBits bits;
  if (!bits.init(src, n)) return false;
  for (size_t i = 0; i < count; ++i) {
    const uint32_t v = bits.peek(h.log);
    out[i] = h.sym[v];
    if (x2 && i + 1 == count) {
      // HUF_decodeLastSymbolX2: the lookup's second code, where the bits
      // after the first hold a whole one within the table's log
      const int dlog = zstd_huff_log(h), l1 = h.nbits[v];
      const uint32_t w = bits.peek(dlog);
      const uint32_t rest = (w << l1) & ((1u << dlog) - 1);
      const int l2 = h.nbits[rest >> (dlog - h.log)];
      if (l1 + l2 > dlog) {
        bits.left -= l1;
      } else if (bits.left > 0) {
        bits.left = std::max<int64_t>(bits.left - l1 - l2, 0);
      }
      break;
    }
    bits.left -= h.nbits[v];
  }
  return bits.done();
}

// HUF_decompress4X: the fast loop where every stream has 8 bytes and the
// table's log is 11, else one stream at a time to their exact ends
bool zstd_huff_decode(const ZstdHuff& h, bool four, bool x2, const uint8_t* src, size_t n,
                      uint8_t* out, size_t count) {
  if (!four) return zstd_huff_stream(h, src, n, out, count, x2);
  if (n < 10 || count < 6) return false;
  const size_t l1 = src[0] | src[1] << 8, l2 = src[2] | src[3] << 8, l3 = src[4] | src[5] << 8;
  if (l1 + l2 + l3 + 6 > n) return false;
  const size_t l4 = n - 6 - l1 - l2 - l3;
  const size_t seg = (count + 3) / 4;
  const size_t lens[4] = {l1, l2, l3, l4};
  const size_t outs[4] = {seg, seg, seg, count - std::min(count, 3 * seg)};
  size_t starts[4], ends[4];
  for (int k = 0; k < 4; ++k) {
    starts[k] = k ? ends[k - 1] : 6;
    ends[k] = starts[k] + lens[k];
  }
  const bool fast = zstd_huff_log(h) == 11 && l1 >= 8 && l2 >= 8 && l3 >= 8 && l4 >= 8 &&
                    3 * seg < count;
  if (!fast) {
    if (3 * seg > count) return false;
    bool ok = true;
    for (int k = 0; k < 4; ++k) {
      ZstdBits probe;
      if (!probe.init(src + starts[k], lens[k])) return false;
    }
    for (int k = 0; k < 4; ++k)
      ok = zstd_huff_stream(h, src + starts[k], lens[k], out + k * seg, outs[k], x2) && ok;
    return ok;
  }
  // HUF_decompress4X1_usingDTable_internal_fast: each stream read down to
  // the jump table (ilowest); bulk rounds of 5 symbols a stream while the
  // first stream has 7 bytes a round above ilowest and the fourth 5 symbols
  // left; then each stream finished to its segment's end, unchecked, unless
  // the bulk rounds took it a byte past its own start
  ZstdHuffReader r[4];
  size_t done[4] = {0, 0, 0, 0};
  for (int k = 0; k < 4; ++k) {
    const uint8_t last = src[ends[k] - 1];
    int hb = 7;
    while (last && !(last >> hb)) --hb;
    r[k] = {src, (int64_t)ends[k] * 8 - (last ? 8 - hb : 0), false};
  }
  const int dlog = zstd_huff_log(h);
  auto one = [&](int k) {
    const uint32_t v = r[k].peek(dlog) >> (dlog - h.log);
    out[k * seg + done[k]++] = h.sym[v];
    r[k].left -= h.nbits[v];
  };
  // ip[k] - ilowest, the byte whose container holds the next bits
  auto ip = [&](int k) { return (int64_t)ends[k] - 8 - ((int64_t)ends[k] * 8 - r[k].left) / 8; };
  while (true) {
    const size_t oiters = (outs[3] - done[3]) / 5;
    const int64_t i0 = ip(0);
    const size_t iiters = i0 > 0 ? (size_t)(i0 / 7) : 0;
    const size_t iters = std::min(oiters, iiters);
    if (iters == 0) break;
    bool crossed = false;
    for (int k = 1; k < 4; ++k) crossed = crossed || ip(k) < ip(k - 1);
    if (crossed) break;
    for (size_t it = 0; it < iters; ++it)
      for (int sy = 0; sy < 5; ++sy)
        for (int k = 0; k < 4; ++k) one(k);
  }
  for (int k = 0; k < 4; ++k) {
    if (ip(k) < (int64_t)starts[k] - 8) return false;
    r[k].wrap = true;
    while (done[k] < outs[k]) one(k);
  }
  return true;
}

// HUF_selectDecoder: X2 (double-symbol) where its estimated time is shorter
bool zstd_huff_x2(size_t dst, size_t csrc) {
  static const uint32_t t[16][4] = {
      {0, 0, 1, 1}, {0, 0, 1, 1}, {150, 216, 381, 119}, {170, 205, 514, 112},
      {177, 199, 539, 110}, {197, 194, 644, 107}, {221, 192, 735, 107}, {256, 189, 881, 106},
      {359, 188, 1167, 109}, {582, 187, 1570, 114}, {688, 187, 1712, 122},
      {825, 186, 1965, 136}, {976, 185, 2131, 150}, {1180, 186, 2070, 175},
      {1377, 185, 1731, 202}, {1412, 185, 1695, 202}};
  const uint32_t q = csrc >= dst ? 15 : (uint32_t)(csrc * 16 / dst);
  const uint32_t d256 = (uint32_t)(dst >> 8);
  const uint32_t t0 = t[q][0] + t[q][1] * d256;
  uint32_t t1 = t[q][2] + t[q][3] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// -------------------------------------------------------- sequences
const uint32_t kZstdLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                                  12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kZstdLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kZstdMLBase[53] = {3,  4,  5,  6,  7,   8,   9,   10,   11,   12,   13,    14,    15,   16,
                                  17, 18, 19, 20, 21,  22,  23,  24,   25,   26,   27,    28,    29,   30,
                                  31, 32, 33, 34, 35,  37,  39,  41,   43,   47,   51,    59,    67,   83,
                                  99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kZstdMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kZstdLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kZstdMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kZstdOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct ZstdSeqTable {
  int log = 0;
  std::vector<ZstdFseEntry> t;
};

// --------------------------------------------------------- the frame
struct ZstdFrame {
  bool checksum = false;
  uint64_t fcs = UINT64_MAX, window = 0, block_max = 0;
  uint32_t dict_id = 0;
  size_t header_size = 0;
};

// ZSTD_getFrameHeader: 1 decoded, 0 needs more bytes, -1 an error,
// 2 a skippable frame
int zstd_frame_header(const uint8_t* d, size_t n, ZstdFrame& f) {
  if (n < 5) {
    uint8_t m[4] = {0x28, 0xB5, 0x2F, 0xFD};
    std::memcpy(m, d, std::min<size_t>(n, 4));
    const uint32_t v = m[0] | m[1] << 8 | m[2] << 16 | (uint32_t)m[3] << 24;
    if (v != 0xFD2FB528u) {
      uint8_t k[4] = {0x50, 0x2A, 0x4D, 0x18};
      std::memcpy(k, d, std::min<size_t>(n, 4));
      const uint32_t u = k[0] | k[1] << 8 | k[2] << 16 | (uint32_t)k[3] << 24;
      if ((u & 0xFFFFFFF0u) != 0x184D2A50u) return -1;
    }
    return 0;
  }
  const uint32_t magic = d[0] | d[1] << 8 | d[2] << 16 | (uint32_t)d[3] << 24;
  if (magic != 0xFD2FB528u) return (magic & 0xFFFFFFF0u) == 0x184D2A50u ? 2 : -1;
  const uint8_t fhd = d[4];
  static const size_t did_size[4] = {0, 1, 2, 4}, fcs_size[4] = {0, 2, 4, 8};
  const bool single = (fhd >> 5) & 1;
  const size_t hs = 5 + !single + did_size[fhd & 3] + fcs_size[fhd >> 6] +
                    (single && !(fhd >> 6) ? 1 : 0);
  if (n < hs) return 0;
  if (fhd & 0x08) return -1;
  size_t pos = 5;
  f = ZstdFrame();
  if (!single) {
    const uint8_t wb = d[pos++];
    const unsigned wlog = (wb >> 3) + 10;
    if (wlog > 31) return -1;
    f.window = 1ull << wlog;
    f.window += (f.window >> 3) * (wb & 7);
  }
  for (size_t i = 0; i < did_size[fhd & 3]; ++i) f.dict_id |= (uint32_t)d[pos + i] << (8 * i);
  pos += did_size[fhd & 3];
  switch (fhd >> 6) {
    case 0: if (single) f.fcs = d[pos]; break;
    case 1: f.fcs = (d[pos] | d[pos + 1] << 8) + 256u; break;
    case 2: f.fcs = (uint64_t)(d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16) | (uint64_t)d[pos + 3] << 24; break;
    default:
      f.fcs = 0;
      for (int i = 7; i >= 0; --i) f.fcs = (f.fcs << 8) | d[pos + i];
  }
  if (single) f.window = f.fcs;
  f.block_max = std::min<uint64_t>(f.window, 128 * 1024);
  f.checksum = (fhd >> 2) & 1;
  f.header_size = hs;
  return 1;
}

// one frame's decoding state (ZSTD_DCtx's): entropy, repeat offsets and
// the history a block may reach back over, as offsets into `buf`
struct ZstdState {
  std::vector<uint8_t>* buf = nullptr;
  uint64_t block_max = 0;
  bool streaming = false;
  bool lit_entropy = false, fse_entropy = false;
  ZstdHuff huff;
  ZstdSeqTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  // ZSTD_checkContinuity: the current segment starts at prefix; the one
  // before, [ext_start, ext_end), reads as if it lay just before it
  bool have_prev = false;
  size_t prev_end = 0, prefix = 0, ext_start = 0, ext_end = 0;
  Xxh64 xxh;

  void continuity(size_t dst) {
    if (!have_prev || dst != prev_end) {
      if (have_prev) {
        ext_start = prefix;
        ext_end = prev_end;
      } else {
        ext_start = ext_end = dst;
      }
      prefix = dst;
      prev_end = dst;
      have_prev = true;
    }
  }

  bool build_table(int mode, const uint8_t*& ip, const uint8_t* iend, unsigned max,
                   unsigned max_log, const int16_t* def, unsigned def_max, unsigned def_log,
                   ZstdSeqTable& t) {
    switch (mode) {
      case 0:
        t.log = (int)def_log;
        zstd_build_fse(def, def_max, def_log, t.t);
        return true;
      case 1:
        if (ip >= iend || *ip > max) return false;
        t.log = 0;
        t.t.assign(1, ZstdFseEntry{*ip, 0, 0});
        ++ip;
        return true;
      case 2: {
        int16_t norm[64];
        unsigned mx = max, log;
        const size_t hs = zstd_read_ncount(ip, (size_t)(iend - ip), norm, mx, log);
        if (!hs || log > max_log) return false;
        t.log = (int)log;
        zstd_build_fse(norm, mx, log, t.t);
        ip += hs;
        return true;
      }
      default:
        return fse_entropy;
    }
  }

  // ZSTD_decompressBlock_internal: a compressed block into buf[dst, dst +
  // cap); its size, or -1
  int64_t compressed(const uint8_t* src, size_t n, size_t dst, size_t cap) {
    if (n > block_max) return -1;
    if (n < 2) return -1;
    const uint8_t* ip = src;
    const int lit_type = src[0] & 3, lhl = (src[0] >> 2) & 3;
    const size_t expected = (size_t)std::min<uint64_t>(block_max, cap);
    std::vector<uint8_t> lits;
    size_t lit_size, used;
    if (lit_type <= 1) {
      size_t lh;
      if (lhl == 0 || lhl == 2) {
        lh = 1;
        lit_size = src[0] >> 3;
      } else if (lhl == 1) {
        lh = 2;
        if (lit_type == 1 && n < 3) return -1;
        lit_size = (src[0] | src[1] << 8) >> 4;
      } else {
        lh = 3;
        if (n < (lit_type == 1 ? 4u : 3u)) return -1;
        lit_size = (src[0] | src[1] << 8 | src[2] << 16) >> 4;
      }
      if (lit_size > block_max || expected < lit_size) return -1;
      if (lit_type == 0) {
        if (lit_size + lh > n) return -1;
        lits.assign(src + lh, src + lh + lit_size);
        used = lh + lit_size;
      } else {
        lits.assign(lit_size, src[lh]);
        used = lh + 1;
      }
    } else {
      if (lit_type == 3 && !lit_entropy) return -1;
      if (n < 5) return -1;
      const uint32_t lhc = src[0] | src[1] << 8 | src[2] << 16 | (uint32_t)src[3] << 24;
      size_t lh, csize;
      bool single = false;
      if (lhl <= 1) {
        single = lhl == 0;
        lh = 3;
        lit_size = (lhc >> 4) & 0x3FF;
        csize = (lhc >> 14) & 0x3FF;
      } else if (lhl == 2) {
        lh = 4;
        lit_size = (lhc >> 4) & 0x3FFF;
        csize = lhc >> 18;
      } else {
        lh = 5;
        lit_size = (lhc >> 4) & 0x3FFFF;
        csize = (lhc >> 22) + ((size_t)src[4] << 10);
      }
      if (lit_size > block_max) return -1;
      if (!single && lit_size < 6) return -1;
      if (csize + lh > n) return -1;
      if (expected < lit_size) return -1;
      const uint8_t* hs = src + lh;
      size_t hn = csize;
      if (lit_type == 2) {
        if (hn == 0) return -1;
        const size_t d = zstd_read_huffman(hs, hn, huff);
        if (!d || d >= hn) return -1;
        hs += d;
        hn -= d;
      }
      // a new table is X1 for one stream (HUF_decompress1X1_DCtx_wksp), as
      // HUF_selectDecoder picks for four; a treeless section keeps its type
      if (lit_type == 2) huff.x2 = !single && zstd_huff_x2(lit_size, csize);
      lits.assign(lit_size, 0);
      if (!zstd_huff_decode(huff, !single, huff.x2, hs, hn, lits.data(), lit_size)) return -1;
      lit_entropy = true;
      used = lh + csize;
    }
    ip += used;
    const uint8_t* iend = src + n;
    // the sequences section
    if (ip >= iend) return -1;
    size_t nseq = *ip++;
    if (nseq > 0x7F) {
      if (nseq == 0xFF) {
        if (ip + 2 > iend) return -1;
        nseq = (ip[0] | ip[1] << 8) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) return -1;
        nseq = ((nseq - 0x80) << 8) + *ip++;
      }
    }
    std::vector<uint8_t>& b = *buf;
    // the output may not run into the literals where libzstd keeps them
    // after the block in the strip's buffer (single pass, room to spare)
    const bool in_dst = !streaming && cap > block_max + 32 + lits.size() + 32;
    const size_t oend = dst + (in_dst ? (size_t)block_max + 32 : cap);
    size_t op = dst, lp = 0;
    if (nseq == 0) {
      if (ip != iend) return -1;
    } else {
      if (ip + 1 > iend) return -1;
      const uint8_t modes = *ip++;
      if (modes & 3) return -1;
      if (!build_table(modes >> 6, ip, iend, 35, 9, kZstdLLDefault, 35, 6, ll)) return -1;
      if (!build_table((modes >> 4) & 3, ip, iend, 31, 8, kZstdOFDefault, 28, 5, of)) return -1;
      if (!build_table((modes >> 2) & 3, ip, iend, 52, 9, kZstdMLDefault, 52, 6, ml)) return -1;
      fse_entropy = true;
      ZstdBits bits;
      if (!bits.init(ip, (size_t)(iend - ip))) return -1;
      uint32_t sll = bits.read(ll.log), sof = bits.read(of.log), sml = bits.read(ml.log);
      for (size_t k = 0; k < nseq; ++k) {
        const uint32_t llc = ll.t[sll].symbol, ofc = of.t[sof].symbol, mlc = ml.t[sml].symbol;
        uint64_t offset;
        if (ofc > 1) {
          offset = ((1ull << ofc) - 3) + bits.read((int)ofc);
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        } else {
          const bool ll0 = kZstdLLBase[std::min<uint32_t>(llc, 35)] == 0 && llc == 0;
          if (ofc == 0) {
            offset = rep[ll0];
            rep[1] = rep[!ll0];
            rep[0] = offset;
          } else {
            const uint64_t idx = 1 + ll0 + bits.read(1);
            uint64_t t = idx == 3 ? rep[0] - 1 : rep[idx];
            if (t == 0) t = UINT64_MAX;
            if (idx != 1) rep[2] = rep[1];
            rep[1] = rep[0];
            rep[0] = offset = t;
          }
        }
        const uint64_t mlen = kZstdMLBase[mlc] + bits.read(kZstdMLBits[mlc]);
        const uint64_t llen = kZstdLLBase[llc] + bits.read(kZstdLLBits[llc]);
        if (k + 1 < nseq) {
          sll = ll.t[sll].next + bits.read(ll.t[sll].nbits);
          sml = ml.t[sml].next + bits.read(ml.t[sml].nbits);
          sof = of.t[sof].next + bits.read(of.t[sof].nbits);
        }
        // ZSTD_execSequence
        if (llen + mlen > oend - op) return -1;
        if (llen > lits.size() - lp) return -1;
        copy_bytes(b.data() + op, lits.data() + lp, (size_t)llen);
        op += (size_t)llen;
        lp += (size_t)llen;
        const uint64_t in_prefix = op - prefix, reach = in_prefix + (ext_end - ext_start);
        if (offset > reach) return -1;
        uint64_t left = mlen;
        if (offset > in_prefix) {
          size_t from = ext_end - (size_t)(offset - in_prefix);
          while (left > 0 && from < ext_end) {
            b[op++] = b[from++];
            --left;
          }
          size_t p2 = prefix;
          while (left > 0) {
            b[op++] = b[p2++];
            --left;
          }
        } else {
          for (; left > 0; --left, ++op) b[op] = b[op - (size_t)offset];
        }
      }
      if (!bits.done()) return -1;
    }
    const size_t last = lits.size() - lp;
    if (last > oend - op) return -1;
    copy_bytes(b.data() + op, lits.data() + lp, last);
    op += last;
    return (int64_t)(op - dst);
  }

  // one block of either kind: its size, or -1
  int64_t block(int type, const uint8_t* src, size_t csize, size_t rle_size, size_t dst,
                size_t cap) {
    continuity(dst);
    int64_t r;
    if (type == 2) {
      r = compressed(src, csize, dst, cap);
    } else if (type == 0) {
      if (csize > cap) return -1;
      copy_bytes(buf->data() + dst, src, csize);
      r = (int64_t)csize;
    } else {
      if (rle_size > cap) return -1;
      std::memset(buf->data() + dst, src[0], rle_size);
      r = (int64_t)rle_size;
    }
    if (r < 0 || (uint64_t)r > block_max) return -1;
    prev_end = dst + (size_t)r;
    xxh.update(buf->data() + dst, (size_t)r);
    return r;
  }
};

// ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where the walk fails
size_t zstd_frame_size(const uint8_t* d, size_t n, const ZstdFrame& f) {
  size_t pos = f.header_size;
  while (true) {
    if (n - pos < 3) return 0;
    const uint32_t bh = d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16;
    const int type = (bh >> 1) & 3;
    if (type == 3) return 0;
    const size_t cs = type == 1 ? 1 : bh >> 3;
    if (3 + cs > n - pos) return 0;
    pos += 3 + cs;
    if (bh & 1) break;
  }
  if (f.checksum) {
    if (n - pos < 4) return 0;
    pos += 4;
  }
  return pos;
}

// ZSTDDecode of one strip or tile: its bytes → `expect` bytes, or false
// where libtiff fails it (`out` then holds what was flushed, then zeros)
bool zstd_decode(const uint8_t* d, size_t n, std::vector<uint8_t>& out, size_t expect) {
  out.assign(expect, 0);
  ZstdFrame f;
  if (zstd_frame_header(d, n, f) != 1) return false;
  if (f.dict_id) return false;  // "Dictionary mismatch"
  auto checksum_ok = [&](const ZstdState& st, size_t at) {
    if (!f.checksum) return true;
    if (n - at < 4) return false;
    const uint32_t want = d[at] | d[at + 1] << 8 | d[at + 2] << 16 | (uint32_t)d[at + 3] << 24;
    return (uint32_t)st.xxh.digest() == want;
  };
  ZstdState st;
  st.block_max = f.block_max;
  if (f.fcs != UINT64_MAX && f.fcs <= expect && zstd_frame_size(d, n, f)) {
    // the single pass into the strip's buffer
    st.buf = &out;
    size_t pos = f.header_size, op = 0;
    while (true) {
      const uint32_t bh = d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16;
      const int type = (bh >> 1) & 3;
      const size_t cs = type == 1 ? 1 : bh >> 3;
      const int64_t r = st.block(type, d + pos + 3, cs, bh >> 3, op, expect - op);
      if (r < 0) {
        std::fill(out.begin(), out.end(), 0);  // the position stays at 0: ZSTDDecode zeroes it all
        return false;
      }
      op += (size_t)r;
      pos += 3 + cs;
      if (bh & 1) break;
    }
    if (op == f.fcs && checksum_ok(st, pos) && op == expect) return true;
    std::fill(out.begin(), out.end(), 0);
    return false;
  }
  // streaming
  const uint64_t window = std::max<uint64_t>(f.window, 1024);
  if (window > (1ull << 27) + 1) return false;
  const uint64_t bsize = std::min<uint64_t>(window, 128 * 1024);
  const uint64_t ring = std::min<uint64_t>(f.fcs, window + 2 * bsize + 64);
  if (ring > ((uint64_t)1 << 31)) return false;
  // the buffer as far as this strip can reach into it: past the strip and
  // one more block, a block's output fails the block size check anyway
  const size_t held = (size_t)std::min<uint64_t>(ring, (uint64_t)expect + 2 * bsize + 128);
  std::vector<uint8_t> buf(held);
  st.buf = &buf;
  st.streaming = true;
  size_t pos = f.header_size, out_start = 0, op = 0;
  uint64_t decoded = 0;
  while (true) {
    if (n - pos < 3) return op == expect;  // waits for more input
    const uint32_t bh = d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16;
    const int type = (bh >> 1) & 3;
    if (type == 3) return false;
    const size_t cs = type == 1 ? 1 : bh >> 3;
    if (cs > f.block_max) return false;  // "Block Size Exceeds Maximum"
    pos += 3;
    int64_t r = 0;
    if (cs > 0) {
      if (type == 0) {  // raw data streams in as it arrives
        const size_t k = std::min(cs, n - pos);
        r = st.block(0, d + pos, k, 0, out_start, held - out_start);
        if (r < 0) return false;
        pos += k;
        if (k < cs) {
          const size_t room = expect - op;
          const size_t copy = std::min<size_t>((size_t)r, room);
          copy_bytes(out.data() + op, buf.data() + out_start, copy);
          return op + copy == expect;
        }
      } else {
        if (n - pos < cs) return op == expect;
        r = st.block(type, d + pos, cs, bh >> 3, out_start, held - out_start);
        if (r < 0) return false;
        pos += cs;
      }
    }
    decoded += (uint64_t)r;
    if ((bh & 1) && f.fcs != UINT64_MAX && decoded != f.fcs) return false;
    // the flush
    const size_t room = expect - op;
    const size_t copy = std::min<size_t>((size_t)r, room);
    copy_bytes(out.data() + op, buf.data() + out_start, copy);
    op += copy;
    if (copy < (size_t)r) return true;  // the strip is full: no more decoding
    out_start += (size_t)r;
    if (ring < f.fcs && out_start + f.block_max > ring) out_start = 0;
    if (bh & 1) {
      if (f.checksum) {
        if (n - pos < 4) return op == expect;
        if (!checksum_ok(st, pos)) return false;
      }
      return op == expect;
    }
  }
}
