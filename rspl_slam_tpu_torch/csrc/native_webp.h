// WebP as PIL 12.1 reads it (WebPImagePlugin through libwebp 1.6.0's
// WebPAnimDecoder), then convert("L"):
//
//   - the RIFF container as libwebp's demuxer walks it: a simple "VP8 " or
//     "VP8L" file, or "VP8X" with ICCP / EXIF / XMP / ALPH / ANIM / ANMF
//     chunks; odd chunks padded; the RIFF size, each chunk size, the
//     canvas and every frame's bounds checked where the demuxer checks
//     them (a still image's frame must fill the canvas exactly);
//   - frame 0 decoded onto a zero RGBA canvas of the VP8X size at its ANMF
//     offset (the first frame is a key frame: nothing blends), alpha not
//     premultiplied; L is the luma of R, G and B, so alpha is decoded only
//     so that a file libwebp refuses for its alpha is refused here;
//   - VP8L (lossless, vp8l_dec.c): Huffman codes (simple and
//     length-coded), meta Huffman groups, LZ77 with the 120-entry distance
//     map, the colour cache, the predictor (14 modes), cross-colour,
//     subtract-green and colour-indexing transforms (pixel bundling
//     included); the bit reader's end of stream is libwebp's: reading past
//     the last bit fails the decode, and a stream shorter than 8 bytes
//     reads zeros up to 64 bits first;
//   - ALPH: raw or VP8L-compressed, filters 0-3, the pre-processing bits;
//   - VP8 (lossy): native_vp8.h.
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_pil.h and native_vp8.h.

const uint8_t kVp8lCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

inline uint32_t webp_le24(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16; }
inline uint32_t webp_le32(const uint8_t* p) { return webp_le24(p) | (uint32_t)p[3] << 24; }

// --------------------------------------------------------------- VP8L
// libwebp's VP8LBitReader: LSB first, zeros past the end; the end of
// stream is reading past max(8 · size, 64) bits
struct Vp8lBits {
  const uint8_t* d = nullptr;
  size_t n = 0, p = 0;
  uint64_t buf = 0, consumed = 0, limit = 0;
  int nb = 0;

  void init(const uint8_t* data, size_t size) {
    d = data;
    n = size;
    p = 0;
    buf = 0;
    nb = 0;
    consumed = 0;
    limit = std::max<uint64_t>(64, (uint64_t)size * 8);
  }
  void fill() {
    while (nb <= 56) {
      buf |= (uint64_t)(p < n ? d[p] : 0) << nb;
      ++p;
      nb += 8;
    }
  }
  uint32_t peek(int k) {
    if (nb < k) fill();
    return (uint32_t)(buf & ((1ull << k) - 1));
  }
  void skip(int k) {
    buf >>= k;
    nb -= k;
    consumed += (uint64_t)k;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool eos() const { return consumed > limit; }
};

// A canonical prefix code as libwebp's two-level tables hold it: 8 root
// bits, then second-level tables
struct Vp8lCode {
  uint8_t bits;
  uint16_t value;
};
constexpr int kVp8lRootBits = 8;

inline uint32_t vp8l_next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}
inline void vp8l_replicate(Vp8lCode* table, int step, int end, Vp8lCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

// BuildHuffmanTable: false for an over-subscribed or incomplete code (one
// used symbol alone is a code of no bits), or all lengths zero
bool vp8l_build(std::vector<Vp8lCode>& out, int root_bits, const int* lengths, int size) {
  int count[16] = {0}, offset[16];
  for (int s = 0; s < size; ++s) {
    if (lengths[s] > 15) return false;
    ++count[lengths[s]];
  }
  if (count[0] == size) return false;
  offset[1] = 0;
  for (int len = 1; len < 15; ++len) {
    if (count[len] > (1 << len)) return false;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(size);
  for (int s = 0; s < size; ++s)
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = (uint16_t)s;
  const int total_root = 1 << root_bits;
  if (offset[15] == 1) {
    out.assign(total_root, Vp8lCode{0, sorted[0]});
    return true;
  }
  // the table's size, as BuildHuffmanTable counts it before filling
  int total = total_root;
  {
    int c[16];
    std::memcpy(c, count, sizeof(c));
    uint32_t key = 0, low = 0xffffffffu, mask = total_root - 1;
    int num_open = 1;
    for (int len = 1; len <= 15; ++len) {
      num_open <<= 1;
      num_open -= c[len];
      if (num_open < 0) return false;
      if (len <= root_bits) {
        for (; c[len] > 0; --c[len]) key = vp8l_next_key(key, len);
        continue;
      }
      for (; c[len] > 0; --c[len]) {
        if ((key & mask) != low) {
          int tl = len, left = 1 << (len - root_bits);
          while (tl < 15) {
            left -= c[tl];
            if (left <= 0) break;
            ++tl;
            left <<= 1;
          }
          total += 1 << (tl - root_bits);
          low = key & mask;
        }
        key = vp8l_next_key(key, len);
      }
    }
    if (num_open != 0) return false;
  }
  out.assign(total, Vp8lCode{0, 0});
  Vp8lCode* root = out.data();
  Vp8lCode* table = root;
  int table_bits = root_bits, table_size = 1 << table_bits, symbol = 0;
  uint32_t key = 0, low = 0xffffffffu, mask = total_root - 1;
  int len, step;
  for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1)
    for (; count[len] > 0; --count[len]) {
      vp8l_replicate(&table[key], step, table_size, Vp8lCode{(uint8_t)len, sorted[symbol++]});
      key = vp8l_next_key(key, len);
    }
  for (len = root_bits + 1, step = 2; len <= 15; ++len, step <<= 1)
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        int tl = len, left = 1 << (len - root_bits);
        while (tl < 15) {
          left -= count[tl];
          if (left <= 0) break;
          ++tl;
          left <<= 1;
        }
        table_bits = tl - root_bits;
        table_size = 1 << table_bits;
        low = key & mask;
        root[low].bits = (uint8_t)(table_bits + root_bits);
        root[low].value = (uint16_t)((table - root) - low);
      }
      vp8l_replicate(&table[key >> root_bits], step, table_size,
                     Vp8lCode{(uint8_t)(len - root_bits), sorted[symbol++]});
      key = vp8l_next_key(key, len);
    }
  return true;
}

inline int vp8l_read_symbol(const Vp8lCode* table, Vp8lBits& br) {
  uint32_t val = br.peek(24);
  table += val & ((1u << kVp8lRootBits) - 1);
  const int nbits = table->bits - kVp8lRootBits;
  if (nbits > 0) {
    br.skip(kVp8lRootBits);
    val = br.peek(16);
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.skip(table->bits);
  return table->value;
}

struct Vp8lTransform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct Vp8lGroup {
  std::vector<Vp8lCode> trees[5];  // green (+ lengths + cache), red, blue, alpha, distance
};

// The VP8L decoder over one image stream (a whole VP8L image, or the
// VP8L-compressed alpha plane, whose stream has no header)
struct Vp8lDecoder {
  Vp8lBits br;
  Vp8lTransform transforms[4];
  int next_transform = 0;
  uint32_t transforms_seen = 0;

  // the level-0 image's entropy set-up
  int cache_bits = 0;
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  std::vector<Vp8lGroup> groups;
  // every group libwebp keeps (all of them, or the used ones where it
  // remaps more than 1000 or more than the image's pixels) has one-symbol
  // red, blue and alpha codes: with no cache and colour indexing alone, an
  // alpha plane then takes libwebp's 8-bit path (Is8bOptimizable)
  bool rba_single = true;

  bool read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths);
  bool read_code(int alphabet, std::vector<Vp8lCode>& table, std::vector<int>& lengths);
  bool read_codes(int xsize, int ysize, int color_cache_bits, bool allow_recursion,
                  int& hbits, int& hxsize, std::vector<uint32_t>& himage,
                  std::vector<Vp8lGroup>& gs, bool& single);
  bool read_transform(int& xsize, int ysize);
  bool decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out);
  bool decode_data(uint32_t* data, int width, int height, int cbits, int hbits, int hxsize,
                   const std::vector<uint32_t>& himage, const std::vector<Vp8lGroup>& gs,
                   bool alpha8 = false);
  bool decode_image(int width, int height, std::vector<uint32_t>& argb, bool alpha = false);
};

const int kVp8lCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
                                      14, 15};
const int kVp8lAlphabet[5] = {256 + 24, 256, 256, 256, 40};

inline int vp8l_subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

bool Vp8lDecoder::read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths) {
  std::vector<Vp8lCode> table;
  if (!vp8l_build(table, 7, cl_lengths, 19)) return false;
  int max_symbol;
  if (br.read(1)) {
    const int length_nbits = 2 + 2 * (int)br.read(3);
    max_symbol = 2 + (int)br.read(length_nbits);
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0, prev = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const Vp8lCode& c = table[br.peek(7)];
    br.skip(c.bits);
    const int code_len = c.value;
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev = code_len;
    } else {
      static const int extra[3] = {2, 3, 7}, offsets[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = (int)br.read(extra[slot]) + offsets[slot];
      if (symbol + repeat > num_symbols) return false;
      const int v = code_len == 16 ? prev : 0;
      while (repeat-- > 0) lengths[symbol++] = v;
    }
    if (br.eos()) return false;
  }
  return true;
}

// ReadHuffmanCode
bool Vp8lDecoder::read_code(int alphabet, std::vector<Vp8lCode>& table,
                            std::vector<int>& lengths) {
  lengths.assign(std::max(alphabet, 256), 0);
  bool ok;
  if (br.read(1)) {  // simple code: one or two symbols of length 1
    const int num = (int)br.read(1) + 1;
    const int first8 = (int)br.read(1);
    lengths[br.read(first8 ? 8 : 1)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
    ok = true;
  } else {
    int cl[19] = {0};
    const int num_codes = (int)br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl[kVp8lCodeLengthOrder[i]] = (int)br.read(3);
    ok = read_code_lengths(cl, alphabet, lengths.data());
  }
  if (!ok || br.eos()) return false;
  return vp8l_build(table, kVp8lRootBits, lengths.data(), alphabet);
}

bool Vp8lDecoder::read_codes(int xsize, int ysize, int color_cache_bits, bool allow_recursion,
                             int& hbits, int& hxsize, std::vector<uint32_t>& himage,
                             std::vector<Vp8lGroup>& gs, bool& single) {
  int num_groups = 1;
  hbits = 0;
  hxsize = 0;
  himage.clear();
  if (allow_recursion && br.read(1)) {
    const int precision = 2 + (int)br.read(3);
    const int hx = vp8l_subsample(xsize, precision), hy = vp8l_subsample(ysize, precision);
    if (!decode_stream(hx, hy, false, &himage)) return false;
    hbits = precision;
    hxsize = hx;
    for (auto& v : himage) {
      v = (v >> 8) & 0xffff;
      if ((int)v >= num_groups) num_groups = (int)v + 1;
    }
  }
  if (br.eos()) return false;
  // every group up to the largest index is read and checked, used or not
  std::vector<char> used(num_groups, himage.empty() ? 1 : 0);
  for (auto v : himage) used[v] = 1;
  const bool remapped = num_groups > 1000 || (int64_t)num_groups > (int64_t)xsize * ysize;
  gs.assign(num_groups, Vp8lGroup());
  std::vector<int> lengths;
  std::vector<Vp8lCode> scratch;
  single = true;
  for (int i = 0; i < num_groups; ++i)
    for (int j = 0; j < 5; ++j) {
      const int alphabet = kVp8lAlphabet[j] + (j == 0 && color_cache_bits > 0 ? 1 << color_cache_bits : 0);
      std::vector<Vp8lCode>& table = used[i] ? gs[i].trees[j] : scratch;
      if (!read_code(alphabet, table, lengths)) return false;
      if (j >= 1 && j <= 3 && (used[i] || !remapped) && table[0].bits) single = false;
    }
  return true;
}

bool Vp8lDecoder::read_transform(int& xsize, int ysize) {
  const int type = (int)br.read(2);
  if (transforms_seen & (1u << type)) return false;
  transforms_seen |= 1u << type;
  Vp8lTransform& t = transforms[next_transform++];
  t.type = type;
  t.xsize = xsize;
  t.ysize = ysize;
  t.data.clear();
  switch (type) {
    case 0: case 1:  // predictor, cross-colour
      t.bits = 2 + (int)br.read(3);
      return decode_stream(vp8l_subsample(t.xsize, t.bits), vp8l_subsample(t.ysize, t.bits),
                           false, &t.data);
    case 3: {  // colour indexing
      const int num_colors = (int)br.read(8) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      xsize = vp8l_subsample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> pal;
      if (!decode_stream(num_colors, 1, false, &pal)) return false;
      // ExpandColorMap: entries added bytewise to the previous; the rest black
      const int final_n = 1 << (8 >> bits);
      t.data.assign(final_n, 0);
      t.data[0] = pal[0];
      uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* od = reinterpret_cast<const uint8_t*>(pal.data());
      for (int i = 4; i < 4 * num_colors && i < 4 * final_n; ++i)
        nd[i] = (uint8_t)(od[i] + nd[i - 4]);
      return true;
    }
    default:  // subtract green
      return true;
  }
}

// DecodeImageStream: transforms (level 0), colour cache, codes; a sub-image's
// pixels into out, the level-0 image's set-up kept for decode_image
bool Vp8lDecoder::decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>* out) {
  int txsize = xsize;
  if (level0)
    while (br.read(1))
      if (!read_transform(txsize, ysize)) return false;
  int cbits = 0;
  if (br.read(1)) {
    cbits = (int)br.read(4);
    if (cbits < 1 || cbits > 11) return false;
  }
  int hbits, hxsize;
  bool single;
  std::vector<uint32_t> himage;
  std::vector<Vp8lGroup> gs;
  if (!read_codes(txsize, ysize, cbits, level0, hbits, hxsize, himage, gs, single)) return false;
  if (level0) {
    rba_single = single;
    cache_bits = cbits;
    huffman_bits = hbits;
    huffman_xsize = hxsize;
    huffman_image.swap(himage);
    groups.swap(gs);
    return true;
  }
  out->assign((size_t)txsize * ysize, 0);
  return decode_data(out->data(), txsize, ysize, cbits, hbits, hxsize, himage, gs) && !br.eos();
}

// DecodeImageData over the whole image: literals, backward references and
// colour cache codes; reading past the stream's end fails it. With alpha8,
// DecodeAlphaData's rule instead: the end is checked after each literal or
// copy, and fails the plane only if pixels are left to decode
bool Vp8lDecoder::decode_data(uint32_t* data, int width, int height, int cbits, int hbits,
                              int hxsize, const std::vector<uint32_t>& himage,
                              const std::vector<Vp8lGroup>& gs, bool alpha8) {
  const size_t total = (size_t)width * height;
  std::vector<uint32_t> cache(cbits ? (size_t)1 << cbits : 0);
  const int cache_shift = 32 - cbits;
  size_t pos = 0, last_cached = 0;
  int col = 0, row = 0;
  auto group_at = [&](int x, int y) -> const Vp8lGroup& {
    return hbits ? gs[himage[(size_t)hxsize * (y >> hbits) + (x >> hbits)]] : gs[0];
  };
  auto flush_cache = [&]() {
    for (; last_cached < pos; ++last_cached)
      cache[(0x1e35a7bdu * data[last_cached]) >> cache_shift] = data[last_cached];
  };
  while (pos < total) {
    const Vp8lGroup& g = group_at(col, row);
    const int code = vp8l_read_symbol(g.trees[0].data(), br);
    if (!alpha8 && br.eos()) break;
    if (code < 256) {
      const int red = vp8l_read_symbol(g.trees[1].data(), br);
      const int blue = vp8l_read_symbol(g.trees[2].data(), br);
      const int alpha = vp8l_read_symbol(g.trees[3].data(), br);
      if (!alpha8 && br.eos()) break;
      data[pos++] = (uint32_t)alpha << 24 | (uint32_t)red << 16 | (uint32_t)code << 8 | blue;
      if (++col >= width) {
        col = 0;
        ++row;
        if (cbits) flush_cache();
      }
    } else if (code < 256 + 24) {
      auto prefix_value = [&](int sym) {
        if (sym < 4) return sym + 1;
        const int extra = (sym - 2) >> 1;
        const int offset = (2 + (sym & 1)) << extra;
        return offset + (int)br.read(extra) + 1;
      };
      const int length = prefix_value(code - 256);
      const int dist_symbol = vp8l_read_symbol(g.trees[4].data(), br);
      const int dist_code = prefix_value(dist_symbol);
      int dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        const int dc = kVp8lCodeToPlane[dist_code - 1];
        dist = (dc >> 4) * width + (8 - (dc & 0xf));
        if (dist < 1) dist = 1;
      }
      if (!alpha8 && br.eos()) break;
      if (pos < (size_t)dist || total - pos < (size_t)length) return false;
      for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (cbits) flush_cache();
    } else if (code < 256 + 24 + (cbits ? 1 << cbits : 0)) {
      flush_cache();
      data[pos++] = cache[code - 256 - 24];
      if (++col >= width) {
        col = 0;
        ++row;
        flush_cache();
      }
    } else {
      return false;
    }
    if (alpha8 && br.eos()) break;
  }
  return alpha8 ? !(br.eos() && pos < total) : !br.eos();
}

inline uint32_t vp8l_add(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t vp8l_avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t vp8l_clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t vp8l_select(uint32_t a, uint32_t b, uint32_t c) {  // a T, b L, c TL
  int s = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int av = (a >> sh) & 0xff, bv = (b >> sh) & 0xff, cv = (c >> sh) & 0xff;
    s += std::abs(bv - cv) - std::abs(av - cv);
  }
  return s <= 0 ? a : b;
}
inline uint32_t vp8l_clamped_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int v = (int)((c0 >> sh) & 0xff) + (int)((c1 >> sh) & 0xff) - (int)((c2 >> sh) & 0xff);
    out |= vp8l_clip255((uint32_t)v) << sh;
  }
  return out;
}
inline uint32_t vp8l_clamped_half(uint32_t c0, uint32_t c1) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int a = (c0 >> sh) & 0xff, b = (c1 >> sh) & 0xff;
    out |= vp8l_clip255((uint32_t)(a + (a - b) / 2)) << sh;
  }
  return out;
}
inline uint32_t vp8l_predict(int mode, const uint32_t* top, uint32_t left) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return vp8l_avg2(vp8l_avg2(left, top[1]), top[0]);
    case 6: return vp8l_avg2(left, top[-1]);
    case 7: return vp8l_avg2(left, top[0]);
    case 8: return vp8l_avg2(top[-1], top[0]);
    case 9: return vp8l_avg2(top[0], top[1]);
    case 10: return vp8l_avg2(vp8l_avg2(left, top[-1]), vp8l_avg2(top[0], top[1]));
    case 11: return vp8l_select(top[0], left, top[-1]);
    case 12: return vp8l_clamped_full(left, top[0], top[-1]);
    case 13: return vp8l_clamped_half(vp8l_avg2(left, top[0]), top[-1]);
    default: return 0xff000000u;  // 0, and 14, 15
  }
}

// the inverse transforms, last read first; pixels grow to each transform's
// width (colour indexing unbundles)
void vp8l_inverse(const Vp8lTransform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  switch (t.type) {
    case 0: {  // predictor
      uint32_t* out = px.data();
      out[0] = vp8l_add(out[0], 0xff000000u);
      for (int x = 1; x < w; ++x) out[x] = vp8l_add(out[x], out[x - 1]);
      const int tiles = vp8l_subsample(w, t.bits);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = out + (size_t)y * w;
        const uint32_t* modes = t.data.data() + (size_t)(y >> t.bits) * tiles;
        row[0] = vp8l_add(row[0], row[-w]);
        for (int x = 1; x < w; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = vp8l_add(row[x], vp8l_predict(mode, row + x - w, row[x - 1]));
        }
      }
      return;
    }
    case 1: {  // cross colour
      const int tiles = vp8l_subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = px.data() + (size_t)y * w;
        const uint32_t* codes = t.data.data() + (size_t)(y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          const uint32_t m = codes[x >> t.bits];
          const int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff);
          const int8_t r2b = (int8_t)((m >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = (int8_t)(argb >> 8);
          int nr = (argb >> 16) & 0xff, nb = argb & 0xff;
          nr += ((int)g2r * green) >> 5;
          nr &= 0xff;
          nb += ((int)g2b * green) >> 5;
          nb += ((int)r2b * (int8_t)nr) >> 5;
          nb &= 0xff;
          row[x] = (argb & 0xff00ff00u) | (uint32_t)nr << 16 | (uint32_t)nb;
        }
      }
      return;
    }
    case 2:  // subtract green
      for (auto& v : px) {
        const uint32_t g = (v >> 8) & 0xff;
        const uint32_t rb = ((v & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
        v = (v & 0xff00ff00u) | rb;
      }
      return;
    case 3: {  // colour indexing
      const int bpp = 8 >> t.bits;
      const int packed_w = vp8l_subsample(w, t.bits);
      std::vector<uint32_t> out((size_t)w * h);
      for (int y = 0; y < h; ++y) {
        const uint32_t* src = px.data() + (size_t)y * packed_w;
        uint32_t* dst = out.data() + (size_t)y * w;
        if (bpp < 8) {
          const int count_mask = (1 << t.bits) - 1;
          const uint32_t bit_mask = (1u << bpp) - 1;
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bpp;
          }
        } else {
          for (int x = 0; x < w; ++x) dst[x] = t.data[(src[x] >> 8) & 0xff];
        }
      }
      px.swap(out);
      return;
    }
  }
}

// the level-0 image after its header: pixels as ARGB (an alpha plane's:
// by DecodeAlphaData's rule where libwebp takes its 8-bit path)
bool Vp8lDecoder::decode_image(int width, int height, std::vector<uint32_t>& argb, bool alpha) {
  if (!decode_stream(width, height, true, nullptr)) return false;
  int xs = width;  // the coded width: colour indexing bundles pixels
  for (int i = 0; i < next_transform; ++i)
    if (transforms[i].type == 3) xs = vp8l_subsample(transforms[i].xsize, transforms[i].bits);
  argb.assign((size_t)xs * height, 0);
  const bool alpha8 = alpha && next_transform == 1 && transforms[0].type == 3 &&
                      cache_bits == 0 && rba_single;
  if (!decode_data(argb.data(), xs, height, cache_bits, huffman_bits, huffman_xsize,
                   huffman_image, groups, alpha8))
    return false;
  for (int i = next_transform - 1; i >= 0; --i) vp8l_inverse(transforms[i], argb);
  return true;
}

// ------------------------------------------------------------ container
struct WebpFrame {
  size_t image_offset = 0, image_size = 0, alpha_offset = 0, alpha_size = 0;
  bool lossless = false;
  int x = 0, y = 0, w = 0, h = 0, frame_num = 0;
};

struct WebpInfo {
  int canvas_w = 0, canvas_h = 0;
  uint32_t flags = 0;
  bool ext = false;
  std::vector<WebpFrame> frames;
};

// VP8LGetInfo on a VP8L payload: the signature, the size and version 0
// (else kWebpVp8lVersion); br is left after the header
int vp8l_info(Vp8lBits& br, const uint8_t* d, size_t n, int& w, int& h) {
  if (n < 5 || d[0] != 0x2f) return kCorrupt;
  if ((d[4] >> 5) != 0) return kWebpVp8lVersion;
  br.init(d, n);
  br.read(8);
  w = (int)br.read(14) + 1;
  h = (int)br.read(14) + 1;
  br.read(1);  // alpha is used: a hint
  br.read(3);
  return kOk;
}

// StoreFrame: the ALPH and image chunks of one frame from mem[pos, end)
int webp_store_frame(const uint8_t* d, size_t& pos, size_t riff_end, int frame_num,
                     WebpFrame& f) {
  int alpha_chunks = 0, image_chunks = 0;
  if (riff_end - pos < 8) return kCorrupt;
  for (;;) {
    const size_t start = pos;
    const uint8_t* c = d + pos;
    const uint32_t payload = webp_le32(c + 4);
    if (payload > 0xfffffff6u) return kCorrupt;  // MAX_CHUNK_PAYLOAD
    const uint64_t padded = (uint64_t)payload + (payload & 1);
    if (padded > riff_end - pos - 8) return kCorrupt;  // SizeIsInvalid
    const size_t chunk = 8 + (size_t)padded;
    bool done = false;
    if (!std::memcmp(c, "ALPH", 4)) {
      if (alpha_chunks == 0) {
        ++alpha_chunks;
        f.alpha_offset = start;
        f.alpha_size = chunk;
        f.frame_num = frame_num;
        pos += chunk;
      } else {
        done = true;
      }
    } else if (!std::memcmp(c, "VP8L", 4) || !std::memcmp(c, "VP8 ", 4)) {
      const bool lossless = c[3] == 'L';
      if (lossless && alpha_chunks > 0) return kCorrupt;  // VP8L has its own alpha
      if (image_chunks == 0) {
        int w, h;
        Vp8lBits br;
        const int rc = lossless ? vp8l_info(br, c + 8, (size_t)padded, w, h)
                                : vp8_info(c + 8, (size_t)padded, payload, w, h);
        if (rc) return rc;
        ++image_chunks;
        f.image_offset = start;
        f.image_size = chunk;
        f.w = w;
        f.h = h;
        f.lossless = lossless;
        f.frame_num = frame_num;
        pos += chunk;
      } else {
        done = true;
      }
    } else {
      done = true;
    }
    if (done || pos == riff_end) break;
    if (riff_end - pos < 8) return kCorrupt;  // a partial chunk header in a complete file
  }
  return kOk;
}

// WebPDemux over the whole file, then IsValidSimpleFormat / IsValidExtendedFormat
int webp_demux(const uint8_t* d, size_t n, WebpInfo& info) {
  if (n < 20) return kCorrupt;
  const uint32_t riff_size = webp_le32(d + 4);
  if (riff_size < 8 || riff_size > 0xfffffff6u) return kCorrupt;
  const size_t riff_end = (size_t)riff_size + 8;
  if (n < riff_end) return kCorrupt;  // partial data: no demuxer
  size_t pos = 12;
  const uint8_t* c = d + pos;
  if (!std::memcmp(c, "VP8 ", 4) || !std::memcmp(c, "VP8L", 4)) {
    WebpFrame f;
    int rc = webp_store_frame(d, pos, riff_end, 1, f);
    if (rc) return rc;
    f.alpha_size = 0;  // no VP8X: no alpha flag, any ALPH is dropped
    if (!f.image_size || f.w <= 0 || f.h <= 0) return kCorrupt;
    info.canvas_w = f.w;
    info.canvas_h = f.h;
    info.frames.push_back(f);
  } else {  // VP8X
    if (riff_end - pos < 8) return kCorrupt;
    info.ext = true;
    uint32_t vp8x_size = webp_le32(c + 4);
    if (vp8x_size > 0xfffffff6u || vp8x_size < 10) return kCorrupt;
    vp8x_size += vp8x_size & 1;
    pos += 8;
    if (vp8x_size > riff_end - pos) return kCorrupt;
    info.flags = d[pos];
    info.canvas_w = 1 + (int)webp_le24(d + pos + 4);
    info.canvas_h = 1 + (int)webp_le24(d + pos + 7);
    if ((uint64_t)info.canvas_w * info.canvas_h >= (1ull << 32)) return kCorrupt;
    pos += vp8x_size;
    if (riff_end - pos < 8) return kCorrupt;
    const bool animation = info.flags & 0x02;
    int anim_chunks = 0;
    for (;;) {
      c = d + pos;
      const uint32_t size = webp_le32(c + 4);
      if (size > 0xfffffff6u) return kCorrupt;
      const uint64_t padded = (uint64_t)size + (size & 1);
      if (padded > riff_end - pos - 8) return kCorrupt;
      if (!std::memcmp(c, "VP8X", 4)) return kCorrupt;
      if (!std::memcmp(c, "ALPH", 4) || !std::memcmp(c, "VP8 ", 4) || !std::memcmp(c, "VP8L", 4)) {
        if (anim_chunks > 0 || animation) return kCorrupt;
        if (!info.frames.empty()) return kCorrupt;  // ParseSingleImage: one image
        WebpFrame f;
        int rc = webp_store_frame(d, pos, riff_end, 1, f);
        if (rc) return rc;
        if (!(info.flags & 0x10) && f.alpha_size) {  // no alpha flag: alpha dropped
          f.alpha_size = 0;
          f.alpha_offset = 0;
        }
        if (!f.image_size && !f.alpha_size) return kCorrupt;  // AddFrame: nothing stored
        info.frames.push_back(f);
      } else if (!std::memcmp(c, "ANIM", 4)) {
        if (padded < 6) return kCorrupt;
        if (anim_chunks == 0) ++anim_chunks;
        pos += 8 + (size_t)padded;
      } else if (!std::memcmp(c, "ANMF", 4)) {
        if (anim_chunks == 0) return kCorrupt;  // ANIM precedes frames
        if (padded < 16) return kCorrupt;
        pos += 8;
        const size_t payload_start = pos;
        WebpFrame f;
        f.x = 2 * (int)webp_le24(d + pos);
        f.y = 2 * (int)webp_le24(d + pos + 3);
        const int aw = 1 + (int)webp_le24(d + pos + 6), ah = 1 + (int)webp_le24(d + pos + 9);
        if ((uint64_t)aw * ah >= (1ull << 32)) return kCorrupt;
        pos += 16;
        const size_t anmf_payload = (size_t)padded - 16;
        int rc = webp_store_frame(d, pos, riff_end, (int)info.frames.size() + 1, f);
        if (rc) return rc;
        if (pos - (payload_start + 16) > anmf_payload) return kCorrupt;
        if (animation && f.frame_num > 0) {
          if (!f.image_size && !f.alpha_size) return kCorrupt;
          info.frames.push_back(f);
        }
      } else {  // ICCP, EXIF, XMP and unknown chunks
        pos += 8 + (size_t)padded;
      }
      if (pos == riff_end) break;
      if (riff_end - pos < 8) return kCorrupt;
    }
  }
  // IsValid*Format
  if (info.canvas_w <= 0 || info.canvas_h <= 0 || info.frames.empty()) return kCorrupt;
  if (info.ext) {
    if (info.flags & ~0x3eu) return kCorrupt;
    const bool animation = info.flags & 0x02;
    for (const WebpFrame& f : info.frames) {
      if (!animation && f.frame_num > 1) return kCorrupt;
      if (!f.image_size && !f.alpha_size) return kCorrupt;
      if (f.alpha_size && f.alpha_offset > f.image_offset) return kCorrupt;
      if (!f.image_size || f.w <= 0 || f.h <= 0) return kCorrupt;
      if (!animation) {
        if (f.x || f.y || f.w != info.canvas_w || f.h != info.canvas_h) return kCorrupt;
      } else if (f.w + f.x > info.canvas_w || f.h + f.y > info.canvas_h) {
        return kCorrupt;
      }
    }
  }
  return kOk;
}

// ALPHInit and the alpha plane's decode, whose values L does not use: a
// compression method above 1, pre-processing above 1 or reserved bits set
// are kWebpAlpha (filters 0-3 are all valid); raw data shorter than the
// plane, or a VP8L stream that fails, corrupt
int webp_alpha(const uint8_t* d, size_t n, int w, int h) {
  if (n <= 1) return kCorrupt;
  const int method = d[0] & 3, pre = (d[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (d[0] >> 6) != 0) return kWebpAlpha;
  if (method == 0) return n - 1 >= (size_t)w * h ? kOk : kCorrupt;
  Vp8lDecoder dec;
  dec.br.init(d + 1, n - 1);
  std::vector<uint32_t> px;
  return dec.decode_image(w, h, px, true) ? kOk : kCorrupt;
}

// WebPDecode of one frame's fragment onto the gray canvas at (x, y)
int webp_decode_frame(const uint8_t* d, const WebpFrame& f, uint8_t* canvas, int canvas_w) {
  // the decoder sees the image chunk's payload through its padding
  const uint8_t* payload = d + f.image_offset + 8;
  const size_t size = f.image_size - 8;
  uint8_t* out = canvas + (size_t)f.y * canvas_w + f.x;
  if (f.lossless) {
    int w, h;
    Vp8lDecoder dec;
    int rc = vp8l_info(dec.br, payload, size, w, h);
    if (rc) return rc;
    std::vector<uint32_t> argb;
    if (!dec.decode_image(w, h, argb)) return kCorrupt;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t v = argb[(size_t)y * w + x];
        out[(size_t)y * canvas_w + x] = pil_luma((v >> 16) & 0xff, (v >> 8) & 0xff, v & 0xff);
      }
    return kOk;
  }
  auto dec = std::make_unique<Vp8Decoder>();
  Vp8Frame fr;
  int rc = dec->decode(payload, size, fr);
  if (rc) return rc;
  if (f.alpha_size) {
    rc = webp_alpha(d + f.alpha_offset + 8, webp_le32(d + f.alpha_offset + 4), fr.w, fr.h);
    if (rc) return rc;
  }
  vp8_frame_to_gray(fr, out, (size_t)canvas_w);
  return kOk;
}

int webp_setup(const uint8_t* d, size_t n, WebpInfo& info) {
  int rc = webp_demux(d, n, info);
  if (rc) return rc;
  if ((uint64_t)info.canvas_w * info.canvas_h > kMaxPixels) return kCorrupt;
  return kOk;
}

int decode_webp(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  WebpInfo info;
  int rc = webp_setup(d, n, info);
  if (rc) return rc;
  w = info.canvas_w;
  h = info.canvas_h;
  gray.assign((size_t)w * h, 0);
  return webp_decode_frame(d, info.frames[0], gray.data(), w);
}
