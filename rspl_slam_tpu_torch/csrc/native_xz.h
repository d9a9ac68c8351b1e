// TIFF's LZMA compression (34925): one strip or tile is one .xz stream,
// which libtiff 4.7.1's LZMADecode hands to liblzma 5.8.2's
// lzma_stream_decoder (no memory limit, no flags: no LZMA_CONCATENATED)
// and calls lzma_code on until the strip's buffer is full, the stream
// ends or liblzma fails. The strip reads where the buffer fills: a
// liblzma error after that, in the same call or never seen, does not
// fail it ("Decoding error at scanline N" and "Not enough data" only where
// the buffer is short). So the stream's index and footer never decide a
// strip (they follow the last block's data), and a block's check only
// where a later block must fill the strip; bytes past the stream are never
// read.
//
// The coders keep liblzma's shape, because which bytes reach the buffer
// when it fills or an error stops the chain follows from it: the block
// decoder (sizes, padding, check: none, CRC32, CRC64, SHA-256; other
// check ids are skipped unverified) over a chain of up to four filters
// (delta, the BCJ filters x86, PowerPC, IA-64, ARM, ARM-Thumb, ARM64,
// SPARC and RISC-V through simple_coder.c's buffering, LZMA2 last), LZMA2
// over lz_decoder.c's decode_buffer and the LZMA1 range decoder. A BCJ
// filter holds back up to a few unfiltered bytes at the buffer's end, so
// an error just past the strip fails it, and an error that stops LZMA2
// exactly as the buffer fills leaves those bytes unfiltered in a strip
// that reads (simple_code returns the error before filtering).
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_png.h (crc32).

enum XzRet { kXzOk, kXzEnd, kXzData, kXzOptions, kXzFormat };

// memcpy of k bytes, none where k is 0 (an empty vector's data() may be null)
inline void copy_bytes(uint8_t* dst, const uint8_t* src, size_t k) {
  if (k) std::memcpy(dst, src, k);
}

// ------------------------------------------------------------ checks
uint64_t xz_crc64(const uint8_t* p, size_t n, uint64_t crc) {
  static uint64_t table[256];
  static std::once_flag once;
  std::call_once(once, [] {
    for (uint64_t i = 0; i < 256; ++i) {
      uint64_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xC96C5795D7870F42ull ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  });
  crc = ~crc;
  for (size_t i = 0; i < n; ++i) crc = table[(crc ^ p[i]) & 255] ^ (crc >> 8);
  return ~crc;
}

struct Sha256 {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint8_t block[64];
  size_t fill = 0;
  uint64_t total = 0;
  static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }
  void compress() {
    static const uint32_t k[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4,
        0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe,
        0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f,
        0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
        0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
        0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116,
        0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
        0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7,
        0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t)block[4 * i] << 24 | (uint32_t)block[4 * i + 1] << 16 |
             (uint32_t)block[4 * i + 2] << 8 | block[4 * i + 3];
    for (int i = 16; i < 64; ++i) {
      const uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      const uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a[8];
    std::memcpy(a, h, sizeof(a));
    for (int i = 0; i < 64; ++i) {
      const uint32_t t1 = a[7] + (rotr(a[4], 6) ^ rotr(a[4], 11) ^ rotr(a[4], 25)) +
                          ((a[4] & a[5]) ^ (~a[4] & a[6])) + k[i] + w[i];
      const uint32_t t2 = (rotr(a[0], 2) ^ rotr(a[0], 13) ^ rotr(a[0], 22)) +
                          ((a[0] & a[1]) ^ (a[0] & a[2]) ^ (a[1] & a[2]));
      std::memmove(a + 1, a, 7 * sizeof(uint32_t));
      a[4] += t1;
      a[0] = t1 + t2;
    }
    for (int i = 0; i < 8; ++i) h[i] += a[i];
  }
  void update(const uint8_t* p, size_t n) {
    total += n;
    for (size_t i = 0; i < n; ++i) {
      block[fill++] = p[i];
      if (fill == 64) {
        compress();
        fill = 0;
      }
    }
  }
  void digest(uint8_t out[32]) {
    const uint64_t bits = total * 8;
    const uint8_t one = 0x80, zero = 0;
    update(&one, 1);
    while (fill != 56) update(&zero, 1);
    for (int i = 7; i >= 0; --i) {
      const uint8_t b = (uint8_t)(bits >> (8 * i));
      update(&b, 1);
    }
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 4; ++j) out[4 * i + j] = (uint8_t)(h[i] >> (24 - 8 * j));
  }
};

// ------------------------------------------------- LZMA1 under LZMA2
// The dictionary as lz_decoder.c keeps it, flat: the bytes since the last
// dictionary reset (distances reach back `full`, at most the dictionary's
// size: the filter's, at least 4096, rounded up to 16).
struct XzDict {
  std::vector<uint8_t> buf;
  size_t limit = 0;  // decode no further than this (the caller's room)
  uint64_t size = 4096;
  bool need_reset = false;
  size_t full() const { return (size_t)std::min<uint64_t>(buf.size(), size); }
};

struct XzLzma {
  // the range decoder; `init` bytes of its first five are still to read
  uint32_t range = 0xFFFFFFFFu, code = 0;
  int init = 5;
  bool starved = false;  // needed a byte past the input: no further progress
  int lc = 0, lp = 0, pb = 0;
  uint32_t state = 0, rep[4] = {0, 0, 0, 0};
  uint64_t uncompressed = 0;  // the chunk's bytes still to come
  uint32_t copy_left = 0;     // a match cut by the dictionary's limit
  bool parked = false;        // a literal or short rep decoded, not yet written
  uint8_t parked_byte = 0;
  uint16_t is_match[12][16], is_rep[12], is_rep0[12], is_rep1[12], is_rep2[12],
      is_rep0_long[12][16], dist_slot[4][64], dist_special[114], dist_align[16];
  struct Len {
    uint16_t choice, choice2, low[16][8], mid[16][8], high[256];
  } match_len, rep_len;
  std::vector<uint16_t> literal;

  void reset() {  // lzma_decoder_reset: state, reps and probabilities
    state = 0;
    std::fill(std::begin(rep), std::end(rep), 0);
    copy_left = 0;
    parked = false;
    auto set = [](uint16_t* p, size_t n) { std::fill(p, p + n, 1024); };
    set(&is_match[0][0], 12 * 16);
    set(is_rep, 12);
    set(is_rep0, 12);
    set(is_rep1, 12);
    set(is_rep2, 12);
    set(&is_rep0_long[0][0], 12 * 16);
    set(&dist_slot[0][0], 4 * 64);
    set(dist_special, 114);
    set(dist_align, 16);
    set((uint16_t*)&match_len, sizeof(Len) / 2);
    set((uint16_t*)&rep_len, sizeof(Len) / 2);
    literal.assign((size_t)0x300 << (lc + lp), 1024);
    rc_reset();
  }
  void rc_reset() {
    range = 0xFFFFFFFFu;
    code = 0;
    init = 5;
  }

  // one byte for the range decoder, or false where the input has run out
  bool take(const uint8_t* in, size_t& pos, size_t end, uint32_t& byte) {
    if (pos >= end) {
      starved = true;
      pos = end;
      return false;
    }
    byte = in[pos++];
    return true;
  }
  bool normalize(const uint8_t* in, size_t& pos, size_t end) {
    if (range >= (1u << 24)) return true;
    uint32_t b;
    if (!take(in, pos, end, b)) return false;
    range <<= 8;
    code = (code << 8) | b;
    return true;
  }
  // -1: starved
  int bit(uint16_t& p, const uint8_t* in, size_t& pos, size_t end) {
    if (!normalize(in, pos, end)) return -1;
    const uint32_t bound = (range >> 11) * p;
    if (code < bound) {
      range = bound;
      p += (2048 - p) >> 5;
      return 0;
    }
    range -= bound;
    code -= bound;
    p -= p >> 5;
    return 1;
  }
  int direct(int n, uint32_t& v, const uint8_t* in, size_t& pos, size_t end) {
    for (int i = 0; i < n; ++i) {
      if (!normalize(in, pos, end)) return -1;
      range >>= 1;
      const uint32_t t = (code - range) >> 31;  // 1 where code < range
      code -= range & (t - 1);
      v = (v << 1) | (1 - t);
    }
    return 0;
  }
  int tree(uint16_t* probs, int bits, uint32_t& v, const uint8_t* in, size_t& pos, size_t end) {
    uint32_t m = 1;
    for (int i = 0; i < bits; ++i) {
      const int b = bit(probs[m], in, pos, end);
      if (b < 0) return -1;
      m = (m << 1) | b;
    }
    v = m - (1u << bits);
    return 0;
  }
  int reverse(uint16_t* probs, int bits, uint32_t& v, const uint8_t* in, size_t& pos,
              size_t end) {
    uint32_t m = 1, out = 0;
    for (int i = 0; i < bits; ++i) {
      const int b = bit(probs[m], in, pos, end);
      if (b < 0) return -1;
      m = (m << 1) | b;
      out |= (uint32_t)b << i;
    }
    v = out;
    return 0;
  }
  int length(Len& l, uint32_t ps, uint32_t& len, const uint8_t* in, size_t& pos, size_t end) {
    uint32_t v;
    int b = bit(l.choice, in, pos, end);
    if (b < 0) return -1;
    if (!b) {
      if (tree(l.low[ps], 3, v, in, pos, end)) return -1;
      len = 2 + v;
      return 0;
    }
    if ((b = bit(l.choice2, in, pos, end)) < 0) return -1;
    if (!b) {
      if (tree(l.mid[ps], 3, v, in, pos, end)) return -1;
      len = 10 + v;
      return 0;
    }
    if (tree(l.high, 8, v, in, pos, end)) return -1;
    len = 18 + v;
    return 0;
  }

  // lzma_decode over one LZMA2 chunk: kXzOk (the input ran out, or a
  // symbol waits for room), kXzEnd (the chunk's bytes all out and the range
  // decoder finished), kXzData. As liblzma, the decoder goes on decoding
  // while the chunk has bytes left: a symbol decoded with the caller's room
  // full waits (SEQ_LITERAL_WRITE, SEQ_SHORTREP, SEQ_COPY) for the next
  // call, so a stop reads the input that symbol took.
  XzRet decode(XzDict& dict, const uint8_t* in, size_t& pos, size_t end) {
    while (init > 0) {
      uint32_t b;
      if (!take(in, pos, end, b)) return kXzOk;
      if (init == 5 && b != 0) return kXzData;
      code = (code << 8) | b;
      --init;
    }
    if (starved) return kXzOk;
    const size_t start = dict.buf.size();
    const size_t chunk_end = start + (size_t)uncompressed;
    const size_t limit = std::min(dict.limit, chunk_end);
    const uint32_t pos_mask = (1u << pb) - 1, lp_mask = (1u << lp) - 1;
    XzRet ret = kXzOk;
    auto put_copy = [&](uint32_t dist, uint32_t& left) {
      while (left > 0 && dict.buf.size() < limit) {
        dict.buf.push_back(dict.buf[dict.buf.size() - 1 - dist]);
        --left;
      }
    };
    // a byte decoded and waiting: true where it is now written
    auto put = [&](uint8_t b) {
      if (dict.buf.size() >= limit) {
        parked = true;
        parked_byte = b;
        return false;
      }
      dict.buf.push_back(b);
      return true;
    };
    bool waiting = false;
    if (parked) {
      parked = false;
      waiting = !put(parked_byte);
    } else if (copy_left) {
      put_copy(rep[0], copy_left);
      waiting = copy_left > 0;
    }
    while (!waiting && dict.buf.size() < chunk_end) {
      const size_t at = dict.buf.size();
      const uint32_t ps = (uint32_t)at & pos_mask;
      int b = bit(is_match[state][ps], in, pos, end);
      if (b < 0) break;
      if (!b) {  // a literal
        const uint32_t prev = at ? dict.buf[at - 1] : 0;
        uint16_t* probs =
            literal.data() + 0x300 * ((((uint32_t)at & lp_mask) << lc) + (prev >> (8 - lc)));
        uint32_t sym = 1;
        if (state < 7) {
          while (sym < 0x100) {
            if ((b = bit(probs[sym], in, pos, end)) < 0) break;
            sym = (sym << 1) | b;
          }
        } else {
          uint32_t match_byte = (uint32_t)dict.buf[at - 1 - rep[0]] << 1, offset = 0x100;
          while (sym < 0x100) {
            const uint32_t match_bit = match_byte & offset;
            match_byte <<= 1;
            if ((b = bit(probs[offset + match_bit + sym], in, pos, end)) < 0) break;
            sym = (sym << 1) | b;
            offset &= b ? match_bit : ~match_bit;
          }
        }
        if (b < 0) break;
        state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
        waiting = !put((uint8_t)sym);
        continue;
      }
      if ((b = bit(is_rep[state], in, pos, end)) < 0) break;
      uint32_t len;
      if (!b) {  // a match
        if (length(match_len, ps, len, in, pos, end)) break;
        uint32_t slot;
        if (tree(dist_slot[std::min<uint32_t>(len - 2, 3)], 6, slot, in, pos, end)) break;
        uint32_t dist;
        if (slot < 4) {
          dist = slot;
        } else {
          const int limit_bits = (int)(slot >> 1) - 1;
          dist = (2 | (slot & 1)) << limit_bits;
          uint32_t v = 0;
          if (slot < 14) {
            if (reverse(dist_special + dist - slot - 1, limit_bits, v, in, pos, end)) break;
          } else {
            if (direct(limit_bits - 4, v, in, pos, end)) break;
            uint32_t a;
            if (reverse(dist_align, 4, a, in, pos, end)) break;
            v = (v << 4) | a;
          }
          dist += v;
        }
        rep[3] = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = dist;
        state = state < 7 ? 7 : 10;
        if (dist >= dict.full()) {  // also the end-of-payload marker
          ret = kXzData;
          break;
        }
      } else {  // a repeated match
        if (dict.full() == 0) {
          ret = kXzData;
          break;
        }
        if ((b = bit(is_rep0[state], in, pos, end)) < 0) break;
        if (!b) {
          if ((b = bit(is_rep0_long[state][ps], in, pos, end)) < 0) break;
          if (!b) {  // a short rep: one byte
            state = state < 7 ? 9 : 11;
            waiting = !put(dict.buf[dict.buf.size() - 1 - rep[0]]);
            continue;
          }
        } else {
          uint32_t dist;
          if ((b = bit(is_rep1[state], in, pos, end)) < 0) break;
          if (!b) {
            dist = rep[1];
          } else {
            if ((b = bit(is_rep2[state], in, pos, end)) < 0) break;
            if (!b) {
              dist = rep[2];
            } else {
              dist = rep[3];
              rep[3] = rep[2];
            }
            rep[2] = rep[1];
          }
          rep[1] = rep[0];
          rep[0] = dist;
        }
        state = state < 7 ? 8 : 11;
        if (length(rep_len, ps, len, in, pos, end)) break;
      }
      copy_left = len;
      put_copy(rep[0], copy_left);
      waiting = copy_left > 0;
    }
    uncompressed -= dict.buf.size() - start;
    if (ret != kXzOk || starved) return ret;
    if (uncompressed == 0) {
      if (copy_left || parked) return kXzData;  // a symbol runs past the chunk
      // the chunk's end: the range decoder normalized and at zero
      if (!normalize(in, pos, end)) return kXzOk;
      if (code != 0) return kXzData;
      rc_reset();
      return kXzEnd;
    }
    return kXzOk;
  }
};

// lzma2_decoder.c's lzma2_decode
struct XzLzma2 {
  enum Seq { kControl, kUnc1, kUnc2, kComp0, kComp1, kProps, kLzma, kCopy } seq = kControl,
                                                                       next = kControl;
  bool need_props = true, need_dict_reset = true;
  uint32_t compressed = 0;
  XzLzma lzma;

  XzRet decode(XzDict& dict, const uint8_t* in, size_t& pos, size_t end) {
    while (pos < end || seq == kLzma) {
      switch (seq) {
        case kControl: {
          const uint32_t c = in[pos++];
          if (c == 0) return kXzEnd;
          if (c >= 0xE0 || c == 1) {
            need_props = true;
            need_dict_reset = true;
          } else if (need_dict_reset) {
            return kXzData;
          }
          if (c >= 0x80) {
            lzma.uncompressed = (uint64_t)(c & 0x1F) << 16;
            seq = kUnc1;
            if (c >= 0xC0) {
              need_props = false;
              next = kProps;
            } else if (need_props) {
              return kXzData;
            } else {
              next = kLzma;
              if (c >= 0xA0) lzma.reset();
            }
          } else {
            if (c > 2) return kXzData;
            seq = kComp0;
            next = kCopy;
          }
          if (need_dict_reset) {
            need_dict_reset = false;
            dict.need_reset = true;
            return kXzOk;
          }
          break;
        }
        case kUnc1:
          lzma.uncompressed += (uint64_t)in[pos++] << 8;
          seq = kUnc2;
          break;
        case kUnc2:
          lzma.uncompressed += in[pos++] + 1u;
          seq = kComp0;
          break;
        case kComp0:
          compressed = (uint32_t)in[pos++] << 8;
          seq = kComp1;
          break;
        case kComp1:
          compressed += in[pos++] + 1u;
          seq = next;
          break;
        case kProps: {
          uint32_t b = in[pos++];
          if (b > (4 * 5 + 4) * 9 + 8) return kXzData;
          const int pbv = (int)(b / 45);
          b -= pbv * 45;
          const int lpv = (int)(b / 9), lcv = (int)(b - lpv * 9);
          if (lcv + lpv > 4) return kXzData;
          lzma.lc = lcv;
          lzma.lp = lpv;
          lzma.pb = pbv;
          lzma.reset();
          seq = kLzma;
          break;
        }
        case kLzma: {
          const size_t start = pos;
          const XzRet r = lzma.decode(dict, in, pos, end);
          const size_t used = pos - start;
          if (used > compressed) return kXzData;
          compressed -= (uint32_t)used;
          if (r != kXzEnd) return r;
          if (compressed != 0) return kXzData;
          seq = kControl;
          break;
        }
        case kCopy: {
          const size_t k = std::min<size_t>({end - pos, (size_t)compressed,
                                             dict.limit - dict.buf.size()});
          dict.buf.insert(dict.buf.end(), in + pos, in + pos + k);
          pos += k;
          compressed -= (uint32_t)k;
          if (compressed != 0) return kXzOk;
          seq = kControl;
          break;
        }
      }
    }
    return kXzOk;
  }
};

// one coder of the chain: liblzma's code(in, in_pos, in_size, out,
// out_pos, out_size)
struct XzCoder {
  virtual ~XzCoder() = default;
  virtual XzRet code(const uint8_t* in, size_t& in_pos, size_t in_size, uint8_t* out,
                     size_t& out_pos, size_t out_size) = 0;
};

// lz_decoder.c's lz_decode / decode_buffer over LZMA2
struct XzLzma2Coder : XzCoder {
  XzDict dict;
  XzLzma2 lzma2;
  XzRet code(const uint8_t* in, size_t& in_pos, size_t in_size, uint8_t* out, size_t& out_pos,
             size_t out_size) override {
    while (true) {
      const size_t start = dict.buf.size();
      dict.limit = start + (out_size - out_pos);
      const XzRet r = lzma2.decode(dict, in, in_pos, in_size);
      const size_t k = dict.buf.size() - start;
      copy_bytes(out + out_pos, dict.buf.data() + start, k);
      out_pos += k;
      if (dict.need_reset) {
        dict.need_reset = false;
        dict.buf.clear();
        if (r != kXzOk || out_pos == out_size) return r;
        continue;
      }
      return r;
    }
  }
};

// delta_decoder.c
struct XzDeltaCoder : XzCoder {
  std::unique_ptr<XzCoder> next;
  size_t distance = 1;
  uint8_t history[256] = {};
  uint8_t hpos = 0;
  XzRet code(const uint8_t* in, size_t& in_pos, size_t in_size, uint8_t* out, size_t& out_pos,
             size_t out_size) override {
    const size_t start = out_pos;
    const XzRet r = next->code(in, in_pos, in_size, out, out_pos, out_size);
    for (size_t i = start; i < out_pos; ++i) {
      out[i] = (uint8_t)(out[i] + history[(uint8_t)(distance + hpos)]);
      history[hpos--] = out[i];
    }
    return r;
  }
};

// the BCJ filters' decode functions (simple/*.c): filter buffer[0, size)
// at stream position now, return how many bytes are final
uint32_t xz_le32(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }
void xz_put_le32(uint8_t* p, uint32_t v) {
  for (int i = 0; i < 4; ++i) p[i] = (uint8_t)(v >> (8 * i));
}

struct XzSimpleCoder : XzCoder {
  std::unique_ptr<XzCoder> next;
  int id = 4;
  uint32_t now = 0;
  uint32_t prev_mask = 0, prev_pos = (uint32_t)-5;  // x86's state
  bool end_reached = false;
  size_t pos = 0, filtered = 0, size = 0, allocated = 0;
  std::vector<uint8_t> buffer;

  size_t x86(uint8_t* b, size_t n) {
    static const bool allowed[8] = {true, true, true, false, true, false, false, false};
    static const uint32_t bit_number[8] = {0, 1, 2, 2, 3, 3, 3, 3};
    auto ms = [](uint32_t v) { return ((v + 1) & 0xFE) == 0; };
    if (n < 5) return 0;
    if (now - prev_pos > 5) prev_pos = now - 5;
    const size_t limit = n - 5;
    size_t i = 0;
    while (i <= limit) {
      uint32_t c = b[i];
      if (c != 0xE8 && c != 0xE9) {
        ++i;
        continue;
      }
      const uint32_t offset = now + (uint32_t)i - prev_pos;
      prev_pos = now + (uint32_t)i;
      if (offset > 5) {
        prev_mask = 0;
      } else {
        for (uint32_t k = 0; k < offset; ++k) {
          prev_mask &= 0x77;
          prev_mask <<= 1;
        }
      }
      c = b[i + 4];
      if (ms(c) && allowed[(prev_mask >> 1) & 7] && (prev_mask >> 1) < 0x10) {
        uint32_t src = c << 24 | (uint32_t)b[i + 3] << 16 | (uint32_t)b[i + 2] << 8 | b[i + 1];
        uint32_t dest;
        while (true) {
          dest = src - (now + (uint32_t)i + 5);
          if (prev_mask == 0) break;
          const uint32_t k = bit_number[prev_mask >> 1];
          c = (uint8_t)(dest >> (24 - k * 8));
          if (!ms(c)) break;
          src = dest ^ ((1u << (32 - k * 8)) - 1);
        }
        b[i + 4] = (uint8_t)(~(((dest >> 24) & 1) - 1));
        b[i + 3] = (uint8_t)(dest >> 16);
        b[i + 2] = (uint8_t)(dest >> 8);
        b[i + 1] = (uint8_t)dest;
        i += 5;
        prev_mask = 0;
      } else {
        ++i;
        prev_mask |= 1;
        if (ms(c)) prev_mask |= 0x10;
      }
    }
    return i;
  }
  size_t powerpc(uint8_t* b, size_t n) {
    size_t i;
    for (i = 0; i + 4 <= n; i += 4) {
      if ((b[i] >> 2) != 0x12 || (b[i + 3] & 3) != 1) continue;
      const uint32_t src = ((uint32_t)(b[i] & 3) << 24) | (uint32_t)b[i + 1] << 16 |
                           (uint32_t)b[i + 2] << 8 | (b[i + 3] & ~3u);
      const uint32_t dest = src - (now + (uint32_t)i);
      b[i] = (uint8_t)(0x48 | ((dest >> 24) & 3));
      b[i + 1] = (uint8_t)(dest >> 16);
      b[i + 2] = (uint8_t)(dest >> 8);
      b[i + 3] = (uint8_t)((b[i + 3] & 3) | (dest & 0xFF));
    }
    return i;
  }
  size_t ia64(uint8_t* b, size_t n) {
    static const uint32_t branch[32] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                        4, 4, 6, 6, 0, 0, 7, 7, 4, 4, 0, 0, 4, 4, 0, 0};
    size_t i;
    for (i = 0; i + 16 <= n; i += 16) {
      const uint32_t mask = branch[b[i] & 0x1F];
      uint32_t bit_pos = 5;
      for (int slot = 0; slot < 3; ++slot, bit_pos += 41) {
        if (((mask >> slot) & 1) == 0) continue;
        const size_t byte_pos = bit_pos >> 3;
        const uint32_t bit_res = bit_pos & 7;
        uint64_t instr = 0;
        for (int j = 0; j < 6; ++j) instr += (uint64_t)b[i + j + byte_pos] << (8 * j);
        uint64_t norm = instr >> bit_res;
        if (((norm >> 37) & 0xF) != 0x5 || ((norm >> 9) & 0x7) != 0) continue;
        uint32_t src = (uint32_t)((norm >> 13) & 0xFFFFF);
        src |= ((norm >> 36) & 1) << 20;
        src <<= 4;
        uint32_t dest = src - (now + (uint32_t)i);
        dest >>= 4;
        norm &= ~((uint64_t)0x8FFFFF << 13);
        norm |= (uint64_t)(dest & 0xFFFFF) << 13;
        norm |= (uint64_t)(dest & 0x100000) << (36 - 20);
        instr &= (1ull << bit_res) - 1;
        instr |= norm << bit_res;
        for (int j = 0; j < 6; ++j) b[i + j + byte_pos] = (uint8_t)(instr >> (8 * j));
      }
    }
    return i;
  }
  size_t arm(uint8_t* b, size_t n) {
    size_t i;
    for (i = 0; i + 4 <= n; i += 4) {
      if (b[i + 3] != 0xEB) continue;
      uint32_t src = (uint32_t)b[i + 2] << 16 | (uint32_t)b[i + 1] << 8 | b[i];
      src <<= 2;
      const uint32_t dest = (src - (now + (uint32_t)i + 8)) >> 2;
      b[i + 2] = (uint8_t)(dest >> 16);
      b[i + 1] = (uint8_t)(dest >> 8);
      b[i] = (uint8_t)dest;
    }
    return i;
  }
  size_t armthumb(uint8_t* b, size_t n) {
    size_t i;
    for (i = 0; i + 4 <= n; i += 2) {
      if ((b[i + 1] & 0xF8) != 0xF0 || (b[i + 3] & 0xF8) != 0xF8) continue;
      uint32_t src = ((uint32_t)(b[i + 1] & 7) << 19) | (uint32_t)b[i] << 11 |
                     ((uint32_t)(b[i + 3] & 7) << 8) | b[i + 2];
      src <<= 1;
      const uint32_t dest = (src - (now + (uint32_t)i + 4)) >> 1;
      b[i + 1] = (uint8_t)(0xF0 | ((dest >> 19) & 7));
      b[i] = (uint8_t)(dest >> 11);
      b[i + 3] = (uint8_t)(0xF8 | ((dest >> 8) & 7));
      b[i + 2] = (uint8_t)dest;
      i += 2;
    }
    return i;
  }
  size_t sparc(uint8_t* b, size_t n) {
    size_t i;
    for (i = 0; i + 4 <= n; i += 4) {
      if (!((b[i] == 0x40 && (b[i + 1] & 0xC0) == 0) || (b[i] == 0x7F && (b[i + 1] & 0xC0) == 0xC0)))
        continue;
      uint32_t src = (uint32_t)b[i] << 24 | (uint32_t)b[i + 1] << 16 | (uint32_t)b[i + 2] << 8 |
                     b[i + 3];
      src <<= 2;
      uint32_t dest = (src - (now + (uint32_t)i)) >> 2;
      dest = (((0 - ((dest >> 22) & 1)) << 22) & 0x3FFFFFFF) | (dest & 0x3FFFFF) | 0x40000000;
      for (int k = 0; k < 4; ++k) b[i + k] = (uint8_t)(dest >> (24 - 8 * k));
    }
    return i;
  }
  size_t arm64(uint8_t* b, size_t n) {
    size_t i;
    for (i = 0; i + 4 <= n; i += 4) {
      uint32_t pc = now + (uint32_t)i;
      uint32_t instr = xz_le32(b + i);
      if ((instr >> 26) == 0x25) {
        const uint32_t src = instr;
        pc >>= 2;
        pc = 0u - pc;
        xz_put_le32(b + i, 0x94000000u | ((src + pc) & 0x03FFFFFF));
      } else if ((instr & 0x9F000000u) == 0x90000000u) {
        const uint32_t src = ((instr >> 29) & 3) | ((instr >> 3) & 0x001FFFFC);
        if ((src + 0x00020000) & 0x001C0000) continue;
        instr &= 0x9000001Fu;
        pc >>= 12;
        pc = 0u - pc;
        const uint32_t dest = src + pc;
        instr |= (dest & 3) << 29;
        instr |= (dest & 0x0003FFFC) << 3;
        instr |= (0u - (dest & 0x00020000)) & 0x00E00000;
        xz_put_le32(b + i, instr);
      }
    }
    return i;
  }
  size_t riscv(uint8_t* b, size_t n) {
    if (n < 8) return 0;
    n -= 8;
    size_t i;
    for (i = 0; i <= n; i += 2) {
      uint32_t inst = b[i];
      if (inst == 0xEF) {  // JAL
        const uint32_t b1 = b[i + 1];
        if ((b1 & 0x0D) != 0) continue;
        const uint32_t b2 = b[i + 2], b3 = b[i + 3];
        const uint32_t pc = now + (uint32_t)i;
        uint32_t addr = ((b1 & 0xF0) << 13) | (b2 << 9) | (b3 << 1);
        addr -= pc;
        b[i + 1] = (uint8_t)((b1 & 0x0F) | ((addr >> 8) & 0xF0));
        b[i + 2] = (uint8_t)(((addr >> 16) & 0x0F) | ((addr >> 7) & 0x10) | ((addr << 4) & 0xE0));
        b[i + 3] = (uint8_t)(((addr >> 4) & 0x7F) | ((addr >> 13) & 0x80));
        i += 4 - 2;
      } else if ((inst & 0x7F) == 0x17) {  // AUIPC
        inst |= (uint32_t)b[i + 1] << 8 | (uint32_t)b[i + 2] << 16 | (uint32_t)b[i + 3] << 24;
        uint32_t inst2;
        if (inst & 0xE80) {
          inst2 = xz_le32(b + i + 4);
          if (((inst << 8) ^ (inst2 - 3)) & 0xF8003) {
            i += 6 - 2;
            continue;
          }
          uint32_t addr = inst & 0xFFFFF000u;
          addr += inst2 >> 20;
          inst = 0x17 | (2 << 7) | (inst2 << 12);
          inst2 = addr;
        } else {
          const uint32_t rs1 = inst >> 27;
          if (((inst - 0x3117) << 18) >= (rs1 & 0x1D)) {
            i += 4 - 2;
            continue;
          }
          uint32_t addr = (uint32_t)b[i + 4] << 24 | (uint32_t)b[i + 5] << 16 |
                          (uint32_t)b[i + 6] << 8 | b[i + 7];
          addr -= now + (uint32_t)i;
          inst2 = (inst >> 12) | (addr << 20);
          inst = 0x17 | (rs1 << 7) | ((addr + 0x800) & 0xFFFFF000u);
        }
        xz_put_le32(b + i, inst);
        xz_put_le32(b + i + 4, inst2);
        i += 8 - 2;
      }
    }
    return i;
  }
  size_t filter(uint8_t* b, size_t n) {
    size_t k;
    switch (id) {
      case 4: k = x86(b, n); break;
      case 5: k = powerpc(b, n); break;
      case 6: k = ia64(b, n); break;
      case 7: k = arm(b, n); break;
      case 8: k = armthumb(b, n); break;
      case 9: k = sparc(b, n); break;
      case 10: k = arm64(b, n); break;
      default: k = riscv(b, n); break;
    }
    now += (uint32_t)k;
    return k;
  }
  XzRet copy_or_code(const uint8_t* in, size_t& in_pos, size_t in_size, uint8_t* out,
                     size_t& out_pos, size_t out_size) {
    const XzRet r = next->code(in, in_pos, in_size, out, out_pos, out_size);
    if (r == kXzEnd) end_reached = true;
    else if (r != kXzOk) return r;
    return kXzOk;
  }
  // simple_coder.c's simple_code
  XzRet code(const uint8_t* in, size_t& in_pos, size_t in_size, uint8_t* out, size_t& out_pos,
             size_t out_size) override {
    if (pos < filtered) {
      const size_t k = std::min(filtered - pos, out_size - out_pos);
      copy_bytes(out + out_pos, buffer.data() + pos, k);
      pos += k;
      out_pos += k;
      if (pos < filtered) return kXzOk;
      if (end_reached) return kXzEnd;
    }
    filtered = 0;
    const size_t out_avail = out_size - out_pos, buf_avail = size - pos;
    if (out_avail > buf_avail || buf_avail == 0) {
      const size_t out_start = out_pos;
      copy_bytes(out + out_pos, buffer.data() + pos, buf_avail);
      out_pos += buf_avail;
      const XzRet r = copy_or_code(in, in_pos, in_size, out, out_pos, out_size);
      if (r != kXzOk) return r;
      const size_t n = out_pos - out_start;
      const size_t done = n == 0 ? 0 : filter(out + out_start, n);
      const size_t unfiltered = n - done;
      pos = 0;
      size = unfiltered;
      if (end_reached) {
        size = 0;
      } else if (unfiltered > 0) {
        out_pos -= unfiltered;
        copy_bytes(buffer.data(), out + out_pos, unfiltered);
      }
    } else if (pos > 0) {
      std::memmove(buffer.data(), buffer.data() + pos, buf_avail);
      size -= pos;
      pos = 0;
    }
    if (size > 0) {
      const XzRet r = copy_or_code(in, in_pos, in_size, buffer.data(), size, allocated);
      if (r != kXzOk) return r;
      filtered = filter(buffer.data(), size);
      if (end_reached) filtered = size;
      const size_t k = std::min(filtered - pos, out_size - out_pos);
      copy_bytes(out + out_pos, buffer.data() + pos, k);
      pos += k;
      out_pos += k;
    }
    if (end_reached && pos == size) return kXzEnd;
    return kXzOk;
  }
};

// lzma_vli_decode in single-call mode
bool xz_vli(const uint8_t* in, size_t& pos, size_t end, uint64_t& v) {
  v = 0;
  for (int i = 0; i < 9; ++i) {
    if (pos >= end) return false;
    const uint8_t b = in[pos++];
    v |= (uint64_t)(b & 0x7F) << (7 * i);
    if (!(b & 0x80)) return !(b == 0 && i > 0);
  }
  return false;
}

const uint8_t kXzCheckSize[16] = {0, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 32, 64, 64, 64};
const uint64_t kXzVliMax = UINT64_MAX / 2;

// block_decoder.c over the filter chain its header names
struct XzBlock {
  std::unique_ptr<XzCoder> chain;
  int check = 0;
  uint64_t header_size = 0, compressed = 0, uncompressed = 0;
  uint64_t compressed_limit = 0, uncompressed_limit = 0;
  uint64_t want_compressed = 0, want_uncompressed = 0;  // the header's, or kXzVliMax + 1
  enum Seq { kCode, kPadding, kCheck } seq = kCode;
  uint32_t crc = 0;
  uint64_t crc64 = 0;
  Sha256 sha;
  uint8_t raw_check[64];
  size_t check_pos = 0;

  // lzma_block_header_decode and the raw decoder's chain: kXzOk or its error
  XzRet init(const uint8_t* h, size_t hsize, int check_id) {
    check = check_id;
    header_size = hsize;
    const size_t n = hsize - 4;
    if (crc32(h, n) != xz_le32(h + n)) return kXzData;
    if (h[1] & 0x3C) return kXzOptions;
    size_t p = 2;
    const uint64_t unknown = kXzVliMax + 1;
    want_compressed = want_uncompressed = unknown;
    if (h[1] & 0x40) {
      if (!xz_vli(h, p, n, want_compressed)) return kXzData;
      const uint64_t unpadded = want_compressed + hsize + kXzCheckSize[check];
      if (want_compressed == 0 || want_compressed > kXzVliMax || unpadded > (kXzVliMax & ~3ull))
        return kXzData;
    }
    if (h[1] & 0x80) {
      if (!xz_vli(h, p, n, want_uncompressed)) return kXzData;
    }
    struct Filter { uint64_t id; std::vector<uint8_t> props; };
    std::vector<Filter> filters;
    for (int i = 0; i < (h[1] & 3) + 1; ++i) {
      Filter f;
      uint64_t props;
      if (!xz_vli(h, p, n, f.id)) return kXzData;
      if (f.id >= (1ull << 62)) return kXzData;
      if (!xz_vli(h, p, n, props)) return kXzData;
      if (n - p < props) return kXzData;
      f.props.assign(h + p, h + p + props);
      p += (size_t)props;
      // lzma_properties_decode
      if (f.id == 0x21) {
        if (props != 1 || (f.props[0] & 0xC0) || f.props[0] > 40) return kXzOptions;
      } else if (f.id == 3) {
        if (props != 1) return kXzOptions;
      } else if (f.id >= 4 && f.id <= 11) {
        if (props != 0 && props != 4) return kXzOptions;
      } else {
        return kXzOptions;  // a filter liblzma has no decoder for
      }
      filters.push_back(std::move(f));
    }
    while (p < n)
      if (h[p++] != 0) return kXzOptions;
    // validate_chain: LZMA2 last and only there
    for (size_t i = 0; i < filters.size(); ++i)
      if ((filters[i].id == 0x21) != (i + 1 == filters.size())) return kXzOptions;
    // the chain, last filter first
    const uint8_t db = filters.back().props[0];
    auto lz = std::make_unique<XzLzma2Coder>();
    uint64_t dict_size = db == 40 ? 0xFFFFFFFFull : (uint64_t)(2 | (db & 1)) << (db / 2 + 11);
    dict_size = std::max<uint64_t>(dict_size, 4096);
    lz->dict.size = (dict_size + 15) & ~15ull;
    chain = std::move(lz);
    for (size_t i = filters.size() - 1; i-- > 0;) {
      const Filter& f = filters[i];
      if (f.id == 3) {
        auto d = std::make_unique<XzDeltaCoder>();
        d->distance = (size_t)f.props[0] + 1;
        d->next = std::move(chain);
        chain = std::move(d);
      } else {
        static const size_t unfiltered_max[12] = {0, 0, 0, 0, 5, 4, 16, 4, 4, 4, 4, 8};
        auto s = std::make_unique<XzSimpleCoder>();
        s->id = (int)f.id;
        if (f.props.size() == 4) s->now = xz_le32(f.props.data());
        s->allocated = 2 * unfiltered_max[f.id];
        s->buffer.assign(s->allocated, 0);
        s->next = std::move(chain);
        chain = std::move(s);
      }
    }
    compressed_limit = want_compressed != unknown
                           ? want_compressed
                           : (kXzVliMax & ~3ull) - hsize - kXzCheckSize[check];
    uncompressed_limit = want_uncompressed != unknown ? want_uncompressed : kXzVliMax;
    return kXzOk;
  }

  XzRet code(const uint8_t* in, size_t& in_pos, size_t in_size, uint8_t* out, size_t& out_pos,
             size_t out_size) {
    if (seq == kCode) {
      const size_t in_start = in_pos, out_start = out_pos;
      const size_t in_stop = in_pos + (size_t)std::min<uint64_t>(in_size - in_pos,
                                                                 compressed_limit - compressed);
      const size_t out_stop = out_pos + (size_t)std::min<uint64_t>(
                                            out_size - out_pos, uncompressed_limit - uncompressed);
      const XzRet r = chain->code(in, in_pos, in_stop, out, out_pos, out_stop);
      compressed += in_pos - in_start;
      uncompressed += out_pos - out_start;
      if (r == kXzOk) {
        const bool comp_done = compressed == want_compressed;
        const bool uncomp_done = uncompressed == want_uncompressed;
        if (comp_done && uncomp_done) return kXzData;
        if (comp_done && out_pos < out_size) return kXzData;
        if (uncomp_done && in_pos < in_size) return kXzData;
      }
      const uint8_t* o = out + out_start;
      const size_t k = out_pos - out_start;
      if (check == 1) crc = crc32(o, k, crc);
      else if (check == 4) crc64 = xz_crc64(o, k, crc64);
      else if (check == 10) sha.update(o, k);
      if (r != kXzEnd) return r;
      const uint64_t unknown = kXzVliMax + 1;
      if ((want_compressed != unknown && compressed != want_compressed) ||
          (want_uncompressed != unknown && uncompressed != want_uncompressed))
        return kXzData;
      seq = kPadding;
    }
    if (seq == kPadding) {
      while (compressed & 3) {
        if (in_pos >= in_size) return kXzOk;
        ++compressed;
        if (in[in_pos++] != 0) return kXzData;
      }
      if (check == 0) return kXzEnd;
      seq = kCheck;
    }
    const size_t csize = kXzCheckSize[check];
    const size_t k = std::min(csize - check_pos, in_size - in_pos);
    copy_bytes(raw_check + check_pos, in + in_pos, k);
    check_pos += k;
    in_pos += k;
    if (check_pos < csize) return kXzOk;
    uint8_t want[32];
    if (check == 1) {
      xz_put_le32(want, crc);
    } else if (check == 4) {
      for (int i = 0; i < 8; ++i) want[i] = (uint8_t)(crc64 >> (8 * i));
    } else if (check == 10) {
      sha.digest(want);
    } else {
      return kXzEnd;  // a check liblzma does not know: skipped
    }
    return std::memcmp(want, raw_check, csize) ? kXzData : kXzEnd;
  }
};

// LZMADecode of one strip or tile: its bytes → `expect` bytes, or false
// where libtiff fails it
bool xz_decode(const uint8_t* in, size_t n, std::vector<uint8_t>& out, size_t expect) {
  out.assign(expect, 0);
  size_t in_pos = 0, out_pos = 0;
  // stream_decoder.c's sequence; anything past the last block's data
  // (the index, the footer) ends the decode as an error or the stream's
  // end would: neither fills the strip
  enum { kHeader, kBlockHeader, kBlockRun, kDone } seq = kHeader;
  int check = 0;
  std::unique_ptr<XzBlock> block;
  auto stream_code = [&]() -> XzRet {
    while (true) {
      switch (seq) {
        case kHeader: {
          if (n - in_pos < 12) {
            in_pos = n;
            return kXzOk;
          }
          const uint8_t* h = in + in_pos;
          static const uint8_t magic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
          if (std::memcmp(h, magic, 6)) return kXzFormat;
          if (crc32(h + 6, 2) != xz_le32(h + 8)) return kXzData;
          if (h[6] != 0 || (h[7] & 0xF0)) return kXzOptions;
          check = h[7] & 15;
          in_pos += 12;
          seq = kBlockHeader;
          break;
        }
        case kBlockHeader: {
          if (in_pos >= n) return kXzOk;
          if (in[in_pos] == 0) {  // the index
            seq = kDone;
            return kXzEnd;
          }
          const size_t hsize = ((size_t)in[in_pos] + 1) * 4;
          if (n - in_pos < hsize) {
            in_pos = n;
            return kXzOk;
          }
          block = std::make_unique<XzBlock>();
          const XzRet r = block->init(in + in_pos, hsize, check);
          in_pos += hsize;
          if (r != kXzOk) return r;
          seq = kBlockRun;
          break;
        }
        case kBlockRun: {
          const XzRet r = block->code(in, in_pos, n, out.data(), out_pos, expect);
          if (r != kXzEnd) return r;
          seq = kBlockHeader;
          break;
        }
        case kDone:
          return kXzEnd;
      }
    }
  };
  // LZMADecode's loop over lzma_code (two calls in a row without progress
  // are LZMA_BUF_ERROR)
  bool stalled = false;
  while (out_pos < expect) {
    const size_t i0 = in_pos, o0 = out_pos;
    const XzRet r = stream_code();
    if (r != kXzOk) break;
    if (in_pos == i0 && out_pos == o0) {
      if (stalled) break;
      stalled = true;
    } else {
      stalled = false;
    }
  }
  return out_pos == expect;
}
