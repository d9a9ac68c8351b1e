// PNG as PIL 12.1's PngImagePlugin reads it, then convert("L").
//
// Pillow's C decoders are not on this machine: what they do was found by
// probing PIL. The plugin reads a file in three steps, and so does this
// reader:
//   - _open (png_open): the chunks up to the first IDAT (or fdAT), each
//     through its PngStream handler, then its CRC. A bad CRC or chunk name,
//     a short read of a chunk header or checksum, and the handlers'
//     SyntaxError, struct.error and IndexError pass the file on (kPassOn);
//     a short IHDR, sRGB, pHYs, acTL or fcTL (ValueError) or a chunk cut
//     short by the end of the file (OSError) end the open (kCorrupt).
//   - load (png_load): the run of image data chunks (IDAT, DDAT or fdAT)
//     from the first one, read as ImageFile.load reads it (at most 65536
//     bytes a read), into zlib as Pillow's ZipDecode drives it: one row of
//     output at a time, done the moment the tile's last row is full. No
//     CRC is checked. In the read that fills the last row, zlib decodes on
//     while no symbol needs output (the next code, an end of block, the
//     next block header, the Adler-32 check), so damage there raises and
//     damage past it does not. A run too short for the image is PIL's
//     "image file is truncated".
//   - load_end (png_tail): the chunks after the data, through their
//     handlers, without CRCs, up to IEND, an APNG's next fcTL, or the
//     first chunk header that cannot be read; a handler's error raises.
// Load errors of Image.open's pass-on kinds (a bad chunk name where the
// data run needs its next chunk, an fdAT out of sequence, a handler's
// SyntaxError or struct.error) return kLoadPassOn: a PNG file raises them
// (kCorrupt); an ICO, whose open loads its PNG entry, passes the file on.
//
// Frame 0 of an APNG is the tile of its first fcTL, zeros around it. A
// palette index past PLTE reads 0, and a P image without PLTE reads all 0.
//
// Included by native_runtime.cpp inside its anonymous namespace, after the
// inflate section and native_pil.h.

uint32_t crc_table[256];
std::once_flag crc_once;

// zlib's crc32(seed, p, n)
uint32_t crc32(const uint8_t* p, size_t n, uint32_t seed = 0) {
  std::call_once(crc_once, [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  });
  uint32_t c = seed ^ 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc_table[(c ^ p[i]) & 255] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

// is_cid: four of [A-Za-z0-9_]
inline bool png_cid(const uint8_t* c) {
  for (int i = 0; i < 4; ++i)
    if (c[i] > 127 || !(std::isalnum(c[i]) || c[i] == '_')) return false;
  return true;
}

// _MODES: the (bit depth, colour type) pairs PIL has a mode for
inline bool png_mode(int b, int t) {
  return (t == 0 && (b == 1 || b == 2 || b == 4 || b == 8 || b == 16)) ||
         (t == 3 && (b == 1 || b == 2 || b == 4 || b == 8)) ||
         ((t == 2 || t == 4 || t == 6) && (b == 8 || b == 16));
}

// PngStream's attributes, and where _open found the image data
struct PngState {
  int64_t w = 0, h = 0;  // im_size
  int depth = 0, ctype = 0;
  bool mode = false;       // an IHDR gave im_mode and im_rawmode
  bool interlace = false;  // info["interlace"]: any IHDR's byte 12 not 0
  bool has_pal = false;    // a PLTE while the mode was P
  std::vector<uint8_t> pal;
  int64_t seq = -1;     // _seq_num; -1 for None
  int64_t frames = 0;   // im_n_frames; 0 for None
  bool bbox = false;    // info["bbox"], from an fcTL
  int64_t bx0 = 0, by0 = 0, bx1 = 0, by1 = 0;
  // the tile: where the first data chunk's data starts, and its length
  bool tile = false, animated = false;
  size_t data = 0;
  int64_t data_len = 0;
  int64_t tx0 = 0, ty0 = 0, tx1 = 0, ty1 = 0;  // its extents (0, 0, 0, 0: the image)
};

enum PngCall { kCallOk, kCallEof, kCallUnknown, kCallPassOn, kCallError };

// PngStream.call(cid, pos, length): the handler's outcome (EOFError,
// AttributeError for a chunk without a handler, an exception of the
// pass-on kinds, another exception); fp receives where its reads leave
// the file
int png_call(const uint8_t* d, size_t n, const uint8_t* cid, size_t pos, uint32_t len,
             PngState& st, size_t& fp) {
  fp = pos;
  auto is = [&](const char* k) { return !std::memcmp(cid, k, 4); };
  // chunk_IDAT: AttributeError (im_rawmode) without a mode, else EOFError
  if (is("IDAT")) return st.mode ? kCallEof : kCallUnknown;
  if (is("IEND")) return kCallEof;
  if (is("fdAT")) {
    if (len < 4) return kCallError;     // "APNG contains truncated fDAT chunk"
    if (n - pos < 4) return kCallError;  // _safe_read: "Truncated File Read"
    const int64_t seq = be32(d + pos);
    fp = pos + 4;
    if (st.seq < 0 || st.seq != seq - 1) return kCallPassOn;  // "frame sequence errors"
    st.seq = seq;
    return st.mode ? kCallEof : kCallUnknown;
  }
  static const char* const kHandled[] = {"iCCP", "IHDR", "PLTE", "tRNS", "gAMA", "cHRM", "sRGB",
                                         "pHYs", "tEXt", "zTXt", "iTXt", "eXIf", "acTL", "fcTL"};
  bool handled = false;
  for (const char* k : kHandled) handled = handled || is(k);
  if (!handled) return kCallUnknown;
  if (len > 0 && n - pos < len) return kCallError;  // _safe_read: "Truncated File Read"
  fp = pos + len;
  const uint8_t* s = d + pos;
  if (is("IHDR")) {
    if (len < 13) return kCallError;  // "Truncated IHDR chunk"
    st.w = be32(s);
    st.h = be32(s + 4);
    if (png_mode(s[8], s[9])) {
      st.depth = s[8];
      st.ctype = s[9];
      st.mode = true;
    }
    if (s[12]) st.interlace = true;
    return s[11] ? kCallPassOn : kCallOk;  // "unknown filter category"
  }
  if (is("PLTE")) {
    if (st.mode && st.ctype == 3) {
      st.pal.assign(s, s + len);
      st.has_pal = true;
    }
    return kCallOk;
  }
  if (is("tRNS")) {  // i16 of mode 1, L and I;16; three of RGB: struct.error
    if (st.mode && ((st.ctype == 0 && len < 2) || (st.ctype == 2 && len < 6))) return kCallPassOn;
    return kCallOk;
  }
  if (is("gAMA")) return len < 4 ? kCallPassOn : kCallOk;     // i32: struct.error
  if (is("cHRM")) return len % 4 ? kCallPassOn : kCallOk;     // unpack of len // 4 ints
  if (is("sRGB")) return len < 1 ? kCallError : kCallOk;      // "Truncated sRGB chunk"
  if (is("pHYs")) return len < 9 ? kCallError : kCallOk;      // "Truncated pHYs chunk"
  if (is("zTXt")) {  // a compression method other than 0: SyntaxError
    const uint8_t* z = len ? (const uint8_t*)std::memchr(s, 0, len) : nullptr;
    return z && z + 1 < s + len && z[1] ? kCallPassOn : kCallOk;
  }
  if (is("iCCP")) {  // s[s.find(b"\0") + 1]: IndexError past the end; a method other than 0
    const uint8_t* z = len ? (const uint8_t*)std::memchr(s, 0, len) : nullptr;
    const size_t at = z ? (size_t)(z - s) + 1 : 0;
    return at >= len || s[at] ? kCallPassOn : kCallOk;
  }
  if (is("acTL")) {
    if (len < 8) return kCallError;  // "APNG contains truncated acTL chunk"
    if (st.frames) {
      st.frames = 0;  // a second acTL: "Invalid APNG"
    } else {
      const uint32_t f = be32(s);
      if (f != 0 && f <= 0x80000000u) st.frames = f;
    }
    return kCallOk;
  }
  if (is("fcTL")) {
    if (len < 26) return kCallError;  // "APNG contains truncated fcTL chunk"
    const int64_t seq = be32(s);
    if ((st.seq < 0 && seq != 0) || (st.seq >= 0 && st.seq != seq - 1)) return kCallPassOn;
    st.seq = seq;
    const int64_t fw = be32(s + 4), fh = be32(s + 8), px = be32(s + 12), py = be32(s + 16);
    if (px + fw > st.w || py + fh > st.h) return kCallPassOn;  // "APNG contains invalid frames"
    st.bbox = true;
    st.bx0 = px;
    st.by0 = py;
    st.bx1 = px + fw;
    st.by1 = py + fh;
    return kCallOk;
  }
  return kCallOk;  // tEXt, iTXt, eXIf
}

// PngImageFile._open, then Image.open's checks: kOk, kPassOn or kCorrupt
int png_open(const uint8_t* d, size_t n, PngState& st) {
  if (n < 8 || std::memcmp(d, kPngSig, 8)) return kPassOn;
  size_t pos = 8;
  while (true) {
    if (n - pos < 8) return kPassOn;  // i32 or is_cid of a short read
    const uint8_t* cid = d + pos + 4;
    if (!png_cid(cid)) return kPassOn;  // "broken PNG file (chunk ...)"
    const uint32_t len = be32(d + pos);
    size_t fp;
    const int r = png_call(d, n, cid, pos + 8, len, st, fp);
    if (r == kCallPassOn) return kPassOn;
    if (r == kCallError) return kCorrupt;
    if (r == kCallEof) {
      if (std::memcmp(cid, "IEND", 4)) {  // the tile of the first IDAT or fdAT
        st.tile = true;
        st.data = fp;
        st.data_len = std::memcmp(cid, "fdAT", 4) ? (int64_t)len : (int64_t)len - 4;
        if (st.bbox) {
          st.tx0 = st.bx0;
          st.ty0 = st.by0;
          st.tx1 = st.bx1;
          st.ty1 = st.by1;
        } else {
          st.tx1 = st.w;
          st.ty1 = st.h;
        }
        const bool default_image = !st.bbox && st.frames;
        st.animated = (st.frames ? st.frames : 1) + (default_image ? 1 : 0) > 1;
      }
      break;
    }
    const uint8_t* body = d + pos + 8;
    if (r == kCallUnknown) {  // _safe_read(length) from where the handler left the file
      if (len > 0 && n - fp < len) return kCorrupt;
      body = d + fp;
      fp += len;
    }
    if (n - fp < 4) return kPassOn;  // "incomplete checksum"
    if (crc32(body, len, crc32(cid, 4)) != be32(d + fp)) return kPassOn;  // "bad header checksum"
    pos = fp + 4;
  }
  if (!st.mode || st.w == 0 || st.h == 0) return kPassOn;  // "not identified by this driver"
  if ((uint64_t)st.w * st.h > kMaxPixels) return kCorrupt;  // DecompressionBombError
  return kOk;
}

// load_end from pos, where the chunk that held the tile's last byte ends
int png_tail(const uint8_t* d, size_t n, size_t pos, PngState& st) {
  while (true) {
    pos = std::min(pos + 4, n);  // the CRC, read and not checked
    if (n - pos < 8 || !png_cid(d + pos + 4)) return kOk;  // struct.error, SyntaxError: the end
    const uint32_t len = be32(d + pos);
    const uint8_t* cid = d + pos + 4;
    pos += 8;
    if (!std::memcmp(cid, "IEND", 4) || (!std::memcmp(cid, "fcTL", 4) && st.animated))
      return kOk;
    size_t fp;
    const int r = png_call(d, n, cid, pos, len, st, fp);
    if (r == kCallPassOn) return kLoadPassOn;
    if (r == kCallError) return kCorrupt;
    if (r == kCallEof || r == kCallUnknown) {  // _safe_read of the data a handler did not read
      const uint32_t left = r == kCallEof && !std::memcmp(cid, "fdAT", 4) ? len - 4 : len;
      if (left > 0 && n - fp < left) return kCorrupt;  // "Truncated File Read"
      fp += left;
    }
    pos = fp;
  }
}

// One read of the data run: its bytes, and what load_end needs where the
// image is done in it (the end of its chunk, _seq_num after it)
struct PngRead {
  size_t a, b, chunk_end;
  int64_t seq;
};

// The reads load_read gives the decoder, in order; `term` receives what it
// raises when the decoder asks for more: "image file is truncated"
// (kCorrupt; also a short fdAT), or a bad chunk name or fdAT sequence
// (kLoadPassOn)
void png_reads(const uint8_t* d, size_t n, PngState st, std::vector<PngRead>& reads, int& term) {
  reads.clear();
  size_t fp = st.data;
  int64_t idat = st.data_len;
  size_t chunk_end = (size_t)std::min<uint64_t>((uint64_t)fp + (uint64_t)idat, n);
  while (true) {
    while (idat == 0) {
      fp = std::min(fp + 4, n);  // the CRC
      if (n - fp < 4) {
        term = kCorrupt;  // struct.error: "image file is truncated"
        return;
      }
      if (n - fp < 8 || !png_cid(d + fp + 4)) {
        term = kLoadPassOn;  // "broken PNG file (chunk ...)"
        return;
      }
      const uint32_t len = be32(d + fp);
      const uint8_t* cid = d + fp + 4;
      fp += 8;
      if (!std::memcmp(cid, "IDAT", 4) || !std::memcmp(cid, "DDAT", 4)) {
        idat = len;
      } else if (!std::memcmp(cid, "fdAT", 4)) {
        size_t after;
        const int r = png_call(d, n, cid, fp, len, st, after);
        if (r != kCallEof) {
          term = r == kCallPassOn ? kLoadPassOn : kCorrupt;
          return;
        }
        fp = after;
        idat = (int64_t)len - 4;
      } else {
        term = kCorrupt;  // pushed back; an empty read: "image file is truncated"
        return;
      }
      chunk_end = (size_t)std::min<uint64_t>((uint64_t)fp + (uint64_t)idat, n);
    }
    const int64_t want = std::min<int64_t>(65536, idat);
    idat -= want;
    const size_t got = std::min<size_t>((size_t)want, n - fp);
    if (got == 0) {
      term = kCorrupt;  // "image file is truncated"
      return;
    }
    reads.push_back({fp, fp + got, chunk_end, st.seq});
    fp += got;
  }
}

// zlib's Huffman tables: an over-subscribed set fails; an incomplete one
// too, but for a literal/length or distance set of one 1-bit code, and a
// distance set of no codes (whose use fails)
enum ZTable { kZCodes, kZLens, kZDists };
bool zlib_table_ok(const uint8_t* lengths, int n, ZTable kind) {
  int count[16] = {0};
  for (int s = 0; s < n; ++s) count[lengths[s]]++;
  int max = 15;
  while (max >= 1 && !count[max]) --max;
  if (max == 0) return kind != kZLens;
  int left = 1;
  for (int l = 1; l < 16; ++l) {
    left = (left << 1) - count[l];
    if (left < 0) return false;
  }
  return left == 0 || (kind != kZCodes && max == 1);
}

// zlib driven as ZipDecode drives it over the reads (their bytes one after
// another in d, the end of each in `ends`), filling `rows` (the end of each
// row, its filter byte first): kOk when the last row is full, with `seg` the
// read whose decode filled it; kCorrupt where zlib fails, or a full row's
// filter byte is not 0-4 ("unrecognized data stream contents"); kSize where
// the reads end first (the decoder asks for more)
int png_inflate(const uint8_t* d, size_t n, const std::vector<size_t>& ends,
                const std::vector<size_t>& rows, std::vector<uint8_t>& out, int& seg) {
  out.clear();
  out.reserve(rows.back());
  InflateIn in{d, n};
  seg = 0;
  size_t row = 0, limit = n * 8;
  bool done = false;
  auto used = [&]() { return (in.pos + in.overrun) * 8 - (size_t)in.cnt; };
  // where the input a step needed is not there: zlib waits for more
  auto short_input = [&]() { return done ? (int)kOk : (int)kSize; };
  auto fits = [&]() { return used() <= limit; };
  // the read the decoder is in: the one holding the last byte zlib pulled
  auto track = [&]() {
    const size_t pulled = (used() + 7) / 8;
    while (seg + 1 < (int)ends.size() && pulled > ends[seg]) ++seg;
  };
  // one byte out; at a row's end, its filter byte is checked; at the last,
  // zlib may go on only within the read it is in
  auto emit = [&](uint8_t v) -> int {
    out.push_back(v);
    if (out.size() < rows[row]) return kOk;
    if (out[row ? rows[row - 1] : 0] > 4) return kCorrupt;
    if (++row == rows.size()) {
      done = true;
      limit = ends[seg] * 8;
    }
    return kOk;
  };
  const int cmf = (int)in.bits(8), flg = (int)in.bits(8);
  if (!fits()) return kSize;
  if (((cmf << 8) | flg) % 31 || (cmf & 15) != 8 || (cmf >> 4) > 7) return kCorrupt;
  if (flg & 0x20) return kSize;  // Z_NEED_DICT: ZipDecode waits for more, as for input
  static const uint8_t kOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                     11, 4, 12, 3, 13, 2, 14, 1, 15};
  Huffman lit, dist;
  while (true) {
    const int last = (int)in.bits(1), type = (int)in.bits(2);
    if (!fits()) return short_input();
    if (type == 3) return kCorrupt;  // "invalid block type"
    if (type == 0) {
      in.align();
      const int len = (int)in.bits(16), nlen = (int)in.bits(16);
      if (!fits()) return short_input();
      if (len != (~nlen & 0xffff)) return kCorrupt;  // "invalid stored block lengths"
      for (int k = 0; k < len; ++k) {
        if (done) return kOk;  // a copy with no room left
        const uint8_t v = (uint8_t)in.bits(8);
        if (!fits()) return short_input();
        track();
        if (emit(v)) return kCorrupt;
      }
    } else {
      uint8_t lengths[320] = {0};
      if (type == 1) {
        for (int s = 0; s < 288; ++s) lengths[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
        for (int s = 0; s < 30; ++s) lengths[288 + s] = 5;
        lit.build(lengths, 288);
        dist.build(lengths + 288, 30);
      } else {
        const int nlen = (int)in.bits(5) + 257, ndist = (int)in.bits(5) + 1;
        const int ncode = (int)in.bits(4) + 4;
        if (!fits()) return short_input();
        if (nlen > 286 || ndist > 30) return kCorrupt;  // "too many length or distance symbols"
        for (int k = 0; k < ncode; ++k) lengths[kOrder[k]] = (uint8_t)in.bits(3);
        if (!fits()) return short_input();
        if (!zlib_table_ok(lengths, 19, kZCodes)) {
          // no code at all: each length reads as 0 from one bit, then
          // "invalid code -- missing end-of-block"; else "invalid code lengths set"
          bool none = true;
          for (int k = 0; k < 19; ++k) none = none && !lengths[k];
          if (none) {
            for (int k = 0; k < nlen + ndist; ++k) in.bits(1);
            if (!fits()) return short_input();
          }
          return kCorrupt;
        }
        Huffman lencode;
        lencode.build(lengths, 19);
        std::memset(lengths, 0, sizeof(lengths));
        int idx = 0;
        while (idx < nlen + ndist) {
          const int sym = in.decode(lencode);
          if (!fits()) return short_input();
          if (sym < 16) {
            lengths[idx++] = (uint8_t)sym;
            continue;
          }
          int len = 0, rep;
          if (sym == 16) {
            if (idx == 0) return kCorrupt;  // "invalid bit length repeat"
            len = lengths[idx - 1];
            rep = 3 + (int)in.bits(2);
          } else if (sym == 17) {
            rep = 3 + (int)in.bits(3);
          } else {
            rep = 11 + (int)in.bits(7);
          }
          if (!fits()) return short_input();
          if (idx + rep > nlen + ndist) return kCorrupt;  // "invalid bit length repeat"
          while (rep--) lengths[idx++] = (uint8_t)len;
        }
        if (lengths[256] == 0) return kCorrupt;  // "invalid code -- missing end-of-block"
        if (!zlib_table_ok(lengths, nlen, kZLens) || !zlib_table_ok(lengths + nlen, ndist, kZDists))
          return kCorrupt;  // "invalid literal/lengths set", "invalid distances set"
        lit.build(lengths, nlen);
        dist.build(lengths + nlen, ndist);
      }
      while (true) {
        const int sym = in.decode(lit);
        if (sym < 0) return used() + 1 > limit ? short_input() : (int)kCorrupt;
        if (!fits()) return short_input();
        if (sym < 256) {
          if (done) return kOk;  // a literal with no room left
          track();
          if (emit((uint8_t)sym)) return kCorrupt;
          continue;
        }
        if (sym == 256) break;
        const int li = sym - 257;
        if (li >= 29) return kCorrupt;  // "invalid literal/length code"
        const int length = kLenBase[li] + (int)in.bits(kLenExtra[li]);
        if (!fits()) return short_input();
        const int di = in.decode(dist);
        if (di < 0) return used() + 1 > limit ? short_input() : (int)kCorrupt;
        if (!fits()) return short_input();
        if (di >= 30) return kCorrupt;  // "invalid distance code"
        const size_t back = (size_t)kDistBase[di] + in.bits(kDistExtra[di]);
        if (!fits()) return short_input();
        if (done) return kOk;  // a match with no room left
        track();
        if (back > out.size()) return kCorrupt;  // "invalid distance too far back"
        for (int k = 0; k < length; ++k) {
          if (done) return kOk;
          const size_t before = row;
          if (emit(out[out.size() - back])) return kCorrupt;
          // a row filled mid-match with the read used up: the rest comes
          // in the decode call of the next read
          if (row != before && !done && k + 1 < length && (used() + 7) / 8 >= ends[seg]) {
            if (++seg == (int)ends.size()) return kSize;
          }
        }
      }
    }
    if (last) {  // the Adler-32 check, big-endian, byte-aligned
      in.align();
      uint32_t sum = 0;
      for (int k = 0; k < 4; ++k) sum = sum << 8 | in.bits(8);
      if (!fits()) return short_input();
      if (sum != adler32(out.data(), out.size())) return kCorrupt;  // "incorrect data check"
      return done ? (int)kOk : (int)kSize;  // the stream ends before the image: more is asked for
    }
  }
}

// PIL's image after load: the tile decoded into zeros, then convert("L")
int png_load(const uint8_t* d, size_t n, PngState& st, std::vector<uint8_t>& gray, int& w,
             int& h) {
  if (!st.tile) return kCorrupt;  // "cannot load this image"
  if (st.has_pal && st.pal.size() / 3 > 256) return kCorrupt;  // "invalid palette size"
  // setimage: extents (0, 0, 0, …) are the whole image
  int64_t x0 = st.tx0, y0 = st.ty0, xs = st.tx1 - st.tx0, ys = st.ty1 - st.ty0;
  if (st.tx0 == 0 && st.tx1 == 0) {
    x0 = y0 = 0;
    xs = st.w;
    ys = st.h;
  }
  if (xs <= 0 || ys <= 0 || x0 + xs > st.w || y0 + ys > st.h)
    return kCorrupt;  // "tile cannot extend outside image"
  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  const int ch = kChannels[st.ctype], depth = st.depth;
  const int64_t bits_pp = (int64_t)ch * depth, bpp = std::max<int64_t>(1, bits_pp / 8);
  static const int x0s[7] = {0, 4, 0, 2, 0, 1, 0}, y0s[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int dxs[7] = {8, 8, 4, 4, 2, 2, 1}, dys[7] = {8, 8, 8, 4, 4, 2, 2};
  const int npass = st.interlace ? 7 : 1;
  std::vector<size_t> rows;
  size_t end = 0;
  for (int p = 0; p < npass; ++p) {
    const int64_t px0 = st.interlace ? x0s[p] : 0, py0 = st.interlace ? y0s[p] : 0;
    const int64_t dx = st.interlace ? dxs[p] : 1, dy = st.interlace ? dys[p] : 1;
    const int64_t pw = (xs - px0 + dx - 1) / dx, ph = (ys - py0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const size_t stride = (size_t)((pw * bits_pp + 7) / 8);
    for (int64_t r = 0; r < ph; ++r) rows.push_back(end += stride + 1);
  }
  std::vector<PngRead> reads;
  int term = kCorrupt;
  png_reads(d, n, st, reads, term);
  std::vector<uint8_t> run;
  std::vector<size_t> ends;
  for (const PngRead& r : reads) {
    run.insert(run.end(), d + r.a, d + r.b);
    ends.push_back(run.size());
  }
  std::vector<uint8_t> raw, line;
  int seg = 0;
  int rc = ends.empty() ? (int)kSize : png_inflate(run.data(), run.size(), ends, rows, raw, seg);
  if (rc == kSize) return term;
  if (rc) return rc;
  w = (int)st.w;
  h = (int)st.h;
  uint8_t pal[256 * 3] = {0};
  const size_t npal = st.has_pal ? st.pal.size() / 3 : 0;
  if (npal) std::memcpy(pal, st.pal.data(), npal * 3);
  const uint8_t zero = st.ctype == 3 ? pil_luma(pal[0], pal[1], pal[2]) : 0;
  gray.assign((size_t)w * h, zero);
  size_t off = 0;
  for (int p = 0; p < npass; ++p) {
    const int64_t px0 = st.interlace ? x0s[p] : 0, py0 = st.interlace ? y0s[p] : 0;
    const int64_t dx = st.interlace ? dxs[p] : 1, dy = st.interlace ? dys[p] : 1;
    const int64_t pw = (xs - px0 + dx - 1) / dx, ph = (ys - py0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const int stride = (int)((pw * bits_pp + 7) / 8);
    if (!unfilter(raw.data() + off, (int)ph, stride, (int)bpp, line)) return kCorrupt;
    off += (size_t)ph * (stride + 1);
    for (int64_t py = 0; py < ph; ++py) {
      const uint8_t* r = line.data() + (size_t)py * stride;
      uint8_t* o = gray.data() + (size_t)(y0 + py0 + py * dy) * w + x0 + px0;
      for (int64_t px = 0; px < pw; ++px) {
        uint8_t v;
        if (depth < 8) {  // packed gray or palette index, MSB first
          const int64_t bit = px * depth;
          const int s = (r[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
          if (st.ctype == 3) v = (size_t)s < npal ? pil_luma(pal[3 * s], pal[3 * s + 1], pal[3 * s + 2]) : 0;
          else v = (uint8_t)(depth == 1 ? s * 255 : depth == 2 ? s * 85 : s * 17);
        } else if (depth == 8) {
          const uint8_t* q = r + (size_t)px * ch;
          if (st.ctype == 3) v = q[0] < npal ? pil_luma(pal[3 * q[0]], pal[3 * q[0] + 1], pal[3 * q[0] + 2]) : 0;
          else if (ch <= 2) v = q[0];
          else v = pil_luma(q[0], q[1], q[2]);
        } else {  // 16 bit, big endian
          const uint8_t* q = r + (size_t)px * ch * 2;
          if (st.ctype == 0) v = (uint8_t)std::min(255, (q[0] << 8) | q[1]);
          else if (ch == 2) v = q[0];
          else v = pil_luma(q[0], q[2], q[4]);
        }
        o[px * dx] = v;
      }
    }
  }
  st.seq = reads[seg].seq;
  return png_tail(d, n, reads[seg].chunk_end, st);
}

// A PNG's open and load: kOk, kPassOn (the open passes it on), kCorrupt, or
// kLoadPassOn (a load error of the pass-on kinds)
int png_read(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  PngState st;
  const int rc = png_open(d, n, st);
  if (rc) return rc;
  return png_load(d, n, st, gray, w, h);
}

int decode_png(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  const int rc = png_read(d, n, gray, w, h);
  return rc == kLoadPassOn ? kCorrupt : rc;
}

int probe_png(const uint8_t* d, size_t n, int& w, int& h) {
  PngState st;
  const int rc = png_open(d, n, st);
  w = (int)st.w;
  h = (int)st.h;
  return rc;
}
