// QOI, Sun raster, PCX (and DCX), SGI, TGA and PCD as PIL 12.1 reads them, then
// convert("L"): each plugin's open (QoiImagePlugin, SunImagePlugin,
// PcxImagePlugin, SgiImagePlugin, TgaImagePlugin) with the errors that pass
// a file on to the next plugin returned as kPassOn, and the decoders its
// tiles name: QoiDecoder (Python), Pillow's raw decoder, sun_rle, pcx,
// sgi_rle with the SGI16 Python decoder, and tga_rle, each with the checks
// and quirks found by probing PIL (its C decoders are not readable here):
//   - QOI: the Python decoder's hash table and its reads past the end
//     (IndexError, or a short pixel that fails to unpack: both raise);
//   - Sun: rows padded to 16 bits when raw, unpadded under RLE, whose runs
//     continue across rows; an 8-bit or 4-bit image with a colour map reads
//     as P through the planar "RGB;L" palette; a 1-bit or RGB image with one
//     raises ("unrecognized image mode"), as does a map of over 256 colours;
//   - PCX: PIL's own stride (rounded up to even when the header's differs),
//     the decoder's move of the planes together (bit planes to (width + 7)
//     / 8 bytes apart, byte planes to the width, where the line holds more;
//     a 1- or 3-pixel RGB line it leaves as it is), a run past the end of a
//     line (an overrun: an error); the 256-colour palette at the end only
//     when the file's last 769 bytes start with 12;
//   - SGI: raw bands one after another, or RLE rows through the offset and
//     length tables, with sgi_rle's bounds (an offset before the data fails;
//     the codes are held to the file, not to the row's length; a copy may
//     not reach the last byte of the file), its early stop (the last code a
//     row's length allows, when not 0, ends the image, the rest left black)
//     and its one row buffer, which a short row leaves as the row before
//     left it; rows bottom-up;
//   - TGA: reached only when every earlier plugin has passed the file on;
//     image types 1-3 and 9-11, depths 1, 8, 16, 24, 32; colour maps of 16
//     and 24 bits from their first index (32 bits: "unrecognized raw mode"),
//     applied to colour-mapped images only; a literal packet continues
//     across rows, a run does not (an overrun); RLE at depth 1 never ends
//     (PIL: "image file is truncated"); bit 0x20 top-down, bit 0x10 flipped
//     left to right after decoding.
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_pil.h and native_bmp.h.

inline int rs_be16(const uint8_t* p) { return p[0] << 8 | p[1]; }

// Pillow's putpalette: the palette's entries (len · 8 / bits of the raw
// mode), more than 256 fail ("invalid palette size")
inline bool palette_fits(size_t bytes, int entry_bytes) { return bytes / entry_bytes <= 256; }

// =================================================================== QOI
struct QoiInfo {
  int w = 0, h = 0, bands = 3;
};

int qoi_open(const uint8_t* d, size_t n, QoiInfo& q) {
  if (n < 13) return kPassOn;  // i32 of a short read, or read(1)[0]: struct.error, IndexError
  const uint32_t w = be32(d + 4), h = be32(d + 8);
  q.bands = d[12] == 3 ? 3 : 4;
  if (w == 0 || h == 0) return kPassOn;  // "not identified by this driver"
  if (w > (1u << 24) || h > (1u << 24) || (uint64_t)w * h > kMaxPixels) return kCorrupt;
  q.w = (int)w;
  q.h = (int)h;
  return kOk;
}

int probe_qoi(const uint8_t* d, size_t n, int& w, int& h) {
  QoiInfo q;
  const int rc = qoi_open(d, n, q);
  w = q.w;
  h = q.h;
  return rc;
}

int decode_qoi(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  QoiInfo q;
  const int rc = qoi_open(d, n, q);
  if (rc) return rc;
  w = q.w;
  h = q.h;
  const size_t npx = (size_t)w * h;
  gray.resize(npx);
  uint8_t seen[64][4];
  bool have[64] = {false};
  uint8_t prev[4] = {0, 0, 0, 255};
  size_t pos = 14, out = 0;  // the colour space byte is skipped
  auto emit = [&](const uint8_t* v) {
    if (out < npx) gray[out] = pil_luma(v[0], v[1], v[2]);
    ++out;
  };
  while (out < npx) {
    if (pos >= n) return kCorrupt;  // read(1)[0]: IndexError
    const int byte = d[pos++];
    uint8_t v[4];
    if (byte == 0xFE || byte == 0xFF) {  // QOI_OP_RGB, QOI_OP_RGBA
      const size_t k = byte == 0xFE ? 3 : 4;
      if (n - pos < k) return kCorrupt;  // a short pixel: "not enough values to unpack"
      std::memcpy(v, d + pos, k);
      if (k == 3) v[3] = prev[3];
      pos += k;
    } else if ((byte >> 6) == 0) {  // QOI_OP_INDEX, (0, 0, 0, 0) where nothing was stored
      const int i = byte & 63;
      if (have[i]) std::memcpy(v, seen[i], 4);
      else std::memset(v, 0, 4);
    } else if ((byte >> 6) == 1) {  // QOI_OP_DIFF
      v[0] = (uint8_t)(prev[0] + ((byte >> 4) & 3) - 2);
      v[1] = (uint8_t)(prev[1] + ((byte >> 2) & 3) - 2);
      v[2] = (uint8_t)(prev[2] + (byte & 3) - 2);
      v[3] = prev[3];
    } else if ((byte >> 6) == 2) {  // QOI_OP_LUMA
      if (pos >= n) return kCorrupt;
      const int second = d[pos++];
      const int dg = (byte & 63) - 32;
      v[0] = (uint8_t)(prev[0] + dg + ((second >> 4) & 15) - 8);
      v[1] = (uint8_t)(prev[1] + dg);
      v[2] = (uint8_t)(prev[2] + dg + (second & 15) - 8);
      v[3] = prev[3];
    } else {  // QOI_OP_RUN: the previous pixel again, not hashed
      for (int r = (byte & 63) + 1; r > 0; --r) emit(prev);
      continue;
    }
    std::memcpy(prev, v, 4);
    const int hsh = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(seen[hsh], v, 4);
    have[hsh] = true;
    emit(v);
  }
  return kOk;
}

// ============================================================ Sun raster
struct SunInfo {
  int w = 0, h = 0, depth = 0, type = 0;
  PilMode mode = kModeNone;
  std::string raw;
  size_t data = 32;
  const uint8_t* pal = nullptr;  // the colour map as read ("RGB;L": R, G, B planes)
  size_t pal_bytes = 0;
  bool has_pal = false;
};

int sun_open(const uint8_t* d, size_t n, SunInfo& s) {
  if (n < 32) return kPassOn;  // i32 of a short header: struct.error
  const uint32_t w = be32(d + 4), h = be32(d + 8), depth = be32(d + 12);
  const uint32_t type = be32(d + 20), pal_type = be32(d + 24), pal_len = be32(d + 28);
  s.depth = (int)depth;
  s.type = (int)type;
  switch (depth) {
    case 1: s.mode = kMode1; s.raw = "1;I"; break;
    case 4: s.mode = kModeL; s.raw = "L;4"; break;
    case 8: s.mode = kModeL; s.raw = "L"; break;
    case 24: s.mode = kModeRGB; s.raw = type == 3 ? "RGB" : "BGR"; break;
    case 32: s.mode = kModeRGB; s.raw = type == 3 ? "RGBX" : "BGRX"; break;
    default: return kPassOn;  // "Unsupported Mode/Bit Depth"
  }
  if (pal_len) {
    if (pal_len > 1024 || pal_type != 1) return kPassOn;
    s.has_pal = true;
    s.pal = d + 32;
    s.pal_bytes = std::min<size_t>(pal_len, n - 32);
    s.data += pal_len;
    if (s.mode == kModeL) {
      s.mode = kModeP;
      s.raw = depth == 4 ? "P;4" : "P";
    }
  }
  if (type > 5) return kPassOn;  // "Unsupported Sun Raster file type"
  if (w == 0 || h == 0) return kPassOn;
  if (w > (1u << 24) || h > (1u << 24) || (uint64_t)w * h > kMaxPixels) return kCorrupt;
  s.w = (int)w;
  s.h = (int)h;
  return kOk;
}

int probe_sun(const uint8_t* d, size_t n, int& w, int& h) {
  SunInfo s;
  const int rc = sun_open(d, n, s);
  w = s.w;
  h = s.h;
  return rc;
}

// sun_rle: a 0x80 byte starts a run (0x80, count - 1, value) or, followed by
// 0, is a literal 0x80; runs continue across rows; rows are not padded
int sun_rle(const uint8_t* d, size_t n, size_t pos, PilImage& im, const UnpackerDef& u) {
  const int64_t bytes = ((int64_t)im.w * u.bits + 7) / 8;
  std::vector<uint8_t> row((size_t)bytes);
  int64_t x = 0;
  int y = 0;
  auto put = [&](int v, int64_t count) {  // false once the image is complete
    while (count > 0) {
      const int64_t k = std::min(count, bytes - x);
      std::memset(row.data() + x, v, (size_t)k);
      x += k;
      count -= k;
      if (x >= bytes) {
        unpack(u.op, im.at(0, y), row.data(), im.w);
        x = 0;
        if (++y >= im.h) return false;
      }
    }
    return true;
  };
  while (true) {
    if (pos >= n) return kCorrupt;  // "image file is truncated"
    if (d[pos] == 0x80) {
      if (n - pos < 2) return kCorrupt;
      if (d[pos + 1] == 0) {
        pos += 2;
        if (!put(0x80, 1)) return kOk;
      } else {
        if (n - pos < 3) return kCorrupt;
        const int count = d[pos + 1] + 1, v = d[pos + 2];
        pos += 3;
        if (!put(v, count)) return kOk;
      }
    } else {
      if (!put(d[pos++], 1)) return kOk;
    }
  }
}

int decode_sun(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  SunInfo s;
  int rc = sun_open(d, n, s);
  if (rc) return rc;
  w = s.w;
  h = s.h;
  PilImage im;
  im.alloc(s.mode, w, h);
  if (s.has_pal) {
    // realized at load: on P through the planar RGB;L raw mode; on 1 or RGB
    // putpalette fails ("unrecognized image mode")
    if (s.mode != kModeP) return kSunPalette;
    if (!palette_fits(s.pal_bytes, 3)) return kSunPalette;
    const size_t k = s.pal_bytes / 3;
    for (size_t i = 0; i < k; ++i)
      for (int c = 0; c < 3; ++c) im.pal[3 * i + c] = s.pal[i + c * k];
    im.pal_n = (int)k;
  }
  const UnpackerDef* u = find_unpacker(s.mode, s.raw);
  if (!u) return kCorrupt;
  if (s.type == 2) {
    rc = sun_rle(d, n, s.data, im, *u);
  } else {
    const int64_t stride = (((int64_t)w * s.depth + 15) / 16) * 2;
    rc = raw_decode(d, n, s.data, im, 0, 0, w, h, *u, stride, 1);
  }
  if (rc) return rc;
  return pil_to_gray(im, gray);
}

// =================================================================== PCX
struct PcxInfo {
  int w = 0, h = 0, bits = 0, planes = 0;
  int64_t stride = 0;
  PilMode mode = kModeNone;
  std::string raw;
  uint8_t pal[256 * 3] = {0};
  int pal_n = 0;
};

// the header at `at` (a DCX's frame; the 256-colour palette is still the
// file's last 769 bytes)
int pcx_open(const uint8_t* d, size_t n, PcxInfo& p, size_t at = 0) {
  if (at > n || n - at < 68) return kPassOn;  // _accept or i16(s, 66) of a short read
  d += at;
  n -= at;
  if (d[0] != 10 || (d[1] != 0 && d[1] != 2 && d[1] != 3 && d[1] != 5))
    return kPassOn;  // "not a PCX file"
  const int x0 = d[4] | d[5] << 8, y0 = d[6] | d[7] << 8;
  const int x1 = (d[8] | d[9] << 8) + 1, y1 = (d[10] | d[11] << 8) + 1;
  if (x1 <= x0 || y1 <= y0) return kPassOn;  // "bad PCX image size"
  const int version = d[1];
  p.bits = d[3];
  p.planes = d[65];
  const int provided = d[66] | d[67] << 8;
  if (p.bits == 1 && p.planes == 1) {
    p.mode = kMode1;
    p.raw = "1";
  } else if (p.bits == 1 && (p.planes == 2 || p.planes == 4)) {
    p.mode = kModeP;
    p.raw = p.planes == 2 ? "P;2L" : "P;4L";
    std::memcpy(p.pal, d + 16, 48);
    p.pal_n = 16;
  } else if (version == 5 && p.bits == 8 && p.planes == 1) {
    p.mode = kModeL;
    p.raw = "L";
    // fp.seek(-769, SEEK_END) on a file: a shorter one fails (EINVAL)
    if (n + at < 769) return kCorrupt;
    const uint8_t* s = d + n - 769;
    if (s[0] == 12) {
      for (int i = 0; i < 256; ++i)
        if (s[3 * i + 1] != i || s[3 * i + 2] != i || s[3 * i + 3] != i) {
          p.mode = kModeP;
          p.raw = "P";
          break;
        }
      if (p.mode == kModeP) {
        std::memcpy(p.pal, s + 1, 768);
        p.pal_n = 256;
      }
    }
  } else if (version == 5 && p.bits == 8 && p.planes == 3) {
    p.mode = kModeRGB;
    p.raw = "RGB;L";
  } else {
    return kPcxMode;  // OSError: "unknown PCX mode"
  }
  p.w = x1 - x0;
  p.h = y1 - y0;
  if ((uint64_t)p.w * p.h > kMaxPixels) return kCorrupt;  // DecompressionBombError
  p.stride = ((int64_t)p.w * p.bits + 7) / 8;
  if (provided != p.stride) p.stride += p.stride % 2;
  return kOk;
}

int probe_pcx(const uint8_t* d, size_t n, int& w, int& h) {
  PcxInfo p;
  const int rc = pcx_open(d, n, p);
  w = p.w;
  h = p.h;
  return rc;
}

int decode_pcx_at(const uint8_t* d, size_t n, size_t at, std::vector<uint8_t>& gray, int& w,
                  int& h) {
  PcxInfo p;
  const int rc = pcx_open(d, n, p, at);
  if (rc) return rc;
  w = p.w;
  h = p.h;
  PilImage im;
  im.alloc(p.mode, w, h);
  std::memcpy(im.pal, p.pal, sizeof(p.pal));
  im.pal_n = p.pal_n;
  const UnpackerDef* u = find_unpacker(p.mode, p.raw);
  if (!u) return kCorrupt;
  const int64_t bytes = p.planes * p.stride;  // the decoder's line
  if (((int64_t)w * u->bits + 7) / 8 > bytes) return kCorrupt;
  std::vector<uint8_t> line((size_t)bytes);
  int64_t x = 0;
  int y = 0;
  bool overrun = false;
  size_t pos = at + 128;
  while (true) {
    if (pos >= n) return kCorrupt;  // "image file is truncated"
    if ((d[pos] & 0xC0) == 0xC0) {
      if (n - pos < 2) return kCorrupt;
      for (int k = d[pos] & 0x3F; k > 0; --k) {
        if (x >= bytes) {  // IMAGING_CODEC_OVERRUN: the rest of the run is dropped
          overrun = true;
          break;
        }
        line[(size_t)x++] = d[pos + 1];
      }
      pos += 2;
    } else {
      line[(size_t)x++] = d[pos++];
    }
    if (x >= bytes) {
      // the decoder moves the planes together: bit planes (2 and 4) to
      // (w + 7) / 8 bytes apart, byte planes to w bytes apart
      int64_t xs, bands, stride = 0;
      if (u->bits == 2 || u->bits == 4) {
        xs = (w + 7) / 8;
        bands = u->bits;
        stride = bytes / u->bits;
      } else {
        xs = w;
        bands = bytes / w;
        if (bands) stride = bytes / bands;
      }
      if (stride > xs)
        for (int64_t i = 1; i < bands; ++i)
          std::memmove(&line[(size_t)(i * xs)], &line[(size_t)(i * stride)], (size_t)xs);
      unpack(u->op, im.at(0, y), line.data(), w);
      x = 0;
      if (++y >= h) break;
    }
  }
  if (overrun) return kCorrupt;  // "buffer overrun when reading image file"
  return pil_to_gray(im, gray);
}

int decode_pcx(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  return decode_pcx_at(d, n, 0, gray, w, h);
}

// =================================================================== DCX
// DcxImagePlugin: a table of up to 1024 offsets ended by 0 (an entry cut
// short passes the file on, as does an empty table: seek(0) raises
// EOFError); frame 0 is PcxImageFile's open at the first offset.
int dcx_open(const uint8_t* d, size_t n, size_t& first) {
  size_t pos = 4;
  int count = 0;
  for (int i = 0; i < 1024; ++i) {
    if (n - pos < 4) return kPassOn;  // i32 of a short read: struct.error
    const uint32_t off = le32(d + pos);
    pos += 4;
    if (!off) break;
    if (!count++) first = off;
  }
  return count ? kOk : kPassOn;
}

int probe_dcx(const uint8_t* d, size_t n, int& w, int& h) {
  size_t first = 0;
  int rc = dcx_open(d, n, first);
  if (rc) return rc;
  PcxInfo p;
  rc = pcx_open(d, n, p, first);
  w = p.w;
  h = p.h;
  return rc;
}

int decode_dcx(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  size_t first = 0;
  const int rc = dcx_open(d, n, first);
  return rc ? rc : decode_pcx_at(d, n, first, gray, w, h);
}

// =================================================================== SGI
struct SgiInfo {
  int w = 0, h = 0, bpc = 0, zsize = 0, compression = 0;
  PilMode mode = kModeNone;
};

int sgi_open(const uint8_t* d, size_t n, SgiInfo& s) {
  if (n < 12) return kPassOn;  // i16 of a short header: struct.error
  s.compression = d[2];
  s.bpc = d[3];
  const int dim = rs_be16(d + 4);
  s.w = rs_be16(d + 6);
  s.h = rs_be16(d + 8);
  s.zsize = rs_be16(d + 10);
  if (s.bpc != 1 && s.bpc != 2) return kSgiMode;
  if ((dim == 1 || dim == 2) && s.zsize == 1) s.mode = kModeL;
  else if (dim == 3 && s.zsize == 3) s.mode = kModeRGB;
  else if (dim == 3 && s.zsize == 4) s.mode = kModeRGBA;
  else return kSgiMode;  // ValueError: "Unsupported SGI image mode"
  if (s.w == 0 || s.h == 0) return kPassOn;
  if ((uint64_t)s.w * s.h > kMaxPixels) return kCorrupt;  // DecompressionBombError
  return kOk;
}

int probe_sgi(const uint8_t* d, size_t n, int& w, int& h) {
  SgiInfo s;
  const int rc = sgi_open(d, n, s);
  w = s.w;
  h = s.h;
  return rc;
}

// sgi_rle's expandrow / expandrow2: `codes` codes at most; 0 done, 1 the
// image ends here (the last code is not 0), -1 an overrun
int sgi_expand(const uint8_t* buf, size_t bufsize, size_t src, int64_t codes, int bpc,
               uint8_t* dest, int z, int xsize) {
  const size_t end = bufsize - 1;  // the last byte: the decoder's end_of_buffer
  int x = 0;
  for (; codes > 0; --codes) {
    if (src + (bpc - 1) > end) return -1;
    const int pixel = buf[src + bpc - 1];
    src += bpc;
    if (codes == 1 && pixel != 0) return 1;
    const int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + (size_t)bpc * count > end) return -1;
      for (int i = 0; i < count; ++i, src += bpc, dest += z * bpc)
        std::memcpy(dest, buf + src, bpc);
    } else {
      if (bpc == 1 ? src > end : src + 2 > end) return -1;
      for (int i = 0; i < count; ++i, dest += z * bpc) std::memcpy(dest, buf + src, bpc);
      src += bpc;
    }
  }
  return 0;
}

int decode_sgi(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  SgiInfo s;
  int rc = sgi_open(d, n, s);
  if (rc) return rc;
  w = s.w;
  h = s.h;
  if (s.compression > 1) return kSgiCompression;  // no tile: "cannot load this image"
  PilImage im;
  im.alloc(s.mode, w, h);
  const int z = pil_bands(s.mode);
  const size_t page = (size_t)w * h;
  if (s.compression == 0) {  // bands one after another, rows bottom-up
    const size_t band = page * s.bpc;
    if (n < 512 || (n - 512) / band < (size_t)z) return kCorrupt;  // truncated
    for (int c = 0; c < z; ++c) {
      const uint8_t* p = d + 512 + c * band;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
          im.at(x, h - 1 - y)[z == 1 ? 0 : c] = p[((size_t)y * w + x) * s.bpc];
    }
    return pil_to_gray(im, gray);
  }
  if (n < 512) return kCorrupt;
  const size_t bufsize = n - 512;
  const uint8_t* buf = d + 512;
  const size_t tablen = (size_t)z * h;
  if (bufsize < 8 * tablen) return kCorrupt;
  std::vector<uint8_t> row((size_t)w * z * 2, 0);  // one buffer for every row
  for (int r = 0; r < h; ++r) {
    for (int c = 0; c < z; ++c) {
      const uint32_t off = be32(buf + 4 * (r + (size_t)c * h));
      const uint32_t len = be32(buf + 4 * tablen + 4 * (r + (size_t)c * h));
      if (off < 512) return kCorrupt;  // before the data (the length is not checked)
      const int st = sgi_expand(buf, bufsize, off - 512, (int32_t)len, s.bpc,
                                row.data() + c * s.bpc, z, w);
      if (st == -1) return kCorrupt;
      if (st == 1) return pil_to_gray(im, gray);  // the rows not reached stay black
    }
    uint8_t* o = im.at(0, h - 1 - r);
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < z; ++c) o[4 * x + (z == 1 ? 0 : c)] = row[((size_t)x * z + c) * s.bpc];
  }
  return pil_to_gray(im, gray);
}

// =================================================================== TGA
struct TgaInfo {
  int w = 0, h = 0, depth = 0, itype = 0;
  bool top_down = false, flip = false, cmap = false;
  PilMode mode = kModeNone;
  std::string raw;  // empty: no tile ("cannot load this image")
  int map_depth = 0;
  size_t map_bytes = 0, map_zero = 0;  // the map's bytes read, and the zero bytes before them
  const uint8_t* map = nullptr;
  size_t data = 0;
};

int tga_open(const uint8_t* d, size_t n, TgaInfo& t) {
  if (n < 18) return kPassOn;  // s[16] of a short header: IndexError
  const int id_len = d[0], cmt = d[1];
  t.itype = d[2];
  t.depth = d[16];
  const int flags = d[17];
  t.w = d[12] | d[13] << 8;
  t.h = d[14] | d[15] << 8;
  if ((cmt != 0 && cmt != 1) || t.w <= 0 || t.h <= 0 ||
      !(t.depth == 1 || t.depth == 8 || t.depth == 16 || t.depth == 24 || t.depth == 32))
    return kPassOn;  // "not a TGA file"
  if (t.itype == 3 || t.itype == 11) {
    t.mode = t.depth == 1 ? kMode1 : t.depth == 16 ? kModeLA : kModeL;
  } else if (t.itype == 1 || t.itype == 9) {
    t.mode = cmt ? kModeP : kModeL;
  } else if (t.itype == 2 || t.itype == 10) {
    t.mode = t.depth == 24 ? kModeRGB : kModeRGBA;
  } else {
    return kPassOn;  // "unknown TGA mode"
  }
  t.top_down = (flags & 0x20) != 0;
  t.flip = (flags & 0x10) != 0;
  size_t pos = 18 + std::min<size_t>(id_len, n - 18);
  t.cmap = cmt == 1;
  if (t.cmap) {
    const int start = d[3] | d[4] << 8, size = d[5] | d[6] << 8;
    t.map_depth = d[7];
    if (t.map_depth != 16 && t.map_depth != 24 && t.map_depth != 32)
      return kPassOn;  // "unknown TGA map depth"
    const int eb = t.map_depth / 8;
    t.map_zero = (size_t)eb * start;
    t.map = d + pos;
    t.map_bytes = std::min<size_t>((size_t)eb * size, n - pos);
    pos += t.map_bytes;
  }
  const int key = t.itype & 7;
  if (key == 1 && t.depth == 8) t.raw = "P";
  else if (key == 3 && t.depth == 1) t.raw = "1";
  else if (key == 3 && t.depth == 8) t.raw = "L";
  else if (key == 3 && t.depth == 16) t.raw = "LA";
  else if (key == 2 && t.depth == 16) t.raw = "BGRA;15Z";
  else if (key == 2 && t.depth == 24) t.raw = "BGR";
  else if (key == 2 && t.depth == 32) t.raw = "BGRA";
  t.data = pos;
  if ((uint64_t)t.w * t.h > kMaxPixels) return kCorrupt;  // DecompressionBombError
  return kOk;
}

int probe_tga(const uint8_t* d, size_t n, int& w, int& h) {
  TgaInfo t;
  const int rc = tga_open(d, n, t);
  w = t.w;
  h = t.h;
  return rc;
}

// tga_rle: a packet's top bit makes it a run of one pixel, else a literal
// of (low 7 bits + 1) pixels; literals continue across rows, runs may not
int tga_rle(const uint8_t* d, size_t n, size_t pos, PilImage& im, const UnpackerDef& u,
            int depth, bool top_down) {
  const int64_t bytes = ((int64_t)im.w * u.bits + 7) / 8;
  const int pb = depth / 8;  // bytes per pixel: 0 at depth 1, where no packet moves on
  std::vector<uint8_t> row((size_t)bytes);
  int64_t x = 0;
  int y = top_down ? 0 : im.h - 1;
  const int ystep = top_down ? 1 : -1;
  while (true) {
    if (pos >= n) return kCorrupt;  // "image file is truncated"
    const int64_t count = (int64_t)pb * ((d[pos] & 0x7F) + 1);
    int64_t extra = 0;
    const uint8_t* src;
    int64_t k = count;
    if (d[pos] & 0x80) {
      if (n - pos < (size_t)(1 + pb)) return kCorrupt;
      if (x + count > bytes) return kCorrupt;  // "buffer overrun"
      for (int64_t i = 0; i < count; i += pb) std::memcpy(&row[(size_t)(x + i)], d + pos + 1, pb);
      pos += 1 + pb;
      src = nullptr;
    } else {
      if ((int64_t)(n - pos) < 1 + count) return kCorrupt;
      src = d + pos + 1;
      if (x + count > bytes) {
        k = bytes - x;
        extra = count - k;
      }
      std::memcpy(&row[(size_t)x], src, (size_t)k);
      src += k;
      pos += 1 + count;
    }
    while (true) {
      x += k;
      if (x >= bytes) {
        unpack(u.op, im.at(0, y), row.data(), im.w);
        x = 0;
        y += ystep;
        if (y < 0 || y >= im.h) return kOk;
      }
      if (extra == 0) break;
      k = std::min(extra, bytes);
      std::memcpy(row.data(), src, (size_t)k);
      src += k;
      extra -= k;
    }
  }
}

int decode_tga(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  TgaInfo t;
  int rc = tga_open(d, n, t);
  if (rc) return rc;
  w = t.w;
  h = t.h;
  if (t.raw.empty()) return kTgaKind;  // no tile: "cannot load this image"
  PilImage im;
  im.alloc(t.mode, w, h);
  if (t.cmap) {
    // the map is realized at load: P takes it; 1, RGB and RGBA refuse a map
    // ("unrecognized image mode"), and a 32-bit map has no raw mode PIL maps
    if (t.mode == kMode1 || t.mode == kModeRGB || t.mode == kModeRGBA) return kTgaMap;
    if (t.map_depth == 32) return kTgaMap;
    const int eb = t.map_depth / 8;
    if (!palette_fits(t.map_zero + t.map_bytes, eb)) return kTgaMap;  // "invalid palette size"
    if (t.mode == kModeP) {
      const size_t first = t.map_zero / eb, k = t.map_bytes / eb;
      for (size_t i = 0; i < k; ++i) {
        const uint8_t* e = t.map + eb * i;
        uint8_t* o = im.pal + 3 * (first + i);
        if (eb == 3) {
          o[0] = e[2]; o[1] = e[1]; o[2] = e[0];
        } else {
          const int p = e[0] | e[1] << 8;
          o[0] = (uint8_t)(((p >> 10) & 31) * 255 / 31);
          o[1] = (uint8_t)(((p >> 5) & 31) * 255 / 31);
          o[2] = (uint8_t)((p & 31) * 255 / 31);
        }
      }
      im.pal_n = (int)((t.map_zero + t.map_bytes) / eb);
    }
  }
  const UnpackerDef* u = find_unpacker(t.mode, t.raw);
  if (!u) return kTgaKind;  // "unknown raw mode for given image mode"
  if (t.itype & 8) rc = tga_rle(d, n, t.data, im, *u, t.depth, t.top_down);
  else rc = raw_decode(d, n, t.data, im, 0, 0, w, h, *u, 0, t.top_down ? 1 : -1);
  if (rc) return rc;
  if (t.flip)
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w / 2; ++x)
        for (int b = 0; b < 4; ++b) std::swap(im.at(x, y)[b], im.at(w - 1 - x, y)[b]);
  return pil_to_gray(im, gray);
}

// =================================================================== PCD
// PcdImagePlugin: "PCD_" at 2048 (no accept test), the orientation in the
// low bits of byte 3586; Pillow's pcd decoder over the 768 × 512 base image
// at 96 · 2048: chunks of two luma rows and the half-width Cb and Cr of
// both (PcdDecode.c), through the "YCC;P" unpacker's PhotoYCC tables
// (UnpackYCC.c: R = L[y] + Cr[cr], G = L[y] + Gb[cb] + Gr[cr], B = L[y] +
// Cb[cb], each clamped to 0..255; read out of PIL over all 2^24 inputs);
// orientation 1 and 3 rotate by 90 and 270 degrees (counter-clockwise) in
// load_end
const int16_t kPcdL[256] = {
    0, 1, 3, 4, 5, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19, 20, 22, 23, 24, 26, 27, 29, 30, 31,
    33, 34, 35, 37, 38, 39, 41, 42, 43, 45, 46, 48, 49, 50, 52, 53, 54, 56, 57, 58, 60, 61, 62,
    64, 65, 67, 68, 69, 71, 72, 73, 75, 76, 77, 79, 80, 82, 83, 84, 86, 87, 88, 90, 91, 92, 94,
    95, 96, 98, 99, 101, 102, 103, 105, 106, 107, 109, 110, 111, 113, 114, 115, 117, 118, 120,
    121, 122, 124, 125, 126, 128, 129, 130, 132, 133, 134, 136, 137, 139, 140, 141, 143, 144,
    145, 147, 148, 149, 151, 152, 153, 155, 156, 158, 159, 160, 162, 163, 164, 166, 167, 168,
    170, 171, 173, 174, 175, 177, 178, 179, 181, 182, 183, 185, 186, 187, 189, 190, 192, 193,
    194, 196, 197, 198, 200, 201, 202, 204, 205, 206, 208, 209, 211, 212, 213, 215, 216, 217,
    219, 220, 221, 223, 224, 225, 227, 228, 230, 231, 232, 234, 235, 236, 238, 239, 240, 242,
    243, 245, 246, 247, 249, 250, 251, 253, 254, 255, 257, 258, 259, 261, 262, 264, 265, 266,
    268, 269, 270, 272, 273, 274, 276, 277, 278, 280, 281, 283, 284, 285, 287, 288, 289, 291,
    292, 293, 295, 296, 297, 299, 300, 302, 303, 304, 306, 307, 308, 310, 311, 312, 314, 315,
    317, 318, 319, 321, 322, 323, 325, 326, 327, 329, 330, 331, 333, 334, 336, 337, 338, 340,
    341, 342, 344, 345, 346};
const int16_t kPcdCb[256] = {
    -345, -343, -341, -338, -336, -334, -332, -329, -327, -325, -323, -321, -318, -316, -314,
    -312, -310, -307, -305, -303, -301, -298, -296, -294, -292, -290, -287, -285, -283, -281,
    -278, -276, -274, -272, -270, -267, -265, -263, -261, -258, -256, -254, -252, -250, -247,
    -245, -243, -241, -239, -236, -234, -232, -230, -227, -225, -223, -221, -219, -216, -214,
    -212, -210, -207, -205, -203, -201, -199, -196, -194, -192, -190, -188, -185, -183, -181,
    -179, -176, -174, -172, -170, -168, -165, -163, -161, -159, -156, -154, -152, -150, -148,
    -145, -143, -141, -139, -137, -134, -132, -130, -128, -125, -123, -121, -119, -117, -114,
    -112, -110, -108, -105, -103, -101, -99, -97, -94, -92, -90, -88, -85, -83, -81, -79, -77,
    -74, -72, -70, -68, -66, -63, -61, -59, -57, -54, -52, -50, -48, -46, -43, -41, -39, -37,
    -34, -32, -30, -28, -26, -23, -21, -19, -17, -15, -12, -10, -8, -6, -3, -1, 0, 2, 4, 7, 9,
    11, 13, 16, 18, 20, 22, 24, 27, 29, 31, 33, 35, 38, 40, 42, 44, 47, 49, 51, 53, 55, 58, 60,
    62, 64, 67, 69, 71, 73, 75, 78, 80, 82, 84, 86, 89, 91, 93, 95, 98, 100, 102, 104, 106,
    109, 111, 113, 115, 118, 120, 122, 124, 126, 129, 131, 133, 135, 138, 140, 142, 144, 146,
    149, 151, 153, 155, 157, 160, 162, 164, 166, 169, 171, 173, 175, 177, 180, 182, 184, 186,
    189, 191, 193, 195, 197, 200, 202, 204, 206, 208, 211, 213, 215, 217, 220};
const int16_t kPcdGb[256] = {
    67, 67, 66, 66, 65, 65, 65, 64, 64, 63, 63, 62, 62, 62, 61, 61, 60, 60, 59, 59, 59, 58, 58,
    57, 57, 56, 56, 56, 55, 55, 54, 54, 53, 53, 52, 52, 52, 51, 51, 50, 50, 49, 49, 49, 48, 48,
    47, 47, 46, 46, 46, 45, 45, 44, 44, 43, 43, 43, 42, 42, 41, 41, 40, 40, 40, 39, 39, 38, 38,
    37, 37, 37, 36, 36, 35, 35, 34, 34, 34, 33, 33, 32, 32, 31, 31, 31, 30, 30, 29, 29, 28, 28,
    28, 27, 27, 26, 26, 25, 25, 25, 24, 24, 23, 23, 22, 22, 22, 21, 21, 20, 20, 19, 19, 19, 18,
    18, 17, 17, 16, 16, 15, 15, 15, 14, 14, 13, 13, 12, 12, 12, 11, 11, 10, 10, 9, 9, 9, 8, 8,
    7, 7, 6, 6, 6, 5, 5, 4, 4, 3, 3, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0, -1, -1, -2, -2, -2, -3, -3,
    -4, -4, -5, -5, -5, -6, -6, -7, -7, -8, -8, -8, -9, -9, -10, -10, -11, -11, -11, -12, -12,
    -13, -13, -14, -14, -14, -15, -15, -16, -16, -17, -17, -18, -18, -18, -19, -19, -20, -20,
    -21, -21, -21, -22, -22, -23, -23, -24, -24, -24, -25, -25, -26, -26, -27, -27, -27, -28,
    -28, -29, -29, -30, -30, -30, -31, -31, -32, -32, -33, -33, -33, -34, -34, -35, -35, -36,
    -36, -36, -37, -37, -38, -38, -39, -39, -39, -40, -40, -41, -41, -42};
const int16_t kPcdCr[256] = {
    -249, -247, -245, -243, -241, -239, -238, -236, -234, -232, -230, -229, -227, -225, -223,
    -221, -219, -218, -216, -214, -212, -210, -208, -207, -205, -203, -201, -199, -198, -196,
    -194, -192, -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172, -170, -168,
    -167, -165, -163, -161, -159, -157, -156, -154, -152, -150, -148, -147, -145, -143, -141,
    -139, -137, -136, -134, -132, -130, -128, -127, -125, -123, -121, -119, -117, -116, -114,
    -112, -110, -108, -106, -105, -103, -101, -99, -97, -96, -94, -92, -90, -88, -86, -85, -83,
    -81, -79, -77, -76, -74, -72, -70, -68, -66, -65, -63, -61, -59, -57, -55, -54, -52, -50,
    -48, -46, -45, -43, -41, -39, -37, -35, -34, -32, -30, -28, -26, -25, -23, -21, -19, -17,
    -15, -14, -12, -10, -8, -6, -4, -3, -1, 0, 2, 4, 5, 7, 9, 11, 13, 15, 16, 18, 20, 22, 24,
    26, 27, 29, 31, 33, 35, 36, 38, 40, 42, 44, 46, 47, 49, 51, 53, 55, 56, 58, 60, 62, 64, 66,
    67, 69, 71, 73, 75, 77, 78, 80, 82, 84, 86, 87, 89, 91, 93, 95, 97, 98, 100, 102, 104, 106,
    107, 109, 111, 113, 115, 117, 118, 120, 122, 124, 126, 128, 129, 131, 133, 135, 137, 138,
    140, 142, 144, 146, 148, 149, 151, 153, 155, 157, 158, 160, 162, 164, 166, 168, 169, 171,
    173, 175, 177, 179, 180, 182, 184, 186, 188, 189, 191, 193, 195, 197, 199, 200, 202, 204,
    206, 208, 209, 211, 213, 215};
const int16_t kPcdGr[256] = {
    127, 126, 125, 124, 123, 122, 121, 121, 120, 119, 118, 117, 116, 115, 114, 113, 112, 111,
    110, 109, 108, 108, 107, 106, 105, 104, 103, 102, 101, 100, 99, 98, 97, 96, 95, 95, 94, 93,
    92, 91, 90, 89, 88, 87, 86, 85, 84, 83, 83, 82, 81, 80, 79, 78, 77, 76, 75, 74, 73, 72, 71,
    70, 70, 69, 68, 67, 66, 65, 64, 63, 62, 61, 60, 59, 58, 57, 57, 56, 55, 54, 53, 52, 51, 50,
    49, 48, 47, 46, 45, 45, 44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 32, 31, 30, 29,
    28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 19, 18, 17, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6,
    6, 5, 4, 3, 2, 1, 0, 0, -1, -2, -3, -4, -5, -5, -6, -7, -8, -9, -10, -11, -12, -13, -14,
    -15, -16, -17, -18, -18, -19, -20, -21, -22, -23, -24, -25, -26, -27, -28, -29, -30, -31,
    -31, -32, -33, -34, -35, -36, -37, -38, -39, -40, -41, -42, -43, -44, -44, -45, -46, -47,
    -48, -49, -50, -51, -52, -53, -54, -55, -56, -56, -57, -58, -59, -60, -61, -62, -63, -64,
    -65, -66, -67, -68, -69, -69, -70, -71, -72, -73, -74, -75, -76, -77, -78, -79, -80, -81,
    -82, -82, -83, -84, -85, -86, -87, -88, -89, -90, -91, -92, -93, -94, -94, -95, -96, -97,
    -98, -99, -100, -101, -102, -103, -104, -105, -106, -107, -107, -108};

int pcd_open(const uint8_t* d, size_t n, int& orientation) {
  if (n < 2048 + 1539 || std::memcmp(d + 2048, "PCD_", 4)) return kPassOn;  // IndexError too
  orientation = d[2048 + 1538] & 3;
  return kOk;
}

int probe_pcd(const uint8_t* d, size_t n, int& w, int& h) {
  int o = 0;
  const int rc = pcd_open(d, n, o);
  w = rc ? 0 : (o == 1 || o == 3) ? 512 : 768;
  h = rc ? 0 : (o == 1 || o == 3) ? 768 : 512;
  return rc;
}

int decode_pcd(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  int o = 0;
  const int rc = pcd_open(d, n, o);
  if (rc) return rc;
  constexpr int W = 768, H = 512;
  constexpr size_t kChunk = 3 * W, kAt = 96 * 2048;
  if (n < kAt + kChunk * (H / 2)) return kCorrupt;  // "image file is truncated"
  std::vector<uint8_t> g((size_t)W * H);
  for (int y = 0; y < H; ++y) {
    const uint8_t* c = d + kAt + kChunk * (y / 2);
    for (int x = 0; x < W; ++x) {
      const int l = kPcdL[c[x + (y & 1) * W]], cb = c[(x + 4 * W) / 2], cr = c[(x + 5 * W) / 2];
      g[(size_t)y * W + x] = pil_luma(clip8(l + kPcdCr[cr]), clip8(l + kPcdGb[cb] + kPcdGr[cr]),
                                      clip8(l + kPcdCb[cb]));
    }
  }
  w = (o == 1 || o == 3) ? H : W;
  h = (o == 1 || o == 3) ? W : H;
  gray.resize(g.size());
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x)
      gray[(size_t)y * w + x] = o == 1   ? g[(size_t)x * W + (W - 1 - y)]   // ROTATE_90
                                : o == 3 ? g[(size_t)(H - 1 - x) * W + y]  // ROTATE_270
                                         : g[(size_t)y * W + x];
  return kOk;
}
