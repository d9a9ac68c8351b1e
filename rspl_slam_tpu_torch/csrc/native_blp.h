// BLP and FTEX as PIL 12.1 reads them (BlpImagePlugin, FtexImagePlugin),
// then convert("L").
//
// BLP: _open reads the header (BLP1: compression, alpha flag, size,
// encoding; BLP2: compression, encoding, alpha depth, alpha encoding,
// size); the mode is RGBA where the alpha field is not 0, else RGB. The
// Python decoder reads 16 mipmap offsets and lengths (a short read is
// "Truncated File Read") and then frame 0:
//   - BLP1, compression 0: a JPEG made of the header stored after the
//     table and mipmap 0, read by JpegImageFile (four components as
//     CMYK: the plugin sets the JPEG mode "CMYK", so YCCK is not
//     converted), converted to RGB, and taken as BGR bytes: red and blue
//     swap;
//   - BLP1, compression 1, encoding 4 or 5, and BLP2, compression 1,
//     encoding 1: the 256-entry BGRA palette after the table, then
//     mipmap 0's bytes (BLP1: straight after the palette; BLP2: at its
//     offset), each an index, as RGB (or RGBA);
//   - BLP2, compression 1, encoding 2: DXT1 (alpha encoding 0), DXT3 (1) or
//     DXT5 (7) blocks at mipmap 0's offset through the plugin's Python
//     decode_dxt1/3/5, whose endpoints are not bit-replicated (x << 3,
//     x << 2) and whose DXT1 takes its alpha flag from the header: the
//     rows of blocks, (w + 3) / 4 · 4 pixels wide, 3 or 4 bytes a pixel,
//     then read by the raw decoder as rows of w pixels of the mode's
//     bytes (a width off a multiple of 4 shears the image, a 4-byte DXT3 or
//     DXT5 stream read as RGB shifts it, as PIL does).
// Any other compression, encoding or alpha encoding is a BLPFormatError (a
// NotImplementedError: refused, kBlpFormat); data cut short raises.
//
// FTEX: the header's size and one format (format_count not 1 fails its
// assert), mipmap 0 at the offset the header gives, `mipmap_size` bytes
// (-1 reads the rest of the file): format 0 as BC1 through Pillow's bcn
// decoder (native_bcn.h), 1 as raw RGB; any other is a ValueError that ends
// the open. The open closes the file, so even its "not identified" (a size
// not positive) ends in an error: the next plugin cannot seek.
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_pil.h and native_bcn.h.

// --------------------------------------------------------------- BLP
struct BlpInfo {
  bool blp2 = false, alpha = false;
  int64_t compression = 0, encoding = 0, alpha_encoding = 0;
  uint32_t w = 0, h = 0;
};

int blp_open(const uint8_t* d, size_t n, BlpInfo& b) {
  b.blp2 = d[3] == '2';
  if (n < (b.blp2 ? 20u : 24u)) return kPassOn;  // unpack of a short read: struct.error
  b.compression = (int32_t)le32(d + 4);
  if (b.blp2) {
    b.encoding = (int8_t)d[8];
    b.alpha = d[9] != 0;
    b.alpha_encoding = (int8_t)d[10];
    b.w = le32(d + 12);
    b.h = le32(d + 16);
  } else {
    b.alpha = le32(d + 8) != 0;
    b.w = le32(d + 12);
    b.h = le32(d + 16);
    b.encoding = (int32_t)le32(d + 20);
  }
  if (b.w == 0 || b.h == 0) return kPassOn;  // "not identified by this driver"
  if ((uint64_t)b.w * b.h > kMaxPixels) return kCorrupt;  // DecompressionBombError
  return kOk;
}

int probe_blp(const uint8_t* d, size_t n, int& w, int& h) {
  BlpInfo b;
  const int rc = blp_open(d, n, b);
  w = (int)b.w;
  h = (int)b.h;
  return rc;
}

inline void blp_565(uint16_t c, int& r, int& g, int& b) {  // unpack_565
  r = ((c >> 11) & 0x1F) << 3;
  g = ((c >> 5) & 0x3F) << 2;
  b = (c & 0x1F) << 3;
}

// decode_dxt1/3/5 of one block into its 4 × 4 (r, g, b, a), row by row
void blp_dxt_block(const uint8_t* s, int kind, uint8_t px[16][4]) {
  const uint8_t* c = kind == 1 ? s : s + 8;
  const uint16_t c0 = (uint16_t)(c[0] | c[1] << 8), c1 = (uint16_t)(c[2] | c[3] << 8);
  const uint32_t code = le32(c + 4);
  int r0, g0, b0, r1, g1, b1;
  blp_565(c0, r0, g0, b0);
  blp_565(c1, r1, g1, b1);
  uint64_t a2 = 0, a1 = 0;
  if (kind == 5) {
    a2 = s[2] | s[3] << 8;
    a1 = (uint64_t)s[4] | (uint64_t)s[5] << 8 | (uint64_t)s[6] << 16 | (uint64_t)s[7] << 24;
  }
  for (int i = 0; i < 16; ++i) {
    const int cc = (code >> (2 * i)) & 3;
    int r, g, b, a = 255;
    if (cc == 0) {
      r = r0, g = g0, b = b0;
    } else if (cc == 1) {
      r = r1, g = g1, b = b1;
    } else if (kind != 1 || c0 > c1) {
      const bool two = cc == 2;
      r = two ? (2 * r0 + r1) / 3 : (2 * r1 + r0) / 3;
      g = two ? (2 * g0 + g1) / 3 : (2 * g1 + g0) / 3;
      b = two ? (2 * b0 + b1) / 3 : (2 * b1 + b0) / 3;
    } else if (cc == 2) {
      r = (r0 + r1) / 2, g = (g0 + g1) / 2, b = (b0 + b1) / 2;
    } else {
      r = g = b = a = 0;
    }
    if (kind == 3) {
      const int v = s[i / 2];
      a = (i % 2 ? v >> 4 : v & 0xF) * 17;
    } else if (kind == 5) {
      const int at = 3 * i;
      int ac;
      if (at <= 12) ac = (int)((a2 >> at) & 7);
      else if (at == 15) ac = (int)((a2 >> 15) | ((a1 << 1) & 6));
      else ac = (int)((a1 >> (at - 16)) & 7);
      const int x0 = s[0], x1 = s[1];
      if (ac == 0) a = x0;
      else if (ac == 1) a = x1;
      else if (x0 > x1) a = ((8 - ac) * x0 + (ac - 1) * x1) / 7;
      else if (ac == 6) a = 0;
      else if (ac == 7) a = 255;
      else a = ((6 - ac) * x0 + (ac - 1) * x1) / 5;
    }
    px[i][0] = (uint8_t)r;
    px[i][1] = (uint8_t)g;
    px[i][2] = (uint8_t)b;
    px[i][3] = (uint8_t)a;
  }
}

int decode_blp(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  BlpInfo b;
  int rc = blp_open(d, n, b);
  if (rc) return rc;
  w = (int)b.w;
  h = (int)b.h;
  const size_t npx = (size_t)w * h, bpp = b.alpha ? 4 : 3;
  // _read_header: 16 offsets and 16 lengths at the tile's offset
  const size_t table = b.blp2 ? 20 : 28;
  if (n < table + 128) return kCorrupt;  // "Truncated File Read"
  const uint32_t offset0 = le32(d + table), length0 = le32(d + table + 64);
  size_t pos = table + 128;
  std::vector<uint8_t> data;  // set_as_raw's bytes, in the mode's layout
  auto safe_read = [&](size_t k, size_t& at) {  // ImageFile._safe_read
    if (pos > n || n - pos < k) return false;
    at = pos;
    pos += k;
    return true;
  };
  // _read_bgra: each index of mipmap 0 through the palette at `pal` as
  // (r, g, b[, a])
  auto bgra = [&](size_t pal) -> int {
    size_t at;
    if (!safe_read(length0, at)) return kCorrupt;
    data.reserve((size_t)length0 * bpp);
    for (size_t i = 0; i < length0; ++i) {
      const uint8_t* e = d + pal + 4 * d[at + i];
      data.push_back(e[2]);
      data.push_back(e[1]);
      data.push_back(e[0]);
      if (b.alpha) data.push_back(e[3]);
    }
    return kOk;
  };
  if (!b.blp2) {
    if (b.compression == 0) {
      size_t at;
      if (!safe_read(4, at)) return kCorrupt;
      const uint32_t header = le32(d + at);
      size_t hdr;
      if (!safe_read(header, hdr)) return kCorrupt;
      if (offset0 > pos) {  // self._safe_read(offsets[0] - fd.tell())
        size_t skip;
        if (!safe_read(offset0 - pos, skip)) return kCorrupt;
      }
      size_t body;
      if (!safe_read(length0, body)) return kCorrupt;
      std::vector<uint8_t> jpeg(d + hdr, d + hdr + header);
      jpeg.insert(jpeg.end(), d + body, d + body + length0);
      if (jpeg_open(jpeg.data(), jpeg.size())) return kCorrupt;  // JpegImageFile's open, at load
      JpegDecoder j(jpeg.data(), jpeg.size());
      rc = j.parse();
      if (rc) return rc;
      if ((uint64_t)j.W * j.H > kMaxPixels) return kCorrupt;  // DecompressionBombError
      std::vector<uint8_t> rgb;
      rc = j.to_rgb(rgb, false);  // the JPEG mode "CMYK": no YCCK
      if (rc) return rc;
      if (rgb.size() < npx * 3) return kCorrupt;  // "not enough image data"
      gray.resize(npx);
      for (size_t i = 0; i < npx; ++i)  // BGR
        gray[i] = pil_luma(rgb[3 * i + 2], rgb[3 * i + 1], rgb[3 * i]);
      return kOk;
    }
    if (b.compression != 1 || (b.encoding != 4 && b.encoding != 5)) return kBlpFormat;
    size_t pal;
    if (!safe_read(1024, pal)) return kCorrupt;  // _read_palette
    rc = bgra(pal);
    if (rc) return rc;
  } else {
    size_t pal;
    if (!safe_read(1024, pal)) return kCorrupt;  // _read_palette
    pos = offset0;
    if (b.compression != 1) return kBlpFormat;
    if (b.encoding == 1) {
      rc = bgra(pal);
      if (rc) return rc;
    } else if (b.encoding == 2) {
      const int kind = b.alpha_encoding == 0 ? 1 : b.alpha_encoding == 1 ? 3 :
                       b.alpha_encoding == 7 ? 5 : 0;
      if (!kind) return kBlpFormat;
      const size_t bw = ((size_t)w + 3) / 4, bh = ((size_t)h + 3) / 4;
      const size_t block = kind == 1 ? 8 : 16, out_bpp = kind == 1 && !b.alpha ? 3 : 4;
      data.resize(bh * 4 * bw * 4 * out_bpp);
      uint8_t px[16][4];
      for (size_t by = 0; by < bh; ++by) {
        size_t at;
        if (!safe_read(bw * block, at)) return kCorrupt;
        for (size_t bx = 0; bx < bw; ++bx) {
          blp_dxt_block(d + at + bx * block, kind, px);
          for (int i = 0; i < 16; ++i) {
            uint8_t* o = data.data() + (((by * 4 + i / 4) * bw + bx) * 4 + i % 4) * out_bpp;
            std::memcpy(o, px[i], out_bpp);
          }
        }
      }
    } else {
      return kBlpFormat;  // "Unknown BLP encoding"
    }
  }
  if (data.size() < npx * bpp) return kCorrupt;  // "not enough image data"
  gray.resize(npx);
  for (size_t i = 0; i < npx; ++i)
    gray[i] = pil_luma(data[bpp * i], data[bpp * i + 1], data[bpp * i + 2]);
  return kOk;
}

// -------------------------------------------------------------- FTEX
struct FtexInfo {
  int32_t w = 0, h = 0, format = 0;
  size_t data = 0, len = 0;
};

int ftex_open(const uint8_t* d, size_t n, FtexInfo& f) {
  if (n < 24) return kPassOn;  // struct.unpack of a short read
  f.w = (int32_t)le32(d + 8);
  f.h = (int32_t)le32(d + 12);
  if ((int32_t)le32(d + 20) != 1) return kCorrupt;  // assert format_count == 1
  if (n < 32) return kPassOn;
  f.format = (int32_t)le32(d + 24);
  const int32_t where = (int32_t)le32(d + 28);
  if (where < 0) return kCorrupt;  // seek to a negative position
  if ((size_t)where > n || n - where < 4) return kPassOn;  // unpack of a short read
  const int32_t size = (int32_t)le32(d + where);
  if (size < -1) return kCorrupt;  // read(size): "read length must be non-negative or -1"
  f.data = (size_t)where + 4;
  f.len = size < 0 ? n - f.data : std::min<size_t>((size_t)size, n - f.data);
  if (f.format != 0 && f.format != 1) return kCorrupt;  // "Invalid texture compression format"
  // "not identified by this driver" passes a file on whose fp the open has
  // closed: the next plugin's seek raises ("seek of closed file")
  if (f.w <= 0 || f.h <= 0) return kCorrupt;
  if ((uint64_t)f.w * f.h > kMaxPixels) return kCorrupt;  // DecompressionBombError
  return kOk;
}

int probe_ftex(const uint8_t* d, size_t n, int& w, int& h) {
  FtexInfo f;
  const int rc = ftex_open(d, n, f);
  w = f.w;
  h = f.h;
  return rc;
}

int decode_ftex(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  FtexInfo f;
  const int rc = ftex_open(d, n, f);
  if (rc) return rc;
  w = f.w;
  h = f.h;
  const uint8_t* s = d + f.data;
  const size_t npx = (size_t)w * h;
  gray.resize(npx);
  if (f.format == 1) {  // raw RGB
    if (f.len / 3 < npx) return kCorrupt;  // "image file is truncated"
    for (size_t i = 0; i < npx; ++i) gray[i] = pil_luma(s[3 * i], s[3 * i + 1], s[3 * i + 2]);
    return kOk;
  }
  const size_t bw = ((size_t)w + 3) / 4, bh = ((size_t)h + 3) / 4;
  if (f.len / 8 < bw * bh) return kCorrupt;  // "image file is truncated"
  Rgba px[16];
  for (size_t by = 0; by < bh; ++by)
    for (size_t bx = 0; bx < bw; ++bx) {
      decode_bc1_color(px, s + (by * bw + bx) * 8, false);
      for (int i = 0; i < 16; ++i) {
        const size_t x = bx * 4 + i % 4, y = by * 4 + i / 4;
        if (x < (size_t)w && y < (size_t)h) gray[y * w + x] = pil_luma(px[i].r, px[i].g, px[i].b);
      }
    }
  return kOk;
}
