// Compressed YCbCr TIFF (photometric 6 under LZW, Deflate, PackBits, new-
// style JPEG on separate planes, and old-style JPEG) as Pillow reads it:
// TiffDecode.c's _decodeAsRGBA, i.e. libtiff 4.7's TIFFRGBAImage asked for
// ORIENTATION_TOPLEFT, one block of RowsPerStrip rows (or one row of tiles)
// per TIFFRGBAImageGet, then rawmode "RGBX" and ImageOps.exif_transpose.
//   - The stored data are YCbCrSubsampling (530) blocks: h × v luma samples,
//     then Cb and Cr, ceil(width / h) blocks a block row, each strip or tile
//     starting a block row; tif_getimage.c's putcontig8bitYCbCr{44,42,41,22,
//     21,12,11}tile give pixel (x, y) of a segment the luma sample (y % v) ·
//     h + x % h of block (x / h, y / v) and that block's chroma, clipped at
//     the right and bottom edges (in a tile cut by the image's right edge,
//     4 × 4 steps over the blocks past it at 10 bytes a block, libtiff's
//     slip); other subsamplings are "Can not handle format". Separate planes read through putseparate8bitYCbCr11tile, so
//     only at 1 × 1. YCbCrPositioning (531) is not read.
//   - TIFFYCbCrToRGBInit's tables from YCbCrCoefficients (529, default
//     0.299, 0.587, 0.114) and ReferenceBlackWhite (532, default 0 255 128
//     255 128 255), in libtiff's float arithmetic, and TIFFYCbCrtoRGB.
//   - The orientation: TIFFRGBAImage returns the image as stored (probed:
//     Pillow's image is the stored one flipped or rotated by PIL's
//     exif_transpose alone, at every orientation 1-8).
//   - Old-style JPEG (6): tif_ojpeg.c rebuilds one JPEG stream for the whole
//     image, from the JPEGInterchangeFormat stream (513/514) up to its SOS,
//     or from JPEGQTables, JPEGDCTables and JPEGACTables (519-521) with a
//     baseline frame of the subsampling tag's factors (whatever JPEGProc,
//     512, says), JPEGRestartInterval
//     (515) as its DRI; its entropy data are the interchange stream's bytes
//     after the SOS, then each strip's, an RSTn marker between strips.
//     libjpeg's raw (unconverted, not upsampled) component samples are
//     packed into the blocks above, at the stream's own subsampling.
//
// Included by native_tiff.h after decode_tiff_codec.

// libtiff's reading of a float tag (TIFFReadDirEntryFloatArray): RATIONAL
// as (float)num / (float)den, 0 for a zero denominator
inline bool tiff_floats(const uint8_t* d, const TiffIfd& f, int tag, int count, float* out) {
  auto it = f.entries.find(tag);
  if (it == f.entries.end() || (int)it->second.count < count) return false;
  const TiffEntry& e = it->second;
  const uint8_t* p = d + e.off;
  for (int i = 0; i < count; ++i) {
    float v;
    switch (e.type) {
      case 5: case 10: {
        const uint64_t a = tiff_uint(p + 8 * i, 4, f.le), b = tiff_uint(p + 8 * i + 4, 4, f.le);
        if (e.type == 5) v = b == 0 ? 0.0f : (float)(uint32_t)a / (float)(uint32_t)b;
        else v = b == 0 ? 0.0f : (float)(int32_t)a / (float)(int32_t)b;
        break;
      }
      case 11: {
        const uint32_t u = (uint32_t)tiff_uint(p + 4 * i, 4, f.le);
        std::memcpy(&v, &u, 4);
        break;
      }
      case 12: {
        const uint64_t u = tiff_uint(p + 8 * i, 8, f.le);
        double x;
        std::memcpy(&x, &u, 8);
        v = (float)x;
        break;
      }
      case 1: v = (float)p[i]; break;
      case 3: v = (float)tiff_uint(p + 2 * i, 2, f.le); break;
      case 4: v = (float)tiff_uint(p + 4 * i, 4, f.le); break;
      default: return false;
    }
    out[i] = v;
  }
  return true;
}

// TIFFYCbCrToRGBInit and TIFFYCbCrtoRGB (tif_color.c)
struct TiffYcc {
  int32_t y_tab[256], cr_r[256], cb_b[256], cr_g[256], cb_g[256];

  static int32_t fix(float x) { return (int32_t)((double)(x * 65536.0f) + 0.5); }
  static float clampf(float f, float lo, float hi) { return f < lo ? lo : f > hi ? hi : f; }
  static float code2v(int c, float rb, float rw, float cr) {
    const float den = (rw - rb != 0) ? (rw - rb) : 1.0f;
    return ((float)(c - (int32_t)rb) * cr) / den;
  }
  void init(const float* luma, const float* rbw) {
    const float f1 = 2 - 2 * luma[0];
    const int32_t D1 = fix(clampf(f1, 0.0f, 2.0f));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t D2 = -fix(clampf(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * luma[2];
    const int32_t D3 = fix(clampf(f3, 0.0f, 2.0f));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t D4 = -fix(clampf(f4, 0.0f, 2.0f));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t Cr = (int32_t)clampf(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127),
                                         -128.0f * 32, 128.0f * 32);
      const int32_t Cb = (int32_t)clampf(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127),
                                         -128.0f * 32, 128.0f * 32);
      cr_r[i] = (int32_t)(((int64_t)D1 * Cr + 32768) >> 16);
      cb_b[i] = (int32_t)(((int64_t)D3 * Cb + 32768) >> 16);
      cr_g[i] = D2 * Cr;
      cb_g[i] = D4 * Cb + 32768;
      y_tab[i] = (int32_t)clampf(code2v(x + 128, rbw[0], rbw[1], 255), -128.0f * 32,
                                 128.0f * 32);
    }
  }
  static int clamp8(int32_t v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  void rgb(int Y, int Cb, int Cr, uint8_t* o) const {
    o[0] = (uint8_t)clamp8(y_tab[Y] + cr_r[Cr]);
    o[1] = (uint8_t)clamp8(y_tab[Y] + (int32_t)(((int64_t)cb_g[Cb] + cr_g[Cr]) >> 16));
    o[2] = (uint8_t)clamp8(y_tab[Y] + cb_b[Cb]);
  }
};

// initYCbCrConversion: the tables, or false where libtiff refuses the tags
inline bool tiff_ycc_init(const uint8_t* d, const TiffIfd& f, TiffYcc& ycc) {
  float luma[3] = {0.299f, 0.587f, 0.114f};
  float rbw[6] = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};
  tiff_floats(d, f, kTagYccCoefficients, 3, luma);
  tiff_floats(d, f, kTagRefBlackWhite, 6, rbw);
  if (std::isnan(luma[0]) || std::isnan(luma[1]) || luma[1] == 0.0f || std::isnan(luma[2]))
    return false;  // "Invalid values for YCbCrCoefficients tag"
  for (float v : rbw)
    if (!(v > (float)(-0x7FFFFFFF + 128) && v < (float)0x7FFFFFFF))
      return false;  // "Invalid values for ReferenceBlackWhite tag"
  ycc.init(luma, rbw);
  return true;
}

// ------------------------------------------------------ old-style JPEG
// the stream tif_ojpeg.c hands libjpeg, decoded: the raw component planes
struct OjpegImage {
  int hs = 2, vs = 2;
  std::vector<std::vector<uint8_t>> planes;
  std::vector<int> strides;
};

inline void ojpeg_segment(std::vector<uint8_t>& s, int marker, const uint8_t* body, size_t len) {
  s.push_back(0xFF);
  s.push_back((uint8_t)marker);
  s.push_back((uint8_t)((len + 2) >> 8));
  s.push_back((uint8_t)((len + 2) & 255));
  s.insert(s.end(), body, body + len);
}

int ojpeg_decode(const uint8_t* d, size_t n, const TiffInfo& t, OjpegImage& img) {
  const TiffIfd& f = t.ifd;
  const uint64_t rps_tag = f.get(kTagRowsPerStrip, 0xFFFFFFFFu);
  const int64_t rps = (int64_t)std::min<uint64_t>(rps_tag, (uint64_t)t.ysize);
  const int64_t length_total = (t.ysize + rps - 1) / rps * rps;
  std::vector<uint64_t> offs = f.tuple(kTagStripOffsets, {});
  std::vector<uint64_t> counts = f.tuple(kTagStripBytes, {});
  std::vector<uint8_t> s = {0xFF, 0xD8};
  size_t entropy_from = 0, entropy_to = 0;  // the interchange stream's data after its SOS
  const uint64_t jif = f.get(kTagJif, 0);
  bool have_frame = false;
  int restart = (int)f.get(kTagJpegRestart, 0);
  if (jif != 0 && jif < n) {
    uint64_t len = f.get(kTagJifLength, 0);
    if (len == 0 || jif + len > n) len = n - jif;
    const uint8_t* j = d + jif;
    size_t p = 0;
    const size_t jn = (size_t)len;
    bool sos = false;
    while (!sos) {
      if (p >= jn || j[p] != 0xFF) break;  // not a marker: the header ends
      while (p < jn && j[p] == 0xFF) ++p;
      if (p >= jn) return kCorrupt;
      const int m = j[p++];
      if (m == 0xD8) continue;
      if (p + 2 > jn) return kCorrupt;
      const size_t seg = ((size_t)j[p] << 8) | j[p + 1];
      if (seg < 2 || p + seg > jn) return kCorrupt;
      const uint8_t* body = j + p + 2;
      switch (m) {
        case 0xDB: case 0xC4: ojpeg_segment(s, m, body, seg - 2); break;
        case 0xDD:
          if (seg < 4) return kCorrupt;
          restart = (body[0] << 8) | body[1];
          break;
        case 0xC0: case 0xC1: {
          if (seg < 8) return kCorrupt;
          const int64_t sy = (body[1] << 8) | body[2], sx = (body[3] << 8) | body[4];
          if (sy < t.ysize && sy < length_total) return kCorrupt;  // "unexpected height"
          if (sx < t.xsize) return kCorrupt;                        // "unexpected width"
          if (sx > t.xsize) return kCorrupt;  // "image width exceeds expected image width"
          ojpeg_segment(s, m, body, seg - 2);
          have_frame = true;
          break;
        }
        case 0xDA:
          if (!have_frame) return kCorrupt;
          if (restart) {
            const uint8_t dri[2] = {(uint8_t)(restart >> 8), (uint8_t)(restart & 255)};
            ojpeg_segment(s, 0xDD, dri, 2);
          }
          ojpeg_segment(s, m, body, seg - 2);
          sos = true;
          break;
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) break;  // APPn, COM
          return kTiffOjpeg;  // a frame libtiff's OJPEG does not take
      }
      p += seg;
    }
    if (sos) {
      entropy_from = (size_t)jif + p;
      entropy_to = (size_t)(jif + len);
    } else if (have_frame) {
      return kCorrupt;
    }
  }
  if (!have_frame) {  // JPEGQTables, JPEGDCTables, JPEGACTables and the tags' frame
    tiff_ycc_subsampling(f, img.hs, img.vs);
    const std::vector<uint64_t> q = f.tuple(kTagJpegQTables, {});
    const std::vector<uint64_t> dc = f.tuple(kTagJpegDcTables, {});
    const std::vector<uint64_t> ac = f.tuple(kTagJpegAcTables, {});
    const int nc = t.spp;
    if ((int)q.size() < nc || (int)dc.size() < nc || (int)ac.size() < nc || q[0] == 0)
      return kCorrupt;  // "Missing JPEG tables"
    int tq[4] = {0}, td[4] = {0}, ta[4] = {0};
    for (int m = 0; m < nc; ++m) {
      if (q[m] != 0 && (m == 0 || q[m] != q[m - 1])) {
        if (q[m] > n || n - q[m] < 64) return kCorrupt;
        std::vector<uint8_t> body = {(uint8_t)m};
        body.insert(body.end(), d + q[m], d + q[m] + 64);
        ojpeg_segment(s, 0xDB, body.data(), body.size());
        tq[m] = m;
      } else {
        tq[m] = tq[m - 1];
      }
      for (int cls = 0; cls < 2; ++cls) {
        const std::vector<uint64_t>& o = cls ? ac : dc;
        int* sel = cls ? ta : td;
        if (o[m] != 0 && (m == 0 || o[m] != o[m - 1])) {
          if (o[m] > n || n - o[m] < 16) return kCorrupt;
          size_t nv = 0;
          for (int k = 0; k < 16; ++k) nv += d[o[m] + k];
          if (n - o[m] - 16 < nv) return kCorrupt;
          std::vector<uint8_t> body = {(uint8_t)((cls << 4) | m)};
          body.insert(body.end(), d + o[m], d + o[m] + 16 + nv);
          ojpeg_segment(s, 0xC4, body.data(), body.size());
          sel[m] = m;
        } else {
          sel[m] = sel[m - 1];
        }
      }
    }
    if (restart) {
      const uint8_t dri[2] = {(uint8_t)(restart >> 8), (uint8_t)(restart & 255)};
      ojpeg_segment(s, 0xDD, dri, 2);
    }
    std::vector<uint8_t> sof = {8, (uint8_t)(length_total >> 8), (uint8_t)(length_total & 255),
                                (uint8_t)(t.xsize >> 8), (uint8_t)(t.xsize & 255), (uint8_t)nc};
    std::vector<uint8_t> sos = {(uint8_t)nc};
    for (int m = 0; m < nc; ++m) {
      sof.push_back((uint8_t)m);
      sof.push_back(m == 0 ? (uint8_t)((img.hs << 4) | img.vs) : 0x11);
      sof.push_back((uint8_t)tq[m]);
      sos.push_back((uint8_t)m);
      sos.push_back((uint8_t)((td[m] << 4) | ta[m]));
    }
    sos.insert(sos.end(), {0, 63, 0});
    ojpeg_segment(s, 0xC0, sof.data(), sof.size());
    ojpeg_segment(s, 0xDA, sos.data(), sos.size());
  }
  s.insert(s.end(), d + entropy_from, d + entropy_to);
  int rst = 0;
  for (size_t k = 0; k < offs.size(); ++k) {
    uint64_t off = offs[k], cnt = k < counts.size() ? counts[k] : 0;
    if (off == 0 || off >= n) continue;
    if (cnt == 0 || off + cnt > n) cnt = n - off;
    s.insert(s.end(), d + off, d + off + cnt);
    if (k + 1 < offs.size()) {
      s.push_back(0xFF);
      s.push_back((uint8_t)(0xD0 + rst));
      rst = (rst + 1) & 7;
    }
  }
  s.push_back(0xFF);
  s.push_back(0xD9);
  JpegDecoder dec(s.data(), s.size());
  dec.tiff = true;
  dec.one_scan = true;
  if (dec.parse() || dec.comps.size() != 3 || dec.lossless) return kCorrupt;
  // OJPEGSubsamplingCorrect: the stream's factors, where TIFF can say them
  const int h = dec.comps[0].h, v = dec.comps[0].v;
  if ((h != 1 && h != 2 && h != 4) || (v != 1 && v != 2 && v != 4) || dec.comps[1].h != 1 ||
      dec.comps[1].v != 1 || dec.comps[2].h != 1 || dec.comps[2].v != 1)
    return kTiffOjpeg;  // libtiff then upsamples inside libjpeg
  img.hs = h;
  img.vs = v;
  if (dec.H < length_total && dec.H < t.ysize) return kCorrupt;
  if (offs.size() > 1) {
    // "Incompatible vertical subsampling and image strip/tile length"
    if (rps % (8 * v)) return kCorrupt;
    // libtiff puts an RSTn marker between strips: a file whose restart
    // interval is not one strip's MCUs reads through libjpeg's resync
    const int64_t mcus = (t.xsize + 8 * h - 1) / (8 * h) * (rps / (8 * v));
    if (restart != mcus) return kTiffOjpeg;
  }
  dec.component_planes(img.planes, img.strides);
  return kOk;
}

// one strip of OJPEGDecodeRaw's packed blocks: rows [y0, y0 + rows)
void ojpeg_pack(const OjpegImage& img, int width, int y0, size_t rows, std::vector<uint8_t>& out) {
  const int hs = img.hs, vs = img.vs;
  const size_t across = ((size_t)width + hs - 1) / hs, down = (rows + vs - 1) / vs;
  const size_t unit = (size_t)hs * vs + 2;
  out.assign(across * down * unit, 0);
  const size_t yrows = img.planes[0].size() / img.strides[0];
  const size_t crows = img.planes[1].size() / img.strides[1];
  uint8_t* o = out.data();
  for (size_t br = 0; br < down; ++br) {
    const size_t cy = (size_t)y0 / vs + br;
    for (size_t q = 0; q < across; ++q) {
      for (int sy = 0; sy < vs; ++sy) {
        const size_t y = (size_t)y0 + br * vs + sy;
        for (int sx = 0; sx < hs; ++sx)
          *o++ = y < yrows ? img.planes[0][y * img.strides[0] + q * hs + sx] : 0;
      }
      *o++ = cy < crows ? img.planes[1][cy * img.strides[1] + q] : 0;
      *o++ = cy < crows ? img.planes[2][cy * img.strides[2] + q] : 0;
    }
  }
}

// ------------------------------------------------------- TIFFRGBAImage
int decode_tiff_rgba(const uint8_t* d, size_t n, const TiffInfo& t, PilImage& im) {
  const TiffIfd& f = t.ifd;
  if (t.spp != 3 || t.bps.size() != 3 || t.bps[0] != 8) return kCorrupt;
  const bool separate = t.planar == 2;
  const bool tiled = tiff_libtiff_tiled(f);
  OjpegImage oj;
  int hs, vs;
  if (t.compression == 6) {
    // libtiff's OJPEG reads the strips of a big-endian file out of order
    // (strip k from the data of strip 2k, probed)
    if (separate || tiled || (!f.le && f.tuple(kTagStripOffsets, {}).size() > 1))
      return kTiffOjpeg;
    const int rc = ojpeg_decode(d, n, t, oj);
    if (rc) return rc;
    hs = oj.hs;
    vs = oj.vs;
  } else {
    tiff_ycc_subsampling(f, hs, vs);
  }
  const int sub = (hs << 4) | vs;
  if (separate ? sub != 0x11
               : (sub != 0x44 && sub != 0x42 && sub != 0x41 && sub != 0x22 && sub != 0x21 &&
                  sub != 0x12 && sub != 0x11))
    return kCorrupt;  // "Can not handle format"
  TiffYcc ycc;
  if (!tiff_ycc_init(d, f, ycc)) return kCorrupt;
  std::vector<uint64_t> offs, counts;
  int64_t sw, sh;
  const int nplanes = separate ? 3 : 1;
  if (!tiff_libtiff_layout(d, n, f, t.xsize, t.ysize, sw, sh, offs, counts, nplanes) &&
      t.compression != 6)
    return kCorrupt;
  if (sw <= 0 || sh <= 0 || sw > (1 << 24)) return kCorrupt;
  const int64_t across = (t.xsize + sw - 1) / sw, down = (t.ysize + sh - 1) / sh;
  const int64_t per_plane = across * down;
  const size_t blocks_across = ((size_t)sw + hs - 1) / hs, unit = (size_t)hs * vs + 2;
  std::vector<std::vector<uint8_t>> seg(nplanes);
  // Pillow asks TIFFRGBAImageGet for a strip, or a row of tiles, at a time;
  // the read that first fills its buffer may not fail to find its data
  // (TIFFFillStrip: a byte count of 0, data past the file), later ones keep
  // the buffer as it was
  auto filled = [&](uint64_t off, uint64_t count) { return count && off <= n && n - off >= count; };
  for (int64_t s = 0; s < per_plane; ++s) {
    const int x0 = (int)((s % across) * sw), y0 = (int)((s / across) * sh);
    const size_t rows = tiled ? (size_t)sh : (size_t)std::min<int64_t>(sh, t.ysize - y0);
    TiffSeg sg;
    sg.w = (int)sw;
    sg.h = (int)rows;
    sg.last = !tiled && y0 + (int64_t)rows >= t.ysize;
    sg.separate = separate;
    sg.tile = tiled;
    sg.tolerant = t.compression != 7 && !is_ccitt(t.compression);
    const bool call_start = !tiled || s % across == 0;
    if (t.compression == 6) {
      ojpeg_pack(oj, (int)sw, y0, rows, seg[0]);
    } else if (separate) {
      for (int p = 0; p < 3; ++p) {
        const uint64_t off = offs[p * per_plane + s], count = counts[p * per_plane + s];
        if (sg.tolerant && !filled(off, count)) {
          if (p == 0 && call_start) return kCorrupt;
          seg[p].resize((size_t)rows * sw, 0);
          continue;
        }
        const int rc = tiff_segment(d, n, t, off, count, rows, (size_t)sw, 1, 8, seg[p], sg);
        if (rc) return rc;
      }
    } else {
      // the predictor runs over rows of TIFFScanlineSize bytes of the packed
      // blocks (strips; TIFFTileRowSize, width × 3, in tiles), three bytes
      // apart; where the segment is no whole number of those rows, or a
      // row no multiple of 3 bytes ("occ0%rowsize != 0", "(cc%stride)!=0"),
      // libtiff undoes nothing and TIFFRGBAImage reads the differences
      // gtStripContig reads TIFFScanlineSize (a block row's bytes over vs,
      // rounded down) times the strip's rows rounded up to vs: short of the
      // strip where a block row's bytes do not divide by vs (the rest of its
      // buffer stays zero); gtTileContig reads the whole tile
      const size_t block_rows = (rows + vs - 1) / vs;
      const size_t bytes = block_rows * blocks_across * unit;
      const size_t prow = tiled ? (size_t)sw * 3 : blocks_across * unit / vs;
      const size_t read = tiled ? bytes : block_rows * vs * prow;
      sg.raw = prow == 0 || read % prow != 0 || prow % 3 != 0;
      const size_t rlen = sg.raw ? read : prow;
      if (sg.tolerant && !filled(offs[s], counts[s])) {
        if (call_start) return kCorrupt;
        seg[0].resize(bytes, 0);
      } else if (read == 0) {
        seg[0].assign(bytes, 0);
      } else {
        const int rc = tiff_segment(d, n, t, offs[s], counts[s], read / rlen, rlen, 3, 8, seg[0],
                                    sg);
        if (rc) return rc;
        seg[0].resize(bytes, 0);
      }
    }
    const int xs = (int)std::min<int64_t>(sw, t.xsize - x0);
    const int ys = (int)std::min<int64_t>((int64_t)rows, t.ysize - y0);
    // the bytes between block rows: past the blocks put, the put function
    // skips (tile width − width put) / h blocks, which 4 × 4 counts at 10
    // bytes, not 18 (putcontig8bitYCbCr44tile's "4 * 2 + 2")
    const size_t skip_unit = sub == 0x44 ? 10 : unit;
    const size_t row_step = ((size_t)xs + hs - 1) / hs * unit + (size_t)(sw - xs) / hs * skip_unit;
    for (int r = 0; r < ys; ++r) {
      const int y = y0 + r;
      for (int c = 0; c < xs; ++c) {
        const int x = x0 + c;
        int Y, Cb, Cr;
        if (separate) {
          const size_t i = (size_t)r * sw + c;
          Y = seg[0][i];
          Cb = seg[1][i];
          Cr = seg[2][i];
        } else {
          const uint8_t* b = seg[0].data() + (size_t)(r / vs) * row_step + (size_t)(c / hs) * unit;
          Y = b[(r % vs) * hs + c % hs];
          Cb = b[hs * vs];
          Cr = b[hs * vs + 1];
        }
        uint8_t* q = im.at(x, y);
        ycc.rgb(Y, Cb, Cr, q);
        q[3] = 255;
      }
    }
  }
  return kOk;
}
