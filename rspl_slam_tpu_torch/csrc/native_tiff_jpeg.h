// New-style JPEG in TIFF (compression 7) as libtiff 4.7's tif_jpeg.c hands
// one strip or tile to Pillow's TiffDecode.c: the JPEGTables stream (tag
// 347) read first for its DQT and DHT segments (jpeg_read_header(FALSE)),
// then the strip's own stream, whose segments replace them; its size,
// component count, precision and sampling checked as JPEGPreDecode checks
// them; then libjpeg-turbo's output: YCbCr (photometric 6, one plane)
// upsampled as jdsample.c does and converted to RGB (Pillow asks for
// JPEGCOLORMODE_RGB and reads rawmode "RGB"), every other photometric's
// components as stored (libtiff sets JCS_UNKNOWN: no conversion).
//
// Included by native_tiff.h before tiff_segment.

// the bytes of an entry's value (any type, as stored) or nullptr
inline const uint8_t* tiff_entry_bytes(const uint8_t* d, const TiffIfd& f, int tag, size_t& size) {
  auto it = f.entries.find(tag);
  if (it == f.entries.end()) return nullptr;
  size = (size_t)(it->second.count * tiff_type_size(it->second.type));
  return d + it->second.off;
}

// libtiff's YCbCrSubsampling (530) as its codecs and TIFFRGBAImage read it:
// (2, 2) where the tag is absent
inline void tiff_ycc_subsampling(const TiffIfd& f, int& hs, int& vs) {
  const std::vector<uint64_t> v = f.tuple(kTagYccSubsampling, {2, 2});
  hs = (int)v[0];
  vs = v.size() > 1 ? (int)v[1] : 2;
}

// JPEGFixupTagsSubsampling: where a YCbCr JPEG TIFF (one plane, 3 samples
// of 8 bits) has no YCbCrSubsampling tag, libtiff takes the first strip or
// tile's frame's sampling factors for it (when TIFF can state them)
inline void tiff_jpeg_subsampling(const uint8_t* d, size_t n, const TiffInfo& t, int& hs,
                                  int& vs) {
  tiff_ycc_subsampling(t.ifd, hs, vs);
  const TiffIfd& f = t.ifd;
  if (f.has(kTagYccSubsampling) || t.planar != 1 || t.spp != 3) return;
  const std::vector<uint64_t> offs =
      f.tuple(f.has(kTagStripOffsets) ? kTagStripOffsets : kTagTileOffsets, {});
  const std::vector<uint64_t> counts =
      f.tuple(f.has(kTagStripOffsets) ? kTagStripBytes : kTagTileBytes, {});
  if (offs.empty() || counts.empty() || offs[0] > n || n - offs[0] < counts[0]) return;
  const uint8_t* p = d + offs[0];
  const size_t m = (size_t)counts[0];
  if (m < 4 || p[0] != 0xFF || p[1] != 0xD8) return;
  for (size_t i = 2; i + 4 <= m;) {
    if (p[i] != 0xFF) return;
    const int mk = p[i + 1];
    const size_t len = ((size_t)p[i + 2] << 8) | p[i + 3];
    if (mk >= 0xC0 && mk <= 0xCF && mk != 0xC4 && mk != 0xC8 && mk != 0xCC) {
      if (i + 12 > m || p[i + 9] != 3) return;
      const int h = p[i + 11] >> 4, v = p[i + 11] & 15;
      if ((h == 1 || h == 2 || h == 4) && (v == 1 || v == 2 || v == 4)) {
        hs = h;
        vs = v;
      }
      return;
    }
    i += 2 + len;
  }
}

// one strip or tile: rows × row_bytes bytes (row_bytes = seg_w × samples);
// seg_w × seg_h is the segment JPEGPreDecode expects, last_strip a strip
// that ends the image (its stream may be taller), separate one plane of
// PlanarConfiguration 2
int tiff_jpeg_segment(const uint8_t* d, size_t n, const TiffInfo& t, const uint8_t* src, size_t count,
                      int seg_w, int seg_h, bool last_strip, bool separate, size_t rows,
                      size_t row_bytes, std::vector<uint8_t>& out) {
  JpegDecoder dec(src, count);
  dec.tiff = true;
  size_t tn = 0;
  const uint8_t* tables = tiff_entry_bytes(d, t.ifd, kTagJpegTables, tn);
  if (tables && dec.load_tables(tables, tn)) return kCorrupt;  // "Bogus JPEGTables field"
  if (dec.parse()) return kCorrupt;
  // a stream smaller than its segment leaves the rest of Pillow's strip
  // buffer as the previous strip left it (libtiff only warns)
  if (dec.W < seg_w || dec.H < seg_h) return kTiffJpeg;
  const bool taller_last = dec.W == seg_w && dec.H > seg_h && last_strip;
  if (!taller_last && (dec.W > seg_w || dec.H > seg_h))
    return kCorrupt;  // "JPEG strip/tile size exceeds expected dimensions"
  const int nc = (int)dec.comps.size();
  if (nc != (separate ? 1 : t.spp)) return kCorrupt;  // "Improper JPEG component count"
  int hs = 1, vs = 1;
  const bool ycc = t.photo == 6 && !separate;
  if (ycc) tiff_jpeg_subsampling(d, n, t, hs, vs);
  if (dec.comps[0].h != hs || dec.comps[0].v != vs) return kCorrupt;  // "Improper JPEG sampling"
  for (int c = 1; c < nc; ++c)
    if (dec.comps[c].h != 1 || dec.comps[c].v != 1) return kCorrupt;
  std::vector<std::vector<uint8_t>> full;
  dec.full_planes(full);
  out.assign(rows * row_bytes, 0);
  const YccTable& tab = ycc_table();
  for (size_t r = 0; r < rows; ++r) {
    uint8_t* o = out.data() + r * row_bytes;
    const size_t base = r * (size_t)dec.W;
    if (ycc) {
      for (int x = 0; x < seg_w; ++x) {
        int R, G, B;
        tab.rgb(full[0][base + x], full[1][base + x], full[2][base + x], R, G, B);
        o[3 * x] = (uint8_t)R;
        o[3 * x + 1] = (uint8_t)G;
        o[3 * x + 2] = (uint8_t)B;
      }
    } else {
      for (int x = 0; x < seg_w; ++x)
        for (int c = 0; c < nc; ++c) o[(size_t)x * nc + c] = full[c][base + x];
    }
  }
  return kOk;
}
