// ICO and CUR as PIL 12.1 reads them (IcoImagePlugin, CurImagePlugin), then
// convert("L").
//
// ICO: the directory's entries sorted as IcoFile sorts them (by colour depth,
// then, stably, by area, largest first); PIL's image is the first. An entry
// that starts with PNG's signature is a PNG read by the port's PNG reader
// (its gray is PIL's, whatever the PNG's mode); any other is a DIB whose
// header starts at the entry's offset (native_bmp.h's _bitmap), read at
// half its stored height (the XOR image). PIL then reads a mask and makes
// the image RGBA: the 32-bit entries' alpha bytes, or the AND mask at the
// end of the entry (offset + size − its bytes); a mask cut short raises.
// The mask does not change the gray. IcoImageFile's open loads the image,
// so an error of the entry that passes a file on passes the ICO file on
// too: a DIB's, or a PNG's (native_png.h: its open's, and its load's
// errors of the same kinds, kLoadPassOn); its other errors raise.
//
// CUR: BmpImageFile._bitmap at the largest entry's offset (the first, unless
// a later one is wider and taller), half the stored height, no mask; an
// offset of 22 reads 32-bit pixels as BGRA.
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_bmp.h and native_png.h.

// ------------------------------------------------------------------ CUR
int cur_open(const uint8_t* d, size_t n, BmpInfo& b) {
  if (n < 6) return kPassOn;  // i16(s, 4): struct.error
  const int count = d[4] | d[5] << 8;
  size_t pos = 6, m = 0, m_len = 0;
  for (int i = 0; i < count; ++i) {
    const size_t s = pos, s_len = std::min<size_t>(16, n - pos);
    pos += s_len;
    if (!m_len) {
      m = s;
      m_len = s_len;
    } else {
      if (s_len < 1) return kPassOn;  // s[0]: IndexError
      if (d[s] > d[m]) {
        if (s_len < 2 || m_len < 2) return kPassOn;
        if (d[s + 1] > d[m + 1]) {
          m = s;
          m_len = s_len;
        }
      }
    }
  }
  if (!m_len) return kPassOn;  // "No cursors were found" (TypeError)
  if (m_len < 16) return kPassOn;  // i32(m, 12): struct.error
  const uint32_t header = le32(d + m + 12);
  // _bitmap(header): seeks there unless it is 0, then reads on
  const int rc = bmp_bitmap(d, n, header ? header : pos, 0, b, header == 22);
  if (rc) return rc;
  b.h /= 2;
  if (b.h <= 0) return kPassOn;  // "not identified by this driver"
  return bmp_too_big(b.w, b.h) ? kCorrupt : kOk;
}

int probe_cur(const uint8_t* d, size_t n, int& w, int& h) {
  BmpInfo b;
  const int rc = cur_open(d, n, b);
  w = (int)b.w;
  h = (int)b.h;
  return rc;
}

int decode_cur(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  BmpInfo b;
  int rc = cur_open(d, n, b);
  if (rc) return rc;
  w = (int)b.w;
  h = (int)b.h;
  PilImage im;
  rc = bmp_pixels(d, n, b, b.w, b.h, im);
  if (rc) return rc;
  return pil_to_gray(im, gray);
}

// ------------------------------------------------------------------ ICO
struct IcoEntry {
  int width, height, bpp;
  uint32_t size, offset;
  int64_t color_depth;
};

int decode_ico(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  if (n < 6) return kPassOn;
  const int count = d[4] | d[5] << 8;
  std::vector<IcoEntry> entries;
  size_t pos = 6;
  for (int i = 0; i < count; ++i) {
    const size_t k = std::min<size_t>(16, n - pos);
    const uint8_t* s = d + pos;
    pos += k;
    if (k < 16) return kPassOn;  // s[0], i16 or i32 of a short read
    IcoEntry e;
    e.width = s[0] ? s[0] : 256;
    e.height = s[1] ? s[1] : 256;
    const int nb_color = s[2];
    e.bpp = s[6] | s[7] << 8;
    e.size = le32(s + 8);
    e.offset = le32(s + 12);
    // bpp or (nb_color != 0 and ceil(log(nb_color, 2))) or 256
    int64_t cd = e.bpp;
    if (!cd && nb_color) cd = (int64_t)std::ceil(std::log((double)nb_color) / std::log(2.0));
    e.color_depth = cd ? cd : 256;
    entries.push_back(e);
  }
  if (entries.empty()) return kPassOn;  // entry[0]: IndexError
  std::stable_sort(entries.begin(), entries.end(), [](const IcoEntry& a, const IcoEntry& b) {
    return a.color_depth < b.color_depth;
  });
  std::stable_sort(entries.begin(), entries.end(), [](const IcoEntry& a, const IcoEntry& b) {
    return a.width * a.height > b.width * b.height;
  });
  const IcoEntry& e = entries[0];
  const size_t off = e.offset;
  if (off < n && n - off >= 8 && !std::memcmp(d + off, kPngSig, 8)) {
    const int rc = png_read(d + off, n - off, gray, w, h);
    return rc == kLoadPassOn ? kPassOn : rc;
  }
  BmpInfo b;
  int rc = bmp_bitmap(d, n, off, 0, b);  // DibImageFile at the entry's offset
  if (rc) return rc;
  if (bmp_too_big(b.w, b.h)) return kCorrupt;
  const int64_t hw = b.w, hh = b.h / 2;
  // the mask PIL reads before it converts to RGBA: it must be all there
  if (e.bpp == 32) {
    if (b.data > n || (n - b.data) / 4 < (uint64_t)(hw * hh)) return kCorrupt;
  } else {
    const int64_t wm = (hw + 31) / 32 * 32, total = wm * hh / 8;
    const int64_t at = (int64_t)e.offset + e.size - total;
    if (at < 0) return kCorrupt;  // a seek before the start of the file
    // the raw decoder's need: every row but the last at the padded stride
    const int64_t need = hh > 0 ? (hh - 1) * (wm / 8) + (hw + 7) / 8 : 0;
    const int64_t got = (uint64_t)at > n ? 0 : std::min<int64_t>(total, (int64_t)(n - at));
    if (got < need) return kCorrupt;  // "not enough image data"
  }
  PilImage im;
  rc = bmp_pixels(d, n, b, hw, hh, im);
  if (rc) return rc;
  if (hh <= 0) return kPassOn;  // "not identified by this driver"
  w = (int)hw;
  h = (int)hh;
  return pil_to_gray(im, gray);
}

int probe_ico(const uint8_t* d, size_t n, int& w, int& h) {
  std::vector<uint8_t> gray;
  return decode_ico(d, n, gray, w, h);
}
