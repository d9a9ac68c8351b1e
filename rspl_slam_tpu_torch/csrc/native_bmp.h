// BMP as PIL 12's BmpImagePlugin reads it, then convert("L"): "BM" files,
// the headerless DIB (DibImageFile: the header at 0, the pixels after the
// header, masks and palette) and the entries of ICO and CUR files, all
// through one port of BmpImageFile._bitmap that starts at a given offset:
// header sizes 12 (OS/2 1.x, 16-bit sizes, 3-byte palette entries), 40, 52,
// 56, 64, 108 and 124; depths 1, 4, 8, 16, 24, 32 (PIL has no 2-bit mode);
// RAW, RLE8, RLE4 and BITFIELDS at the masks PIL maps; a height whose top
// byte is 0xFF runs top to bottom. A palette whose entries are a grey ramp
// (0 and 255 for two colours) reads as mode L or 1 with the raw bytes taken
// as grey levels, as PIL reads it; any other as P, then each entry's luma
// (indices past the palette: black). The quirks are PIL's too: the pixel
// offset moves past a palette when the header says it starts at the
// palette, and the RLE decoder reads a delta's two bytes and then two more.
// An RLE bitmap whose codes end before its last row raises, as in PIL
// ("not enough image data"); rows that an end-of-line or a delta cuts short
// are filled with index 0. The errors are PIL's, in its order: a header cut
// short raises ("Truncated File Read"), masks cut short or no pixels pass
// the file on to the next plugin (kPassOn).
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_pil.h.

inline uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 | (uint32_t)p[3] << 24;
}
inline uint32_t le16(const uint8_t* p) { return (uint32_t)p[0] | (uint32_t)p[1] << 8; }

struct BmpInfo {
  int64_t w = 0, h = 0;
  int bits = 0, compression = 0, direction = -1, padding = 4;
  int64_t colors = 0;
  size_t data = 0;  // where the pixels start
  uint32_t mask[4] = {0, 0, 0, 0};
  bool rle = false;
  PilMode mode = kModeNone;
  std::string raw;
  uint8_t pal[256 * 3] = {0};  // mode P: the palette as RGB
  int pal_n = 0;
};

// BmpImageFile._bitmap(header=start, offset): the header whose size field
// is at `start`, its BITFIELDS masks and palette; the pixels start at
// `offset`, or with 0 right after what was read. "BM" files call it at 14
// with the file header's offset, DIBs (DibImageFile) at 0 with 0, ICO and
// CUR entries at the entry's offset with 0. kPassOn where PIL raises one of
// the errors that pass the file on to the next plugin (a field cut short:
// struct.error; no pixels: "not identified by this driver"); a header cut
// short is PIL's "Truncated File Read" (kCorrupt). The checks run in PIL's
// order, so a file fails on the check PIL fails it on.
int bmp_bitmap(const uint8_t* d, size_t n, size_t start, size_t offset, BmpInfo& b,
               bool cur22 = false) {
  if (start > n || n - start < 4) return kPassOn;
  const uint32_t hs = le32(d + start);
  if (hs > 4 && n - start - 4 < hs - 4) return kCorrupt;
  const uint8_t* hd = d + start + 4;  // the header after its size field
  size_t pos = start + (hs > 4 ? hs : 4);
  if (hs == 12) {
    b.w = le16(hd);
    b.h = le16(hd + 2);
    b.bits = (int)le16(hd + 6);
    b.compression = 0;
    b.padding = 3;
  } else if (hs == 40 || hs == 52 || hs == 56 || hs == 64 || hs == 108 || hs == 124) {
    const bool y_flip = hd[7] == 0xFF;
    b.direction = y_flip ? 1 : -1;
    b.w = le32(hd);
    b.h = y_flip ? (int64_t)4294967296LL - le32(hd + 4) : (int64_t)le32(hd + 4);
    b.bits = (int)le16(hd + 10);
    b.compression = (int)le32(hd + 12);
    b.colors = le32(hd + 28);
    b.padding = 4;
    if (b.compression == 3) {
      if (hs - 4 >= 48) {
        for (int i = 0; i < (hs - 4 >= 52 ? 4 : 3); ++i) b.mask[i] = le32(hd + 36 + 4 * i);
      } else {
        for (int i = 0; i < 3; ++i, pos += 4) {
          if (n - std::min(pos, n) < 4) return kPassOn;  // i32(read(4)): struct.error
          b.mask[i] = le32(d + pos);
        }
      }
    }
  } else {
    return kBmpHeader;
  }
  if (b.colors == 0) b.colors = b.bits < 63 ? (int64_t)1 << b.bits : 0;
  if (offset == 14 + (size_t)hs && b.bits <= 8) offset += 4 * (size_t)b.colors;
  switch (b.bits) {
    case 1: b.mode = kModeP; b.raw = "P;1"; break;
    case 4: b.mode = kModeP; b.raw = "P;4"; break;
    case 8: b.mode = kModeP; b.raw = "P"; break;
    case 16: b.mode = kModeRGB; b.raw = "BGR;15"; break;
    case 24: b.mode = kModeRGB; b.raw = "BGR"; break;
    case 32: b.mode = kModeRGB; b.raw = "BGRX"; break;
    default: return kBmpDepth;
  }
  if (b.compression == 3) {
    const uint32_t* m = b.mask;
    auto is = [&](uint32_t r, uint32_t g, uint32_t bl, uint32_t a) {
      return m[0] == r && m[1] == g && m[2] == bl && m[3] == a;
    };
    if (b.bits == 32) {
      if (is(0xFF0000, 0xFF00, 0xFF, 0)) b.raw = "BGRX";
      else if (is(0xFF000000, 0xFF0000, 0xFF00, 0)) b.raw = "XBGR";
      else if (is(0xFF000000, 0xFF00, 0xFF, 0)) b.raw = "BGXR";
      else if (is(0xFF000000, 0xFF0000, 0xFF00, 0xFF)) b.raw = "ABGR";
      else if (is(0xFF, 0xFF00, 0xFF0000, 0xFF000000)) b.raw = "RGBA";
      else if (is(0xFF0000, 0xFF00, 0xFF, 0xFF000000)) b.raw = "BGRA";
      else if (is(0xFF000000, 0xFF00, 0xFF, 0xFF0000)) b.raw = "BGAR";
      else if (is(0, 0, 0, 0)) b.raw = "BGRA";
      else return kBmpBitfields;
      if (b.raw.find('A') != std::string::npos) b.mode = kModeRGBA;
    } else if (b.bits == 24 && m[0] == 0xFF0000 && m[1] == 0xFF00 && m[2] == 0xFF) {
      b.raw = "BGR";
    } else if (b.bits == 16 && m[0] == 0xF800 && m[1] == 0x7E0 && m[2] == 0x1F) {
      b.raw = "BGR;16";
    } else if (b.bits == 16 && m[0] == 0x7C00 && m[1] == 0x3E0 && m[2] == 0x1F) {
      b.raw = "BGR;15";
    } else {
      return kBmpBitfields;
    }
  } else if (b.compression == 0) {
    if (b.bits == 32 && cur22) {  // a CUR entry at 22, "32-bit .cur offset": BGRA
      b.raw = "BGRA";
      b.mode = kModeRGBA;
    }
  } else if (b.compression == 1 || b.compression == 2) {
    b.rle = true;
  } else {
    return kBmpCompression;
  }
  if (b.mode == kModeP) {
    if (!(b.colors > 0 && b.colors <= 65536)) return kBmpPalette;
    const size_t want = (size_t)b.padding * (size_t)b.colors;
    const size_t got = std::min(want, n - std::min(pos, n));
    const uint8_t* pal = d + pos;
    pos += got;
    bool grayscale = true;
    const int64_t count = b.colors == 2 ? 2 : b.colors;
    for (int64_t ind = 0; ind < count; ++ind) {
      const int val = b.colors == 2 ? (ind ? 255 : 0) : (int)(ind & 255);
      const size_t at = (size_t)ind * b.padding;
      if (at + 3 > got || pal[at] != val || pal[at + 1] != val || pal[at + 2] != val)
        grayscale = false;
    }
    if (grayscale) {
      b.mode = b.colors == 2 ? kMode1 : kModeL;
      b.raw = b.colors == 2 ? "1" : "L";
    } else {
      const size_t entries = got / b.padding;
      if (entries > 256) return kBmpPalette;  // "invalid palette size", at load
      for (size_t i = 0; i < entries; ++i) {  // BGR(X) → RGB
        b.pal[3 * i] = pal[i * b.padding + 2];
        b.pal[3 * i + 1] = pal[i * b.padding + 1];
        b.pal[3 * i + 2] = pal[i * b.padding];
      }
      b.pal_n = (int)entries;
    }
  }
  b.data = offset ? offset : pos;
  if (b.w <= 0 || b.h <= 0) return kPassOn;  // "not identified by this driver"
  return kOk;
}

// PIL's Image.open ends with DecompressionBombError past twice
// MAX_IMAGE_PIXELS; sizes past 2^24 fail here too
inline bool bmp_too_big(int64_t w, int64_t h) {
  return w > (1 << 24) || h > (1 << 24) || (uint64_t)(w * h) > kMaxPixels;
}

// BmpImageFile._open: the file header, then _bitmap at 14
int bmp_header(const uint8_t* d, size_t n, BmpInfo& b) {
  if (n < 14) return kPassOn;  // i32(head_data, 10): struct.error
  const int rc = bmp_bitmap(d, n, 14, le32(d + 10), b);
  if (rc) return rc;
  return bmp_too_big(b.w, b.h) ? kCorrupt : kOk;
}

// DibImageFile._open: _bitmap at 0, the pixels right after the header
int dib_header(const uint8_t* d, size_t n, BmpInfo& b) {
  const int rc = bmp_bitmap(d, n, 0, 0, b);
  if (rc) return rc;
  return bmp_too_big(b.w, b.h) ? kCorrupt : kOk;
}

// BmpRleDecoder.decode, step for step, from the pixel offset
void bmp_rle(const uint8_t* d, size_t n, size_t pos, bool rle4, int64_t xsize, int64_t ysize,
             std::vector<uint8_t>& data) {
  const size_t dest = (size_t)(xsize * ysize);
  int64_t x = 0;
  data.clear();
  auto read1 = [&](int& v) {
    if (pos >= n) return false;
    v = d[pos++];
    return true;
  };
  while (data.size() < dest) {
    int num, byte;
    if (!read1(num) || !read1(byte)) break;
    if (num) {  // encoded mode
      if (x + num > xsize) num = (int)std::max<int64_t>(0, xsize - x);
      for (int i = 0; i < num; ++i)
        data.push_back(rle4 ? (uint8_t)(i % 2 == 0 ? byte >> 4 : byte & 15) : (uint8_t)byte);
      x += num;
    } else if (byte == 0) {  // end of line
      while (data.size() % (size_t)xsize) data.push_back(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: PIL reads two bytes, then its offsets from the next two
      if (n - std::min(pos, n) < 2) break;
      pos += 2;
      if (n - std::min(pos, n) < 2) break;  // unpacking fewer than two bytes raises
      const int right = d[pos], up = d[pos + 1];
      pos += 2;
      data.insert(data.end(), (size_t)(right + (int64_t)up * xsize), 0);
      x = (int64_t)(data.size() % (size_t)xsize);
    } else {  // absolute mode
      const size_t want = rle4 ? (size_t)byte / 2 : (size_t)byte;
      const size_t got = std::min(want, n - std::min(pos, n));
      for (size_t k = 0; k < got; ++k) {
        const uint8_t v = d[pos + k];
        if (rle4) {
          data.push_back(v >> 4);
          data.push_back(v & 15);
        } else {
          data.push_back(v);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if (pos % 2) pos += 1;  // word alignment of the file position
    }
  }
}

// the pixels of a parsed bitmap at (w, h), which ICO and CUR cut to the
// top half of the stored height (the XOR image, without the AND mask)
int bmp_pixels(const uint8_t* d, size_t n, const BmpInfo& b, int64_t w64, int64_t h64,
               PilImage& im) {
  const int w = (int)w64, h = (int)h64;
  im.alloc(b.mode, w, h);
  if (b.mode == kModeP) {
    std::memcpy(im.pal, b.pal, sizeof(b.pal));
    im.pal_n = b.pal_n;
  }
  if (b.rle) {
    // set_as_raw with rawmode L for mode L, else P
    const UnpackerDef* u = find_unpacker(im.mode, im.mode == kModeL ? "L" : "P");
    if (!u) return kBmpRle;
    std::vector<uint8_t> data;
    bmp_rle(d, n, b.data, b.compression == 2, w64, h64, data);
    if (data.size() < (size_t)(w64 * h64)) return kCorrupt;  // "not enough image data"
    return raw_decode(data.data(), data.size(), 0, im, 0, 0, w, h, *u, 0, b.direction);
  }
  const UnpackerDef* u = find_unpacker(im.mode, b.raw);
  if (!u) return kCorrupt;
  const int64_t stride = ((w64 * b.bits + 31) >> 3) & ~3LL;
  return raw_decode(d, n, b.data, im, 0, 0, w, h, *u, stride, b.direction);
}

int decode_bmp_as(int (*header)(const uint8_t*, size_t, BmpInfo&), const uint8_t* d, size_t n,
                  std::vector<uint8_t>& gray, int& w, int& h) {
  BmpInfo b;
  int rc = header(d, n, b);
  if (rc) return rc;
  w = (int)b.w;
  h = (int)b.h;
  PilImage im;
  rc = bmp_pixels(d, n, b, b.w, b.h, im);
  if (rc) return rc;
  return pil_to_gray(im, gray);
}

int decode_bmp(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  return decode_bmp_as(bmp_header, d, n, gray, w, h);
}

int decode_dib(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  return decode_bmp_as(dib_header, d, n, gray, w, h);
}
