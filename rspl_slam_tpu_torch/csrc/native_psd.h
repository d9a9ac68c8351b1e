// PSD as PIL 12.1's PsdImagePlugin reads it, then convert("L"): the merged
// image of the image data section, never the layers.
//
// _open reads the 26-byte header (version 1; (mode, depth) one of MODES, or
// KeyError, which passes the file on; fewer channels than the mode needs is
// "not enough channels", an OSError), the colour mode data (a planar RGB
// palette when the mode is indexed and the section is 768 bytes long), the
// image resources (walked entry by entry while the file position is short
// of the section's end: a read cut short by the end of the file passes the
// file on), the layer and mask section (only its length and the layer
// info's length are read, then it is skipped: its contents are never
// parsed), then the compression of the image data: 0 raw, each channel a
// plane after the other; 1 PackBits, with a byte count per row and channel
// whose sum places each channel (a table cut short passes the file on);
// any other leaves no tile ("cannot load this image"). Each channel is a
// band of the image: R, G, B, A of RGB and RGBA (4 channels), inverted C,
// M, Y, K of CMYK. PIL opens a Lab image, whose convert("L") fails
// ("conversion from LAB to RGB not supported"): refused once opened.
//
// Pillow's PackBitsDecode.c decodes a channel from its offset on, row after
// row: a byte n < 128 is a literal of n + 1 bytes, 0x80 nothing, any other
// a run of 257 − n copies of the next byte; a literal or run that passes
// the end of a row is cut there (the rest dropped, not carried over), and
// the byte counts play no part in it. The file ending before the last row
// of a channel is "image file is truncated".
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_pil.h.

inline int psd_be16(const uint8_t* p) { return p[0] << 8 | p[1]; }

struct PsdInfo {
  int w = 0, h = 0, channels = 0;  // the bands the mode reads
  PilMode mode = kModeNone;
  bool lab = false, has_pal = false;
  int compression = 0;
  uint8_t pal[256 * 3] = {0};
  std::vector<size_t> offsets;  // each channel's data
};

int psd_open(const uint8_t* d, size_t n, PsdInfo& p) {
  if (n < 26) return kPassOn;  // i16 of a short header: struct.error
  if (psd_be16(d + 4) != 1) return kPassOn;  // "not a PSD file"
  const int bits = psd_be16(d + 22), psd_channels = psd_be16(d + 12), m = psd_be16(d + 24);
  int need;
  if (m == 0 && bits == 1) {
    p.mode = kMode1;
    need = 1;
  } else if (bits == 8 && (m == 0 || m == 1 || m == 7 || m == 8)) {
    p.mode = kModeL;
    need = 1;
  } else if (bits == 8 && m == 2) {
    p.mode = kModeP;
    need = 1;
  } else if (bits == 8 && (m == 3 || m == 9)) {
    p.mode = kModeRGB;
    p.lab = m == 9;
    need = 3;
  } else if (bits == 8 && m == 4) {
    p.mode = kModeCMYK;
    need = 4;
  } else {
    return kPassOn;  // MODES[(mode, bits)]: KeyError
  }
  if (need > psd_channels) return kCorrupt;  // "not enough channels"
  if (p.mode == kModeRGB && !p.lab && psd_channels == 4) {
    p.mode = kModeRGBA;
    need = 4;
  }
  p.channels = need;
  const uint32_t w = be32(d + 18), h = be32(d + 14);
  // the file as PsdImageFile reads it: reads stop at its end, seeks do not
  size_t pos = 26;
  auto read = [&](size_t k) {
    const size_t at = std::min(pos, n);
    pos = std::min(pos, n) + std::min(k, n - std::min(pos, n));
    return at;
  };
  auto i32 = [&](uint32_t& v) {  // i32(read(4)); false: struct.error
    if (pos >= n || n - pos < 4) return false;
    v = be32(d + read(4));
    return true;
  };
  uint32_t size;
  if (!i32(size)) return kPassOn;  // colour mode data
  if (size) {
    const size_t at = read(size);
    if (p.mode == kModeP && size == 768 && n - at >= 768) {
      for (int i = 0; i < 256; ++i)
        for (int c = 0; c < 3; ++c) p.pal[3 * i + c] = d[at + 256 * c + i];  // "RGB;L"
      p.has_pal = true;
    }
  }
  if (!i32(size)) return kPassOn;  // image resources
  if (size) {
    const size_t end = pos + size;
    while (pos < end) {
      read(4);  // signature
      if (pos >= n || n - pos < 2) return kPassOn;  // i16 of a short read
      read(2);
      if (pos >= n) return kPassOn;  // i8 of an empty read: IndexError
      const size_t name = d[read(1)];
      const size_t before = std::min(pos, n);
      read(name);
      if (!((std::min(pos, n) - before) & 1)) read(1);  // padding
      uint32_t len;
      if (!i32(len)) return kPassOn;
      const size_t at = std::min(pos, n);
      read(len);
      if ((std::min(pos, n) - at) & 1) read(1);  // padding
    }
  }
  if (!i32(size)) return kPassOn;  // layer and mask information
  if (size) {
    const size_t end = pos + size;
    uint32_t layers;
    if (!i32(layers)) return kPassOn;
    pos = end;
  }
  // _maketile
  if (pos >= n || n - pos < 2) return kPassOn;  // i16 of a short read
  p.compression = psd_be16(d + read(2));
  size_t offset = pos;
  if (p.compression == 0) {
    const uint64_t plane = (uint64_t)w * h;
    for (int c = 0; c < p.channels; ++c) p.offsets.push_back((size_t)(offset + c * plane));
  } else if (p.compression == 1) {
    const uint64_t rows = (uint64_t)p.channels * h;
    if (pos >= n || (n - pos) / 2 < rows) return kPassOn;  // i16 of a short byte-count table
    const uint8_t* counts = d + pos;
    offset = pos + 2 * rows;
    for (int c = 0; c < p.channels; ++c) {
      p.offsets.push_back(offset);
      for (uint32_t y = 0; y < h; ++y) offset += psd_be16(counts + 2 * ((uint64_t)c * h + y));
    }
  }
  if (w == 0 || h == 0) return kPassOn;  // "not identified by this driver"
  if ((uint64_t)w * h > kMaxPixels) return kCorrupt;  // DecompressionBombError
  p.w = (int)w;
  p.h = (int)h;
  // PIL opens Lab, and convert("L") fails: refused as soon as it is known
  return p.lab ? kPsdLab : kOk;
}

int probe_psd(const uint8_t* d, size_t n, int& w, int& h) {
  PsdInfo p;
  const int rc = psd_open(d, n, p);
  w = p.w;
  h = p.h;
  return rc;
}

// PackBitsDecode.c: `rows` rows of `bytes` bytes from d + pos on
bool psd_packbits(const uint8_t* d, size_t n, size_t pos, int rows, size_t bytes,
                  std::vector<uint8_t>& out) {
  out.assign((size_t)rows * bytes, 0);
  size_t x = 0;
  int y = 0;
  while (true) {
    if (pos >= n) return false;  // "image file is truncated"
    const int c = d[pos];
    uint8_t* row = out.data() + (size_t)y * bytes;
    if (c & 0x80) {
      if (c == 0x80) {
        ++pos;
        continue;
      }
      if (n - pos < 2) return false;
      for (int k = 257 - c; k > 0 && x < bytes; --k) row[x++] = d[pos + 1];
      pos += 2;
    } else {
      const size_t len = (size_t)c + 1;
      if (n - pos < len + 1) return false;
      for (size_t k = 0; k < len && x < bytes; ++k) row[x++] = d[pos + 1 + k];
      pos += len + 1;
    }
    if (x >= bytes) {
      x = 0;
      if (++y >= rows) return true;
    }
  }
}

int decode_psd(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  PsdInfo p;
  const int rc = psd_open(d, n, p);
  if (rc) return rc;
  w = p.w;
  h = p.h;
  if (p.compression > 1) return kCorrupt;  // no tile: "cannot load this image"
  const size_t row = p.mode == kMode1 ? ((size_t)w + 7) / 8 : (size_t)w;
  std::vector<std::vector<uint8_t>> planes(p.channels);
  for (int c = 0; c < p.channels; ++c) {
    if (p.compression == 1) {
      if (!psd_packbits(d, n, p.offsets[c], h, row, planes[c])) return kCorrupt;
    } else {
      const size_t at = p.offsets[c];
      if (at > n || (n - at) / row < (size_t)h) return kCorrupt;  // "image file is truncated"
      planes[c].assign(d + at, d + at + row * h);
    }
  }
  const size_t npx = (size_t)w * h;
  gray.resize(npx);
  const uint8_t* q = planes[0].data();
  for (size_t i = 0; i < npx; ++i) {
    switch (p.mode) {
      case kMode1: {
        const size_t y = i / w, x = i % w;
        gray[i] = (q[y * row + x / 8] >> (7 - x % 8)) & 1 ? 255 : 0;
        break;
      }
      case kModeP:
        gray[i] = p.has_pal ? pil_luma(p.pal[3 * q[i]], p.pal[3 * q[i] + 1], p.pal[3 * q[i] + 2])
                            : 0;
        break;
      case kModeRGB: case kModeRGBA:
        gray[i] = pil_luma(q[i], planes[1][i], planes[2][i]);
        break;
      case kModeCMYK:  // "C;I", "M;I", "Y;I", "K;I"
        gray[i] = pil_cmyk_luma(255 - q[i], 255 - planes[1][i], 255 - planes[2][i],
                                255 - planes[3][i]);
        break;
      default:
        gray[i] = q[i];
    }
  }
  return kOk;
}
