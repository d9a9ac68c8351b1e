// ICNS as PIL 12.1's IcnsImagePlugin reads it, then convert("L").
//
// _open walks the blocks while the offset is short of the header's file
// size (a header cut short, or a block size of 0, passes the file on; a
// later block of a type replaces an earlier one) and takes the best size,
// the largest (width, height, scale) of SIZES with a block present (none
// passes the file on). Loading calls, in SIZES' order, the reader of each
// block that size has:
//   - ic07-ic14, icp4-icp6: a PNG (native_png.h, read from the block's
//     start to the end of the file: any failure raises, the file being
//     open) or JPEG 2000 (refused, kIcnsJpeg2000: the port has no JPEG
//     2000 decoder); another signature raises;
//   - it32 (after four zero bytes), ih32, il32, is32: read_32, an RGB icon,
//     interleaved where the block holds exactly 3 · w · h bytes, else three
//     planes of PackBits-like runs (a byte n ≥ 128 repeats the next byte
//     n − 125 times, a byte n < 128 is a literal of n + 1 bytes), each
//     plane ending exactly at w · h bytes (else SyntaxError) and held to
//     them (a plane cut short by the end of the file raises);
//   - t8mk, h8mk, l8mk, s8mk: the 8-bit mask, which must be all there and
//     does not change the gray.
// The image is the PNG where there is one (its own mode's gray, its size
// one that the sizes allow), else the RGB icon.
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_png.h.

struct IcnsSize {
  int w, h, scale;
  const char* types[3];
};

// IcnsFile.SIZES, in its order; the reader of each type is told by its name
const IcnsSize kIcnsSizes[] = {
    {512, 512, 2, {"ic10"}},         {512, 512, 1, {"ic09"}},
    {256, 256, 2, {"ic14"}},         {256, 256, 1, {"ic08"}},
    {128, 128, 2, {"ic13"}},         {128, 128, 1, {"ic07", "it32", "t8mk"}},
    {64, 64, 1, {"icp6"}},           {32, 32, 2, {"ic12"}},
    {48, 48, 1, {"ih32", "h8mk"}},   {32, 32, 1, {"icp5", "il32", "l8mk"}},
    {16, 16, 2, {"ic11"}},           {16, 16, 1, {"icp4", "is32", "s8mk"}},
};

struct IcnsInfo {
  std::map<uint32_t, std::pair<int64_t, int64_t>> blocks;  // type → (start, length)
  std::vector<const IcnsSize*> sizes;                       // itersizes()
  const IcnsSize* best = nullptr;
};

int icns_open(const uint8_t* d, size_t n, IcnsInfo& f) {
  if (n < 8) return kPassOn;  // nextheader: struct.error
  const int64_t filesize = be32(d + 4);
  int64_t i = 8;
  while (i < filesize) {
    if ((uint64_t)i > n || n - i < 8) return kPassOn;  // nextheader of a short read
    const uint32_t type = be32(d + i);
    const int64_t blocksize = be32(d + i + 4);
    if (blocksize == 0) return kPassOn;  // "invalid block header"
    i += 8;
    f.blocks[type] = {i, blocksize - 8};
    i += blocksize - 8;
  }
  for (const IcnsSize& s : kIcnsSizes)
    for (const char* t : s.types)
      if (t && f.blocks.count(be32((const uint8_t*)t))) {
        f.sizes.push_back(&s);
        break;
      }
  for (const IcnsSize* s : f.sizes)
    if (!f.best || std::make_tuple(s->w, s->h, s->scale) >
                       std::make_tuple(f.best->w, f.best->h, f.best->scale))
      f.best = s;
  if (!f.best) return kPassOn;  // "No 32bit icon resources found"
  return kOk;
}

// read_32: the three planes of an RGB icon of `sq` pixels
int icns_rgb(const uint8_t* d, size_t n, int64_t start, int64_t length, size_t sq,
             std::vector<uint8_t>& rgb) {
  size_t pos = (size_t)std::min<int64_t>(start, (int64_t)n);
  rgb.assign(sq * 3, 0);
  if (length == (int64_t)(sq * 3)) {  // interleaved
    if (n - pos < sq * 3) return kCorrupt;  // "not enough image data"
    std::memcpy(rgb.data(), d + pos, sq * 3);
    return kOk;
  }
  for (int band = 0; band < 3; ++band) {
    int64_t left = (int64_t)sq;
    size_t got = 0;
    while (left > 0 && pos < n) {
      const int c = d[pos++];
      int64_t block;
      if (c & 0x80) {
        block = c - 125;
        if (pos < n) {
          for (int64_t k = 0; k < block && got < sq; ++k) rgb[3 * got++ + band] = d[pos];
          ++pos;
        }
      } else {
        block = c + 1;
        const size_t take = std::min<size_t>((size_t)block, n - pos);
        for (size_t k = 0; k < take && got < sq; ++k) rgb[3 * got++ + band] = d[pos + k];
        pos += take;
      }
      left -= block;
    }
    if (left != 0) return kCorrupt;  // "Error reading channel"
    if (got < sq) return kCorrupt;   // a plane short of its pixels: "not enough image data"
  }
  return kOk;
}

int decode_icns(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  IcnsInfo f;
  int rc = icns_open(d, n, f);
  if (rc) return rc;
  const IcnsSize& s = *f.best;
  const size_t pw = (size_t)s.w * s.scale, ph = (size_t)s.h * s.scale, sq = pw * ph;
  std::vector<uint8_t> rgb;
  bool have_rgb = false;
  int64_t png = -1;
  PngState st;
  for (const char* t : s.types) {
    if (!t) continue;
    const auto it = f.blocks.find(be32((const uint8_t*)t));
    if (it == f.blocks.end()) continue;
    const int64_t start = it->second.first, length = it->second.second;
    const size_t at = (size_t)std::min<int64_t>(start, (int64_t)n), avail = n - at;
    const char kind = t[1] == '8' ? 'm' : !std::memcmp(t, "it32", 4) ? 't' :
                      t[2] == '3' ? 'r' : 'p';
    if (kind == 'p') {  // read_png_or_jpeg2000
      const uint8_t* sig = d + at;
      if (avail >= 8 && !std::memcmp(sig, kPngSig, 8)) {
        st = PngState();
        if (png_open(sig, avail, st)) return kCorrupt;
        png = (int64_t)at;
      } else if ((avail >= 4 && (!std::memcmp(sig, "\xff\x4f\xff\x51", 4) ||
                                 !std::memcmp(sig, "\x0d\x0a\x87\x0a", 4))) ||
                 (avail >= 12 && !std::memcmp(sig, "\0\0\0\x0cjP  \x0d\x0a\x87\x0a", 12))) {
        return kIcnsJpeg2000;
      } else {
        return kCorrupt;  // "Unsupported icon subimage format"
      }
    } else if (kind == 'm') {  // read_mk: the mask, all of it
      if (avail < sq) return kCorrupt;
    } else {
      int64_t from = start, len = length;
      if (kind == 't') {  // read_32t: four zero bytes first
        if (avail < 4 || le32(d + at)) return kCorrupt;  // "Unknown signature"
        from += 4;
        len -= 4;
      }
      rc = icns_rgb(d, n, from, len, sq, rgb);
      if (rc) return rc;
      have_rgb = true;
    }
  }
  if (png >= 0) {
    int pw2 = 0, ph2 = 0;
    rc = png_load(d + png, n - png, st, gray, pw2, ph2);
    if (rc) return kCorrupt;
    // the size setter: one of the sizes must divide into it
    bool ok = false;
    for (const IcnsSize* z : f.sizes) {
      const int64_t zw = (int64_t)z->w * z->scale, zh = (int64_t)z->h * z->scale;
      ok = ok || (double)zh / ph2 == (double)(zw / pw2);
    }
    if (!ok) return kCorrupt;  // "This is not one of the allowed sizes of this image"
    w = pw2;
    h = ph2;
    return kOk;
  }
  if (!have_rgb) return kCorrupt;  // channels["RGB"]: KeyError
  w = (int)pw;
  h = (int)ph;
  gray.resize(sq);
  for (size_t i = 0; i < sq; ++i) gray[i] = pil_luma(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
  return kOk;
}

// the size is the PNG entry's where the best size has one, known once it is
// read (PIL's im.size after load)
int probe_icns(const uint8_t* d, size_t n, int& w, int& h) {
  std::vector<uint8_t> gray;
  return decode_icns(d, n, gray, w, h);
}
