// FLI and FLC (Autodesk animations) as PIL 12.1 reads their frame 0, then
// convert("L"): FliImagePlugin's open (the 128-byte header and its zero
// ranges, the palette of the first frame's COLOR_256 or COLOR_64 chunk, a
// grey ramp where there is none, frame 0's size word) and Pillow's
// FliDecode.c as ImageFile.load feeds it: reads of the frame's size from
// the file's byte 128 (the frame there, whatever the open's prefix chunk
// skipped for the palette), the decoder taking nothing until the buffer
// holds the frame (one pad byte short of it is enough), then each subchunk:
// COLOR (4, 11) and PSTAMP (18) skipped, SS2 (7) word delta with its
// line-skip and last-byte words, LC (12) byte delta, BLACK (13), BRUN (15,
// its packet count byte ignored), COPY (16); a packet past the line ends the
// chunk's lines, and a chunk whose data or advance runs past the buffer
// fails. The image starts as zeros (palette index 0).
//
// Included by native_runtime.cpp inside its anonymous namespace.

struct FliInfo {
  int w = 0, h = 0;
  uint8_t pal[768];
  uint32_t framesize = 0;
};

inline int fli16(const uint8_t* p) { return p[0] | p[1] << 8; }

int fli_open(const uint8_t* d, size_t n, FliInfo& f) {
  if (n < 128) return kPassOn;  // "not an FLI/FLC file"
  for (int i : {20, 21})
    if (d[i]) return kPassOn;
  for (int i = 42; i < 80; ++i)
    if (d[i]) return kPassOn;
  for (int i = 88; i < 128; ++i)
    if (d[i]) return kPassOn;
  const int frames = fli16(d + 6);
  f.w = fli16(d + 8);
  f.h = fli16(d + 10);
  for (int i = 0; i < 256; ++i) f.pal[3 * i] = f.pal[3 * i + 1] = f.pal[3 * i + 2] = (uint8_t)i;
  size_t pos = 128;
  auto read = [&](size_t k, size_t& got) {  // read(k) at pos: the bytes there
    const size_t at = std::min(pos, n);
    got = std::min(k, n - at);
    pos += got;
    return d + at;
  };
  size_t got;
  const uint8_t* s = read(16, got);
  if (got < 6) return kPassOn;  // i16(s, 4): struct.error
  if (fli16(s + 4) == 0xF100) {
    pos = 128 + (size_t)le32(s);
    s = read(16, got);
    if (got < 6) return kPassOn;
  }
  if (fli16(s + 4) == 0xF1FA) {
    if (got < 8) return kPassOn;
    const int chunks = fli16(s + 6);
    int64_t chunk_size = -1;
    for (int c = 0; c < chunks; ++c) {
      if (chunk_size >= 0) pos += (size_t)(chunk_size - 6);
      const uint8_t* h6 = read(6, got);
      if (got < 6) return kPassOn;
      const int type = fli16(h6 + 4);
      if (type == 4 || type == 11) {  // the palette: packets of (skip, count), count 0 = 256
        const int shift = type == 11 ? 2 : 0;
        const uint8_t* p2 = read(2, got);
        if (got < 2) return kPassOn;
        const int packets = fli16(p2);
        int i = 0;
        for (int e = 0; e < packets; ++e) {
          const uint8_t* sk = read(2, got);
          if (got < 2) return kPassOn;  // s[0], s[1]: IndexError
          i += sk[0];
          const int count = sk[1] ? sk[1] : 256;
          const uint8_t* rgb = read((size_t)count * 3, got);
          for (size_t k = 0; k < got; k += 3) {
            if (k + 2 >= got || i >= 256) return kPassOn;  // IndexError
            for (int c3 = 0; c3 < 3; ++c3) f.pal[3 * i + c3] = (uint8_t)(rgb[k + c3] << shift);
            ++i;
          }
        }
        break;
      }
      chunk_size = le32(h6);
      if (!chunk_size) break;
    }
  }
  if (frames == 0) return kPassOn;  // seek(0): "attempt to seek outside sequence"
  if (n < 132) return kPassOn;      // "missing frame size", or i32: struct.error
  f.framesize = le32(d + 128);
  if (!f.w || !f.h) return kPassOn;
  if (too_big(f.w, f.h)) return kCorrupt;
  return kOk;
}

int probe_fli(const uint8_t* d, size_t n, int& w, int& h) {
  FliInfo f;
  const int rc = fli_open(d, n, f);
  w = f.w;
  h = f.h;
  return rc;
}

// FliDecode.c on one buffer: the bytes it took (0: not yet the whole
// frame), or -1 at the frame's end with err set where it failed
int64_t fli_decode(const uint8_t* buf, int64_t bytes, PilImage& im, bool& err) {
  const int W = im.w, H = im.h;
  auto px = [&](int x, int y) -> uint8_t& { return im.at(x, y)[0]; };
  if (bytes < 4) return 0;
  const uint8_t* ptr = buf;
  const int64_t framesize = le32(ptr);  // unsigned: a size of 2^31 or more waits too
  if (bytes + (bytes % 2) < framesize) return 0;
  err = true;
  if (bytes < 8) return -1;
  if (fli16(ptr + 4) != 0xF1FA) return -1;
  const int chunks = fli16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) return -1;
    const uint8_t* data = ptr + 6;
    auto oob = [&](int64_t k) { return data + k > ptr + bytes; };
    switch (fli16(ptr + 4)) {
      case 4: case 11: case 18:
        break;
      case 7: {  // SS2: word delta
        const int lines = fli16(data);
        data += 2;
        int l = 0, y = 0;
        for (; l < lines && y < H; ++l, ++y) {
          if (oob(2)) return -1;
          int packets = fli16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {  // skip lines
              y += 65536 - packets;
              if (y >= H) return -1;
            } else {  // the last byte of an odd-width line
              px(W - 1, y) = (uint8_t)packets;
            }
            if (oob(2)) return -1;
            packets = fli16(data);
            data += 2;
          }
          int p = 0, x = 0;
          for (; p < packets; ++p) {
            if (oob(2)) return -1;
            x += data[0];
            if (data[1] >= 128) {
              if (oob(4)) return -1;
              const int i = 256 - data[1];
              if (x + i + i > W) break;
              for (int j = 0; j < i; ++j) {
                px(x++, y) = data[2];
                px(x++, y) = data[3];
              }
              data += 4;
            } else {
              const int i = 2 * data[1];
              if (x + i > W) break;
              if (oob(2 + i)) return -1;
              for (int j = 0; j < i; ++j) px(x + j, y) = data[2 + j];
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return -1;
        break;
      }
      case 12: {  // LC: byte delta
        int y = fli16(data);
        const int ymax = y + fli16(data + 2);
        data += 4;
        for (; y < ymax && y < H; ++y) {
          if (oob(1)) return -1;
          const int packets = *data++;
          int p = 0, x = 0, i = 0;
          for (; p < packets; ++p, x += i) {
            if (oob(2)) return -1;
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > W) break;
              if (oob(3)) return -1;
              for (int j = 0; j < i; ++j) px(x + j, y) = data[2];
              data += 3;
            } else {
              i = data[1];
              if (x + i > W) break;
              if (oob(2 + i)) return -1;
              for (int j = 0; j < i; ++j) px(x + j, y) = data[2 + j];
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return -1;
        break;
      }
      case 13:  // BLACK
        for (int y = 0; y < H; ++y)
          for (int x = 0; x < W; ++x) px(x, y) = 0;
        break;
      case 15: {  // BRUN: the packet count byte of each line is ignored
        for (int y = 0; y < H; ++y) {
          data += 1;
          int x = 0, i = 0;
          for (; x < W; x += i) {
            if (oob(2)) return -1;
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > W) break;
              if (oob(i + 1)) return -1;
              for (int j = 0; j < i; ++j) px(x + j, y) = data[1 + j];
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > W) break;
              for (int j = 0; j < i; ++j) px(x + j, y) = data[1];
              data += 2;
            }
          }
          if (x != W) return -1;
        }
        break;
      }
      case 16:  // COPY
        if (INT32_MAX / W < H) return -1;
        if (data + (int64_t)W * H > ptr + bytes) {  // not yet the whole frame
          err = false;
          return ptr - buf;
        }
        for (int y = 0; y < H; ++y)
          for (int x = 0; x < W; ++x) px(x, y) = data[(size_t)y * W + x];
        break;
      default:
        return -1;  // an unknown chunk
    }
    const int32_t advance = (int32_t)le32(ptr);
    if (advance == 0 || advance < 0 || advance > bytes) return -1;
    ptr += advance;
    bytes -= advance;
  }
  err = false;
  return -1;
}

int decode_fli(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  FliInfo f;
  const int rc = fli_open(d, n, f);
  if (rc) return rc;
  w = f.w;
  h = f.h;
  PilImage im;
  im.alloc(kModeP, w, h);
  std::memcpy(im.pal, f.pal, 768);
  im.pal_n = 256;
  // ImageFile.load: reads of framesize bytes from 128 (decodermaxblock), the
  // buffer's unconsumed bytes kept for the next call
  size_t pos = 128;
  std::vector<uint8_t> b;
  while (true) {
    const size_t k = std::min<size_t>(f.framesize, n - std::min(pos, n));
    if (!k) return kCorrupt;  // "image file is truncated"
    b.insert(b.end(), d + pos, d + pos + k);
    pos += k;
    bool err = false;
    const int64_t used = fli_decode(b.data(), (int64_t)b.size(), im, err);
    if (used < 0) {
      if (err) return kCorrupt;
      break;
    }
    b.erase(b.begin(), b.begin() + used);
  }
  return pil_to_gray(im, gray);
}
