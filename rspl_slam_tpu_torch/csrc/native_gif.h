// GIF frame 0 as PIL 12's GifImagePlugin reads it, then convert("L"):
//
//   - the logical screen, grown to frame 0's extent where that passes it;
//   - a palette whose entry i is (i, i, i) for every i is dropped
//     (_is_palette_needed), the global one and a local one alike; a frame
//     left with no palette is mode L holding the raw indices. A local
//     identity palette does not fall back to the global palette: the frame
//     is L (its palette is False, not None);
//   - the canvas is filled with the graphic control extension's
//     transparency index where it has one, else 0, so pixels outside frame
//     0's rectangle keep that index through P → L;
//   - P → L through each entry's luma; indices past a short palette are
//     black;
//   - the LZW decoder is Pillow's GifDecode.c, fed as ImageFile.load feeds
//     it: 65536-byte reads from the first sub-block on, sub-blocks taken
//     whole, decoding stopping when the last row is written. An End code
//     only ends one call: the next read continues the code stream, and an
//     empty read raises ("image file is truncated"). A code past the
//     table, or a first code after Clear above Clear, is a broken stream.
//
// Extension blocks before the image (graphic control, comment,
// application, any other) are walked as the plugin walks them; a byte that
// starts no block is skipped; no image descriptor before the trailer or
// the end is "image not found in GIF frame".
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_pil.h.

struct GifInfo {
  int w = 0, h = 0;                        // the screen, grown to frame 0's extent
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;      // frame 0's extent
  bool interlace = false;
  int code_bits = 0;                       // the LZW minimum code size byte
  int transparency = -1;
  size_t offset = 0;                       // frame 0's first sub-block
  const uint8_t* pal = nullptr;            // the frame's palette (global or local), or none
  int pal_n = 0;
};

// _is_palette_needed: any entry other than (i, i, i)
inline bool gif_palette_needed(const uint8_t* p, int entries) {
  for (int i = 0; i < entries; ++i)
    if (p[3 * i] != i || p[3 * i + 1] != i || p[3 * i + 2] != i) return true;
  return false;
}

// GifImageFile._open and _seek(0) up to frame 0's image data
int gif_setup(const uint8_t* d, size_t n, GifInfo& g) {
  if (n < 13) return kCorrupt;
  g.w = d[6] | d[7] << 8;
  g.h = d[8] | d[9] << 8;
  size_t pos = 13;
  const uint8_t* global = nullptr;
  int global_n = 0;
  if (d[10] & 128) {
    const int entries = 1 << ((d[10] & 7) + 1);
    if (n - pos < (size_t)entries * 3) return kCorrupt;  // a short palette: IndexError, EOF
    if (gif_palette_needed(d + pos, entries)) {
      global = d + pos;
      global_n = entries;
    }
    pos += (size_t)entries * 3;
  }
  // self.data(): one sub-block, short at the end of the file; none at size 0
  auto block = [&](size_t& p, const uint8_t*& b, size_t& len) {
    if (p >= n || d[p] == 0) {
      if (p < n) ++p;
      return false;
    }
    len = std::min((size_t)d[p], n - p - 1);
    b = d + p + 1;
    p += 1 + len;
    return true;
  };
  auto skip_blocks = [&](size_t& p) {
    const uint8_t* b;
    size_t len;
    while (block(p, b, len)) {
    }
  };
  bool found = false;
  int local = -1;  // -1: no local palette; 0: an identity one (False); 1: a palette
  const uint8_t* local_pal = nullptr;
  int local_n = 0;
  while (pos < n && d[pos] != ';') {
    const uint8_t c = d[pos++];
    if (c == '!') {
      if (pos >= n) return kCorrupt;  // s[0] of an empty read
      const uint8_t label = d[pos++];
      const uint8_t* b = nullptr;
      size_t len = 0;
      const bool has = block(pos, b, len);
      if (label == 249 && has) {
        if (len < 1 || ((b[0] & 1) && len < 4)) return kCorrupt;  // block[0], block[3]
        if (b[0] & 1) g.transparency = b[3];
        if (len < 3) return kCorrupt;  // i16(block, 1)
      } else if (label == 254) {
        if (has) skip_blocks(pos);
        continue;
      } else if (label == 255 && has) {
        if (len >= 11 && !std::memcmp(b, "NETSCAPE2.0", 11)) block(pos, b, len);
      }
      skip_blocks(pos);
    } else if (c == ',') {
      if (n - pos < 9) return kCorrupt;
      const uint8_t* s = d + pos;
      pos += 9;
      g.x0 = s[0] | s[1] << 8;
      g.y0 = s[2] | s[3] << 8;
      g.x1 = g.x0 + (s[4] | s[5] << 8);
      g.y1 = g.y0 + (s[6] | s[7] << 8);
      if (g.x1 > g.w || g.y1 > g.h) {
        g.w = std::max(g.x1, g.w);
        g.h = std::max(g.y1, g.h);
        if ((uint64_t)g.w * g.h > kMaxPixels) return kCorrupt;
      }
      g.interlace = (s[8] & 64) != 0;
      if (s[8] & 128) {
        const int entries = 1 << ((s[8] & 7) + 1);
        if (n - pos < (size_t)entries * 3) return kCorrupt;
        local = gif_palette_needed(d + pos, entries) ? 1 : 0;
        local_pal = d + pos;
        local_n = entries;
        pos += (size_t)entries * 3;
      }
      if (pos >= n) return kCorrupt;  // read(1)[0]
      g.code_bits = d[pos++];
      g.offset = pos;
      found = true;
      break;
    }
  }
  if (!found) return kCorrupt;  // "image not found in GIF frame"
  if (local == 1) {
    g.pal = local_pal;
    g.pal_n = local_n;
  } else if (local == -1 && global) {
    g.pal = global;
    g.pal_n = global_n;
  }
  if ((uint64_t)g.w * g.h > kMaxPixels) return kCorrupt;
  return kOk;
}

// Pillow's GifDecode.c over one image: the decoder's state between calls
struct GifLzw {
  static constexpr int kBits = 12, kTable = 4096, kBuffer = 4096;
  uint8_t* im;  // the canvas (stride im_w)
  int im_w, xoff, yoff, xsize, ysize;
  int x = 0, y = 0, state = 0;
  int bits, clear = 0, end = 0, next = 0, codesize = 0, codemask = 0, lastcode = 0;
  int interlace, step = 1;
  int blocksize = 0, bitcount = 0;
  uint32_t bitbuffer = 0;
  uint8_t lastdata = 0;
  int bufferindex = kBuffer;
  uint8_t buffer[kBuffer];
  uint8_t data[kTable];
  uint16_t link[kTable];

  // NEWLINE: false once the last row is passed (the decoder's return -1)
  bool newline() {
    x = 0;
    y += step;
    while (y >= ysize) {
      switch (interlace) {
        case 1: y = 4; interlace = 2; break;
        case 2: step = 4; y = 2; interlace = 3; break;
        case 3: step = 2; y = 1; interlace = 0; break;
        default: return false;
      }
    }
    return true;
  }

  // One call: returns the bytes consumed (≥ 0), -1 when the image is done,
  // -2 for a broken stream
  int decode(const uint8_t* buf, int bytes) {
    const uint8_t* ptr = buf;
    if (!state) {
      clear = 1 << bits;
      end = clear + 1;
      if (interlace) {
        interlace = 1;
        step = 8;
      } else {
        step = 1;
      }
      state = 1;
    }
    uint8_t* out = im + (size_t)(y + yoff) * im_w + xoff + x;
    for (;;) {
      if (state == 1) {
        next = clear + 2;
        codesize = bits + 1;
        codemask = (1 << codesize) - 1;
        bufferindex = kBuffer;
        state = 2;
      }
      const uint8_t* p;
      int i;
      if (bufferindex < kBuffer) {
        i = kBuffer - bufferindex;
        p = &buffer[bufferindex];
        bufferindex = kBuffer;
      } else {
        while (bitcount < codesize) {
          if (blocksize > 0) {
            const int c = *ptr++;
            --bytes;
            --blocksize;
            bitbuffer |= (uint32_t)c << bitcount;
            bitcount += 8;
          } else {
            if (bytes < 1) return (int)(ptr - buf);
            const int c = *ptr;
            if (bytes < c + 1) return (int)(ptr - buf);
            blocksize = c;
            ++ptr;
            --bytes;
          }
        }
        int c = (int)(bitbuffer & (uint32_t)codemask);
        bitbuffer >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
          if (state != 2) state = 1;
          continue;
        }
        if (c == end) break;
        i = 1;
        p = &lastdata;
        if (state == 2) {
          if (c > clear) return -2;
          lastdata = (uint8_t)c;
          lastcode = c;
          state = 3;
        } else {
          const int thiscode = c;
          if (c > next) return -2;
          if (c == next) {
            if (bufferindex <= 0) return -2;
            buffer[--bufferindex] = lastdata;
            c = lastcode;
          }
          while (c >= clear) {
            if (bufferindex <= 0 || c >= kTable) return -2;
            buffer[--bufferindex] = data[c];
            c = link[c];
          }
          lastdata = (uint8_t)c;
          if (next < kTable) {
            data[next] = (uint8_t)c;
            link[next] = (uint16_t)lastcode;
            if (next == codemask && codesize < kBits) {
              ++codesize;
              codemask = (1 << codesize) - 1;
            }
            ++next;
          }
          lastcode = thiscode;
        }
      }
      if (y >= ysize) return -2;  // IMAGING_CODEC_OVERRUN
      for (int k = 0; k < i; ++k) {  // frame 0 has no transparency to skip
        *out++ = p[k];
        if (++x >= xsize) {
          if (!newline()) return -1;
          out = im + (size_t)(y + yoff) * im_w + xoff;
        }
      }
    }
    return (int)(ptr - buf);
  }
};

int decode_gif(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  GifInfo g;
  int rc = gif_setup(d, n, g);
  if (rc) return rc;
  w = g.w;
  h = g.h;
  // the decoder's setimage: an extent starting at x 0 of width 0 means the whole image
  int xoff = g.x0, yoff = g.y0, xsize = g.x1 - g.x0, ysize = g.y1 - g.y0;
  if (g.x0 == 0 && g.x1 == 0) {
    xoff = yoff = 0;
    xsize = g.w;
    ysize = g.h;
  }
  if (xsize <= 0 || ysize <= 0 || xoff + xsize > g.w || yoff + ysize > g.h) return kCorrupt;
  if (g.code_bits > 12) return kGifCodeSize;
  std::vector<uint8_t> canvas((size_t)g.w * g.h,
                              (uint8_t)(g.transparency >= 0 ? g.transparency : 0));
  auto lzw = std::make_unique<GifLzw>();
  GifLzw& z = *lzw;
  z.im = canvas.data();
  z.im_w = g.w;
  z.xoff = xoff;
  z.yoff = yoff;
  z.xsize = xsize;
  z.ysize = ysize;
  z.bits = g.code_bits;
  z.interlace = g.interlace ? 1 : 0;
  // ImageFile.load: 65536-byte reads appended to what the decoder left
  std::vector<uint8_t> b;
  size_t fpos = g.offset;
  for (;;) {
    const size_t take = std::min((size_t)65536, n - fpos);
    if (take == 0) return kCorrupt;  // "image file is truncated"
    b.insert(b.end(), d + fpos, d + fpos + take);
    fpos += take;
    const int r = z.decode(b.data(), (int)b.size());
    if (r == -1) break;
    if (r < 0) return kCorrupt;
    b.erase(b.begin(), b.begin() + r);
  }
  gray.resize(canvas.size());
  for (size_t i = 0; i < canvas.size(); ++i) {
    const int v = canvas[i];
    gray[i] = !g.pal ? (uint8_t)v
              : v < g.pal_n ? pil_luma(g.pal[3 * v], g.pal[3 * v + 1], g.pal[3 * v + 2])
                            : 0;
  }
  return kOk;
}
