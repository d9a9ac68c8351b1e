// The plugins of PIL 12.1 that hold their samples behind a small header,
// read as PIL reads them, then convert("L"): MSP, XBM, XPM, IM, IMT, IPTC,
// SPIDER, GBR, McIDAS, PIXAR, XVThumb and FITS. Each reader starts with its
// plugin's _open, returning kPassOn exactly where that open raises an error
// that passes the file on (SyntaxError, IndexError, TypeError, KeyError,
// EOFError, struct.error, or ImageFile's own "not identified" SyntaxError
// for an empty mode or a size of 0 or less), then decodes the tile the open set up as
// ImageFile.load does:
//   - Pillow's raw decoder (native_pil.h's raw_decode), and where the file
//     is opened by path, a single raw tile whose raw mode is its mode and a
//     mapping mode (L, P, I;16, I;16B, RGBA, CMYK) memory-mapped instead:
//     only McIDAS, whose row stride is its own, reads otherwise then (a
//     stride shorter than a row is no error there);
//   - MspDecoder (Python: the row map of 16-bit lengths, runs and literals),
//     XbmDecode.c (hex bytes after each 'x', LSB first), XpmDecoder
//     (Python: the pixel lines' keys through the colour dict), BitDecode.c
//     (the IM plugin's F;N kinds) and FitsGzipDecoder (Python: gzip of the
//     rest of the file, the low BITPIX / 8 bytes of each 4-byte word, rows
//     reversed), and the IPTC plugin's load (its data fields joined, a P5
//     header first when raw, opened again through every plugin, one band
//     placed among zero bands);
//   - GBR's own load (width · height · depth bytes after the name).
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_plugins.h (Python's int() and float() of text, py_space).

// ------------------------------------------------------ Python helpers
// bytes.strip() / split(): ASCII whitespace (py_space)
std::string py_strip(const std::string& s) {
  size_t a = 0, b = s.size();
  while (a < b && py_space((uint8_t)s[a])) ++a;
  while (b > a && py_space((uint8_t)s[b - 1])) --b;
  return s.substr(a, b - a);
}

std::string py_rstrip(const std::string& s) {
  size_t b = s.size();
  while (b > 0 && py_space((uint8_t)s[b - 1])) --b;
  return s.substr(0, b);
}

std::vector<std::string> py_split(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && py_space((uint8_t)s[i])) ++i;
    if (i >= s.size()) break;
    const size_t a = i;
    while (i < s.size() && !py_space((uint8_t)s[i])) ++i;
    out.push_back(s.substr(a, i - a));
  }
  return out;
}

// s[a:b] with Python's clamping (b < 0 counts from the end)
std::string py_slice(const std::string& s, int64_t a, int64_t b) {
  const int64_t n = (int64_t)s.size();
  if (a < 0) a = std::max<int64_t>(0, n + a);
  if (b < 0) b = std::max<int64_t>(0, n + b);
  a = std::min(a, n);
  b = std::min(b, n);
  return a < b ? s.substr((size_t)a, (size_t)(b - a)) : std::string();
}

// int(s) as a size: false where it raises; saturated to ±2^62
bool py_int_sat(const std::string& s, int64_t& v) {
  double x;
  if (!py_int_text(s, x)) return false;
  v = x > 4.6e18 ? ((int64_t)1 << 62) : x < -4.6e18 ? -((int64_t)1 << 62) : (int64_t)x;
  return true;
}

// int(s, 16) & 0xFFFFFF (Python's two's complement for a negative value)
bool py_hex24(const std::string& text, uint32_t& v) {
  const std::string s = py_strip(text);
  size_t i = 0;
  bool neg = false;
  if (i < s.size() && (s[i] == '+' || s[i] == '-')) neg = s[i++] == '-';
  if (i + 1 < s.size() && s[i] == '0' && (s[i + 1] == 'x' || s[i + 1] == 'X')) {
    i += 2;
    if (i < s.size() && s[i] == '_') ++i;  // an underscore may follow the prefix
  }
  if (i >= s.size()) return false;
  uint32_t x = 0;
  bool digit = false;
  for (; i < s.size(); ++i) {
    const int c = (uint8_t)s[i];
    int h;
    if (c == '_') {
      if (!digit || i + 1 >= s.size() || s[i + 1] == '_') return false;
      digit = false;
      continue;
    }
    if (c >= '0' && c <= '9') h = c - '0';
    else if (c >= 'a' && c <= 'f') h = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') h = c - 'A' + 10;
    else return false;
    x = (x << 4 | (uint32_t)h) & 0xFFFFFFu;
    digit = true;
  }
  if (!digit) return false;
  v = (neg ? (0x1000000u - x) : x) & 0xFFFFFFu;
  return true;
}

// readline() of a binary file: up to and including the next LF
std::string py_readline(const uint8_t* d, size_t n, size_t& pos) {
  const size_t a = pos;
  while (pos < n && d[pos] != '\n') ++pos;
  if (pos < n) ++pos;
  return std::string((const char*)d + a, pos - a);
}

inline bool too_big(int64_t w, int64_t h) {  // DecompressionBombError
  return w > (int64_t)kMaxPixels || h > (int64_t)kMaxPixels ||
         (uint64_t)w * (uint64_t)h > kMaxPixels;
}

// ImageFile.load of one raw tile whose raw mode is the image's mode, opened by
// path: a mapping mode is memory-mapped (Image.core.map_buffer) where
// offset + height · stride lies in the file, packed rows where stride ≤ 0;
// else Pillow's raw decoder
bool pil_maps(PilMode m) {
  return m == kModeL || m == kModeP || m == kModeI16 || m == kModeI16B || m == kModeRGBA ||
         m == kModeCMYK;
}

int raw_tile(const uint8_t* d, size_t n, int64_t offset, PilImage& im, const UnpackerDef& u,
             int64_t stride, int ystep, bool mapping) {
  if (offset < 0) return kCorrupt;  // "Tile offset cannot be negative", or seek()
  // the stride is a C int to map_buffer and to the raw decoder: OverflowError
  if (stride > INT32_MAX || stride < INT32_MIN) return kCorrupt;
  if (mapping && offset + (int64_t)im.h * stride <= (int64_t)n) {
    const int64_t bytes = ((int64_t)im.w * u.bits + 7) / 8;
    const int64_t step = stride > 0 ? stride : bytes;
    if (offset + (int64_t)im.h * step > (int64_t)n)
      return kCorrupt;  // "buffer is not large enough"
    std::vector<uint8_t> row((size_t)bytes);
    for (int r = 0; r < im.h; ++r) {
      const int64_t at = offset + r * step;  // rows past the file's end read as zeros
      for (int64_t i = 0; i < bytes; ++i) row[(size_t)i] = at + i < (int64_t)n ? d[at + i] : 0;
      unpack(u.op, im.at(0, ystep < 0 ? im.h - 1 - r : r), row.data(), im.w);
    }
    return kOk;
  }
  if ((uint64_t)offset > n) return kCorrupt;  // "image file is truncated"
  return raw_decode(d, n, (size_t)offset, im, 0, 0, im.w, im.h, u, stride, ystep);
}

// ================================================================== MSP
struct MspInfo {
  int w = 0, h = 0;
  bool lins = false;
};

int msp_open(const uint8_t* d, size_t n, MspInfo& m) {
  if (n < 32) return kPassOn;  // i16 of a short read: struct.error
  int x = 0;
  for (int i = 0; i < 32; i += 2) x ^= d[i] | d[i + 1] << 8;
  if (x) return kPassOn;  // "bad MSP checksum"
  m.w = d[4] | d[5] << 8;
  m.h = d[6] | d[7] << 8;
  m.lins = d[0] == 'L';
  if (!m.w || !m.h) return kPassOn;
  if (too_big(m.w, m.h)) return kCorrupt;
  return kOk;
}

int probe_msp(const uint8_t* d, size_t n, int& w, int& h) {
  MspInfo m;
  const int rc = msp_open(d, n, m);
  w = m.w;
  h = m.h;
  return rc;
}

int decode_msp(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  MspInfo m;
  int rc = msp_open(d, n, m);
  if (rc) return rc;
  w = m.w;
  h = m.h;
  PilImage im;
  im.alloc(kMode1, w, h);
  const UnpackerDef& u = *find_unpacker(kMode1, "1");
  if (!m.lins) {
    rc = raw_decode(d, n, 32, im, 0, 0, w, h, u, 0, 1);
    return rc ? rc : pil_to_gray(im, gray);
  }
  // MspDecoder: a row map of h lengths, then the rows one after another; a
  // row of length 0 is white
  const size_t stride = ((size_t)w + 7) / 8;
  if (n < 32 + 2 * (size_t)h) return kCorrupt;  // "Truncated MSP file in row map"
  std::vector<uint8_t> img;
  size_t pos = 32 + 2 * (size_t)h;
  for (int y = 0; y < h; ++y) {
    const size_t len = d[32 + 2 * y] | d[33 + 2 * y] << 8;
    if (!len) {
      img.insert(img.end(), stride, 0xFF);
      continue;
    }
    if (n - pos < len) return kCorrupt;  // "Truncated MSP file"
    const uint8_t* row = d + pos;
    pos += len;
    for (size_t i = 0; i < len;) {
      const int type = row[i++];
      if (type == 0) {  // a run: count, byte
        if (i + 2 > len) return kCorrupt;  // struct.error: "Corrupted MSP file"
        img.insert(img.end(), row[i], row[i + 1]);
        i += 2;
      } else {  // a literal, cut at the row's end
        img.insert(img.end(), row + i, row + std::min(len, i + type));
        i += type;
      }
    }
  }
  rc = raw_decode(img.data(), img.size(), 0, im, 0, 0, w, h, u, 0, 1);  // set_as_raw
  return rc ? rc : pil_to_gray(im, gray);
}

// ================================================================== XBM
// xbm_head matched at the start of the first 512 bytes:
//   \s*#define[ \t]+.*_width[ \t]+(\d+)[\r\n]+#define[ \t]+.*_height[ \t]+(\d+)[\r\n]+
//   (#define[ \t]+[^_]*_x_hot[ \t]+\d+[\r\n]+#define[ \t]+[^_]*_y_hot[ \t]+\d+[\r\n]+)?
//   [\000-\377]*_bits\[]
// a `.*` ends at its line's end, so one "_width" of a line at most is
// followed by its number and the line's end; [^_]* runs to the first '_'

// the tail [ \t]+(\d+)[\r\n]+ at p: its number (saturated) and end
bool xbm_number(const uint8_t* d, size_t n, size_t p, int64_t& v, size_t& end) {
  if (p >= n || (d[p] != ' ' && d[p] != '\t')) return false;
  while (p < n && (d[p] == ' ' || d[p] == '\t')) ++p;
  if (p >= n || d[p] < '0' || d[p] > '9') return false;
  v = 0;
  while (p < n && d[p] >= '0' && d[p] <= '9')
    v = std::min<int64_t>(v * 10 + (d[p++] - '0'), (int64_t)1 << 62);
  if (p >= n || (d[p] != '\r' && d[p] != '\n')) return false;
  while (p < n && (d[p] == '\r' || d[p] == '\n')) ++p;
  end = p;
  return true;
}

bool xbm_define(const uint8_t* d, size_t n, size_t& p, const char* name, bool hot, int64_t& v) {
  if (n - std::min(n, p) < 8 || std::memcmp(d + p, "#define", 7) ||
      (d[p + 7] != ' ' && d[p + 7] != '\t'))
    return false;
  const size_t k = std::strlen(name);
  if (hot) {
    size_t u = p + 8;
    while (u < n && d[u] != '_') ++u;
    size_t end;
    if (n - std::min(n, u) < k || std::memcmp(d + u, name, k) || !xbm_number(d, n, u + k, v, end))
      return false;
    p = end;
    return true;
  }
  size_t eol = p + 7;
  while (eol < n && d[eol] != '\n') ++eol;
  for (size_t s = eol >= k ? eol - k : 0; s + 1 > p + 8; --s) {  // the last occurrence first
    size_t end;
    if (s + k <= eol && !std::memcmp(d + s, name, k) && xbm_number(d, n, s + k, v, end)) {
      p = end;
      return true;
    }
    if (s == 0) break;
  }
  return false;
}

int xbm_open(const uint8_t* d, size_t n, int64_t& w, int64_t& h, size_t& data) {
  const size_t m = std::min<size_t>(n, 512);
  size_t p = 0;
  while (p < m && py_space(d[p])) ++p;
  if (!xbm_define(d, m, p, "_width", false, w) || !xbm_define(d, m, p, "_height", false, h))
    return kPassOn;  // "not a XBM file"
  size_t q = p;
  int64_t hx, hy;
  if (xbm_define(d, m, q, "_x_hot", true, hx) && xbm_define(d, m, q, "_y_hot", true, hy)) p = q;
  static const char kBits[] = "_bits[]";
  size_t end = 0;
  for (size_t s = p; s + 7 <= m; ++s)
    if (!std::memcmp(d + s, kBits, 7)) end = s + 7;
  if (!end) return kPassOn;
  data = end;
  if (w <= 0 || h <= 0) return kPassOn;
  if (too_big(w, h)) return kCorrupt;
  return kOk;
}

int probe_xbm(const uint8_t* d, size_t n, int& w, int& h) {
  int64_t W = 0, H = 0;
  size_t data;
  const int rc = xbm_open(d, n, W, H, data);
  w = (int)W;
  h = (int)H;
  return rc;
}

inline int xbm_hex(int v) {
  return v >= '0' && v <= '9' ? v - '0' : v >= 'a' && v <= 'f' ? v - 'a' + 10
                                        : v >= 'A' && v <= 'F' ? v - 'A' + 10 : 0;
}

int decode_xbm(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  int64_t W, H;
  size_t p;
  const int rc = xbm_open(d, n, W, H, p);
  if (rc) return rc;
  w = (int)W;
  h = (int)H;
  PilImage im;
  im.alloc(kMode1, w, h);
  const UnpackerDef& u = *find_unpacker(kMode1, "1;R");
  std::vector<uint8_t> row(((size_t)w + 7) / 8);
  size_t x = 0;
  for (int y = 0; y < h;) {
    while (p < n && d[p] != 'x') ++p;  // each byte follows an 'x'
    if (n - p < 3) return kCorrupt;  // "image file is truncated"
    row[x] = (uint8_t)((xbm_hex(d[p + 1]) << 4) + xbm_hex(d[p + 2]));
    if (++x >= row.size()) {
      unpack(u.op, im.at(0, y++), row.data(), w);
      x = 0;
    }
    p += 3;
  }
  return pil_to_gray(im, gray);
}

// ================================================================== XPM
struct XpmInfo {
  int w = 0, h = 0;
  int64_t bpp = 0, colours = 0;
  std::vector<std::string> keys;  // the colour dict's keys, in order
  std::vector<uint32_t> rgb;      // their colours
  size_t data = 0;
};

int xpm_open(const uint8_t* d, size_t n, XpmInfo& x) {
  size_t pos = std::min<size_t>(n, 9);
  int64_t g[4];
  while (true) {
    const std::string line = py_readline(d, n, pos);
    if (line.empty()) return kPassOn;  // "broken XPM file"
    // "([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)  at the line's start
    size_t i = 1;
    bool ok = line[0] == '"';
    std::string num[4];
    for (int k = 0; ok && k < 4; ++k) {
      if (k) ok = i < line.size() && line[i++] == ' ';
      while (ok && i < line.size() && line[i] >= '0' && line[i] <= '9') num[k] += line[i++];
    }
    if (!ok) continue;
    for (int k = 0; k < 4; ++k)
      if (!py_int_sat(num[k], g[k])) return kCorrupt;  // int(b""): ValueError
    break;
  }
  x.bpp = g[3];
  x.colours = g[2];
  for (int64_t c = 0; c < x.colours; ++c) {
    const std::string line = py_rstrip(py_readline(d, n, pos));
    const std::string key = py_slice(line, 1, x.bpp + 1);
    const std::vector<std::string> s = py_split(py_slice(line, x.bpp + 1, -2));
    bool found = false;
    for (size_t i = 0; i < s.size(); i += 2) {
      if (s[i] != "c") continue;
      if (i + 1 >= s.size()) return kPassOn;  // s[i + 1]: IndexError
      const std::string& v = s[i + 1];
      if (v != "None") {
        uint32_t rgb;
        if (v[0] != '#' || !py_hex24(v.substr(1), rgb)) return kCorrupt;  // ValueError
        auto it = std::find(x.keys.begin(), x.keys.end(), key);
        if (it == x.keys.end()) {
          x.keys.push_back(key);
          x.rgb.push_back(rgb);
        } else {
          x.rgb[it - x.keys.begin()] = rgb;
        }
      }
      found = true;
      break;
    }
    if (!found) return kCorrupt;  // "cannot read this XPM file"
    if (pos >= n && c + 1 < x.colours) {  // every further line is empty: ValueError
      return kCorrupt;
    }
  }
  x.data = pos;
  if (g[0] <= 0 || g[1] <= 0) return kPassOn;
  if (too_big(g[0], g[1])) return kCorrupt;
  x.w = (int)g[0];
  x.h = (int)g[1];
  return kOk;
}

int probe_xpm(const uint8_t* d, size_t n, int& w, int& h) {
  XpmInfo x;
  const int rc = xpm_open(d, n, x);
  w = x.w;
  h = x.h;
  return rc;
}

int decode_xpm(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  XpmInfo x;
  const int rc = xpm_open(d, n, x);
  if (rc) return rc;
  w = x.w;
  h = x.h;
  if (x.bpp <= 0) return kCorrupt;  // range(..., 0): ValueError (or no line: no data)
  std::unordered_map<std::string_view, uint32_t> index;  // key → its place in the dict
  for (size_t i = 0; i < x.keys.size(); ++i) index.emplace(x.keys[i], (uint32_t)i);
  const size_t want = (size_t)w * h;
  gray.resize(want);
  size_t got = 0, pos = x.data;
  bool pixel_header = false;
  while (got < want) {
    const size_t a = pos;
    while (pos < n && d[pos] != '\n') ++pos;
    if (pos < n) ++pos;
    if (a == pos) break;  // the end of the file
    std::string_view line((const char*)d + a, pos - a);
    size_t e = line.size();
    while (e > 0 && py_space((uint8_t)line[e - 1])) --e;
    if (line.substr(0, e) == "/* pixels */" && !pixel_header) {
      pixel_header = true;
      continue;
    }
    // b'"'.join(line.split(b'"')[1:-1]): from the first quote to the last
    const size_t q0 = line.find('"'), q1 = line.rfind('"');
    line = q0 == std::string_view::npos || q0 == q1 ? std::string_view()
                                                    : line.substr(q0 + 1, q1 - q0 - 1);
    const size_t step = (size_t)std::min<int64_t>(x.bpp, (int64_t)line.size());
    for (size_t i = 0; i < line.size(); i += step) {
      auto it = index.find(line.substr(i, step));
      if (it == index.end()) return kCorrupt;  // palette.index: ValueError; palette[key]: KeyError
      if (got < want) {
        // P: the index into the dict (at most 256 colours), its palette entry; RGB: its colour
        const uint32_t c = x.rgb[it->second];
        gray[got] = pil_luma(c >> 16 & 255, c >> 8 & 255, c & 255);
      }
      ++got;
    }
  }
  if (got < want) return kCorrupt;  // set_as_raw: "not enough image data"
  return kOk;
}

// =================================================================== IM
// ImImagePlugin's OPEN: an "Image type" value → (mode, raw mode)
bool im_open_mode(const std::string& v, std::string& mode, std::string& raw) {
  static const char* kTable[][3] = {
      {"0 1 image", "1", "1"}, {"L 1 image", "1", "1"}, {"Greyscale image", "L", "L"},
      {"Grayscale image", "L", "L"}, {"RGB image", "RGB", "RGB;L"}, {"RLB image", "RGB", "RLB"},
      {"RYB image", "RGB", "RLB"}, {"B1 image", "1", "1"}, {"B2 image", "P", "P;2"},
      {"B4 image", "P", "P;4"}, {"X 24 image", "RGB", "RGB"}, {"L 32 S image", "I", "I;32"},
      {"L 32 F image", "F", "F;32"}, {"RGB3 image", "RGB", "RGB;T"},
      {"RYB3 image", "RGB", "RYB;T"}, {"LA image", "LA", "LA;L"}, {"PA image", "LA", "PA;L"},
      {"RGBA image", "RGBA", "RGBA;L"}, {"RGBX image", "RGB", "RGBX;L"},
      {"CMYK image", "CMYK", "CMYK;L"}, {"YCC image", "YCbCr", "YCbCr;L"}};
  for (const auto& e : kTable)
    if (v == e[0]) {
      mode = e[1];
      raw = e[2];
      return true;
    }
  // "L <i> image" and "L*<i> image"
  if (v.size() < 9 || v[0] != 'L' || (v[1] != ' ' && v[1] != '*') ||
      v.compare(v.size() - 6, 6, " image"))
    return false;
  const std::string i = v.substr(2, v.size() - 8);
  for (const char* f : {"8", "8S", "16", "16S", "32", "32F"})
    if (i == f) {
      mode = "F";
      raw = "F;" + i;
      return true;
    }
  for (const char* f : {"16", "16L", "16B"})
    if (i == f) {
      mode = raw = "I;" + i;
      return true;
    }
  if (i == "32S") {
    mode = "I";
    raw = "I;32S";
    return true;
  }
  if (v[1] == '*' && i.size() <= 2 && !i.empty() && std::isdigit((uint8_t)i[0]) &&
      (i.size() == 1 || std::isdigit((uint8_t)i[1])) && i[0] != '0') {
    const int j = std::atoi(i.c_str());
    if (j >= 2 && j <= 32) {
      mode = "F";
      raw = "F;" + i;
      return true;
    }
  }
  return false;
}

struct ImInfo {
  std::string mode = "L", raw = "L";
  std::vector<double> size = {512, 512};
  bool size_ints = true;  // every size value parsed as an int, not a float
  bool lut = false;
  uint8_t pal[768];
  size_t pal_len = 0;  // the Lut's bytes read (512 to 768 where it is used)
  size_t offset = 0;
};

int im_open(const uint8_t* d, size_t n, ImInfo& I) {
  if (!std::memchr(d, '\n', std::min<size_t>(n, 100))) return kPassOn;
  size_t pos = 0;
  int tags = 0;
  int last = -1;  // the byte that ended the header: -1 for the end of the file
  bool bad_number = false;
  while (true) {
    if (pos >= n) break;
    const int c = d[pos++];
    if (c == '\r') continue;
    if (c == 0 || c == 0x1a) {
      last = c;
      break;
    }
    size_t e = pos;
    while (e < n && d[e] != '\n') ++e;
    if (e < n) ++e;
    std::string s(1, (char)c);
    s.append((const char*)d + pos, e - pos);
    pos = e;
    if (s.size() > 100) return kPassOn;
    if (s.size() >= 2 && !s.compare(s.size() - 2, 2, "\r\n")) s.resize(s.size() - 2);
    else if (!s.empty() && s.back() == '\n') s.pop_back();
    // split = ^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$
    const size_t colon = s.find(':');
    if (s.empty() || !std::isalpha((uint8_t)s[0]) || (uint8_t)s[0] > 127 ||
        colon == std::string::npos || s.find('\n') != std::string::npos)
      return kPassOn;  // "Syntax error in IM header"
    size_t vs = colon + 1;
    while (vs < s.size() && (s[vs] == ' ' || s[vs] == '\t')) ++vs;
    const std::string k = s.substr(0, colon), v = s.substr(vs);
    if (k == "File size (no of images)" || k == "Scale (x,y)" || k == "Image size (x*y)") {
      // the value is latin-1 text: int() and float() of it skip 0x85 and
      // 0xA0 as they skip ASCII whitespace
      std::string t = v;
      for (char& ch : t) {
        const uint8_t u = (uint8_t)ch;
        if (ch == '*') ch = ',';
        else if (u == 0x85 || u == 0xa0) ch = ' ';
      }
      std::vector<double> nums;
      bool ints = true;
      size_t a = 0;
      while (true) {
        const size_t b = t.find(',', a);
        const std::string part = t.substr(a, b == std::string::npos ? std::string::npos : b - a);
        double x;
        if (py_int_text(part, x)) {
        } else if (py_float_text(part, x)) {
          ints = false;
        } else {
          bad_number = true;  // ValueError ends the open
          break;
        }
        nums.push_back(x);
        if (b == std::string::npos) break;
        a = b + 1;
      }
      if (bad_number) return kCorrupt;
      if (k == "Image size (x*y)") {
        I.size = nums;
        I.size_ints = ints;
      }
    } else if (k == "Image type") {
      std::string mode, raw;
      if (im_open_mode(v, mode, raw)) {
        I.mode = mode;
        I.raw = raw;
      } else {
        I.mode = v;
      }
    }
    if (k == "Lut") I.lut = true;
    if (k == "Comment" || k == "Date" || k == "Digitalization equipment" ||
        k == "File size (no of images)" || k == "Lut" || k == "Name" || k == "Scale (x,y)" ||
        k == "Image size (x*y)" || k == "Image type")
      ++tags;
  }
  if (!tags) return kPassOn;  // "Not an IM file"
  if (I.size.size() == 1) return kPassOn;  // a number, not a size: self.size[0], TypeError
  if (last < 0) return kPassOn;  // "File truncated"
  if (last == 0) {
    while (pos < n && d[pos] != 0x1a) ++pos;
    if (pos >= n) return kPassOn;
    ++pos;
  }
  if (I.lut) {
    const size_t len = std::min<size_t>(768, n - pos);
    const uint8_t* p = d + pos;
    bool grey = true, linear = true;
    for (size_t i = 0; i < 256; ++i) {
      if (len <= i + 256) return kPassOn;  // palette[i + 256]: IndexError
      if (p[i] == p[i + 256]) {
        if (len <= i + 512) return kPassOn;
        if (p[i + 256] == p[i + 512]) {
          if (p[i] != i) linear = false;
          continue;
        }
      }
      grey = false;
    }
    std::memcpy(I.pal, p, len);
    I.pal_len = len;
    pos += len;
    (void)linear;  // a non-linear grey Lut sets im.lut, which convert() ignores
    if (!grey) {
      if (I.mode == "L" || I.mode == "P") {
        I.mode = I.raw = "P";
      } else if (I.mode == "LA" || I.mode == "PA") {
        I.mode = "PA";
        I.raw = "PA;L";
      } else {
        I.lut = false;
      }
    } else {
      I.lut = false;  // no palette set
    }
  }
  I.offset = pos;
  if (I.mode.empty() || I.size[0] <= 0 || I.size[1] <= 0) return kPassOn;  // NaN is no size ≤ 0
  auto at_least_1 = [](double v) { return v > 1 ? v : 1.0; };  // Python's max(1, v)
  if (at_least_1(I.size[0]) * at_least_1(I.size[1]) > (double)kMaxPixels) return kCorrupt;
  return kOk;
}

int probe_im(const uint8_t* d, size_t n, int& w, int& h) {
  ImInfo I;
  const int rc = im_open(d, n, I);
  if (!rc && (I.size.size() != 2 || !I.size_ints)) return kCorrupt;
  w = rc ? 0 : (int)I.size[0];
  h = rc ? 0 : (int)I.size[1];
  return rc;
}

// BitDecode.c with the IM plugin's (bits, pad 8, fill 3, unsigned, bottom-up):
// bytes enter the bit buffer above its bits, values leave from its bottom;
// each row starts on a byte
int im_bit_decode(const uint8_t* d, size_t n, size_t pos, PilImage& im, int bits) {
  const uint64_t mask = (1ull << bits) - 1;
  uint64_t buf = 0;
  int count = 0, x = 0, y = im.h - 1;
  while (pos < n) {
    const uint8_t byte = d[pos++];
    buf |= (uint64_t)byte << count;
    count += 8;
    while (count >= bits) {
      const uint64_t v = buf & mask;
      if (count > 32) buf = byte >> (8 - (count - bits));
      else buf >>= bits;
      count -= bits;
      const float f = (float)v;
      std::memcpy(im.at(x, y), &f, 4);
      if (++x >= im.w) {
        x = 0;
        if (--y < 0) return kOk;
        buf = 0;  // the pad: the next row starts on a byte
        count = 0;
      }
    }
  }
  return kCorrupt;  // "image file is truncated"
}

int decode_im(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  ImInfo I;
  int rc = im_open(d, n, I);
  if (rc) return rc;
  // a size of other than two ints, and a mode Pillow lacks, fail at load
  if (I.size.size() != 2 || !I.size_ints) return kCorrupt;
  const PilMode mode = pil_mode(I.mode);
  if (mode == kModeNone || mode == kModeLAB) return kCorrupt;  // "unrecognized image mode"
  w = (int)I.size[0];
  h = (int)I.size[1];
  PilImage im;
  im.alloc(mode, w, h);
  if (I.lut) {  // a colour Lut: the palette, planar ("RGB;L") over its length / 3 entries
    const int e = (int)(I.pal_len / 3);
    for (int i = 0; i < e; ++i)
      for (int c = 0; c < 3; ++c) im.pal[3 * i + c] = I.pal[e * c + i];
    im.pal_n = e;
  }
  const std::string& raw = I.raw;
  if (raw.size() > 2 && raw[0] == 'F' && raw[1] == ';') {
    bool digits = true;
    for (size_t i = 2; i < raw.size(); ++i) digits &= std::isdigit((uint8_t)raw[i]) != 0;
    const int bits = digits ? std::atoi(raw.c_str() + 2) : 8;
    if (digits && bits != 8 && bits != 16 && bits != 32) {
      if (mode != kModeF) return kCorrupt;  // the bit decoder's config error
      rc = im_bit_decode(d, n, I.offset, im, bits);
      return rc ? rc : pil_to_gray(im, gray);
    }
  }
  if (raw == "RGB;T" || raw == "RYB;T") {  // G, R and B planes, each bottom-up
    if (mode != kModeRGB) return kCorrupt;
    const size_t plane = (size_t)w * h;
    for (int t = 0; t < 3; ++t) {
      const UnpackerDef& u = *find_unpacker(kModeRGB, t == 0 ? "G" : t == 1 ? "R" : "B");
      rc = raw_decode(d, n, std::min(n, I.offset + t * plane), im, 0, 0, w, h, u, 0, -1);
      if (rc) return rc;
    }
    return pil_to_gray(im, gray);
  }
  const UnpackerDef* u = find_unpacker(mode, raw);
  if (!u) return kCorrupt;  // "unknown raw mode for given image mode"
  rc = raw_tile(d, n, (int64_t)I.offset, im, *u, 0, -1, raw == I.mode && pil_maps(mode));
  return rc ? rc : pil_to_gray(im, gray);
}

// ================================================================== IMT
struct ImtInfo {
  int64_t w = 0, h = 0;
  bool mode = false, tile = false;
  size_t offset = 0;
};

int imt_open(const uint8_t* d, size_t n, ImtInfo& t) {
  size_t pos = std::min<size_t>(n, 100);
  std::string buffer((const char*)d, pos);
  if (buffer.find('\n') == std::string::npos) return kPassOn;
  auto read = [&](size_t k) {
    const size_t m = std::min(k, n - pos);
    std::string r((const char*)d + pos, m);
    pos += m;
    return r;
  };
  int64_t xsize = 0, ysize = 0;
  while (true) {
    std::string s;
    if (!buffer.empty()) {
      s = buffer.substr(0, 1);
      buffer.erase(0, 1);
    } else {
      s = read(1);
    }
    if (s.empty()) break;
    if (s[0] == '\x0c') {
      t.tile = true;
      t.offset = pos - buffer.size();
      break;
    }
    if (buffer.find('\n') == std::string::npos) buffer += read(100);
    const size_t nl = buffer.find('\n');
    if (nl == std::string::npos) {
      s += buffer;
      buffer.clear();
    } else {
      s += buffer.substr(0, nl);
      buffer.erase(0, nl + 1);
    }
    if (s.size() == 1 || s.size() > 100) break;
    if (s[0] == '*') continue;
    // field = ([a-z]*) ([^ \r\n]*), matched at the start
    size_t i = 0;
    while (i < s.size() && s[i] >= 'a' && s[i] <= 'z') ++i;
    if (i >= s.size() || s[i] != ' ') break;
    size_t j = i + 1;
    while (j < s.size() && s[j] != ' ' && s[j] != '\r' && s[j] != '\n') ++j;
    const std::string k = s.substr(0, i), v = s.substr(i + 1, j - i - 1);
    if (k == "width") {
      if (!py_int_sat(v, xsize)) return kCorrupt;  // int(v): ValueError ends the open
      t.w = xsize;
      t.h = ysize;
    } else if (k == "height") {
      if (!py_int_sat(v, ysize)) return kCorrupt;
      t.w = xsize;
      t.h = ysize;
    } else if (k == "pixel" && v == "n8") {
      t.mode = true;
    }
  }
  if (!t.mode || t.w <= 0 || t.h <= 0) return kPassOn;
  if (too_big(t.w, t.h)) return kCorrupt;
  return kOk;
}

int probe_imt(const uint8_t* d, size_t n, int& w, int& h) {
  ImtInfo t;
  const int rc = imt_open(d, n, t);
  w = (int)t.w;
  h = (int)t.h;
  return rc;
}

int decode_imt(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  ImtInfo t;
  int rc = imt_open(d, n, t);
  if (rc) return rc;
  if (!t.tile) return kCorrupt;  // "cannot load this image"
  w = (int)t.w;
  h = (int)t.h;
  PilImage im;
  im.alloc(kModeL, w, h);
  rc = raw_tile(d, n, (int64_t)t.offset, im, *find_unpacker(kModeL, "L"), 0, 1, true);
  return rc ? rc : pil_to_gray(im, gray);
}

// ================================================================= IPTC
struct IptcInfo {
  PilMode mode = kModeNone;
  int band = -2;  // -2: none (mode L); else the band index (Python's, -1 the last)
  int64_t w = 0, h = 0, compression = 0;
  bool tile = false;
  size_t offset = 0;
};

// IptcImageFile.field at pos: 0 with the tag and size; 1 for no tag (a
// read of zeros); kPassOn for a SyntaxError-like failure, kCorrupt for the
// OSError of a length over 132
int iptc_field(const uint8_t* d, size_t n, size_t& pos, std::pair<int, int>& tag, int64_t& size) {
  const size_t k = std::min<size_t>(5, n - pos);
  const uint8_t* s = d + pos;
  pos += k;
  bool blank = true;
  for (size_t i = 0; i < k; ++i) blank &= s[i] == 0;
  if (blank) return 1;
  if (k < 3) return kPassOn;  // IndexError
  tag = {s[1], s[2]};
  static const int kRecords[] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 240};
  if (s[0] != 0x1C ||
      std::find(std::begin(kRecords), std::end(kRecords), tag.first) == std::end(kRecords))
    return kPassOn;  // SyntaxError
  if (k < 4) return kPassOn;
  size = s[3];
  if (size > 132) return kCorrupt;  // OSError: "illegal field length"
  if (size == 128) {
    size = 0;
  } else if (size > 128) {
    const size_t m = std::min<size_t>((size_t)size - 128, n - pos);
    uint32_t v = 0;
    for (size_t i = 0; i < m; ++i) v = v << 8 | d[pos + i];
    pos += m;
    size = v;
  } else {
    if (k < 5) return kPassOn;  // struct.error
    size = s[3] << 8 | s[4];
  }
  return 0;
}

int iptc_open(const uint8_t* d, size_t n, IptcInfo& I) {
  struct Field {
    bool none = true;   // a field of size 0 stores None
    bool list = false;  // a tag seen twice stores a list
    std::string data;
  };
  std::map<std::pair<int, int>, Field> info;
  size_t pos = 0;
  std::pair<int, int> tag;
  while (true) {
    const size_t offset = pos;
    int64_t size = 0;
    const int rc = iptc_field(d, n, pos, tag, size);
    if (rc == 1) break;
    if (rc) return rc;
    if (tag == std::make_pair(8, 10)) {
      I.tile = true;
      I.offset = offset;
      break;
    }
    Field f;
    if (size) {
      const size_t m = std::min<size_t>((size_t)size, n - pos);
      f.none = false;
      f.data.assign((const char*)d + pos, m);
      pos += m;
    }
    auto it = info.find(tag);
    if (it == info.end()) info[tag] = f;
    else it->second.list = true;
  }
  // layers, component = info[3, 60][0], [1]; band = info[3, 65][0] - 1
  auto it = info.find({3, 60});
  if (it == info.end()) return kPassOn;  // KeyError
  const Field& lc = it->second;
  bool l_mode = false;
  if (!lc.list) {
    if (lc.none || lc.data.size() < 2) return kPassOn;  // TypeError, IndexError
    const int layers = (uint8_t)lc.data[0], component = (uint8_t)lc.data[1];
    l_mode = layers == 1 && !component;
    if (l_mode) I.mode = kModeL;
    else if (layers == 3 && component) I.mode = kModeRGB;
    else if (layers == 4 && component) I.mode = kModeCMYK;
  }  // a list of two or more: its items are bytes or None, never 1, 3 or 4
  if (!l_mode) {
    auto b = info.find({3, 65});
    if (b == info.end()) {
      I.band = 0;
    } else {
      if (b->second.list || b->second.none || b->second.data.empty()) return kPassOn;
      I.band = (uint8_t)b->second.data[0] - 1;
    }
  }
  // size = getint(3, 20), getint(3, 30); compression = getint(3, 120)
  auto getint = [&](std::pair<int, int> key, int64_t& v) {
    auto f = info.find(key);
    if (f == info.end()) return 1;                   // KeyError
    if (f->second.list || f->second.none) return 2;  // TypeError
    std::string s = std::string(4, '\0') + f->second.data;
    v = (int64_t)be32((const uint8_t*)s.data() + s.size() - 4);
    return 0;
  };
  if (getint({3, 20}, I.w) || getint({3, 30}, I.h)) return kPassOn;
  const int rc = getint({3, 120}, I.compression);
  if (rc == 2) return kPassOn;
  if (rc == 1 || (I.compression != 1 && I.compression != 5)) return kCorrupt;  // OSError
  if (I.mode == kModeNone || I.w <= 0 || I.h <= 0) return kPassOn;
  if (too_big(I.w, I.h)) return kCorrupt;
  return kOk;
}

int decode_by_signature(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h);
const char* plugin_name_of(const uint8_t* d, size_t n);

// The IPTC plugin's load: its (8, 10) fields from the tile on, joined (after
// a P5 header when raw), opened again through every plugin; in mode L the
// image that opens becomes the image, which convert("L") then copies as it
// is (an image of another mode comes out unconverted: refused), else it is
// one band among zero bands (Image.merge wants mode L of every band but the
// first). The port tells mode L of a one-component JPEG and an 8-bit P2 or
// P5 (the raw data's own header) and refuses the other plugins' images.
int iptc_load(const uint8_t* d, size_t n, const IptcInfo& I, std::vector<uint8_t>& gray, int& w,
              int& h) {
  if (!I.tile) return kCorrupt;  // "cannot load this image"
  std::vector<uint8_t> o;
  if (I.compression == 1) {
    const std::string head = "P5\n" + std::to_string(I.w) + " " + std::to_string(I.h) + "\n255\n";
    o.assign(head.begin(), head.end());
  }
  size_t pos = I.offset;
  while (true) {
    std::pair<int, int> tag;
    int64_t size = 0;
    const int rc = iptc_field(d, n, pos, tag, size);
    if (rc == 1) break;
    if (rc) return kCorrupt;  // raised while loading
    if (tag != std::make_pair(8, 10)) break;
    const size_t m = std::min<size_t>((size_t)size, n - pos);
    o.insert(o.end(), d + pos, d + pos + m);
    pos += m;
  }
  const int rc = decode_by_signature(o.data(), o.size(), gray, w, h);
  if (rc) return rc;
  const std::string name = plugin_name_of(o.data(), o.size());
  int l_image = -1;  // 1: mode L, 0: another mode, -1: a plugin whose mode the port does not tell
  if (name == "JPEG") {
    int jw, jh, nc = 0;
    l_image = !jpeg_frame_info(o.data(), o.size(), jw, jh, nc) && nc == 1;
  } else if (name == "PPM") {
    PnmHeader hd;
    l_image = !pnm_header(o.data(), o.size(), hd) && (hd.kind == 2 || hd.kind == 5) &&
              hd.maxval < 256;
  }
  if (I.band == -2) return l_image == 1 ? kOk : kIptc;
  const int bands = I.mode == kModeCMYK ? 4 : 3;
  const int band = I.band == -1 ? bands - 1 : I.band;
  if (band >= bands) return kCorrupt;  // bands[band]: IndexError
  if (l_image == 0 && band != 0) return kCorrupt;  // Image.merge: "mode mismatch"
  if (l_image != 1) return kIptc;
  for (uint8_t& g : gray) {
    int v[4] = {0, 0, 0, 0};
    v[band] = g;
    g = bands == 4 ? pil_cmyk_luma(v[0], v[1], v[2], v[3]) : pil_luma(v[0], v[1], v[2]);
  }
  return kOk;
}

int decode_iptc(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  IptcInfo I;
  const int rc = iptc_open(d, n, I);
  return rc ? rc : iptc_load(d, n, I, gray, w, h);
}

// the size of the image the load gives (the opened data's, not the header's)
int probe_iptc(const uint8_t* d, size_t n, int& w, int& h) {
  std::vector<uint8_t> gray;
  return decode_iptc(d, n, gray, w, h);
}

// =============================================================== SPIDER
struct SpiderInfo {
  int64_t w = 0, h = 0, offset = 0;
  bool big = true;
};

int spider_open(const uint8_t* d, size_t n, SpiderInfo& S) {
  if (n < 27 * 4) return kPassOn;  // struct.error
  double t[28];
  auto header = [&](bool big) -> double {  // isSpiderHeader: labbyt, or 0
    for (int i = 0; i < 27; ++i) {
      uint32_t u = big ? be32(d + 4 * i) : le32(d + 4 * i);
      float f;
      std::memcpy(&f, &u, 4);
      t[i + 1] = f;
    }
    for (int i : {1, 2, 5, 12, 13, 22, 23})
      if (!std::isfinite(t[i]) || t[i] != std::trunc(t[i])) return 0;
    const double iform = t[5];
    if (iform != 1 && iform != 3 && iform != -11 && iform != -12 && iform != -21 &&
        iform != -22)
      return 0;
    // labbyt == labrec * lenbyt: float32 integers, so the double product is exact
    return t[22] == t[13] * t[23] ? t[22] : 0;
  };
  double hdrlen = header(true);
  S.big = true;
  if (hdrlen == 0) {
    hdrlen = header(false);
    S.big = false;
  }
  if (hdrlen == 0) return kPassOn;
  if (t[5] != 1) return kPassOn;  // "not a Spider 2D image"
  // int(h[24]), int(h[27]): ValueError or OverflowError end the open
  if (!std::isfinite(t[24]) || !std::isfinite(t[27])) return kCorrupt;
  const double istack = std::trunc(t[24]), img = std::trunc(t[27]);
  if (istack == 0 && img > 0) return kCorrupt;  // self.stkoffset: AttributeError
  if (istack == 0 && img == 0) {
    S.offset = (int64_t)hdrlen;
  } else if (istack > 0 && img == 0) {
    if (!std::isfinite(t[26])) return kCorrupt;  // int(h[26])
    S.offset = (int64_t)hdrlen * 2;
  } else {
    return kPassOn;  // "inconsistent stack header values"
  }
  S.w = (int64_t)t[12];
  S.h = (int64_t)t[2];
  if (S.w <= 0 || S.h <= 0) return kPassOn;
  if (too_big(S.w, S.h)) return kCorrupt;
  return kOk;
}

int probe_spider(const uint8_t* d, size_t n, int& w, int& h) {
  SpiderInfo S;
  const int rc = spider_open(d, n, S);
  w = (int)S.w;
  h = (int)S.h;
  return rc;
}

int decode_spider(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  SpiderInfo S;
  int rc = spider_open(d, n, S);
  if (rc) return rc;
  w = (int)S.w;
  h = (int)S.h;
  PilImage im;
  im.alloc(kModeF, w, h);
  rc = raw_tile(d, n, S.offset, im, *find_unpacker(kModeF, S.big ? "F;32BF" : "F;32F"), 0, 1,
                false);
  return rc ? rc : pil_to_gray(im, gray);
}

// ================================================================== GBR
struct GbrInfo {
  int64_t w = 0, h = 0;
  int depth = 1;
  size_t data = 0;
};

int gbr_open(const uint8_t* d, size_t n, GbrInfo& g) {
  if (n < 20) return kPassOn;  // i32 of a short read: struct.error
  const uint32_t hs = be32(d), version = be32(d + 4);
  g.w = be32(d + 8);
  g.h = be32(d + 12);
  g.depth = (int)std::min<uint32_t>(be32(d + 16), 255);
  if (hs < 20 || (version != 1 && version != 2) || g.w == 0 || g.h == 0 ||
      (g.depth != 1 && g.depth != 4))
    return kPassOn;
  size_t pos = 20;
  int64_t comment = (int64_t)hs - 20;
  if (version == 2) {
    if (n < 28 || std::memcmp(d + 20, "GIMP", 4)) return kPassOn;
    pos = 28;
    comment = (int64_t)hs - 28;
  }
  // read(comment): a negative length reads to the end
  g.data = comment < 0 ? n : (size_t)std::min<int64_t>((int64_t)n, (int64_t)pos + comment);
  if (too_big(g.w, g.h)) return kCorrupt;  // _decompression_bomb_check in the open
  return kOk;
}

int probe_gbr(const uint8_t* d, size_t n, int& w, int& h) {
  GbrInfo g;
  const int rc = gbr_open(d, n, g);
  w = (int)g.w;
  h = (int)g.h;
  return rc;
}

int decode_gbr(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  GbrInfo g;
  const int rc = gbr_open(d, n, g);
  if (rc) return rc;
  w = (int)g.w;
  h = (int)g.h;
  const size_t npx = (size_t)w * h;
  if (n - g.data < npx * g.depth) return kCorrupt;  // frombytes: "not enough image data"
  const uint8_t* p = d + g.data;
  gray.resize(npx);
  for (size_t i = 0; i < npx; ++i)
    gray[i] = g.depth == 1 ? p[i] : pil_luma(p[4 * i], p[4 * i + 1], p[4 * i + 2]);
  return kOk;
}

// =============================================================== McIDAS
struct McidasInfo {
  int64_t w = 0, h = 0, offset = 0, stride = 0;
  int bytes = 1;
};

int mcidas_open(const uint8_t* d, size_t n, McidasInfo& m) {
  if (n < 256) return kPassOn;  // "not an McIdas area file"
  auto word = [&](int i) { return (int64_t)(int32_t)be32(d + 4 * (i - 1)); };  // w[1..64]
  m.bytes = (int)word(11);
  if (m.bytes != 1 && m.bytes != 2 && m.bytes != 4) return kPassOn;  // "unsupported McIdas format"
  m.w = word(10);
  m.h = word(9);
  m.offset = word(34) + word(15);
  m.stride = word(15) + word(10) * word(11) * word(14);
  if (m.w <= 0 || m.h <= 0) return kPassOn;
  if (too_big(m.w, m.h)) return kCorrupt;
  return kOk;
}

int probe_mcidas(const uint8_t* d, size_t n, int& w, int& h) {
  McidasInfo m;
  const int rc = mcidas_open(d, n, m);
  w = (int)m.w;
  h = (int)m.h;
  return rc;
}

int decode_mcidas(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  McidasInfo m;
  int rc = mcidas_open(d, n, m);
  if (rc) return rc;
  w = (int)m.w;
  h = (int)m.h;
  const PilMode mode = m.bytes == 1 ? kModeL : m.bytes == 2 ? kModeI16B : kModeI;
  PilImage im;
  im.alloc(mode, w, h);
  const UnpackerDef& u =
      *find_unpacker(mode, m.bytes == 1 ? "L" : m.bytes == 2 ? "I;16B" : "I;32BS");
  rc = raw_tile(d, n, m.offset, im, u, m.stride, 1, m.bytes != 4);
  return rc ? rc : pil_to_gray(im, gray);
}

// ================================================================ PIXAR
int pixar_open(const uint8_t* d, size_t n, int& w, int& h) {
  if (n < 428) return kPassOn;  // i16 of a short read: struct.error
  w = d[418] | d[419] << 8;
  h = d[416] | d[417] << 8;
  const int channels = d[424] | d[425] << 8, depth = d[426] | d[427] << 8;
  if (channels != 14 || depth != 2 || !w || !h) return kPassOn;  // no mode
  if (too_big(w, h)) return kCorrupt;
  return kOk;
}

int probe_pixar(const uint8_t* d, size_t n, int& w, int& h) { return pixar_open(d, n, w, h); }

int decode_pixar(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  int rc = pixar_open(d, n, w, h);
  if (rc) return rc;
  PilImage im;
  im.alloc(kModeRGB, w, h);
  rc = raw_tile(d, n, 1024, im, *find_unpacker(kModeRGB, "RGB"), 0, 1, false);
  return rc ? rc : pil_to_gray(im, gray);
}

// ============================================================== XVThumb
int xvthumb_open(const uint8_t* d, size_t n, int64_t& w, int64_t& h, size_t& data) {
  size_t pos = std::min<size_t>(n, 6);
  py_readline(d, n, pos);
  std::string s;
  while (true) {
    s = py_readline(d, n, pos);
    if (s.empty()) return kPassOn;  // "Unexpected EOF reading XV thumbnail file"
    if (s[0] != '#') break;
  }
  const std::vector<std::string> tok = py_split(py_strip(s));
  if (tok.size() < 2) return kCorrupt;  // w, h = ...: ValueError
  if (!py_int_sat(tok[0], w) || !py_int_sat(tok[1], h)) return kCorrupt;
  data = pos;
  if (w <= 0 || h <= 0) return kPassOn;
  if (too_big(w, h)) return kCorrupt;
  return kOk;
}

int probe_xvthumb(const uint8_t* d, size_t n, int& w, int& h) {
  int64_t W = 0, H = 0;
  size_t data;
  const int rc = xvthumb_open(d, n, W, H, data);
  w = (int)W;
  h = (int)H;
  return rc;
}

int decode_xvthumb(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  int64_t W, H;
  size_t data;
  int rc = xvthumb_open(d, n, W, H, data);
  if (rc) return rc;
  w = (int)W;
  h = (int)H;
  PilImage im;
  im.alloc(kModeP, w, h);
  for (int r = 0, i = 0; r < 8; ++r)  // the plugin's 3-3-2 PALETTE
    for (int g = 0; g < 8; ++g)
      for (int b = 0; b < 4; ++b, ++i) {
        im.pal[3 * i] = (uint8_t)(r * 255 / 7);
        im.pal[3 * i + 1] = (uint8_t)(g * 255 / 7);
        im.pal[3 * i + 2] = (uint8_t)(b * 255 / 3);
      }
  im.pal_n = 256;
  rc = raw_tile(d, n, (int64_t)data, im, *find_unpacker(kModeP, "P"), 0, 1, true);
  return rc ? rc : pil_to_gray(im, gray);
}

// ================================================================= FITS
// gzip.decompress: members one after another, zero bytes between them
// stripped; false where it raises
bool gzip_decompress(const uint8_t* d, size_t n, std::vector<uint8_t>& out) {
  out.clear();
  size_t pos = 0;
  while (true) {
    if (pos >= n) return true;
    if (n - pos < 2 || d[pos] != 0x1f || d[pos + 1] != 0x8b) return false;  // "Not a gzipped file"
    if (n - pos < 10 || d[pos + 2] != 8) return false;  // _read_exact, "Unknown compression method"
    const int flag = d[pos + 3];
    size_t p = pos + 10;
    if (flag & 4) {  // FEXTRA
      if (n - p < 2) return false;
      const size_t len = d[p] | d[p + 1] << 8;
      p += 2;
      if (n - p < len) return false;
      p += len;
    }
    for (int f : {8, 16}) {  // FNAME, FCOMMENT: to a zero byte or the end
      if (!(flag & f)) continue;
      while (p < n && d[p] != 0) ++p;
      if (p < n) ++p;
    }
    if (flag & 2) {  // FHCRC
      if (n - p < 2) return false;
      p += 2;
    }
    std::vector<uint8_t> member;
    size_t used;
    if (raw_inflate(d + p, n - p, member, used) != kOk) return false;
    p += used;
    if (n - p < 8) return false;  // "Compressed file ended before the end-of-stream marker"
    if (le32(d + p) != crc32(member.data(), member.size()) ||
        le32(d + p + 4) != (uint32_t)member.size())
      return false;
    out.insert(out.end(), member.begin(), member.end());
    pos = p + 8;
    while (pos < n && d[pos] == 0) ++pos;
  }
}

struct FitsInfo {
  int64_t w = 0, h = 0;
  int bits = 0;
  bool gzip = false;
  PilMode mode = kModeNone;
  int64_t offset = 0;
};

// FitsImageFile._parse_headers: 0, kPassOn (KeyError), kCorrupt (ValueError
// of int()), or 1 where the headers hold no image (NAXIS 0)
int fits_parse(const std::map<std::string, std::string>& hd, FitsInfo& F) {
  auto get_int = [&](const std::string& k, int64_t& v) -> int {
    auto it = hd.find(k);
    if (it == hd.end()) return kPassOn;
    return py_int_sat(it->second, v) ? kOk : kCorrupt;
  };
  auto size_of = [&](const std::string& p, int64_t& w, int64_t& h) -> int {
    int64_t naxis;
    int rc = get_int(p + "NAXIS", naxis);
    if (rc) return rc;
    if (naxis == 0) return 1;
    if (naxis == 1) {
      w = 1;
      return get_int(p + "NAXIS1", h);
    }
    if ((rc = get_int(p + "NAXIS1", w))) return rc;
    return get_int(p + "NAXIS2", h);
  };
  std::string prefix;
  int64_t offset = 0;
  bool gz = false;
  auto x = hd.find("XTENSION"), z = hd.find("ZIMAGE");
  if (x != hd.end() && x->second == "'BINTABLE'" && z != hd.end() && z->second == "T") {
    auto c = hd.find("ZCMPTYPE");
    if (c == hd.end()) return kPassOn;
    if (c->second == "'GZIP_1  '") {
      int64_t w0 = 0, h0 = 0, bits;
      const int rc = size_of("", w0, h0);
      if (rc == 1) w0 = h0 = 0;
      else if (rc) return rc;
      const int rc2 = get_int("BITPIX", bits);
      if (rc2) return rc2;
      const int64_t b8 = bits >= 0 ? bits / 8 : -((-bits + 7) / 8);  // floor division
      offset = w0 * h0 * b8;
      prefix = "Z";
      gz = true;
    }
  }
  int64_t w = 0, h = 0;
  int rc = size_of(prefix, w, h);
  if (rc) return rc;
  int64_t bits;
  if ((rc = get_int(prefix + "BITPIX", bits))) return rc;
  F.w = w;
  F.h = h;
  F.gzip = gz;
  F.offset = offset;
  F.bits = (int)std::max<int64_t>(-1000, std::min<int64_t>(1000, bits));
  F.mode = bits == 8 ? kModeL : bits == 16 ? kModeI16 : bits == 32 ? kModeI
           : (bits == -32 || bits == -64) ? kModeF : kModeNone;
  return kOk;
}

int fits_open(const uint8_t* d, size_t n, FitsInfo& F) {
  std::map<std::string, std::string> headers;
  bool in_progress = false, found = false;
  size_t pos = 0;
  while (true) {
    if (pos >= n) return kCorrupt;  // "Truncated FITS file"
    const std::string header((const char*)d + pos, std::min<size_t>(80, n - pos));
    pos += header.size();
    const std::string keyword = py_strip(header.substr(0, 8));
    if (keyword == "SIMPLE" || keyword == "XTENSION") {
      in_progress = true;
    } else if (!headers.empty() && !in_progress) {
      break;
    } else if (keyword == "END") {
      pos = (pos + 2879) / 2880 * 2880;
      if (!found) {
        const int rc = fits_parse(headers, F);
        if (rc == kOk) found = true;
        else if (rc != 1) return rc;
      }
      in_progress = false;
      continue;
    }
    if (found) continue;
    std::string value = header.size() > 8 ? header.substr(8) : std::string();
    value = py_strip(value.substr(0, value.find('/')));
    if (!value.empty() && value[0] == '=') value = py_strip(value.substr(1));
    if (headers.empty() && (keyword.compare(0, 6, "SIMPLE") || value != "T"))
      return kPassOn;  // "Not a FITS file"
    headers[keyword] = value;
  }
  if (!found) return kCorrupt;  // "No image data"
  F.offset += (int64_t)pos - 80;
  if (F.mode == kModeNone || F.w <= 0 || F.h <= 0) return kPassOn;
  if (too_big(F.w, F.h)) return kCorrupt;
  return kOk;
}

int probe_fits(const uint8_t* d, size_t n, int& w, int& h) {
  FitsInfo F;
  const int rc = fits_open(d, n, F);
  w = (int)F.w;
  h = (int)F.h;
  return rc;
}

int decode_fits(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  FitsInfo F;
  int rc = fits_open(d, n, F);
  if (rc) return rc;
  w = (int)F.w;
  h = (int)F.h;
  PilImage im;
  im.alloc(F.mode, w, h);
  const char* raw = F.mode == kModeL     ? "L"
                    : F.mode == kModeI16 ? "I;16"
                    : F.mode == kModeI   ? "I"
                                         : "F";
  const UnpackerDef& u = *find_unpacker(F.mode, raw);
  if (!F.gzip) {  // the mode as the raw mode, bottom-up
    rc = raw_tile(d, n, F.offset, im, u, 0, -1, pil_maps(F.mode));
    return rc ? rc : pil_to_gray(im, gray);
  }
  // FitsGzipDecoder: the low min(BITPIX // 8, 4) bytes of each 4-byte word,
  // rows reversed (a float BITPIX takes nothing)
  if (F.offset < 0 || (uint64_t)F.offset > n) return kCorrupt;
  std::vector<uint8_t> value;
  if (!gzip_decompress(d + F.offset, n - (size_t)F.offset, value)) return kCorrupt;
  const size_t npx = (size_t)w * h;
  const int nb = F.bits >= 0 ? std::min(F.bits / 8, 4) : 0;
  if (nb <= 0 || value.size() < 4 * npx) return kCorrupt;  // "not enough image data"
  std::vector<uint8_t> row((size_t)w * nb);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x)
      std::memcpy(&row[(size_t)x * nb], &value[4 * ((size_t)y * w + x) + 4 - nb], nb);
    unpack(u.op, im.at(0, h - 1 - y), row.data(), w);
  }
  return pil_to_gray(im, gray);
}
