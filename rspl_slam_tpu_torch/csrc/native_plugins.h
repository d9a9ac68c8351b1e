// How PIL 12.1's Image.open identifies a file, for the table of plugins in
// native_runtime.cpp: each plugin's accept test on the first 16 bytes (the
// prefix Image.open reads), and, for the plugins PIL registers without one
// that come before TGA in Image.ID (IM, IMT, IPTC, PCD, SPIDER), their open
// checks as far as the error that passes the file on to the next plugin;
// so too for GBR and WMF, whose accept tests take QOI, DIB and TGA files.
// A plugin passes a file on when its open raises SyntaxError, IndexError,
// TypeError, KeyError, EOFError or struct.error; any other error ends the
// open. The port reads none of these plugins, so a file one of them would
// take is refused naming it; the checks say only whether it would take it.
//
// Included by native_runtime.cpp inside its anonymous namespace.

inline bool starts_with(const uint8_t* p, size_t k, const char* sig, size_t m) {
  return k >= m && !std::memcmp(p, sig, m);
}

// ------------------------------------------------------- accept tests
// p: the prefix, k = min(16, file size) bytes
bool accept_bmp(const uint8_t* p, size_t k) { return starts_with(p, k, "BM", 2); }
bool accept_dib(const uint8_t* p, size_t k) {
  if (k < 4) return false;
  const uint32_t v = le32(p);
  return v == 12 || v == 40 || v == 52 || v == 56 || v == 64 || v == 108 || v == 124;
}
bool accept_gif(const uint8_t* p, size_t k) {
  return starts_with(p, k, "GIF87a", 6) || starts_with(p, k, "GIF89a", 6);
}
bool accept_jpeg(const uint8_t* p, size_t k) { return starts_with(p, k, "\xff\xd8\xff", 3); }
bool accept_ppm(const uint8_t* p, size_t k) {
  return k >= 2 && p[0] == 'P' && p[1] && std::strchr("0123456fy", p[1]);
}
bool accept_png(const uint8_t* p, size_t k) {
  return starts_with(p, k, "\x89PNG\r\n\x1a\n", 8);
}
bool accept_avif(const uint8_t* p, size_t k) {
  if (k < 12 || std::memcmp(p + 4, "ftyp", 4)) return false;
  const uint8_t* b = p + 8;
  return !std::memcmp(b, "avif", 4) || !std::memcmp(b, "avis", 4) ||
         !std::memcmp(b, "mif1", 4) || !std::memcmp(b, "msf1", 4);
}
bool accept_blp(const uint8_t* p, size_t k) {
  return starts_with(p, k, "BLP1", 4) || starts_with(p, k, "BLP2", 4);
}
bool accept_bufr(const uint8_t* p, size_t k) {
  return starts_with(p, k, "BUFR", 4) || starts_with(p, k, "ZCZC", 4);
}
bool accept_cur(const uint8_t* p, size_t k) { return starts_with(p, k, "\0\0\2\0", 4); }
bool accept_pcx(const uint8_t* p, size_t k) {
  return k >= 2 && p[0] == 10 && (p[1] == 0 || p[1] == 2 || p[1] == 3 || p[1] == 5);
}
bool accept_dcx(const uint8_t* p, size_t k) { return k >= 4 && le32(p) == 0x3ADE68B1u; }
bool accept_dds(const uint8_t* p, size_t k) { return starts_with(p, k, "DDS ", 4); }
bool accept_eps(const uint8_t* p, size_t k) {
  return starts_with(p, k, "%!PS", 4) || (k >= 4 && le32(p) == 0xC6D3D0C5u);
}
bool accept_fits(const uint8_t* p, size_t k) { return starts_with(p, k, "SIMPLE", 6); }
bool accept_fli(const uint8_t* p, size_t k) {
  if (k < 16) return false;
  const int magic = p[4] | p[5] << 8, flags = p[14] | p[15] << 8;
  return (magic == 0xAF11 || magic == 0xAF12) && (flags == 0 || flags == 3);
}
bool accept_ftex(const uint8_t* p, size_t k) { return starts_with(p, k, "FTEX", 4); }
bool accept_gbr(const uint8_t* p, size_t k) {
  return k >= 8 && be32(p) >= 20 && (be32(p + 4) == 1 || be32(p + 4) == 2);
}
bool accept_grib(const uint8_t* p, size_t k) {
  return k >= 8 && starts_with(p, k, "GRIB", 4) && p[7] == 1;
}
bool accept_hdf5(const uint8_t* p, size_t k) {
  return starts_with(p, k, "\x89HDF\r\n\x1a\n", 8);
}
bool accept_jpeg2000(const uint8_t* p, size_t k) {
  return starts_with(p, k, "\xff\x4f\xff\x51", 4) ||
         starts_with(p, k, "\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a", 12);
}
bool accept_icns(const uint8_t* p, size_t k) { return starts_with(p, k, "icns", 4); }
bool accept_ico(const uint8_t* p, size_t k) { return starts_with(p, k, "\0\0\1\0", 4); }
bool accept_mcidas(const uint8_t* p, size_t k) {
  return starts_with(p, k, "\0\0\0\0\0\0\0\4", 8);
}
bool accept_mpeg(const uint8_t* p, size_t k) { return starts_with(p, k, "\0\0\1\xb3", 4); }
bool accept_tiff(const uint8_t* p, size_t k) {
  static const char* prefixes[6] = {"MM\x00\x2a", "II\x2a\x00", "MM\x2a\x00",
                                    "II\x00\x2a", "MM\x00\x2b", "II\x2b\x00"};
  for (const char* s : prefixes)
    if (starts_with(p, k, s, 4)) return true;
  return false;
}
bool accept_msp(const uint8_t* p, size_t k) {
  return starts_with(p, k, "DanM", 4) || starts_with(p, k, "LinS", 4);
}
bool accept_pixar(const uint8_t* p, size_t k) { return starts_with(p, k, "\x80\xe8\0\0", 4); }
bool accept_psd(const uint8_t* p, size_t k) { return starts_with(p, k, "8BPS", 4); }
bool accept_qoi(const uint8_t* p, size_t k) { return starts_with(p, k, "qoif", 4); }
bool accept_sgi(const uint8_t* p, size_t k) { return k >= 2 && (p[0] << 8 | p[1]) == 474; }
bool accept_sun(const uint8_t* p, size_t k) { return k >= 4 && be32(p) == 0x59A66A95u; }
bool accept_webp(const uint8_t* p, size_t k) {
  return k >= 16 && !std::memcmp(p, "RIFF", 4) && !std::memcmp(p + 8, "WEBP", 4) &&
         (!std::memcmp(p + 12, "VP8 ", 4) || !std::memcmp(p + 12, "VP8L", 4) ||
          !std::memcmp(p + 12, "VP8X", 4));
}
bool accept_wmf(const uint8_t* p, size_t k) {
  return starts_with(p, k, "\xd7\xcd\xc6\x9a\x00\x00", 6) ||
         starts_with(p, k, "\x01\x00\x00\x00", 4);
}
inline bool py_space(int c) { return c == ' ' || (c >= '\t' && c <= '\r'); }
bool accept_xbm(const uint8_t* p, size_t k) {  // prefix.lstrip().startswith(b"#define")
  size_t i = 0;
  while (i < k && py_space(p[i])) ++i;
  return starts_with(p + i, k - i, "#define", 7);
}
bool accept_xpm(const uint8_t* p, size_t k) { return starts_with(p, k, "/* XPM */", 9); }
bool accept_xvthumb(const uint8_t* p, size_t k) { return starts_with(p, k, "P7 332", 6); }

// ------------------------------------- Python's int() and float() of text
// int(s) of bytes or latin-1 text: surrounding whitespace, a sign, ASCII
// digits with single underscores between them; false where it raises
bool py_int_text(const std::string& s, double& v) {
  size_t a = 0, b = s.size();
  while (a < b && py_space((uint8_t)s[a])) ++a;
  while (b > a && py_space((uint8_t)s[b - 1])) --b;
  if (a < b && (s[a] == '+' || s[a] == '-')) ++a;
  if (a >= b || !std::isdigit((uint8_t)s[a]) || !std::isdigit((uint8_t)s[b - 1])) return false;
  double x = 0;
  for (size_t i = a; i < b; ++i) {
    if (s[i] == '_') {
      if (!std::isdigit((uint8_t)s[i + 1])) return false;
      continue;
    }
    if (!std::isdigit((uint8_t)s[i])) return false;
    x = x * 10 + (s[i] - '0');
  }
  size_t first = 0;
  while (first < s.size() && py_space((uint8_t)s[first])) ++first;
  v = s[first] == '-' ? -x : x;
  return true;
}

// float(s): whitespace, a sign, digits (underscores between them), a point,
// an exponent, or inf / infinity / nan in any case; false where it raises
bool py_float_text(const std::string& s, double& v) {
  size_t a = 0, b = s.size();
  while (a < b && py_space((uint8_t)s[a])) ++a;
  while (b > a && py_space((uint8_t)s[b - 1])) --b;
  std::string t = s.substr(a, b - a);
  std::string low;
  for (char c : t) low += (char)std::tolower((uint8_t)c);
  size_t i = 0;
  if (i < low.size() && (low[i] == '+' || low[i] == '-')) ++i;
  const std::string body = low.substr(i);
  if (body == "inf" || body == "infinity" || body == "nan") {
    v = body == "nan" ? NAN : (low[0] == '-' ? -INFINITY : INFINITY);
    return true;
  }
  // [sign] (digits [. [digits]] | . digits) [e [sign] digits], where digits
  // are ASCII digits with single underscores between them
  std::string clean;
  size_t j = 0;
  auto digits = [&]() {
    const size_t start = j;
    while (j < low.size() && std::isdigit((uint8_t)low[j])) {
      clean += low[j++];
      if (j + 1 < low.size() && low[j] == '_' && std::isdigit((uint8_t)low[j + 1])) ++j;
    }
    return j > start;
  };
  if (j < low.size() && (low[j] == '+' || low[j] == '-')) clean += low[j++];
  bool mantissa = digits();
  if (j < low.size() && low[j] == '.') {
    clean += low[j++];
    mantissa |= digits();
  }
  if (!mantissa) return false;
  if (j < low.size() && low[j] == 'e') {
    clean += low[j++];
    if (j < low.size() && (low[j] == '+' || low[j] == '-')) clean += low[j++];
    if (!digits()) return false;
  }
  if (j != low.size()) return false;
  v = std::strtod(clean.c_str(), nullptr);
  return true;
}

// ---------------------- the open checks of plugins with weak accept tests
// GbrImagePlugin._open: the accept takes any file whose first two big-endian
// words are at least 20 and 1 or 2, which QOI, DIB and other files can be
bool gbr_takes(const uint8_t* d, size_t n) {
  if (n < 20) return false;  // i32 of a short read: struct.error
  const uint32_t hs = be32(d), version = be32(d + 4), w = be32(d + 8),
                 h = be32(d + 12), depth = be32(d + 16);
  if (hs < 20 || (version != 1 && version != 2) || w == 0 || h == 0 || (depth != 1 && depth != 4))
    return false;
  if (version == 2 && (n < 28 || std::memcmp(d + 20, "GIMP", 4))) return false;
  return true;
}

// WmfImagePlugin._open: a placeable metafile whose standard header follows
// its own, or an enhanced metafile (" EMF" at 40), of a positive size; the
// accept's 01 00 00 00 also starts TGA, DIB-like and other files
bool wmf_takes(const uint8_t* d, size_t n) {
  auto s16 = [&](size_t o) { return (int)(int16_t)(d[o] | d[o + 1] << 8); };
  auto s32 = [&](size_t o) { return (int64_t)(int32_t)le32(d + o); };
  if (n >= 6 && !std::memcmp(d, "\xd7\xcd\xc6\x9a\x00\x00", 6)) {
    if (n < 16) return false;  // struct.error
    const int inch = d[14] | d[15] << 8;
    if (inch == 0) return true;  // ValueError: "Invalid inch"
    if (n < 26 || std::memcmp(d + 22, "\x01\x00\t\x00", 4)) return false;
    auto floordiv = [](int64_t a, int64_t b) { return a / b - ((a % b) && ((a < 0) != (b < 0))); };
    return floordiv((int64_t)(s16(10) - s16(6)) * 72, inch) > 0 &&
           floordiv((int64_t)(s16(12) - s16(8)) * 72, inch) > 0;
  }
  if (n >= 44 && !std::memcmp(d, "\x01\x00\x00\x00", 4) && !std::memcmp(d + 40, " EMF", 4)) {
    if (s32(32) == s32(24) || s32(36) == s32(28)) return true;  // ZeroDivisionError
    return s32(16) - s32(8) > 0 && s32(20) - s32(12) > 0;
  }
  return false;  // "Unsupported file format"
}

// ------------------------------------------- IM (ImImagePlugin._open)
// true where IM takes the file: it reads it, or its open ends with an error
// that does not pass the file on (a number it cannot parse)
bool im_takes(const uint8_t* d, size_t n) {
  if (!std::memchr(d, '\n', std::min<size_t>(n, 100))) return false;
  size_t pos = 0;
  int tags = 0;
  bool mode = true;  // "L", or OPEN's mode for the value, or the value itself
  std::vector<double> size = {512, 512};
  bool lut = false;
  int last = -1;  // the byte that ended the header: -1 for the end of the file
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
    if (s.size() > 100) return false;
    if (s.size() >= 2 && !s.compare(s.size() - 2, 2, "\r\n")) s.resize(s.size() - 2);
    else if (!s.empty() && s.back() == '\n') s.pop_back();
    // split = ^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$
    const size_t colon = s.find(':');
    if (s.empty() || !std::isalpha((uint8_t)s[0]) || (uint8_t)s[0] > 127 ||
        colon == std::string::npos)
      return false;
    size_t vs = colon + 1;
    while (vs < s.size() && (s[vs] == ' ' || s[vs] == '\t')) ++vs;
    const std::string k = s.substr(0, colon), v = s.substr(vs);
    if (v.find('\n') != std::string::npos) return false;
    if (k == "File size (no of images)" || k == "Scale (x,y)" || k == "Image size (x*y)") {
      std::string t = v;
      for (char& ch : t)
        if (ch == '*') ch = ',';
      std::vector<double> nums;
      size_t a = 0;
      while (true) {
        const size_t b = t.find(',', a);
        const std::string part = t.substr(a, b == std::string::npos ? std::string::npos : b - a);
        double x;
        if (!py_int_text(part, x) && !py_float_text(part, x)) return true;  // ValueError
        nums.push_back(x);
        if (b == std::string::npos) break;
        a = b + 1;
      }
      if (k == "Image size (x*y)") size = nums;
    } else if (k == "Image type") {
      mode = !v.empty();
    }
    if (k == "Lut") lut = true;
    if (k == "Comment" || k == "Date" || k == "Digitalization equipment" ||
        k == "File size (no of images)" || k == "Lut" || k == "Name" || k == "Scale (x,y)" ||
        k == "Image size (x*y)" || k == "Image type")
      ++tags;
  }
  if (!tags) return false;
  if (last < 0) return false;  // "File truncated"
  if (last == 0) {
    while (pos < n && d[pos] != 0x1a) ++pos;
    if (pos >= n) return false;
    ++pos;
  }
  if (lut) {  // palette[i] == palette[i + 256] == palette[i + 512] over 768 bytes read
    const size_t len = std::min<size_t>(768, n - pos);
    const uint8_t* p = d + pos;
    for (size_t i = 0; i < 256; ++i) {
      if (len <= i + 256) return false;  // IndexError
      if (p[i] == p[i + 256] && len <= i + 512) return false;
    }
  }
  if (size.size() < 2) return false;  // a number, not a size: TypeError
  return mode && !(size[0] <= 0) && !(size[1] <= 0);
}

// ----------------------------------------- IMT (ImtImagePlugin._open)
bool imt_takes(const uint8_t* d, size_t n) {
  size_t pos = std::min<size_t>(n, 100);
  std::string buffer((const char*)d, pos);
  if (buffer.find('\n') == std::string::npos) return false;
  auto read = [&](size_t k) {
    const size_t m = std::min(k, n - pos);
    std::string r((const char*)d + pos, m);
    pos += m;
    return r;
  };
  int64_t xsize = 0, ysize = 0, w = 0, h = 0;
  bool mode = false;
  auto py_int = [](const std::string& v, int64_t& out) {
    double x;
    if (!py_int_text(v, x)) return false;
    out = x > 9e18 ? INT64_MAX : x < -9e18 ? INT64_MIN : (int64_t)x;
    return true;
  };
  while (true) {
    std::string s;
    if (!buffer.empty()) {
      s = buffer.substr(0, 1);
      buffer.erase(0, 1);
    } else {
      s = read(1);
    }
    if (s.empty()) break;
    if (s[0] == '\x0c') break;
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
      if (!py_int(v, xsize)) return true;  // int(v): ValueError ends the open
      w = xsize;
      h = ysize;
    } else if (k == "height") {
      if (!py_int(v, ysize)) return true;
      w = xsize;
      h = ysize;
    } else if (k == "pixel" && v == "n8") {
      mode = true;
    }
  }
  return mode && w > 0 && h > 0;
}

// --------------------------------------- IPTC (IptcImagePlugin._open)
bool iptc_takes(const uint8_t* d, size_t n) {
  struct Field {
    bool none = true;     // a field of size 0 stores None
    bool list = false;    // a tag seen twice stores a list
    std::string data;
  };
  std::map<std::pair<int, int>, Field> info;
  size_t pos = 0;
  std::pair<int, int> tag;
  while (true) {
    const size_t k = std::min<size_t>(5, n - pos);
    const uint8_t* s = d + pos;
    pos += k;
    bool blank = true;
    for (size_t i = 0; i < k; ++i) blank &= s[i] == 0;
    if (blank) break;  // no tag
    if (k < 3) return false;  // IndexError
    tag = {s[1], s[2]};
    static const int kRecords[] = {1, 2, 3, 4, 5, 6, 7, 8, 9, 240};
    if (s[0] != 0x1C || std::find(std::begin(kRecords), std::end(kRecords), tag.first) ==
                            std::end(kRecords))
      return false;  // SyntaxError
    if (k < 4) return false;
    int64_t size = s[3];
    if (size > 132) return true;  // OSError: "illegal field length"
    if (size == 128) {
      size = 0;
    } else if (size > 128) {
      const size_t m = std::min<size_t>((size_t)size - 128, n - pos);
      uint64_t v = 0;
      for (size_t i = 0; i < m; ++i) v = v << 8 | d[pos + i];
      pos += m;
      size = (int64_t)(uint32_t)v;
    } else {
      if (k < 5) return false;  // struct.error
      size = s[3] << 8 | s[4];
    }
    if (tag == std::make_pair(8, 10)) break;
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
  if (it == info.end()) return false;  // KeyError
  const Field& lc = it->second;
  bool mode = false;
  if (lc.list) {  // a list of two or more: its items are bytes or None, never 1, 3 or 4
  } else {
    if (lc.none || lc.data.size() < 2) return false;  // TypeError, IndexError
    const int layers = (uint8_t)lc.data[0], component = (uint8_t)lc.data[1];
    mode = (layers == 1 && !component) || (layers == 3 && component) ||
           (layers == 4 && component);
    if (!(layers == 1 && !component)) {
      auto b = info.find({3, 65});
      if (b != info.end() && (b->second.list || b->second.none)) return false;  // TypeError
    }
  }
  if (lc.list) {
    auto b = info.find({3, 65});
    if (b != info.end() && (b->second.list || b->second.none)) return false;
  }
  // size = getint(3, 20), getint(3, 30); compression = getint(3, 120)
  auto getint = [&](std::pair<int, int> key, int64_t& v) {
    auto f = info.find(key);
    if (f == info.end()) return 1;                       // KeyError
    if (f->second.list || f->second.none) return 2;      // TypeError
    std::string s = std::string(4, '\0') + f->second.data;
    v = (int64_t)be32((const uint8_t*)s.data() + s.size() - 4);
    return 0;
  };
  int64_t w = 0, h = 0, comp = 0;
  if (getint({3, 20}, w) || getint({3, 30}, h)) return false;
  const int rc = getint({3, 120}, comp);
  if (rc == 2) return false;
  if (rc == 1 || (comp != 1 && comp != 5)) return true;  // OSError: unknown compression
  return mode && w > 0 && h > 0;
}

// ------------------------------------------ PCD (PcdImagePlugin._open)
bool pcd_takes(const uint8_t* d, size_t n) {
  return n >= 2048 + 1539 && !std::memcmp(d + 2048, "PCD_", 4);
}

// ---------------------------------------- SPIDER (SpiderImagePlugin._open)
bool spider_takes(const uint8_t* d, size_t n) {
  if (n < 27 * 4) return false;  // struct.error
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
  if (hdrlen == 0) hdrlen = header(false);
  if (hdrlen == 0) return false;
  if (t[5] != 1) return false;  // "not a Spider 2D image"
  // int(h[24]), int(h[27]): ValueError or OverflowError end the open
  if (!std::isfinite(t[24]) || !std::isfinite(t[27])) return true;
  const double istack = std::trunc(t[24]), img = std::trunc(t[27]);
  if (istack == 0 && img > 0) return true;  // self.stkoffset: AttributeError
  if (!((istack == 0 && img == 0) || (istack > 0 && img == 0))) return false;
  if (istack > 0 && !std::isfinite(t[26])) return true;
  return std::trunc(t[12]) > 0 && std::trunc(t[2]) > 0;
}
