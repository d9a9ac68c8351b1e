// How PIL 12.1's Image.open identifies a file, for the table of plugins in
// native_runtime.cpp: each plugin's accept test on the first 16 bytes (the
// prefix Image.open reads), and WMF's open check as far as the error that
// passes the file on to the next plugin (its accept test takes TGA,
// DIB-like and other files; the port does not read WMF, so a file its open
// would take is refused naming it). A plugin passes a file on when its open
// raises SyntaxError, IndexError, TypeError, KeyError, EOFError or
// struct.error; any other error ends the open. The plugins without an accept
// test that the port reads (IM, IMT, IPTC, PCD, SPIDER) start their readers
// with their open checks (native_layouts.h, native_raster.h).
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

// ---------------------------------- the open check of WMF's weak accept test
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
