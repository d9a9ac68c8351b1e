// PIL's image model for the formats PIL reads through ImageFile's raw
// decoder and its own unpackers (TIFF, BMP, PFM): the modes, the unpackers
// of Pillow's Unpack.c that TiffImagePlugin, BmpImagePlugin and
// PpmImagePlugin reach, the raw decoder's walk over rows (RawDecode.c), and
// convert("L") from each mode (Convert.c).
//
// Included by native_runtime.cpp inside its anonymous namespace: it uses that
// file's Err codes, pil_luma and pil_cmyk_luma.

// PIL's Image.open raises DecompressionBombError past twice
// Image.MAX_IMAGE_PIXELS (89,478,485)
constexpr uint64_t kMaxPixels = 2ull * 89478485;

enum PilMode {
  kMode1, kModeL, kModeP, kModeLA, kModePA, kModeI16, kModeI16B, kModeI, kModeF,
  kModeRGB, kModeRGBA, kModeCMYK, kModeLAB, kModeYCbCr, kModeNone
};

PilMode pil_mode(const std::string& s) {
  static const std::pair<const char*, PilMode> names[] = {
      {"1", kMode1},     {"L", kModeL},       {"P", kModeP},     {"LA", kModeLA},
      {"PA", kModePA},   {"I;16", kModeI16},  {"I;16B", kModeI16B}, {"I", kModeI},
      {"F", kModeF},     {"RGB", kModeRGB},   {"RGBA", kModeRGBA}, {"CMYK", kModeCMYK},
      {"LAB", kModeLAB}, {"I;16L", kModeI16}, {"YCbCr", kModeYCbCr}};
  for (const auto& m : names)
    if (s == m.first) return m.second;
  return kModeNone;
}

// bands of a mode, as Pillow's image->bands
int pil_bands(PilMode m) {
  switch (m) {
    case kModeLA: case kModePA: return 2;
    case kModeRGB: case kModeLAB: case kModeYCbCr: return 3;
    case kModeRGBA: case kModeCMYK: return 4;
    default: return 1;
  }
}

// An image as Pillow holds it: 4 bytes per pixel (the 8-bit modes use byte
// 0; I;16 holds its two bytes little-endian, I;16B big-endian; I and F a
// native int32 / float32), zero-filled, and the palette of P and PA
// (entries past pal_n read as black).
struct PilImage {
  PilMode mode = kModeNone;
  int w = 0, h = 0;
  std::vector<uint8_t> px;
  uint8_t pal[256 * 3] = {0};
  int pal_n = 0;

  void alloc(PilMode m, int width, int height) {
    mode = m;
    w = width;
    h = height;
    px.assign((size_t)w * h * 4, 0);
  }
  uint8_t* at(int x, int y) { return px.data() + ((size_t)y * w + x) * 4; }
};

// ------------------------------------------------------------ unpackers
enum Unpack {
  kU1, kU1I, kU1R, kU1IR,
  kUL2, kUL2I, kUL2R, kUL2IR, kUL4, kUL4I, kUL4R, kUL4IR, kUL, kULI, kULR,
  kUP1, kUP2, kUP4, kUP, kUPR, kUPX, kUPA, kULA,
  kUI16, kUI16R, kUI12, kUI16Swap, kUI16S, kUI16BS, kUI32, kUI32B, kUF, kUFB,
  kURGB, kURGBR, kURGBX, kURGBXX, kURGBXXX, kURGB16L, kURGB16B, kURGBX16L, kURGBX16B,
  kURGBA, kURGBAX, kURGBAXX, kURGBa, kURGBaX, kURGBaXX, kURGBA16L, kURGBA16B,
  kURGBa16L, kURGBa16B,
  kUCMYK, kUCMYKX, kUCMYKXX, kUCMYK16L, kUCMYK16B,
  kUBand0, kUBand1, kUBand2, kUBand3,
  kUBGR15, kUBGR16, kUBGR, kUBGRX, kUXBGR, kUBGXR, kUABGR, kUBGRA, kUBGAR,
  kUBGRA15Z, kUP2L, kUP4L, kURGBL, kUL16B,
  kULAL, kURGBAL, kURGBXL, kUCMYKL, kUYCCL, kUF8, kUF8S, kUF16, kUF16S, kUF32U, kUF32S
};

struct UnpackerDef {
  PilMode mode;
  const char* raw;
  int bits;  // per pixel
  Unpack op;
};

// (mode, rawmode) pairs Pillow has, of those the plugins ported here can ask for;
// a pair not here is Pillow's "unknown raw mode for given image mode"
const UnpackerDef kUnpackers[] = {
    {kMode1, "1", 1, kU1}, {kMode1, "1;I", 1, kU1I}, {kMode1, "1;R", 1, kU1R},
    {kMode1, "1;IR", 1, kU1IR},
    {kModeL, "L;2", 2, kUL2}, {kModeL, "L;2I", 2, kUL2I}, {kModeL, "L;2R", 2, kUL2R},
    {kModeL, "L;2IR", 2, kUL2IR}, {kModeL, "L;4", 4, kUL4}, {kModeL, "L;4I", 4, kUL4I},
    {kModeL, "L;4R", 4, kUL4R}, {kModeL, "L;4IR", 4, kUL4IR}, {kModeL, "L", 8, kUL},
    {kModeL, "L;I", 8, kULI}, {kModeL, "L;R", 8, kULR},
    {kModeP, "P;1", 1, kUP1}, {kModeP, "P;2", 2, kUP2}, {kModeP, "P;4", 4, kUP4},
    {kModeP, "P", 8, kUP}, {kModeP, "P;R", 8, kUPR}, {kModeP, "PX", 16, kUPX},
    {kModePA, "PA", 16, kUPA}, {kModeLA, "LA", 16, kULA},
    {kModeI16, "I;16", 16, kUI16}, {kModeI16, "I;16N", 16, kUI16},
    {kModeI16, "I;16R", 16, kUI16R}, {kModeI16, "I;12", 12, kUI12},
    {kModeI16B, "I;16B", 16, kUI16}, {kModeI16B, "I;16N", 16, kUI16Swap},
    {kModeI, "I;16S", 16, kUI16S}, {kModeI, "I;16BS", 16, kUI16BS},
    {kModeI, "I;32N", 32, kUI32}, {kModeI, "I;32S", 32, kUI32}, {kModeI, "I", 32, kUI32},
    {kModeI, "I;32BS", 32, kUI32B},
    {kModeF, "F;32F", 32, kUF}, {kModeF, "F", 32, kUF}, {kModeF, "F;32BF", 32, kUFB},
    {kModeRGB, "RGB", 24, kURGB}, {kModeRGB, "RGB;R", 24, kURGBR},
    {kModeRGB, "RGBX", 32, kURGBX}, {kModeRGB, "RGBXX", 40, kURGBXX},
    {kModeRGB, "RGBXXX", 48, kURGBXXX}, {kModeRGB, "RGB;16L", 48, kURGB16L},
    {kModeRGB, "RGB;16N", 48, kURGB16L}, {kModeRGB, "RGB;16B", 48, kURGB16B},
    {kModeRGB, "RGBX;16L", 64, kURGBX16L}, {kModeRGB, "RGBX;16N", 64, kURGBX16L},
    {kModeRGB, "RGBX;16B", 64, kURGBX16B},
    {kModeRGB, "R", 8, kUBand0}, {kModeRGB, "G", 8, kUBand1}, {kModeRGB, "B", 8, kUBand2},
    {kModeRGB, "BGR;15", 16, kUBGR15}, {kModeRGB, "BGR;16", 16, kUBGR16},
    {kModeRGB, "BGR", 24, kUBGR}, {kModeRGB, "BGRX", 32, kUBGRX},
    {kModeRGB, "XBGR", 32, kUXBGR}, {kModeRGB, "BGXR", 32, kUBGXR},
    {kModeRGBA, "RGBA", 32, kURGBA}, {kModeRGBA, "RGBAX", 40, kURGBAX},
    {kModeRGBA, "RGBAXX", 48, kURGBAXX}, {kModeRGBA, "RGBa", 32, kURGBa},
    {kModeRGBA, "RGBaX", 40, kURGBaX}, {kModeRGBA, "RGBaXX", 48, kURGBaXX},
    {kModeRGBA, "RGBA;16L", 64, kURGBA16L}, {kModeRGBA, "RGBA;16N", 64, kURGBA16L},
    {kModeRGBA, "RGBA;16B", 64, kURGBA16B}, {kModeRGBA, "RGBa;16L", 64, kURGBa16L},
    {kModeRGBA, "RGBa;16N", 64, kURGBa16L}, {kModeRGBA, "RGBa;16B", 64, kURGBa16B},
    {kModeRGBA, "R", 8, kUBand0}, {kModeRGBA, "G", 8, kUBand1},
    {kModeRGBA, "B", 8, kUBand2}, {kModeRGBA, "A", 8, kUBand3},
    {kModeRGBA, "ABGR", 32, kUABGR}, {kModeRGBA, "BGRA", 32, kUBGRA},
    {kModeRGBA, "BGAR", 32, kUBGAR},
    {kModeCMYK, "CMYK", 32, kUCMYK}, {kModeCMYK, "CMYKX", 40, kUCMYKX},
    {kModeCMYK, "CMYKXX", 48, kUCMYKXX}, {kModeCMYK, "CMYK;16L", 64, kUCMYK16L},
    {kModeCMYK, "CMYK;16N", 64, kUCMYK16L}, {kModeCMYK, "CMYK;16B", 64, kUCMYK16B},
    {kModeCMYK, "C", 8, kUBand0}, {kModeCMYK, "M", 8, kUBand1},
    {kModeCMYK, "Y", 8, kUBand2}, {kModeCMYK, "K", 8, kUBand3},
    {kModeRGBA, "BGRA;15Z", 16, kUBGRA15Z}, {kModeP, "P;2L", 2, kUP2L},
    {kModeP, "P;4L", 4, kUP4L}, {kModeRGB, "RGB;L", 24, kURGBL}, {kModeL, "L;16B", 16, kUL16B},
    // the IM plugin's line-interleaved ("…;L") and F / I kinds
    {kModeLA, "LA;L", 16, kULAL}, {kModePA, "PA;L", 16, kULAL}, {kModeRGBA, "RGBA;L", 32, kURGBAL},
    {kModeRGB, "RGBX;L", 32, kURGBXL}, {kModeCMYK, "CMYK;L", 32, kUCMYKL},
    {kModeYCbCr, "YCbCr;L", 24, kUYCCL},
    {kModeF, "F;8", 8, kUF8}, {kModeF, "F;8S", 8, kUF8S}, {kModeF, "F;16", 16, kUF16},
    {kModeF, "F;16S", 16, kUF16S}, {kModeF, "F;32", 32, kUF32U}, {kModeF, "F;32S", 32, kUF32S},
    {kModeI, "I;32", 32, kUI32}, {kModeI16, "I;16L", 16, kUI16},
};

const UnpackerDef* find_unpacker(PilMode mode, const std::string& raw) {
  for (const auto& u : kUnpackers)
    if (u.mode == mode && raw == u.raw) return &u;
  return nullptr;
}

inline uint8_t bitflip(uint8_t b) {
  b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
  b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
  return (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
}

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// premultiplied alpha back to straight, as Pillow's unpackRGBa
inline void unpremultiply(uint8_t* o, int r, int g, int b, int a) {
  if (a == 0) {
    o[0] = o[1] = o[2] = o[3] = 0;
  } else if (a == 255) {
    o[0] = (uint8_t)r; o[1] = (uint8_t)g; o[2] = (uint8_t)b; o[3] = 255;
  } else {
    o[0] = clip8(r * 255 / a); o[1] = clip8(g * 255 / a); o[2] = clip8(b * 255 / a);
    o[3] = (uint8_t)a;
  }
}

inline void put_i32(uint8_t* o, int32_t v) { std::memcpy(o, &v, 4); }

// n pixels of packed input → out, 4 bytes per pixel
void unpack(Unpack op, uint8_t* o, const uint8_t* in, int n) {
  switch (op) {
    case kU1: case kU1I: case kU1R: case kU1IR: case kUP1: {
      const bool rev = op == kU1R || op == kU1IR, inv = op == kU1I || op == kU1IR;
      for (int i = 0; i < n; ++i) {
        const uint8_t byte = rev ? bitflip(in[i >> 3]) : in[i >> 3];
        const int bit = (byte >> (7 - (i & 7))) & 1;
        o[4 * i] = op == kUP1 ? (uint8_t)bit : (uint8_t)((bit ^ inv) ? 255 : 0);
      }
      return;
    }
    case kUL2: case kUL2I: case kUL2R: case kUL2IR: case kUP2:
    case kUL4: case kUL4I: case kUL4R: case kUL4IR: case kUP4: {
      const int k =
          (op == kUL2 || op == kUL2I || op == kUL2R || op == kUL2IR || op == kUP2) ? 2 : 4;
      const bool rev = op == kUL2R || op == kUL2IR || op == kUL4R || op == kUL4IR;
      const bool inv = op == kUL2I || op == kUL2IR || op == kUL4I || op == kUL4IR;
      const bool index = op == kUP2 || op == kUP4;
      const int scale = k == 2 ? 0x55 : 0x11, mask = (1 << k) - 1;
      for (int i = 0; i < n; ++i) {
        const int bitpos = i * k;
        const uint8_t byte = rev ? bitflip(in[bitpos >> 3]) : in[bitpos >> 3];
        const int v = (byte >> (8 - k - (bitpos & 7))) & mask;
        o[4 * i] = index ? (uint8_t)v : inv ? (uint8_t)(255 - v * scale) : (uint8_t)(v * scale);
      }
      return;
    }
    case kUL: case kUP:
      for (int i = 0; i < n; ++i) o[4 * i] = in[i];
      return;
    case kULI:
      for (int i = 0; i < n; ++i) o[4 * i] = (uint8_t)~in[i];
      return;
    case kULR: case kUPR:
      for (int i = 0; i < n; ++i) o[4 * i] = bitflip(in[i]);
      return;
    case kUPX:
      for (int i = 0; i < n; ++i) o[4 * i] = in[2 * i];
      return;
    case kUPA: case kULA:
      for (int i = 0; i < n; ++i) {
        o[4 * i] = in[2 * i];
        if (op == kULA) o[4 * i + 1] = o[4 * i + 2] = in[2 * i];
        o[4 * i + 3] = in[2 * i + 1];
      }
      return;
    case kUI16: case kUI16R:
      for (int i = 0; i < n; ++i) {
        o[4 * i] = op == kUI16R ? bitflip(in[2 * i]) : in[2 * i];
        o[4 * i + 1] = op == kUI16R ? bitflip(in[2 * i + 1]) : in[2 * i + 1];
      }
      return;
    case kUI16Swap:
      for (int i = 0; i < n; ++i) {
        o[4 * i] = in[2 * i + 1];
        o[4 * i + 1] = in[2 * i];
      }
      return;
    case kUI12: {  // |AAAAAAAA|AAAABBBB|BBBBBBBB| → I;16 little-endian
      int i = 0;
      for (; i + 1 < n; i += 2, in += 3) {
        const int a = (in[0] << 4) | (in[1] >> 4), b = ((in[1] & 15) << 8) | in[2];
        o[4 * i] = (uint8_t)a; o[4 * i + 1] = (uint8_t)(a >> 8);
        o[4 * i + 4] = (uint8_t)b; o[4 * i + 5] = (uint8_t)(b >> 8);
      }
      if (i == n - 1) {
        const int a = (in[0] << 4) | (in[1] >> 4);
        o[4 * i] = (uint8_t)a; o[4 * i + 1] = (uint8_t)(a >> 8);
      }
      return;
    }
    case kUI16S:
      for (int i = 0; i < n; ++i) put_i32(o + 4 * i, (int16_t)(in[2 * i] | in[2 * i + 1] << 8));
      return;
    case kUI16BS:
      for (int i = 0; i < n; ++i) put_i32(o + 4 * i, (int16_t)(in[2 * i] << 8 | in[2 * i + 1]));
      return;
    case kUI32: case kUF:
      std::memcpy(o, in, (size_t)n * 4);
      return;
    case kUI32B: case kUFB:
      for (int i = 0; i < n; ++i)
        for (int b = 0; b < 4; ++b) o[4 * i + b] = in[4 * i + 3 - b];
      return;
    case kURGB: case kURGBR: case kURGBX: case kURGBXX: case kURGBXXX: {
      const int s = op == kURGBX ? 4 : op == kURGBXX ? 5 : op == kURGBXXX ? 6 : 3;
      for (int i = 0; i < n; ++i, in += s)
        for (int c = 0; c < 3; ++c) o[4 * i + c] = op == kURGBR ? bitflip(in[c]) : in[c];
      for (int i = 0; i < n; ++i) o[4 * i + 3] = 255;
      return;
    }
    case kURGB16L: case kURGB16B: case kURGBX16L: case kURGBX16B: {
      const int s = (op == kURGBX16L || op == kURGBX16B) ? 8 : 6;
      const int hi = (op == kURGB16L || op == kURGBX16L) ? 1 : 0;
      for (int i = 0; i < n; ++i, in += s) {
        for (int c = 0; c < 3; ++c) o[4 * i + c] = in[2 * c + hi];
        o[4 * i + 3] = 255;
      }
      return;
    }
    case kURGBA: case kURGBAX: case kURGBAXX: case kUCMYK: case kUCMYKX: case kUCMYKXX: {
      const int s = (op == kURGBAX || op == kUCMYKX)     ? 5
                    : (op == kURGBAXX || op == kUCMYKXX) ? 6
                                                         : 4;
      for (int i = 0; i < n; ++i, in += s) std::memcpy(o + 4 * i, in, 4);
      return;
    }
    case kURGBa: case kURGBaX: case kURGBaXX: {
      const int s = op == kURGBaX ? 5 : op == kURGBaXX ? 6 : 4;
      for (int i = 0; i < n; ++i, in += s) unpremultiply(o + 4 * i, in[0], in[1], in[2], in[3]);
      return;
    }
    case kURGBA16L: case kURGBA16B: case kUCMYK16L: case kUCMYK16B: {
      const int hi = (op == kURGBA16L || op == kUCMYK16L) ? 1 : 0;
      for (int i = 0; i < n; ++i, in += 8)
        for (int c = 0; c < 4; ++c) o[4 * i + c] = in[2 * c + hi];
      return;
    }
    case kURGBa16L: case kURGBa16B: {
      const int hi = op == kURGBa16L ? 1 : 0;
      for (int i = 0; i < n; ++i, in += 8)
        unpremultiply(o + 4 * i, in[hi], in[2 + hi], in[4 + hi], in[6 + hi]);
      return;
    }
    case kUBand0: case kUBand1: case kUBand2: case kUBand3: {
      const int b = op - kUBand0;
      for (int i = 0; i < n; ++i) o[4 * i + b] = in[i];
      return;
    }
    case kUBGR15: case kUBGR16:
      for (int i = 0; i < n; ++i) {
        const int p = in[2 * i] | in[2 * i + 1] << 8;
        if (op == kUBGR15) {
          o[4 * i] = (uint8_t)(((p >> 10) & 31) * 255 / 31);
          o[4 * i + 1] = (uint8_t)(((p >> 5) & 31) * 255 / 31);
        } else {
          o[4 * i] = (uint8_t)(((p >> 11) & 31) * 255 / 31);
          o[4 * i + 1] = (uint8_t)(((p >> 5) & 63) * 255 / 63);
        }
        o[4 * i + 2] = (uint8_t)((p & 31) * 255 / 31);
        o[4 * i + 3] = 255;
      }
      return;
    case kUBGR: case kUBGRX: {
      const int s = op == kUBGR ? 3 : 4;
      for (int i = 0; i < n; ++i, in += s) {
        o[4 * i] = in[2]; o[4 * i + 1] = in[1]; o[4 * i + 2] = in[0]; o[4 * i + 3] = 255;
      }
      return;
    }
    case kUBGRA15Z:  // 5-5-5 with an inverted alpha bit: the colours of BGR;15
      for (int i = 0; i < n; ++i) {
        const int p = in[2 * i] | in[2 * i + 1] << 8;
        o[4 * i] = (uint8_t)(((p >> 10) & 31) * 255 / 31);
        o[4 * i + 1] = (uint8_t)(((p >> 5) & 31) * 255 / 31);
        o[4 * i + 2] = (uint8_t)((p & 31) * 255 / 31);
        o[4 * i + 3] = (p >> 15) ? 0 : 255;
      }
      return;
    case kUP2L: case kUP4L: {  // bit planes (pixels + 7) / 8 bytes apart, MSB first
      const int planes = op == kUP2L ? 2 : 4, s = (n + 7) / 8;
      for (int i = 0; i < n; ++i) {
        int v = 0;
        for (int b = 0; b < planes; ++b) v |= ((in[i / 8 + b * s] >> (7 - i % 8)) & 1) << b;
        o[4 * i] = (uint8_t)v;
      }
      return;
    }
    case kURGBL:  // R, G and B planes, `pixels` bytes apart
      for (int i = 0; i < n; ++i) {
        o[4 * i] = in[i]; o[4 * i + 1] = in[i + n]; o[4 * i + 2] = in[i + 2 * n];
        o[4 * i + 3] = 255;
      }
      return;
    case kUL16B:
      for (int i = 0; i < n; ++i) o[4 * i] = in[2 * i];
      return;
    case kULAL:  // L (or P) and A planes, `pixels` bytes apart
      for (int i = 0; i < n; ++i) {
        o[4 * i] = o[4 * i + 1] = o[4 * i + 2] = in[i];
        o[4 * i + 3] = in[i + n];
      }
      return;
    case kURGBAL: case kURGBXL: case kUCMYKL: case kUYCCL: {  // planes, `pixels` bytes apart
      const int planes = op == kUYCCL ? 3 : 4;
      for (int i = 0; i < n; ++i) {
        for (int c = 0; c < planes; ++c) o[4 * i + c] = in[i + c * n];
        if (op == kURGBXL) o[4 * i + 3] = 255;
      }
      return;
    }
    case kUF8: case kUF8S: case kUF16: case kUF16S: case kUF32U: case kUF32S:
      for (int i = 0; i < n; ++i) {
        float f;
        if (op == kUF8) f = (float)in[i];
        else if (op == kUF8S) f = (float)(int8_t)in[i];
        else if (op == kUF16) f = (float)(uint16_t)(in[2 * i] | in[2 * i + 1] << 8);
        else if (op == kUF16S) f = (float)(int16_t)(in[2 * i] | in[2 * i + 1] << 8);
        else {
          const uint8_t* q = in + 4 * i;
          const uint32_t u = q[0] | q[1] << 8 | q[2] << 16 | (uint32_t)q[3] << 24;
          f = op == kUF32U ? (float)u : (float)(int32_t)u;
        }
        std::memcpy(o + 4 * i, &f, 4);
      }
      return;
    case kUXBGR: case kUBGXR: case kUABGR: case kUBGRA: case kUBGAR:
      // (R, G, B, A) byte positions of each 32-bit layout
      for (int i = 0; i < n; ++i, in += 4) {
        static const int pos[5][4] = {{3, 2, 1, -1}, {3, 1, 0, -1}, {3, 2, 1, 0},
                                      {2, 1, 0, 3}, {3, 1, 0, 2}};
        const int* p = pos[op - kUXBGR];
        for (int c = 0; c < 3; ++c) o[4 * i + c] = in[p[c]];
        o[4 * i + 3] = p[3] < 0 ? 255 : in[p[3]];
      }
      return;
  }
}

// PIL's raw decoder over one tile: rows of (xs·bits + 7) / 8 bytes read
// from pos on, `stride` bytes apart (0: packed), unpacked into the extent
// (x0, y0, xs, ys), the first row at the bottom when ystep < 0. The file
// ending before the last row is PIL's "image file is truncated", and a
// stride shorter than a row its decoder's config error: both kCorrupt.
int raw_decode(const uint8_t* d, size_t n, size_t pos, PilImage& im, int x0, int y0, int xs,
               int ys, const UnpackerDef& u, int64_t stride, int ystep) {
  if (xs <= 0 || ys <= 0 || x0 < 0 || y0 < 0 || x0 + xs > im.w || y0 + ys > im.h)
    return kCorrupt;  // "tile cannot extend outside image"
  const int64_t bytes = ((int64_t)xs * u.bits + 7) / 8;
  if (stride && stride < bytes) return kCorrupt;
  const int64_t step = stride ? stride : bytes;
  for (int r = 0; r < ys; ++r) {
    if (pos > n || n - pos < (size_t)bytes) return kCorrupt;
    const int y = ystep < 0 ? y0 + ys - 1 - r : y0 + r;
    unpack(u.op, im.at(x0, y), d + pos, xs);
    pos += (size_t)step;
  }
  return kOk;
}

// Pillow's convert("L") from each mode
int pil_to_gray(const PilImage& im, std::vector<uint8_t>& gray) {
  const size_t npx = (size_t)im.w * im.h;
  gray.resize(npx);
  const uint8_t* p = im.px.data();
  for (size_t i = 0; i < npx; ++i, p += 4) {
    uint8_t v;
    switch (im.mode) {
      case kMode1: case kModeL: case kModeLA: case kModeYCbCr: v = p[0]; break;
      case kModeP: case kModePA:
        v = p[0] < im.pal_n ? pil_luma(im.pal[3 * p[0]], im.pal[3 * p[0] + 1], im.pal[3 * p[0] + 2])
                            : 0;
        break;
      case kModeI16: v = p[1] ? 255 : p[0]; break;
      case kModeI16B: v = p[0] ? 255 : p[1]; break;
      case kModeI: {
        int32_t x;
        std::memcpy(&x, p, 4);
        v = x <= 0 ? 0 : x >= 255 ? 255 : (uint8_t)x;
        break;
      }
      case kModeF: {
        float f;
        std::memcpy(&f, p, 4);
        v = f <= 0.0f ? 0 : f >= 255.0f ? 255 : (f == f ? (uint8_t)(int)f : 0);  // NaN → 0
        break;
      }
      case kModeRGB: case kModeRGBA: v = pil_luma(p[0], p[1], p[2]); break;
      case kModeCMYK: v = pil_cmyk_luma(p[0], p[1], p[2], p[3]); break;
      default: return kCorrupt;
    }
    gray[i] = v;
  }
  return kOk;
}
