// DDS as PIL 12.1's DdsImagePlugin reads it, then convert("L"): the header
// (124 bytes; an "Incomplete header" raises, another size is refused as PIL
// refuses it), the pixel formats by flag in PIL's order: RGB(A) by bit
// masks (DdsRgbDecoder: each masked field scaled by float division and
// truncated; past the end of the file a pixel reads as 0), luminance (L,
// LA), 8-bit palette (1024 bytes of RGBA), and by FourCC DXT1, DXT3, DXT5,
// BC4U / ATI1, BC5U / ATI2, BC5S and DX10 with the DXGI formats PIL maps
// (BC1-BC7, BC6H UF16 and SF16, R8G8B8A8; sRGB names only a gamma). The
// blocks decode as Pillow's bcn decoder decodes them: 4×4 blocks in rows,
// clipped at the image's edges; a file that ends before the last block
// raises ("image file is truncated"). The BC6H and BC7 tables are those of
// the formats' specification (the D3D11 functional specification), in the
// layout Pillow's decoder keeps them; Pillow's own arithmetic is kept where
// it departs from the specification (signed BC6H deltas are not extended
// again after the base is added; BC5S's blue is 128), found by probing.
//
// Included by native_runtime.cpp inside its anonymous namespace, after
// native_pil.h and native_bmp.h.

struct Rgba {
  uint8_t r, g, b, a;
};

// ----------------------------------------------------------- BC1-BC5
inline Rgba decode_565(uint16_t x) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  r |= r >> 5;
  g |= g >> 6;
  b |= b >> 5;
  return {(uint8_t)r, (uint8_t)g, (uint8_t)b, 0xff};
}

// BC2 and BC3 colour blocks always take four colours
void decode_bc1_color(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = le16(src), c1 = le16(src + 2);
  const uint32_t lut = le32(src + 4);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = {(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3),
            (uint8_t)((2 * b0 + b1) / 3), 0xff};
    p[3] = {(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3),
            (uint8_t)((b0 + 2 * b1) / 3), 0xff};
  } else {
    p[2] = {(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2), (uint8_t)((b0 + b1) / 2), 0xff};
    p[3] = {0, 0, 0, 0};
  }
  for (int i = 0; i < 16; ++i) dst[i] = p[3 & (lut >> (2 * i))];
}

// an 8-byte alpha block (BC3's alpha, BC4, each channel of BC5) into byte
// `o` of 16 pixels `stride` bytes apart; signed blocks shift by 128
void decode_bc3_alpha(uint8_t* dst, const uint8_t* src, int stride, int o, bool sign) {
  int a0 = src[0], a1 = src[1];
  if (sign) {
    a0 = (int8_t)src[0] + 128;
    a1 = (int8_t)src[1] + 128;
  }
  const uint32_t lut1 = src[2] | src[3] << 8 | src[4] << 16;
  const uint32_t lut2 = src[5] | src[6] << 8 | src[7] << 16;
  uint8_t a[8];
  a[0] = (uint8_t)a0;
  a[1] = (uint8_t)a1;
  if (a0 > a1) {
    for (int i = 2; i < 8; ++i) a[i] = (uint8_t)(((8 - i) * a0 + (i - 1) * a1) / 7);
  } else {
    for (int i = 2; i < 6; ++i) a[i] = (uint8_t)(((6 - i) * a0 + (i - 1) * a1) / 5);
    a[6] = 0;
    a[7] = 0xff;
  }
  for (int i = 0; i < 8; ++i) dst[stride * i + o] = a[7 & (lut1 >> (3 * i))];
  for (int i = 0; i < 8; ++i) dst[stride * (8 + i) + o] = a[7 & (lut2 >> (3 * i))];
}

// ---------------------------------------------------------------- BC7
struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// the partitions of two subsets, one bit per pixel, and of three, two bits
const uint16_t kBc7Si2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kBc7Si3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254};
// anchor indices: of subset 1 of two, of subsets 1 and 2 of three
const uint8_t kBc7Ai0[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                             15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                             15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                             6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kBc7Ai1[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                             3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                             8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                             3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kBc7Ai2[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                             15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                             15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                             15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t kBcWeights2[4] = {0, 21, 43, 64};
const uint8_t kBcWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kBcWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

inline const uint8_t* bc_weights(int n) {
  return n == 2 ? kBcWeights2 : n == 3 ? kBcWeights3 : kBcWeights4;
}

inline int bc_subset(int ns, int partition, int i) {
  if (ns == 2) return 1 & (kBc7Si2[partition] >> i);
  if (ns == 3) return 3 & (kBc7Si3[partition] >> (2 * i));
  return 0;
}

// `count` (≤ 8) bits from bit `bit` of the 16-byte block, LSB first
inline int bc_bits(const uint8_t* src, int bit, int count) {
  if (!count) return 0;
  const int by = bit >> 3;
  bit &= 7;
  if (bit + count <= 8) return (src[by] >> bit) & ((1 << count) - 1);
  const int x = src[by] | (by + 1 < 16 ? src[by + 1] : 0) << 8;
  return (x >> bit) & ((1 << count) - 1);
}

inline uint8_t expand_quantized(uint8_t v, int bits) {
  v = (uint8_t)(v << (8 - bits));
  return (uint8_t)(v | (v >> bits));
}

inline void bc7_lerp(Rgba* dst, const Rgba* e, int s0, int s1) {
  const int t0 = 64 - s0, t1 = 64 - s1;
  dst->r = (uint8_t)((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  dst->g = (uint8_t)((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  dst->b = (uint8_t)((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  dst->a = (uint8_t)((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void decode_bc7_block(Rgba* col, const uint8_t* src) {
  int mode = 0;
  while (mode < 8 && !(src[0] & (1 << mode))) ++mode;
  if (mode == 8) {  // no mode bit: a block of zeros
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 0};
    return;
  }
  const Bc7Mode& info = kBc7Modes[mode];
  int bit = mode + 1;
  const int partition = bc_bits(src, bit, info.pb);
  bit += info.pb;
  const int rotation = bc_bits(src, bit, info.rb);
  bit += info.rb;
  const int index_sel = bc_bits(src, bit, info.isb);
  bit += info.isb;
  const int numep = info.ns << 1;
  Rgba ep[6];
  for (int i = 0; i < numep; ++i, bit += info.cb) ep[i].r = (uint8_t)bc_bits(src, bit, info.cb);
  for (int i = 0; i < numep; ++i, bit += info.cb) ep[i].g = (uint8_t)bc_bits(src, bit, info.cb);
  for (int i = 0; i < numep; ++i, bit += info.cb) ep[i].b = (uint8_t)bc_bits(src, bit, info.cb);
  for (int i = 0; i < numep; ++i) {
    if (info.ab) {
      ep[i].a = (uint8_t)bc_bits(src, bit, info.ab);
      bit += info.ab;
    } else {
      ep[i].a = 255;
    }
  }
  int cb = info.cb, ab = info.ab;
  if (info.epb) {  // a p-bit per endpoint
    for (int i = 0; i < numep; ++i) {
      const int s = bc_bits(src, bit++, 1);
      ep[i].r = (uint8_t)(ep[i].r << 1 | s);
      ep[i].g = (uint8_t)(ep[i].g << 1 | s);
      ep[i].b = (uint8_t)(ep[i].b << 1 | s);
      if (ab) ep[i].a = (uint8_t)(ep[i].a << 1 | s);
    }
    ++cb;
    if (ab) ++ab;
  }
  if (info.spb) {  // a p-bit per subset
    for (int i = 0; i < numep; i += 2) {
      const int s = bc_bits(src, bit++, 1);
      for (int j = 0; j < 2; ++j) {
        ep[i + j].r = (uint8_t)(ep[i + j].r << 1 | s);
        ep[i + j].g = (uint8_t)(ep[i + j].g << 1 | s);
        ep[i + j].b = (uint8_t)(ep[i + j].b << 1 | s);
        if (ab) ep[i + j].a = (uint8_t)(ep[i + j].a << 1 | s);
      }
    }
    ++cb;
    if (ab) ++ab;
  }
  for (int i = 0; i < numep; ++i) {
    ep[i].r = expand_quantized(ep[i].r, cb);
    ep[i].g = expand_quantized(ep[i].g, cb);
    ep[i].b = expand_quantized(ep[i].b, cb);
    if (ab) ep[i].a = expand_quantized(ep[i].a, ab);
  }
  int cibit = bit, aibit = cibit + 16 * info.ib - info.ns;
  const uint8_t* cw = bc_weights(info.ib);
  const uint8_t* aw = bc_weights(info.ab && info.ib2 ? info.ib2 : info.ib);
  for (int i = 0; i < 16; ++i) {
    const int s = bc_subset(info.ns, partition, i) << 1;
    int ib = info.ib;
    if (i == 0) {
      --ib;
    } else if (info.ns == 2) {
      if (i == kBc7Ai0[partition]) --ib;
    } else if (info.ns == 3) {
      if (i == kBc7Ai1[partition] || i == kBc7Ai2[partition]) --ib;
    }
    const int i0 = bc_bits(src, cibit, ib);
    cibit += ib;
    if (info.ab && info.ib2) {
      int ib2 = info.ib2;
      if (i == 0) --ib2;
      const int i1 = bc_bits(src, aibit, ib2);
      aibit += ib2;
      if (index_sel) bc7_lerp(&col[i], &ep[s], aw[i1], cw[i0]);
      else bc7_lerp(&col[i], &ep[s], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &ep[s], cw[i0], cw[i0]);
    }
    if (rotation == 1) std::swap(col[i].r, col[i].a);
    else if (rotation == 2) std::swap(col[i].g, col[i].a);
    else if (rotation == 3) std::swap(col[i].b, col[i].a);
  }
}

// ---------------------------------------------------------------- BC6H
struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
};
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};

// each mode's endpoint bits in stream order, as endpoint · 16 + bit, the
// endpoints r0 g0 b0 r1 g1 b1 r2 g2 b2 r3 g3 b3 (the specification's w x y z)
const uint8_t kBc6Packings[14][75] = {
    {116, 132, 180, 0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,
     22,  23,  24,  25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  52,
     164, 112, 113, 114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,
     84,  177, 128, 129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {117, 164, 165, 0,   1,   2,   3,   4,   5,   6,   176, 177, 132, 16,  17,  18,  19,  20,  21,
     22,  133, 178, 116, 32,  33,  34,  35,  36,  37,  38,  179, 181, 180, 48,  49,  50,  51,  52,
     53,  112, 113, 114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,  82,  83,
     84,  85,  128, 129, 130, 131, 96,  97,  98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,  22,  23,  24,
     25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  52,  10,  112, 113,
     114, 115, 64,  65,  66,  67,  26,  176, 160, 161, 162, 163, 80,  81,  82,  83,  42,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,  22,  23,  24,
     25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  10,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  26,  160, 161, 162, 163, 80,  81,  82,  83,  42,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  176, 178, 144, 145, 146, 147, 116, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   9,   16,  17,  18,  19,  20,  21,  22,  23,  24,
     25,  32,  33,  34,  35,  36,  37,  38,  39,  40,  41,  48,  49,  50,  51,  10,  132, 112, 113,
     114, 115, 64,  65,  66,  67,  26,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  42,  128,
     129, 130, 131, 96,  97,  98,  99,  177, 178, 144, 145, 146, 147, 180, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   8,   132, 16,  17,  18,  19,  20,  21,  22,  23,  24,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  40,  180, 48,  49,  50,  51,  52,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   164, 132, 16,  17,  18,  19,  20,  21,  22,  23,  178,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  179, 180, 48,  49,  50,  51,  52,  53,  112, 113,
     114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,   1,   2,   3,   4,   5,   6,   7,   176, 132, 16,  17,  18,  19,  20,  21,  22,  23,  117,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  165, 180, 48,  49,  50,  51,  52,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,  82,  83,  84,  177, 128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   6,   7,   177, 132, 16,  17,  18,  19,  20,  21,  22,  23,  133,
     116, 32,  33,  34,  35,  36,  37,  38,  39,  181, 180, 48,  49,  50,  51,  52,  164, 112, 113,
     114, 115, 64,  65,  66,  67,  68,  176, 160, 161, 162, 163, 80,  81,  82,  83,  84,  85,  128,
     129, 130, 131, 96,  97,  98,  99,  100, 178, 144, 145, 146, 147, 148, 179},
    {0,   1,   2,   3,   4,   5,   164, 176, 177, 132, 16,  17,  18,  19,  20,  21,  117, 133, 178,
     116, 32,  33,  34,  35,  36,  37,  165, 179, 181, 180, 48,  49,  50,  51,  52,  53,  112, 113,
     114, 115, 64,  65,  66,  67,  68,  69,  160, 161, 162, 163, 80,  81,  82,  83,  84,  85,  128,
     129, 130, 131, 96,  97,  98,  99,  100, 101, 144, 145, 146, 147, 148, 149},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
     64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 56, 10,
     64, 65, 66, 67, 68, 69, 70, 71, 72, 26, 80, 81, 82, 83, 84, 85, 86, 87, 88, 42},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 52, 53, 54, 55, 11, 10,
     64, 65, 66, 67, 68, 69, 70, 71, 27, 26, 80, 81, 82, 83, 84, 85, 86, 87, 43, 42},
    {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
     32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 48, 49, 50, 51, 15, 14, 13, 12, 11, 10,
     64, 65, 66, 67, 31, 30, 29, 28, 27, 26, 80, 81, 82, 83, 47, 46, 45, 44, 43, 42}};

inline void bc6_sign_extend(uint16_t& v, int prec) {
  int x = v;
  if (x & (1 << (prec - 1))) x |= ~((1 << prec) - 1);
  v = (uint16_t)x;
}

inline int bc6_unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    const int x = v;
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = (int16_t)v;
  if (prec >= 16) return x;
  const bool s = x < 0;
  if (s) x = -x;
  if (x != 0) {
    if (x >= (1 << (prec - 1)) - 1) x = 0x7fff;
    else x = ((x << 15) + 0x4000) >> (prec - 1);
  }
  return s ? -x : x;
}

// a half float, as Pillow converts it (magic-number scaling)
inline float half_to_float(uint16_t h) {
  uint32_t ou = (uint32_t)(h & 0x7fff) << 13;
  float of, mf;
  uint32_t mu = 0x77800000;
  std::memcpy(&of, &ou, 4);
  std::memcpy(&mf, &mu, 4);
  of *= mf;
  mu = 0x47800000;
  std::memcpy(&mf, &mu, 4);
  std::memcpy(&ou, &of, 4);
  if (of >= mf) ou |= 255u << 23;
  ou |= (uint32_t)(h & 0x8000) << 16;
  std::memcpy(&of, &ou, 4);
  return of;
}

inline float bc6_finalize(int v, bool sign) {
  if (sign) {
    if (v < 0) return half_to_float((uint16_t)(0x8000 | ((-v) * 31) / 32));
    return half_to_float((uint16_t)((v * 31) / 32));
  }
  return half_to_float((uint16_t)((v * 31) / 64));
}

inline uint8_t bc6_clamp(float v) {
  if (v < 0.0f) return 0;
  if (v > 1.0f) return 255;
  return (uint8_t)(v * 255.0f);
}

inline void bc6_lerp(Rgba* col, const int* e0, const int* e1, int s, bool sign) {
  const int t = 64 - s;
  col->r = bc6_clamp(bc6_finalize((e0[0] * t + e1[0] * s) >> 6, sign));
  col->g = bc6_clamp(bc6_finalize((e0[1] * t + e1[1] * s) >> 6, sign));
  col->b = bc6_clamp(bc6_finalize((e0[2] * t + e1[2] * s) >> 6, sign));
}

void decode_bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1f, bit = 5, epbits = 75, ib = 3;
  if ((mode & 3) == 0 || (mode & 3) == 1) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    epbits = 72;
  } else {
    mode = 10 + (mode >> 2);
    epbits = 60;
    ib = 4;
  }
  if (mode >= 14) {  // a reserved mode: a block of zeros
    for (int i = 0; i < 16; ++i) col[i] = {0, 0, 0, 0};
    return;
  }
  const Bc6Mode& info = kBc6Modes[mode];
  const uint8_t* cw = bc_weights(ib);
  const int numep = info.ns == 2 ? 12 : 6;
  uint16_t ep[12] = {0};
  for (int i = 0; i < epbits; ++i) {
    const int di = kBc6Packings[mode][i];
    ep[di >> 4] = (uint16_t)(ep[di >> 4] | bc_bits(src, bit + i, 1) << (di & 15));
  }
  bit += epbits;
  const int partition = bc_bits(src, bit, info.pb);
  bit += info.pb;
  const int mask = (1 << info.epb) - 1;
  if (sign)
    for (int i = 0; i < 3; ++i) bc6_sign_extend(ep[i], info.epb);
  if (sign || info.tr)
    for (int i = 3; i < numep; i += 3) {
      bc6_sign_extend(ep[i], info.rb);
      bc6_sign_extend(ep[i + 1], info.gb);
      bc6_sign_extend(ep[i + 2], info.bb);
    }
  if (info.tr)  // deltas from the first endpoint, masked and, unlike the
                 // specification, not sign-extended again when signed
    for (int i = 3; i < numep; ++i) ep[i] = (uint16_t)((ep[i] + ep[i % 3]) & mask);
  int ueps[12];
  for (int i = 0; i < numep; ++i) ueps[i] = bc6_unquantize(ep[i], info.epb, sign);
  for (int i = 0; i < 16; ++i) {
    const int s = bc_subset(info.ns, partition, i) * 6;
    int ib2 = ib;
    if (i == 0) --ib2;
    else if (info.ns == 2 && i == kBc7Ai0[partition]) --ib2;
    const int i0 = bc_bits(src, bit, ib2);
    bit += ib2;
    bc6_lerp(&col[i], &ueps[s], &ueps[s + 3], cw[i0], sign);
  }
}

// ----------------------------------------------------------------- DDS
struct DdsInfo {
  int w = 0, h = 0;
  PilMode mode = kModeNone;
  int n = 0;  // the bcn kind, 1-7; 0: raw or dds_rgb
  bool sign = false, rgb = false;
  int64_t bitcount = 0;
  uint32_t masks[4] = {0, 0, 0, 0};
  size_t data = 128;
};

int dds_open(const uint8_t* d, size_t n, DdsInfo& s) {
  if (n < 8) return kPassOn;  // struct.unpack of a short read: struct.error
  if (le32(d + 4) != 124) return kDdsHeader;  // OSError: "Unsupported header size"
  if (n < 128) return kCorrupt;  // "Incomplete header"
  const uint32_t height = le32(d + 12), width = le32(d + 16);
  const uint32_t pfflags = le32(d + 80);
  const uint8_t* fourcc = d + 84;
  s.bitcount = le32(d + 88);
  auto is = [&](const char* f) { return !std::memcmp(fourcc, f, 4); };
  if (pfflags & 0x40) {  // DDPF.RGB
    s.rgb = true;
    s.mode = pfflags & 0x1 ? kModeRGBA : kModeRGB;
    for (int i = 0; i < (s.mode == kModeRGBA ? 4 : 3); ++i) s.masks[i] = le32(d + 92 + 4 * i);
  } else if (pfflags & 0x20000) {  // DDPF.LUMINANCE
    if (s.bitcount == 8) s.mode = kModeL;
    else if (s.bitcount == 16 && (pfflags & 0x1)) s.mode = kModeLA;
    else return kDdsFormat;  // "Unsupported bitcount"
  } else if (pfflags & 0x20) {  // DDPF.PALETTEINDEXED8: 1024 bytes of RGBA first
    s.mode = kModeP;
    s.data = 128 + std::min<size_t>(1024, n - 128);
  } else if (pfflags & 0x4) {  // DDPF.FOURCC
    if (is("DXT1")) { s.mode = kModeRGBA; s.n = 1; }
    else if (is("DXT3")) { s.mode = kModeRGBA; s.n = 2; }
    else if (is("DXT5")) { s.mode = kModeRGBA; s.n = 3; }
    else if (is("BC4U") || is("ATI1")) { s.mode = kModeL; s.n = 4; }
    else if (is("BC5S")) { s.mode = kModeRGB; s.n = 5; s.sign = true; }
    else if (is("BC5U") || is("ATI2")) { s.mode = kModeRGB; s.n = 5; }
    else if (is("DX10")) {
      if (n < 132) return kPassOn;  // struct.unpack of a short read
      const uint32_t f = le32(d + 128);
      s.data = 128 + std::min<size_t>(20, n - 128);
      if (f == 70 || f == 71) { s.mode = kModeRGBA; s.n = 1; }
      else if (f == 73 || f == 74) { s.mode = kModeRGBA; s.n = 2; }
      else if (f == 76 || f == 77) { s.mode = kModeRGBA; s.n = 3; }
      else if (f == 79 || f == 80) { s.mode = kModeL; s.n = 4; }
      else if (f == 82 || f == 83) { s.mode = kModeRGB; s.n = 5; }
      else if (f == 84) { s.mode = kModeRGB; s.n = 5; s.sign = true; }
      else if (f == 95) { s.mode = kModeRGB; s.n = 6; }
      else if (f == 96) { s.mode = kModeRGB; s.n = 6; s.sign = true; }
      else if (f == 97 || f == 98 || f == 99) { s.mode = kModeRGBA; s.n = 7; }
      else if (f == 27 || f == 28 || f == 29) { s.mode = kModeRGBA; }
      else return kDdsFormat;  // NotImplementedError: "Unimplemented DXGI format"
    } else {
      return kDdsFormat;  // NotImplementedError: "Unimplemented pixel format"
    }
  } else {
    return kDdsFormat;  // NotImplementedError: "Unknown pixel format flags"
  }
  if (width == 0 || height == 0) return kPassOn;  // "not identified by this driver"
  if (width > (1u << 24) || height > (1u << 24) || (uint64_t)width * height > kMaxPixels)
    return kCorrupt;
  s.w = (int)width;
  s.h = (int)height;
  return kOk;
}

int probe_dds(const uint8_t* d, size_t n, int& w, int& h) {
  DdsInfo s;
  const int rc = dds_open(d, n, s);
  w = s.w;
  h = s.h;
  return rc;
}

int decode_dds(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  DdsInfo s;
  const int rc = dds_open(d, n, s);
  if (rc) return rc;
  w = s.w;
  h = s.h;
  const size_t npx = (size_t)w * h;
  gray.resize(npx);
  if (s.rgb) {  // DdsRgbDecoder: little-endian pixels of bitcount // 8 bytes
    const int k = s.mode == kModeRGBA ? 4 : 3;
    const int64_t bytecount = s.bitcount / 8;
    const int64_t used = std::min<int64_t>(bytecount, 4);  // the masks see 32 bits
    int off[4];
    double total[4];
    for (int i = 0; i < k; ++i) {
      uint32_t m = s.masks[i];
      int o = 0;
      if (m)
        while (((uint64_t)m >> (o + 1) << (o + 1)) == m) ++o;
      off[i] = o;
      total[i] = (double)(m >> o);
    }
    size_t pos = s.data;
    for (size_t i = 0; i < npx; ++i) {
      uint64_t v = 0;
      for (int64_t b = 0; b < used && pos + b < n; ++b) v |= (uint64_t)d[pos + b] << (8 * b);
      pos = pos + bytecount < n ? pos + bytecount : n;
      int c[3];
      for (int j = 0; j < 3; ++j)
        c[j] = total[j] ? (int)((double)((v & s.masks[j]) >> off[j]) / total[j] * 255.0) : 0;
      gray[i] = pil_luma(c[0], c[1], c[2]);
    }
    return kOk;
  }
  if (!s.n) {  // raw: L, LA, P (an RGBA palette) or RGBA, from the current position
    const int bpp = s.mode == kModeLA ? 2 : s.mode == kModeRGBA ? 4 : 1;
    if (s.data > n || (n - s.data) / bpp < npx) return kCorrupt;  // "image file is truncated"
    const uint8_t* p = d + s.data;
    const uint8_t* pal = d + 128;
    const size_t pal_n = std::min<size_t>(1024, n - 128) / 4;
    for (size_t i = 0; i < npx; ++i, p += bpp) {
      if (s.mode == kModeP)
        gray[i] = p[0] < pal_n ? pil_luma(pal[4 * p[0]], pal[4 * p[0] + 1], pal[4 * p[0] + 2]) : 0;
      else if (s.mode == kModeRGBA)
        gray[i] = pil_luma(p[0], p[1], p[2]);
      else
        gray[i] = p[0];
    }
    return kOk;
  }
  // bcn: blocks of 8 (BC1, BC4) or 16 bytes in rows of (w + 3) / 4
  const size_t block = s.n == 1 || s.n == 4 ? 8 : 16;
  const size_t bw = ((size_t)w + 3) / 4, bh = ((size_t)h + 3) / 4;
  if (s.data > n || (n - s.data) / block < bw * bh) return kCorrupt;
  const uint8_t* p = d + s.data;
  Rgba col[16];
  for (size_t by = 0; by < bh; ++by)
    for (size_t bx = 0; bx < bw; ++bx, p += block) {
      std::memset(col, 0, sizeof(col));
      switch (s.n) {
        case 1: decode_bc1_color(col, p, false); break;
        case 2:
          decode_bc1_color(col, p + 8, true);
          for (int i = 0; i < 8; ++i) {  // explicit 4-bit alpha
            col[2 * i].a = (uint8_t)((p[i] & 15) * 17);
            col[2 * i + 1].a = (uint8_t)((p[i] >> 4) * 17);
          }
          break;
        case 3:
          decode_bc1_color(col, p + 8, true);
          decode_bc3_alpha(&col[0].r, p, 4, 3, false);
          break;
        case 4: decode_bc3_alpha(&col[0].r, p, 4, 0, false); break;
        case 5:  // red and green; blue 0, or 128 (zero) when signed
          decode_bc3_alpha(&col[0].r, p, 4, 0, s.sign);
          decode_bc3_alpha(&col[0].r, p + 8, 4, 1, s.sign);
          if (s.sign)
            for (int i = 0; i < 16; ++i) col[i].b = 128;
          break;
        case 6: decode_bc6_block(col, p, s.sign); break;
        case 7: decode_bc7_block(col, p); break;
      }
      for (int j = 0; j < 4; ++j) {
        const size_t y = by * 4 + j;
        if (y >= (size_t)h) continue;
        for (int i = 0; i < 4; ++i) {
          const size_t x = bx * 4 + i;
          if (x >= (size_t)w) continue;
          const Rgba& c = col[4 * j + i];
          gray[y * w + x] = s.n == 4 ? c.r : pil_luma(c.r, c.g, c.b);
        }
      }
    }
  return kOk;
}
