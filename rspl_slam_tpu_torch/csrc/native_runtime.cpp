// The port's native runtime: host C++ only, no device code, built by
// ops/cuda_build.py with the host compiler and loaded with ctypes
// (rspl_slam_tpu_torch/native.py).
//
//   A. merge_lines (MergeLines of the reference's line_processor.cc) and
//      the bilinear remap with the border clamp of camera.remap_bilinear;
//   B. PNG: an RFC 1950/1951 inflate, every colour type and bit depth,
//      Adam7, the chunks walked as PIL's plugin walks them (native_png.h);
//   C. JPEG as libjpeg-turbo decodes it for PIL: sequential, progressive
//      and lossless, Huffman or arithmetic coded, gray, YCbCr, RGB, CMYK
//      and YCCK, any integral sampling; netpbm P1-P6, Pillow's own kinds
//      and PFM as PIL reads them; TIFF and BMP, and the headerless DIB
//      (native_tiff.h, native_bmp.h, over PIL's image model in
//      native_pil.h); GIF's frame 0 (native_gif.h); WebP, lossless and
//      lossy, with alpha, frame 0 of an animation (native_webp.h,
//      native_vp8.h); QOI, Sun raster, PCX, DCX, SGI and TGA
//      (native_raster.h); ICO and CUR (native_ico.h); DDS with the BCn
//      blocks (native_bcn.h); PSD (native_psd.h); BLP and FTEX
//      (native_blp.h); ICNS (native_icns.h);
//   D. an ordered stereo prefetcher: decode threads, a bounded reorder
//      buffer, optional rectification.
//
// Formats are told apart by content, never by the file name, as PIL's
// Image.open tells them: one table of PIL 12.1's plugins in its order
// (native_plugins.h holds their accept tests and the open checks of the
// plugins without one), each either read or refused naming it. A plugin's
// open that fails the way PIL's passes the file on to the next; a file no
// plugin takes is kUnknown.
//
// Every decoder returns the 8-bit gray that PIL's Image.open(p).convert("L")
// returns: RGB through PIL's luma (R·19595 + G·38470 + B·7471 + 0x8000) >> 16,
// alpha and tRNS dropped, 16-bit gray clipped at 255, 16-bit colour and
// gray+alpha by their high byte. Nothing here links more than the C++
// standard library and pthreads.

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <string_view>
#include <thread>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

enum Err {
  kPassOn = -1,  // inside the table of plugins only: the plugin passes the file on
  kLoadPassOn = -2,  // inside the PNG reader only: a load error of the pass-on kinds
  kOk = 0, kIO = 1, kCorrupt = 2, kUnknown = 3, kSize = 4,
  // image kinds refused, every code from kPrecision on (native_runtime_error_kind;
  // native.py raises NotImplementedError). PIL refuses the JPEG ones, kTiffMode,
  // kTiffLab, kTiffRawMode, the BMP, GIF, WebP, Sun, PCX, SGI, TGA and DDS
  // ones too, and kPsdLab and kBlpFormat; it reads the rest, which the port
  // does not yet. 31, 32, 34-36 and 38-41 named GIF, WebP, ICO, CUR, QOI,
  // DDS, SGI, Sun raster and PCX before they were read; 13, 49 and 53
  // named Pillow's own netpbm kinds, DCX and FTEX; 16, 17 and 20 TIFF's
  // LZMA, ZSTD and ThunderScan.
  kPrecision = 5, kHierarchical = 6, kDNL = 7, kFractional = 8, kLosslessColour = 9,
  kArithLossless = 10, kComponents = 11, kMcuSize = 12,
  kTiffJpeg = 14, kTiffOjpeg = 15, kTiffWebp = 18,
  kTiffSgiLog = 19, kTiffMode = 22, kTiffLab = 23,
  kTiffRawMode = 24, kBmpHeader = 25, kBmpDepth = 26, kBmpCompression = 27,
  kBmpBitfields = 28, kBmpPalette = 29, kBmpRle = 30,
  kJpeg2000 = 33, kPsdLab = 37, kAvif = 42,
  kGifCodeSize = 43, kWebpVp8Frame = 44, kWebpVp8lVersion = 45, kWebpAlpha = 46,
  // the plugins PIL has that the port does not read, each refused by name,
  // the kinds of BLP and ICNS it refuses, and an IPTC band it cannot place;
  // 51, 52, 54, 58, 60, 61, 63-67, 69 and 70 named FITS, FLI, GBR, McIDAS,
  // MSP, PIXAR, XBM, XPM, XVThumb, IM, IMT, PCD and SPIDER before they were
  // read
  kBlpFormat = 47, kBufr = 48, kEps = 50,
  kGrib = 55, kHdf5 = 56, kIcnsJpeg2000 = 57, kMpeg = 59, kWmf = 62, kIptc = 68,
  // kinds of the formats read since PR 20 that PIL does not read either
  kSunPalette = 71, kPcxMode = 72, kSgiMode = 73, kSgiCompression = 74, kTgaKind = 75,
  kTgaMap = 76, kDdsHeader = 77, kDdsFormat = 78
};

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  buf.clear();
  uint8_t chunk[1 << 16];
  size_t n;
  while ((n = std::fread(chunk, 1, sizeof(chunk), f)) > 0) buf.insert(buf.end(), chunk, chunk + n);
  const bool ok = !std::ferror(f);
  std::fclose(f);
  return ok;
}

inline uint8_t pil_luma(int r, int g, int b) {
  return (uint8_t)((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
}

// PIL's CMYK → RGB: its cmyk2rgb (MULDIV255 of each ink by 255 − K)
inline void pil_cmyk_rgb(int c, int m, int y, int k, int& r, int& g, int& b) {
  auto muldiv255 = [](int a, int b) {
    const int t = a * b + 128;
    return ((t >> 8) + t) >> 8;
  };
  auto clamp = [](int v) { return v < 0 ? 0 : v > 255 ? 255 : v; };
  const int nk = 255 - k;
  r = clamp(nk - muldiv255(c, nk));
  g = clamp(nk - muldiv255(m, nk));
  b = clamp(nk - muldiv255(y, nk));
}

// PIL's CMYK → L: cmyk2rgb, then luma
inline uint8_t pil_cmyk_luma(int c, int m, int y, int k) {
  int r, g, b;
  pil_cmyk_rgb(c, m, y, k, r, g, b);
  return pil_luma(r, g, b);
}

inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

// ================================================================ A. lines
// MergeLines (reference line_processor.cc:492-665), the same steps as the
// numpy merge_lines of ops/lines.py: pair tests → union-find components →
// longest-first sub-cluster split → sequential length-weighted fold.

void merge_two(const double* a, const double* b, double* out) {
  const double ax = a[0], ay = a[1], bx = a[2], by = a[3];
  const double cx = b[0], cy = b[1], dx = b[2], dy = b[3];
  const double dlix = bx - ax, dliy = by - ay;
  const double dljx = dx - cx, dljy = dy - cy;
  const double li = std::hypot(dlix, dliy), lj = std::hypot(dljx, dljy);
  const double xg = (li * (ax + bx) + lj * (cx + dx)) / (2.0 * (li + lj));
  const double yg = (li * (ay + by) + lj * (cy + dy)) / (2.0 * (li + lj));
  const double thi = dlix == 0.0 ? M_PI / 2 : std::atan(dliy / dlix);
  const double thj = dljx == 0.0 ? M_PI / 2 : std::atan(dljy / dljx);
  double th;
  if (std::fabs(thi - thj) <= M_PI / 2) {
    th = (li * thi + lj * thj) / (li + lj);
  } else {
    const double tmp = thj - M_PI * (thj / std::fabs(thj));
    th = (li * thi + lj * tmp) / (li + lj);
  }
  const double ct = std::cos(th), st = std::sin(th);
  const double pa = (ay - yg) * st + (ax - xg) * ct;
  const double pb = (by - yg) * st + (bx - xg) * ct;
  const double pc = (cy - yg) * st + (cx - xg) * ct;
  const double pd = (dy - yg) * st + (dx - xg) * ct;
  const double lo = std::min(std::min(pa, pb), std::min(pc, pd));
  const double hi = std::max(std::max(pa, pb), std::max(pc, pd));
  out[0] = lo * ct + xg;
  out[1] = lo * st + yg;
  out[2] = hi * ct + xg;
  out[3] = hi * st + yg;
}

struct UnionFind {
  std::vector<int> p;
  explicit UnionFind(int n) : p(n) {
    for (int i = 0; i < n; ++i) p[i] = i;
  }
  int find(int x) {
    while (p[x] != x) {
      p[x] = p[p[x]];
      x = p[x];
    }
    return x;
  }
  void unite(int a, int b) {
    const int ra = find(a), rb = find(b);
    if (ra != rb) p[rb] = ra;
  }
};

int merge_lines(const double* segs, int n, double angle_thr, double distance_thr,
                double ep_thr, double* out) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  if (n == 1) {
    std::memcpy(out, segs, 4 * sizeof(double));
    return 1;
  }
  std::vector<double> ang(n), len(n), A(n), B(n), C(n), D(n), mx(n), my(n);
  // each segment's ends ordered along each axis: [axis * n + i]
  std::vector<double> P0x(2 * n), P0y(2 * n), P1x(2 * n), P1y(2 * n);
  for (int i = 0; i < n; ++i) {
    const double x1 = segs[4 * i], y1 = segs[4 * i + 1];
    const double x2 = segs[4 * i + 2], y2 = segs[4 * i + 3];
    const double ddx = x2 - x1, ddy = y2 - y1;
    ang[i] = ddx == 0.0 ? M_PI / 2 : std::atan(ddy / ddx);
    len[i] = std::hypot(ddx, ddy);
    A[i] = ddy;
    B[i] = -ddx;
    C[i] = x2 * y1 - x1 * y2;
    D[i] = std::max(std::hypot(A[i], B[i]), 1e-9);
    mx[i] = (x1 + x2) / 2;
    my[i] = (y1 + y2) / 2;
    for (int axis = 0; axis < 2; ++axis) {
      const double e1 = axis == 0 ? x1 : y1, e2 = axis == 0 ? x2 : y2;
      const bool swap = e2 < e1;
      P0x[axis * n + i] = swap ? x2 : x1;
      P0y[axis * n + i] = swap ? y2 : y1;
      P1x[axis * n + i] = swap ? x1 : x2;
      P1y[axis * n + i] = swap ? y1 : y2;
    }
  }
  // rank in the stable angle sort (ties by index)
  std::vector<int> order(n), pos(n);
  for (int i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) { return ang[a] < ang[b]; });
  for (int r = 0; r < n; ++r) pos[order[r]] = r;

  const double ep2 = ep_thr * ep_thr;
  auto axis_cond = [&](int i, int j, int axis) -> bool {
    const int oi = axis * n + i, oj = axis * n + j;
    const double p1i = axis == 0 ? P1x[oi] : P1y[oi];
    const double p1j = axis == 0 ? P1x[oj] : P1y[oj];
    const bool i_first = p1i <= p1j;
    const double fex = i_first ? P1x[oi] : P1x[oj];
    const double fey = i_first ? P1y[oi] : P1y[oj];
    const double ssx = i_first ? P0x[oj] : P0x[oi];
    const double ssy = i_first ? P0y[oj] : P0y[oi];
    const bool overlap = (axis == 0 ? fex : fey) >= (axis == 0 ? ssx : ssy);
    const double gx = ssx - fex, gy = ssy - fey;
    return overlap || (gx * gx + gy * gy) < ep2;
  };

  std::vector<uint8_t> ok((size_t)n * n, 0);
  UnionFind uf(n);
  for (int i = 0; i < n; ++i) {
    for (int j = i + 1; j < n; ++j) {
      double dA = std::fabs(ang[i] - ang[j]);
      dA = std::min(dA, M_PI - dA);
      if (dA > angle_thr) continue;
      const double dij = std::fabs(mx[i] * A[j] + my[i] * B[j] + C[j]) / D[j];
      const double dji = std::fabs(mx[j] * A[i] + my[j] * B[i] + C[i]) / D[i];
      if (dij > distance_thr && dji > distance_thr) continue;
      // overlap / gap along the dominant axis of the angle-earlier segment
      const int e = pos[i] <= pos[j] ? i : j;
      if (!axis_cond(i, j, std::fabs(ang[e]) < M_PI / 4 ? 0 : 1)) continue;
      ok[(size_t)i * n + j] = ok[(size_t)j * n + i] = 1;
      uf.unite(i, j);
    }
  }

  // components in the order of their first member
  std::vector<std::vector<int>> comps;
  std::vector<int> comp_of(n, -1);
  for (int i = 0; i < n; ++i) {
    const int r = uf.find(i);
    if (comp_of[r] < 0) {
      comp_of[r] = (int)comps.size();
      comps.emplace_back();
    }
    comps[comp_of[r]].push_back(i);
  }

  int m = 0;
  auto fold = [&](const std::vector<int>& s) {
    double cur[4];
    std::memcpy(cur, &segs[4 * s[0]], sizeof(cur));
    for (size_t k = 1; k < s.size(); ++k) {
      double nxt[4];
      merge_two(cur, &segs[4 * s[k]], nxt);
      std::memcpy(cur, nxt, sizeof(cur));
    }
    std::memcpy(&out[4 * m], cur, sizeof(cur));
    ++m;
  };
  std::vector<uint8_t> clustered(n, 0);
  std::vector<int> sub;
  for (auto& members : comps) {
    if (members.size() <= 2) {
      fold(members);
      continue;
    }
    std::vector<int> cl = members;
    std::stable_sort(cl.begin(), cl.end(), [&](int a, int b) { return len[a] > len[b]; });
    std::fill(clustered.begin(), clustered.end(), 0);
    for (int li : cl) {
      if (clustered[li]) continue;
      sub.assign(1, li);
      for (int j = 0; j < n; ++j) {
        if (ok[(size_t)li * n + j]) {
          sub.push_back(j);
          clustered[j] = 1;
        }
      }
      // neighbours fold in angle order
      std::stable_sort(sub.begin() + 1, sub.end(), [&](int a, int b) { return pos[a] < pos[b]; });
      fold(sub);
    }
  }
  return m;
}

// map_xy (h, w, 2): the source (x, y) of each output pixel. Corners clamp
// to [0, w-2] × [0, h-2] and weights to [0, 1] (camera.remap_bilinear).
void remap_bilinear(const float* src, int h, int w, const float* map_xy, float* dst) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const float sx = map_xy[((size_t)y * w + x) * 2 + 0];
      const float sy = map_xy[((size_t)y * w + x) * 2 + 1];
      int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
      x0 = std::min(std::max(x0, 0), w - 2);
      y0 = std::min(std::max(y0, 0), h - 2);
      const float wx = std::min(std::max(sx - (float)x0, 0.0f), 1.0f);
      const float wy = std::min(std::max(sy - (float)y0, 0.0f), 1.0f);
      const float v00 = src[(size_t)y0 * w + x0], v01 = src[(size_t)y0 * w + x0 + 1];
      const float v10 = src[(size_t)(y0 + 1) * w + x0], v11 = src[(size_t)(y0 + 1) * w + x0 + 1];
      dst[(size_t)y * w + x] = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
                               v10 * wy * (1 - wx) + v11 * wy * wx;
    }
  }
}

// =========================================================== B. inflate
// RFC 1950 (zlib wrapper, Adler-32) around RFC 1951 (stored, fixed and
// dynamic Huffman blocks). Codes of up to kFast bits decode by one table
// lookup; longer ones canonically, bit by bit (zlib's contrib/puff).

constexpr int kFast = 10;

struct Huffman {
  int16_t count[16];   // codes per length
  int16_t symbol[288]; // symbols in canonical order
  uint16_t fast[1 << kFast];  // (symbol << 4) | length, 0 = not in table

  // returns false on an over-subscribed set of lengths
  bool build(const uint8_t* lengths, int n) {
    std::memset(count, 0, sizeof(count));
    std::memset(fast, 0, sizeof(fast));
    for (int s = 0; s < n; ++s) count[lengths[s]]++;
    count[0] = 0;
    int left = 1;
    for (int l = 1; l < 16; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) return false;
    }
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + count[l];
    for (int s = 0; s < n; ++s)
      if (lengths[s]) symbol[offs[lengths[s]]++] = (int16_t)s;
    // canonical codes, MSB first; the stream holds them bit-reversed
    int code = 0, idx = 0;
    for (int l = 1; l <= kFast; ++l) {
      for (int k = 0; k < count[l]; ++k, ++code, ++idx) {
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int f = rev; f < (1 << kFast); f += 1 << l)
          fast[f] = (uint16_t)((symbol[idx] << 4) | l);
      }
      code <<= 1;
    }
    return true;
  }
};

struct InflateIn {
  const uint8_t* d;
  size_t n, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  size_t overrun = 0;  // zero bytes fed past the end

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (pos < n) b = d[pos++];
      else overrun++;
      buf |= b << cnt;
      cnt += 8;
    }
  }
  uint32_t bits(int k) {  // k ≤ 32
    if (k == 0) return 0;
    if (cnt < k) fill();
    const uint32_t v = (uint32_t)(buf & ((1ull << k) - 1));
    buf >>= k;
    cnt -= k;
    return v;
  }
  bool overran() const { return overrun * 8 > (size_t)cnt; }
  void align() {  // drop the bits up to the next byte boundary
    const int drop = cnt & 7;
    buf >>= drop;
    cnt -= drop;
  }
  // bytes still buffered go back to the stream
  void unread() {
    const size_t back = (size_t)cnt / 8;
    const size_t from_stream = back > overrun ? back - overrun : 0;
    pos -= from_stream;
    overrun = 0;
    buf = 0;
    cnt = 0;
  }
  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    const uint16_t e = h.fast[buf & ((1u << kFast) - 1)];
    if (e) {
      const int l = e & 15;
      buf >>= l;
      cnt -= l;
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= (int)((buf >> (l - 1)) & 1);
      const int c = h.count[l];
      if (code - c < first) {
        buf >>= l;
        cnt -= l;
        return h.symbol[index + (code - first)];
      }
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return -1;  // no code of this set matches
  }
};

const int16_t kLenBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
                              31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
const int8_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                              2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const int16_t kDistBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129,
                               193, 257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097,
                               6145, 8193, 12289, 16385, 24577};
const int8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                               6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

bool inflate_codes(InflateIn& in, const Huffman& lit, const Huffman& dist,
                   std::vector<uint8_t>& out) {
  while (true) {
    const int sym = in.decode(lit);
    if (sym < 0) return false;
    if (sym < 256) {
      out.push_back((uint8_t)sym);
    } else if (sym == 256) {
      return !in.overran();
    } else {
      const int li = sym - 257;
      if (li >= 29) return false;
      const int length = kLenBase[li] + (int)in.bits(kLenExtra[li]);
      const int di = in.decode(dist);
      if (di < 0 || di >= 30) return false;
      const size_t d = (size_t)kDistBase[di] + in.bits(kDistExtra[di]);
      if (d > out.size()) return false;
      const size_t from = out.size() - d;
      for (int k = 0; k < length; ++k) out.push_back(out[from + k]);
    }
    if (in.overran()) return false;
  }
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    const size_t k = std::min<size_t>(n, 5552);
    n -= k;
    for (size_t i = 0; i < k; ++i) {
      a += p[i];
      b += a;
    }
    p += k;
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

// RFC 1951 blocks appended to out; used: the bytes the stream took, to the
// end of its final block's last byte
int raw_inflate(const uint8_t* d, size_t n, std::vector<uint8_t>& out, size_t& used) {
  InflateIn in{d, n};
  Huffman lit, dist;
  int final = 0;
  do {
    final = (int)in.bits(1);
    const int type = (int)in.bits(2);
    if (type == 0) {
      in.align();
      in.unread();
      if (in.pos + 4 > in.n) return kCorrupt;
      const int len = in.d[in.pos] | (in.d[in.pos + 1] << 8);
      const int nlen = in.d[in.pos + 2] | (in.d[in.pos + 3] << 8);
      if (len != (~nlen & 0xffff) || in.pos + 4 + len > in.n) return kCorrupt;
      out.insert(out.end(), in.d + in.pos + 4, in.d + in.pos + 4 + len);
      in.pos += 4 + len;
    } else if (type == 1) {
      uint8_t l[288 + 30];
      for (int s = 0; s < 288; ++s) l[s] = s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
      for (int s = 0; s < 30; ++s) l[288 + s] = 5;
      lit.build(l, 288);
      dist.build(l + 288, 30);
      if (!inflate_codes(in, lit, dist, out)) return kCorrupt;
    } else if (type == 2) {
      const int nlen = (int)in.bits(5) + 257, ndist = (int)in.bits(5) + 1;
      const int ncode = (int)in.bits(4) + 4;
      if (nlen > 286 || ndist > 30) return kCorrupt;
      static const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                        11, 4, 12, 3, 13, 2, 14, 1, 15};
      uint8_t lengths[320] = {0};
      for (int k = 0; k < ncode; ++k) lengths[order[k]] = (uint8_t)in.bits(3);
      Huffman lencode;
      if (!lencode.build(lengths, 19)) return kCorrupt;
      std::memset(lengths, 0, sizeof(lengths));
      int idx = 0;
      while (idx < nlen + ndist) {
        int sym = in.decode(lencode);
        if (sym < 0) return kCorrupt;
        if (sym < 16) {
          lengths[idx++] = (uint8_t)sym;
          continue;
        }
        int len = 0, rep;
        if (sym == 16) {
          if (idx == 0) return kCorrupt;
          len = lengths[idx - 1];
          rep = 3 + (int)in.bits(2);
        } else if (sym == 17) {
          rep = 3 + (int)in.bits(3);
        } else {
          rep = 11 + (int)in.bits(7);
        }
        if (idx + rep > nlen + ndist) return kCorrupt;
        while (rep--) lengths[idx++] = (uint8_t)len;
      }
      if (lengths[256] == 0) return kCorrupt;
      if (!lit.build(lengths, nlen) || !dist.build(lengths + nlen, ndist)) return kCorrupt;
      if (!inflate_codes(in, lit, dist, out)) return kCorrupt;
    } else {
      return kCorrupt;
    }
    if (in.overran()) return kCorrupt;
  } while (!final);
  in.align();
  in.unread();
  used = in.pos;
  return kOk;
}

int zlib_inflate(const uint8_t* d, size_t n, std::vector<uint8_t>& out, size_t expect) {
  if (n < 6) return kCorrupt;
  const int cmf = d[0], flg = d[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0 || (flg & 0x20))
    return kCorrupt;
  out.clear();
  out.reserve(expect);
  size_t used = 0;
  const int rc = raw_inflate(d + 2, n - 2, out, used);
  if (rc) return rc;
  if (2 + used + 4 > n) return kCorrupt;
  if (be32(d + 2 + used) != adler32(out.data(), out.size())) return kCorrupt;
  return kOk;
}

// =============================================================== B. PNG
// (the plugin's walk over the chunks is native_png.h)

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

// undo the row filters in place: rows of 1 filter byte + stride bytes
bool unfilter(uint8_t* raw, int rows, int stride, int bpp, std::vector<uint8_t>& out) {
  out.assign((size_t)rows * stride, 0);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* in = raw + (size_t)y * (stride + 1);
    uint8_t* cur = out.data() + (size_t)y * stride;
    const uint8_t* up = y > 0 ? cur - stride : nullptr;
    const int f = *in++;
    for (int i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (f) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return false;
      }
      cur[i] = (uint8_t)(in[i] + pred);
    }
  }
  return true;
}

// ========================================================= C. JPEG
// Every JPEG that libjpeg-turbo decodes for PIL (8-bit samples), decoded as
// it decodes it: sequential and progressive Huffman (jdhuff.c, jdphuff.c),
// sequential and progressive arithmetic coding (jdarith.c), lossless
// (jdlossls.c, jddiffct.c, jdlhuff.c); 1, 3 or 4 components, any integral
// sampling ratio, restarts. The input side is libjpeg's own: the markers as
// jdmarker.c reads them (exact segment lengths, a second SOI or SOF, unknown
// markers and, after a one-scan image, a second SOS fail), the Huffman bits
// as jdhuff.c and jdphuff.c read them from the buffer Pillow hands over in
// 65,536-byte reads (the fast path where 512 bytes a block remain, the slow
// path's fills, the MCU redone where either suspends or meets a marker), a
// segment whose data runs out left as zeros from there (insufficient_data),
// and restarts resynced as jpeg_resync_to_restart does. DCT data fills
// libjpeg's coefficient buffer, then block smoothing where a progressive file leaves its first
// coefficients coarse (jdcoefct.c), the islow IDCT (jidctint.c),
// upsampling (jdsample.c), colour conversion (jdcolor.c); then PIL's own
// conversions: RGB luma, Adobe CMYK read inverted ("CMYK;I") and CMYK → RGB.
// The kinds PIL refuses are refused here too, each with its own code.

const uint8_t kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the block's end lands here (libjpeg's guard)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct JHuff {
  bool present = false;
  // jdhuff.c's jpeg_make_d_derived_tbl refuses the table when a scan uses
  // it: a code of all ones, or more codes of a length than it holds
  bool bogus = false;
  int nvals = 0;
  uint8_t vals[256];
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valptr[17];   // index of its first symbol minus its first code
  // jdhuff.c's lookahead: (length << 8) | symbol for codes of ≤ 8 bits, 9 << 8 else
  uint16_t look8[1 << 8];

  // a table as DHT stores it; jdhuff.c refuses a bogus one when a scan uses it
  void build(const uint8_t* counts, const uint8_t* v, int nv) {
    std::memset(vals, 0, sizeof(vals));
    std::memcpy(vals, v, nv);
    nvals = nv;
    for (uint16_t& e : look8) e = 9 << 8;
    bogus = false;
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k - code;
      for (int i = 0; i < counts[l - 1]; ++i, ++code, ++k) {
        if (l <= 8 && code < (1 << l))
          for (int f = code << (8 - l); f < ((code + 1) << (8 - l)); ++f)
            look8[f] = (uint16_t)((l << 8) | vals[k]);
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (counts[l - 1] && code >= (1 << l)) bogus = true;  // all ones, or too many codes
      code = std::min(code, 1 << 17) << 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
  // the table as a DC table of a lossy (lossless) scan: symbols 0-15 (0-16)
  bool dc_ok(bool lossless) const {
    if (bogus) return false;
    for (int i = 0; i < nvals; ++i)
      if (vals[i] > (lossless ? 16 : 15)) return false;
    return true;
  }
};

// jstdhuff.c's tables (ITU T.81 K.3), which libjpeg-turbo installs for a
// Huffman table 0 or 1 that no DHT defined (motion-JPEG frames): counts of
// codes of each length, then the symbols
const uint8_t kStdCounts[4][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},      // DC 0
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},      // DC 1
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},    // AC 0
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};   // AC 1
const uint8_t kStdDcSymbols[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcSymbols[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// jaricom.c's jpeg_aritab, ITU T.81 Table D.2 packed as
// (Qe << 16) | (Next_Index_MPS << 8) | (Switch_MPS << 7) | Next_Index_LPS;
// entry 113 is the fixed 0.5 estimate of sign and refinement bits
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};


struct JComp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // allocated blocks (samples when lossless) per row / column
  int width_in_blocks = 0, height_in_blocks = 0;
  int dw = 0, dh = 0;  // downsampled width / height
  std::vector<int16_t> coef;  // DCT: 64 per block, natural order
  std::vector<int32_t> diff;  // lossless: one difference per sample
  std::vector<uint8_t> first_row;  // lossless: rows predicted as the first row
  int coef_bits[64];  // progressive: the Al each coefficient was last coded at, −1: never
  uint16_t q[64];     // the quantization table latched at the component's first scan
  bool latched = false;
  int dc_pred = 0, td = 0, ta = 0, dc_context = 0;
  int predictor = 1, point_transform = 0;  // lossless: its scan's Ss and Al
};

// jpeg_idct_islow as libjpeg-turbo runs it for PIL on x86-64: its SIMD
// version (jidctint-sse2/avx2.asm), equal to jidctint.c wherever nothing
// overflows, and otherwise in 16-bit lanes: the dequantizing multiply keeps
// the low 16 bits, in0 ± in4 and the odd part's z3, z4 are 16-bit sums,
// each pass's descaled output saturates to 16 bits, the last to 8 bits
// (no range-limit table); a block whose rows 1-7 are zero takes the DC
// shortcut, a 16-bit shift
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F_0_298631336 = 2446, F_0_390180644 = 3196, F_0_541196100 = 4433,
                  F_0_765366865 = 6270, F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137, F_1_961570560 = 16069,
                  F_2_053119869 = 16819, F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int16_t sat16(int32_t x) { return (int16_t)std::min(32767, std::max(-32768, x)); }

// the 1-D IDCT of eight 16-bit values in the SIMD code's arrangement,
// descaled by n and saturated to 16 bits
void idct_1d_simd(const int16_t* x, int step, int n, int16_t* o, int ostep) {
  const int32_t x0 = x[0], x1 = x[step], x2 = x[2 * step], x3 = x[3 * step];
  const int32_t x4 = x[4 * step], x5 = x[5 * step], x6 = x[6 * step], x7 = x[7 * step];
  // even part
  const int32_t tmp3 = x2 * (F_0_541196100 + F_0_765366865) + x6 * F_0_541196100;
  const int32_t tmp2 = x2 * F_0_541196100 + x6 * (F_0_541196100 - F_1_847759065);
  const int32_t tmp0 = (int32_t)(int16_t)(x0 + x4) * (1 << kConstBits);
  const int32_t tmp1 = (int32_t)(int16_t)(x0 - x4) * (1 << kConstBits);
  const int32_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  // odd part
  const int32_t z3 = (int16_t)(x7 + x3), z4 = (int16_t)(x5 + x1);
  const int32_t z3p = z3 * (F_1_175875602 - F_1_961570560) + z4 * F_1_175875602;
  const int32_t z4p = z3 * F_1_175875602 + z4 * (F_1_175875602 - F_0_390180644);
  const int32_t o0 = x7 * (F_0_298631336 - F_0_899976223) + x1 * -F_0_899976223 + z3p;
  const int32_t o3 = x7 * -F_0_899976223 + x1 * (F_1_501321110 - F_0_899976223) + z4p;
  const int32_t o1 = x5 * (F_2_053119869 - F_2_562915447) + x3 * -F_2_562915447 + z4p;
  const int32_t o2 = x5 * -F_2_562915447 + x3 * (F_3_072711026 - F_2_562915447) + z3p;
  const int32_t r = 1 << (n - 1);
  const int32_t v[8] = {t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                        t13 - o0, t12 - o1, t11 - o2, t10 - o3};
  for (int k = 0; k < 8; ++k) o[k * ostep] = sat16((int32_t)((uint32_t)v[k] + (uint32_t)r) >> n);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int16_t deq[64], ws[64], row[8];
  bool ac = false;
  for (int i = 0; i < 64; ++i) {
    deq[i] = (int16_t)(uint16_t)((uint32_t)(uint16_t)in[i] * q[i]);
    ac = ac || (i >= 8 && in[i]);
  }
  if (!ac) {
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = (int16_t)(uint16_t)((uint32_t)(uint16_t)deq[c] << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; ++c) idct_1d_simd(deq + c, 8, kConstBits - kPass1Bits, ws + c, 8);
  }
  for (int r = 0; r < 8; ++r) {
    idct_1d_simd(ws + 8 * r, 1, kConstBits + kPass1Bits + 3, row, 1);
    uint8_t* o = out + (size_t)r * stride;
    for (int k = 0; k < 8; ++k) o[k] = (uint8_t)(std::min(127, std::max(-128, (int)row[k])) + 128);
  }
}

// jdsample.c's upsamplers onto a full-size plane of W × H. Context rows
// above the first row and below the last real row repeat those rows
// (jdmainct.c); the first and last columns repeat likewise. ``fancy``:
// libjpeg's do_fancy (off in lossless mode, where blocks are one sample);
// every other integral ratio replicates (h2v1_upsample, h2v2_upsample,
// int_upsample).
void upsample(const JComp& c, const uint8_t* src, int sstride, int hr, int vr, int W, int H,
              bool fancy, std::vector<uint8_t>& dst) {
  dst.assign((size_t)W * H, 0);
  const int cw = c.dw, chh = c.dh;
  auto at = [&](int y, int x) -> int {
    y = std::min(std::max(y, 0), chh - 1);
    x = std::min(std::max(x, 0), cw - 1);
    return src[(size_t)y * sstride + x];
  };
  const bool fancy_h = fancy && cw > 2;
  for (int oy = 0; oy < H; ++oy) {
    uint8_t* o = dst.data() + (size_t)oy * W;
    const int cy = oy / vr;
    if (hr == 1 && vr == 1) {
      for (int ox = 0; ox < W; ++ox) o[ox] = (uint8_t)at(cy, ox);
    } else if (hr == 2 && vr == 1 && fancy_h) {  // h2v1_fancy_upsample
      for (int ox = 0; ox < W; ++ox) {
        const int cx = ox >> 1, t = at(cy, cx) * 3;
        o[ox] = (uint8_t)(ox & 1 ? (t + at(cy, cx + 1) + 2) >> 2 : (t + at(cy, cx - 1) + 1) >> 2);
      }
    } else if (hr == 1 && vr == 2 && fancy) {  // h1v2_fancy_upsample
      const int far = oy & 1 ? cy + 1 : cy - 1, bias = oy & 1 ? 2 : 1;
      for (int ox = 0; ox < W; ++ox) o[ox] = (uint8_t)((at(cy, ox) * 3 + at(far, ox) + bias) >> 2);
    } else if (hr == 2 && vr == 2 && fancy_h) {  // h2v2_fancy_upsample
      const int far = oy & 1 ? cy + 1 : cy - 1;
      auto colsum = [&](int x) { return at(cy, x) * 3 + at(far, x); };
      for (int ox = 0; ox < W; ++ox) {
        const int cx = ox >> 1, t = colsum(cx) * 3;
        o[ox] = (uint8_t)(ox & 1 ? (t + colsum(cx + 1) + 7) >> 4 : (t + colsum(cx - 1) + 8) >> 4);
      }
    } else {  // box replication
      for (int ox = 0; ox < W; ++ox) o[ox] = (uint8_t)at(cy, ox / hr);
    }
  }
}

// jdcoefct.c's decompress_smooth_data (libjpeg-turbo 2.1 and later): a
// progressive component whose first AC coefficients (zigzag 1-9) are not
// all known to full precision gets estimates of the zero ones from the
// 5×5 neighbourhood of DC values, and its DC too when no AC coefficient
// was ever sent. Columns past the component's blocks repeat the edge;
// rows follow jdcoefct.c's numbering (``rows``).
struct Smoother {
  const JComp& c;
  int vs, total_imcu_rows;
  bool change_dc;
  const int* bits;  // coef_bits[0..9] of the component
  int64_t Q00 = 0, Q01 = 0, Q10 = 0, Q20 = 0, Q11 = 0, Q02 = 0, Q03 = 0, Q12 = 0, Q21 = 0,
          Q30 = 0;

  int dc(int by, int bx) const {  // a DC of the component's own block grid, edge repeated
    bx = std::min(std::max(bx, 0), c.width_in_blocks - 1);
    return c.coef[((size_t)by * c.bw + bx) * 64];
  }
  static int estimate(int64_t num, int64_t q, int al) {
    int pred;
    if (num >= 0) {
      pred = (int)(((q << 7) + num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = (int)(((q << 7) - num) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return pred;
  }
  // the block rows that stand for rows −2..+2 of image block row ``row``.
  // jdcoefct.c numbers the rows as if every iMCU row held as many block
  // rows as the current one (``block_rows``, fewer in the last iMCU row),
  // so a row below the component's last (an MCU's padding) can be a
  // neighbour, and the last iMCU row's neighbours above can repeat.
  void rows(int row, int r[5]) const {
    const int imcu = row / vs, b = row % vs;
    int block_rows = vs;
    if (imcu == total_imcu_rows - 1) {
      block_rows = c.height_in_blocks % vs;
      if (block_rows == 0) block_rows = vs;
    }
    const int image_row = imcu * block_rows + b, image_rows = block_rows * total_imcu_rows;
    r[2] = row;
    r[1] = image_row > 0 ? row - 1 : row;
    r[0] = image_row > 1 ? row - 2 : r[1];
    r[3] = image_row < image_rows - 1 ? row + 1 : row;
    r[4] = image_row < image_rows - 2 ? row + 2 : r[3];
  }
  void block(int by, int bx, int16_t* w) const {
    int r[5];
    rows(by, r);
    int DC[26];  // DC01..DC25, row-major over rows −2..+2 and columns −2..+2
    for (int i = 0; i < 5; ++i)
      for (int j = 0; j < 5; ++j) DC[1 + 5 * i + j] = dc(r[i], bx - 2 + j);
    const int DC01 = DC[1], DC02 = DC[2], DC03 = DC[3], DC04 = DC[4], DC05 = DC[5];
    const int DC06 = DC[6], DC07 = DC[7], DC08 = DC[8], DC09 = DC[9], DC10 = DC[10];
    const int DC11 = DC[11], DC12 = DC[12], DC13 = DC[13], DC14 = DC[14], DC15 = DC[15];
    const int DC16 = DC[16], DC17 = DC[17], DC18 = DC[18], DC19 = DC[19], DC20 = DC[20];
    const int DC21 = DC[21], DC22 = DC[22], DC23 = DC[23], DC24 = DC[24], DC25 = DC[25];
    int al;
    if ((al = bits[1]) != 0 && w[1] == 0) {  // AC01
      const int64_t num = Q00 * (change_dc
          ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
             3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
             13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
          : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
      w[1] = (int16_t)estimate(num, Q01, al);
    }
    if ((al = bits[2]) != 0 && w[8] == 0) {  // AC10
      const int64_t num = Q00 * (change_dc
          ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 + 38 * DC08 +
             13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
             3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
          : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
      w[8] = (int16_t)estimate(num, Q10, al);
    }
    if ((al = bits[3]) != 0 && w[16] == 0) {  // AC20
      const int64_t num = Q00 * (change_dc
          ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
             2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
          : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
      w[16] = (int16_t)estimate(num, Q20, al);
    }
    if ((al = bits[4]) != 0 && w[9] == 0) {  // AC11
      const int64_t num = Q00 * (change_dc
          ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25)
          : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 - DC06 +
             10 * DC07 - 10 * DC09));
      w[9] = (int16_t)estimate(num, Q11, al);
    }
    if ((al = bits[5]) != 0 && w[2] == 0) {  // AC02
      const int64_t num = Q00 * (change_dc
          ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
             2 * DC17 - 5 * DC18 + 2 * DC19)
          : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
      w[2] = (int16_t)estimate(num, Q02, al);
    }
    if (change_dc) {
      if ((al = bits[6]) != 0 && w[3] == 0)  // AC03
        w[3] = (int16_t)estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
      if ((al = bits[7]) != 0 && w[10] == 0)  // AC12
        w[10] = (int16_t)estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
      if ((al = bits[8]) != 0 && w[17] == 0)  // AC21
        w[17] = (int16_t)estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
      if ((al = bits[9]) != 0 && w[24] == 0)  // AC30
        w[24] = (int16_t)estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
      const int64_t num = Q00 *
          (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
           42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
           8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 - 2 * DC21 -
           6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
      w[0] = (int16_t)estimate(num, Q00, 0);
    }
  }
};

// jdcolor.c's build_ycc_rgb_table and ycc_rgb_convert
struct YccTable {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTable() {
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + 32768) >> 16);
      cb_b[i] = (int)((116130 * x + 32768) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + 32768;
    }
  }
  static int clamp(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
  void rgb(int y, int cb, int cr, int& r, int& g, int& b) const {
    r = clamp(y + cr_r[cr]);
    g = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
    b = clamp(y + cb_b[cb]);
  }
};

const YccTable& ycc_table() {
  static const YccTable table;
  return table;
}

struct JpegDecoder {
  const uint8_t* d;
  size_t n, pos = 0;
  JpegDecoder(const uint8_t* data, size_t size) : d(data), n(size) {}
  uint16_t qt[4][64];  // natural order
  bool qt_present[4] = {false, false, false, false};
  JHuff dc[4], ac[4];
  uint8_t arith_L[16], arith_U[16], arith_K[16];  // DAC conditioning
  std::vector<JComp> comps;
  int W = 0, H = 0, hmax = 1, vmax = 1, restart_interval = 0;
  int mcux = 0, mcuy = 0, precision = 8;
  bool frame = false, progressive = false, arith = false, lossless = false;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  // the arithmetic decoder's statistics (jdarith.c)
  uint8_t dc_stats[16][64], ac_stats[16][256], fixed_bin = 113;
  // a strip or tile of a TIFF (libtiff's JPEG codecs): any 1-4 components,
  // the colour space the caller's, a wrong precision libtiff's error
  bool tiff = false;
  // TIFF's JPEGTables: DQT and DHT segments to EOI, kept for the strips
  bool tables_only = false;
  // the scans read, whether the first made it an image of several scans
  // (which must reach EOI), and whether EOI was read
  int scans = 0;
  bool multi = false, eoi = false;

  int u16(size_t p) const { return (d[p] << 8) | d[p + 1]; }

  // the frame (get_sof's fields from f: precision, height, width, the
  // components), with jdinput.c's initial_setup checks
  int read_frame(const uint8_t* f, int marker) {
    precision = f[0];
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker >= 0xC9;
    lossless = marker == 0xC3 || marker == 0xCB;
    H = f[1] << 8 | f[2];
    W = f[3] << 8 | f[4];
    const int nc = f[5];
    // PIL's JpegImagePlugin refuses these at its own SOF: precision
    // other than 8 bits, and other component counts than 1, 3 or 4
    // (libtiff: "Improper JPEG data precision", "component count")
    if (precision != 8) return tiff ? kCorrupt : kPrecision;
    if (tiff ? (nc < 1 || nc > 4) : (nc != 1 && nc != 3 && nc != 4))
      return tiff ? kCorrupt : kComponents;
    if (W > 65500 || H > 65500) return kCorrupt;  // JERR_IMAGE_TOO_BIG
    if (lossless && arith) return kArithLossless;
    comps.assign(nc, JComp());
    hmax = vmax = 1;
    for (int i = 0; i < nc; ++i) {
      JComp& c = comps[i];
      c.id = f[6 + 3 * i];
      c.h = f[7 + 3 * i] >> 4;
      c.v = f[7 + 3 * i] & 15;
      c.tq = f[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return kCorrupt;  // JERR_BAD_SAMPLING
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    for (JComp& c : comps)
      if (hmax % c.h || vmax % c.v) return kFractional;  // jdsample.c refuses it
    const int unit = lossless ? 1 : 8;
    mcux = (W + unit * hmax - 1) / (unit * hmax);
    mcuy = (H + unit * vmax - 1) / (unit * vmax);
    for (JComp& c : comps) {
      c.dw = (int)(((int64_t)W * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)H * c.v + vmax - 1) / vmax);
      c.width_in_blocks = (c.dw + unit - 1) / unit;
      c.height_in_blocks = (c.dh + unit - 1) / unit;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      if (lossless) {
        c.diff.assign((size_t)c.bw * c.bh, 0);
        c.first_row.assign(c.bh, 0);
        c.first_row[0] = 1;
      } else {
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      }
    }
    frame = true;
    return kOk;
  }



  int eobrun = 0;  // a progressive AC scan's run of blocks that end at once

  // ------------------------------------------------------------ arithmetic
  // jdarith.c's decoder over the same source as the markers: a marker met
  // supplies zeros (unread_marker), a byte past the file fails (libjpeg's
  // JERR_CANT_SUSPEND), and a bad code (a magnitude or a spectral overflow)
  // stops the segment: its later MCUs are left as they are (ct = -1) until
  // a restart
  int64_t ar_c = 0, ar_a = 0;
  int ar_ct = -16;  // -16: two bytes to read into C first; -1: a bad code was met
  bool ar_eof = false;

  int arith_byte() {
    const int c = src_byte();
    if (c < 0) ar_eof = true;
    return c < 0 ? 0 : c;
  }
  int arith_decode(uint8_t* st) {
    while (ar_a < 0x8000) {
      if (--ar_ct < 0) {
        int data = 0;
        if (!unread_marker) {
          data = arith_byte();
          if (data == 0xFF) {  // a stuffed zero or a marker
            do data = arith_byte();
            while (data == 0xFF && !ar_eof);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker = data;
              data = 0;
            }
          }
        }
        ar_c = (ar_c << 8) | data;
        if ((ar_ct += 8) < 0)
          if (++ar_ct == 0) ar_a = 0x8000;  // two initial bytes read: A = 0x10000 below
      }
      ar_a <<= 1;
    }
    int sv = *st;
    const uint32_t e = kAritab[sv & 0x7F];
    const int nl = e & 0xFF, nm = (e >> 8) & 0xFF;
    const int64_t qe = e >> 16;
    int64_t temp = ar_a - qe;
    ar_a = temp;
    temp <<= ar_ct;
    if (ar_c >= temp) {
      ar_c -= temp;
      if (ar_a < qe) {  // conditional exchange: the MPS
        ar_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        ar_a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (ar_a < 0x8000) {
      if (ar_a < qe) {  // conditional exchange: the LPS
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // a DC difference into last (masked to 16 bits); false at a bad code
  bool arith_dc(JComp& c, int& last) {
    uint8_t* base = dc_stats[c.td];
    uint8_t* st = base + c.dc_context;
    if (arith_decode(st) == 0) {
      c.dc_context = 0;
      return true;
    }
    const int sign = arith_decode(st + 1);
    st += 2 + sign;
    int m = arith_decode(st);
    if (m != 0) {
      st = base + 20;
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;  // a magnitude overflow
        ++st;
      }
    }
    if (m < (int)((1L << arith_L[c.td]) >> 1)) c.dc_context = 0;
    else if (m > (int)((1L << arith_U[c.td]) >> 1)) c.dc_context = 12 + sign * 4;
    else c.dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last = (last + v) & 0xffff;
    return true;
  }
  // one nonzero AC value's sign, magnitude category and bits (st: its S0 +
  // 2); false at a bad code
  bool arith_ac_value(uint8_t* st, uint8_t* base, int k, int tbl, int& v) {
    const int sign = arith_decode(&fixed_bin);
    int m = arith_decode(st);
    if (m != 0 && arith_decode(st)) {
      m <<= 1;
      st = base + (k <= arith_K[tbl] ? 189 : 217);
      while (arith_decode(st)) {
        if ((m <<= 1) == 0x8000) return false;  // a magnitude overflow
        ++st;
      }
    }
    v = m;
    st += 14;
    while (m >>= 1)
      if (arith_decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    return true;
  }
  bool arith_ac_first(JComp& c, int16_t* blk, int ss, int se, int al) {
    uint8_t* base = ac_stats[c.ta];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = base + 3 * (k - 1);
      if (arith_decode(st)) break;  // EOB
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;  // a spectral overflow
      }
      int v;
      if (!arith_ac_value(st + 2, base, k, c.ta, v)) return false;
      blk[kZigzag[k]] = (int16_t)((unsigned)v << al);
    }
    return true;
  }
  bool arith_ac_refine(JComp& c, int16_t* blk, int ss, int se, int al) {
    uint8_t* base = ac_stats[c.ta];
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kZigzag[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = base + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kZigzag[k];
        if (*coef) {
          if (arith_decode(st + 2)) *coef = (int16_t)(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (arith_decode(st + 1)) {
          *coef = (int16_t)(arith_decode(&fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;  // a spectral overflow
      }
    }
    return true;
  }
  // one MCU of an arithmetic scan: the restart (statistics and predictions
  // of the scan's kind reset, the coder restarted), then its blocks unless a
  // bad code stopped the segment (DC refinement decodes regardless)
  void arith_mcu(int16_t* const* blk, JComp* const* bc, int nblk, const std::vector<JComp*>& sc,
                 int ss, int se, int ah, int al) {
    const bool dc_first = !progressive || (ss == 0 && ah == 0);
    if (restart_interval) {
      if (restarts_to_go == 0) {
        if (!read_restart_marker()) ar_eof = true;  // JERR_CANT_SUSPEND
        for (JComp* c : sc) {
          if (dc_first) {
            std::memset(dc_stats[c->td], 0, 64);
            c->dc_pred = 0;
            c->dc_context = 0;
          }
          if (!progressive || ss) std::memset(ac_stats[c->ta], 0, 256);
        }
        ar_c = ar_a = 0;
        ar_ct = -16;
        restarts_to_go = restart_interval;
      }
      --restarts_to_go;
    }
    const bool dc_refine = progressive && ss == 0 && ah != 0;
    if (ar_ct == -1 && !dc_refine) return;
    for (int b = 0; b < nblk; ++b) {
      JComp& c = *bc[b];
      bool ok = true;
      if (dc_refine) {
        if (arith_decode(&fixed_bin)) blk[b][0] = (int16_t)(blk[b][0] | (1 << al));
      } else if (dc_first) {
        ok = arith_dc(c, c.dc_pred);
        if (ok) blk[b][0] = (int16_t)((unsigned)c.dc_pred << (progressive ? al : 0));
        if (ok && !progressive) ok = arith_ac_first(c, blk[b], 1, 63, 0);
      } else {
        ok = ah == 0 ? arith_ac_first(c, blk[b], ss, se, al) : arith_ac_refine(c, blk[b], ss, se, al);
      }
      if (!ok) {
        ar_ct = -1;  // JWRN_ARITH_BAD_CODE
        return;
      }
    }
  }

  // ------------------------------------------- libjpeg's input side, byte by byte
  // Pillow hands libjpeg the file in reads of 65,536 bytes (ImageFile.load):
  // read_end is the end of what it has read so far. libjpeg suspends where
  // it needs a byte past it and Pillow reads on; at the file's end a
  // suspension is final ("image file is truncated"). libtiff instead
  // answers every read past a strip's end with a fake EOI (FF D9).
  static constexpr int kSuspend = -3;  // inside parse(): suspended at the data's end
  size_t read_end = 65536;
  int fake_eoi = 0;
  int unread_marker = 0;     // cinfo->unread_marker
  int next_restart_num = 0;  // the RSTn the entropy decoder expects next
  bool saw_sof = false;

  // jdarith.c cannot suspend: a byte past Pillow's read fails (it is read
  // only if the scan needs it, so an arithmetic scan past 65,536 bytes
  // fails in PIL)
  bool no_suspend = false;

  // INPUT_BYTE: 0-255, or -1 where libjpeg suspends at the file's end (in
  // an arithmetic scan, at the end of Pillow's read)
  int src_byte() {
    if (pos >= n) {
      if (!tiff) return -1;
      return (fake_eoi++ & 1) ? 0xD9 : 0xFF;
    }
    if (pos >= read_end && no_suspend) return -1;
    while (pos >= read_end) read_end += 65536;
    return d[pos++];
  }
  int src_2bytes() {
    const int a = src_byte();
    if (a < 0) return -1;
    const int b = src_byte();
    return b < 0 ? -1 : (a << 8 | b);
  }
  // Pillow's skip_input_data: past the data a suspension follows (libtiff:
  // its fake EOI)
  void src_skip(int64_t k) {
    if (k <= 0) return;
    pos = tiff ? std::min(pos + (size_t)k, n) : pos + (size_t)k;
    if (pos < n) while (pos >= read_end) read_end += 65536;
  }

  // jdmarker.c's next_marker: garbage skipped to FF, FF fill, a marker code
  int next_marker() {
    for (;;) {
      int c = src_byte();
      if (c < 0) return kSuspend;
      while (c != 0xFF) {
        if ((c = src_byte()) < 0) return kSuspend;
      }
      do {
        if ((c = src_byte()) < 0) return kSuspend;
      } while (c == 0xFF);
      if (c != 0) {
        unread_marker = c;
        return kOk;
      }
    }
  }

  // skip_variable (COM, DNL, the APPn libjpeg does not examine)
  int skip_variable() {
    const int len = src_2bytes();
    if (len < 0) return kSuspend;
    src_skip(len - 2);
    return kOk;
  }

  // get_interesting_appn: APP0 (JFIF) and APP14 (Adobe), 14 bytes examined
  int get_appn(int m) {
    int64_t len = src_2bytes();
    if (len < 0) return kSuspend;
    len -= 2;
    const int k = len >= 14 ? 14 : len > 0 ? (int)len : 0;
    uint8_t b[14];
    for (int i = 0; i < k; ++i) {
      const int c = src_byte();
      if (c < 0) return kSuspend;
      b[i] = (uint8_t)c;
    }
    len -= k;
    if (m == 0xE0 && k >= 14 && !std::memcmp(b, "JFIF\0", 5)) jfif = true;
    if (m == 0xEE && k >= 12 && !std::memcmp(b, "Adobe", 5)) {
      adobe = true;
      adobe_transform = b[11];
    }
    src_skip(len);
    return kOk;
  }

  int get_dri() {
    const int len = src_2bytes();
    if (len < 0) return kSuspend;
    if (len != 4) return kCorrupt;  // JERR_BAD_LENGTH
    const int ri = src_2bytes();
    if (ri < 0) return kSuspend;
    restart_interval = ri;
    return kOk;
  }

  // get_dqt: each table reads its 64 entries (16-bit for any nonzero
  // precision nibble) wherever the segment ends; a length left over fails
  int get_dqt() {
    int64_t len = src_2bytes();
    if (len < 0) return kSuspend;
    len -= 2;
    while (len > 0) {
      const int c = src_byte();
      if (c < 0) return kSuspend;
      const int prec = c >> 4, tq = c & 15;
      if (tq >= 4) return kCorrupt;  // JERR_DQT_INDEX
      for (int k = 0; k < 64; ++k) {
        const int v = prec ? src_2bytes() : src_byte();
        if (v < 0) return kSuspend;
        qt[tq][kZigzag[k]] = (uint16_t)v;
      }
      qt_present[tq] = true;
      len -= 65;
      if (prec) len -= 64;
    }
    return len ? kCorrupt : kOk;  // JERR_BAD_LENGTH
  }

  // get_dht: the tables as stored; jdhuff.c checks a table when a scan uses it
  int get_dht() {
    int64_t len = src_2bytes();
    if (len < 0) return kSuspend;
    len -= 2;
    while (len > 16) {
      const int index = src_byte();
      if (index < 0) return kSuspend;
      uint8_t counts[16], vals[256];
      int count = 0;
      for (int i = 0; i < 16; ++i) {
        const int c = src_byte();
        if (c < 0) return kSuspend;
        counts[i] = (uint8_t)c;
        count += c;
      }
      len -= 17;
      if (count > 256 || count > len) return kCorrupt;  // JERR_BAD_HUFF_TABLE
      for (int i = 0; i < count; ++i) {
        const int c = src_byte();
        if (c < 0) return kSuspend;
        vals[i] = (uint8_t)c;
      }
      len -= count;
      const bool is_ac = index & 0x10;
      const int th = is_ac ? index - 0x10 : index;
      if (th >= 4) return kCorrupt;  // JERR_DHT_INDEX
      (is_ac ? ac[th] : dc[th]).build(counts, vals, count);
    }
    return len ? kCorrupt : kOk;  // JERR_BAD_LENGTH
  }

  int get_dac() {
    int64_t len = src_2bytes();
    if (len < 0) return kSuspend;
    len -= 2;
    while (len > 0) {
      const int index = src_byte();
      if (index < 0) return kSuspend;
      const int val = src_byte();
      if (val < 0) return kSuspend;
      len -= 2;
      if (index >= 32) return kCorrupt;  // JERR_DAC_INDEX
      if (index >= 16) {
        if (val < 1 || val > 63) return kCorrupt;
        arith_K[index - 16] = (uint8_t)val;
      } else {
        arith_L[index] = (uint8_t)(val & 15);
        arith_U[index] = (uint8_t)(val >> 4);
        if (arith_L[index] > arith_U[index]) return kCorrupt;  // JERR_DAC_VALUE
      }
    }
    return len ? kCorrupt : kOk;
  }

  // get_sof, then the frame's components (jdinput.c's initial_setup checks
  // the port makes at the frame)
  int get_sof(int marker) {
    if (saw_sof) return kCorrupt;  // JERR_SOF_DUPLICATE
    const int len = src_2bytes();
    if (len < 0) return kSuspend;
    int prec = src_byte(), h = src_2bytes(), w = h < 0 ? -1 : src_2bytes();
    const int nc = w < 0 ? -1 : src_byte();
    if (prec < 0 || h < 0 || w < 0 || nc < 0) return kSuspend;
    if (h == 0 && w > 0 && nc > 0 && len - 8 == nc * 3 && !tiff && prec == 8)
      return kDNL;  // libjpeg-turbo: "Empty JPEG image (DNL not supported)"
    if (h <= 0 || w <= 0 || nc <= 0) return kCorrupt;  // JERR_EMPTY_IMAGE
    if (len - 8 != nc * 3) return kCorrupt;  // JERR_BAD_LENGTH
    uint8_t f[8 + 3 * 255];
    f[0] = (uint8_t)prec;
    f[1] = (uint8_t)(h >> 8);
    f[2] = (uint8_t)h;
    f[3] = (uint8_t)(w >> 8);
    f[4] = (uint8_t)w;
    f[5] = (uint8_t)nc;
    for (int i = 0; i < 3 * nc; ++i) {
      const int c = src_byte();
      if (c < 0) return kSuspend;
      f[6 + i] = (uint8_t)c;
    }
    saw_sof = true;
    return read_frame(f, marker);
  }

  // ------------------------------------ jdhuff.c / jdphuff.c's bit reading
  // get_buffer / bits_left; a marker met stops the reading (unread_marker)
  // and zeros are stuffed where bits are wanted past it, once marking the
  // segment's data insufficient: its later MCUs are then left as they are
  uint64_t get_buffer = 0;
  int bits_left = 0;
  bool insufficient = false;
  int restarts_to_go = 0;

  // jpeg_fill_bit_buffer: up to 57 bits, a marker, or a suspension (false)
  bool fill_bits(int nbits) {
    if (unread_marker == 0) {
      while (bits_left < 57) {
        int c = src_byte();
        if (c < 0) return false;
        if (c == 0xFF) {
          do {
            if ((c = src_byte()) < 0) return false;
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker = c;
            goto no_more_bytes;
          }
        }
        get_buffer = (get_buffer << 8) | (uint64_t)c;
        bits_left += 8;
      }
      return true;
    }
  no_more_bytes:
    if (nbits > bits_left) {
      insufficient = true;  // JWRN_HIT_MARKER
      get_buffer <<= 57 - bits_left;
      bits_left = 57;
    }
    return true;
  }
  bool check_bits(int nbits) { return bits_left >= nbits || fill_bits(nbits); }
  int get_bits(int nbits) {
    bits_left -= nbits;
    return (int)(get_buffer >> bits_left) & ((1 << nbits) - 1);
  }
  // HUFF_DECODE with jpeg_huff_decode: a symbol, or -1 where it suspended
  int huff_decode(const JHuff& t) {
    int nb;
    if (bits_left < 8) {
      if (!fill_bits(0)) return -1;
      if (bits_left < 8) {
        nb = 1;
        goto slow;
      }
    }
    {
      const int e = t.look8[(get_buffer >> (bits_left - 8)) & 255];
      nb = e >> 8;
      if (nb <= 8) {
        bits_left -= nb;
        return e & 255;
      }
    }
  slow:
    if (!check_bits(nb)) return -1;
    int32_t code = get_bits(nb);
    while (code > t.maxcode[nb]) {
      code <<= 1;
      if (!check_bits(1)) return -1;
      code |= get_bits(1);
      ++nb;
    }
    if (nb > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero
    return t.vals[code + t.valptr[nb]];
  }

  // the state an MCU starts from, for decode_mcu_fast's own copy and for a
  // retry after libjpeg suspended at one of Pillow's read ends
  struct LjSaved {
    size_t pos, read_end;
    uint64_t get_buffer;
    int bits_left, unread_marker, next_restart_num, restarts_to_go, eobrun, fake_eoi;
    bool insufficient;
    int dc_pred[4];
  };
  LjSaved lj_save(const std::vector<JComp*>& sc) const {
    LjSaved s{pos, read_end, get_buffer, bits_left, unread_marker, next_restart_num,
              restarts_to_go, eobrun, fake_eoi, insufficient, {0, 0, 0, 0}};
    for (size_t i = 0; i < sc.size(); ++i) s.dc_pred[i] = sc[i]->dc_pred;
    return s;
  }
  void lj_restore(const LjSaved& s, const std::vector<JComp*>& sc) {
    pos = s.pos;
    read_end = s.read_end;
    get_buffer = s.get_buffer;
    bits_left = s.bits_left;
    unread_marker = s.unread_marker;
    next_restart_num = s.next_restart_num;
    restarts_to_go = s.restarts_to_go;
    eobrun = s.eobrun;
    fake_eoi = s.fake_eoi;
    insufficient = s.insufficient;
    for (size_t i = 0; i < sc.size(); ++i) sc[i]->dc_pred = s.dc_pred[i];
  }

  // jpeg_resync_to_restart, the source manager's (Pillow's and libtiff's)
  int resync_to_restart(int desired) {
    int marker = unread_marker;
    for (;;) {
      int action;
      if (marker < 0xC0) action = 2;  // an invalid marker
      else if (marker < 0xD0 || marker > 0xD7) action = 3;  // a valid non-restart marker
      else if (marker == 0xD0 + ((desired + 1) & 7) || marker == 0xD0 + ((desired + 2) & 7))
        action = 3;  // one of the next two expected restarts
      else if (marker == 0xD0 + ((desired - 1) & 7) || marker == 0xD0 + ((desired - 2) & 7))
        action = 2;  // a prior restart: advance
      else
        action = 1;  // the desired restart, or too far away
      if (action == 1) {
        unread_marker = 0;
        return kOk;
      }
      if (action == 3) return kOk;  // the next segment is left empty
      const int rc = next_marker();
      if (rc) return rc;
      marker = unread_marker;
    }
  }

  // read_restart_marker: the RSTn expected, or a resync; false where it suspended
  bool read_restart_marker() {
    if (unread_marker == 0 && next_marker()) return false;
    if (unread_marker == 0xD0 + next_restart_num) unread_marker = 0;
    else if (resync_to_restart(next_restart_num)) return false;
    next_restart_num = (next_restart_num + 1) & 7;
    return true;
  }

  // process_restart: the buffered bits dropped, the RSTn read (or resynced),
  // DC predictions and the EOB run reset
  bool process_restart(const std::vector<JComp*>& sc) {
    bits_left = 0;
    if (!read_restart_marker()) return false;
    for (JComp* c : sc) c->dc_pred = 0;
    eobrun = 0;
    restarts_to_go = restart_interval;
    if (unread_marker == 0) insufficient = false;
    return true;
  }

  // decode_mcu_fast (jdhuff.c): 6 bytes at a time while 16 bits or fewer
  // remain, no suspension (libjpeg takes it while 512 bytes a block are
  // left in Pillow's buffer); false where a marker turned up, and the MCU is
  // decoded again the slow way from its start
  bool seq_mcu_fast(int16_t* const* blk, JComp* const* bc, int nblk) {
    uint64_t gb = get_buffer;
    int bl = bits_left;
    size_t p = pos;
    int marker = 0;
    int dcp[4];
    JComp* owner[4] = {nullptr, nullptr, nullptr, nullptr};
    int owners = 0;
    auto pred = [&](JComp* c) -> int& {
      for (int i = 0; i < owners; ++i)
        if (owner[i] == c) return dcp[i];
      owner[owners] = c;
      dcp[owners] = c->dc_pred;
      return dcp[owners++];
    };
    auto get_byte = [&]() {
      const int c0 = d[p++];
      const int c1 = p < n ? d[p] : 0;
      gb = (gb << 8) | (uint64_t)c0;
      bl += 8;
      if (c0 == 0xFF) {
        ++p;
        if (c1 != 0) {
          marker = c1;
          p -= 2;
          gb &= ~(uint64_t)0xFF;
        }
      }
    };
    auto fill = [&]() {
      if (bl <= 16)
        for (int i = 0; i < 6; ++i) get_byte();
    };
    auto getb = [&](int k) {
      bl -= k;
      return (int)(gb >> bl) & ((1 << k) - 1);
    };
    auto decode = [&](const JHuff& t) {
      fill();
      int s = t.look8[(gb >> (bl - 8)) & 255];
      int nb = s >> 8;
      bl -= nb;
      s &= 255;
      if (nb > 8) {
        s = (int)(gb >> bl) & ((1 << nb) - 1);
        while (s > t.maxcode[nb]) {
          s <<= 1;
          s |= getb(1);
          ++nb;
        }
        s = nb > 16 ? 0 : t.vals[(s + t.valptr[nb]) & 0xFF];
      }
      return s;
    };
    for (int b = 0; b < nblk; ++b) {
      JComp& c = *bc[b];
      int s = decode(dc[c.td]);
      if (s) {
        fill();
        s = extend(getb(s), s);
      }
      int& last = pred(&c);
      last = (int)((unsigned)last + (unsigned)s);
      blk[b][0] = (int16_t)last;
      const JHuff& t = ac[c.ta];
      for (int k = 1; k < 64; ++k) {
        s = decode(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          fill();
          blk[b][kZigzag[k]] = (int16_t)extend(getb(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    if (marker) return false;  // cinfo->unread_marker is reset to 0
    pos = p;
    get_buffer = gb;
    bits_left = bl;
    for (int i = 0; i < owners; ++i) owner[i]->dc_pred = dcp[i];
    return true;
  }

  // decode_mcu_slow: false where it suspended
  bool seq_mcu_slow(int16_t* const* blk, JComp* const* bc, int nblk) {
    for (int b = 0; b < nblk; ++b) {
      JComp& c = *bc[b];
      int s = huff_decode(dc[c.td]);
      if (s < 0) return false;
      if (s) {
        if (!check_bits(s)) return false;
        s = extend(get_bits(s), s);
      }
      c.dc_pred = (int)((unsigned)c.dc_pred + (unsigned)s);
      blk[b][0] = (int16_t)c.dc_pred;
      const JHuff& t = ac[c.ta];
      for (int k = 1; k < 64; ++k) {
        s = huff_decode(t);
        if (s < 0) return false;
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          if (!check_bits(s)) return false;
          blk[b][kZigzag[k]] = (int16_t)extend(get_bits(s), s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    return true;
  }

  // decode_mcu_DC_first, _AC_first, _DC_refine, _AC_refine (jdphuff.c)
  bool prog_mcu(int16_t* const* blk, JComp* const* bc, int nblk, int ss, int se, int ah, int al) {
    if (ss == 0 && ah == 0) {  // DC first
      if (insufficient) return true;
      for (int b = 0; b < nblk; ++b) {
        int s = huff_decode(dc[bc[b]->td]);
        if (s < 0) return false;
        if (s) {
          if (!check_bits(s)) return false;
          s = extend(get_bits(s), s);
        }
        JComp& c = *bc[b];
        c.dc_pred = (int)((unsigned)c.dc_pred + (unsigned)s);
        blk[b][0] = (int16_t)((unsigned)c.dc_pred << al);
      }
      return true;
    }
    if (ss == 0) {  // DC refine: no check of insufficient data
      for (int b = 0; b < nblk; ++b) {
        if (!check_bits(1)) return false;
        if (get_bits(1)) blk[b][0] = (int16_t)(blk[b][0] | (1 << al));
      }
      return true;
    }
    if (insufficient) return true;
    int16_t* block = blk[0];
    const JHuff& t = ac[bc[0]->ta];
    if (ah == 0) {  // AC first
      if (eobrun > 0) {
        --eobrun;
        return true;
      }
      for (int k = ss; k <= se; ++k) {
        int s = huff_decode(t);
        if (s < 0) return false;
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          if (!check_bits(s)) return false;
          block[kZigzag[k]] = (int16_t)((unsigned)extend(get_bits(s), s) << al);
        } else if (r == 15) {
          k += 15;
        } else {
          int run = 1 << r;
          if (r) {
            if (!check_bits(r)) return false;
            run += get_bits(r);
          }
          eobrun = run - 1;
          break;
        }
      }
      return true;
    }
    // AC refine
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    int newnz[64], num_newnz = 0;
    auto undo = [&]() {
      while (num_newnz > 0) block[newnz[--num_newnz]] = 0;
      return false;
    };
    auto correct = [&](int16_t* coef) {
      if (!check_bits(1)) return false;
      if (get_bits(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
      return true;
    };
    int run = eobrun;
    if (run == 0) {
      for (; k <= se; ++k) {
        int s = huff_decode(t);
        if (s < 0) return undo();
        int r = s >> 4;
        s &= 15;
        if (s) {
          if (!check_bits(1)) return undo();
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          run = 1 << r;
          if (r) {
            if (!check_bits(r)) return undo();
            run += get_bits(r);
          }
          break;
        }
        do {
          int16_t* coef = block + kZigzag[k];
          if (*coef != 0) {
            if (!correct(coef)) return undo();
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) {
          const int at = kZigzag[k];
          block[at] = (int16_t)s;
          newnz[num_newnz++] = at;
        }
      }
    }
    if (run > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = block + kZigzag[k];
        if (*coef != 0 && !correct(coef)) return undo();
      }
      --run;
    }
    eobrun = run;
    return true;
  }

  // decode_mcu of a Huffman DCT scan: the restart first, then (unless the
  // segment's data ran out) the MCU; false where libjpeg suspended
  bool huff_mcu(int16_t* const* blk, JComp* const* bc, int nblk, const std::vector<JComp*>& sc,
                int ss, int se, int ah, int al) {
    bool usefast = !progressive;
    if (restart_interval) {
      if (restarts_to_go == 0 && !process_restart(sc)) return false;
      usefast = false;
    }
    const int64_t in_buffer = (int64_t)std::min(read_end, n) - (int64_t)pos;
    if (in_buffer < 512 * (int64_t)nblk || unread_marker) usefast = false;
    bool ok;
    if (progressive) {
      ok = prog_mcu(blk, bc, nblk, ss, se, ah, al);
    } else {
      ok = insufficient || (usefast && seq_mcu_fast(blk, bc, nblk)) || seq_mcu_slow(blk, bc, nblk);
    }
    if (!ok) return false;
    if (restart_interval) --restarts_to_go;
    return true;
  }

  // ------------------------------------------------------------------ scans
  // get_sos: the scan's components as libjpeg finds them (among the first
  // four of the frame, each in a slot not yet taken), tables, Ss, Se, Ah, Al
  int get_sos(std::vector<JComp*>& sc, int& ss, int& se, int& ah, int& al) {
    if (!saw_sof) return kCorrupt;  // JERR_SOS_NO_SOF
    const int len = src_2bytes();
    if (len < 0) return kSuspend;
    const int ns = src_byte();
    if (ns < 0) return kSuspend;
    if (len != ns * 2 + 6 || ns < 1 || ns > 4) return kCorrupt;  // JERR_BAD_LENGTH
    JComp* slot[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < ns; ++i) {
      const int cc = src_byte();
      if (cc < 0) return kSuspend;
      const int t = src_byte();
      if (t < 0) return kSuspend;
      JComp* found = nullptr;
      for (int ci = 0; ci < (int)comps.size() && ci < 4; ++ci)
        if (cc == comps[ci].id && !slot[ci]) {
          found = &comps[ci];
          break;
        }
      if (!found) return kCorrupt;  // JERR_BAD_COMPONENT_ID
      slot[i] = found;
      found->td = t >> 4;
      found->ta = t & 15;
      for (int pi = 0; pi < i; ++pi)
        if (slot[pi] == found) return kCorrupt;
    }
    const int s0 = src_byte(), s1 = s0 < 0 ? -1 : src_byte(), s2 = s1 < 0 ? -1 : src_byte();
    if (s2 < 0) return kSuspend;
    ss = s0;
    se = s1;
    ah = s2 >> 4;
    al = s2 & 15;
    next_restart_num = 0;
    sc.assign(slot, slot + ns);
    return kOk;
  }

  // a scan's data from pos: Huffman DCT scans as jdhuff.c and jdphuff.c read
  // them (MCU by MCU, again from the MCU's start where libjpeg suspended at
  // the end of one of Pillow's reads), arithmetic and lossless ones by their
  // own readers; pos ends where libjpeg looks for the next marker
  int run_scan(std::vector<JComp*>& sc, int ss, int se, int ah, int al) {
    const bool dc_band = ss == 0;
    if (lossless) {  // Ss: the predictor, Al: the point transform
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision) return kCorrupt;
    } else if (progressive) {  // jdphuff.c / jdarith.c's progression checks
      if (dc_band ? se != 0 : (ss > se || se > 63 || sc.size() != 1)) return kCorrupt;
      if (ah != 0 && al != ah - 1) return kCorrupt;
      if (al > 13) return kCorrupt;
    }
    const bool dc_scan = !progressive || (dc_band && ah == 0);
    const bool ac_scan = !progressive || !dc_band;
    for (JComp* c : sc) {
      if (arith) {
        if (c->td > 15 || c->ta > 15) return kCorrupt;
      } else {
        // only the tables the scan decodes with are looked up
        const bool dc_used = dc_scan || lossless, ac_used = ac_scan && !lossless;
        if ((dc_used && c->td > 3) || (ac_used && c->ta > 3))
          return kCorrupt;  // JERR_NO_HUFF_TABLE
        // an undefined table 0 or 1 of a sequential DCT scan is the standard
        // one (jdhuff.c's motion-JPEG default; jdphuff.c and jdlhuff.c have none)
        const bool defaults = !progressive && !lossless;
        if (defaults && dc_used && !dc[c->td].present && c->td < 2)
          dc[c->td].build(kStdCounts[c->td], kStdDcSymbols, 12);
        if (defaults && ac_used && !ac[c->ta].present && c->ta < 2)
          ac[c->ta].build(kStdCounts[2 + c->ta], kStdAcSymbols[c->ta], 162);
        if (dc_used && !(dc[c->td].present && dc[c->td].dc_ok(lossless)))
          return kCorrupt;  // "Bogus Huffman table definition"
        if (ac_used && !(ac[c->ta].present && !ac[c->ta].bogus)) return kCorrupt;
      }
      if (!lossless && !c->latched) {  // jdinput.c's latch_quant_tables
        if (c->tq > 3 || !qt_present[c->tq]) return kCorrupt;  // JERR_NO_QUANT_TABLE
        std::memcpy(c->q, qt[c->tq], sizeof(c->q));
        c->latched = true;
      }
      if (progressive)
        for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
      else if (!lossless)
        for (int k = 0; k < 64; ++k) c->coef_bits[k] = 0;
    }
    // the MCU: one data unit of the component when it is alone, else h × v of each
    const bool single = sc.size() == 1;
    if (!single) {
      int blocks = 0;
      for (JComp* c : sc) blocks += c->h * c->v;
      if (blocks > 10) return kMcuSize;  // libjpeg: "Sampling factors too large"
    }
    const int mx = single ? sc[0]->width_in_blocks : mcux;
    const int my = single ? sc[0]->height_in_blocks : mcuy;
    if (lossless && restart_interval && restart_interval % mx) return kCorrupt;

    for (JComp* c : sc) {
      c->dc_pred = 0;
      c->dc_context = 0;
    }
    eobrun = 0;
    if (arith) {
      for (JComp* c : sc) {
        if (dc_scan) std::memset(dc_stats[c->td], 0, 64);
        if (ac_scan) std::memset(ac_stats[c->ta], 0, 256);
      }
    }
    if (arith) {  // jdarith.c: the coder starts with two bytes to read
      ar_c = ar_a = 0;
      ar_ct = -16;
      ar_eof = false;
      no_suspend = true;
      restarts_to_go = restart_interval;
      std::vector<int16_t*> blk;
      std::vector<JComp*> bc;
      for (int y = 0; y < my; ++y) {
        for (int x = 0; x < mx; ++x) {
          blk.clear();
          bc.clear();
          for (JComp* c : sc) {
            const int nh = single ? 1 : c->h, nv = single ? 1 : c->v;
            for (int by = 0; by < nv; ++by)
              for (int bx = 0; bx < nh; ++bx) {
                const int row = y * nv + by, col = x * nh + bx;
                blk.push_back(c->coef.data() + ((size_t)row * c->bw + col) * 64);
                bc.push_back(c);
              }
          }
          arith_mcu(blk.data(), bc.data(), (int)blk.size(), sc, ss, se, ah, al);
        }
      }
      no_suspend = false;
      if (ar_eof) return kCorrupt;  // a byte past Pillow's read: JERR_CANT_SUSPEND
      if (scans++ == 0) multi = progressive || sc.size() < comps.size();
      return kOk;
    }
    if (!lossless) {
      bits_left = 0;
      get_buffer = 0;
      insufficient = false;
      restarts_to_go = restart_interval;
      std::vector<int16_t*> blk;
      std::vector<JComp*> bc;
      std::vector<int16_t> snap;
      for (int y = 0; y < my; ++y) {
        for (int x = 0; x < mx; ++x) {
          blk.clear();
          bc.clear();
          for (JComp* c : sc) {
            const int nh = single ? 1 : c->h, nv = single ? 1 : c->v;
            for (int by = 0; by < nv; ++by)
              for (int bx = 0; bx < nh; ++bx) {
                const int row = y * nv + by, col = x * nh + bx;
                blk.push_back(c->coef.data() + ((size_t)row * c->bw + col) * 64);
                bc.push_back(c);
              }
          }
          const int nblk = (int)blk.size();
          if (read_end >= n) {  // the whole file is in Pillow's buffer: no read ends ahead
            if (!huff_mcu(blk.data(), bc.data(), nblk, sc, ss, se, ah, al)) return kSuspend;
            continue;
          }
          for (;;) {
            const LjSaved saved = lj_save(sc);
            snap.resize((size_t)nblk * 64);
            for (int b = 0; b < nblk; ++b) std::memcpy(&snap[(size_t)b * 64], blk[b], 128);
            if (!huff_mcu(blk.data(), bc.data(), nblk, sc, ss, se, ah, al)) return kSuspend;
            if (read_end == saved.read_end) break;
            // libjpeg suspended where this MCU passed the end of Pillow's read,
            // and decodes it again once the next read is in the buffer
            const size_t re = read_end;
            lj_restore(saved, sc);
            read_end = re;
            for (int b = 0; b < nblk; ++b) std::memcpy(blk[b], &snap[(size_t)b * 64], 128);
          }
        }
      }
      if (scans++ == 0) multi = progressive || sc.size() < comps.size();
      return kOk;
    }
    // lossless scans: jdlhuff.c's decode_mcus, one MCU row at a time as
    // jddiffct.c calls it; a row that starts after the segment's data ran out
    // keeps zero differences, and a restart or such a row predicts the iMCU
    // row being read as a first row
    bits_left = 0;
    get_buffer = 0;
    insufficient = false;
    int rows_to_go = restart_interval / mx;
    auto reset_predictor = [&](int y) {
      for (JComp* c : sc) {
        const int row = y * (single ? 1 : c->v);
        c->first_row[(size_t)(row / c->v) * c->v] = 1;
      }
    };
    for (int y = 0; y < my; ++y) {
      if (restart_interval && rows_to_go == 0) {
        if (!process_restart(sc)) return kSuspend;
        reset_predictor(y);
        rows_to_go = restart_interval / mx;
      }
      const bool skip = insufficient;
      if (skip) reset_predictor(y);
      for (int x = 0; x < mx; ++x) {
        for (JComp* c : sc) {
          const int nh = single ? 1 : c->h, nv = single ? 1 : c->v;
          for (int by = 0; by < nv; ++by) {
            for (int bx = 0; bx < nh; ++bx) {
              int32_t& diff = c->diff[(size_t)(y * nv + by) * c->bw + x * nh + bx];
              if (skip) {
                diff = 0;
                continue;
              }
              int s = huff_decode(dc[c->td]);
              if (s < 0) return kSuspend;
              if (s == 16) {
                s = 32768;  // no bits follow
              } else if (s) {
                if (!check_bits(s)) return kSuspend;
                s = extend(get_bits(s), s);
              }
              diff = s;
            }
          }
        }
      }
      if (restart_interval) --rows_to_go;
    }
    for (JComp* c : sc) c->predictor = ss, c->point_transform = al;
    if (scans++ == 0) multi = progressive || sc.size() < comps.size();
    return kOk;
  }


  // jdlossls.c's undifferencing and jddiffct.c's scaling of one component
  void undifference(const JComp& c, std::vector<uint8_t>& plane) const {
    const int w = c.width_in_blocks;
    std::vector<int> prev(w), cur(w);
    plane.assign((size_t)c.bw * c.bh, 0);
    const int init = 1 << (precision - c.point_transform - 1);
    for (int y = 0; y < c.height_in_blocks; ++y) {
      const int32_t* df = c.diff.data() + (size_t)y * c.bw;
      if (c.first_row[y]) {
        int ra = (df[0] + init) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < w; ++x) cur[x] = ra = (df[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0];
        int ra = (df[0] + rb) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < w; ++x) {
          const int rc = rb;
          rb = prev[x];
          int pr;
          switch (c.predictor) {
            case 1: pr = ra; break;
            case 2: pr = rb; break;
            case 3: pr = rc; break;
            case 4: pr = ra + rb - rc; break;
            case 5: pr = ra + ((rb - rc) >> 1); break;
            case 6: pr = rb + ((ra - rc) >> 1); break;
            default: pr = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (df[x] + pr) & 0xFFFF;
        }
      }
      uint8_t* o = plane.data() + (size_t)y * c.bw;
      for (int x = 0; x < w; ++x) o[x] = (uint8_t)(cur[x] << c.point_transform);
      std::swap(prev, cur);
    }
  }

  // smoothing_ok (jdcoefct.c): a progressive file whose components all have
  // some DC and nonzero quantizers at the first ten zigzag positions, and
  // one of whose first nine AC coefficients is not known to full precision
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (const JComp& c : comps) {
      if (!c.latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.q[kZigzag[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // the DQT and DHT segments of an abbreviated tables-only stream (TIFF's
  // JPEGTables, libjpeg's jpeg_read_header(FALSE)): they stay for the
  // stream decoded next, whose own segments replace them
  int load_tables(const uint8_t* t, size_t tn) {
    JpegDecoder tab(t, tn);
    tab.tables_only = true;
    if (tab.parse()) return kCorrupt;  // no EOI, a frame or a scan: "Bogus JPEGTables field"
    for (int i = 0; i < 4; ++i) {
      if (tab.qt_present[i]) {
        std::memcpy(qt[i], tab.qt[i], sizeof(qt[i]));
        qt_present[i] = true;
      }
      if (tab.dc[i].present) dc[i] = tab.dc[i];
      if (tab.ac[i].present) ac[i] = tab.ac[i];
    }
    return kOk;
  }

  int decode(std::vector<uint8_t>& gray) {
    int rc = parse();
    if (rc) return rc;
    return to_gray(gray);
  }

  // the markers and scans as libjpeg reads them (jdmarker.c's read_markers,
  // jdinput.c's consume_markers): every component's coefficients (or
  // differences). A one-scan image is whole once its scan is decoded: what
  // follows it is read to EOI, where an error still fails and the data's end
  // (Pillow's finish suspending) does not; an image of several scans must
  // reach EOI
  int parse() {
    for (int i = 0; i < 16; ++i) {
      arith_L[i] = 0;
      arith_U[i] = 1;
      arith_K[i] = 5;
    }
    pos = 0;
    read_end = tiff ? (SIZE_MAX >> 1) : 65536;
    const int c0 = src_byte(), c1 = c0 < 0 ? -1 : src_byte();
    if (c0 != 0xFF || c1 != 0xD8) return kCorrupt;  // JERR_NO_SOI, or suspended
    unread_marker = 0;
    bool image_done = false;
    int rc = kOk;
    while (true) {
      if (unread_marker == 0 && (rc = next_marker())) break;
      const int m = unread_marker;
      if (m == 0xD9) {
        eoi = true;
        break;
      }
      if (tables_only && (m == 0xDA || (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC)))
        return kCorrupt;  // a frame or a scan in an abbreviated tables-only stream
      if (m == 0xD8) return kCorrupt;  // JERR_SOI_DUPLICATE
      if (m == 0xC8) return kCorrupt;  // JPG: JERR_SOF_UNSUPPORTED
      // SOF5-7 and SOF13-15: hierarchical (differential) frames
      if ((m >= 0xC5 && m <= 0xC7) || (m >= 0xCD && m <= 0xCF)) return kHierarchical;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
        rc = get_sof(m);
      } else if (m == 0xDA) {
        std::vector<JComp*> sc;
        int ss, se, ah, al;
        rc = get_sos(sc, ss, se, ah, al);
        if (!rc && scans && !multi) return kCorrupt;  // a second SOS: JERR_EOI_EXPECTED
        if (rc) break;
        unread_marker = 0;  // the SOS processed; the scan may stop at the next marker
        if ((rc = run_scan(sc, ss, se, ah, al))) break;
        if (!multi) image_done = true;
        continue;
      } else if (m == 0xCC) {
        rc = get_dac();
      } else if (m == 0xC4) {
        rc = get_dht();
      } else if (m == 0xDB) {
        rc = get_dqt();
      } else if (m == 0xDD) {
        rc = get_dri();
      } else if (m == 0xE0 || m == 0xEE) {
        rc = get_appn(m);
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        rc = skip_variable();  // APPn, COM, DNL
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        rc = kOk;  // TEM, RSTn: no parameters
      } else if (m == 0xDE) {
        return kHierarchical;  // DHP: libjpeg-turbo has no hierarchical mode
      } else {
        return kCorrupt;  // JERR_UNKNOWN_MARKER
      }
      if (rc) break;
      unread_marker = 0;
    }
    if (rc == kSuspend) return image_done ? kOk : kCorrupt;  // "image file is truncated"
    if (rc) return rc;
    if (tables_only) return kOk;
    if (!frame || !scans) return kCorrupt;
    return kOk;
  }


  // each component's samples at its own resolution (libjpeg's raw data):
  // the IDCT of every allocated block (smoothed where libjpeg-turbo
  // smooths), stride[ci] samples a row; lossless: the undifferenced samples
  void component_planes(std::vector<std::vector<uint8_t>>& planes, std::vector<int>& strides) {
    const size_t nc = comps.size();
    planes.assign(nc, {});
    strides.assign(nc, 0);
    const bool smooth = smoothing_ok();
    for (size_t ci = 0; ci < nc; ++ci) {
      JComp& c = comps[ci];
      std::vector<uint8_t>& plane = planes[ci];
      if (lossless) {
        strides[ci] = c.bw;
        undifference(c, plane);
        continue;
      }
      const int stride = strides[ci] = c.bw * 8;
      plane.assign((size_t)stride * c.bh * 8, 0);
      Smoother sm{c, c.v, mcuy, false, c.coef_bits};
      if (smooth) {
        const int* b = c.coef_bits;
        sm.change_dc = true;
        for (int k = 1; k < 10; ++k)
          if (b[k] != -1) sm.change_dc = false;
        const uint16_t* q = c.q;
        sm.Q00 = q[0], sm.Q01 = q[1], sm.Q10 = q[8], sm.Q20 = q[16], sm.Q11 = q[9];
        sm.Q02 = q[2], sm.Q03 = q[3], sm.Q12 = q[10], sm.Q21 = q[17], sm.Q30 = q[24];
      }
      int16_t work[64];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          const int16_t* blk = c.coef.data() + ((size_t)by * c.bw + bx) * 64;
          if (smooth && by < c.height_in_blocks && bx < c.width_in_blocks) {
            std::memcpy(work, blk, sizeof(work));
            sm.block(by, bx, work);
            blk = work;
          }
          idct_islow(blk, c.q, plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
        }
    }
  }

  // every component upsampled to W × H as jdsample.c does it
  void full_planes(std::vector<std::vector<uint8_t>>& full) {
    std::vector<std::vector<uint8_t>> planes;
    std::vector<int> strides;
    component_planes(planes, strides);
    full.assign(comps.size(), {});
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      const JComp& c = comps[ci];
      upsample(c, planes[ci].data(), strides[ci], hmax / c.h, vmax / c.v, W, H, !lossless,
               full[ci]);
    }
  }

  // PIL's convert("RGB") of the decoded image, interleaved: gray
  // replicated, YCbCr converted, CMYK (YCCK as libjpeg hands it: 255 − RGB,
  // K as is; or, with `ycck` false, four components taken as CMYK, as the
  // JPEG mode "CMYK" asks libjpeg) read as "CMYK;I" (inverted), then
  // cmyk2rgb (MULDIV255)
  int to_rgb(std::vector<uint8_t>& rgb, bool ycck = true) {
    // the colour space libjpeg-turbo assumes (jdapimin.c default_decompress_parms)
    const size_t nc = comps.size();
    enum { kGray, kYCbCr, kRGB, kCMYK, kYCCK } space = kGray;
    if (nc == 3) {
      const bool rgb_ids = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
      if (jfif) space = kYCbCr;
      else if (adobe) space = adobe_transform == 0 ? kRGB : kYCbCr;
      else if (rgb_ids || lossless) space = kRGB;  // lossless: "or RGB (lossless)"
      else space = kYCbCr;
    } else if (nc == 4) {
      space = ycck && adobe && adobe_transform != 0 ? kYCCK : kCMYK;
    }
    // lossless mode converts no colour
    if (lossless && (space == kYCbCr || space == kYCCK)) return kLosslessColour;

    std::vector<std::vector<uint8_t>> full;
    full_planes(full);
    const size_t npx = (size_t)W * H;
    rgb.assign(npx * 3, 0);
    const uint8_t* P0 = full[0].data();
    if (nc == 1) {
      for (size_t i = 0; i < npx; ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = P0[i];
      return kOk;
    }
    const YccTable& ycc = ycc_table();
    const uint8_t *P1 = full[1].data(), *P2 = full[2].data();
    for (size_t i = 0; i < npx; ++i) {
      int r = P0[i], g = P1[i], b = P2[i];
      if (space == kYCbCr || space == kYCCK) ycc.rgb(P0[i], P1[i], P2[i], r, g, b);
      if (nc == 4) {
        // libjpeg's CMYK: YCCK becomes 255 − RGB; then the raw mode's inversion
        const int c = space == kYCCK ? r : 255 - r, m = space == kYCCK ? g : 255 - g;
        const int y = space == kYCCK ? b : 255 - b;
        pil_cmyk_rgb(c, m, y, 255 - full[3][i], r, g, b);
      }
      rgb[3 * i] = (uint8_t)r;
      rgb[3 * i + 1] = (uint8_t)g;
      rgb[3 * i + 2] = (uint8_t)b;
    }
    return kOk;
  }

  int to_gray(std::vector<uint8_t>& gray) {
    if (comps.size() == 1) {
      std::vector<std::vector<uint8_t>> full;
      full_planes(full);
      gray.swap(full[0]);
      return kOk;
    }
    std::vector<uint8_t> rgb;
    const int rc = to_rgb(rgb);
    if (rc) return rc;
    gray.resize(rgb.size() / 3);
    for (size_t i = 0; i < gray.size(); ++i)
      gray[i] = pil_luma(rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
    return kOk;
  }
};

// JpegImageFile._open's walk over the markers up to SOS, as far as its
// errors that pass a file on (SyntaxError, IndexError, struct.error): a
// start other than FF D8 FF, a marker outside its table, a segment length
// or an APP0 JFIF / APP14 Adobe / APP13 Photoshop / ICC / SOF / DQT body
// its handler cannot index, the file ending between markers, no SOF
// before SOS; a segment cut short raises (kCorrupt). A depth other than 8
// or a component count other than 1, 3 or 4, and a height of 0, which pass
// the file on too, are left to the decoder, which refuses them by name.
int jpeg_open(const uint8_t* d, size_t n) {
  if (n < 3 || d[0] != 0xFF || d[1] != 0xD8 || d[2] != 0xFF) return kPassOn;  // "not a JPEG file"
  size_t pos = 3;
  int s0 = 0xFF;  // s = b"\xff"
  bool sof = false;
  int sof_w = 0, sof_h = 0;  // the size the last SOF gave
  std::vector<std::pair<const uint8_t*, size_t>> icc;
  auto next = [&]() -> bool {  // s = fp.read(1); false: empty
    if (pos >= n) return false;
    s0 = d[pos++];
    return true;
  };
  while (true) {
    if (s0 != 0xFF) {  // junk between markers
      if (!next()) return kPassOn;  // s[0] of an empty read: IndexError
      continue;
    }
    if (pos >= n) return kPassOn;  // i16 of one byte: struct.error
    const int m = 0xFF00 | d[pos++];
    if (m == 0xFFFF) continue;  // a fill byte: s = b"\xff"
    if (m == 0xFF00) {
      if (!next()) return kPassOn;
      continue;
    }
    if (m < 0xFFC0) return kPassOn;  // "no marker found"
    const bool bare = m == 0xFFC8 || (m >= 0xFFD0 && m <= 0xFFD9) || (m >= 0xFFF0 && m <= 0xFFFD);
    if (!bare) {  // a handler: i16(read(2)) - 2, then _safe_read of that
      if (n - pos < 2) return kPassOn;
      const int64_t len = ((d[pos] << 8) | d[pos + 1]) - 2;
      pos += 2;
      if (len > 0 && (uint64_t)(n - pos) < (uint64_t)len) return kCorrupt;  // "Truncated File Read"
      const uint8_t* b = d + pos;
      const size_t k = len > 0 ? (size_t)len : 0;
      pos += k;
      auto starts = [&](const char* t, size_t tl) { return k >= tl && !std::memcmp(b, t, tl); };
      if ((m == 0xFFE0 && starts("JFIF", 4)) || (m == 0xFFEE && starts("Adobe", 5))) {
        if (k < 7) return kPassOn;  // i16(s, 5)
      } else if (m == 0xFFED && starts("Photoshop 3.0\0", 14)) {
        size_t o = 14;
        while (o + 4 <= k && !std::memcmp(b + o, "8BIM", 4)) {
          o += 4;
          if (o + 2 > k) break;  // i16: struct.error, caught
          o += 2;
          if (o >= k) return kPassOn;  // name_len = s[offset]: IndexError
          o += 1 + b[o];
          o += o & 1;
          if (o + 4 > k) break;
          const uint64_t size = be32(b + o);
          o += 4;
          if (size > k) break;  // past the segment: the loop's test fails
          o += (size_t)size;
          o += o & 1;
        }
      } else if (m == 0xFFE2 && starts("ICC_PROFILE\0", 12)) {
        icc.emplace_back(b, k);
      } else if ((m >= 0xFFC0 && m <= 0xFFCF && m != 0xFFC4 && m != 0xFFC8 && m != 0xFFCC) ||
                 m == 0xFFDE) {  // SOF
        if (k < 5) return kPassOn;  // i16(s, 3): struct.error
        // "cannot handle N-bit layers", "cannot handle N-layer images": kinds
        // PIL's open refuses, refused here by name
        if (b[0] != 8) return kPrecision;
        if (k < 6) return kPassOn;  // s[5]: IndexError
        if (b[5] != 1 && b[5] != 3 && b[5] != 4) return kComponents;
        if (!icc.empty()) {  // icclist[0][13] of the sorted fragments
          std::sort(icc.begin(), icc.end(), [](const auto& x, const auto& y) {
            return std::lexicographical_compare(x.first, x.first + x.second, y.first,
                                                y.first + y.second);
          });
          if (icc[0].second < 14) return kPassOn;
          icc.clear();
        }
        if ((k - 6) % 3) return kPassOn;  // a component entry cut short: IndexError
        sof = true;
        sof_w = b[3] << 8 | b[4];
        sof_h = b[1] << 8 | b[2];
      } else if (m == 0xFFDB) {  // DQT: every table whole
        size_t o = 0;
        while (o < k) {
          const size_t ql = 1 + (b[o] / 16 == 0 ? 1 : 2) * 64;
          if (k - o < ql) return kPassOn;  // "bad quantization table marker"
          o += ql;
        }
      }
      if (m == 0xFFDA) break;  // SOS
    }
    if (!next()) return kPassOn;
  }
  // no mode, or a width of 0: ImageFile's "not identified"; a height of 0
  // (one a DNL marker would give) is refused by name
  if (!sof || sof_w == 0) return kPassOn;
  return sof_h == 0 ? kDNL : kOk;
}

// ===================================== PIL's image model, TIFF and BMP

#include "native_pil.h"
#include "native_png.h"
#include "native_tiff.h"
#include "native_bmp.h"
#include "native_gif.h"
#include "native_vp8.h"
#include "native_webp.h"
#include "native_raster.h"
#include "native_bcn.h"
#include "native_ico.h"
#include "native_psd.h"
#include "native_blp.h"
#include "native_icns.h"
#include "native_plugins.h"

// ================================================ netpbm (P1-P6, Pf)
// As PIL's PpmImagePlugin reads it, then convert("L"): binary P4/P5/P6 and
// plain P1/P2/P3; P5 at maxval 255 raw, 65535 big-endian raw (mode "I"),
// any other maxval scaled as round(v / maxval · 255) (or · 65535 in mode
// "I", maxval > 255), rounded half to even, then clipped at 255; RGB
// through PIL's luma; bitmaps 1 = black. PFM gray ("Pf", mode "F"): the
// scale's sign gives the byte order (negative: little-endian), rows run
// bottom to top, and each float goes to L truncated toward zero and
// clamped; a scale of zero or not finite is refused as PIL refuses it.
// Colour PFM ("PF") is not identified by PIL. Pillow's own kinds read as
// P5 reads its samples: P0CMYK and PyCMYK (CMYK, not inverted), PyRGBA,
// and PyP (P with no palette: all 0); another magic passes the file on.

inline bool pnm_space(int c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' || c == '\r';
}

// Python's int() of an ASCII token: an optional sign, digits, single
// underscores between digits
bool py_int(const std::string& t, int64_t& v) {
  size_t i = 0;
  bool neg = false;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) neg = t[i++] == '-';
  if (i >= t.size() || !std::isdigit((unsigned char)t[i])) return false;
  v = 0;
  for (; i < t.size(); ++i) {
    if (t[i] == '_') {
      if (i + 1 >= t.size() || !std::isdigit((unsigned char)t[i + 1])) return false;
      continue;
    }
    if (!std::isdigit((unsigned char)t[i])) return false;
    v = v * 10 + (t[i] - '0');
  }
  if (neg) v = -v;
  return true;
}

// Python's float() of an ASCII token in its finite decimal forms: a sign,
// digits with single underscores between them, a point, an exponent (the
// infinities and NaN are refused, as PIL refuses a scale that is not finite)
bool py_float(const std::string& t, double& v) {
  std::string clean;
  size_t i = 0;
  auto digits = [&](bool& any) {
    any = false;
    while (i < t.size()) {
      if (std::isdigit((unsigned char)t[i])) {
        clean.push_back(t[i++]);
        any = true;
      } else if (t[i] == '_' && any && i + 1 < t.size() && std::isdigit((unsigned char)t[i + 1])) {
        ++i;
      } else {
        break;
      }
    }
  };
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) clean.push_back(t[i++]);
  bool int_part, frac_part = false;
  digits(int_part);
  if (i < t.size() && t[i] == '.') {
    clean.push_back(t[i++]);
    digits(frac_part);
  }
  if (!int_part && !frac_part) return false;
  if (i < t.size() && (t[i] == 'e' || t[i] == 'E')) {
    clean.push_back(t[i++]);
    if (i < t.size() && (t[i] == '+' || t[i] == '-')) clean.push_back(t[i++]);
    bool exp_part;
    digits(exp_part);
    if (!exp_part) return false;
  }
  if (i != t.size()) return false;
  v = std::strtod(clean.c_str(), nullptr);
  return true;
}

// PpmImageFile._read_token: whitespace before a token is skipped, a '#'
// drops the rest of its line (up to CR or LF, consumed) and the token goes
// on; a token ends at whitespace (consumed); more than 10 bytes is an error
int pnm_raw_token(const uint8_t* d, size_t n, size_t& pos, std::string& tok) {
  tok.clear();
  while (tok.size() <= 10) {
    if (pos >= n) break;
    const int c = d[pos++];
    if (pnm_space(c)) {
      if (tok.empty()) continue;
      break;
    }
    if (c == '#') {
      while (pos < n) {
        const int x = d[pos++];
        if (x == '\r' || x == '\n') break;
      }
      continue;
    }
    tok.push_back((char)c);
  }
  if (tok.empty() || tok.size() > 10) return kCorrupt;
  return kOk;
}

int pnm_token(const uint8_t* d, size_t n, size_t& pos, int64_t& v) {
  std::string tok;
  const int rc = pnm_raw_token(d, n, pos, tok);
  if (rc) return rc;
  return py_int(tok, v) ? kOk : kCorrupt;
}

struct PnmHeader {
  int kind = 0;  // 1..6, 7 for Pf, 8 P0CMYK and PyCMYK, 9 PyP, 10 PyRGBA
  int64_t w = 0, h = 0, maxval = 1;
  double scale = 0.0;  // Pf
  size_t data = 0;  // offset of the first sample
};

int pnm_header(const uint8_t* d, size_t n, PnmHeader& hd) {
  std::string magic;  // _read_magic: up to 6 bytes, ended by whitespace (consumed)
  size_t pos = 0;
  while (magic.size() < 6 && pos < n) {
    const int c = d[pos++];
    if (pnm_space(c)) break;
    magic.push_back((char)c);
  }
  if (magic.size() == 2 && magic[0] == 'P' && magic[1] >= '1' && magic[1] <= '6') {
    hd.kind = magic[1] - '0';
  } else if (magic == "Pf") {
    hd.kind = 7;
  } else if (magic == "P0CMYK" || magic == "PyCMYK") {
    hd.kind = 8;
  } else if (magic == "PyP") {
    hd.kind = 9;
  } else if (magic == "PyRGBA") {
    hd.kind = 10;
  } else {
    return kPassOn;  // MODES[magic]: KeyError, "not a PPM file"
  }
  int rc;
  if ((rc = pnm_token(d, n, pos, hd.w)) || (rc = pnm_token(d, n, pos, hd.h))) return rc;
  if (hd.kind == 7) {
    std::string tok;
    if ((rc = pnm_raw_token(d, n, pos, tok))) return rc;
    if (!py_float(tok, hd.scale) || hd.scale == 0.0 || !std::isfinite(hd.scale))
      return kCorrupt;  // "scale must be finite and non-zero"
  } else if (hd.kind != 1 && hd.kind != 4) {
    if ((rc = pnm_token(d, n, pos, hd.maxval))) return rc;
    if (hd.maxval <= 0 || hd.maxval >= 65536) return kCorrupt;
  }
  if (hd.w <= 0 || hd.h <= 0) return kPassOn;  // after the open: "not identified by this driver"
  if (hd.w > (1 << 24) || hd.h > (1 << 24)) return kCorrupt;
  hd.data = pos;
  return kOk;
}

// the plain kinds' body with PpmPlainDecoder's comment removal: '#' up to
// and including the first CR or LF is deleted wherever it stands
void pnm_strip_comments(const uint8_t* d, size_t n, size_t pos, std::vector<uint8_t>& out) {
  out.clear();
  out.reserve(n - pos);
  while (pos < n) {
    if (d[pos] == '#') {
      while (pos < n && d[pos] != '\n' && d[pos] != '\r') ++pos;
      ++pos;  // the line end goes too
      continue;
    }
    out.push_back(d[pos++]);
  }
}

int decode_pnm(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  PnmHeader hd;
  int rc = pnm_header(d, n, hd);
  if (rc) return rc;
  w = (int)hd.w;
  h = (int)hd.h;
  const size_t npx = (size_t)w * h;
  const int bands = (hd.kind == 3 || hd.kind == 6) ? 3 : hd.kind == 8 || hd.kind == 10 ? 4 : 1;
  const int64_t maxval = hd.maxval;
  const bool mode_i = maxval > 255 && (hd.kind == 2 || hd.kind == 5);
  const double out_max = mode_i ? 65535.0 : 255.0;
  // min(out_max, round(v / maxval · out_max)), then mode "I"'s clip at 255
  auto scale = [&](int64_t v) -> int {
    return (int)std::min(255.0, std::min(out_max, std::nearbyint((double)v / maxval * out_max)));
  };
  const uint8_t* p = d + hd.data;
  const size_t avail = n - hd.data;
  if (hd.kind == 7) {  // "F;32F" (scale < 0) or "F;32BF", raw, bottom to top
    PilImage im;
    im.alloc(kModeF, w, h);
    const UnpackerDef* u = find_unpacker(kModeF, hd.scale < 0 ? "F;32F" : "F;32BF");
    const int rc2 = raw_decode(d, n, hd.data, im, 0, 0, w, h, *u, 0, -1);
    if (rc2) return rc2;
    return pil_to_gray(im, gray);
  }
  if (hd.kind == 4) {  // "1;I": rows of ceil(w / 8) bytes, MSB first, 1 = black
    const size_t row = ((size_t)w + 7) / 8;
    if (avail < row * h) return kCorrupt;
    gray.resize(npx);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        gray[(size_t)y * w + x] = (p[y * row + x / 8] >> (7 - x % 8)) & 1 ? 0 : 255;
    return kOk;
  }
  std::vector<int> s(npx * bands);
  if (hd.kind == 5 || hd.kind == 6 || hd.kind >= 8) {
    const int bytes = maxval < 256 ? 1 : 2;
    if (avail < npx * bands * bytes) return kCorrupt;
    // the raw decoder at maxval 255 (and 65535 gray), else PpmDecoder,
    // which scales and raises on no sample past maxval
    const bool raw = maxval == 255 || (maxval == 65535 && hd.kind == 5);
    for (size_t i = 0; i < npx * bands; ++i) {
      const int64_t v = bytes == 1 ? p[i] : (p[2 * i] << 8) | p[2 * i + 1];
      s[i] = raw ? (int)std::min<int64_t>(v, 255) : scale(v);
    }
  } else {
    std::vector<uint8_t> body;
    pnm_strip_comments(d, n, hd.data, body);
    size_t i = 0, q = 0;
    const size_t want = npx * bands;
    if (hd.kind == 1) {  // every non-space byte is a token, '0' or '1'
      for (; q < body.size() && i < want; ++q) {
        if (pnm_space(body[q])) continue;
        if (body[q] != '0' && body[q] != '1') return kCorrupt;
        s[i++] = body[q] == '1' ? 0 : 255;
      }
    } else {
      while (i < want) {
        while (q < body.size() && pnm_space(body[q])) ++q;
        if (q >= body.size()) break;
        const size_t start = q;
        while (q < body.size() && !pnm_space(body[q])) ++q;
        if (q - start > 10) return kCorrupt;
        int64_t v;
        if (!py_int(std::string(body.begin() + start, body.begin() + q), v)) return kCorrupt;
        if (v < 0 || v > maxval) return kCorrupt;  // PIL raises on both
        s[i++] = scale(v);
      }
    }
    if (i < want) return kCorrupt;  // "not enough image data"
  }
  gray.resize(npx);
  for (size_t i = 0; i < npx; ++i) {
    const int* v = &s[bands * i];
    if (hd.kind == 9) gray[i] = 0;  // P without a palette
    else if (hd.kind == 8) gray[i] = pil_cmyk_luma(v[0], v[1], v[2], v[3]);
    else if (bands == 1) gray[i] = (uint8_t)v[0];
    else gray[i] = pil_luma(v[0], v[1], v[2]);
  }
  return kOk;
}

// ------------------------------------------------------- probes of sizes
int decode_jpeg(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  const int open = jpeg_open(d, n);
  if (open) return open;
  JpegDecoder j(d, n);
  const int rc = j.decode(gray);
  w = j.W;
  h = j.H;
  return rc;
}

// the first SOF's size and component count, as a walk over the markers
// finds it (no SOF before SOS or EOI: kCorrupt)
int jpeg_frame_info(const uint8_t* d, size_t n, int& w, int& h, int& nc) {
  size_t p = 2;
  while (p + 4 <= n) {
    while (p < n && d[p] != 0xFF) ++p;
    while (p < n && d[p] == 0xFF) ++p;
    if (p + 3 > n) break;
    const int m = d[p++];
    if (m == 0xD9 || m == 0xDA) break;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    const int len = (d[p] << 8) | d[p + 1];
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (len < 8 || p + 7 > n) return kCorrupt;
      h = (d[p + 3] << 8) | d[p + 4];
      w = (d[p + 5] << 8) | d[p + 6];
      nc = p + 8 <= n ? d[p + 7] : 0;
      return kOk;
    }
    p += len;
  }
  return kCorrupt;
}

int probe_jpeg(const uint8_t* d, size_t n, int& w, int& h) {
  const int open = jpeg_open(d, n);
  if (open) return open;
  int nc;
  return jpeg_frame_info(d, n, w, h, nc);
}

int probe_pnm(const uint8_t* d, size_t n, int& w, int& h) {
  PnmHeader hd;
  const int rc = pnm_header(d, n, hd);
  w = (int)hd.w;
  h = (int)hd.h;
  return rc;
}

int probe_bmp_as(int (*header)(const uint8_t*, size_t, BmpInfo&), const uint8_t* d, size_t n,
                 int& w, int& h) {
  BmpInfo b;
  const int rc = header(d, n, b);
  w = (int)b.w;
  h = (int)b.h;
  return rc;
}
int probe_bmp(const uint8_t* d, size_t n, int& w, int& h) {
  return probe_bmp_as(bmp_header, d, n, w, h);
}
int probe_dib(const uint8_t* d, size_t n, int& w, int& h) {
  return probe_bmp_as(dib_header, d, n, w, h);
}

int probe_tiff(const uint8_t* d, size_t n, int& w, int& h) {
  TiffInfo t;
  const int rc = tiff_setup(d, n, t);
  w = t.w;
  h = t.h;
  return rc;
}

int probe_gif(const uint8_t* d, size_t n, int& w, int& h) {  // the screen grown to frame 0
  GifInfo g;
  const int rc = gif_setup(d, n, g);
  w = g.w;
  h = g.h;
  return rc;
}

int probe_webp(const uint8_t* d, size_t n, int& w, int& h) {  // the demuxer's canvas
  WebpInfo info;
  const int rc = webp_setup(d, n, info);
  w = info.canvas_w;
  h = info.canvas_h;
  return rc;
}

#include "native_layouts.h"
#include "native_fli.h"

// ------------------------------------------------- the table of plugins
// PIL 12.1's Image.open: the preinit plugins (BMP, DIB, GIF, JPEG, PPM,
// PNG), then every other in the order of Image.ID. A plugin whose accept
// test fails is skipped; one with none (IM, IMT, IPTC, PCD, SPIDER, TGA) is
// tried on every file. A reader returns kPassOn where the plugin's open
// raises an error that passes the file on; any other result ends the
// search. A plugin the port does not read (no reader) is refused with its
// code, where `takes` (the plugins without an accept test, and GBR and WMF,
// whose accept tests QOI, DIB and TGA files can pass) says its open would
// take the file. No plugin taking the file is kUnknown: PIL opens nothing.
struct Plugin {
  const char* name;  // PIL's format name (im.format)
  bool (*accept)(const uint8_t* prefix, size_t k);
  int (*decode)(const uint8_t*, size_t, std::vector<uint8_t>&, int&, int&);
  int (*probe)(const uint8_t*, size_t, int&, int&);
  int refusal;
  bool (*takes)(const uint8_t*, size_t);
};

const Plugin kPlugins[] = {
    {"BMP", accept_bmp, decode_bmp, probe_bmp, 0, nullptr},
    {"DIB", accept_dib, decode_dib, probe_dib, 0, nullptr},
    {"GIF", accept_gif, decode_gif, probe_gif, 0, nullptr},
    {"JPEG", accept_jpeg, decode_jpeg, probe_jpeg, 0, nullptr},
    {"PPM", accept_ppm, decode_pnm, probe_pnm, 0, nullptr},
    {"PNG", accept_png, decode_png, probe_png, 0, nullptr},
    {"AVIF", accept_avif, nullptr, nullptr, kAvif, nullptr},
    {"BLP", accept_blp, decode_blp, probe_blp, 0, nullptr},
    {"BUFR", accept_bufr, nullptr, nullptr, kBufr, nullptr},
    {"CUR", accept_cur, decode_cur, probe_cur, 0, nullptr},
    {"PCX", accept_pcx, decode_pcx, probe_pcx, 0, nullptr},
    {"DCX", accept_dcx, decode_dcx, probe_dcx, 0, nullptr},
    {"DDS", accept_dds, decode_dds, probe_dds, 0, nullptr},
    {"EPS", accept_eps, nullptr, nullptr, kEps, nullptr},
    {"FITS", accept_fits, decode_fits, probe_fits, 0, nullptr},
    {"FLI", accept_fli, decode_fli, probe_fli, 0, nullptr},
    {"FTEX", accept_ftex, decode_ftex, probe_ftex, 0, nullptr},
    {"GBR", accept_gbr, decode_gbr, probe_gbr, 0, nullptr},
    {"GRIB", accept_grib, nullptr, nullptr, kGrib, nullptr},
    {"HDF5", accept_hdf5, nullptr, nullptr, kHdf5, nullptr},
    {"JPEG2000", accept_jpeg2000, nullptr, nullptr, kJpeg2000, nullptr},
    {"ICNS", accept_icns, decode_icns, probe_icns, 0, nullptr},
    {"ICO", accept_ico, decode_ico, probe_ico, 0, nullptr},
    {"IM", nullptr, decode_im, probe_im, 0, nullptr},
    {"IMT", nullptr, decode_imt, probe_imt, 0, nullptr},
    {"IPTC", nullptr, decode_iptc, probe_iptc, 0, nullptr},
    {"MCIDAS", accept_mcidas, decode_mcidas, probe_mcidas, 0, nullptr},
    {"MPEG", accept_mpeg, nullptr, nullptr, kMpeg, nullptr},
    {"TIFF", accept_tiff, decode_tiff, probe_tiff, 0, nullptr},
    {"MSP", accept_msp, decode_msp, probe_msp, 0, nullptr},
    {"PCD", nullptr, decode_pcd, probe_pcd, 0, nullptr},
    {"PIXAR", accept_pixar, decode_pixar, probe_pixar, 0, nullptr},
    {"PSD", accept_psd, decode_psd, probe_psd, 0, nullptr},
    {"QOI", accept_qoi, decode_qoi, probe_qoi, 0, nullptr},
    {"SGI", accept_sgi, decode_sgi, probe_sgi, 0, nullptr},
    {"SPIDER", nullptr, decode_spider, probe_spider, 0, nullptr},
    {"SUN", accept_sun, decode_sun, probe_sun, 0, nullptr},
    {"TGA", nullptr, decode_tga, probe_tga, 0, nullptr},
    {"WEBP", accept_webp, decode_webp, probe_webp, 0, nullptr},
    {"WMF", accept_wmf, nullptr, nullptr, kWmf, wmf_takes},
    {"XBM", accept_xbm, decode_xbm, probe_xbm, 0, nullptr},
    {"XPM", accept_xpm, decode_xpm, probe_xpm, 0, nullptr},
    {"XVThumb", accept_xvthumb, decode_xvthumb, probe_xvthumb, 0, nullptr},
};
constexpr int kPluginCount = (int)(sizeof(kPlugins) / sizeof(kPlugins[0]));

// The first plugin that takes the file runs `read` (its decoder or its
// probe) or is refused; `which` receives its index, -1 where none takes it
template <class Read>
int by_plugin(const uint8_t* d, size_t n, Read&& read, int* which = nullptr) {
  const size_t k = std::min<size_t>(n, 16);  // Image.open's prefix
  if (which) *which = -1;
  for (int i = 0; i < kPluginCount; ++i) {
    const Plugin& p = kPlugins[i];
    if (p.accept && !p.accept(d, k)) continue;
    int rc;
    if (p.decode) rc = read(p);
    else rc = p.takes && !p.takes(d, n) ? kPassOn : p.refusal;
    if (rc == kPassOn) continue;
    if (which) *which = i;
    return rc;
  }
  return kUnknown;
}

int decode_by_signature(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w,
                        int& h) {
  return by_plugin(d, n, [&](const Plugin& p) { return p.decode(d, n, gray, w, h); });
}

// the name of the plugin that takes a file (its probe run), "" for none
const char* plugin_name_of(const uint8_t* d, size_t n) {
  int which = -1, w = 0, h = 0;
  by_plugin(d, n, [&](const Plugin& p) { return p.probe(d, n, w, h); }, &which);
  return which < 0 ? "" : kPlugins[which].name;
}

// no exception leaves the library: a header that asks for more memory than
// there is fails as corrupt data
int decode_any(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  try {
    return decode_by_signature(d, n, gray, w, h);
  } catch (const std::exception&) {
    return kCorrupt;
  }
}

int probe_by_signature(const uint8_t* d, size_t n, int& w, int& h) {
  return by_plugin(d, n, [&](const Plugin& p) { return p.probe(d, n, w, h); });
}

int probe_size(const uint8_t* d, size_t n, int& w, int& h) {
  try {
    return probe_by_signature(d, n, w, h);
  } catch (const std::exception&) {
    return kCorrupt;
  }
}

int decode_path(const char* path, std::vector<uint8_t>& gray, int& w, int& h) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return kIO;
  return decode_any(buf.data(), buf.size(), gray, w, h);
}

// 8-bit gray → float32 in [0, 1] by division, as numpy's u8.astype(f32) / 255
int decode_path_float(const char* path, int H, int W, std::vector<float>& out) {
  std::vector<uint8_t> gray;
  int w = 0, h = 0;
  const int rc = decode_path(path, gray, w, h);
  if (rc) return rc;
  if (w != W || h != H) return kSize;
  out.resize(gray.size());
  for (size_t i = 0; i < gray.size(); ++i) out[i] = (float)gray[i] / 255.0f;
  return kOk;
}

// ===================================================== D. the prefetcher

struct Frame {
  int index = -1;
  int rc = kOk;
  std::vector<float> left, right;
};

struct Loader {
  std::vector<std::string> lefts, rights;
  int H = 0, W = 0;
  std::vector<float> map_l, map_r;
  bool rectify = false;
  size_t depth = 3;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<int, Frame> ready;  // decoded frames not yet taken
  std::atomic<int> next_to_decode{0};
  int next_to_emit = 0;
  bool stop = false;
  std::vector<std::thread> workers;

  void worker() {
    std::vector<float> tmp;
    while (true) {
      const int idx = next_to_decode.fetch_add(1);
      if (idx >= (int)lefts.size()) return;
      Frame fr;
      fr.index = idx;
      fr.rc = decode_path_float(lefts[idx].c_str(), H, W, fr.left);
      if (fr.rc == kOk) fr.rc = decode_path_float(rights[idx].c_str(), H, W, fr.right);
      if (fr.rc == kOk && rectify) {
        tmp = fr.left;
        remap_bilinear(tmp.data(), H, W, map_l.data(), fr.left.data());
        tmp = fr.right;
        remap_bilinear(tmp.data(), H, W, map_r.data(), fr.right.data());
      }
      std::unique_lock<std::mutex> lk(mu);
      // bounded: wait while `depth` frames are buffered, unless this one
      // is among the next `depth` to be taken (it is then never blocked)
      cv_space.wait(lk, [&] {
        return stop || ready.size() < depth || idx < next_to_emit + (int)depth;
      });
      if (stop) return;
      ready.emplace(idx, std::move(fr));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

const char* native_runtime_error_string(int code) {
  switch (code) {
    case kIO: return "cannot read the file";
    case kCorrupt: return "corrupt or unrecognized image data";
    case kSize: return "the image size differs from the expected size";
    case kPrecision:
      return "a JPEG whose samples are not 8-bit (a frame of 12 or 16 bits, or any other depth): "
             "PIL does not read it either (JpegImagePlugin: \"cannot handle N-bit layers\")";
    case kHierarchical:
      return "a hierarchical JPEG (DHP, SOF5-7, SOF13-15): PIL does not read it either "
             "(libjpeg-turbo has no hierarchical mode)";
    case kDNL:
      return "a JPEG whose height comes from a DNL marker: PIL does not read it either "
             "(libjpeg-turbo: \"Empty JPEG image (DNL not supported)\")";
    case kFractional:
      return "a JPEG with fractional sampling ratios: PIL does not read it either "
             "(libjpeg-turbo: \"Fractional sampling not implemented yet\")";
    case kLosslessColour:
      return "a lossless JPEG in a YCbCr or YCCK colour space: PIL does not read it either "
             "(libjpeg-turbo converts no colour in lossless mode)";
    case kArithLossless:
      return "an arithmetic-coded lossless JPEG (SOF11): PIL does not read it either "
             "(libjpeg-turbo codes lossless data with Huffman tables only)";
    case kComponents:
      return "a JPEG of other than 1, 3 or 4 components: PIL does not read it either "
             "(JpegImagePlugin: \"cannot handle N-layer images\")";
    case kMcuSize:
      return "a JPEG scan of more than 10 blocks per MCU: PIL does not read it either "
             "(libjpeg-turbo: \"Sampling factors too large for interleaved scan\")";
    case kUnknown:
      return "no plugin of PIL's opens it (\"cannot identify image file\"): no format's "
             "signature matches, or each plugin it matches passes it on";
    case kTiffJpeg:
      return "a TIFF with new-style JPEG compression (7) of 12-bit samples, or whose JPEG "
             "strip or tile is smaller than the TIFF says (libtiff leaves the rest of Pillow's "
             "strip buffer as the previous strip left it): PIL reads it through libtiff; not "
             "read";
    case kTiffOjpeg:
      return "a TIFF with old-style JPEG compression (6) in tiles, on separate planes, in a "
             "big-endian file of several strips (libtiff's OJPEG reads them out of order), of "
             "several strips whose restart interval is not one strip's MCUs, of a frame other "
             "than SOF0/SOF1, or of sampling factors "
             "TIFF cannot state (libtiff's OJPEG then upsamples inside libjpeg): PIL reads it "
             "through libtiff; not read";
    case kTiffWebp:
      return "a TIFF with WebP compression (50001): PIL does not read it either (Pillow's "
             "libtiff is built without it: \"WEBP compression support is not configured\")";
    case kTiffSgiLog:
      return "a TIFF with SGILog compression (34676, 34677) of a photometric other than LogL or "
             "LogLuv: PIL does not read it either (libtiff: \"Inappropriate photometric "
             "interpretation\"; LogL and LogLuv are PIL's unknown pixel mode)";
    case kTiffMode:
      return "a TIFF whose (byte order, photometric, sample format, fill order, bits, extra "
             "samples) PIL's OPEN_INFO maps to no mode: PIL does not read it either "
             "(TiffImagePlugin: \"unknown pixel mode\")";
    case kTiffLab:
      return "a CIELAB TIFF: PIL opens it as mode LAB but does not convert it to L either "
             "(\"conversion from LAB to RGB not supported\")";
    case kTiffRawMode:
      return "a TIFF whose layout asks PIL for a raw mode it lacks (uncompressed separate "
             "planes of LA, PA, RGBX or RGBa; fill order 2 at 8-bit min-is-white or palette), "
             "which PIL does not read either (\"unknown raw mode for given image mode\"), or a "
             "compressed palette TIFF with an extra sample on separate planes, or compressed "
             "tiles whose rows are shorter than PIL's raw mode reads (tags written twice), which "
             "PIL reads past the end of its tile buffer (its pixels differ from read to read): "
             "not read";
    case kBmpHeader:
      return "a BMP whose header size is not 12, 40, 52, 56, 64, 108 or 124: PIL does not "
             "read it either (\"Unsupported BMP header type\")";
    case kBmpDepth:
      return "a BMP of a pixel depth other than 1, 4, 8, 16, 24 or 32 bits: PIL does not "
             "read it either (\"Unsupported BMP pixel depth\")";
    case kBmpCompression:
      return "a BMP with JPEG (4), PNG (5) or another unknown compression: PIL does not read "
             "it either (\"Unsupported BMP compression\")";
    case kBmpBitfields:
      return "a BMP whose BITFIELDS masks PIL maps to no layout: PIL does not read it either "
             "(\"Unsupported BMP bitfields layout\")";
    case kBmpPalette:
      return "a BMP palette of more than 256 colours: PIL does not read it either "
             "(\"Unsupported BMP Palette size\", \"invalid palette size\")";
    case kBmpRle:
      return "an RLE BMP above 8 bits or with a black-and-white palette: PIL does not read it "
             "either (\"unknown raw mode\")";
    case kGifCodeSize:
      return "a GIF whose LZW minimum code size is above 12: PIL does not read it either "
             "(\"codec configuration error when reading image file\")";
    case kWebpVp8Frame:
      return "a WebP whose VP8 frame is not a displayable key frame of profile 0-3: PIL does "
             "not read it either (libwebp's VP8GetInfo refuses it: \"could not create decoder "
             "object\")";
    case kWebpVp8lVersion:
      return "a WebP whose VP8L header has a version other than 0: PIL does not read it "
             "either (libwebp's VP8LGetInfo refuses it: \"could not create decoder object\")";
    case kWebpAlpha:
      return "a WebP whose ALPH chunk names a compression method above 1, a pre-processing "
             "above 1 or sets its reserved bits: PIL does not read it either (libwebp's "
             "ALPHInit refuses it: \"failed to read next frame\")";
    case kJpeg2000:
      return "a JPEG 2000 image (codestream or JP2): PIL reads it through OpenJPEG; not read";
    case kPsdLab:
      return "a PSD in Lab colour: PIL opens it as mode LAB but does not convert it to L "
             "either (\"conversion from LAB to RGB not supported\")";
    case kAvif: return "an AVIF image (or a HEIF brand PIL's AVIF plugin tries): PIL reads it "
                       "through libavif; not read";
    case kBlpFormat:
      return "a BLP (Blizzard texture) image of a compression, encoding or alpha encoding "
             "PIL does not read either (BLPFormatError: \"Unsupported BLP compression\", "
             "\"Unsupported BLP encoding\", \"Unknown BLP encoding\", \"Unsupported alpha "
             "encoding\")";
    case kBufr: return "a BUFR file: PIL identifies it but loads it only through a handler "
                       "an application installs (\"cannot find loader\"); not read";
    case kEps: return "an EPS file: PIL renders it only through Ghostscript; not read";
    case kGrib: return "a GRIB file: PIL identifies it but loads it only through a handler "
                       "an application installs (\"cannot find loader\"); not read";
    case kHdf5: return "an HDF5 file: PIL identifies it but loads it only through a handler "
                       "an application installs (\"cannot find loader\"); not read";
    case kIcnsJpeg2000:
      return "an ICNS (Apple icon) image whose best size is a JPEG 2000 entry: PIL reads it "
             "through OpenJPEG; not read";
    case kMpeg: return "an MPEG stream: PIL identifies it but cannot read it either; not read";
    case kWmf: return "a WMF/EMF metafile: PIL renders it only on Windows; not read";
    case kIptc:
      return "an IPTC/NAA file whose image data opens as an image of other than mode L (or of a "
             "plugin other than JPEG or netpbm, whose mode the port does not tell): PIL's "
             "convert(\"L\") copies such an image unconverted, and Image.merge refuses it as a "
             "band; not read";
    case kSunPalette:
      return "a Sun raster image whose colour map PIL cannot apply (a 1-bit or RGB image with a "
             "map: \"unrecognized image mode\"; a map of more than 256 colours: \"invalid "
             "palette size\"): PIL does not read it either";
    case kPcxMode:
      return "a PCX image of a depth and plane count PIL has no mode for: PIL does not read it "
             "either (\"unknown PCX mode\")";
    case kSgiMode:
      return "an SGI image of a bytes-per-channel, dimension and channel count PIL has no mode "
             "for: PIL does not read it either (\"Unsupported SGI image mode\")";
    case kSgiCompression:
      return "an SGI image whose compression is neither 0 nor 1: PIL does not read it either "
             "(\"cannot load this image\")";
    case kTgaKind:
      return "a TGA image whose type and depth PIL maps to no raw mode (or a colour-mapped one "
             "without a map): PIL does not read it either (\"cannot load this image\", "
             "\"unknown raw mode\")";
    case kTgaMap:
      return "a TGA image whose colour map PIL cannot apply (a 32-bit map: \"unrecognized raw "
             "mode\"; a map on a 1-bit or true-colour image: \"unrecognized image mode\"; more "
             "than 256 entries: \"invalid palette size\"): PIL does not read it either";
    case kDdsHeader:
      return "a DDS file whose header size is not 124: PIL does not read it either "
             "(\"Unsupported header size\")";
    case kDdsFormat:
      return "a DDS pixel format PIL does not read either (a luminance bit count other than 8, "
             "or 16 with alpha: \"Unsupported bitcount\"; a FourCC or DXGI format PIL has no "
             "decoder for: \"Unimplemented pixel format\", \"Unimplemented DXGI format\"; no "
             "format flag: \"Unknown pixel format flags\")";
    default: return "unknown error";
  }
}

// the Python exception an error code raises (native.py): 1 NotImplementedError
// for an image kind the decoder refuses, 2 ValueError for a file of no known
// signature, 0 IOError for the rest
int native_runtime_error_kind(int code) {
  return code >= kPrecision ? 1 : code == kUnknown ? 2 : 0;
}

// segs (n, 4) f64 row-major; out (n, 4). Returns the merged count.
int native_merge_lines(const double* segs, int n, double angle_thr, double distance_thr,
                       double ep_thr, double* out) {
  return merge_lines(segs, n, angle_thr, distance_thr, ep_thr, out);
}

int native_remap_bilinear(const float* src, int h, int w, const float* map_xy, float* dst) {
  if (h < 2 || w < 2) return kSize;
  remap_bilinear(src, h, w, map_xy, dst);
  return kOk;
}

// Decodes an image in memory into out (H × W, 8-bit gray).
int native_decode_u8(const uint8_t* data, int64_t n, uint8_t* out, int H, int W) {
  std::vector<uint8_t> gray;
  int w = 0, h = 0;
  const int rc = decode_any(data, (size_t)n, gray, w, h);
  if (rc) return rc;
  if (w != W || h != H) return kSize;
  std::memcpy(out, gray.data(), gray.size());
  return kOk;
}

// A PNG as PIL opens it, for png.py's own inflate: out receives (width,
// height, bit depth, colour type, interlaced, tiled: an APNG frame smaller
// than the image, reads) and then the start and end of each read of the
// data run (up to cap of them). Returns the open's code (kPassOn for a
// file PIL's PNG plugin passes on).
int native_png_layout(const uint8_t* data, int64_t n, int64_t* out, int64_t cap) {
  try {
    PngState st;
    const int rc = png_open(data, (size_t)n, st);
    if (rc) return rc;
    if (!st.tile) return kCorrupt;  // "cannot load this image"
    std::vector<PngRead> reads;
    int term;
    png_reads(data, (size_t)n, st, reads, term);
    const int64_t head[7] = {st.w, st.h, st.depth, st.ctype, st.interlace ? 1 : 0,
                             (st.tx0 || st.ty0 || st.tx1 != st.w || st.ty1 != st.h) ? 1 : 0,
                             (int64_t)reads.size()};
    std::memcpy(out, head, sizeof(head));
    for (int64_t i = 0; i < std::min<int64_t>(cap, (int64_t)reads.size()); ++i) {
      out[7 + 2 * i] = (int64_t)reads[i].a;
      out[8 + 2 * i] = (int64_t)reads[i].b;
    }
    return kOk;
  } catch (const std::exception&) {
    return kCorrupt;
  }
}

// PIL's load_end after the image was done in read `seg` of the layout
int native_png_tail(const uint8_t* data, int64_t n, int64_t seg) {
  PngState st;
  int rc = png_open(data, (size_t)n, st);
  if (rc) return rc;
  std::vector<PngRead> reads;
  int term;
  png_reads(data, (size_t)n, st, reads, term);
  if (seg < 0 || seg >= (int64_t)reads.size()) return kCorrupt;
  st.seq = reads[seg].seq;
  rc = png_tail(data, (size_t)n, reads[seg].chunk_end, st);
  return rc == kLoadPassOn ? kCorrupt : rc;
}

// The name of the PIL plugin that takes an image in memory (reads or
// refuses it: PIL's im.format) into out (16 bytes), "" where none does
int native_identify(const uint8_t* data, int64_t n, char* out) {
  int which = -1, w = 0, h = 0;
  try {
    by_plugin(data, (size_t)n, [&](const Plugin& p) { return p.probe(data, (size_t)n, w, h); },
              &which);
  } catch (const std::exception&) {
  }
  std::snprintf(out, 16, "%s", which < 0 ? "" : kPlugins[which].name);
  return which;
}

// hw = (height, width) of an image in memory, from its header alone
int native_image_size(const uint8_t* data, int64_t n, int* hw) {
  return probe_size(data, (size_t)n, hw[1], hw[0]);
}

int native_decode_file(const char* path, float* out, int H, int W) {
  std::vector<float> buf;
  const int rc = decode_path_float(path, H, W, buf);
  if (rc) return rc;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return kOk;
}

int native_loader_create(const char** left_paths, const char** right_paths, int n, int H,
                         int W, const float* map_l, const float* map_r, int depth,
                         int n_threads, void** handle) {
  if (n < 0 || H < 2 || W < 2) return kSize;
  auto* L = new Loader();
  L->lefts.assign(left_paths, left_paths + n);
  L->rights.assign(right_paths, right_paths + n);
  L->H = H;
  L->W = W;
  L->depth = depth > 0 ? (size_t)depth : 3;
  if (map_l && map_r) {
    const size_t sz = (size_t)H * W * 2;
    L->map_l.assign(map_l, map_l + sz);
    L->map_r.assign(map_r, map_r + sz);
    L->rectify = true;
  }
  const int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::worker, L);
  *handle = L;
  return kOk;
}

// Blocks for the next frame in order: its index, −1 at the end, −100 − the
// error code when it failed to decode or had another size.
int native_loader_next(void* handle, float* out_left, float* out_right) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_to_emit >= (int)L->lefts.size()) return -1;
  const int want = L->next_to_emit;
  L->cv_ready.wait(lk, [&] { return L->ready.count(want) > 0; });
  Frame fr = std::move(L->ready[want]);
  L->ready.erase(want);
  L->next_to_emit++;
  L->cv_space.notify_all();
  lk.unlock();
  if (fr.rc != kOk) return -100 - fr.rc;
  const size_t sz = (size_t)L->H * L->W;
  std::memcpy(out_left, fr.left.data(), sz * sizeof(float));
  std::memcpy(out_right, fr.right.data(), sz * sizeof(float));
  return fr.index;
}

// Stops and joins the workers (those blocked on a full buffer too).
int native_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->next_to_decode.store(1 << 30);
  }
  L->cv_space.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
  return kOk;
}

}  // extern "C"
