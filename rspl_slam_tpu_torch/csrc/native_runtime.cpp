// The port's native runtime: host C++ only, no device code, built by
// ops/cuda_build.py with the host compiler and loaded with ctypes
// (rspl_slam_tpu_torch/native.py).
//
//   A. merge_lines (MergeLines of the reference's line_processor.cc) and
//      the bilinear remap with the border clamp of camera.remap_bilinear;
//   B. PNG: an RFC 1950/1951 inflate, every colour type and bit depth,
//      Adam7;
//   C. baseline JPEG: Huffman decoding, libjpeg's integer "islow" IDCT,
//      its fancy chroma upsampling and YCbCr→RGB tables;
//   D. an ordered stereo prefetcher: decode threads, a bounded reorder
//      buffer, optional rectification.
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
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Err { kOk = 0, kIO = 1, kCorrupt = 2, kUnsupported = 3, kSize = 4 };

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

int zlib_inflate(const uint8_t* d, size_t n, std::vector<uint8_t>& out, size_t expect) {
  if (n < 6) return kCorrupt;
  const int cmf = d[0], flg = d[1];
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 != 0 || (flg & 0x20))
    return kCorrupt;
  out.clear();
  out.reserve(expect);
  InflateIn in{d + 2, n - 2};
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
  if (in.pos + 4 > in.n) return kCorrupt;
  if (be32(in.d + in.pos) != adler32(out.data(), out.size())) return kCorrupt;
  return kOk;
}

// =============================================================== B. PNG

uint32_t crc_table[256];
std::once_flag crc_once;

uint32_t crc32(const uint8_t* p, size_t n) {
  std::call_once(crc_once, [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      crc_table[i] = c;
    }
  });
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = crc_table[(c ^ p[i]) & 255] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

struct PngHeader {
  int w = 0, h = 0, depth = 0, ctype = 0, interlace = 0;
};

int png_header(const uint8_t* d, size_t n, PngHeader& hd) {
  if (n < 33 || std::memcmp(d, kPngSig, 8) || std::memcmp(d + 12, "IHDR", 4)) return kCorrupt;
  hd.w = (int)be32(d + 16);
  hd.h = (int)be32(d + 20);
  hd.depth = d[24];
  hd.ctype = d[25];
  hd.interlace = d[28];
  const int t = hd.ctype, b = hd.depth;
  const bool valid = (t == 0 && (b == 1 || b == 2 || b == 4 || b == 8 || b == 16)) ||
                     (t == 3 && (b == 1 || b == 2 || b == 4 || b == 8)) ||
                     ((t == 2 || t == 4 || t == 6) && (b == 8 || b == 16));
  if (!valid || hd.w <= 0 || hd.h <= 0 || d[26] != 0 || d[27] != 0 || hd.interlace > 1)
    return kCorrupt;
  return kOk;
}

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

int decode_png(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  PngHeader hd;
  int rc = png_header(d, n, hd);
  if (rc) return rc;
  std::vector<uint8_t> idat;
  uint8_t pal[256 * 3];
  int npal = 0;
  size_t pos = 8;
  bool end = false;
  while (pos + 12 <= n && !end) {
    const uint32_t len = be32(d + pos);
    if (len > n - pos - 12) return kCorrupt;
    const uint8_t* kind = d + pos + 4;
    const uint8_t* body = d + pos + 8;
    if (crc32(kind, len + 4) != be32(body + len)) return kCorrupt;
    if (!std::memcmp(kind, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(kind, "PLTE", 4)) {
      if (len % 3 || len > 768) return kCorrupt;
      npal = (int)len / 3;
      std::memcpy(pal, body, len);
    } else if (!std::memcmp(kind, "IEND", 4)) {
      end = true;
    }
    pos += 12 + len;
  }
  if (hd.ctype == 3 && npal == 0) return kCorrupt;
  // a palette index past PLTE reads the gray ramp PIL's palettes start from
  for (int i = npal; i < 256; ++i) pal[3 * i] = pal[3 * i + 1] = pal[3 * i + 2] = (uint8_t)i;

  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  const int ch = kChannels[hd.ctype], depth = hd.depth;
  const int bits_pp = ch * depth, bpp = std::max(1, bits_pp / 8);
  static const int x0s[7] = {0, 4, 0, 2, 0, 1, 0}, y0s[7] = {0, 0, 4, 0, 2, 0, 1};
  static const int dxs[7] = {8, 8, 4, 4, 2, 2, 1}, dys[7] = {8, 8, 8, 4, 4, 2, 2};
  const int npass = hd.interlace ? 7 : 1;
  w = hd.w;
  h = hd.h;
  size_t expect = 0;
  for (int p = 0; p < npass; ++p) {
    const int x0 = hd.interlace ? x0s[p] : 0, y0 = hd.interlace ? y0s[p] : 0;
    const int dx = hd.interlace ? dxs[p] : 1, dy = hd.interlace ? dys[p] : 1;
    const size_t pw = (size_t)(w - x0 + dx - 1) / dx, ph = (size_t)(h - y0 + dy - 1) / dy;
    if (pw && ph) expect += ph * ((pw * bits_pp + 7) / 8 + 1);
  }
  std::vector<uint8_t> raw, rows;
  rc = zlib_inflate(idat.data(), idat.size(), raw, expect);
  if (rc) return rc;
  if (raw.size() < expect) return kCorrupt;
  gray.assign((size_t)w * h, 0);
  size_t off = 0;
  for (int p = 0; p < npass; ++p) {
    const int x0 = hd.interlace ? x0s[p] : 0, y0 = hd.interlace ? y0s[p] : 0;
    const int dx = hd.interlace ? dxs[p] : 1, dy = hd.interlace ? dys[p] : 1;
    const int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
    if (pw <= 0 || ph <= 0) continue;
    const int stride = (int)(((size_t)pw * bits_pp + 7) / 8);
    if (!unfilter(raw.data() + off, ph, stride, bpp, rows)) return kCorrupt;
    off += (size_t)ph * (stride + 1);
    for (int py = 0; py < ph; ++py) {
      const uint8_t* r = rows.data() + (size_t)py * stride;
      uint8_t* o = gray.data() + (size_t)(y0 + py * dy) * w;
      for (int px = 0; px < pw; ++px) {
        uint8_t v;
        if (depth < 8) {  // packed gray or palette index, MSB first
          const int bit = px * depth;
          const int s = (r[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
          if (hd.ctype == 3) v = pil_luma(pal[3 * s], pal[3 * s + 1], pal[3 * s + 2]);
          else v = (uint8_t)(depth == 1 ? s * 255 : depth == 2 ? s * 85 : s * 17);
        } else if (depth == 8) {
          const uint8_t* q = r + (size_t)px * ch;
          if (hd.ctype == 3) v = pil_luma(pal[3 * q[0]], pal[3 * q[0] + 1], pal[3 * q[0] + 2]);
          else if (ch <= 2) v = q[0];
          else v = pil_luma(q[0], q[1], q[2]);
        } else {  // 16 bit, big endian
          const uint8_t* q = r + (size_t)px * ch * 2;
          if (hd.ctype == 0) v = (uint8_t)std::min(255, (q[0] << 8) | q[1]);
          else if (ch == 2) v = q[0];
          else v = pil_luma(q[0], q[2], q[4]);
        }
        o[x0 + px * dx] = v;
      }
    }
  }
  return kOk;
}

// ========================================================= C. JPEG
// Baseline and extended sequential Huffman JPEG, 8-bit, 1 or 3 components,
// sampling factors up to 2, restart intervals. Decoded as libjpeg-turbo
// decodes it for PIL: islow IDCT (jidctint.c), fancy upsampling
// (jdsample.c), YCbCr→RGB (jdcolor.c); then PIL's luma.

const uint8_t kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past the block's end lands here (libjpeg's guard)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct JHuff {
  bool present = false;
  uint8_t vals[256];
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valptr[17];   // index of its first symbol minus its first code
  uint16_t fast[1 << 9];  // (length << 8) | symbol for codes of ≤ 9 bits

  bool build(const uint8_t* counts, const uint8_t* v, int nv) {
    std::memcpy(vals, v, nv);
    std::memset(fast, 0, sizeof(fast));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k - code;
      for (int i = 0; i < counts[l - 1]; ++i, ++code, ++k) {
        if (l <= 9) {
          const int sh = 9 - l;
          for (int f = code << sh; f < ((code + 1) << sh); ++f) fast[f] = (uint16_t)((l << 8) | vals[k]);
        }
      }
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) return false;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
    return true;
  }
};

struct JBits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  bool marker = false;  // the entropy data ended at a marker: zeros follow

  void fill() {
    while (cnt <= 56) {
      uint64_t b = 0;
      if (!marker && pos < n) {
        if (d[pos] == 0xFF) {
          const uint8_t nx = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (nx == 0x00) {
            b = 0xFF;
            pos += 2;
          } else {
            marker = true;
          }
        } else {
          b = d[pos++];
        }
      }
      buf |= b << (56 - cnt);
      cnt += 8;
    }
  }
  int get(int k) {  // k in 1..16
    if (cnt < k) fill();
    const int v = (int)(buf >> (64 - k));
    buf <<= k;
    cnt -= k;
    return v;
  }
  int decode(const JHuff& t) {
    if (cnt < 16) fill();
    const uint16_t e = t.fast[buf >> (64 - 9)];
    if (e) {
      const int l = e >> 8;
      buf <<= l;
      cnt -= l;
      return e & 255;
    }
    int l = 10;
    int code = (int)(buf >> (64 - l));
    while (code > t.maxcode[l]) {
      if (++l > 16) return -1;
      code = (int)(buf >> (64 - l));
    }
    buf <<= l;
    cnt -= l;
    return t.vals[t.valptr[l] + code];
  }
  // a restart: drop the buffered bits and step over the RSTn marker
  void restart() {
    buf = 0;
    cnt = 0;
    marker = false;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)) ++pos;
    if (pos + 1 < n) pos += 2;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct JComp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;  // allocated blocks per row / column
  int width_in_blocks = 0, height_in_blocks = 0;
  int dw = 0, dh = 0;  // downsampled width / height
  std::vector<int16_t> coef;  // 64 per block, natural order
  int dc_pred = 0, td = 0, ta = 0;
};

// jidctint.c's jpeg_idct_islow, with its descale and range limit
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F_0_298631336 = 2446, F_0_390180644 = 3196, F_0_541196100 = 4433,
                  F_0_765366865 = 6270, F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137, F_1_961570560 = 16069,
                  F_2_053119869 = 16819, F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// IDCT_range_limit(cinfo)[x & RANGE_MASK] of jdmaster.c's table
inline uint8_t idct_limit(int64_t x) {
  const int v = (int)(x & 1023);
  if (v < 128) return (uint8_t)(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return (uint8_t)(v - 896);
}

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    auto deq = [&](int r) -> int64_t { return (int64_t)ip[8 * r] * (int64_t)qp[8 * r]; };
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int dc = (int)(deq(0) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
      continue;
    }
    int64_t z2 = deq(2), z3 = deq(6);
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = deq(0);
    z3 = deq(4);
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = deq(7);
    tmp1 = deq(5);
    tmp2 = deq(3);
    tmp3 = deq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[8 * 0 + c] = (int)descale(tmp10 + tmp3, sh);
    ws[8 * 7 + c] = (int)descale(tmp10 - tmp3, sh);
    ws[8 * 1 + c] = (int)descale(tmp11 + tmp2, sh);
    ws[8 * 6 + c] = (int)descale(tmp11 - tmp2, sh);
    ws[8 * 2 + c] = (int)descale(tmp12 + tmp1, sh);
    ws[8 * 5 + c] = (int)descale(tmp12 - tmp1, sh);
    ws[8 * 3 + c] = (int)descale(tmp13 + tmp0, sh);
    ws[8 * 4 + c] = (int)descale(tmp13 - tmp0, sh);
  }
  const int sh = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F_0_541196100;
    int64_t tmp2 = z1 + z3 * -F_1_847759065;
    int64_t tmp3 = z1 + z2 * F_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// jdsample.c's upsamplers onto a full-size plane of W × H. Context rows
// above the first row and below the last real row repeat those rows
// (jdmainct.c); the first and last columns repeat likewise.
void upsample(const JComp& c, const uint8_t* src, int sstride, int hr, int vr, int W, int H,
              std::vector<uint8_t>& dst) {
  dst.assign((size_t)W * H, 0);
  const int cw = c.dw, chh = c.dh;
  auto at = [&](int y, int x) -> int {
    y = std::min(std::max(y, 0), chh - 1);
    x = std::min(std::max(x, 0), cw - 1);
    return src[(size_t)y * sstride + x];
  };
  const bool fancy_h = cw > 2;
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
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      const int far = oy & 1 ? cy + 1 : cy - 1, bias = oy & 1 ? 2 : 1;
      for (int ox = 0; ox < W; ++ox) o[ox] = (uint8_t)((at(cy, ox) * 3 + at(far, ox) + bias) >> 2);
    } else if (hr == 2 && vr == 2 && fancy_h) {  // h2v2_fancy_upsample
      const int far = oy & 1 ? cy + 1 : cy - 1;
      auto colsum = [&](int x) { return at(cy, x) * 3 + at(far, x); };
      for (int ox = 0; ox < W; ++ox) {
        const int cx = ox >> 1, t = colsum(cx) * 3;
        o[ox] = (uint8_t)(ox & 1 ? (t + colsum(cx + 1) + 7) >> 4 : (t + colsum(cx - 1) + 8) >> 4);
      }
    } else {  // box replication (h2v1_upsample, h2v2_upsample)
      for (int ox = 0; ox < W; ++ox) o[ox] = (uint8_t)at(cy, ox / hr);
    }
  }
}

struct JpegDecoder {
  const uint8_t* d;
  size_t n, pos = 0;
  JpegDecoder(const uint8_t* data, size_t size) : d(data), n(size) {}
  uint16_t qt[4][64];  // natural order
  bool qt_present[4] = {false, false, false, false};
  JHuff dc[4], ac[4];
  std::vector<JComp> comps;
  int W = 0, H = 0, hmax = 1, vmax = 1, restart_interval = 0;
  int mcux = 0, mcuy = 0;
  bool frame = false, adobe = false;
  int adobe_transform = -1;

  int u16(size_t p) const { return (d[p] << 8) | d[p + 1]; }

  int read_frame(size_t p, int len, int marker) {
    if (marker != 0xC0 && marker != 0xC1) return kUnsupported;
    if (len < 8) return kCorrupt;
    if (d[p] != 8) return kUnsupported;  // 12-bit
    H = u16(p + 1);
    W = u16(p + 3);
    const int nc = d[p + 5];
    if (H == 0) return kUnsupported;  // height from a DNL marker
    if (W == 0) return kCorrupt;
    if (nc == 4) return kUnsupported;  // CMYK / YCCK
    if (nc != 1 && nc != 3) return kCorrupt;
    if (len < 8 + 3 * nc) return kCorrupt;
    comps.assign(nc, JComp());
    for (int i = 0; i < nc; ++i) {
      JComp& c = comps[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return kCorrupt;
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (nc == 1) {  // one component: never subsampled against itself
      comps[0].h = comps[0].v = hmax = vmax = 1;
    }
    for (JComp& c : comps) {
      if (hmax % c.h || vmax % c.v || hmax / c.h > 2 || vmax / c.v > 2) return kUnsupported;
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (JComp& c : comps) {
      c.dw = (int)(((int64_t)W * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)H * c.v + vmax - 1) / vmax);
      c.width_in_blocks = (c.dw + 7) / 8;
      c.height_in_blocks = (c.dh + 7) / 8;
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame = true;
    return kOk;
  }

  int read_dqt(size_t p, int len) {
    const size_t end = p + len - 2;
    while (p < end) {
      const int pq = d[p] >> 4, tq = d[p] & 15;
      if (tq > 3 || pq > 1 || p + 1 + 64 * (pq + 1) > end) return kCorrupt;
      for (int k = 0; k < 64; ++k)
        qt[tq][kZigzag[k]] = pq ? (uint16_t)u16(p + 1 + 2 * k) : d[p + 1 + k];
      qt_present[tq] = true;
      p += 1 + 64 * (pq + 1);
    }
    return kOk;
  }

  int read_dht(size_t p, int len) {
    const size_t end = p + len - 2;
    while (p < end) {
      if (p + 17 > end) return kCorrupt;
      const int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) return kCorrupt;
      int nv = 0;
      for (int k = 0; k < 16; ++k) nv += d[p + 1 + k];
      if (nv > 256 || p + 17 + nv > end) return kCorrupt;
      JHuff& t = tc ? ac[th] : dc[th];
      if (!t.build(d + p + 1, d + p + 17, nv)) return kCorrupt;
      p += 17 + nv;
    }
    return kOk;
  }

  int decode_block(JBits& bits, JComp& c, int16_t* blk) {
    const int s = bits.decode(dc[c.td]);
    if (s < 0 || s > 16) return kCorrupt;
    const int diff = s ? extend(bits.get(s), s) : 0;
    c.dc_pred += diff;
    blk[0] = (int16_t)c.dc_pred;
    const JHuff& t = ac[c.ta];
    for (int k = 1; k < 64;) {
      const int rs = bits.decode(t);
      if (rs < 0) return kCorrupt;
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kZigzag[k]] = (int16_t)extend(bits.get(sz), sz);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    return kOk;
  }

  int read_scan(size_t p, int len, size_t& next) {
    if (!frame) return kCorrupt;
    const int ns = d[p];
    if (ns < 1 || ns > 4 || len < 6 + 2 * ns) return kCorrupt;
    std::vector<JComp*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = d[p + 1 + 2 * i];
      JComp* c = nullptr;
      for (JComp& k : comps)
        if (k.id == id) c = &k;
      if (!c) return kCorrupt;
      c->td = d[p + 2 + 2 * i] >> 4;
      c->ta = d[p + 2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].present || !ac[c->ta].present) return kCorrupt;
      if (!qt_present[c->tq]) return kCorrupt;
      sc.push_back(c);
    }
    const size_t q = p + 1 + 2 * ns;
    if (d[q] != 0 || d[q + 1] != 63 || d[q + 2] != 0) return kUnsupported;  // not sequential
    for (JComp* c : sc) c->dc_pred = 0;
    JBits bits{d, n, p + len - 2};
    // one component: one block per MCU over its own block grid
    const bool single = ns == 1;
    const int mx = single ? sc[0]->width_in_blocks : mcux;
    const int my = single ? sc[0]->height_in_blocks : mcuy;
    int todo = restart_interval;
    for (int y = 0; y < my; ++y) {
      for (int x = 0; x < mx; ++x) {
        if (restart_interval) {
          if (todo == 0) {
            bits.restart();
            for (JComp* c : sc) c->dc_pred = 0;
            todo = restart_interval;
          }
          --todo;
        }
        for (JComp* c : sc) {
          const int nh = single ? 1 : c->h, nv = single ? 1 : c->v;
          for (int by = 0; by < nv; ++by) {
            for (int bx = 0; bx < nh; ++bx) {
              const int row = y * nv + by, col = x * nh + bx;
              int16_t* blk = c->coef.data() + ((size_t)row * c->bw + col) * 64;
              const int rc = decode_block(bits, *c, blk);
              if (rc) return rc;
            }
          }
        }
      }
    }
    // the next marker follows the entropy-coded data
    size_t e = bits.pos;
    while (e + 1 < n && !(d[e] == 0xFF && d[e + 1] != 0x00 && !(d[e + 1] >= 0xD0 && d[e + 1] <= 0xD7)))
      ++e;
    next = e;
    return kOk;
  }

  int decode(std::vector<uint8_t>& gray) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kCorrupt;
    pos = 2;
    bool scanned = false;
    while (true) {
      while (pos < n && d[pos] != 0xFF) ++pos;  // garbage before a marker
      while (pos < n && d[pos] == 0xFF) ++pos;  // fill bytes
      if (pos >= n) break;
      const int m = d[pos++];
      if (m == 0xD9) break;  // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (pos + 2 > n) return kCorrupt;
      const int len = u16(pos);
      if (len < 2 || pos + len > n) return kCorrupt;
      const size_t body = pos + 2;
      int rc = kOk;
      if (m == 0xC4) {
        rc = read_dht(body, len);
      } else if (m == 0xDB) {
        rc = read_dqt(body, len);
      } else if (m == 0xDD) {
        if (len < 4) return kCorrupt;
        restart_interval = u16(body);
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        if (frame) return kCorrupt;
        rc = read_frame(body, len, m);
      } else if (m == 0xCC) {
        return kUnsupported;  // arithmetic-coding conditioning
      } else if (m == 0xEE) {
        if (len >= 14 && !std::memcmp(d + body, "Adobe", 5)) {
          adobe = true;
          adobe_transform = d[body + 11];
        }
      } else if (m == 0xDA) {
        if (frame && comps.size() == 3) {
          // libjpeg's colour space: an Adobe transform of 0 or the ids
          // 'R', 'G', 'B' mean RGB, which is not decoded here
          const bool rgb = adobe ? adobe_transform == 0
                                 : (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
          if (rgb) return kUnsupported;
        }
        size_t next = 0;
        rc = read_scan(body, len, next);
        if (rc) return rc;
        scanned = true;
        pos = next;
        continue;
      }
      if (rc) return rc;
      pos += len;
    }
    if (!frame || !scanned) return kCorrupt;
    // IDCT every block onto its component's plane, upsample, convert
    std::vector<std::vector<uint8_t>> full(comps.size());
    for (size_t ci = 0; ci < comps.size(); ++ci) {
      JComp& c = comps[ci];
      const int stride = c.bw * 8;
      std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, qt[c.tq],
                     plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
      upsample(c, plane.data(), stride, hmax / c.h, vmax / c.v, W, H, full[ci]);
    }
    if (comps.size() == 1) {
      gray.swap(full[0]);
      return kOk;
    }
    // jdcolor.c's build_ycc_rgb_table and ycc_rgb_convert
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = (int)((91881 * x + 32768) >> 16);
      cb_b[i] = (int)((116130 * x + 32768) >> 16);
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + 32768;
    }
    auto clamp = [](int v) { return v < 0 ? 0 : v > 255 ? 255 : v; };
    gray.assign((size_t)W * H, 0);
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
    for (size_t i = 0; i < (size_t)W * H; ++i) {
      const int y = Y[i], cb = Cb[i], cr = Cr[i];
      const int r = clamp(y + cr_r[cr]);
      const int g = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      const int b = clamp(y + cb_b[cb]);
      gray[i] = pil_luma(r, g, b);
    }
    return kOk;
  }
};

// ========================================================== PGM (P5)

int decode_pgm(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  size_t p = 2;
  int fields[3];
  for (int f = 0; f < 3; ++f) {
    while (p < n && (std::isspace(d[p]) || d[p] == '#')) {
      if (d[p] == '#')
        while (p < n && d[p] != '\n') ++p;
      else
        ++p;
    }
    if (p >= n || !std::isdigit(d[p])) return kCorrupt;
    int64_t v = 0;
    while (p < n && std::isdigit(d[p]) && v < (1 << 30)) v = v * 10 + (d[p++] - '0');
    fields[f] = (int)v;
  }
  w = fields[0];
  h = fields[1];
  if (fields[2] != 255) return kUnsupported;
  ++p;  // the one whitespace byte before the samples
  if (w <= 0 || h <= 0 || p + (size_t)w * h > n) return kCorrupt;
  gray.assign(d + p, d + p + (size_t)w * h);
  return kOk;
}

int decode_any(const uint8_t* d, size_t n, std::vector<uint8_t>& gray, int& w, int& h) {
  if (n >= 8 && !std::memcmp(d, kPngSig, 8)) return decode_png(d, n, gray, w, h);
  if (n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF) {
    JpegDecoder j(d, n);
    const int rc = j.decode(gray);
    w = j.W;
    h = j.H;
    return rc;
  }
  if (n >= 2 && d[0] == 'P' && d[1] == '5') return decode_pgm(d, n, gray, w, h);
  return kCorrupt;
}

int probe_size(const uint8_t* d, size_t n, int& w, int& h) {
  if (n >= 8 && !std::memcmp(d, kPngSig, 8)) {
    PngHeader hd;
    const int rc = png_header(d, n, hd);
    w = hd.w;
    h = hd.h;
    return rc;
  }
  if (n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF) {
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
        return kOk;
      }
      p += len;
    }
    return kCorrupt;
  }
  if (n >= 2 && d[0] == 'P' && d[1] == '5') {
    std::vector<uint8_t> gray;
    const int rc = decode_pgm(d, n, gray, w, h);
    return rc;
  }
  return kCorrupt;
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
  bool ok = false;
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
      fr.ok = decode_path_float(lefts[idx].c_str(), H, W, fr.left) == kOk &&
              decode_path_float(rights[idx].c_str(), H, W, fr.right) == kOk;
      if (fr.ok && rectify) {
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
    case kUnsupported: return "an image kind the decoder does not read";
    case kSize: return "the image size differs from the expected size";
    default: return "unknown error";
  }
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

// Blocks for the next frame in order: its index, −1 at the end, −2 when it
// failed to decode or had another size.
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
  if (!fr.ok) return -2;
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
