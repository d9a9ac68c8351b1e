// PNG row unfiltering on the host (png.py's decode step): no device code.
//
// `raw` holds `height` rows of one filter-type byte followed by `stride`
// filtered bytes; `out` receives the (height, stride) reconstructed bytes.
// `bpp` is the bytes per pixel, the distance to the "left" byte. Filters
// (PNG spec §9): 0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth; bytes left of
// the first pixel and the row above the first row read as 0. Built by
// ops/cuda_build.py with the kernels' flags and loaded with ctypes.

#include <cstdlib>

namespace {

inline unsigned char paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return (unsigned char)a;
  return (unsigned char)(pb <= pc ? b : c);
}

}  // namespace

extern "C" int png_unfilter(const unsigned char* raw, unsigned char* out, int height,
                            int stride, int bpp) {
  for (int y = 0; y < height; ++y) {
    const unsigned char* in = raw + (size_t)y * (stride + 1);
    unsigned char* cur = out + (size_t)y * stride;
    const unsigned char* up = y > 0 ? cur - stride : nullptr;
    const int f = in[0];
    ++in;
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
        default: return 1;
      }
      cur[i] = (unsigned char)(in[i] + pred);
    }
  }
  return 0;
}

extern "C" const char* png_unfilter_error_string(int code) {
  return code == 1 ? "invalid PNG filter type" : "unknown error";
}
