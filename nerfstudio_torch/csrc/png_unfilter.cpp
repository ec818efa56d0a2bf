// PNG row filters undone on the host (PNG spec section 9): None, Sub, Up,
// Average and Paeth, on bytes mod 256. Each byte depends on the decoded
// byte bpp to its left and on the row above, so the rows are walked in
// order, one byte at a time. Plain C interface, loaded with ctypes.

#include <cstdint>
#include <cstdlib>

// raw: h rows of (filter type, stride bytes); out: h * stride bytes.
// Returns 0, or 1 + the first row whose filter type is unknown.
extern "C" int64_t nst_png_unfilter(const uint8_t* raw, uint8_t* out, int64_t h, int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* line = raw + y * (stride + 1) + 1;
    const uint8_t kind = line[-1];
    uint8_t* cur = out + y * stride;
    const uint8_t* up = y > 0 ? cur - stride : nullptr;
    if (kind > 4) return 1 + y;
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      int pred = 0;
      if (kind == 1) {
        pred = a;
      } else if (kind == 2) {
        pred = b;
      } else if (kind == 3) {
        pred = (a + b) >> 1;
      } else if (kind == 4) {
        const int c = up && i >= bpp ? up[i - bpp] : 0;
        const int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
        pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
      }
      cur[i] = static_cast<uint8_t>(line[i] + pred);
    }
  }
  return 0;
}
