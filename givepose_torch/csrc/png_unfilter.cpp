// PNG row unfiltering (PNG 1.2 section 9) for givepose_torch/data/png.py.
//
// A host library, built with g++ (ops/_build.py build_host): the decoder
// inflates with Python's zlib and hands the filtered rows here.  Sub, Up,
// Average and Paeth are recurrences along a row (each byte depends on the
// one bpp bytes to its left, already unfiltered), which a Python loop
// takes seconds for per 640 x 480 image.

#include <cstdint>
#include <cstdlib>

extern "C" {

// in:  height rows of (1 filter byte + rowbytes bytes), as inflated;
// out: height * rowbytes unfiltered bytes.
// bpp: bytes per complete pixel, at least 1.
// Returns 0, or the 1-based row whose filter type is not 0..4.
int64_t png_unfilter(const uint8_t* in, uint8_t* out, int64_t height,
                     int64_t rowbytes, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = in + y * (rowbytes + 1);
    const uint8_t filter = src[0];
    ++src;
    uint8_t* cur = out + y * rowbytes;
    const uint8_t* prev = y > 0 ? out + (y - 1) * rowbytes : nullptr;
    switch (filter) {
      case 0:
        for (int64_t i = 0; i < rowbytes; ++i) cur[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = uint8_t(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = uint8_t(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = uint8_t(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = uint8_t(src[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
