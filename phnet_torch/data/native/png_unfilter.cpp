// PNG scanline unfiltering of the port's PNG codec (phnet_torch/data/png.py,
// which loads it with ctypes; phnet_torch/ops/_build.py builds it with g++).
//
// The codec inflates a PNG's IDAT stream with Python's zlib; what comes out
// is one filter-type byte a row followed by the row's filtered bytes. The
// Sub, Average and Paeth filters predict each byte from the byte bpp places
// before it in the same row, already unfiltered, so a row is a sequential
// recurrence: this loop, not an array expression. png.py keeps a numpy
// plain version (unfilter_plain) that the tests hold this function to.
// No dependency beyond the C++ standard library.

#include <cstdlib>

namespace {

inline unsigned char paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<unsigned char>(a);
  if (pb <= pc) return static_cast<unsigned char>(b);
  return static_cast<unsigned char>(c);
}

}  // namespace

extern "C" {

// Undo the scanline filters of `height` rows of `rowbytes` bytes each.
// `filtered` holds height * (rowbytes + 1) bytes (a filter-type byte before
// each row), `out` receives height * rowbytes bytes; `bpp` is the bytes a
// complete pixel takes, at least 1 (PNG rounds sub-byte pixels up to 1).
// Returns 0, or 1 + the index of the first row whose filter type is not
// 0-4.
int png_unfilter(const unsigned char* filtered, int height, int rowbytes,
                 int bpp, unsigned char* out) {
  const unsigned char* prior = nullptr;  // the row above, unfiltered
  for (int y = 0; y < height; ++y) {
    const unsigned char* in = filtered + static_cast<long>(y) * (rowbytes + 1);
    const int type = in[0];
    ++in;
    unsigned char* row = out + static_cast<long>(y) * rowbytes;
    switch (type) {
      case 0:
        for (int x = 0; x < rowbytes; ++x) row[x] = in[x];
        break;
      case 1:
        for (int x = 0; x < rowbytes; ++x)
          row[x] = static_cast<unsigned char>(in[x] + (x >= bpp ? row[x - bpp]
                                                                : 0));
        break;
      case 2:
        for (int x = 0; x < rowbytes; ++x)
          row[x] = static_cast<unsigned char>(in[x] + (prior ? prior[x] : 0));
        break;
      case 3:
        for (int x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = prior ? prior[x] : 0;
          row[x] = static_cast<unsigned char>(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int x = 0; x < rowbytes; ++x) {
          const int a = x >= bpp ? row[x - bpp] : 0;
          const int b = prior ? prior[x] : 0;
          const int c = (prior && x >= bpp) ? prior[x - bpp] : 0;
          row[x] = static_cast<unsigned char>(in[x] + paeth(a, b, c));
        }
        break;
      default:
        return 1 + y;
    }
    prior = row;
  }
  return 0;
}

}  // extern "C"
