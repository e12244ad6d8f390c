// PNG row reconstruction (the inverse of the five row filters of the PNG
// specification, section 9), for data/image.py's decoder: the sub, average
// and Paeth filters read the byte just reconstructed to their left, a
// dependence that numpy cannot vectorise along a row.

#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: h rows of (1 filter byte + stride bytes), as inflated from IDAT.
// out: h x stride reconstructed bytes. bpp: bytes a complete pixel (>= 1).
// Returns 0, or -1 - r for the first row r with an unknown filter type.
int png_unfilter(const uint8_t* raw, int h, int stride, int bpp, uint8_t* out) {
  for (int r = 0; r < h; ++r) {
    const uint8_t kind = raw[static_cast<long long>(r) * (stride + 1)];
    const uint8_t* line = raw + static_cast<long long>(r) * (stride + 1) + 1;
    uint8_t* cur = out + static_cast<long long>(r) * stride;
    const uint8_t* prev = r ? cur - stride : nullptr;
    if (kind > 4) return -1 - r;
    for (int i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = prev ? prev[i] : 0;
      const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
      int pred = 0;
      switch (kind) {
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: break;
      }
      cur[i] = static_cast<uint8_t>((line[i] + pred) & 0xFF);
    }
  }
  return 0;
}

}  // extern "C"
