// Reverse the five PNG row filters (ISO/IEC 15948, section 9) of an
// inflated, non-interlaced image, on the host.
//
// Replaces the row reconstruction inside libpng, which cv2.imread runs in
// the JAX package's loader (monogs_tpu/data/datasets.py); there is no TPU
// kernel behind it. The plain version is
// monogs_tpu_torch/data/png.py::unfilter_plain (numpy), which the CPU path
// runs. Bound by memory: one byte read and one written per sample, a few
// integer operations each; rows depend on the row above and, for Sub,
// Average and Paeth, on the pixel to the left, so the loop is sequential.
// Called through ctypes, which releases the interpreter lock, so the
// prefetching loader's threads decode frames side by side.

#include <cstdint>
#include <cstdlib>

extern "C" {

// filtered: height rows of (1 filter byte + row_bytes); out: height *
// row_bytes; bpp: bytes per complete pixel (at least 1). Returns 0, or
// 1 + the row index of the first row with an unknown filter type.
int png_unfilter(const uint8_t* filtered, uint8_t* out, int height,
                 int row_bytes, int bpp) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = filtered + (size_t)y * (row_bytes + 1);
    const int ftype = src[0];
    ++src;
    uint8_t* cur = out + (size_t)y * row_bytes;
    const uint8_t* prev = y > 0 ? cur - row_bytes : nullptr;
    switch (ftype) {
      case 0:
        for (int i = 0; i < row_bytes; ++i) cur[i] = src[i];
        break;
      case 1:
        for (int i = 0; i < row_bytes; ++i)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < row_bytes; ++i)
          cur[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
