// JPEG chroma upsampling and YCbCr -> RGB conversion as libjpeg does them,
// on the planes nvJPEG decodes (luma at full size, chroma at the stream's
// subsampling), into interleaved uint8 RGB.
//
// Replaces the last two steps of cv2.imread of a JPEG file in the JAX
// package (monogs_tpu/data/datasets.py, ReplicaDataset's colour frames):
// libjpeg's fancy upsampling (jdsample.c: the triangle filter, 3/4 of the
// nearer chroma sample and 1/4 of the further one in each doubled
// direction, edge samples repeated, alternating rounding biases; a plane
// doubled across from at most 2 samples is replicated) and its 16-bit
// fixed-point colour conversion (jdcolor.c). There is no TPU kernel behind
// it. Plain version: monogs_tpu_torch/data/jpeg.py::ycc_to_rgb_plain,
// which equals libjpeg bit for bit on planes it decodes exactly. Integer
// arithmetic only, so the kernel equals the plain version bit for bit.
// Bound by memory: one luma byte and three output bytes per pixel, the
// chroma samples read from cache. One thread per output pixel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// chroma sample of output pixel (px, py); sx, sy the subsampling factors
__device__ __forceinline__ int chroma(const uint8_t* __restrict__ c, int px,
                                      int py, int ch, int cw, int sx,
                                      int sy) {
  if (sx == 1) return c[py * cw + px];                      // 4:4:4
  const int k = px >> 1;
  if (cw <= 2) return c[(py / sy) * cw + k];                // box
  const bool odd = px & 1;
  const int kf = clampi(odd ? k + 1 : k - 1, 0, cw - 1);
  if (sy == 1)                                              // 4:2:2
    return (3 * c[py * cw + k] + c[py * cw + kf] + (odd ? 2 : 1)) >> 2;
  const int r = py >> 1;                                    // 4:2:0
  const int rf = clampi((py & 1) ? r + 1 : r - 1, 0, ch - 1);
  const int near = 3 * c[r * cw + k] + c[rf * cw + k];
  const int far = 3 * c[r * cw + kf] + c[rf * cw + kf];
  return (3 * near + far + (odd ? 7 : 8)) >> 4;
}

__global__ void ycc_rgb_kernel(const uint8_t* __restrict__ y,
                               const uint8_t* __restrict__ cb,
                               const uint8_t* __restrict__ cr,
                               uint8_t* __restrict__ out, int h, int w,
                               int ch, int cw, int sx, int sy) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h * w) return;
  const int py = i / w, px = i - py * w;
  const int Y = y[i];
  uint8_t* o = out + (size_t)i * 3;
  if (cb == nullptr) {                       // grey: Y repeated
    o[0] = o[1] = o[2] = (uint8_t)Y;
    return;
  }
  const int u = chroma(cb, px, py, ch, cw, sx, sy) - 128;
  const int v = chroma(cr, px, py, ch, cw, sx, sy) - 128;
  // FIX(1.402), FIX(1.772), FIX(0.71414), FIX(0.34414); ONE_HALF 1 << 15
  const int r = Y + ((91881 * v + 32768) >> 16);
  const int g = Y + ((-22554 * u + 32768 - 46802 * v) >> 16);
  const int b = Y + ((116130 * u + 32768) >> 16);
  o[0] = (uint8_t)clampi(r, 0, 255);
  o[1] = (uint8_t)clampi(g, 0, 255);
  o[2] = (uint8_t)clampi(b, 0, 255);
}

}  // namespace

extern "C" {

// y [h, w], cb and cr [ch, cw] (both null for grey), out [h, w, 3], all
// contiguous uint8 on the device; sx, sy in {1, 2}; launches on ``stream``.
int ycc_rgb_u8(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
               uint8_t* out, int h, int w, int ch, int cw, int sx, int sy,
               cudaStream_t stream) {
  const int n = h * w;
  if (n == 0) return 0;
  const int threads = 256;
  ycc_rgb_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      y, cb, cr, out, h, w, ch, cw, sx, sy);
  return (int)cudaGetLastError();
}

}  // extern "C"
