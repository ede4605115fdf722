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
// chroma samples read from cache.
//
// Design for the H100. A frame is a few microseconds of work, held by
// latency and the launch rather than by bandwidth: each thread makes four
// horizontal output pixels of a row on a 2-D grid (row, quad), so a
// 1200x680 frame is one wave of 256-thread CTAs and no thread divides.
// It reads its luma as one 32-bit word and writes its 12 output bytes as
// three. Doubled across, the four pixels need the chroma columns k-1 ..
// k+2 of their k (clamped at the edges, as libjpeg repeats the edge
// samples): each thread loads them once per plane and row and forms the
// triangle filter of all four in registers, in place of up to 8 loads a
// pixel. The last quad of a width that is not a multiple of 4, unaligned
// buffers and the replicated narrow planes (at most 2 samples across)
// take the per-pixel path. One pixel a thread, and coalescing the
// stores by warp shuffles, were timed against this layout on the card and
// were slower (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQuadsX = 32, kRowsY = 8;   // a CTA: 32 quads x 8 rows

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// chroma sample of output pixel (px, py); sx, sy the subsampling factors
__device__ __forceinline__ int chroma(const uint8_t* __restrict__ c, int px,
                                      int py, int ch, int cw, int sx,
                                      int sy) {
  if (sx == 1) return __ldg(c + py * cw + px);               // 4:4:4
  const int k = px >> 1;
  if (cw <= 2) return __ldg(c + (py / sy) * cw + k);         // box
  const bool odd = px & 1;
  const int kf = clampi(odd ? k + 1 : k - 1, 0, cw - 1);
  if (sy == 1)                                               // 4:2:2
    return (3 * __ldg(c + py * cw + k) + __ldg(c + py * cw + kf) +
            (odd ? 2 : 1)) >> 2;
  const int r = py >> 1;                                     // 4:2:0
  const int rf = clampi((py & 1) ? r + 1 : r - 1, 0, ch - 1);
  const int near = 3 * __ldg(c + r * cw + k) + __ldg(c + rf * cw + k);
  const int far = 3 * __ldg(c + r * cw + kf) + __ldg(c + rf * cw + kf);
  return (3 * near + far + (odd ? 7 : 8)) >> 4;
}

// libjpeg's conversion of one pixel into rgb[0..3)
__device__ __forceinline__ void convert(int Y, int cb, int cr,
                                        uint8_t* rgb) {
  const int u = cb - 128, v = cr - 128;
  // FIX(1.402), FIX(1.772), FIX(0.71414), FIX(0.34414); ONE_HALF 1 << 15
  rgb[0] = (uint8_t)clampi(Y + ((91881 * v + 32768) >> 16), 0, 255);
  rgb[1] = (uint8_t)clampi(Y + ((-22554 * u + 32768 - 46802 * v) >> 16), 0,
                           255);
  rgb[2] = (uint8_t)clampi(Y + ((116130 * u + 32768) >> 16), 0, 255);
}

// the four upsampled chroma samples of pixels x .. x + 3 (x a multiple of
// 4, the quad inside the row) of row py of plane c, doubled across (sx 2,
// cw > 2): from columns x/2 - 1 .. x/2 + 2, clamped
template <int SY>
__device__ __forceinline__ void chroma4(const uint8_t* __restrict__ c,
                                        int x, int py, int ch, int cw,
                                        int* out) {
  const int k = x >> 1;
  const int col[4] = {max(k - 1, 0), k, k + 1, min(k + 2, cw - 1)};
  int v[4];
  if (SY == 1) {                                             // 4:2:2
    const uint8_t* row = c + py * cw;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(row + col[j]);
    out[0] = (3 * v[1] + v[0] + 1) >> 2;
    out[1] = (3 * v[1] + v[2] + 2) >> 2;
    out[2] = (3 * v[2] + v[1] + 1) >> 2;
    out[3] = (3 * v[2] + v[3] + 2) >> 2;
    return;
  }
  const int r = py >> 1;                                     // 4:2:0
  const int rf = clampi((py & 1) ? r + 1 : r - 1, 0, ch - 1);
  const uint8_t* near = c + r * cw;
  const uint8_t* far = c + rf * cw;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = 3 * __ldg(near + col[j]) + __ldg(far + col[j]);
  out[0] = (3 * v[1] + v[0] + 8) >> 4;
  out[1] = (3 * v[1] + v[2] + 7) >> 4;
  out[2] = (3 * v[2] + v[1] + 8) >> 4;
  out[3] = (3 * v[2] + v[3] + 7) >> 4;
}

// SX, SY: the subsampling factors (SX 0: grey); vec: the width is a
// multiple of 4 and every plane and the output 4-byte aligned
template <int SX, int SY>
__global__ void __launch_bounds__(kQuadsX * kRowsY)
    ycc_rgb_kernel(const uint8_t* __restrict__ y,
                   const uint8_t* __restrict__ cb,
                   const uint8_t* __restrict__ cr,
                   uint8_t* __restrict__ out, int h, int w, int ch, int cw,
                   int vec) {
  const int py = blockIdx.y * kRowsY + threadIdx.y;
  const int x = (blockIdx.x * kQuadsX + threadIdx.x) * 4;
  if (py >= h || x >= w) return;
  const int i = py * w + x;
  if (vec && x + 4 <= w && !(SX == 2 && cw <= 2)) {
    const uint32_t yw = __ldg(reinterpret_cast<const uint32_t*>(y + i));
    uint8_t rgb[12];
    if (SX == 0) {                                           // grey
#pragma unroll
      for (int k = 0; k < 4; ++k)
        rgb[3 * k] = rgb[3 * k + 1] = rgb[3 * k + 2] =
            (uint8_t)(yw >> (8 * k));
    } else {
      int u[4], v[4];
      if (SX == 1) {                                         // 4:4:4
        const uint32_t bw =
            __ldg(reinterpret_cast<const uint32_t*>(cb + py * cw + x));
        const uint32_t rw =
            __ldg(reinterpret_cast<const uint32_t*>(cr + py * cw + x));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          u[k] = (bw >> (8 * k)) & 255;
          v[k] = (rw >> (8 * k)) & 255;
        }
      } else {
        chroma4<SY>(cb, x, py, ch, cw, u);
        chroma4<SY>(cr, x, py, ch, cw, v);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        convert((yw >> (8 * k)) & 255, u[k], v[k], rgb + 3 * k);
    }
    uint32_t* o = reinterpret_cast<uint32_t*>(out + (size_t)i * 3);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o[j] = (uint32_t)rgb[4 * j] | ((uint32_t)rgb[4 * j + 1] << 8) |
             ((uint32_t)rgb[4 * j + 2] << 16) |
             ((uint32_t)rgb[4 * j + 3] << 24);
    return;
  }
  const int n = min(4, w - x);
  for (int k = 0; k < n; ++k) {
    const int px = x + k;
    const int Y = __ldg(y + i + k);
    uint8_t* o = out + (size_t)(i + k) * 3;
    if (SX == 0) {
      o[0] = o[1] = o[2] = (uint8_t)Y;
    } else {
      convert(Y, chroma(cb, px, py, ch, cw, SX, SY),
              chroma(cr, px, py, ch, cw, SX, SY), o);
    }
  }
}

bool aligned4(const void* p) { return ((uintptr_t)p & 3) == 0; }

}  // namespace

extern "C" {

// y [h, w], cb and cr [ch, cw] (both null for grey), out [h, w, 3], all
// contiguous uint8 on the device; sx, sy in {1, 2}; launches on ``stream``.
int ycc_rgb_u8(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
               uint8_t* out, int h, int w, int ch, int cw, int sx, int sy,
               cudaStream_t stream) {
  if (h <= 0 || w <= 0) return 0;
  const int vec = w % 4 == 0 && aligned4(y) && aligned4(out) &&
                  (cb == nullptr || (aligned4(cb) && aligned4(cr)));
  const dim3 block(kQuadsX, kRowsY);
  const dim3 grid(((w + 3) / 4 + kQuadsX - 1) / kQuadsX,
                  (h + kRowsY - 1) / kRowsY);
  if (cb == nullptr)
    ycc_rgb_kernel<0, 1><<<grid, block, 0, stream>>>(y, cb, cr, out, h, w,
                                                     ch, cw, vec);
  else if (sx == 1)
    ycc_rgb_kernel<1, 1><<<grid, block, 0, stream>>>(y, cb, cr, out, h, w,
                                                     ch, cw, vec);
  else if (sy == 1)
    ycc_rgb_kernel<2, 1><<<grid, block, 0, stream>>>(y, cb, cr, out, h, w,
                                                     ch, cw, vec);
  else
    ycc_rgb_kernel<2, 2><<<grid, block, 0, stream>>>(y, cb, cr, out, h, w,
                                                     ch, cw, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
