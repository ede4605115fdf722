// Bilinear remap of a uint8 image through float32 maps, border value 0:
// cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR) as OpenCV computes it in
// float arithmetic (two lerps along x, one along y, rounded half to even).
//
// Replaces the cv2.remap calls of the JAX package's undistortion and
// stereo rectification (monogs_tpu/data/datasets.py, MonocularDataset and
// StereoDataset.__getitem__); there is no TPU kernel behind them. Plain
// version: monogs_tpu_torch/data/undistort.py::remap_plain. Bound by
// memory: per output pixel two map floats and one output byte a channel,
// the four source texels read mostly from cache (the maps move slowly).
//
// Design for the H100. A frame is a few microseconds of work, held by
// the launch and by latency rather than by bandwidth (an empty kernel on
// the same grid takes 2.1-2.7 us on the card). One thread makes one output
// pixel, all channels, on a 2-D grid (row, column) with no integer
// division; sources and maps go through the read-only path; a pixel whose
// four taps lie inside the image skips the border tests; gridDim.z is the
// image, so a stereo pair is remapped in one launch. Four pixels a thread
// (float4 maps, packed 32-bit stores, one wave at 640x480), two a thread,
// 32-bit source words and 128-thread CTAs were each timed against this
// layout on the card and were slower or no faster on RGB or grey
// (PERF.md): with one pixel a thread the card has the most gathers in
// flight.
// Every float operation is an explicit round-to-nearest intrinsic, so
// none is contracted into a fused multiply-add and the results equal the
// plain version's bit for bit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Image {
  const uint8_t* src;
  const float* map_x;
  const float* map_y;
  uint8_t* dst;
};

struct Images {
  Image im[2];
};

constexpr int kThreadsX = 32, kRowsY = 8;   // a CTA: 32 pixels x 8 rows

// where one output pixel samples: the top-left tap and the weights
struct Taps {
  float a, b;
  int x0, y0;
};

__device__ __forceinline__ Taps taps_of(float mx, float my, int src_h,
                                        int src_w) {
  const float fx = floorf(mx), fy = floorf(my);
  Taps t;
  t.a = __fsub_rn(mx, fx);
  t.b = __fsub_rn(my, fy);
  // coordinates far outside read only the border: clamp before the cast
  t.x0 = (int)fminf(fmaxf(fx, -2.f), (float)src_w);
  t.y0 = (int)fminf(fmaxf(fy, -2.f), (float)src_h);
  return t;
}

__device__ __forceinline__ bool inside(const Taps& t, int src_h,
                                       int src_w) {
  return t.x0 >= 0 && t.x0 + 1 < src_w && t.y0 >= 0 && t.y0 + 1 < src_h;
}

// the nc channels of one output pixel into out[0..nc); INSIDE: all four
// taps lie in the image, none is tested
template <bool INSIDE>
__device__ __forceinline__ void sample(const uint8_t* __restrict__ src,
                                       const Taps& t, int src_h, int src_w,
                                       int nc, uint8_t* out) {
  bool in00 = true, in01 = true, in10 = true, in11 = true;
  if (!INSIDE) {
    const bool in_x0 = t.x0 >= 0 && t.x0 < src_w;
    const bool in_x1 = t.x0 + 1 >= 0 && t.x0 + 1 < src_w;
    const bool in_y0 = t.y0 >= 0 && t.y0 < src_h;
    const bool in_y1 = t.y0 + 1 >= 0 && t.y0 + 1 < src_h;
    in00 = in_y0 && in_x0;
    in01 = in_y0 && in_x1;
    in10 = in_y1 && in_x0;
    in11 = in_y1 && in_x1;
  }
  const int o00 = (t.y0 * src_w + t.x0) * nc;
  const int o10 = o00 + src_w * nc;
  for (int c = 0; c < nc; ++c) {
    const float p00 = in00 ? (float)__ldg(src + o00 + c) : 0.f;
    const float p01 = in01 ? (float)__ldg(src + o00 + nc + c) : 0.f;
    const float p10 = in10 ? (float)__ldg(src + o10 + c) : 0.f;
    const float p11 = in11 ? (float)__ldg(src + o10 + nc + c) : 0.f;
    const float t0 = __fadd_rn(p00, __fmul_rn(t.a, __fsub_rn(p01, p00)));
    const float t1 = __fadd_rn(p10, __fmul_rn(t.a, __fsub_rn(p11, p10)));
    const float v = __fadd_rn(t0, __fmul_rn(t.b, __fsub_rn(t1, t0)));
    out[c] = (uint8_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
  }
}

// C: the channels, 1 or 3 (0: ``channels`` at run time)
template <int C>
__global__ void __launch_bounds__(kThreadsX * kRowsY)
    remap_kernel(Images ims, int src_h, int src_w, int dst_h, int dst_w,
                 int channels) {
  const int y = blockIdx.y * kRowsY + threadIdx.y;
  const int x = blockIdx.x * kThreadsX + threadIdx.x;
  if (y >= dst_h || x >= dst_w) return;
  const Image im = blockIdx.z ? ims.im[1] : ims.im[0];
  const int nc = C > 0 ? C : channels;
  const int i = y * dst_w + x;
  const Taps t = taps_of(__ldg(im.map_x + i), __ldg(im.map_y + i), src_h,
                         src_w);
  uint8_t* out = im.dst + (size_t)i * nc;
  if (inside(t, src_h, src_w))
    sample<true>(im.src, t, src_h, src_w, nc, out);
  else
    sample<false>(im.src, t, src_h, src_w, nc, out);
}

int launch(const Images& ims, int n, int src_h, int src_w, int dst_h,
           int dst_w, int channels, cudaStream_t stream) {
  if (dst_h <= 0 || dst_w <= 0) return 0;
  // offsets are 32-bit: the source with its border taps and the output
  if ((long long)(src_h + 2) * (src_w + 2) * channels >= INT_MAX ||
      (long long)dst_h * dst_w * channels >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kThreadsX, kRowsY);
  const dim3 grid((dst_w + kThreadsX - 1) / kThreadsX,
                  (dst_h + kRowsY - 1) / kRowsY, n);
  if (channels == 1)
    remap_kernel<1><<<grid, block, 0, stream>>>(ims, src_h, src_w, dst_h,
                                                dst_w, channels);
  else if (channels == 3)
    remap_kernel<3><<<grid, block, 0, stream>>>(ims, src_h, src_w, dst_h,
                                                dst_w, channels);
  else
    remap_kernel<0><<<grid, block, 0, stream>>>(ims, src_h, src_w, dst_h,
                                                dst_w, channels);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// src [src_h, src_w, channels], maps and dst [dst_h, dst_w(, channels)],
// all contiguous on the device; launches on ``stream``.
int remap_u8(const uint8_t* src, const float* map_x, const float* map_y,
             uint8_t* dst, int src_h, int src_w, int dst_h, int dst_w,
             int channels, cudaStream_t stream) {
  Images ims = {};
  ims.im[0] = {src, map_x, map_y, dst};
  return launch(ims, 1, src_h, src_w, dst_h, dst_w, channels, stream);
}

// two images of one shape through maps of one shape (a stereo pair), in
// one launch: what remap_u8 gives for each
int remap_pair_u8(const uint8_t* src0, const float* map_x0,
                  const float* map_y0, uint8_t* dst0, const uint8_t* src1,
                  const float* map_x1, const float* map_y1, uint8_t* dst1,
                  int src_h, int src_w, int dst_h, int dst_w, int channels,
                  cudaStream_t stream) {
  Images ims = {};
  ims.im[0] = {src0, map_x0, map_y0, dst0};
  ims.im[1] = {src1, map_x1, map_y1, dst1};
  return launch(ims, 2, src_h, src_w, dst_h, dst_w, channels, stream);
}

}  // extern "C"
