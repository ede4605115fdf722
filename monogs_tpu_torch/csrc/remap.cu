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
// One thread per output pixel, all channels; every float operation is an
// explicit round-to-nearest intrinsic, so none is contracted into a fused
// multiply-add and the results equal the plain version's bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void remap_kernel(const uint8_t* __restrict__ src,
                             const float* __restrict__ map_x,
                             const float* __restrict__ map_y,
                             uint8_t* __restrict__ dst, int src_h, int src_w,
                             int n_out, int channels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const float mx = map_x[i], my = map_y[i];
  const float fx = floorf(mx), fy = floorf(my);
  const float a = __fsub_rn(mx, fx), b = __fsub_rn(my, fy);
  // coordinates far outside read only the border: clamp before the cast
  const int x0 = (int)fminf(fmaxf(fx, -2.f), (float)src_w);
  const int y0 = (int)fminf(fmaxf(fy, -2.f), (float)src_h);
  const bool in_x0 = x0 >= 0 && x0 < src_w, in_x1 = x0 + 1 >= 0 && x0 + 1 < src_w;
  const bool in_y0 = y0 >= 0 && y0 < src_h, in_y1 = y0 + 1 >= 0 && y0 + 1 < src_h;
  const long long o00 = ((long long)y0 * src_w + x0) * channels;
  const long long o10 = o00 + (long long)src_w * channels;
  for (int c = 0; c < channels; ++c) {
    const float p00 = (in_y0 && in_x0) ? (float)src[o00 + c] : 0.f;
    const float p01 = (in_y0 && in_x1) ? (float)src[o00 + channels + c] : 0.f;
    const float p10 = (in_y1 && in_x0) ? (float)src[o10 + c] : 0.f;
    const float p11 = (in_y1 && in_x1) ? (float)src[o10 + channels + c] : 0.f;
    const float t0 = __fadd_rn(p00, __fmul_rn(a, __fsub_rn(p01, p00)));
    const float t1 = __fadd_rn(p10, __fmul_rn(a, __fsub_rn(p11, p10)));
    const float v = __fadd_rn(t0, __fmul_rn(b, __fsub_rn(t1, t0)));
    dst[(size_t)i * channels + c] =
        (uint8_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
  }
}

}  // namespace

extern "C" {

// src [src_h, src_w, channels], maps and dst [dst_h, dst_w(, channels)],
// all contiguous on the device; launches on ``stream``.
int remap_u8(const uint8_t* src, const float* map_x, const float* map_y,
             uint8_t* dst, int src_h, int src_w, int dst_h, int dst_w,
             int channels, cudaStream_t stream) {
  const int n = dst_h * dst_w;
  if (n == 0) return 0;
  const int threads = 256;
  remap_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      src, map_x, map_y, dst, src_h, src_w, n, channels);
  return (int)cudaGetLastError();
}

}  // extern "C"
