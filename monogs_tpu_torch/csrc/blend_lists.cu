// Hand-written Hopper (sm_90a) kernels for the per-tile list blend.
//
// Counterparts of the four Pallas TPU kernels of the tracking path in
// monogs_tpu/render/pallas_lists.py:
//   blend_fwd (COUNTS=false)  <- _fwd_kernel         (blend_lists_pallas)
//   blend_fwd (COUNTS=true)   <- _fwd_counts_kernel  (blend_lists_pallas_counts)
//   blend_fo_grad             <- _fo_grad_kernel     (fo_grad_lists_pallas)
//   blend_jvp8                <- _jvp8_kernel        (blend_lists_jvp8)
//
// Input contract (unchanged from the TPU kernels): d [T, K, 16] packed
// depth-ordered rows per tile with the column layout of renderer._F (u, v,
// conic a/b/c, opacity, rgb, z, radius, log-opacity, pad); invalid rows carry
// LOGO = -1e30 so they never pass the alpha test. Outputs [T, P, 8] hold
// (r, g, b, depth, acc, 0, 0, 0) per pixel.
//
// Design: one CTA per tile, one thread per pixel (P = tile*tile = 256 at the
// shipped config), the shape of the CUDA 3DGS rasterizer. Rows are staged in
// shared memory KC at a time; each thread walks them front to back with its
// own transmittance in a register. What the TPU kernel needed for Mosaic
// (tile batching, bf16x3 matmuls, block-diagonal feature matrices, K-chunk
// VMEM budgets) is gone: the feature reduction is an f32 multiply-add per
// thread.
//
// Bound on the H100: every (row, pixel) pair a pixel walks costs 26 f32
// operations to evaluate alpha (expf is 10 of them); a contributing pair
// adds 13 for the forward blend, 43 (64 for RGB-D) for the fused
// first-order step and 229 for the six-tangent pass. At the tracking
// shapes that is 20-49 operations per byte moved, at or above the card's
// FP32-to-HBM ratio of 20, so the FP32 pipes, not HBM, bound every kernel
// (chip_smoke.py counts the pairs). The per-pixel early exit
// (T * (1 - alpha) < 1e-4) skips the rows behind opaque surfaces, and a CTA
// stops staging rows once every pixel has exited.
//
// Numerics: the per-pixel early exit is exact, because T is non-increasing:
// once T * (1 - a) < 1e-4 no later row can contribute (renderer.py:151-155).
// `ok` (the alpha test) and `contrib` (ok and not terminated) stay separate,
// as in the TPU kernel. The library is built with -fmad=false and without
// fast math, so that s, alpha and T round exactly as the plain PyTorch
// version's elementwise ops do and the 1/255 and 1e-4 threshold decisions
// agree with it.
//
// Each C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int F = 16;
constexpr int CU = 0, CV = 1, CA = 2, CB = 3, CC = 4, R0 = 6, G0 = 7, B0 = 8,
              CZ = 9, LOGO = 11;
constexpr int KC = 32;       // rows staged in shared memory per step
constexpr int NTAN = 6;      // pose tangents of the jvp8 kernel
constexpr float T_EPS = 1e-4f;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);

struct RowEval {
  float dx, dy, alpha;
  bool ok;
};

// Log-alpha of one row at one pixel, alpha and the alpha test, in the op
// order of the plain version (blend_lists._forward_plain).
__device__ __forceinline__ RowEval eval_row(const float* r, float x0, float y0,
                                            float pxl, float pyl,
                                            bool pix_ok) {
  RowEval e;
  const float ul = r[CU] - x0;
  const float vl = r[CV] - y0;
  e.dx = ul - pxl;
  e.dy = vl - pyl;
  const float s = -0.5f * (r[CA] * e.dx * e.dx + r[CC] * e.dy * e.dy) -
                  r[CB] * e.dx * e.dy + r[LOGO];
  const float alpha = fminf(0.99f, expf(fminf(s, 2.0f)));
  e.ok = pix_ok && (s <= r[LOGO] + 1e-4f) && (alpha >= ALPHA_MIN);
  e.alpha = e.ok ? alpha : 0.0f;
  return e;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int n_floats) {
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ void store8(float* out, const float* v5) {
  float4* o = reinterpret_cast<float4*>(out);
  o[0] = make_float4(v5[0], v5[1], v5[2], v5[3]);
  o[1] = make_float4(v5[4], 0.f, 0.f, 0.f);
}

// ---------------------------------------------------------------- forward --
// Shared memory: rows [KC][F], and for COUNTS per-warp popcounts [KC][nw].
template <bool COUNTS>
__global__ void fwd_kernel(const float* __restrict__ d,
                           const float* __restrict__ tx0,
                           const float* __restrict__ ty0,
                           const float* __restrict__ pmat,
                           float* __restrict__ outs, float* __restrict__ cnts,
                           int kf, int width, int height) {
  extern __shared__ float smem[];
  float* rows = smem;
  int* wcnt = reinterpret_cast<int*>(smem + KC * F);
  const int P = blockDim.x;
  const int nw = P >> 5;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float x0 = tx0[t], y0 = ty0[t];
  const float pxl = pmat[3 * P + p], pyl = pmat[4 * P + p];
  const bool pix_ok = (x0 + pxl <= (float)(width - 1)) &&
                      (y0 + pyl <= (float)(height - 1));
  const float* dt = d + (size_t)t * kf * F;

  float T = 1.0f;
  float o[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  bool done = false;
  for (int k0 = 0; k0 < kf; k0 += KC) {
    const int n = min(KC, kf - k0);
    __syncthreads();
    stage_rows(rows, dt + (size_t)k0 * F, n * F);
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* r = rows + i * F;
      bool contrib = false;
      if (!done) {
        const RowEval e = eval_row(r, x0, y0, pxl, pyl, pix_ok);
        if (e.ok) {
          const float test = T * (1.0f - e.alpha);
          if (test < T_EPS) {
            done = true;
          } else {
            const float w = e.alpha * T;
            o[0] += w * r[R0];
            o[1] += w * r[G0];
            o[2] += w * r[B0];
            o[3] += w * r[CZ];
            o[4] += w;
            T = test;
            contrib = true;
          }
        }
      }
      if constexpr (COUNTS) {
        const unsigned b = __ballot_sync(0xffffffffu, contrib);
        if ((p & 31) == 0) wcnt[i * nw + (p >> 5)] = __popc(b);
      }
    }
    const bool all_done = __syncthreads_and(done);
    if constexpr (COUNTS) {
      for (int i = p; i < n; i += P) {
        int s = 0;
        for (int w = 0; w < nw; ++w) s += wcnt[i * nw + w];
        cnts[(size_t)t * kf + k0 + i] = (float)s;
      }
      if (all_done) {
        for (int k = k0 + n + p; k < kf; k += P) cnts[(size_t)t * kf + k] = 0.f;
      }
    }
    if (all_done) break;
  }
  store8(outs + ((size_t)t * P + p) * 8, o);
}

// ------------------------------------------------- fused first-order step --
// Forward blend, exposure + masked signed-sqrt Huber residual, analytic
// output cotangents, reverse blend, per-row reductions. RGBD adds the second
// reverse chain of the (globally normalized) depth term.
//
// Shared memory: rows [KC][F] | ck [nch][P] transmittance at each chunk
// entry | tex [KC][P] per-row T_excl of the chunk being reversed |
// red [KC][nw][NV] per-warp row sums | bsum [nw][5].
template <bool RGBD>
__global__ void fo_grad_kernel(
    const float* __restrict__ d, const float* __restrict__ tx0,
    const float* __restrict__ ty0, const float* __restrict__ pmat,
    const float* __restrict__ gt, const float* __restrict__ mask,
    const float* __restrict__ gtd, const float* __restrict__ sc,
    float* __restrict__ dd, float* __restrict__ dd_dep,
    float* __restrict__ sums, int kf, int width, int height, int use_huber,
    float delta, float two_delta, float delta_sq, float eps) {
  constexpr int NV = RGBD ? 17 : 10;
  extern __shared__ float smem[];
  const int P = blockDim.x;
  const int nw = P >> 5;
  const int nch = (kf + KC - 1) / KC;
  float* rows = smem;
  float* ck = rows + KC * F;
  float* tex = ck + nch * P;
  float* red = tex + KC * P;
  float* bsum = red + KC * nw * NV;

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5;
  const float x0 = tx0[t], y0 = ty0[t];
  const float pxl = pmat[3 * P + p], pyl = pmat[4 * P + p];
  float pm[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) pm[j] = pmat[j * P + p];
  const bool pix_ok = (x0 + pxl <= (float)(width - 1)) &&
                      (y0 + pyl <= (float)(height - 1));
  const float* dt = d + (size_t)t * kf * F;

  // ---- forward: outputs, chunk-entry checkpoints, first terminated row
  float T = 1.0f;
  float o[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  int kend = kf;
  for (int c = 0; c < nch; ++c) {
    const int k0 = c * KC;
    const int n = min(KC, kf - k0);
    ck[c * P + p] = T;
    __syncthreads();
    stage_rows(rows, dt + (size_t)k0 * F, n * F);
    __syncthreads();
    if (kend < kf) continue;
    for (int i = 0; i < n; ++i) {
      const float* r = rows + i * F;
      const RowEval e = eval_row(r, x0, y0, pxl, pyl, pix_ok);
      if (!e.ok) continue;
      const float test = T * (1.0f - e.alpha);
      if (test < T_EPS) {
        kend = k0 + i;
        break;
      }
      const float w = e.alpha * T;
      o[0] += w * r[R0];
      o[1] += w * r[G0];
      o[2] += w * r[B0];
      o[3] += w * r[CZ];
      o[4] += w;
      T = test;
    }
  }

  // ---- residual chain and output cotangents (ops/losses semantics)
  const float e_a = fabsf(sc[0]) + eps;
  const float e_b = sc[1];
  const float acc = o[4];
  const float mk = mask[(size_t)t * P + p];
  const float am = acc * mk;
  float g[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // d(sum hub^2)/d(r, g, b, -, acc)
  float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sumsq, l1, gea, geb, sd
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float col = o[ch];
    const float diff = (e_a * col + e_b) - gt[((size_t)t * P + p) * 3 + ch];
    const float r = am * diff;
    const float ax = fabsf(r);
    float hub = r, slope = 1.0f;
    if (use_huber && !(ax < delta)) {
      const float safe = sqrtf(fmaxf(two_delta * ax - delta_sq, 1e-20f));
      const float sgn = r > 0.f ? 1.f : (r < 0.f ? -1.f : 0.f);
      hub = sgn * safe;
      slope = delta / safe;
    }
    const float rbar = 2.0f * hub * slope;
    g[ch] = rbar * am * e_a;
    g[4] += rbar * mk * diff;
    part[0] += hub * hub;
    part[1] += ax;
    part[2] += rbar * am * col;
    part[3] += rbar * am;
  }
  float gd3 = 0.f;
  if constexpr (RGBD) {
    const float gz = gtd[(size_t)t * P + p];
    const bool dm = (gz > 0.01f) && (acc > 0.95f);
    const float r_d = dm ? o[3] - gz : 0.0f;
    gd3 = 2.0f * r_d;
    part[4] = r_d * r_d;
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float v = warp_sum(part[j]);
    if (lane == 0) bsum[warp * 5 + j] = v;
  }
  __syncthreads();
  if (p < 8) {
    float v = 0.f;
    if (p < 5)
      for (int w = 0; w < nw; ++w) v += bsum[w * 5 + p];
    sums[(size_t)t * 8 + p] = v;
  }

  // ---- reverse blend, back to front, chunk by chunk from the checkpoints
  float S = 0.f, Sd = 0.f;  // suffix sums of wbar * w (rgb and depth chains)
  for (int c = nch - 1; c >= 0; --c) {
    const int k0 = c * KC;
    const int n = min(KC, kf - k0);
    __syncthreads();
    stage_rows(rows, dt + (size_t)k0 * F, n * F);
    __syncthreads();
    float Tc = ck[c * P + p];
    for (int i = 0; i < n; ++i) {
      tex[i * P + p] = Tc;
      if (k0 + i < kend) {
        const RowEval e = eval_row(rows + i * F, x0, y0, pxl, pyl, pix_ok);
        Tc *= (1.0f - e.alpha);
      }
    }
    for (int i = n - 1; i >= 0; --i) {
      const float* r = rows + i * F;
      const RowEval e = eval_row(r, x0, y0, pxl, pyl, pix_ok);
      const bool contrib = e.ok && (k0 + i < kend);
      const float tx = tex[i * P + p];
      const float om = 1.0f - e.alpha;
      const float w = contrib ? e.alpha * tx : 0.0f;
      const bool live = e.ok && (e.alpha < 0.99f);
      float v[NV];
      {
        const float wbar =
            r[R0] * g[0] + r[G0] * g[1] + r[B0] * g[2] + g[4];
        const float obar = S / om;
        const float abar = (contrib ? tx * wbar : 0.0f) - obar;
        S += wbar * w;
        const float sbar = live ? e.alpha * abar : 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) v[j] = sbar * pm[j];
        v[6] = w * g[0];
        v[7] = w * g[1];
        v[8] = w * g[2];
        v[9] = 0.0f;  // mono output cotangent has no depth column
      }
      if constexpr (RGBD) {
        const float wbar = r[CZ] * gd3;
        const float obar = Sd / om;
        const float abar = (contrib ? tx * wbar : 0.0f) - obar;
        Sd += wbar * w;
        const float sbar = live ? e.alpha * abar : 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) v[10 + j] = sbar * pm[j];
        v[NV - 1] = w * gd3;
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float s = warp_sum(v[j]);
        if (lane == 0) red[(i * nw + warp) * NV + j] = s;
      }
    }
    __syncthreads();
    for (int i = p; i < n; i += P) {
      const float* r = rows + i * F;
      float tot[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float s = 0.f;
        for (int w = 0; w < nw; ++w) s += red[(i * nw + w) * NV + j];
        tot[j] = s;
      }
      const float a = r[CA], b = r[CB], cc = r[CC];
      const float ul = r[CU] - x0, vl = r[CV] - y0;
      const int nchain = RGBD ? 2 : 1;
      for (int chn = 0; chn < nchain; ++chn) {
        const float* G = tot + chn * 10;
        float out[F];
#pragma unroll
        for (int j = 0; j < F; ++j) out[j] = 0.f;
        out[CU] = a * G[3] + b * G[4] - (a * ul + b * vl) * G[5];
        out[CV] = b * G[3] + cc * G[4] - (b * ul + cc * vl) * G[5];
        out[CA] = -0.5f * G[0] + ul * G[3] - 0.5f * ul * ul * G[5];
        out[CB] = -G[1] + vl * G[3] + ul * G[4] - ul * vl * G[5];
        out[CC] = -0.5f * G[2] + vl * G[4] - 0.5f * vl * vl * G[5];
        out[LOGO] = G[5];
        if (chn == 0) {
          out[R0] = G[6];
          out[G0] = G[7];
          out[B0] = G[8];
          out[CZ] = G[9];
        } else {
          out[CZ] = G[6];
        }
        float* dst = (chn == 0 ? dd : dd_dep) + ((size_t)t * kf + k0 + i) * F;
        float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          d4[j] = make_float4(out[4 * j], out[4 * j + 1], out[4 * j + 2],
                              out[4 * j + 3]);
      }
    }
  }
}

// ------------------------------------------------ primal + 6 pose tangents --
// Shared memory: rows [KC][F] | tangent rows [KC][NTAN][F].
__global__ void jvp8_kernel(const float* __restrict__ d,
                            const float* __restrict__ d_tan,
                            const float* __restrict__ tx0,
                            const float* __restrict__ ty0,
                            const float* __restrict__ pmat,
                            float* __restrict__ outs,
                            float* __restrict__ touts, int kf, int width,
                            int height) {
  extern __shared__ float smem[];
  float* rows = smem;
  float* trows = smem + KC * F;
  const int P = blockDim.x;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float x0 = tx0[t], y0 = ty0[t];
  const float pxl = pmat[3 * P + p], pyl = pmat[4 * P + p];
  const bool pix_ok = (x0 + pxl <= (float)(width - 1)) &&
                      (y0 + pyl <= (float)(height - 1));
  const float* dt = d + (size_t)t * kf * F;
  const float* dtt = d_tan + (size_t)t * NTAN * kf * F;

  float T = 1.0f;
  float o[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float pre[NTAN];      // tangent of log T: sum of -alpha_t / (1 - alpha)
  float to[NTAN][5];
#pragma unroll
  for (int j = 0; j < NTAN; ++j) {
    pre[j] = 0.f;
#pragma unroll
    for (int c = 0; c < 5; ++c) to[j][c] = 0.f;
  }
  bool done = false;
  for (int k0 = 0; k0 < kf; k0 += KC) {
    const int n = min(KC, kf - k0);
    __syncthreads();
    stage_rows(rows, dt + (size_t)k0 * F, n * F);
    for (int idx = p; idx < NTAN * n * F; idx += P) {
      const int j = idx / (n * F);
      const int rem = idx - j * n * F;  // i * F + f
      trows[(rem / F) * NTAN * F + j * F + (rem % F)] =
          dtt[((size_t)j * kf + k0) * F + rem];
    }
    __syncthreads();
    for (int i = 0; i < n && !done; ++i) {
      const float* r = rows + i * F;
      const RowEval e = eval_row(r, x0, y0, pxl, pyl, pix_ok);
      if (!e.ok) continue;
      const float om = 1.0f - e.alpha;
      const float test = T * om;
      const bool contrib = test >= T_EPS;
      const bool live = e.alpha < 0.99f;
      const float xx = -0.5f * (e.dx * e.dx);
      const float yy = -0.5f * (e.dy * e.dy);
      const float xy = e.dx * e.dy;
      const float gx = r[CA] * e.dx + r[CB] * e.dy;
      const float gy = r[CB] * e.dx + r[CC] * e.dy;
      const float inv_om = 1.0f / om;
      const float w = e.alpha * T;
#pragma unroll
      for (int j = 0; j < NTAN; ++j) {
        const float* rt = trows + (i * NTAN + j) * F;
        const float s_t = rt[CA] * xx + rt[CC] * yy - rt[CB] * xy -
                          gx * rt[CU] - gy * rt[CV] + rt[LOGO];
        const float alpha_t = live ? e.alpha * s_t : 0.0f;
        if (contrib) {
          const float w_t = alpha_t * T + e.alpha * (T * pre[j]);
          to[j][0] += w_t * r[R0] + w * rt[R0];
          to[j][1] += w_t * r[G0] + w * rt[G0];
          to[j][2] += w_t * r[B0] + w * rt[B0];
          to[j][3] += w_t * r[CZ] + w * rt[CZ];
          to[j][4] += w_t;
        }
        pre[j] += -alpha_t * inv_om;
      }
      if (!contrib) {
        done = true;
        break;
      }
      o[0] += w * r[R0];
      o[1] += w * r[G0];
      o[2] += w * r[B0];
      o[3] += w * r[CZ];
      o[4] += w;
      T = test;
    }
    if (__syncthreads_and(done)) break;
  }
  store8(outs + ((size_t)t * P + p) * 8, o);
#pragma unroll
  for (int j = 0; j < NTAN; ++j)
    store8(touts + (((size_t)t * NTAN + j) * P + p) * 8, to[j]);
}

template <typename K>
int launch_prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  return 0;
}

}  // namespace

extern "C" int blend_fwd(const float* d, const float* tx0, const float* ty0,
                         const float* pmat, float* outs, float* cnts,
                         int n_tiles, int kf, int p, int width, int height,
                         void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = KC * F * sizeof(float) + KC * (p / 32) * sizeof(int);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cnts) {
    fwd_kernel<true><<<n_tiles, p, smem, s>>>(d, tx0, ty0, pmat, outs, cnts,
                                              kf, width, height);
  } else {
    fwd_kernel<false><<<n_tiles, p, smem, s>>>(d, tx0, ty0, pmat, outs,
                                               nullptr, kf, width, height);
  }
  return (int)cudaGetLastError();
}

extern "C" int blend_fo_grad(const float* d, const float* tx0,
                             const float* ty0, const float* pmat,
                             const float* gt, const float* mask,
                             const float* gtd, const float* sc, float* dd,
                             float* dd_dep, float* sums, int n_tiles, int kf,
                             int p, int width, int height, int use_huber,
                             float delta, float two_delta, float delta_sq,
                             float eps, void* stream) {
  if (n_tiles == 0) return 0;
  const int nw = p / 32;
  const int nch = (kf + KC - 1) / KC;
  const int nv = gtd ? 17 : 10;
  const size_t smem =
      (size_t)(KC * F + nch * p + KC * p + KC * nw * nv + nw * 5) *
      sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gtd) {
    launch_prepare(fo_grad_kernel<true>, smem);
    fo_grad_kernel<true><<<n_tiles, p, smem, s>>>(
        d, tx0, ty0, pmat, gt, mask, gtd, sc, dd, dd_dep, sums, kf, width,
        height, use_huber, delta, two_delta, delta_sq, eps);
  } else {
    launch_prepare(fo_grad_kernel<false>, smem);
    fo_grad_kernel<false><<<n_tiles, p, smem, s>>>(
        d, tx0, ty0, pmat, gt, mask, nullptr, sc, dd, nullptr, sums, kf,
        width, height, use_huber, delta, two_delta, delta_sq, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" int blend_jvp8(const float* d, const float* d_tan,
                          const float* tx0, const float* ty0,
                          const float* pmat, float* outs, float* touts,
                          int n_tiles, int kf, int p, int width, int height,
                          void* stream) {
  if (n_tiles == 0) return 0;
  const size_t smem = (size_t)KC * F * (1 + NTAN) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  jvp8_kernel<<<n_tiles, p, smem, s>>>(d, d_tan, tx0, ty0, pmat, outs, touts,
                                       kf, width, height);
  return (int)cudaGetLastError();
}
