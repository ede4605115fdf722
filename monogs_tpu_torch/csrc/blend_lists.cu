// Hand-written Hopper (sm_90a) kernels for the per-tile list blend.
//
// Counterparts of the six Pallas TPU kernels of the tracking and mapping
// paths in monogs_tpu/render/pallas_lists.py:
//   blend_fwd (COUNTS=false)  <- _fwd_kernel         (blend_lists_pallas)
//   blend_fwd (COUNTS=true)   <- _fwd_counts_kernel  (blend_lists_pallas_counts)
//   blend_fo_grad             <- _fo_grad_kernel     (fo_grad_lists_pallas)
//   blend_jvp8                <- _jvp8_kernel        (blend_lists_jvp8)
//   blend_bwd                 <- _bwd_kernel         (blend_lists_pallas VJP)
//   blend_map_grad            <- _map_grad_kernel    (map_grad_lists_pallas;
//                                with madd, its with_madd variant)
//
// Input contract (unchanged from the TPU kernels): d [T, K, 16] packed
// depth-ordered rows per tile with the column layout of renderer._F (u, v,
// conic a/b/c, opacity, rgb, z, radius, log-opacity, pad); invalid rows carry
// LOGO = -1e30 so they never pass the alpha test. Outputs [T, P, 8] hold
// (r, g, b, depth, acc, 0, 0, 0) per pixel.
//
// Design: one CTA per tile, one thread per pixel (P = tile*tile = 256 at the
// shipped config), the shape of the CUDA 3DGS rasterizer; the fused
// first-order and mapping steps reverse only the chunks that some pixel
// walks into and sum each row's moments and features on the tensor cores
// (blend_common.cuh, "tensor-core reverse"). Rows are staged in
// shared memory KC at a time; each thread walks them front to back with its
// own transmittance in a register. What the TPU kernel needed for Mosaic
// (tile batching, bf16x3 matmuls, block-diagonal feature matrices, K-chunk
// VMEM budgets) is gone: the feature reduction is an f32 multiply-add per
// thread. The device machinery (row evaluation and staging, the forward
// walk, the checkpointed forward and the reverse blend) lives in
// blend_common.cuh, shared with the macro-list kernels of blend_macros.cu.
//
// Bound on the H100: every (row, pixel) pair a pixel walks costs 26 f32
// operations to evaluate alpha (expf is 10 of them); a contributing pair
// adds 13 for the forward blend, 43 (64 for RGB-D) for the fused
// first-order step, about as much for the fused mapping step and the blend
// VJP, and 229 for the six-tangent pass. At the tracking and mapping
// shapes that is 20-49 operations per byte moved, at or above the card's
// FP32-to-HBM ratio of 20, so the FP32 pipes, not HBM, bound every kernel
// (chip_smoke.py counts the pairs). The per-pixel early exit
// (T * (1 - alpha) < 1e-4) skips the rows behind opaque surfaces, and a CTA
// stops staging rows once every pixel has exited. In the fused steps row
// sums by warp shuffles would serialise each CTA on its reverse.
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

#include "blend_common.cuh"

namespace {

constexpr int NTAN = 6;      // pose tangents of the jvp8 kernel

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
  const auto c = load_tile(d, tx0, ty0, pmat, kf, width, height);
  float o[5];
  forward_walk<COUNTS>(c, smem, reinterpret_cast<int*>(smem + KC * F), kf, o,
                       COUNTS ? cnts + (size_t)c.t * kf : nullptr);
  store8(outs + ((size_t)c.t * c.P + c.p) * 8, o);
}

// ------------------------------------------------- fused first-order step --
// Forward blend, exposure + masked signed-sqrt Huber residual, analytic
// output cotangents, reverse blend. RGBD adds the second reverse chain of
// the (globally normalized) depth term.
template <bool RGBD>
__global__ void fo_grad_kernel(
    const float* __restrict__ d, const float* __restrict__ tx0,
    const float* __restrict__ ty0, const float* __restrict__ pmat,
    const float* __restrict__ gt, const float* __restrict__ mask,
    const float* __restrict__ gtd, const float* __restrict__ sc,
    float* __restrict__ dd, float* __restrict__ dd_dep,
    float* __restrict__ sums, int kf, int width, int height, int use_huber,
    float delta, float two_delta, float delta_sq, float eps) {
  extern __shared__ float smem[];
  const auto c = load_tile(d, tx0, ty0, pmat, kf, width, height);
  const int lda = c.P + 4;
  float* rows = smem;
  float* ck = rows + KC * F;
  float* A = ck + n_chunks(kf) * c.P;
  float* gsh = A + TcSpec<RGBD>::NA * KC * lda;
  float* bsum = gsh + c.P * GCOL;

  float o[5];
  int n_live;
  const int kend = forward_live(c, rows, ck, kf, o, n_live);

  // ---- residual chain and output cotangents (ops/losses semantics)
  const size_t px = (size_t)c.t * c.P + c.p;
  const float e_a = fabsf(sc[0]) + eps;
  const float e_b = sc[1];
  const float acc = o[4];
  const float mk = mask[px];
  const float am = acc * mk;
  float g[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // d(sum hub^2)/d(r, g, b, -, acc)
  float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sumsq, l1, gea, geb, sd
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float col = o[ch];
    const float diff = (e_a * col + e_b) - gt[px * 3 + ch];
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
    const float gz = gtd[px];
    const bool dm = (gz > 0.01f) && (acc > 0.95f);
    const float r_d = dm ? o[3] - gz : 0.0f;
    gd3 = 2.0f * r_d;
    part[4] = r_d * r_d;
  }
  tile_sums<5>(c, part, bsum, sums);
  const size_t base = (size_t)c.t * kf * F;
  reverse_tile_tc<false, RGBD>(c, rows, ck, A, gsh, lda, kf, kend, n_live,
                               pmat, g, gd3, dd + base,
                               RGBD ? dd_dep + base : nullptr);
}

// --------------------------------------------------- fused mapping step --
// Forward blend, masked L1 residual (exposure unless initialising), its
// sign as the output cotangent with the mean normalisers and the RGB-D mix
// applied, reverse blend. Mapping's normalisers are constants, so even
// RGB-D needs one reverse chain: the depth term is the output cotangent's
// depth column. sums: (sum |r_rgb|, sum |r_d|, sum sgn mask col,
// sum sgn mask, 0, 0, 0, 0); the caller applies the weight and sign(ea) to
// the exposure sums. One body for both row sources: the tile's own rows
// (map_grad_kernel) and raw rows with an additive log-opacity column
// (map_grad_madd_kernel, the TPU kernel's with_madd variant).
template <bool RGBD, class Rows>
__device__ __forceinline__ void map_grad_tile(
    const Tile<Rows>& c, float* smem, const float* __restrict__ pmat,
    const float* __restrict__ gt, const float* __restrict__ mask,
    const float* __restrict__ gtd, const float* __restrict__ sc,
    float* __restrict__ dd, float* __restrict__ sums, int kf,
    int use_exposure, float w_rgb, float w_dep, float eps) {
  const int lda = c.P + 4;
  float* rows = smem;
  float* ck = rows + KC * F;
  float* A = ck + n_chunks(kf) * c.P;
  float* gsh = A + TcSpec<false>::NA * KC * lda;
  float* bsum = gsh + c.P * GCOL;

  float o[5];
  int n_live;
  const int kend = forward_live(c, rows, ck, kf, o, n_live);

  const size_t px = (size_t)c.t * c.P + c.p;
  const float e = use_exposure ? fabsf(sc[0]) + eps : 1.0f;
  const float mk = mask[px];
  const float ge = w_rgb * e;
  float g[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float part[4] = {0.f, 0.f, 0.f, 0.f};  // l_rgb, l_dep, gea, geb
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float col = o[ch];
    const float img = use_exposure ? e * col + sc[1] : col;
    const float r = (img - gt[px * 3 + ch]) * mk;
    const float sgn = r > 0.f ? 1.f : (r < 0.f ? -1.f : 0.f);
    g[ch] = ge * sgn * mk;
    part[0] += fabsf(r);
    part[2] += sgn * mk * col;
    part[3] += sgn * mk;
  }
  if constexpr (RGBD) {
    const float gz = gtd[px];
    const float dm = gz > 0.01f ? 1.0f : 0.0f;
    const float r_d = (o[3] - gz) * dm;
    const float sgn = r_d > 0.f ? 1.f : (r_d < 0.f ? -1.f : 0.f);
    g[3] = w_dep * sgn * dm;
    part[1] = fabsf(r_d);
  }
  tile_sums<4>(c, part, bsum, sums);
  reverse_tile_tc<RGBD, false>(c, rows, ck, A, gsh, lda, kf, kend, n_live,
                               pmat, g, 0.f, dd + (size_t)c.t * kf * F,
                               nullptr);
}

template <bool RGBD>
__global__ void map_grad_kernel(
    const float* __restrict__ d, const float* __restrict__ tx0,
    const float* __restrict__ ty0, const float* __restrict__ pmat,
    const float* __restrict__ gt, const float* __restrict__ mask,
    const float* __restrict__ gtd, const float* __restrict__ sc,
    float* __restrict__ dd, float* __restrict__ sums, int kf, int width,
    int height, int use_exposure, float w_rgb, float w_dep, float eps) {
  extern __shared__ float smem[];
  map_grad_tile<RGBD>(load_tile(d, tx0, ty0, pmat, kf, width, height), smem,
                      pmat, gt, mask, gtd, sc, dd, sums, kf, use_exposure,
                      w_rgb, w_dep, eps);
}

// madd [T, kf]: 0 for a valid row, -1e30 for an invalid one, added to the
// raw row's log-opacity as it is staged (forward and reverse alike), so the
// caller needs no masked copy of the rows. d(LOGO + madd)/d(LOGO) = 1 and an
// invalid row blends with w = 0, so dd is the masked rows' cotangent.
template <bool RGBD>
__global__ void map_grad_madd_kernel(
    const float* __restrict__ d, const float* __restrict__ madd,
    const float* __restrict__ tx0, const float* __restrict__ ty0,
    const float* __restrict__ pmat, const float* __restrict__ gt,
    const float* __restrict__ mask, const float* __restrict__ gtd,
    const float* __restrict__ sc, float* __restrict__ dd,
    float* __restrict__ sums, int kf, int width, int height,
    int use_exposure, float w_rgb, float w_dep, float eps) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const MaddRows src{d + (size_t)t * kf * F, madd + (size_t)t * kf};
  map_grad_tile<RGBD>(make_tile(t, tx0[t], ty0[t], pmat, src, width, height),
                      smem, pmat, gt, mask, gtd, sc, dd, sums, kf,
                      use_exposure, w_rgb, w_dep, eps);
}

// ------------------------------------------------------------- blend VJP --
// Row cotangents of the list blend from output cotangents g_outs [T, P, 8]:
// the forward recomputed from chunk checkpoints, then the reverse blend.
// Columns 5-7 of g_outs pair with constant-zero features and are not read.
__global__ void bwd_kernel(const float* __restrict__ d,
                           const float* __restrict__ tx0,
                           const float* __restrict__ ty0,
                           const float* __restrict__ pmat,
                           const float* __restrict__ g_outs,
                           float* __restrict__ dd, int kf, int width,
                           int height) {
  extern __shared__ float smem[];
  const auto c = load_tile(d, tx0, ty0, pmat, kf, width, height);
  float* rows = smem;
  float* ck = rows + KC * F;
  float* tex = ck + n_chunks(kf) * c.P;
  float* red = tex + KC * c.P;

  float o[5];
  int n_live;
  const int kend = forward_checkpointed(c, rows, ck, kf, o, n_live);
  const float* go = g_outs + ((size_t)c.t * c.P + c.p) * 8;
  const float g[5] = {go[0], go[1], go[2], go[3], go[4]};
  reverse_blend<true, false>(c, rows, ck, tex, red, kf, kend, n_live, g, 0.f,
                             dd + (size_t)c.t * kf * F, nullptr);
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
    stage_span(rows, dt + (size_t)k0 * F, n * F);
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

// A fused step's launch, one CTA per tile; returns its error.
template <typename K, typename... Args>
cudaError_t launch_fused(K kernel, int n_tiles, int p, size_t smem,
                         cudaStream_t s, Args... args) {
  const cudaError_t rc = launch_prepare(kernel, smem);
  if (rc != cudaSuccess) return rc;
  kernel<<<n_tiles, p, smem, s>>>(args...);
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = reverse_tc_smem(kf, p, gtd != nullptr);
  return (int)(gtd ? launch_fused(fo_grad_kernel<true>, n_tiles, p, smem, s,
                                  d, tx0, ty0, pmat, gt, mask, gtd, sc, dd,
                                  dd_dep, sums, kf, width, height, use_huber,
                                  delta, two_delta, delta_sq, eps)
                   : launch_fused(fo_grad_kernel<false>, n_tiles, p, smem, s,
                                  d, tx0, ty0, pmat, gt, mask, gtd, sc, dd,
                                  dd_dep, sums, kf, width, height, use_huber,
                                  delta, two_delta, delta_sq, eps));
}

// madd: nullable [T, kf]; with it the raw rows d blend through
// map_grad_madd_kernel.
extern "C" int blend_map_grad(const float* d, const float* tx0,
                              const float* ty0, const float* pmat,
                              const float* gt, const float* mask,
                              const float* gtd, const float* madd,
                              const float* sc, float* dd, float* sums,
                              int n_tiles, int kf, int p, int width,
                              int height, int use_exposure, float w_rgb,
                              float w_dep, float eps, void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = reverse_tc_smem(kf, p, false);
  cudaError_t rc;
  if (madd && gtd)
    rc = launch_fused(map_grad_madd_kernel<true>, n_tiles, p, smem, s, d,
                      madd, tx0, ty0, pmat, gt, mask, gtd, sc, dd, sums, kf,
                      width, height, use_exposure, w_rgb, w_dep, eps);
  else if (madd)
    rc = launch_fused(map_grad_madd_kernel<false>, n_tiles, p, smem, s,
                      d, madd, tx0, ty0, pmat, gt, mask, gtd, sc, dd, sums,
                      kf, width, height, use_exposure, w_rgb, w_dep, eps);
  else if (gtd)
    rc = launch_fused(map_grad_kernel<true>, n_tiles, p, smem, s, d, tx0,
                      ty0, pmat, gt, mask, gtd, sc, dd, sums, kf, width,
                      height, use_exposure, w_rgb, w_dep, eps);
  else
    rc = launch_fused(map_grad_kernel<false>, n_tiles, p, smem, s, d,
                      tx0, ty0, pmat, gt, mask, gtd, sc, dd, sums, kf, width,
                      height, use_exposure, w_rgb, w_dep, eps);
  return (int)rc;
}

template <typename K>
cudaError_t fused_attrs(K kernel, int p, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  if (rc == cudaSuccess) rc = launch_prepare(kernel, smem);
  int n = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, p, smem);
  out[0] = a.numRegs;
  out[1] = (int)(smem + a.sharedSizeBytes);
  out[2] = n;
  return rc;
}

// Registers per thread, shared memory per CTA (bytes) and resident CTAs
// per SM of the fused steps at list length kf and P = p, into out [6][3]:
// fo_grad_kernel mono and RGB-D, map_grad_kernel mono and RGB-D,
// map_grad_madd_kernel mono and RGB-D.
extern "C" int blend_fused_attrs(int kf, int p, int* out) {
  const size_t mono = reverse_tc_smem(kf, p, false);
  cudaError_t rc[6] = {
      fused_attrs(fo_grad_kernel<false>, p, mono, out),
      fused_attrs(fo_grad_kernel<true>, p, reverse_tc_smem(kf, p, true),
                  out + 3),
      fused_attrs(map_grad_kernel<false>, p, mono, out + 6),
      fused_attrs(map_grad_kernel<true>, p, mono, out + 9),
      fused_attrs(map_grad_madd_kernel<false>, p, mono, out + 12),
      fused_attrs(map_grad_madd_kernel<true>, p, mono, out + 15)};
  for (cudaError_t r : rc)
    if (r != cudaSuccess) return (int)r;
  return 0;
}

extern "C" int blend_bwd(const float* d, const float* tx0, const float* ty0,
                         const float* pmat, const float* g_outs, float* dd,
                         int n_tiles, int kf, int p, int width, int height,
                         void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = reverse_smem(kf, p, RevSpec<true, false>::NV);
  const cudaError_t rc = launch_prepare(bwd_kernel, smem);
  if (rc != cudaSuccess) return (int)rc;
  bwd_kernel<<<n_tiles, p, smem, s>>>(d, tx0, ty0, pmat, g_outs, dd, kf,
                                      width, height);
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
