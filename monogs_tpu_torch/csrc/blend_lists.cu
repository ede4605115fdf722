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
// shipped config), the shape of the CUDA 3DGS rasterizer. The fused
// first-order and mapping steps and the blend VJP reverse only the chunks
// that some pixel walks into and sum each row's moments and features on
// the tensor cores (blend_common.cuh, "tensor-core reverse"); a tile of
// more than 256 pixels is walked by 256 threads in pixel slices. The
// six-tangent pass runs one CTA per (half tile, three tangents), so that
// every SM holds enough warps. Rows are staged in shared memory KC at a
// time; each thread walks them front to back with its own transmittance
// in a register. What the TPU kernel needed for Mosaic (tile batching,
// bf16x3 matmuls, block-diagonal feature matrices, K-chunk VMEM budgets)
// is gone. The device machinery (row evaluation and staging, the forward
// walk, the tensor-core reverse, and the checkpointed forward and reverse
// blend of the macro-list VJP) lives in blend_common.cuh, shared with the
// macro-list kernels of blend_macros.cu.
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
// stops staging rows once every pixel has exited. In the reverse kernels
// row sums by warp shuffles would serialise each CTA on its reverse.
//
// Numerics: the per-pixel early exit is exact, because T is non-increasing:
// once T * (1 - a) < 1e-4 no later row can contribute (renderer.py:151-155).
// `ok` (the alpha test) and `contrib` (ok and not terminated) stay separate,
// as in the TPU kernel. The library is built with -fmad=false and without
// fast math, so that s, alpha and T round exactly as the plain PyTorch
// version's elementwise ops do and the 1/255 and 1e-4 threshold decisions
// agree with it; the six-tangent pass's tangent sums, which decide no
// threshold, are explicit fused multiply-adds.
//
// Each C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <type_traits>

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
// the (globally normalized) depth term. np: the tile's pixels, walked in
// NSL slices (blend_common.cuh, "tensor-core reverse").
template <bool RGBD, int NSL>
__global__ void fo_grad_kernel(
    const float* __restrict__ d, const float* __restrict__ tx0,
    const float* __restrict__ ty0, const float* __restrict__ pmat,
    const float* __restrict__ gt, const float* __restrict__ mask,
    const float* __restrict__ gtd, const float* __restrict__ sc,
    float* __restrict__ dd, float* __restrict__ dd_dep,
    float* __restrict__ sums, int kf, int np, int width, int height,
    int use_huber, float delta, float two_delta, float delta_sq,
    float eps) {
  extern __shared__ float smem[];
  if constexpr (NSL == 1) np = blockDim.x;
  const auto c = load_tile(d, tx0, ty0, pmat, kf, width, height, np);
  const auto q = make_slices<NSL>(c, pmat, np, width, height);
  const int lda = c.P + 4;
  float* rows = smem;
  float* ck = rows + KC * F;
  float* A = ck + n_chunks(kf) * NSL * c.P;
  float* gsh = A + TcSpec<RGBD>::NA * KC * lda;
  float* bsum = gsh + c.P * GCOL;

  float o[NSL][5];
  int kend[NSL], n_live;
  forward_live(c, q, rows, ck, kf, o, kend, n_live);

  // ---- residual chain and output cotangents (ops/losses semantics)
  const float e_a = fabsf(sc[0]) + eps;
  const float e_b = sc[1];
  float g[NSL][5];  // d(sum hub^2)/d(r, g, b, -, acc)
  float gd3[NSL];
  float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sumsq, l1, gea, geb, sd
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
#pragma unroll
    for (int j = 0; j < 5; ++j) g[s][j] = 0.f;
    gd3[s] = 0.f;
    if (!in_tile<NSL>(c, s, np)) continue;
    const size_t px = (size_t)c.t * np + s * c.P + c.p;
    const float acc = o[s][4];
    const float mk = mask[px];
    const float am = acc * mk;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float col = o[s][ch];
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
      g[s][ch] = rbar * am * e_a;
      g[s][4] += rbar * mk * diff;
      part[0] += hub * hub;
      part[1] += ax;
      part[2] += rbar * am * col;
      part[3] += rbar * am;
    }
    if constexpr (RGBD) {
      const float gz = gtd[px];
      const bool dm = (gz > 0.01f) && (acc > 0.95f);
      const float r_d = dm ? o[s][3] - gz : 0.0f;
      gd3[s] = 2.0f * r_d;
      if constexpr (NSL == 1)
        part[4] = r_d * r_d;
      else
        part[4] += r_d * r_d;
    }
  }
  tile_sums<5>(c, part, bsum, sums);
  const size_t base = (size_t)c.t * kf * F;
  reverse_tile_tc<false, RGBD>(c, q, rows, ck, A, gsh, lda, kf, kend, n_live,
                               pmat, np, g, gd3, dd + base,
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
template <bool RGBD, int NSL, class Rows>
__device__ __forceinline__ void map_grad_tile(
    const Tile<Rows>& c, float* smem, const float* __restrict__ pmat,
    const float* __restrict__ gt, const float* __restrict__ mask,
    const float* __restrict__ gtd, const float* __restrict__ sc,
    float* __restrict__ dd, float* __restrict__ sums, int kf, int np,
    int width, int height, int use_exposure, float w_rgb, float w_dep,
    float eps) {
  const auto q = make_slices<NSL>(c, pmat, np, width, height);
  const int lda = c.P + 4;
  float* rows = smem;
  float* ck = rows + KC * F;
  float* A = ck + n_chunks(kf) * NSL * c.P;
  float* gsh = A + TcSpec<false>::NA * KC * lda;
  float* bsum = gsh + c.P * GCOL;

  float o[NSL][5];
  int kend[NSL], n_live;
  forward_live(c, q, rows, ck, kf, o, kend, n_live);

  const float e = use_exposure ? fabsf(sc[0]) + eps : 1.0f;
  const float ge = w_rgb * e;
  float g[NSL][5];
  float part[4] = {0.f, 0.f, 0.f, 0.f};  // l_rgb, l_dep, gea, geb
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
#pragma unroll
    for (int j = 0; j < 5; ++j) g[s][j] = 0.f;
    if (!in_tile<NSL>(c, s, np)) continue;
    const size_t px = (size_t)c.t * np + s * c.P + c.p;
    const float mk = mask[px];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float col = o[s][ch];
      const float img = use_exposure ? e * col + sc[1] : col;
      const float r = (img - gt[px * 3 + ch]) * mk;
      const float sgn = r > 0.f ? 1.f : (r < 0.f ? -1.f : 0.f);
      g[s][ch] = ge * sgn * mk;
      part[0] += fabsf(r);
      part[2] += sgn * mk * col;
      part[3] += sgn * mk;
    }
    if constexpr (RGBD) {
      const float gz = gtd[px];
      const float dm = gz > 0.01f ? 1.0f : 0.0f;
      const float r_d = (o[s][3] - gz) * dm;
      const float sgn = r_d > 0.f ? 1.f : (r_d < 0.f ? -1.f : 0.f);
      g[s][3] = w_dep * sgn * dm;
      if constexpr (NSL == 1)
        part[1] = fabsf(r_d);
      else
        part[1] += fabsf(r_d);
    }
  }
  tile_sums<4>(c, part, bsum, sums);
  const float gd[NSL] = {};
  reverse_tile_tc<RGBD, false>(c, q, rows, ck, A, gsh, lda, kf, kend,
                               n_live, pmat, np, g, gd,
                               dd + (size_t)c.t * kf * F, nullptr);
}

template <bool RGBD, int NSL>
__global__ void map_grad_kernel(
    const float* __restrict__ d, const float* __restrict__ tx0,
    const float* __restrict__ ty0, const float* __restrict__ pmat,
    const float* __restrict__ gt, const float* __restrict__ mask,
    const float* __restrict__ gtd, const float* __restrict__ sc,
    float* __restrict__ dd, float* __restrict__ sums, int kf, int np,
    int width, int height, int use_exposure, float w_rgb, float w_dep,
    float eps) {
  extern __shared__ float smem[];
  if constexpr (NSL == 1) np = blockDim.x;
  map_grad_tile<RGBD, NSL>(
      load_tile(d, tx0, ty0, pmat, kf, width, height, np), smem, pmat, gt,
      mask, gtd, sc, dd, sums, kf, np, width, height, use_exposure, w_rgb,
      w_dep, eps);
}

// madd [T, kf]: 0 for a valid row, -1e30 for an invalid one, added to the
// raw row's log-opacity as it is staged (forward and reverse alike), so the
// caller needs no masked copy of the rows. d(LOGO + madd)/d(LOGO) = 1 and an
// invalid row blends with w = 0, so dd is the masked rows' cotangent.
template <bool RGBD, int NSL>
__global__ void map_grad_madd_kernel(
    const float* __restrict__ d, const float* __restrict__ madd,
    const float* __restrict__ tx0, const float* __restrict__ ty0,
    const float* __restrict__ pmat, const float* __restrict__ gt,
    const float* __restrict__ mask, const float* __restrict__ gtd,
    const float* __restrict__ sc, float* __restrict__ dd,
    float* __restrict__ sums, int kf, int np, int width, int height,
    int use_exposure, float w_rgb, float w_dep, float eps) {
  extern __shared__ float smem[];
  if constexpr (NSL == 1) np = blockDim.x;
  const int t = blockIdx.x;
  const MaddRows src{d + (size_t)t * kf * F, madd + (size_t)t * kf};
  map_grad_tile<RGBD, NSL>(
      make_tile(t, tx0[t], ty0[t], pmat, src, width, height, np), smem,
      pmat, gt, mask, gtd, sc, dd, sums, kf, np, width, height,
      use_exposure, w_rgb, w_dep, eps);
}

// ------------------------------------------------------------- blend VJP --
// Row cotangents of the list blend from output cotangents g_outs [T, P, 8],
// on the tensor-core reverse of the fused steps with the per-pixel
// cotangent read from g_outs: the forward recomputed with its chunk
// checkpoints, then the live chunks reversed back to front. Columns 5-7 of
// g_outs pair with constant-zero features and are not read.
template <int NSL>
__global__ void bwd_kernel(const float* __restrict__ d,
                           const float* __restrict__ tx0,
                           const float* __restrict__ ty0,
                           const float* __restrict__ pmat,
                           const float* __restrict__ g_outs,
                           float* __restrict__ dd, int kf, int np, int width,
                           int height) {
  extern __shared__ float smem[];
  if constexpr (NSL == 1) np = blockDim.x;
  const auto c = load_tile(d, tx0, ty0, pmat, kf, width, height, np);
  const auto q = make_slices<NSL>(c, pmat, np, width, height);
  const int lda = c.P + 4;
  float* rows = smem;
  float* ck = rows + KC * F;
  float* A = ck + n_chunks(kf) * NSL * c.P;
  float* gsh = A + TcSpec<false>::NA * KC * lda;

  float o[NSL][5];
  int kend[NSL], n_live;
  forward_live(c, q, rows, ck, kf, o, kend, n_live);
  float g[NSL][5];
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
    const bool in = in_tile<NSL>(c, s, np);
    const float* go =
        g_outs + ((size_t)c.t * np + (in ? s * c.P + c.p : 0)) * 8;
#pragma unroll
    for (int j = 0; j < 5; ++j) g[s][j] = in ? go[j] : 0.f;
  }
  const float gd[NSL] = {};
  reverse_tile_tc<true, false>(c, q, rows, ck, A, gsh, lda, kf, kend, n_live,
                               pmat, np, g, gd, dd + (size_t)c.t * kf * F,
                               nullptr);
}

// ------------------------------------------------ primal + 6 pose tangents --
// One CTA per (tile part, tangent group): a part is PARTS-th of the tile's
// pixels, one thread per pixel, and a group NTG of the six tangents. Each
// CTA walks the primal blend of its pixels itself and carries its NTG
// tangents; group 0 writes the primal outputs. A pixel's arithmetic per
// tangent is that of one CTA carrying all six over the whole tile, so the
// outputs do not depend on the split. Shared memory, two buffers: rows
// [KC][F] | the group's tangent rows [NTG][KC][F], each tangent's chunk
// copied as one contiguous span with cp.async while the CTA walks the
// chunk before it.
template <int NTG, int PARTS>
__global__ void jvp8_kernel(const float* __restrict__ d,
                            const float* __restrict__ d_tan,
                            const float* __restrict__ tx0,
                            const float* __restrict__ ty0,
                            const float* __restrict__ pmat,
                            float* __restrict__ outs,
                            float* __restrict__ touts, int kf, int width,
                            int height) {
  extern __shared__ float smem[];
  constexpr int BUF = (1 + NTG) * KC * F;  // floats of one buffer
  const int P = blockDim.x * PARTS;
  const int t = blockIdx.x / PARTS;
  const int j0 = blockIdx.y * NTG;
  const int p = blockIdx.x % PARTS * blockDim.x + threadIdx.x;
  const float x0 = tx0[t], y0 = ty0[t];
  const float pxl = pmat[3 * P + p], pyl = pmat[4 * P + p];
  const bool pix_ok = (x0 + pxl <= (float)(width - 1)) &&
                      (y0 + pyl <= (float)(height - 1));
  const float* dt = d + (size_t)t * kf * F;
  const float* dtt = d_tan + ((size_t)t * NTAN + j0) * kf * F;

  float T = 1.0f;
  float o[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float pre[NTG];      // tangent of log T: sum of -alpha_t / (1 - alpha)
  float to[NTG][5];
#pragma unroll
  for (int j = 0; j < NTG; ++j) {
    pre[j] = 0.f;
#pragma unroll
    for (int c = 0; c < 5; ++c) to[j][c] = 0.f;
  }
  // chunk ch's rows and tangent rows into buffer ch & 1
  auto stage = [&](int ch) {
    const int k0 = ch * KC, n = min(KC, kf - k0);
    float* buf = smem + (ch & 1) * BUF;
    stage_span_async(buf, dt + (size_t)k0 * F, n * F);
#pragma unroll
    for (int j = 0; j < NTG; ++j)
      stage_span_async(buf + (1 + j) * KC * F,
                       dtt + ((size_t)j * kf + k0) * F, n * F);
    cp_async_commit();
  };
  const int nch = n_chunks(kf);
  bool done = false;
  stage(0);
  for (int ch = 0; ch < nch; ++ch) {
    const int k0 = ch * KC;
    const int n = min(KC, kf - k0);
    // the other buffer was last read before the previous chunk's barrier
    if (ch + 1 < nch) {
      stage(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* rows = smem + (ch & 1) * BUF;
    const float* trows = rows + KC * F;
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
      // the tangent sums in fused multiply-adds (the library is built
      // without contraction, for the primal's thresholds; these decide
      // none), innermost term first
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        const float* rt = trows + (j * KC + i) * F;
        const float s_t = fmaf(
            rt[CA], xx,
            fmaf(rt[CC], yy,
                 fmaf(-rt[CB], xy,
                      fmaf(-gx, rt[CU], fmaf(-gy, rt[CV], rt[LOGO])))));
        const float alpha_t = live ? e.alpha * s_t : 0.0f;
        if (contrib) {
          const float w_t = fmaf(alpha_t, T, e.alpha * (T * pre[j]));
          to[j][0] = fmaf(w_t, r[R0], fmaf(w, rt[R0], to[j][0]));
          to[j][1] = fmaf(w_t, r[G0], fmaf(w, rt[G0], to[j][1]));
          to[j][2] = fmaf(w_t, r[B0], fmaf(w, rt[B0], to[j][2]));
          to[j][3] = fmaf(w_t, r[CZ], fmaf(w, rt[CZ], to[j][3]));
          to[j][4] += w_t;
        }
        pre[j] = fmaf(-alpha_t, inv_om, pre[j]);
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
  cp_async_wait<0>();  // a chunk staged past the exit
  if (blockIdx.y == 0) store8(outs + ((size_t)t * P + p) * 8, o);
#pragma unroll
  for (int j = 0; j < NTG; ++j)
    store8(touts + (((size_t)t * NTAN + j0 + j) * P + p) * 8, to[j]);
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

// A fused step's launch, one CTA of nt threads per tile; returns its error.
template <typename K, typename... Args>
cudaError_t launch_fused(K kernel, int n_tiles, int nt, size_t smem,
                         cudaStream_t s, Args... args) {
  const cudaError_t rc = launch_prepare(kernel, smem);
  if (rc != cudaSuccess) return rc;
  kernel<<<n_tiles, nt, smem, s>>>(args...);
  return cudaGetLastError();
}

// f(std::integral_constant<int, NSL>) with the pixel slices of a tile of
// p pixels: one for tiles up to 16 px, MAX_SLICES (the last ones partly or
// wholly beyond P) above.
template <typename Fn>
cudaError_t by_slices(int p, Fn f) {
  return p > SLICE ? f(std::integral_constant<int, MAX_SLICES>{})
                   : f(std::integral_constant<int, 1>{});
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
  const int nt = slice_threads(p);
  return (int)by_slices(p, [&](auto ns) {
    constexpr int NSL = decltype(ns)::value;
    const size_t smem = reverse_tc_smem(kf, nt, NSL, gtd != nullptr);
    return gtd ? launch_fused(fo_grad_kernel<true, NSL>, n_tiles, nt, smem,
                              s, d, tx0, ty0, pmat, gt, mask, gtd, sc, dd,
                              dd_dep, sums, kf, p, width, height, use_huber,
                              delta, two_delta, delta_sq, eps)
               : launch_fused(fo_grad_kernel<false, NSL>, n_tiles, nt, smem,
                              s, d, tx0, ty0, pmat, gt, mask, gtd, sc, dd,
                              dd_dep, sums, kf, p, width, height, use_huber,
                              delta, two_delta, delta_sq, eps);
  });
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
  const int nt = slice_threads(p);
  return (int)by_slices(p, [&](auto ns) {
    constexpr int NSL = decltype(ns)::value;
    const size_t smem = reverse_tc_smem(kf, nt, NSL, false);
    if (madd && gtd)
      return launch_fused(map_grad_madd_kernel<true, NSL>, n_tiles, nt, smem,
                          s, d, madd, tx0, ty0, pmat, gt, mask, gtd, sc, dd,
                          sums, kf, p, width, height, use_exposure, w_rgb,
                          w_dep, eps);
    if (madd)
      return launch_fused(map_grad_madd_kernel<false, NSL>, n_tiles, nt,
                          smem, s, d, madd, tx0, ty0, pmat, gt, mask, gtd,
                          sc, dd, sums, kf, p, width, height, use_exposure,
                          w_rgb, w_dep, eps);
    if (gtd)
      return launch_fused(map_grad_kernel<true, NSL>, n_tiles, nt, smem, s,
                          d, tx0, ty0, pmat, gt, mask, gtd, sc, dd, sums, kf,
                          p, width, height, use_exposure, w_rgb, w_dep, eps);
    return launch_fused(map_grad_kernel<false, NSL>, n_tiles, nt, smem, s, d,
                        tx0, ty0, pmat, gt, mask, gtd, sc, dd, sums, kf, p,
                        width, height, use_exposure, w_rgb, w_dep, eps);
  });
}

template <typename K>
cudaError_t fused_attrs(K kernel, int nt, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, kernel);
  if (rc == cudaSuccess) rc = launch_prepare(kernel, smem);
  int n = 0;
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, nt, smem);
  out[0] = a.numRegs;
  out[1] = (int)(smem + a.sharedSizeBytes);
  out[2] = n;
  return rc;
}

// Registers per thread, shared memory per CTA (bytes) and resident CTAs
// per SM of the tensor-core reverse kernels at list length kf and P = p,
// into out [7][3]: fo_grad_kernel mono and RGB-D, map_grad_kernel mono and
// RGB-D, map_grad_madd_kernel mono and RGB-D, bwd_kernel.
extern "C" int blend_fused_attrs(int kf, int p, int* out) {
  const int nt = slice_threads(p);
  return (int)by_slices(p, [&](auto ns) {
    constexpr int NSL = decltype(ns)::value;
    const size_t mono = reverse_tc_smem(kf, nt, NSL, false);
    const cudaError_t rc[7] = {
        fused_attrs(fo_grad_kernel<false, NSL>, nt, mono, out),
        fused_attrs(fo_grad_kernel<true, NSL>, nt,
                    reverse_tc_smem(kf, nt, NSL, true), out + 3),
        fused_attrs(map_grad_kernel<false, NSL>, nt, mono, out + 6),
        fused_attrs(map_grad_kernel<true, NSL>, nt, mono, out + 9),
        fused_attrs(map_grad_madd_kernel<false, NSL>, nt, mono, out + 12),
        fused_attrs(map_grad_madd_kernel<true, NSL>, nt, mono, out + 15),
        fused_attrs(bwd_kernel<NSL>, nt, mono, out + 18)};
    for (cudaError_t r : rc)
      if (r != cudaSuccess) return r;
    return cudaSuccess;
  });
}

extern "C" int blend_bwd(const float* d, const float* tx0, const float* ty0,
                         const float* pmat, const float* g_outs, float* dd,
                         int n_tiles, int kf, int p, int width, int height,
                         void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = slice_threads(p);
  return (int)by_slices(p, [&](auto ns) {
    constexpr int NSL = decltype(ns)::value;
    return launch_fused(bwd_kernel<NSL>, n_tiles, nt,
                        reverse_tc_smem(kf, nt, NSL, false), s, d, tx0, ty0,
                        pmat, g_outs, dd, kf, p, width, height);
  });
}

// The jvp8 kernel's CTAs: NTAN / JVP_NTG tangent groups times JVP_PARTS
// pixel parts per tile.
constexpr int JVP_NTG = 3;
constexpr int JVP_PARTS = 2;

extern "C" int blend_jvp8(const float* d, const float* d_tan,
                          const float* tx0, const float* ty0,
                          const float* pmat, float* outs, float* touts,
                          int n_tiles, int kf, int p, int width, int height,
                          void* stream) {
  if (n_tiles == 0) return 0;
  static_assert(NTAN % JVP_NTG == 0, "whole tangent groups");
  const size_t smem = 2 * (size_t)KC * F * (1 + JVP_NTG) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_tiles * JVP_PARTS, NTAN / JVP_NTG);
  jvp8_kernel<JVP_NTG, JVP_PARTS><<<grid, p / JVP_PARTS, smem, s>>>(
      d, d_tan, tx0, ty0, pmat, outs, touts, kf, width, height);
  return (int)cudaGetLastError();
}
