// Hand-written Hopper (sm_90a) kernels for the per-tile list blend.
//
// Counterparts of the six Pallas TPU kernels of the tracking and mapping
// paths in monogs_tpu/render/pallas_lists.py:
//   blend_fwd (COUNTS=false)  <- _fwd_kernel         (blend_lists_pallas)
//   blend_fwd (COUNTS=true)   <- _fwd_counts_kernel  (blend_lists_pallas_counts)
//   blend_fo_grad             <- _fo_grad_kernel     (fo_grad_lists_pallas)
//   blend_jvp8                <- _jvp8_kernel        (blend_lists_jvp8)
//   blend_bwd                 <- _bwd_kernel         (blend_lists_pallas VJP)
//   blend_map_grad            <- _map_grad_kernel    (map_grad_lists_pallas)
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
// first-order step, about as much for the fused mapping step and the blend
// VJP, and 229 for the six-tangent pass. At the tracking and mapping
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

// ------------------------------------------------------- reverse machinery --
// Shared by the three kernels that pull output cotangents back to the rows
// (fused first-order step, fused mapping step, blend VJP): a forward pass
// that stores the transmittance at each KC-row chunk entry, then a
// back-to-front pass per chunk that recomputes the chunk's per-row T_excl
// from its checkpoint, carries the suffix sum(wbar * w) and reduces each
// row's six conic moments and its feature sums deterministically (warp
// shuffles, then a fixed-order sum over the warps in shared memory). No
// atomics: each CTA owns its tile's rows.
//
// Shared memory (floats): rows [KC][F] | ck [nch][P] | tex [KC][P] |
// red [KC][nw][NV] per-warp row sums | bsum [nw][8] per-warp tile sums.

struct Tile {
  int t, p, lane, warp, nw, P;
  float x0, y0, pxl, pyl;
  float pm[6];
  bool pix_ok;
  const float* dt;  // this tile's rows [kf][F]
};

__device__ __forceinline__ Tile load_tile(const float* d, const float* tx0,
                                          const float* ty0, const float* pmat,
                                          int kf, int width, int height) {
  Tile c;
  c.P = blockDim.x;
  c.nw = c.P >> 5;
  c.t = blockIdx.x;
  c.p = threadIdx.x;
  c.lane = c.p & 31;
  c.warp = c.p >> 5;
  c.x0 = tx0[c.t];
  c.y0 = ty0[c.t];
#pragma unroll
  for (int j = 0; j < 6; ++j) c.pm[j] = pmat[j * c.P + c.p];
  c.pxl = c.pm[3];
  c.pyl = c.pm[4];
  c.pix_ok = (c.x0 + c.pxl <= (float)(width - 1)) &&
             (c.y0 + c.pyl <= (float)(height - 1));
  c.dt = d + (size_t)c.t * kf * F;
  return c;
}

__host__ __device__ constexpr int n_chunks(int kf) {
  return (kf + KC - 1) / KC;
}

// Forward blend of the pixel's rows into o[5] (r, g, b, depth, acc),
// storing the transmittance at each chunk entry in ck; returns the index of
// the row at which the pixel terminates (kf if it never does). Every thread
// of the CTA must call it: it stages rows between barriers.
__device__ __forceinline__ int forward_checkpointed(const Tile& c,
                                                    float* rows, float* ck,
                                                    int kf, float o[5]) {
  float T = 1.0f;
#pragma unroll
  for (int j = 0; j < 5; ++j) o[j] = 0.f;
  int kend = kf;
  for (int ch = 0; ch < n_chunks(kf); ++ch) {
    const int k0 = ch * KC;
    const int n = min(KC, kf - k0);
    ck[ch * c.P + c.p] = T;
    __syncthreads();
    stage_rows(rows, c.dt + (size_t)k0 * F, n * F);
    __syncthreads();
    if (kend < kf) continue;
    for (int i = 0; i < n; ++i) {
      const float* r = rows + i * F;
      const RowEval e = eval_row(r, c.x0, c.y0, c.pxl, c.pyl, c.pix_ok);
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
  return kend;
}

// sums[t][0..7] = the CTA's sums of part[0..NS-1] (zero beyond NS).
template <int NS>
__device__ __forceinline__ void tile_sums(const Tile& c, const float* part,
                                          float* bsum, float* sums) {
  static_assert(NS <= 8, "at most 8 per-tile sums");
  // every lane holds the warp's sum after the butterfly and stores it to
  // the same address: a lane-0 guard here lets the compiler unswitch the
  // surrounding code on the lane, and the shuffles then run diverged
#pragma unroll
  for (int j = 0; j < NS; ++j) bsum[c.warp * 8 + j] = warp_sum(part[j]);
  __syncthreads();
  if (c.p < 8) {
    float v = 0.f;
    if (c.p < NS)
      for (int w = 0; w < c.nw; ++w) v += bsum[w * 8 + c.p];
    sums[(size_t)c.t * 8 + c.p] = v;
  }
}

// Row cotangent of the packed columns from the row's reduced conic moments
// G[0..5] (sums of sbar * (px^2, px py, py^2, px, py, 1)) and its feature
// sums; writes the 16 columns of one row.
__device__ __forceinline__ void write_row(float* dst, const float* r,
                                          float x0, float y0, const float* G,
                                          float gr, float gg, float gb,
                                          float gz) {
  const float a = r[CA], b = r[CB], cc = r[CC];
  const float ul = r[CU] - x0, vl = r[CV] - y0;
  float out[F];
#pragma unroll
  for (int j = 0; j < F; ++j) out[j] = 0.f;
  out[CU] = a * G[3] + b * G[4] - (a * ul + b * vl) * G[5];
  out[CV] = b * G[3] + cc * G[4] - (b * ul + cc * vl) * G[5];
  out[CA] = -0.5f * G[0] + ul * G[3] - 0.5f * ul * ul * G[5];
  out[CB] = -G[1] + vl * G[3] + ul * G[4] - ul * vl * G[5];
  out[CC] = -0.5f * G[2] + vl * G[4] - 0.5f * vl * vl * G[5];
  out[LOGO] = G[5];
  out[R0] = gr;
  out[G0] = gg;
  out[B0] = gb;
  out[CZ] = gz;
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    d4[j] = make_float4(out[4 * j], out[4 * j + 1], out[4 * j + 2],
                        out[4 * j + 3]);
}

// Values each pixel reduces per row: six conic moments and the r, g, b
// feature sums, the depth feature sum when DEP, and for DEPCHAIN a second,
// depth-only chain (six moments and its depth sum).
template <bool DEP, bool DEPCHAIN>
struct RevSpec {
  static constexpr int NV0 = DEP ? 10 : 9;
  static constexpr int NV = NV0 + (DEPCHAIN ? 7 : 0);
};

// Reverse blend, back to front, chunk by chunk from the checkpoints.
// g[5]: this pixel's output cotangent (r, g, b, depth, acc); the depth entry
// is read only when DEP. gd: the depth-only second chain's cotangent when
// DEPCHAIN. Writes dd (and dd_dep) [kf][F] of this tile.
template <bool DEP, bool DEPCHAIN>
__device__ __forceinline__ void reverse_blend(const Tile& c, float* rows,
                                              const float* ck, float* tex,
                                              float* red, int kf, int kend,
                                              const float g[5], float gd,
                                              float* dd, float* dd_dep) {
  using S_ = RevSpec<DEP, DEPCHAIN>;
  constexpr int NV0 = S_::NV0, NV = S_::NV;
  float S = 0.f, Sd = 0.f;  // suffix sums of wbar * w (each chain)
  for (int ch = n_chunks(kf) - 1; ch >= 0; --ch) {
    const int k0 = ch * KC;
    const int n = min(KC, kf - k0);
    __syncthreads();
    stage_rows(rows, c.dt + (size_t)k0 * F, n * F);
    __syncthreads();
    float Tc = ck[ch * c.P + c.p];
    for (int i = 0; i < n; ++i) {
      tex[i * c.P + c.p] = Tc;
      if (k0 + i < kend) {
        const RowEval e =
            eval_row(rows + i * F, c.x0, c.y0, c.pxl, c.pyl, c.pix_ok);
        Tc *= (1.0f - e.alpha);
      }
    }
    for (int i = n - 1; i >= 0; --i) {
      const float* r = rows + i * F;
      const RowEval e = eval_row(r, c.x0, c.y0, c.pxl, c.pyl, c.pix_ok);
      const bool contrib = e.ok && (k0 + i < kend);
      const float tx = tex[i * c.P + c.p];
      const float om = 1.0f - e.alpha;
      const float w = contrib ? e.alpha * tx : 0.0f;
      const bool live = e.ok && (e.alpha < 0.99f);
      float v[NV];
      {
        float wbar = r[R0] * g[0] + r[G0] * g[1] + r[B0] * g[2];
        if constexpr (DEP) wbar += r[CZ] * g[3];
        wbar += g[4];
        const float obar = S / om;
        const float abar = (contrib ? tx * wbar : 0.0f) - obar;
        S += wbar * w;
        const float sbar = live ? e.alpha * abar : 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) v[j] = sbar * c.pm[j];
        v[6] = w * g[0];
        v[7] = w * g[1];
        v[8] = w * g[2];
        if constexpr (DEP) v[9] = w * g[3];
      }
      if constexpr (DEPCHAIN) {
        const float wbar = r[CZ] * gd;
        const float obar = Sd / om;
        const float abar = (contrib ? tx * wbar : 0.0f) - obar;
        Sd += wbar * w;
        const float sbar = live ? e.alpha * abar : 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) v[NV0 + j] = sbar * c.pm[j];
        v[NV0 + 6] = w * gd;
      }
      // stored by every lane, unguarded (see tile_sums)
#pragma unroll
      for (int j = 0; j < NV; ++j)
        red[(i * c.nw + c.warp) * NV + j] = warp_sum(v[j]);
    }
    __syncthreads();
    for (int i = c.p; i < n; i += c.P) {
      const float* r = rows + i * F;
      float tot[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float s = 0.f;
        for (int w = 0; w < c.nw; ++w) s += red[(i * c.nw + w) * NV + j];
        tot[j] = s;
      }
      const size_t row = ((size_t)c.t * kf + k0 + i) * F;
      write_row(dd + row, r, c.x0, c.y0, tot, tot[6], tot[7], tot[8],
                DEP ? tot[NV0 - 1] : 0.0f);
      if constexpr (DEPCHAIN)
        write_row(dd_dep + row, r, c.x0, c.y0, tot + NV0, 0.f, 0.f, 0.f,
                  tot[NV0 + 6]);
    }
  }
}

// Shared memory of a reverse kernel, in bytes.
size_t reverse_smem(int kf, int p, int nv) {
  const int nw = p / 32;
  return (size_t)(KC * F + n_chunks(kf) * p + KC * p + KC * nw * nv +
                  nw * 8) *
         sizeof(float);
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
  constexpr int NV = RevSpec<false, RGBD>::NV;
  extern __shared__ float smem[];
  const Tile c = load_tile(d, tx0, ty0, pmat, kf, width, height);
  float* rows = smem;
  float* ck = rows + KC * F;
  float* tex = ck + n_chunks(kf) * c.P;
  float* red = tex + KC * c.P;
  float* bsum = red + KC * c.nw * NV;

  float o[5];
  const int kend = forward_checkpointed(c, rows, ck, kf, o);

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
  reverse_blend<false, RGBD>(c, rows, ck, tex, red, kf, kend, g, gd3, dd,
                             dd_dep);
}

// --------------------------------------------------- fused mapping step --
// Forward blend, masked L1 residual (exposure unless initialising), its
// sign as the output cotangent with the mean normalisers and the RGB-D mix
// applied, reverse blend. Mapping's normalisers are constants, so even
// RGB-D needs one reverse chain: the depth term is the output cotangent's
// depth column. sums: (sum |r_rgb|, sum |r_d|, sum sgn mask col,
// sum sgn mask, 0, 0, 0, 0); the caller applies the weight and sign(ea) to
// the exposure sums.
template <bool RGBD>
__global__ void map_grad_kernel(
    const float* __restrict__ d, const float* __restrict__ tx0,
    const float* __restrict__ ty0, const float* __restrict__ pmat,
    const float* __restrict__ gt, const float* __restrict__ mask,
    const float* __restrict__ gtd, const float* __restrict__ sc,
    float* __restrict__ dd, float* __restrict__ sums, int kf, int width,
    int height, int use_exposure, float w_rgb, float w_dep, float eps) {
  constexpr int NV = RevSpec<RGBD, false>::NV;
  extern __shared__ float smem[];
  const Tile c = load_tile(d, tx0, ty0, pmat, kf, width, height);
  float* rows = smem;
  float* ck = rows + KC * F;
  float* tex = ck + n_chunks(kf) * c.P;
  float* red = tex + KC * c.P;
  float* bsum = red + KC * c.nw * NV;

  float o[5];
  const int kend = forward_checkpointed(c, rows, ck, kf, o);

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
  reverse_blend<RGBD, false>(c, rows, ck, tex, red, kf, kend, g, 0.f, dd,
                             nullptr);
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
  constexpr int NV = RevSpec<true, false>::NV;
  extern __shared__ float smem[];
  const Tile c = load_tile(d, tx0, ty0, pmat, kf, width, height);
  float* rows = smem;
  float* ck = rows + KC * F;
  float* tex = ck + n_chunks(kf) * c.P;
  float* red = tex + KC * c.P;

  float o[5];
  const int kend = forward_checkpointed(c, rows, ck, kf, o);
  const float* go = g_outs + ((size_t)c.t * c.P + c.p) * 8;
  const float g[5] = {go[0], go[1], go[2], go[3], go[4]};
  reverse_blend<true, false>(c, rows, ck, tex, red, kf, kend, g, 0.f, dd,
                             nullptr);
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

// Dynamic shared memory above 48 KB needs the kernel's opt-in.
template <typename K>
cudaError_t launch_prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gtd) {
    const size_t smem = reverse_smem(kf, p, RevSpec<false, true>::NV);
    const cudaError_t rc = launch_prepare(fo_grad_kernel<true>, smem);
    if (rc != cudaSuccess) return (int)rc;
    fo_grad_kernel<true><<<n_tiles, p, smem, s>>>(
        d, tx0, ty0, pmat, gt, mask, gtd, sc, dd, dd_dep, sums, kf, width,
        height, use_huber, delta, two_delta, delta_sq, eps);
  } else {
    const size_t smem = reverse_smem(kf, p, RevSpec<false, false>::NV);
    const cudaError_t rc = launch_prepare(fo_grad_kernel<false>, smem);
    if (rc != cudaSuccess) return (int)rc;
    fo_grad_kernel<false><<<n_tiles, p, smem, s>>>(
        d, tx0, ty0, pmat, gt, mask, nullptr, sc, dd, nullptr, sums, kf,
        width, height, use_huber, delta, two_delta, delta_sq, eps);
  }
  return (int)cudaGetLastError();
}

extern "C" int blend_map_grad(const float* d, const float* tx0,
                              const float* ty0, const float* pmat,
                              const float* gt, const float* mask,
                              const float* gtd, const float* sc, float* dd,
                              float* sums, int n_tiles, int kf, int p,
                              int width, int height, int use_exposure,
                              float w_rgb, float w_dep, float eps,
                              void* stream) {
  if (n_tiles == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gtd) {
    const size_t smem = reverse_smem(kf, p, RevSpec<true, false>::NV);
    const cudaError_t rc = launch_prepare(map_grad_kernel<true>, smem);
    if (rc != cudaSuccess) return (int)rc;
    map_grad_kernel<true><<<n_tiles, p, smem, s>>>(
        d, tx0, ty0, pmat, gt, mask, gtd, sc, dd, sums, kf, width, height,
        use_exposure, w_rgb, w_dep, eps);
  } else {
    const size_t smem = reverse_smem(kf, p, RevSpec<false, false>::NV);
    const cudaError_t rc = launch_prepare(map_grad_kernel<false>, smem);
    if (rc != cudaSuccess) return (int)rc;
    map_grad_kernel<false><<<n_tiles, p, smem, s>>>(
        d, tx0, ty0, pmat, gt, mask, nullptr, sc, dd, sums, kf, width,
        height, use_exposure, w_rgb, w_dep, eps);
  }
  return (int)cudaGetLastError();
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
