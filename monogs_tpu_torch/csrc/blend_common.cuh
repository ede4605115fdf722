// Device machinery shared by the blend kernels (blend_lists.cu,
// blend_macros.cu): row evaluation, row staging, the forward walk with its
// exact early exit, the checkpointed forward and the reverse blend.
//
// A CTA blends one 16x16 tile with one thread per pixel. Its rows come from
// a row source, a compile-time choice so that the list kernels carry no
// index: the tile's own depth-ordered list (OwnRows, row k is dt[k]), or
// rows picked from a macro list by an index list in shared memory
// (IndexedRows, row k is dt[ridx[k]]). Row cotangents go to the same row of
// the output (dd_t[k], or dd_t[ridx[k]]).
//
// Packed row layout (renderer._F columns): u, v, conic a/b/c, opacity, rgb,
// z, radius, log-opacity, pad. Invalid rows carry LOGO = -1e30 and never
// pass the alpha test.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int F = 16;
constexpr int CU = 0, CV = 1, CA = 2, CB = 3, CC = 4, R0 = 6, G0 = 7, B0 = 8,
              CZ = 9, RAD = 10, LOGO = 11;
constexpr int KC = 32;       // rows staged in shared memory per step
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

__device__ __forceinline__ void stage_span(float* dst, const float* src,
                                           int n_floats) {
  for (int i = threadIdx.x; i < n_floats; i += blockDim.x) dst[i] = src[i];
}

// Asynchronous copy of n_floats (a multiple of 4, both ends 16-byte
// aligned) from global to shared memory by the CTA's threads, 16 bytes
// each; cp_async_commit closes a group of them, cp_async_wait<N> waits
// until at most N of this thread's groups are in flight (a barrier after
// it makes every thread's copies visible).
__device__ __forceinline__ void stage_span_async(float* dst, const float* src,
                                                 int n_floats) {
  for (int i = 4 * threadIdx.x; i < n_floats; i += 4 * blockDim.x) {
    const unsigned s =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(s), "l"(src + i) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store8(float* out, const float* v5) {
  float4* o = reinterpret_cast<float4*>(out);
  o[0] = make_float4(v5[0], v5[1], v5[2], v5[3]);
  o[1] = make_float4(v5[4], 0.f, 0.f, 0.f);
}

// kStopEarly: the checkpointed forward stops staging chunks once every pixel
// of the CTA has terminated. That pays on a macro list (up to Km rows); on a
// tile list of a few chunks the per-chunk barrier costs more than it saves
// (the RGB-D mapping step at Kf 256 ran 12 % slower with it on an H100,
// scripts/port_kernel_ab.py).
struct OwnRows {
  static constexpr bool kContiguous = true;
  static constexpr bool kStopEarly = false;
  static constexpr bool kMadd = false;
  const float* dt;
  __device__ __forceinline__ int operator()(int k) const { return k; }
};

// A raw row -1e30 + LOGO rounds to -1e30 in float32 (LOGO >= log(1e-12)),
// so a masked row stages bit for bit as the caller's pre-masked copy would.
struct MaddRows {
  static constexpr bool kContiguous = true;
  static constexpr bool kStopEarly = false;
  static constexpr bool kMadd = true;
  const float* dt;
  const float* madd_t;  // [kf]
  __device__ __forceinline__ int operator()(int k) const { return k; }
};

struct IndexedRows {
  static constexpr bool kContiguous = false;
  static constexpr bool kStopEarly = true;
  static constexpr bool kMadd = false;
  const float* dt;
  const int* ridx;  // shared memory
  __device__ __forceinline__ int operator()(int k) const { return ridx[k]; }
};

template <class Rows>
struct Tile {
  int t, p, lane, warp, nw, P;
  float x0, y0, pxl, pyl;
  float pm[6];
  bool pix_ok;
  Rows src;
};

// np: the pixels of the tile, the row stride of pmat [6][np]; thread p
// holds pixel p (a fused step's CTA with pixel slices holds more, see
// "tensor-core reverse").
template <class Rows>
__device__ __forceinline__ Tile<Rows> make_tile(int t, float x0, float y0,
                                                const float* pmat, Rows src,
                                                int width, int height,
                                                int np) {
  Tile<Rows> c;
  c.P = blockDim.x;
  c.nw = c.P >> 5;
  c.t = t;
  c.p = threadIdx.x;
  c.lane = c.p & 31;
  c.warp = c.p >> 5;
  c.x0 = x0;
  c.y0 = y0;
#pragma unroll
  for (int j = 0; j < 6; ++j) c.pm[j] = pmat[j * np + c.p];
  c.pxl = c.pm[3];
  c.pyl = c.pm[4];
  c.pix_ok = (c.x0 + c.pxl <= (float)(width - 1)) &&
             (c.y0 + c.pyl <= (float)(height - 1));
  c.src = src;
  return c;
}

// One thread per pixel of the tile.
template <class Rows>
__device__ __forceinline__ Tile<Rows> make_tile(int t, float x0, float y0,
                                                const float* pmat, Rows src,
                                                int width, int height) {
  return make_tile(t, x0, y0, pmat, src, width, height, (int)blockDim.x);
}

// The tile of a list kernel: CTA t blends its own rows d[t] [kf][F].
__device__ __forceinline__ Tile<OwnRows> load_tile(const float* d,
                                                   const float* tx0,
                                                   const float* ty0,
                                                   const float* pmat, int kf,
                                                   int width, int height,
                                                   int np) {
  const int t = blockIdx.x;
  return make_tile(t, tx0[t], ty0[t], pmat, OwnRows{d + (size_t)t * kf * F},
                   width, height, np);
}

__device__ __forceinline__ Tile<OwnRows> load_tile(const float* d,
                                                   const float* tx0,
                                                   const float* ty0,
                                                   const float* pmat, int kf,
                                                   int width, int height) {
  return load_tile(d, tx0, ty0, pmat, kf, width, height, (int)blockDim.x);
}

// Stage rows k0 .. k0 + n - 1 of the tile's row source into dst [n][F].
template <class Rows>
__device__ __forceinline__ void stage_rows(float* dst, const Tile<Rows>& c,
                                           int k0, int n) {
  if constexpr (Rows::kMadd) {
    const float* src = c.src.dt + (size_t)k0 * F;
    for (int i = threadIdx.x; i < n * F; i += blockDim.x) {
      float v = src[i];
      if (i % F == LOGO) v += c.src.madd_t[k0 + i / F];
      dst[i] = v;
    }
  } else if constexpr (Rows::kContiguous) {
    stage_span(dst, c.src.dt + (size_t)k0 * F, n * F);
  } else {
    for (int i = threadIdx.x; i < n * F; i += blockDim.x)
      dst[i] = c.src.dt[(size_t)c.src(k0 + i / F) * F + i % F];
  }
}

__host__ __device__ constexpr int n_chunks(int kf) {
  return (kf + KC - 1) / KC;
}

// ---------------------------------------------------------- forward walk --
// Front-to-back blend of the tile's kf rows into o[5] (r, g, b, depth,
// acc), with the exact per-pixel early exit (T is non-increasing, so once
// T (1 - a) < 1e-4 no later row contributes) and a CTA exit once every
// pixel has exited; pixels beyond the image edge never walk. COUNTS: each
// row's contributing-pixel count into cnts_t[kf] from a warp ballot and
// popcount, summed over the warps in shared memory (wcnt [KC][nw]).
// Every thread of the CTA must call it: it stages rows between barriers.
template <bool COUNTS, class Rows>
__device__ __forceinline__ void forward_walk(const Tile<Rows>& c, float* rows,
                                             int* wcnt, int kf, float o[5],
                                             float* cnts_t) {
  float T = 1.0f;
#pragma unroll
  for (int j = 0; j < 5; ++j) o[j] = 0.f;
  bool done = !c.pix_ok;
  for (int k0 = 0; k0 < kf; k0 += KC) {
    const int n = min(KC, kf - k0);
    __syncthreads();
    stage_rows(rows, c, k0, n);
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const float* r = rows + i * F;
      bool contrib = false;
      if (!done) {
        const RowEval e = eval_row(r, c.x0, c.y0, c.pxl, c.pyl, c.pix_ok);
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
        if (c.lane == 0) wcnt[i * c.nw + c.warp] = __popc(b);
      }
    }
    const bool all_done = __syncthreads_and(done);
    if constexpr (COUNTS) {
      for (int i = c.p; i < n; i += c.P) {
        int s = 0;
        for (int w = 0; w < c.nw; ++w) s += wcnt[i * c.nw + w];
        cnts_t[k0 + i] = (float)s;
      }
      if (all_done) {
        for (int k = k0 + n + c.p; k < kf; k += c.P) cnts_t[k] = 0.f;
      }
    }
    if (all_done) break;
  }
}

// ------------------------------------------------------- reverse machinery --
// Serves only the macro-list VJP (macro_bwd_kernel, blend_macros.cu); the
// list kernels that pull cotangents back (fused first-order and mapping
// steps, blend VJP) run the tensor-core reverse below. A forward pass that
// stores the transmittance at each KC-row chunk entry, then a back-to-front
// pass per chunk that recomputes the chunk's per-row T_excl from its
// checkpoint, carries the suffix sum(wbar * w) and reduces each row's six
// conic moments and its feature sums deterministically (warp shuffles, then
// a fixed-order sum over the warps in shared memory). No atomics: each CTA
// owns the rows it writes.
//
// Shared memory (floats): rows [KC][F] | ck [nch][P] | tex [KC][P] |
// red [KC][nw][NV] per-warp row sums | bsum [nw][8] per-warp tile sums.

// Forward blend of the tile's rows into o[5] (r, g, b, depth, acc),
// storing the transmittance at each chunk entry in ck; returns the index of
// the row at which the pixel terminates (kf if it never does, 0 for a pixel
// beyond the image edge). With Rows::kStopEarly, chunks stop once every
// pixel has terminated. n_live receives the number of chunks walked, beyond
// which every row's cotangent is 0. Every thread of the CTA must call it.
template <class Rows>
__device__ __forceinline__ int forward_checkpointed(const Tile<Rows>& c,
                                                    float* rows, float* ck,
                                                    int kf, float o[5],
                                                    int& n_live) {
  float T = 1.0f;
#pragma unroll
  for (int j = 0; j < 5; ++j) o[j] = 0.f;
  int kend = c.pix_ok ? kf : 0;
  n_live = n_chunks(kf);
  for (int ch = 0; ch < n_chunks(kf); ++ch) {
    const int k0 = ch * KC;
    const int n = min(KC, kf - k0);
    ck[ch * c.P + c.p] = T;
    __syncthreads();
    stage_rows(rows, c, k0, n);
    __syncthreads();
    if (kend == kf) {
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
    if constexpr (Rows::kStopEarly) {
      if (__syncthreads_and(kend < kf)) {
        n_live = ch + 1;
        break;
      }
    }
  }
  return kend;
}

// sums[t][0..7] = the CTA's sums of part[0..NS-1] (zero beyond NS).
template <int NS, class Rows>
__device__ __forceinline__ void tile_sums(const Tile<Rows>& c,
                                          const float* part, float* bsum,
                                          float* sums) {
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

__device__ __forceinline__ void zero_row(float* dst) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int j = 0; j < 4; ++j) d4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Values each pixel reduces per row: six conic moments and the r, g, b
// feature sums, the depth feature sum when DEP, and for DEPCHAIN a second,
// depth-only chain (six moments and its depth sum).
template <bool DEP, bool DEPCHAIN>
struct RevSpec {
  static constexpr int NV0 = DEP ? 10 : 9;
  static constexpr int NV = NV0 + (DEPCHAIN ? 7 : 0);
};

// Reverse blend, back to front, chunk by chunk from the checkpoints of
// forward_checkpointed (kend, n_live its results). g[5]: this pixel's output
// cotangent (r, g, b, depth, acc); the depth entry is read only when DEP.
// gd: the depth-only second chain's cotangent when DEPCHAIN. Writes the
// cotangent of row k to dd_t (and ddd_t) at row c.src(k); rows of the
// chunks beyond n_live get zeros.
template <bool DEP, bool DEPCHAIN, class Rows>
__device__ __forceinline__ void reverse_blend(const Tile<Rows>& c, float* rows,
                                              const float* ck, float* tex,
                                              float* red, int kf, int kend,
                                              int n_live, const float g[5],
                                              float gd, float* dd_t,
                                              float* ddd_t) {
  using S_ = RevSpec<DEP, DEPCHAIN>;
  constexpr int NV0 = S_::NV0, NV = S_::NV;
  for (int k = n_live * KC + c.p; k < kf; k += c.P) {
    const size_t row = (size_t)c.src(k) * F;
    zero_row(dd_t + row);
    if constexpr (DEPCHAIN) zero_row(ddd_t + row);
  }
  float S = 0.f, Sd = 0.f;  // suffix sums of wbar * w (each chain)
  for (int ch = n_live - 1; ch >= 0; --ch) {
    const int k0 = ch * KC;
    const int n = min(KC, kf - k0);
    __syncthreads();
    stage_rows(rows, c, k0, n);
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
      const size_t row = (size_t)c.src(k0 + i) * F;
      write_row(dd_t + row, r, c.x0, c.y0, tot, tot[6], tot[7], tot[8],
                DEP ? tot[NV0 - 1] : 0.0f);
      if constexpr (DEPCHAIN)
        write_row(ddd_t + row, r, c.x0, c.y0, tot + NV0, 0.f, 0.f, 0.f,
                  tot[NV0 + 6]);
    }
  }
}

// ---------------------------------------------- tensor-core reverse (TC) --
// Used by the fused first-order and mapping steps and the blend VJP, one
// CTA per tile. The forward stores the transmittance at each chunk's entry
// and finds the chunks that some pixel walks into (forward_live); the
// chunks after them get zero rows. The live chunks are reversed back to
// front: a pass over the chunk's rows from its checkpoint keeps each row's
// alpha (0 where the row does not contribute) and entry transmittance in
// shared memory, so the back-to-front pass evaluates no row; it overwrites
// them with sbar and w, and the row sums are two products on the tensor
// cores (mma.sync m16n8k8, TF32, float32 accumulation):
//   moments  [KC x P] sbar . [P x 8] pixel basis (px^2, px py, py^2, px,
//            py, 1, 0, 0),
//   features [KC x P] w    . [P x 8] per-pixel output cotangents,
// with a depth chain's moments as a third. Each float32 operand is split
// into a TF32 big part and a TF32 remainder: the pixel basis holds small
// integers (exact in TF32), so the moments take two passes (big.B,
// small.B) and the features three (the remainder of B's too). Warp w
// multiplies pixels [32w, 32w + 32); the warps' partial sums are added in
// a fixed order (no atomics, so two launches give the same bits).
//
// Pixel slices: a CTA has nt = min(P, SLICE) threads. A tile of more
// pixels (P 1024 for a 32 px tile) is walked in NSL slices of nt, slice s
// being pixels [s nt, s nt + nt): thread i holds pixel s nt + i of each
// slice and its state (transmittance, outputs, terminating row,
// cotangents, suffix sums) in registers, and pixels beyond P are outside
// the image. The slices share the staged rows; in the row sums the pixels
// are the products' K dimension, so each slice's products add into the
// same accumulators, slice after slice in a fixed order (split K). With
// NSL = 1 a thread holds one pixel, as in a tile of up to 16 px.
//
// Shared memory (floats): rows [KC][F] | ck [nch][NSL][nt] checkpoints |
// A [NA][KC][nt + 4] operands of one slice (the row stride nt + 4 makes
// the fragment loads conflict-free) | gsh [nt][GCOL] feature cotangents |
// bsum [nw][8] tile sums. The warps' partial products [nw][KC][NC] reuse
// the operands' space after the products, their totals [KC][NC] too.

constexpr int NCOL = 8;    // columns of one product (n of m16n8k8)
constexpr int GCOL = 4;    // feature columns with a cotangent (r, g, b, z)
constexpr int SLICE = 256; // pixels of a slice: the most threads of a CTA
constexpr int MAX_SLICES = 4;

__host__ __device__ constexpr int slice_threads(int np) {
  return np > SLICE ? SLICE : np;
}

__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small up to 2^-22 |x|; x - big is exact in float32.
__device__ __forceinline__ void tf32_split(float x, unsigned& big,
                                           unsigned& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// mma.sync is a warp-collective: every lane of the warp must execute the
// same instruction. The asm is volatile, with a memory clobber, so that it
// stays in program order between the barriers around the products. Its
// operand fetches must be branch-free too: when they were lane-dependent
// selects (gid < 6 ? pmat[...] : 0), nvcc split the product loop on the
// lane's gid into two copies, each with its own mma.sync, and the warp
// hung at its first launch (scripts/port_sass_diff.py counts such HMMA).
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1])
      : "memory");
}

// Products of the chunk's reduction: the moments of sbar, the features of
// w, and with DEPCHAIN the moments of the depth chain's sbar.
template <bool DEPCHAIN>
struct TcSpec {
  static constexpr int NA = DEPCHAIN ? 3 : 2;  // operand arrays
  static constexpr int NC = NA * NCOL;         // summed columns per row
};

// The pixels a thread holds beyond the Tile's first: slice s's pixel
// s nt + p (slice 0's is the Tile's own).
template <int NSL>
struct Slices {
  float pxl[NSL], pyl[NSL];
  bool ok[NSL];  // inside the tile's P pixels and the image
};

template <int NSL, class Rows>
__device__ __forceinline__ Slices<NSL> make_slices(const Tile<Rows>& c,
                                                   const float* pmat, int np,
                                                   int width, int height) {
  Slices<NSL> q;
  q.pxl[0] = c.pxl;
  q.pyl[0] = c.pyl;
  q.ok[0] = c.pix_ok;
#pragma unroll
  for (int s = 1; s < NSL; ++s) {
    const int i = s * c.P + c.p;
    const int j = min(i, np - 1);
    q.pxl[s] = pmat[3 * np + j];
    q.pyl[s] = pmat[4 * np + j];
    q.ok[s] = (i < np) && (c.x0 + q.pxl[s] <= (float)(width - 1)) &&
              (c.y0 + q.pyl[s] <= (float)(height - 1));
  }
  return q;
}

// Whether slice s's pixel of this thread lies within the tile's np pixels
// (the index of its per-pixel inputs is then c.t np + s nt + c.p).
template <int NSL, class Rows>
__device__ __forceinline__ bool in_tile(const Tile<Rows>& c, int s, int np) {
  return NSL == 1 || s * c.P + c.p < np;
}

// Forward blend of the tile's rows into o[s][5] (r, g, b, depth, acc) per
// slice, storing the transmittance at each chunk entry in ck; the barrier
// before each chunk's staging also reduces the exit test, so the walk
// stops once every pixel has terminated. kend[s]: the pixel's terminating
// row (kf if it never terminates, 0 beyond the image edge); n_live
// receives the number of chunks that some pixel walked into, beyond which
// every row's cotangent is 0. Every thread of the CTA must call it.
template <int NSL, class Rows>
__device__ __forceinline__ void forward_live(const Tile<Rows>& c,
                                             const Slices<NSL>& q,
                                             float* rows, float* ck, int kf,
                                             float o[NSL][5], int kend[NSL],
                                             int& n_live) {
  float T[NSL];
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
    T[s] = 1.0f;
#pragma unroll
    for (int j = 0; j < 5; ++j) o[s][j] = 0.f;
    kend[s] = q.ok[s] ? kf : 0;
  }
  n_live = 0;
  for (int ch = 0; ch < n_chunks(kf); ++ch) {
    bool walking = false;
#pragma unroll
    for (int s = 0; s < NSL; ++s) walking = walking || kend[s] == kf;
    if (!__syncthreads_or(walking)) break;
    n_live = ch + 1;
    const int k0 = ch * KC;
    const int n = min(KC, kf - k0);
#pragma unroll
    for (int s = 0; s < NSL; ++s) ck[(ch * NSL + s) * c.P + c.p] = T[s];
    stage_rows(rows, c, k0, n);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NSL; ++s) {
      if (kend[s] != kf) continue;
      for (int i = 0; i < n; ++i) {
        const float* r = rows + i * F;
        const RowEval e =
            eval_row(r, c.x0, c.y0, q.pxl[s], q.pyl[s], q.ok[s]);
        if (!e.ok) continue;
        const float test = T[s] * (1.0f - e.alpha);
        if (test < T_EPS) {
          kend[s] = k0 + i;
          break;
        }
        const float w = e.alpha * T[s];
        o[s][0] += w * r[R0];
        o[s][1] += w * r[G0];
        o[s][2] += w * r[B0];
        o[s][3] += w * r[CZ];
        o[s][4] += w;
        T[s] = test;
      }
    }
  }
}

// Reverse of live chunk ch of every slice, and the row cotangents written
// to dd_t (and ddd_t). Per slice: the chunk's rows walked again from the
// slice's checkpoint, keeping each row's alpha (0 where the row does not
// contribute) in A0 and entry transmittance in A1; back to front from the
// suffix behind the chunk, overwriting them with sbar and w (and the depth
// chain's sbar in A2); the products added into the accumulators. g[s]:
// slice s's output cotangent (r, g, b, depth, acc), the depth entry read
// only when DEP; gd[s]: the depth-only chain's cotangent when DEPCHAIN.
// S, Sd: per slice, the suffix sums(wbar * w) of the rows after the chunk,
// carried on to the chunk's first row. Every thread of the CTA must call
// it.
template <bool DEP, bool DEPCHAIN, int NSL, class Rows>
__device__ __forceinline__ void reverse_chunk_tc(
    const Tile<Rows>& c, const Slices<NSL>& q, float* rows, const float* ck,
    float* A, float* gsh, int lda, int kf, int ch, const int kend[NSL],
    const float* pmat, int np, const float g[NSL][5], const float gd[NSL],
    float S[NSL], float Sd[NSL], float* dd_t, float* ddd_t) {
  static_assert(!(DEP && DEPCHAIN), "one depth form per kernel");
  using Spec = TcSpec<DEPCHAIN>;
  constexpr int NC = Spec::NC;
  float* A0 = A;             // alpha -> sbar
  float* A1 = A + KC * lda;  // entry transmittance -> w
  float* A2 = A1 + KC * lda; // depth chain's sbar (DEPCHAIN)
  const int k0 = ch * KC;
  const int n = min(KC, kf - k0);
  __syncthreads();
  stage_rows(rows, c, k0, n);
  __syncthreads();

  // mma.sync needs the whole warp converged, so no operand fetch depends
  // on the lane by a branch: every lane loads (the basis row min(gid, 5),
  // the cotangent column gid & 3) and rows 6-7 of the basis and columns
  // 4-7 of the cotangents are masked to 0 after the load
  const int gid = c.lane >> 2, tig = c.lane & 3;
  const unsigned bmask = 0u - (unsigned)(gid < 6);
  const unsigned gmask = 0u - (unsigned)(gid < GCOL);
  const float* prow = pmat + min(gid, 5) * np;
  const float* gcol = gsh + (gid & (GCOL - 1));
  float acc[Spec::NA][2][4];
#pragma unroll
  for (int qa = 0; qa < Spec::NA; ++qa)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[qa][mt][j] = 0.f;

#pragma unroll
  for (int s = 0; s < NSL; ++s) {
    // the slice's records, walked again from its checkpoint
    {
      float T = ck[(ch * NSL + s) * c.P + c.p];
      for (int i = 0; i < KC; ++i) {
        float al = 0.f, tx = 0.f;
        if (i < n && k0 + i < kend[s]) {
          const RowEval e = eval_row(rows + i * F, c.x0, c.y0, q.pxl[s],
                                     q.pyl[s], q.ok[s]);
          if (e.ok) {
            al = e.alpha;
            tx = T;
            T *= (1.0f - al);
          }
        }
        A0[i * lda + c.p] = al;
        A1[i * lda + c.p] = tx;
      }
    }

    // the feature product's B: this pixel's cotangent of r, g, b and of
    // the depth column (the output's when DEP, the depth chain's when
    // DEPCHAIN)
    {
      float* gp = gsh + c.p * GCOL;
      gp[0] = g[s][0];
      gp[1] = g[s][1];
      gp[2] = g[s][2];
      gp[3] = DEP ? g[s][3] : (DEPCHAIN ? gd[s] : 0.f);
    }

    // back to front over the chunk's rows, from the suffix behind the chunk
    for (int i = KC - 1; i >= 0; --i) {
      const float al = A0[i * lda + c.p];
      const float tx = A1[i * lda + c.p];
      float sb = 0.f, w = 0.f, sbd = 0.f;
      if (al > 0.f) {  // contributing
        const float* r = rows + i * F;
        float wbar = r[R0] * g[s][0] + r[G0] * g[s][1] + r[B0] * g[s][2];
        if constexpr (DEP) wbar += r[CZ] * g[s][3];
        wbar += g[s][4];
        const float om = 1.0f - al;
        w = al * tx;
        const float obar = S[s] / om;
        const float abar = tx * wbar - obar;
        S[s] += wbar * w;
        if (al < 0.99f) sb = al * abar;
        if constexpr (DEPCHAIN) {
          const float wbd = r[CZ] * gd[s];
          const float obd = Sd[s] / om;
          const float abd = tx * wbd - obd;
          Sd[s] += wbd * w;
          if (al < 0.99f) sbd = al * abd;
        }
      }
      A0[i * lda + c.p] = sb;
      A1[i * lda + c.p] = w;
      if constexpr (DEPCHAIN) A2[i * lda + c.p] = sbd;
    }
    __syncthreads();

    // the slice's row sums on the tensor cores: warp w takes pixels
    // [32 w, 32 w + 32) of the slice in four k-steps of 8, both 16-row
    // halves; a pixel beyond P has zero operands, and its basis is read
    // at P - 1
    __syncwarp();
#pragma unroll
    for (int s4 = 0; s4 < 4; ++s4) {
      const int kk = c.warp * 32 + s4 * 8 + tig;
      int b0 = kk, b1 = kk + 4;
      if constexpr (NSL > 1) {
        b0 = min(s * c.P + b0, np - 1);
        b1 = min(s * c.P + b1, np - 1);
      }
      unsigned bp[2], gb[2], gs[2];
      bp[0] = __float_as_uint(prow[b0]) & bmask;
      bp[1] = __float_as_uint(prow[b1]) & bmask;
      tf32_split(__uint_as_float(__float_as_uint(gcol[kk * GCOL]) & gmask),
                 gb[0], gs[0]);
      tf32_split(
          __uint_as_float(__float_as_uint(gcol[(kk + 4) * GCOL]) & gmask),
          gb[1], gs[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r0 = (mt * 16 + gid) * lda + kk;
        const int r1 = r0 + 8 * lda;
#pragma unroll
        for (int qa = 0; qa < Spec::NA; ++qa) {
          const float* Aq = A + qa * KC * lda;
          unsigned ab[4], as[4];
          tf32_split(Aq[r0], ab[0], as[0]);
          tf32_split(Aq[r1], ab[1], as[1]);
          tf32_split(Aq[r0 + 4], ab[2], as[2]);
          tf32_split(Aq[r1 + 4], ab[3], as[3]);
          if (qa == 1) {  // features: remainders first, then the big parts
            mma_tf32(acc[qa][mt], as, gb);
            mma_tf32(acc[qa][mt], ab, gs);
            mma_tf32(acc[qa][mt], ab, gb);
          } else {        // moments: the pixel basis is exact in TF32
            mma_tf32(acc[qa][mt], as, bp);
            mma_tf32(acc[qa][mt], ab, bp);
          }
        }
      }
    }
    __syncthreads();  // every warp has read the operands
  }

  // partial sums [nw][KC][NC] over the operands, then their totals
  // [KC][NC] in a fixed order over the warps
  float* part = A;
  float* tot = A + c.nw * KC * NC;
#pragma unroll
  for (int qa = 0; qa < Spec::NA; ++qa)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float* pr = part + (c.warp * KC + mt * 16 + gid) * NC + qa * NCOL +
                  2 * tig;
      *reinterpret_cast<float2*>(pr) =
          make_float2(acc[qa][mt][0], acc[qa][mt][1]);
      *reinterpret_cast<float2*>(pr + 8 * NC) =
          make_float2(acc[qa][mt][2], acc[qa][mt][3]);
    }
  __syncthreads();
  for (int idx = c.p; idx < KC * NC; idx += c.P) {
    float sum = 0.f;
    for (int w = 0; w < c.nw; ++w) sum += part[w * KC * NC + idx];
    tot[idx] = sum;
  }
  __syncthreads();
  // columns of tot per row: moments 0-5 | w g: r, g, b, depth 8-11 |
  // depth chain's moments 16-21
  if (c.p < n) {
    const float* tr = tot + c.p * NC;
    const float* r = rows + c.p * F;
    const size_t row = (size_t)c.src(k0 + c.p) * F;
    write_row(dd_t + row, r, c.x0, c.y0, tr, tr[8], tr[9], tr[10],
              DEP ? tr[11] : 0.0f);
    if constexpr (DEPCHAIN)
      write_row(ddd_t + row, r, c.x0, c.y0, tr + 2 * NCOL, 0.f, 0.f, 0.f,
                tr[11]);
  }
}

// Row cotangents of the tile from its forward_live results (kend, n_live,
// the checkpoints ck): zero rows beyond the live chunks, then each live
// chunk back to front, recorded and reversed on the tensor cores. Every
// thread of the CTA must call it.
template <bool DEP, bool DEPCHAIN, int NSL, class Rows>
__device__ __forceinline__ void reverse_tile_tc(
    const Tile<Rows>& c, const Slices<NSL>& q, float* rows, const float* ck,
    float* A, float* gsh, int lda, int kf, const int kend[NSL], int n_live,
    const float* pmat, int np, const float g[NSL][5], const float gd[NSL],
    float* dd_t, float* ddd_t) {
  for (int k = n_live * KC + c.p; k < kf; k += c.P) {
    const size_t row = (size_t)c.src(k) * F;
    zero_row(dd_t + row);
    if constexpr (DEPCHAIN) zero_row(ddd_t + row);
  }
  float S[NSL], Sd[NSL];  // suffix sums of wbar * w (each chain)
#pragma unroll
  for (int s = 0; s < NSL; ++s) S[s] = Sd[s] = 0.f;
  for (int ch = n_live - 1; ch >= 0; --ch)
    reverse_chunk_tc<DEP, DEPCHAIN>(c, q, rows, ck, A, gsh, lda, kf, ch,
                                    kend, pmat, np, g, gd, S, Sd, dd_t,
                                    ddd_t);
}

// Shared memory of a tensor-core reverse CTA of nt threads and nsl pixel
// slices, in bytes: rows [KC][F] | ck [nch][nsl][nt] | operands
// [NA][KC][nt + 4] | gsh [nt][GCOL] | bsum [nw][8].
size_t reverse_tc_smem(int kf, int nt, int nsl, bool depchain) {
  const int na = depchain ? 3 : 2;
  return (size_t)(KC * F + n_chunks(kf) * nsl * nt + na * KC * (nt + 4) +
                  nt * GCOL + (nt / 32) * 8) *
         sizeof(float);
}

// Shared memory of the reverse machinery, in bytes.
size_t reverse_smem(int kf, int p, int nv) {
  const int nw = p / 32;
  return (size_t)(KC * F + n_chunks(kf) * p + KC * p + KC * nw * nv +
                  nw * 8) *
         sizeof(float);
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in, which fails
// above the card's limit per CTA; the error is then returned and cleared,
// so that it does not surface at a later launch.
template <typename K>
cudaError_t launch_prepare(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) cudaGetLastError();
  return rc;
}

}  // namespace
