// The forward walk of a tile, shared by the list forward (fwd_kernel,
// blend_lists.cu) and the macro-list forward (macro_fwd_kernel,
// blend_macros.cu), templated on the row source (blend_common.cuh).

#pragma once

#include "blend_common.cuh"

namespace {

// ---------------------------------------------------------------- forward --
// One CTA per tile, FWD_NPX adjacent pixels per thread (thread q holds
// pixels FWD_NPX q + j), so a warp holds a compact block of the tile, each
// staged row is read from shared memory once for FWD_NPX pixels, and a 16
// px tile is 128 threads. Each pixel's arithmetic is in eval_row's op
// order, so the outputs have the bits of a walk with one pixel a thread.
// The walk (fwd_walk) is shared with the macro-list forward, which gathers
// its rows through an index (blend_macros.cu).
//
// The warps walk independently: each stages the tile's rows into its own
// two buffers by cp.async (chunk ch + 1 copied while chunk ch is walked)
// and syncs only itself, so a warp whose rows are few never waits for
// another; it stops once its pixels have all terminated.
//
// Rows a warp cannot use are culled: after a chunk lands, lane i decides
// for row i whether some pixel of the warp's bounding box may pass the
// alpha test (row_reaches), and the warp walks only the rows of that
// ballot, its pixels branch-free, so that their chains interleave. A
// culled row fails the alpha test at every pixel of the warp, so culling
// changes no bit (tests/test_torch_blend_lists.py emulates row_reaches
// and checks that on real rows).
//
// COUNTS: each walked row's contributing pixels, one ballot and popcount
// per pixel slot; lane i keeps row i's and adds it to the tile's integer
// count in shared memory (exact in any order), written out after a last
// barrier. Shared memory: rows [nw][2][KC][F] | COUNTS: counts [kf] ints.
constexpr int FWD_NPX = 2;

// alpha >= 1/255 needs s >= log(1/255) = -5.5413, and expf errs by at
// most 2 ulp: below S_LO no pair passes the alpha test.
constexpr float S_LO = -5.55f;

__host__ __device__ constexpr int fwd_threads(int p) {
  return ((p + FWD_NPX - 1) / FWD_NPX + 31) / 32 * 32;
}

__host__ __device__ constexpr size_t fwd_smem(int nt, int kf, bool counts) {
  return (nt / 32 * 2 * KC * F + (counts ? kf : 0)) * sizeof(float);
}

// Whether a row (columns r0 = (u, v, a, b), r1 = (c, ...), r2 = (...,
// log-opacity); tile-local centre ul, vl) may pass the alpha test at a
// pixel of the box [x0, x1] x [y0, y1] (tile-local pixel coordinates). A
// pair passes only if its log-alpha s = log-opacity - Q / 2 lies in
// [S_LO, log-opacity + 1e-4], Q the conic's quadratic form at the pixel's
// offset. Culled are rows whose log-opacity + 1e-4 is below S_LO (or NaN),
// and rows with a positive-definite conic of condition number below 1000
// (so that the float Q at a pixel errs by under 1 %) whose smallest Q over
// the box, less 1 %, puts s below S_LO by 0.01; any other row (also one
// with a NaN or inf conic) is walked. The box's offsets bracket every
// pixel's float offset, since rounding is monotonic.
__device__ __forceinline__ bool row_reaches(float4 r0, float4 r1, float4 r2,
                                            float ul, float vl, float x0,
                                            float x1, float y0, float y1) {
  const float lim = r2.w + 1e-4f;
  if (!(lim >= S_LO)) return false;
  const float a = r0.z, b = r0.w, c = r1.x;
  const float tr = a + c;
  if (!(a > 0.f && c > 0.f && a * c - b * b > 1e-3f * tr * tr)) return true;
  // offsets d = centre - pixel over the box; Q(d) = a dx^2 + 2b dx dy + c dy^2
  const float dx0 = ul - x1, dx1 = ul - x0, dy0 = vl - y1, dy1 = vl - y0;
  if (dx0 <= 0.f && dx1 >= 0.f && dy0 <= 0.f && dy1 >= 0.f) return true;
  auto q = [&](float dx, float dy) {
    return a * dx * dx + 2.f * b * dx * dy + c * dy * dy;
  };
  // the minimum lies on the box's edge: on each side, the minimiser along
  // it clamped to the side (its rounding moves Q by far less than 1 %)
  const float ra = -b * __frcp_rn(a), rc = -b * __frcp_rn(c);
  const float qmin = fminf(
      fminf(q(dx0, fminf(fmaxf(rc * dx0, dy0), dy1)),
            q(dx1, fminf(fmaxf(rc * dx1, dy0), dy1))),
      fminf(q(fminf(fmaxf(ra * dy0, dx0), dx1), dy0),
            q(fminf(fmaxf(ra * dy1, dx0), dx1), dy1)));
  return !(lim - 0.495f * qmin < S_LO - 0.01f);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The walk of one tile by the CTA's warps: the rows of the row source
// (OwnRows: the tile's list, staged as contiguous spans; IndexedRows: rows
// of a macro list gathered through the tile's index, four aligned 16-byte
// copies a row, blend_macros.cu), this thread's pixels' outputs into o.
// lane: threadIdx.x & 31, computed by the caller; np: the tile's pixels;
// cnt_s: the tile's integer counts (COUNTS).
template <bool COUNTS, class Rows>
__device__ __forceinline__ void fwd_walk(const Rows& src, int lane,
                                         float x0, float y0,
                                         const float* pmat, float* wrows,
                                         int* cnt_s, int kf, int np,
                                         int width, int height,
                                         float o[FWD_NPX][5]) {
  constexpr int NPX = FWD_NPX;
  const int q = threadIdx.x;
  float pxl[NPX], pyl[NPX];
  bool done[NPX];
  // the bounding box of the warp's pixels that walk (inside the tile and
  // the image; empty if none)
  const float inf = __int_as_float(0x7f800000);
  float bx0 = inf, bx1 = -inf, by0 = inf, by1 = -inf;
#pragma unroll
  for (int j = 0; j < NPX; ++j) {
    const int p = NPX * q + j;
    pxl[j] = p < np ? pmat[3 * np + p] : 0.f;
    pyl[j] = p < np ? pmat[4 * np + p] : 0.f;
    done[j] = !(p < np && x0 + pxl[j] <= (float)(width - 1) &&
                y0 + pyl[j] <= (float)(height - 1));
    if (!done[j]) {
      bx0 = fminf(bx0, pxl[j]);
      bx1 = fmaxf(bx1, pxl[j]);
      by0 = fminf(by0, pyl[j]);
      by1 = fmaxf(by1, pyl[j]);
    }
  }
  bx0 = warp_min(bx0);
  bx1 = -warp_min(-bx1);
  by0 = warp_min(by0);
  by1 = -warp_min(-by1);
  float T[NPX];
#pragma unroll
  for (int j = 0; j < NPX; ++j) {
    T[j] = 1.0f;
#pragma unroll
    for (int c = 0; c < 5; ++c) o[j][c] = 0.f;
  }
  // chunk ch's rows into this warp's buffer ch & 1, 16 bytes a lane
  auto stage = [&](int ch) {
    const int k0 = ch * KC, nf = min(KC, kf - k0) * F;
    float* dst = wrows + (ch & 1) * KC * F;
    if constexpr (Rows::kContiguous) {
      const float* from = src.dt + (size_t)k0 * F;
      for (int i = 4 * lane; i < nf; i += 128) {
        const unsigned sa =
            static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(sa), "l"(from + i) : "memory");
      }
    } else {
      // lane l reads the index of the chunk's row l; float i of the chunk
      // (i = 4 l + 128 j) lies in row i / F, whose index lane i / F holds
      const int row = lane * F < nf ? src(k0 + lane) : 0;
#pragma unroll
      for (int j = 0; j < KC * F / 128; ++j) {
        const int i = 4 * lane + 128 * j;
        const int r = __shfl_sync(0xffffffffu, row, i / F);
        if (i < nf) {
          const unsigned sa =
              static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                       :: "r"(sa), "l"(src.dt + (size_t)r * F + i % F)
                       : "memory");
        }
      }
    }
    cp_async_commit();
  };
  const int nch = n_chunks(kf);
  stage(0);
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<0>();
    __syncwarp();  // the chunk's rows visible, the other buffer free
    bool done_all = true;
#pragma unroll
    for (int j = 0; j < NPX; ++j) done_all = done_all && done[j];
    if (__all_sync(0xffffffffu, done_all)) break;
    if (ch + 1 < nch) stage(ch + 1);
    const int n = min(KC, kf - ch * KC);
    const float* rows = wrows + (ch & 1) * KC * F;
    bool mine = false;
    if (lane < n) {
      const float4* r4 = reinterpret_cast<const float4*>(rows + lane * F);
      const float4 r0 = r4[0], r1 = r4[1], r2 = r4[2];
      mine = row_reaches(r0, r1, r2, r0.x - x0, r0.y - y0, bx0, bx1, by0,
                         by1);
    }
    int my_cnt = 0;
    for (unsigned m = __ballot_sync(0xffffffffu, mine);
         m != 0 && (COUNTS || !done_all); m &= m - 1) {
      const int i = __ffs(m) - 1;
      // columns: r0 = (u, v, a, b), r1 = (c, opacity, r, g),
      // r2 = (b, z, radius, log-opacity)
      const float4* r4 = reinterpret_cast<const float4*>(rows + i * F);
      const float4 r0 = r4[0], r1 = r4[1], r2 = r4[2];
      const float ul = r0.x - x0;
      const float vl = r0.y - y0;
      bool contrib[NPX];
#pragma unroll
      for (int j = 0; j < NPX; ++j) {
        // eval_row's op order; a pixel that has terminated evaluates
        // (ok false) and keeps its state
        const float dx = ul - pxl[j];
        const float dy = vl - pyl[j];
        const float s = -0.5f * (r0.z * dx * dx + r1.x * dy * dy) -
                        r0.w * dx * dy + r2.w;
        const float alpha = fminf(0.99f, expf(fminf(s, 2.0f)));
        const bool ok = !done[j] && s <= r2.w + 1e-4f && alpha >= ALPHA_MIN;
        const float test = T[j] * (1.0f - alpha);
        const bool term = ok && test < T_EPS;
        const float w = alpha * T[j];
        contrib[j] = ok && !term;
        o[j][0] = contrib[j] ? o[j][0] + w * r1.z : o[j][0];
        o[j][1] = contrib[j] ? o[j][1] + w * r1.w : o[j][1];
        o[j][2] = contrib[j] ? o[j][2] + w * r2.x : o[j][2];
        o[j][3] = contrib[j] ? o[j][3] + w * r2.y : o[j][3];
        o[j][4] = contrib[j] ? o[j][4] + w : o[j][4];
        T[j] = contrib[j] ? test : T[j];
        done[j] = done[j] || term;
      }
      if constexpr (COUNTS) {
        int n_c = 0;
#pragma unroll
        for (int j = 0; j < NPX; ++j)
          n_c += __popc(__ballot_sync(0xffffffffu, contrib[j]));
        my_cnt = lane == i ? n_c : my_cnt;
      } else {
        done_all = true;
#pragma unroll
        for (int j = 0; j < NPX; ++j) done_all = done_all && done[j];
      }
    }
    if (COUNTS && my_cnt != 0) atomicAdd(cnt_s + ch * KC + lane, my_cnt);
  }
}

}  // namespace
