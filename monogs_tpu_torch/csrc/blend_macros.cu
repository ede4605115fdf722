// Hand-written Hopper (sm_90a) kernels for the macro-list blend: the
// render backends "pallas" and "pallas_compact" (render/blend_macros.py).
//
// Counterparts of the four Pallas TPU kernels of the render without frozen
// lists (monogs_tpu/render/renderer.py:521-571):
//   macro_fwd, cap Km     <- pallas_blend.py::_fwd_kernel (blend_macros_pallas)
//   macro_bwd, cap Km     <- pallas_blend.py::_bwd_kernel (its VJP)
//   macro_fwd, cap k_fine <- pallas_compact.py::_fwd_kernel
//                            (blend_macros_compact)
//   macro_bwd, cap k_fine <- pallas_compact.py::_bwd_kernel (its VJP)
//
// Input contract (the TPU kernels'): data_m [Tm, Km, 16] depth-ordered
// packed rows per macro tile, xy0 [Tm, 2] macro origins, counts [Tm] the
// number of valid leading rows of each macro list (float), pmat [6, P] the
// tile-local pixel basis. Fine tile f of macro m has its origin at
// xy0[m] + tile * (f % ft_side, f / ft_side). A row enters fine tile f's
// blend when row < counts[m] and its 3-sigma box (u +- rad, v +- rad)
// overlaps the tile. Outputs [Tm, ft, P, 8] hold (r, g, b, depth, acc, 0, 0,
// 0); the VJPs map output cotangents [Tm, ft, P, 8] to ddata [Tm, Km, 16].
//
// Design: one CTA per (macro, fine tile), one thread per pixel. The box
// test is uniform over the CTA, so the CTA tests each macro row once, in
// list order, and compacts the overlapping rows' indices into shared memory
// with a block-wide exclusive scan (warp ballot and popcount, then the
// warps' totals); non-overlapping rows are never staged. The masked walk
// ("pallas") keeps every overlapping row (cap = Km: no k_fine truncation,
// the TPU kernel's semantics); the compact backend keeps the first k_fine
// (cap = k_fine: the depth-nearest, as the XLA "sort" fine stage). The
// CTA then runs the list machinery of blend_common.cuh over those rows:
// the forward walk with its exact per-pixel early exit, or the
// checkpointed forward and the reverse blend. What the TPU needed for
// Mosaic does not come over: the candidate map and 256-row chunk skip of
// pallas_blend.py, and the one-hot [k_fine, Km] MXU compaction and its
// transposed scatter of pallas_compact.py.
//
// The TPU accumulated each macro block's cotangent across its fine tiles in
// grid order (output-block revisiting). Here the fine tiles are separate
// CTAs: each writes its rows' cotangents into its own partial
// [Tm, ft, Km, 16] (zeros for the rows it did not blend; a row appears at
// most once per fine tile, so no two threads write one row), and a second
// kernel sums the partials over ft in a fixed order. No float atomics: two
// launches on the same inputs give bit-identical ddata.
//
// Bound on the H100: FP32 operations, as the list kernels (blend_lists.cu):
// 26 per (row, pixel) pair walked and 13 more per contributing pair forward,
// about 34 more per contributing pair in reverse, plus 8 per (valid row,
// fine tile) for the box test and, in the VJP, 16 per (row, fine tile) that
// entered beyond a row's first for the sum over fine tiles; the bytes are
// each macro list read once and the outputs written once. The scan and the
// partials are this design's cost, not the function's. The early
// exit bounds the uncapped walk by the pixels' opacity, not by Km, and a
// CTA stops once all its pixels have exited.
//
// Each C entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success); a list whose index and
// checkpoints do not fit in a CTA's shared memory is refused with the
// opt-in's error.

#include "blend_common.cuh"

namespace {

constexpr int MAX_WARPS = 32;

// Fine tile f = blockIdx.x % ft of macro m = blockIdx.x / ft.
struct FineTile {
  int m, f;
  float x0, y0;
};

__device__ __forceinline__ FineTile fine_tile(const float* xy0, int tile,
                                              int ft_side) {
  FineTile t;
  const int ft = ft_side * ft_side;
  t.m = blockIdx.x / ft;
  t.f = blockIdx.x % ft;
  t.x0 = xy0[2 * t.m] + (float)(t.f % ft_side) * (float)tile;
  t.y0 = xy0[2 * t.m + 1] + (float)(t.f / ft_side) * (float)tile;
  return t;
}

// Indices of the first `cap` rows r < count of the macro list dm [km][F]
// whose box overlaps the fine tile at (x0, y0), in list order, into
// ridx[cap] (shared memory); returns their number. With zero_dd, the rows
// not selected get zero cotangent rows there. wsum: [MAX_WARPS] ints of
// shared memory. Every thread of the CTA must call it.
__device__ __forceinline__ int build_row_index(const float* dm, int km,
                                               float count, float x0,
                                               float y0, int tile, int cap,
                                               int* ridx, int* wsum,
                                               float* zero_dd) {
  const int P = blockDim.x, p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5, nw = P >> 5;
  const float x1 = x0 + (float)(tile - 1), y1 = y0 + (float)(tile - 1);
  int base = 0;
  for (int r0 = 0; r0 < km; r0 += P) {
    const int r = r0 + p;
    bool hit = false;
    if (r < km && (float)r < count) {
      const float* row = dm + (size_t)r * F;
      const float u = row[CU], v = row[CV], rad = row[RAD];
      hit = (u + rad >= x0) && (u - rad <= x1) && (v + rad >= y0) &&
            (v - rad <= y1);
    }
    const unsigned b = __ballot_sync(0xffffffffu, hit);
    // every lane stores its warp's (identical) count, unguarded (see
    // tile_sums in blend_common.cuh)
    wsum[warp] = __popc(b);
    __syncthreads();
    int before = base, total = 0;
    for (int w = 0; w < nw; ++w) {
      before += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
    const int pos = before + __popc(b & ((1u << lane) - 1u));
    const bool sel = hit && pos < cap;
    if (sel) ridx[pos] = r;
    if (zero_dd != nullptr && r < km && !sel)
      zero_row(zero_dd + (size_t)r * F);
    base += total;
    __syncthreads();
  }
  return min(base, cap);
}

// Shared memory: ridx [cap] | wsum [MAX_WARPS] | rows [KC][F].
__global__ void macro_fwd_kernel(const float* __restrict__ data_m,
                                 const float* __restrict__ xy0,
                                 const float* __restrict__ counts,
                                 const float* __restrict__ pmat,
                                 float* __restrict__ outs, int km, int cap,
                                 int tile, int ft_side, int width,
                                 int height) {
  extern __shared__ int smem_i[];
  int* ridx = smem_i;
  int* wsum = ridx + cap;
  float* rows = reinterpret_cast<float*>(wsum + MAX_WARPS);
  const FineTile ft = fine_tile(xy0, tile, ft_side);
  const float* dm = data_m + (size_t)ft.m * km * F;
  const int n = build_row_index(dm, km, counts[ft.m], ft.x0, ft.y0, tile,
                                cap, ridx, wsum, nullptr);
  const auto c = make_tile(blockIdx.x, ft.x0, ft.y0, pmat,
                           IndexedRows{dm, ridx}, width, height);
  float o[5];
  forward_walk(c, rows, n, o);
  store8(outs + ((size_t)blockIdx.x * c.P + c.p) * 8, o);
}

// Shared memory: ridx [cap] | wsum [MAX_WARPS] | the reverse machinery's
// (reverse_smem). partial: [Tm * ft][km][F].
__global__ void macro_bwd_kernel(const float* __restrict__ data_m,
                                 const float* __restrict__ xy0,
                                 const float* __restrict__ counts,
                                 const float* __restrict__ pmat,
                                 const float* __restrict__ g_outs,
                                 float* __restrict__ partial, int km, int cap,
                                 int tile, int ft_side, int width,
                                 int height) {
  extern __shared__ int smem_i[];
  int* ridx = smem_i;
  int* wsum = ridx + cap;
  float* rows = reinterpret_cast<float*>(wsum + MAX_WARPS);
  float* ck = rows + KC * F;
  float* tex = ck + n_chunks(cap) * blockDim.x;
  float* red = tex + KC * blockDim.x;
  const FineTile ft = fine_tile(xy0, tile, ft_side);
  const float* dm = data_m + (size_t)ft.m * km * F;
  float* dd_t = partial + (size_t)blockIdx.x * km * F;
  const int n = build_row_index(dm, km, counts[ft.m], ft.x0, ft.y0, tile,
                                cap, ridx, wsum, dd_t);
  const auto c = make_tile(blockIdx.x, ft.x0, ft.y0, pmat,
                           IndexedRows{dm, ridx}, width, height);
  float o[5];
  int n_live;
  const int kend = forward_checkpointed(c, rows, ck, n, o, n_live);
  const float* go = g_outs + ((size_t)blockIdx.x * c.P + c.p) * 8;
  const float g[5] = {go[0], go[1], go[2], go[3], go[4]};
  reverse_blend<true, false>(c, rows, ck, tex, red, n, kend, n_live, g, 0.f,
                             dd_t, nullptr);
}

// ddata[m][j] = sum over f = 0 .. ft-1, in that order, of partial[m][f][j]
// (j over the km * F values of a macro list).
__global__ void sum_fine_tiles(const float* __restrict__ partial,
                               float* __restrict__ ddata, int ft,
                               long long per_macro, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long m = i / per_macro, j = i - m * per_macro;
  const float* src = partial + m * ft * per_macro + j;
  float s = 0.f;
  for (int f = 0; f < ft; ++f) s += src[f * per_macro];
  ddata[i] = s;
}

size_t index_smem(int cap) {
  return (size_t)(cap + MAX_WARPS) * sizeof(int);
}

}  // namespace

extern "C" int macro_fwd(const float* data_m, const float* xy0,
                         const float* counts, const float* pmat, float* outs,
                         int n_macro, int km, int cap, int p, int tile,
                         int ft_side, int width, int height, void* stream) {
  const int n_cta = n_macro * ft_side * ft_side;
  if (n_cta == 0) return 0;
  const size_t smem = index_smem(cap) + KC * F * sizeof(float);
  const cudaError_t rc = launch_prepare(macro_fwd_kernel, smem);
  if (rc != cudaSuccess) return (int)rc;
  macro_fwd_kernel<<<n_cta, p, smem, static_cast<cudaStream_t>(stream)>>>(
      data_m, xy0, counts, pmat, outs, km, cap, tile, ft_side, width, height);
  return (int)cudaGetLastError();
}

extern "C" int macro_bwd(const float* data_m, const float* xy0,
                         const float* counts, const float* pmat,
                         const float* g_outs, float* partial, float* ddata,
                         int n_macro, int km, int cap, int p, int tile,
                         int ft_side, int width, int height, void* stream) {
  const int ft = ft_side * ft_side;
  const int n_cta = n_macro * ft;
  if (n_cta == 0) return 0;
  const size_t smem =
      index_smem(cap) + reverse_smem(cap, p, RevSpec<true, false>::NV);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = launch_prepare(macro_bwd_kernel, smem);
  if (rc != cudaSuccess) return (int)rc;
  macro_bwd_kernel<<<n_cta, p, smem, s>>>(data_m, xy0, counts, pmat, g_outs,
                                          partial, km, cap, tile, ft_side,
                                          width, height);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const long long per_macro = (long long)km * F;
  const long long total = (long long)n_macro * per_macro;
  const int threads = 256;
  sum_fine_tiles<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                   s>>>(partial, ddata, ft, per_macro, total);
  return (int)cudaGetLastError();
}
