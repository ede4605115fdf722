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
// Design: one CTA per (macro, fine tile). The box test is uniform over the
// CTA, so the CTA tests each valid macro row once, in list order, and
// compacts the overlapping rows' indices with a block-wide exclusive scan
// (warp ballot and popcount, then the warps' totals), up to `cap` of them
// and no further; non-overlapping rows are never staged, and a tile wholly
// outside the image scans nothing. The masked walk ("pallas") keeps every
// overlapping row (cap = Km: no k_fine truncation, the TPU kernel's
// semantics); the compact backend keeps the first k_fine (cap = k_fine:
// the depth-nearest, as the XLA "sort" fine stage). The index's first
// entries stay in shared memory, the rest go to global scratch.
// Over the index:
//   - the forward runs the list forward's walk (fwd_walk,
//     blend_forward.cuh): two adjacent pixels a thread, four warps a 16 px
//     tile, each warp on its own cp.async buffers (a gathered row is four
//     16-byte copies) culling the rows that no pixel of its 16x4 box can
//     take; its outputs have the bits of a walk with one pixel a thread;
//   - the VJP runs the tensor-core reverse of the list VJP
//     (blend_common.cuh: forward_live, reverse_tile_tc; pixel slices of
//     256 for tiles over 16 px), its checkpoints of the first chunks in
//     shared memory and of later ones in global scratch, so that its
//     shared memory does not grow with the list and a 16 px tile's CTAs
//     fit three an SM.
// What the TPU needed for Mosaic does not come over: the candidate map and
// 256-row chunk skip of pallas_blend.py, and the one-hot [k_fine, Km] MXU
// compaction and its transposed scatter of pallas_compact.py.
//
// The TPU accumulated each macro block's cotangent across its fine tiles in
// grid order (output-block revisiting). Here the fine tiles are separate
// CTAs: each writes its n rows' cotangents compactly, row k of its index
// to slot k of its partial [cap][16], and for every valid macro row its
// slot or -1 into the slot map [Tm, ft, Km]; a second kernel adds, for
// each macro row, the slots of fine tiles 0 .. ft-1 in that order. No
// atomics: two launches on the same inputs give bit-identical ddata.
//
// Bound on the H100: FP32 operations, as the list kernels (blend_lists.cu):
// 26 per (row, pixel) pair walked and 13 more per contributing pair forward,
// about 34 more per contributing pair in reverse, plus 8 per (valid row,
// fine tile) for the box test and, in the VJP, 16 per (row, fine tile) that
// entered beyond a row's first for the sum over fine tiles; the bytes are
// each macro list read once and the outputs written once. The scan, the
// partials and the slot map are this design's cost, not the function's.
// The early exit bounds the uncapped walk by the pixels' opacity, not by
// Km; a warp (forward) or a CTA (VJP) stops once all its pixels have
// exited, and the VJP reverses only the chunks that some pixel walked into.
//
// Each C entry point launches on the caller's stream and returns
// cudaGetLastError() (0 on success); the caller allocates the scratch
// (macro_scratch_bytes).

#include <type_traits>

#include "blend_common.cuh"
#include "blend_forward.cuh"

namespace {

constexpr int RPT = 4;  // rows a thread tests per step of the scan
// index entries the forward keeps in shared memory
constexpr int FWD_IDX_SMEM = 1024;

// The VJP's index entries and checkpoint chunks in shared memory beside
// the tensor-core reverse's (72,704 bytes at 256 threads): with one pixel
// slice, what leaves three CTAs an SM (its registers allow three); with
// four (one CTA an SM by its registers) 1,024 rows of each.
__host__ __device__ constexpr int bwd_idx_smem(int nsl) {
  return nsl == 1 ? 256 : 1024;
}

__host__ __device__ constexpr int bwd_ck_chunks(int nsl) {
  return nsl == 1 ? 2 : 32;
}

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

// The indices of the first `cap` rows r < count of the macro list dm
// [km][F] whose box overlaps the fine tile at (x0, y0), in list order,
// into the row source's index (idx_s [ns] in shared memory, idx_g beyond);
// returns their number. Nothing is scanned when `scan` is false (no pixel
// of the tile lies in the image). With slot, every valid row r gets its
// position in the index or -1 there. wsum: [RPT][nw] ints of shared
// memory. The CTA's nt threads test RPT rows each per step, rows
// r0 + j nt + thread. Every thread of the CTA must call it; the index is
// visible to all of them on return.
__device__ __forceinline__ int build_row_index(
    const float* dm, int km, float count, float x0, float y0, int tile,
    int cap, bool scan, const IndexedRows& ix, int* wsum, int* slot) {
  const int nt = blockDim.x, p = threadIdx.x;
  const int lane = p & 31, warp = p >> 5, nw = nt >> 5;
  const float x1 = x0 + (float)(tile - 1), y1 = y0 + (float)(tile - 1);
  int base = 0, r0 = 0;
  for (; scan && r0 < km && (float)r0 < count && base < cap;
       r0 += RPT * nt) {
    unsigned b[RPT];
    bool hit[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = r0 + j * nt + p;
      hit[j] = false;
      if (r < km && (float)r < count) {
        const float* row = dm + (size_t)r * F;
        const float u = row[CU], v = row[CV], rad = row[RAD];
        hit[j] = (u + rad >= x0) && (u - rad <= x1) && (v + rad >= y0) &&
                 (v - rad <= y1);
      }
      b[j] = __ballot_sync(0xffffffffu, hit[j]);
      // every lane stores its warp's (identical) count, unguarded (see
      // tile_sums in blend_common.cuh)
      wsum[j * nw + warp] = __popc(b[j]);
    }
    __syncthreads();
    int before = base;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      int mine = before, total = 0;
      for (int w = 0; w < nw; ++w) {
        const int c = wsum[j * nw + w];
        mine += w < warp ? c : 0;
        total += c;
      }
      const int r = r0 + j * nt + p;
      const int pos = mine + __popc(b[j] & ((1u << lane) - 1u));
      const bool sel = hit[j] && pos < cap;
      if (sel) {
        if (pos < ix.ns)
          ix.idx_s[pos] = r;
        else
          ix.idx_g[pos - ix.ns] = r;
      }
      if (slot != nullptr && r < km && (float)r < count)
        slot[r] = sel ? pos : -1;
      before += total;
    }
    base = before;
    __syncthreads();
  }
  if (slot != nullptr)
    for (int r = r0 + p; r < km && (float)r < count; r += nt) slot[r] = -1;
  return min(base, cap);
}

// Shared memory: rows [nw][2][KC][F] | idx [FWD_IDX_SMEM] | wsum.
__global__ void macro_fwd_kernel(const float* __restrict__ data_m,
                                 const float* __restrict__ xy0,
                                 const float* __restrict__ counts,
                                 const float* __restrict__ pmat,
                                 float* __restrict__ outs, int* idx_g,
                                 int km, int cap, int tile, int ft_side,
                                 int width, int height) {
  extern __shared__ float smem[];
  constexpr int NPX = FWD_NPX;
  const int q = threadIdx.x, warp = q >> 5, nw = blockDim.x >> 5;
  const int np = tile * tile;
  float* wrows = smem + warp * 2 * KC * F;
  int* idx_s = reinterpret_cast<int*>(smem + nw * 2 * KC * F);
  int* wsum = idx_s + FWD_IDX_SMEM;
  const FineTile ft = fine_tile(xy0, tile, ft_side);
  const float* dm = data_m + (size_t)ft.m * km * F;
  bool in_image = false;
#pragma unroll
  for (int j = 0; j < NPX; ++j) {
    const int p = NPX * q + j;
    in_image = in_image ||
               (p < np && ft.x0 + pmat[3 * np + p] <= (float)(width - 1) &&
                ft.y0 + pmat[4 * np + p] <= (float)(height - 1));
  }
  const IndexedRows ix{
      dm, idx_s, idx_g + (size_t)blockIdx.x * max(cap - FWD_IDX_SMEM, 0),
      FWD_IDX_SMEM};
  const int n = build_row_index(dm, km, counts[ft.m], ft.x0, ft.y0, tile,
                                cap, __syncthreads_or(in_image), ix, wsum,
                                nullptr);
  float o[NPX][5];
  fwd_walk<false>(ix, q & 31, ft.x0, ft.y0, pmat, wrows, nullptr, n, np,
                  width, height, o);
#pragma unroll
  for (int j = 0; j < NPX; ++j) {
    const int p = NPX * q + j;
    if (p < np) store8(outs + ((size_t)blockIdx.x * np + p) * 8, o[j]);
  }
}

// The VJP's scratch, in this order (each part 256-byte aligned): part
// [n_cta][cap][F] floats (the compact partials), slot [n_cta][km] ints,
// ckg [n_cta][nch(cap) - L][nsl][nt] floats (checkpoints beyond shared
// memory), idx [n_cta][cap - bwd_idx_smem] ints (the index beyond it);
// the forward's holds idx [n_cta][cap - FWD_IDX_SMEM] alone.
struct Scratch {
  size_t slot, ckg, idx, total;  // byte offsets; part is at 0
};

__host__ __device__ constexpr size_t align256(size_t b) {
  return (b + 255) / 256 * 256;
}

Scratch scratch_layout(bool fwd, long long n_cta, int km, int cap, int p) {
  const int nt = slice_threads(p), nsl = p > SLICE ? MAX_SLICES : 1;
  const long long n_ckg =
      (long long)max(n_chunks(cap) - bwd_ck_chunks(nsl), 0) * nsl * nt;
  Scratch s{};
  if (fwd) {
    s.total = align256(n_cta * max(cap - FWD_IDX_SMEM, 0) * sizeof(int));
    return s;
  }
  const size_t idx =
      align256(n_cta * max(cap - bwd_idx_smem(nsl), 0) * sizeof(int));
  s.slot = align256(n_cta * cap * F * sizeof(float));
  s.ckg = s.slot + align256(n_cta * km * sizeof(int));
  s.idx = s.ckg + align256(n_cta * n_ckg * sizeof(float));
  s.total = s.idx + idx;
  return s;
}

// One CTA of nt = min(P, 256) threads per (macro, fine tile), NSL pixel
// slices. Shared memory: the tensor-core reverse's (rows | ck [L][NSL][nt]
// | A | gsh) | idx [bwd_idx_smem] | wsum. part: [n_cta][cap][F]; slot:
// [n_cta][km]; ckg: [n_cta][nch(cap) - L][NSL][nt]; idx_g: [n_cta][cap -
// bwd_idx_smem]. L = bwd_ck_chunks(NSL).
template <int NSL>
__global__ void __launch_bounds__(SLICE, NSL == 1 ? 3 : 1)
    macro_bwd_kernel(const float* __restrict__ data_m,
                     const float* __restrict__ xy0,
                     const float* __restrict__ counts,
                     const float* __restrict__ pmat,
                     const float* __restrict__ g_outs,
                     float* __restrict__ part, int* slot, float* ckg,
                     int* idx_g, int km, int cap, int tile, int ft_side,
                     int width, int height) {
  extern __shared__ float smem[];
  const int np = tile * tile, cta = blockIdx.x;
  const int nt = blockDim.x, lda = nt + 4;
  const int n_ck = bwd_ck_chunks(NSL), n_idx = bwd_idx_smem(NSL);
  float* rows = smem;
  float* ck_s = rows + KC * F;
  float* A = ck_s + n_ck * NSL * nt;
  float* gsh = A + TcSpec<false>::NA * KC * lda;
  int* idx_s = reinterpret_cast<int*>(gsh + nt * GCOL);
  int* wsum = idx_s + n_idx;
  const FineTile ft = fine_tile(xy0, tile, ft_side);
  const float* dm = data_m + (size_t)ft.m * km * F;
  const IndexedRows ix{dm, idx_s,
                       idx_g + (size_t)cta * max(cap - n_idx, 0), n_idx};
  const auto c = make_tile(cta, ft.x0, ft.y0, pmat, ix, width, height, np);
  const auto q = make_slices<NSL>(c, pmat, np, width, height);
  bool in_image = false;
#pragma unroll
  for (int s = 0; s < NSL; ++s) in_image = in_image || q.ok[s];
  const int n = build_row_index(dm, km, counts[ft.m], ft.x0, ft.y0, tile,
                                cap, __syncthreads_or(in_image), ix, wsum,
                                slot + (size_t)cta * km);
  const SplitCk ck{
      ck_s,
      ckg + (size_t)cta * max(n_chunks(cap) - n_ck, 0) * NSL * nt, n_ck};
  float o[NSL][5];
  int kend[NSL], n_live;
  forward_live(c, q, rows, ck, n, o, kend, n_live);
  float g[NSL][5];
#pragma unroll
  for (int s = 0; s < NSL; ++s) {
    const bool in = in_tile<NSL>(c, s, np);
    const float* go =
        g_outs + ((size_t)cta * np + (in ? s * nt + c.p : 0)) * 8;
#pragma unroll
    for (int j = 0; j < 5; ++j) g[s][j] = in ? go[j] : 0.f;
  }
  const float gd[NSL] = {};
  reverse_tile_tc<true, false>(c, q, rows, ck, A, gsh, lda, n, kend, n_live,
                               pmat, np, g, gd, part + (size_t)cta * cap * F,
                               nullptr);
}

// ddata[m][r] = the sum over f = 0 .. ft-1, in that order, of row r's
// cotangent in fine tile f's partial, where it entered (slot >= 0); 0 for
// a row beyond counts[m]. Four threads per row, 16 bytes each.
__global__ void sum_fine_tiles(const float* __restrict__ part,
                               const int* __restrict__ slot,
                               const float* __restrict__ counts,
                               float* __restrict__ ddata, int ft, int km,
                               int cap, long long n_quads) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_quads) return;
  const long long row = i >> 2;
  const int m = (int)(row / km), r = (int)(row - (long long)m * km);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if ((float)r < counts[m]) {
    for (int f = 0; f < ft; ++f) {
      const long long cta = (long long)m * ft + f;
      const int k = slot[cta * km + r];
      if (k >= 0) {
        const float4 v = reinterpret_cast<const float4*>(
            part + (cta * cap + k) * F)[i & 3];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
    }
  }
  reinterpret_cast<float4*>(ddata)[i] = s;
}

size_t fwd_macro_smem(int nt) {
  return (size_t)(nt / 32 * 2 * KC * F) * sizeof(float) +
         (FWD_IDX_SMEM + RPT * nt / 32) * sizeof(int);
}

size_t bwd_macro_smem(int nt, int nsl) {
  return (size_t)(KC * F + bwd_ck_chunks(nsl) * nsl * nt +
                  TcSpec<false>::NA * KC * (nt + 4) + nt * GCOL) *
             sizeof(float) +
         (bwd_idx_smem(nsl) + RPT * nt / 32) * sizeof(int);
}

// f(std::integral_constant<int, NSL>) with the pixel slices of a tile of p
// pixels (as blend_lists.cu).
template <typename Fn>
cudaError_t by_slices(int p, Fn f) {
  return p > SLICE ? f(std::integral_constant<int, MAX_SLICES>{})
                   : f(std::integral_constant<int, 1>{});
}

template <typename K>
cudaError_t kernel_attrs(K kernel, int nt, size_t smem, int* out) {
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

}  // namespace

extern "C" size_t macro_scratch_bytes(int fwd, int n_macro, int km, int cap,
                                      int p, int ft_side) {
  return scratch_layout(fwd != 0, (long long)n_macro * ft_side * ft_side,
                        km, cap, p)
      .total;
}

extern "C" int macro_fwd(const float* data_m, const float* xy0,
                         const float* counts, const float* pmat, float* outs,
                         void* scratch, int n_macro, int km, int cap, int p,
                         int tile, int ft_side, int width, int height,
                         void* stream) {
  const int n_cta = n_macro * ft_side * ft_side;
  if (n_cta == 0) return 0;
  const int nt = fwd_threads(p);
  const size_t smem = fwd_macro_smem(nt);
  const cudaError_t rc = launch_prepare(macro_fwd_kernel, smem);
  if (rc != cudaSuccess) return (int)rc;
  macro_fwd_kernel<<<n_cta, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      data_m, xy0, counts, pmat, outs, static_cast<int*>(scratch), km, cap,
      tile, ft_side, width, height);
  return (int)cudaGetLastError();
}

extern "C" int macro_bwd(const float* data_m, const float* xy0,
                         const float* counts, const float* pmat,
                         const float* g_outs, void* scratch, float* ddata,
                         int n_macro, int km, int cap, int p, int tile,
                         int ft_side, int width, int height, void* stream) {
  const int ft = ft_side * ft_side;
  const int n_cta = n_macro * ft;
  if (n_cta == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch l = scratch_layout(false, n_cta, km, cap, p);
  char* base = static_cast<char*>(scratch);
  float* part = reinterpret_cast<float*>(base);
  int* slot = reinterpret_cast<int*>(base + l.slot);
  const int nt = slice_threads(p);
  cudaError_t rc = by_slices(p, [&](auto ns) {
    constexpr int NSL = decltype(ns)::value;
    const size_t smem = bwd_macro_smem(nt, NSL);
    const cudaError_t r = launch_prepare(macro_bwd_kernel<NSL>, smem);
    if (r != cudaSuccess) return r;
    macro_bwd_kernel<NSL><<<n_cta, nt, smem, s>>>(
        data_m, xy0, counts, pmat, g_outs, part, slot,
        reinterpret_cast<float*>(base + l.ckg),
        reinterpret_cast<int*>(base + l.idx), km, cap, tile, ft_side, width,
        height);
    return cudaGetLastError();
  });
  if (rc != cudaSuccess) return (int)rc;
  const long long n_quads = (long long)n_macro * km * 4;
  const int threads = 256;
  sum_fine_tiles<<<(unsigned)((n_quads + threads - 1) / threads), threads, 0,
                   s>>>(part, slot, counts, ddata, ft, km, cap, n_quads);
  return (int)cudaGetLastError();
}

// Registers per thread, shared memory per CTA (bytes) and resident CTAs
// per SM of macro_fwd_kernel and of macro_bwd_kernel at P = p, into out
// [2][3]. Neither depends on the list's length.
extern "C" int macro_attrs(int p, int* out) {
  const int nt = slice_threads(p);
  const cudaError_t rc = kernel_attrs(macro_fwd_kernel, fwd_threads(p),
                                      fwd_macro_smem(fwd_threads(p)), out);
  if (rc != cudaSuccess) return (int)rc;
  return (int)by_slices(p, [&](auto ns) {
    constexpr int NSL = decltype(ns)::value;
    return kernel_attrs(macro_bwd_kernel<NSL>, nt, bwd_macro_smem(nt, NSL),
                        out + 3);
  });
}
