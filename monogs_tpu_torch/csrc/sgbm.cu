// Semi-global block matching of a rectified uint8 pair:
// cv2.StereoSGBM_create(minDisparity=0, numDisparities=64, blockSize=20)
// with setUniquenessRatio(40) and OpenCV's defaults for the rest, followed
// by StereoSGBM::compute's 3x3 median. The algorithm and each of its
// integer conventions are set out in
// monogs_tpu_torch/data/stereo.py, whose sgbm_plain is the plain version;
// both give OpenCV's disparities bit for bit.
//
// Replaces the OpenCV call of monogs_tpu/data/datasets.py
// (StereoDataset.__getitem__); there is no TPU kernel behind it. Bound by
// memory: the cost volume (H x (W - 64) x 64 16-bit costs, 23.1 M cells
// at 752x480) is written once and read once, and the two horizontal path
// sums beside it. Three launches a pair, written to be right first:
//
// 1. sgbm_cost_kernel: one CTA per row. The pixel costs of the 21 window
//    rows are summed per (x, d) in shared memory (16-bit: at most 21 x 93),
//    then along x into the row's cost volume C (written to device memory,
//    stored as OpenCV stores it: P2 added and wrapped to 16 bits). Two
//    warps then run the row's left-to-right and right-to-left paths (one
//    pixel a step, two disparities a lane, the minimum over d by
//    __reduce_min_sync) and store their values as 32-bit integers.
// 2. sgbm_select_kernel: one CTA of 1024 threads walks the rows in order,
//    since the up-left, up and up-right paths of a row start from the row
//    above. A warp takes one pixel at a time: the three paths (the row
//    above kept in a 16-bit device scratch of two rows), the saturated sum
//    S, the first least S, the uniqueness test, the right image's best
//    match per column (atomicMin of (S, x) keys in shared memory), the
//    parabola fit; after a barrier the row's left-right check.
// 3. median3_kernel: the 3x3 median with replicated borders.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int D = 64;          // numDisparities
constexpr int R = 10;          // blockSize / 2
constexpr int P1 = 2, P2 = 5;
constexpr int CAP = 15;        // max(preFilterCap, 15) | 1
constexpr int UNIQ = 40;
constexpr int DISP12 = 1;
constexpr int SHIFT = 4, SCALE = 1 << SHIFT, INVALID = -SCALE;
constexpr int MAX_COST = 32767;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_KEY = 0xffffffffu;
constexpr int COST_THREADS = 256;
constexpr int SELECT_THREADS = 1024;

__device__ __forceinline__ int wrap16(int x) { return (int)(short)x; }
__device__ __forceinline__ int sat16(int x) {
  return min(max(x, -32768), 32767);
}

// one path step for two disparities (d = lane, lane + 32) of a pixel, from
// the previous pixel's stored values p*, its neighbours lo*/hi* (d - 1,
// d + 1; MAX_COST beyond the range) and its stored minimum
__device__ __forceinline__ void path_step(int c0, int c1, int p0, int p1,
                                          int lo0, int lo1, int hi0,
                                          int hi1, int pmin, int& l0,
                                          int& l1) {
  const int delta = pmin + P2;
  l0 = c0 + min(min(p0, lo0 + P1), min(hi0 + P1, delta)) - delta;
  l1 = c1 + min(min(p1, lo1 + P1), min(hi1 + P1, delta)) - delta;
}

// rows: 12 arrays of W bytes: (image, channel) a = img * 2 + ch, each as
// value, min and max of (value, means with the neighbours)
__device__ void prefilter_row(const uint8_t* left, const uint8_t* right,
                              int H, int W, int k, uint8_t* rows) {
  const int kn = k > 0 ? k - 1 : k, ks = k < H - 1 ? k + 1 : k;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    for (int img = 0; img < 2; ++img) {
      const uint8_t* I = img ? right : left;
      const uint8_t* r = I + (size_t)k * W;
      const uint8_t* rn = I + (size_t)kn * W;
      const uint8_t* rs = I + (size_t)ks * W;
      int sob = CAP, raw = CAP;
      if (x > 0 && x < W - 1) {
        const int g = (r[x + 1] - r[x - 1]) * 2 + rn[x + 1] - rn[x - 1] +
                      rs[x + 1] - rs[x - 1];
        sob = min(max(g, -CAP), CAP) + CAP;
        raw = r[x];
      }
      rows[(img * 2 + 0) * 3 * W + x] = (uint8_t)sob;
      rows[(img * 2 + 1) * 3 * W + x] = (uint8_t)raw;
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    for (int a = 0; a < 4; ++a) {
      uint8_t* v = rows + a * 3 * W;
      const int p = v[x];
      const int l = x > 0 ? (p + v[x - 1]) >> 1 : p;
      const int r = x < W - 1 ? (p + v[x + 1]) >> 1 : p;
      v[W + x] = (uint8_t)min(min(l, r), p);
      v[2 * W + x] = (uint8_t)max(max(l, r), p);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(COST_THREADS)
sgbm_cost_kernel(const uint8_t* __restrict__ left,
                 const uint8_t* __restrict__ right, int H, int W,
                 short* __restrict__ C, int* __restrict__ Llr,
                 int* __restrict__ Lrl) {
  extern __shared__ unsigned char smem[];
  const int W1 = W - D, n = W1 * D, y = blockIdx.x;
  short* V = (short*)smem;                       // [W1][D] window sums
  uint8_t* rows = (uint8_t*)(V + n);             // 12 x W
  for (int j = -R; j <= R; ++j) {
    const int k = min(max(y + j, 0), H - 1);
    __syncthreads();                             // rows free again
    prefilter_row(left, right, H, W, k, rows);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int x = e / D + D, x2 = x - e % D;
      int cost = 0;
      for (int ch = 0; ch < 2; ++ch) {
        const uint8_t* Lv = rows + ch * 3 * W;
        const uint8_t* Rv = rows + (2 + ch) * 3 * W;
        const int u = Lv[x], u0 = Lv[W + x], u1 = Lv[2 * W + x];
        const int v = Rv[x2], v0 = Rv[W + x2], v1 = Rv[2 * W + x2];
        const int c0 = max(max(0, u - v1), v0 - u);
        const int c1 = max(max(0, v - u1), u0 - v);
        cost += min(c0, c1) >> (ch ? 2 : 0);
      }
      V[e] = (short)(j == -R ? cost : V[e] + cost);
    }
  }
  __syncthreads();
  short* Cy = C + (size_t)y * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int xi = e / D, d = e % D;
    int s = P2;                                  // OpenCV starts C at P2
    for (int dx = -R; dx <= R; ++dx)
      s += V[min(max(xi + dx, 0), W1 - 1) * D + d];
    Cy[e] = (short)s;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= 2) return;
  int* out = (warp == 0 ? Llr : Lrl) + (size_t)y * n;
  int p0 = 0, p1 = 0, pmin = 0;                  // zeros outside the row
  for (int t = 0; t < W1; ++t) {
    const int xi = warp == 0 ? t : W1 - 1 - t;
    int lo0 = __shfl_up_sync(FULL, p0, 1), lo1 = __shfl_up_sync(FULL, p1, 1);
    int hi0 = __shfl_down_sync(FULL, p0, 1), hi1 = __shfl_down_sync(FULL, p1, 1);
    const int p0_31 = __shfl_sync(FULL, p0, 31), p1_0 = __shfl_sync(FULL, p1, 0);
    if (lane == 0) { lo0 = MAX_COST; lo1 = p0_31; }
    if (lane == 31) { hi0 = p1_0; hi1 = MAX_COST; }
    int l0, l1;
    path_step(Cy[xi * D + lane], Cy[xi * D + lane + 32], p0, p1, lo0, lo1,
              hi0, hi1, pmin, l0, l1);
    out[xi * D + lane] = l0;
    out[xi * D + lane + 32] = l1;
    pmin = wrap16(__reduce_min_sync(FULL, min(l0, l1)));
    p0 = wrap16(l0);
    p1 = wrap16(l1);
  }
}

// the right image's disparity at column xx from its (S, x) key, or INVALID
__device__ __forceinline__ int disp2_at(const unsigned* key2, int xx) {
  const unsigned key = key2[xx];
  if (key == NO_KEY) return INVALID;
  const int xw = 8191 - (int)(key & 8191u);
  return xw + D - xx;
}

__device__ __forceinline__ bool lr_off(const unsigned* key2, int x, int dd,
                                       int W) {
  const int xx = x - dd;
  if (xx < 0 || xx >= W) return false;
  const int d2 = disp2_at(key2, xx);
  return d2 >= 0 && abs(d2 - dd) > DISP12;
}

__global__ void __launch_bounds__(SELECT_THREADS)
sgbm_select_kernel(const short* __restrict__ C, const int* __restrict__ Llr,
                   const int* __restrict__ Lrl, short* Lbuf, short* Mbuf,
                   short* __restrict__ disp, int H, int W) {
  extern __shared__ unsigned char smem[];
  const int W1 = W - D, n = W1 * D;
  unsigned* key2 = (unsigned*)smem;              // [W]
  int* d1row = (int*)(key2 + W);                 // [W1]
  int* Sw = d1row + W1;                          // [warps][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  // Lbuf [2][3][W1][D], Mbuf [2][3][W1]: slot 1 is the row above row 0
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) Lbuf[3 * n + i] = 0;
  for (int i = threadIdx.x; i < 3 * W1; i += blockDim.x) Mbuf[3 * W1 + i] = 0;
  int* sw = Sw + warp * D;
  for (int y = 0; y < H; ++y) {
    const int cur = y & 1, prv = cur ^ 1;
    for (int i = threadIdx.x; i < W; i += blockDim.x) key2[i] = NO_KEY;
    __syncthreads();                             // the row above is stored
    for (int xi = warp; xi < W1; xi += nwarps) {
      const size_t base = (size_t)y * n + xi * D;
      const int c0 = C[base + lane], c1 = C[base + lane + 32];
      int v0 = 0, v1 = 0;
      for (int dir = 0; dir < 3; ++dir) {        // up-left, up, up-right
        const int xp = xi + dir - 1;
        int p0 = 0, p1 = 0, lo0 = 0, lo1 = 0, hi0 = 0, hi1 = 0, pm = 0;
        if (xp >= 0 && xp < W1) {
          const short* P = Lbuf + ((size_t)prv * 3 + dir) * n + xp * D;
          p0 = P[lane];
          p1 = P[lane + 32];
          lo0 = P[lane > 0 ? lane - 1 : 0];
          lo1 = P[lane + 31];
          hi0 = P[lane + 1];
          hi1 = P[lane < 31 ? lane + 33 : 63];
          pm = Mbuf[(prv * 3 + dir) * W1 + xp];
        }
        if (lane == 0) lo0 = MAX_COST;
        if (lane == 31) hi1 = MAX_COST;
        int l0, l1;
        path_step(c0, c1, p0, p1, lo0, lo1, hi0, hi1, pm, l0, l1);
        short* Q = Lbuf + ((size_t)cur * 3 + dir) * n + xi * D;
        Q[lane] = (short)l0;
        Q[lane + 32] = (short)l1;
        const int m = __reduce_min_sync(FULL, min(l0, l1));
        if (lane == 0) Mbuf[(cur * 3 + dir) * W1 + xi] = (short)m;
        v0 += l0;
        v1 += l1;
      }
      const int s0 = sat16(sat16(Llr[base + lane] + v0) + Lrl[base + lane]);
      const int s1 =
          sat16(sat16(Llr[base + lane + 32] + v1) + Lrl[base + lane + 32]);
      const int min_s = __reduce_min_sync(FULL, min(s0, s1));
      const int best = __reduce_min_sync(
          FULL, s0 == min_s ? lane : (s1 == min_s ? lane + 32 : 1 << 20));
      const bool rival =
          (s0 * (100 - UNIQ) < min_s * 100 && abs(best - lane) > 1) ||
          (s1 * (100 - UNIQ) < min_s * 100 && abs(best - lane - 32) > 1);
      const bool unique = !__any_sync(FULL, rival);
      sw[lane] = s0;
      sw[lane + 32] = s1;
      __syncwarp();
      if (lane == 0) {
        int d1 = INVALID;
        if (unique) {
          atomicMin(&key2[xi + D - best],
                    ((unsigned)(min_s + 32768) << 13) | (unsigned)(8191 - xi));
          d1 = best * SCALE;
          if (best > 0 && best < D - 1) {
            const int sm = sw[best - 1], sp = sw[best + 1];
            const int denom2 = max(sm + sp - 2 * min_s, 1);
            d1 += ((sm - sp) * SCALE + denom2) / (denom2 * 2);
          }
        }
        d1row[xi] = d1;
      }
      __syncwarp();
    }
    __syncthreads();                             // the row's matches are in
    short* out = disp + (size_t)y * W;
    for (int x = threadIdx.x; x < W; x += blockDim.x) {
      int d1 = x >= D ? d1row[x - D] : INVALID;
      if (d1 != INVALID) {
        const int lo = d1 >> SHIFT, hi = (d1 + SCALE - 1) >> SHIFT;
        if (lr_off(key2, x, lo, W) && lr_off(key2, x, hi, W)) d1 = INVALID;
      }
      out[x] = (short)d1;
    }
    __syncthreads();                             // key2 read before reset
  }
}

__global__ void median3_kernel(const short* __restrict__ in,
                               short* __restrict__ out, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y;
  if (x >= W) return;
  int v[9], k = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    const int yy = min(max(y + dy, 0), H - 1);
    for (int dx = -1; dx <= 1; ++dx)
      v[k++] = in[(size_t)yy * W + min(max(x + dx, 0), W - 1)];
  }
  for (int i = 1; i < 9; ++i)                    // insertion sort of nine
    for (int j = i; j > 0 && v[j - 1] > v[j]; --j) {
      const int t = v[j];
      v[j] = v[j - 1];
      v[j - 1] = t;
    }
  out[(size_t)y * W + x] = (short)v[4];
}

size_t cost_smem(int W) { return (size_t)(W - D) * D * 2 + 12 * (size_t)W; }
size_t select_smem(int W) {
  return (size_t)W * 4 + (size_t)(W - D) * 4 + (SELECT_THREADS / 32) * D * 4;
}

}  // namespace

extern "C" {

// Shared memory of the cost kernel, for the wrapper's width check.
size_t sgbm_cost_smem(int W) { return cost_smem(W); }

// left, right [H, W] uint8; C [H, W-64, 64] int16; Llr, Lrl [H, W-64, 64]
// int32; Lbuf [2, 3, W-64, 64] int16; Mbuf [2, 3, W-64] int16; pre and
// out [H, W] int16 (pre: before the median). All contiguous on the device;
// launches the three kernels on ``stream``.
int sgbm_run(const uint8_t* left, const uint8_t* right, short* C, int* Llr,
             int* Lrl, short* Lbuf, short* Mbuf, short* pre, short* out,
             int H, int W, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sgbm_cost_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cost_smem(W));
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sgbm_select_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)select_smem(W));
  if (err != cudaSuccess) return (int)err;
  sgbm_cost_kernel<<<H, COST_THREADS, cost_smem(W), stream>>>(
      left, right, H, W, C, Llr, Lrl);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sgbm_select_kernel<<<1, SELECT_THREADS, select_smem(W), stream>>>(
      C, Llr, Lrl, Lbuf, Mbuf, pre, H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  median3_kernel<<<dim3((W + 127) / 128, H), 128, 0, stream>>>(pre, out, H,
                                                                W);
  return (int)cudaGetLastError();
}

}  // extern "C"
