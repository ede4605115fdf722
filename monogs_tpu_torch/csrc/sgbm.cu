// Semi-global block matching of a rectified uint8 pair:
// cv2.StereoSGBM_create(minDisparity=0, numDisparities=64, blockSize=20)
// with setUniquenessRatio(40) and OpenCV's defaults for the rest, followed
// by StereoSGBM::compute's 3x3 median. The algorithm and each of its
// integer conventions are set out in
// monogs_tpu_torch/data/stereo.py, whose sgbm_plain is the plain version;
// both give OpenCV's disparities bit for bit.
//
// Replaces the OpenCV call of monogs_tpu/data/datasets.py
// (StereoDataset.__getitem__); there is no TPU kernel behind it. The cost
// volume has H x (W - 64) x 64 cells (21.1 M at 752x480); each cell takes
// its pixel cost, two window sums, five path steps and a saturated sum,
// tens of integer operations, so the work is bounded by the card's
// integer rate, and the five paths are chains of dependent steps (688 at
// 752x480) whose latency no parallelism hides. Five launches a pair, each
// over many CTAs (no step of one waits for a barrier across the grid):
//
// 1. sgbm_cost_kernel: one CTA per band of 16 rows and 64 columns. The
//    pixel costs of each row are computed once per CTA (two image rows
//    prefiltered into shared memory a step) and the 21-row window sums
//    are running sums down the band: the entering row added, the leaving
//    one subtracted (the sums are exact integers; the 16-bit wrap of
//    OpenCV's buffers is taken once, at the store, which gives the same
//    bits since the wrap is arithmetic modulo 2^16). Then the 21-column
//    box and P2 into the cost volume C (int16). It also fills the right
//    image's match keys with "none".
// 2. sgbm_sweep_kernel: one warp per path: left-to-right and right-to-left
//    along each row, up along each column, up-left and up-right along
//    each diagonal (4 H + 3 (W - 64) - 2 warps, 3,982 at 752x480, within
//    one wave of the card's resident warps). A lane holds disparities
//    2 lane and 2 lane + 1 of the previous pixel in registers; a step
//    reads the pixel's 64 costs (128 B, loaded eight steps ahead), takes
//    the neighbours by two shuffles and the minimum by one reduction, and
//    stores the path's 64 values as int32 into its own plane (a path
//    value can leave the 16-bit range where OpenCV's costs wrap; only the
//    stored predecessors are 16-bit, as OpenCV's).
// 3. sgbm_select_kernel: one warp per pixel: S = sat16(sat16(Llr + v) +
//    Lrl) with v the integer sum of the three upper paths (OpenCV's
//    order of saturations), the first least S, the uniqueness test, the
//    parabola fit, and the right image's best match per column by
//    atomicMin of (S, x) keys.
// 4. sgbm_lr_kernel: the left-right check, per pixel.
// 5. median3_kernel: the 3x3 median with replicated borders.

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

// cost kernel: a CTA's output columns and rows, the window-sum columns it
// holds (its columns and R each side) and the prefiltered image columns
// those need (a window column x reads left x + D and right x + 1 .. x + D,
// each with its two neighbours)
constexpr int XC = 64;
constexpr int BAND = 16;
constexpr int NV = XC + 2 * R;
constexpr int NCOL = NV + D + 1;
constexpr int COST_THREADS = 256;
constexpr int SWEEP_THREADS = 128;
constexpr int SELECT_THREADS = 256;
constexpr int PF = 8;          // cost loads in flight a path

__device__ __forceinline__ int wrap16(int x) { return (int)(short)x; }
__device__ __forceinline__ int sat16(int x) {
  return min(max(x, -32768), 32767);
}

// Prefilter image rows ka and kb (kb < 0: none) over columns [c0, c0 +
// ncol) into slots 0 and 1: pre[s][img][ch][j] the clipped Sobel (ch 0)
// and raw intensity (ch 1), OpenCV's cap on the image's first and last
// columns; then lo/hi the min and max of (value, the means with each
// neighbour), a missing neighbour counting as the value itself.
struct Rows {
  uint8_t pre[2][2][2][NCOL];
  uint8_t lo[2][2][2][NCOL];
  uint8_t hi[2][2][2][NCOL];
};

__device__ void prefilter_rows(const uint8_t* __restrict__ left,
                               const uint8_t* __restrict__ right, int H,
                               int W, int c0, int ncol, int ka, int kb,
                               Rows& rows) {
  const int nslot = kb < 0 ? 1 : 2;
  __syncthreads();                               // the last rows are read
  for (int i = threadIdx.x; i < nslot * 2 * ncol; i += blockDim.x) {
    const int j = i % ncol, img = (i / ncol) & 1, s = i / (2 * ncol);
    const int x = c0 + j, k = s ? kb : ka;
    if (x >= W) continue;
    const uint8_t* I = img ? right : left;
    const int kn = k > 0 ? k - 1 : k, ks = k < H - 1 ? k + 1 : k;
    const uint8_t* r = I + (size_t)k * W;
    int sob = CAP, raw = CAP;
    if (x > 0 && x < W - 1) {
      const uint8_t* rn = I + (size_t)kn * W;
      const uint8_t* rs = I + (size_t)ks * W;
      const int g = (r[x + 1] - r[x - 1]) * 2 + rn[x + 1] - rn[x - 1] +
                    rs[x + 1] - rs[x - 1];
      sob = min(max(g, -CAP), CAP) + CAP;
      raw = r[x];
    }
    rows.pre[s][img][0][j] = (uint8_t)sob;
    rows.pre[s][img][1][j] = (uint8_t)raw;
  }
  __syncthreads();
  // columns c0 + 1 .. c0 + ncol - 2: the ones a cost reads (their
  // neighbours are held)
  for (int i = threadIdx.x; i < nslot * 4 * ncol; i += blockDim.x) {
    const int j = i % ncol, a = (i / ncol) & 3, s = i / (4 * ncol);
    const int x = c0 + j;
    if (j == 0 || j >= ncol - 1 || x >= W) continue;
    const uint8_t* v = rows.pre[s][a >> 1][a & 1];
    const int p = v[j];
    const int l = x > 0 ? (p + v[j - 1]) >> 1 : p;
    const int r = x < W - 1 ? (p + v[j + 1]) >> 1 : p;
    rows.lo[s][a >> 1][a & 1][j] = (uint8_t)min(min(l, r), p);
    rows.hi[s][a >> 1][a & 1][j] = (uint8_t)max(max(l, r), p);
  }
  __syncthreads();
}

// the Birchfield-Tomasi cost of left column x (local index jl) against
// right column x - d (local jr) in slot s
__device__ __forceinline__ int pixel_cost(const Rows& rows, int s, int jl,
                                          int jr) {
  int cost = 0;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const int u = rows.pre[s][0][ch][jl], u0 = rows.lo[s][0][ch][jl],
              u1 = rows.hi[s][0][ch][jl];
    const int v = rows.pre[s][1][ch][jr], v0 = rows.lo[s][1][ch][jr],
              v1 = rows.hi[s][1][ch][jr];
    const int c0 = max(max(0, u - v1), v0 - u);
    const int c1 = max(max(0, v - u1), u0 - v);
    cost += min(c0, c1) >> (ch ? 2 : 0);
  }
  return cost;
}

__global__ void __launch_bounds__(COST_THREADS)
sgbm_cost_kernel(const uint8_t* __restrict__ left,
                 const uint8_t* __restrict__ right, int H, int W,
                 short* __restrict__ C, unsigned* __restrict__ key2) {
  __shared__ Rows rows;
  __shared__ int V[NV * D];                      // window sums, [x][d]
  const int W1 = W - D;
  const int x0 = blockIdx.x * XC, y0 = blockIdx.y * BAND;
  const int y1 = min(y0 + BAND, H), x1 = min(x0 + XC, W1);
  const int v_lo = max(x0 - R, 0), v_hi = min(x1 + R, W1);
  const int nv = v_hi - v_lo;
  const int c0 = v_lo, ncol = nv + D + 1;        // image columns held
  {
    const size_t n = (size_t)H * W;
    const size_t stride = (size_t)gridDim.x * gridDim.y * blockDim.x;
    for (size_t i = ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                        blockDim.x + threadIdx.x;
         i < n; i += stride)
      key2[i] = NO_KEY;
  }
  for (int e = threadIdx.x; e < nv * D; e += blockDim.x) V[e] = 0;
  // V += pix(ka) + sign_b * pix(kb)
  auto accumulate = [&](int ka, int kb, int sign_b) {
    prefilter_rows(left, right, H, W, c0, ncol, ka, kb, rows);
    for (int e = threadIdx.x; e < nv * D; e += blockDim.x) {
      const int d = e & (D - 1), jx = e >> 6;
      const int jl = jx + D, jr = jx + D - d;    // local image columns
      int add = pixel_cost(rows, 0, jl, jr);
      if (kb >= 0) add += sign_b * pixel_cost(rows, 1, jl, jr);
      V[e] += add;
    }
  };
  // the window of row y0: rows y0 - R .. y0 + R, clamped
  for (int j = -R; j <= R; j += 2) {
    const int ka = min(max(y0 + j, 0), H - 1);
    const int kb = j + 1 <= R ? min(max(y0 + j + 1, 0), H - 1) : -1;
    accumulate(ka, kb, 1);
  }
  for (int y = y0; y < y1; ++y) {
    if (y > y0)
      accumulate(min(y + R, H - 1), max(y - 1 - R, 0), -1);
    __syncthreads();                             // V of row y complete
    short* Cy = C + (size_t)y * W1 * D;
    for (int e = threadIdx.x; e < (x1 - x0) * D; e += blockDim.x) {
      const int d = e & (D - 1), xi = x0 + (e >> 6);
      int s = P2;                                // OpenCV starts C at P2
#pragma unroll
      for (int dx = -R; dx <= R; ++dx)
        s += V[(min(max(xi + dx, 0), W1 - 1) - v_lo) * D + d];
      Cy[(size_t)xi * D + d] = (short)s;
    }
    // the next accumulate's barriers order these reads before its writes
  }
}

// A path's first cell, its stride in cells and its length, for warp g:
// rows left to right [0, H), rows right to left [H, 2H), columns top
// down [2H, 2H + W1), up-left diagonals (x - y fixed) and up-right ones
// (x + y fixed), H + W1 - 1 each.
__device__ __forceinline__ bool path_of(int g, int H, int W1, int& dir,
                                        long long& start, long long& stride,
                                        int& len) {
  const int nd = H + W1 - 1;
  if (g < H) {
    dir = 0; start = (long long)g * W1; stride = 1; len = W1;
  } else if (g < 2 * H) {
    dir = 1; start = (long long)(g - H) * W1 + W1 - 1; stride = -1;
    len = W1;
  } else if (g < 2 * H + W1) {
    dir = 2; start = g - 2 * H; stride = W1; len = H;
  } else if (g < 2 * H + W1 + nd) {
    const int k = g - 2 * H - W1 - (H - 1);      // x - y, in [1 - H, W1)
    const int ys = k < 0 ? -k : 0, xs = k < 0 ? 0 : k;
    dir = 3; start = (long long)ys * W1 + xs; stride = W1 + 1;
    len = min(H - ys, W1 - xs);
  } else if (g < 2 * H + W1 + 2 * nd) {
    const int k = g - 2 * H - W1 - nd;           // x + y, in [0, nd)
    const int ys = max(0, k - (W1 - 1)), xs = k - ys;
    dir = 4; start = (long long)ys * W1 + xs; stride = W1 - 1;
    len = min(H - ys, xs + 1);
  } else {
    return false;
  }
  return true;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
sgbm_sweep_kernel(const short* __restrict__ C, int* __restrict__ L, int H,
                  int W) {
  const int W1 = W - D, lane = threadIdx.x & 31;
  const int g = blockIdx.x * (SWEEP_THREADS / 32) + (threadIdx.x >> 5);
  int dir, len;
  long long start, stride;
  if (!path_of(g, H, W1, dir, start, stride, len)) return;
  // lane l holds disparities 2 l and 2 l + 1: a cell's 64 costs are 32
  // short2, its 64 path values 32 int2
  const short2* Cv = reinterpret_cast<const short2*>(C);
  int2* Lv = reinterpret_cast<int2*>(L) +
             (size_t)dir * H * W1 * (D / 2);
  auto cell = [&](int t) { return (size_t)(start + stride * t); };
  short2 buf[PF];
#pragma unroll
  for (int i = 0; i < PF; ++i)
    buf[i] = i < len ? Cv[cell(i) * (D / 2) + lane] : make_short2(0, 0);
  int p0 = 0, p1 = 0, pmin = 0;                  // zeros outside the image
  for (int t0 = 0; t0 < len; t0 += PF) {
#pragma unroll
    for (int i = 0; i < PF; ++i) {
      const int t = t0 + i;
      if (t >= len) break;
      const short2 c = buf[i];
      if (t + PF < len) buf[i] = Cv[cell(t + PF) * (D / 2) + lane];
      int lo0 = __shfl_up_sync(FULL, p1, 1);     // d - 1 of d = 2 lane
      int hi1 = __shfl_down_sync(FULL, p0, 1);   // d + 1 of d = 2 lane + 1
      if (lane == 0) lo0 = MAX_COST;
      if (lane == 31) hi1 = MAX_COST;
      const int delta = pmin + P2;
      const int l0 =
          c.x + min(min(p0, lo0 + P1), min(p1 + P1, delta)) - delta;
      const int l1 =
          c.y + min(min(p1, p0 + P1), min(hi1 + P1, delta)) - delta;
      Lv[cell(t) * (D / 2) + lane] = make_int2(l0, l1);
      pmin = wrap16(__reduce_min_sync(FULL, min(l0, l1)));
      p0 = wrap16(l0);
      p1 = wrap16(l1);
    }
  }
}

__global__ void __launch_bounds__(SELECT_THREADS)
sgbm_select_kernel(const int* __restrict__ L, unsigned* __restrict__ key2,
                   short* __restrict__ pre, int H, int W) {
  const int W1 = W - D, lane = threadIdx.x & 31;
  const long long cells = (long long)H * W1;
  const long long c = (long long)blockIdx.x * (SELECT_THREADS / 32) +
                      (threadIdx.x >> 5);
  if (c >= cells) return;
  const int y = (int)(c / W1), xi = (int)(c % W1);
  const int2* Lv = reinterpret_cast<const int2*>(L);
  const size_t plane = (size_t)cells * (D / 2), at = (size_t)c * (D / 2) + lane;
  const int2 lr = Lv[at], rl = Lv[plane + at], up = Lv[2 * plane + at],
             ul = Lv[3 * plane + at], ur = Lv[4 * plane + at];
  const int s0 = sat16(sat16(lr.x + (ul.x + up.x + ur.x)) + rl.x);
  const int s1 = sat16(sat16(lr.y + (ul.y + up.y + ur.y)) + rl.y);
  const int d0 = 2 * lane, d1 = d0 + 1;
  const int min_s = __reduce_min_sync(FULL, min(s0, s1));
  const int best = __reduce_min_sync(
      FULL, s0 == min_s ? d0 : (s1 == min_s ? d1 : 1 << 20));
  const bool rival =
      (s0 * (100 - UNIQ) < min_s * 100 && abs(best - d0) > 1) ||
      (s1 * (100 - UNIQ) < min_s * 100 && abs(best - d1) > 1);
  const bool unique = !__any_sync(FULL, rival);
  // S at best - 1 and best + 1 (clamped; used only inside the range)
  const int dm = max(best - 1, 0), dp = min(best + 1, D - 1);
  const int m0 = __shfl_sync(FULL, s0, dm >> 1);
  const int m1 = __shfl_sync(FULL, s1, dm >> 1);
  const int q0 = __shfl_sync(FULL, s0, dp >> 1);
  const int q1 = __shfl_sync(FULL, s1, dp >> 1);
  if (lane != 0) return;
  int disp = INVALID;
  if (unique) {
    atomicMin(&key2[(size_t)y * W + xi + D - best],
              ((unsigned)(min_s + 32768) << 13) | (unsigned)(8191 - xi));
    disp = best * SCALE;
    if (best > 0 && best < D - 1) {
      const int sm = dm & 1 ? m1 : m0, sp = dp & 1 ? q1 : q0;
      const int denom2 = max(sm + sp - 2 * min_s, 1);
      disp += ((sm - sp) * SCALE + denom2) / (denom2 * 2);
    }
  }
  pre[(size_t)y * W + xi + D] = (short)disp;
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

// in place on pre: columns below D invalid, the rest left-right checked
__global__ void sgbm_lr_kernel(const unsigned* __restrict__ key2,
                               short* __restrict__ pre, int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y;
  if (x >= W) return;
  const size_t at = (size_t)y * W + x;
  int d1 = x >= D ? pre[at] : INVALID;
  if (d1 != INVALID) {
    const unsigned* row = key2 + (size_t)y * W;
    const int lo = d1 >> SHIFT, hi = (d1 + SCALE - 1) >> SHIFT;
    if (lr_off(row, x, lo, W) && lr_off(row, x, hi, W)) d1 = INVALID;
  }
  pre[at] = (short)d1;
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

constexpr int ROW_THREADS = 128;

dim3 cost_grid(int H, int W) {
  return dim3((W - D + XC - 1) / XC, (H + BAND - 1) / BAND);
}
int sweep_ctas(int H, int W) {
  const int paths = 4 * H + 3 * (W - D) - 2;
  return (paths + SWEEP_THREADS / 32 - 1) / (SWEEP_THREADS / 32);
}
int select_ctas(int H, int W) {
  const long long cells = (long long)H * (W - D);
  return (int)((cells + SELECT_THREADS / 32 - 1) / (SELECT_THREADS / 32));
}
dim3 row_grid(int H, int W) {
  return dim3((W + ROW_THREADS - 1) / ROW_THREADS, H);
}

}  // namespace

extern "C" {

// CTAs of each of the five launches for an [H, W] pair, in order.
int sgbm_grids(int H, int W, int* ctas) {
  const dim3 c = cost_grid(H, W), r = row_grid(H, W);
  ctas[0] = (int)(c.x * c.y);
  ctas[1] = sweep_ctas(H, W);
  ctas[2] = select_ctas(H, W);
  ctas[3] = ctas[4] = (int)(r.x * r.y);
  return 0;
}

// left, right [H, W] uint8; C [H, W-64, 64] int16; L [5, H, W-64, 64]
// int32 (the five paths); key2 [H, W] uint32; pre and out [H, W] int16
// (pre: before the median). All contiguous on the device, W < 8192;
// launches the five kernels on ``stream`` and returns the first CUDA
// error, or 0. ``marks``: NULL, or six events recorded on ``stream``
// before the first launch and after each (the split of a call by launch).
int sgbm_run(const uint8_t* left, const uint8_t* right, short* C, int* L,
             unsigned* key2, short* pre, short* out, int H, int W,
             cudaStream_t stream, cudaEvent_t* marks) {
  cudaError_t err;
  auto mark = [&](int i) {
    return marks ? cudaEventRecord(marks[i], stream) : cudaSuccess;
  };
  if ((err = mark(0)) != cudaSuccess) return (int)err;
  sgbm_cost_kernel<<<cost_grid(H, W), COST_THREADS, 0, stream>>>(
      left, right, H, W, C, key2);
  if ((err = cudaGetLastError()) != cudaSuccess || (err = mark(1)))
    return (int)err;
  sgbm_sweep_kernel<<<sweep_ctas(H, W), SWEEP_THREADS, 0, stream>>>(C, L, H,
                                                                    W);
  if ((err = cudaGetLastError()) != cudaSuccess || (err = mark(2)))
    return (int)err;
  sgbm_select_kernel<<<select_ctas(H, W), SELECT_THREADS, 0, stream>>>(
      L, key2, pre, H, W);
  if ((err = cudaGetLastError()) != cudaSuccess || (err = mark(3)))
    return (int)err;
  sgbm_lr_kernel<<<row_grid(H, W), ROW_THREADS, 0, stream>>>(key2, pre, H,
                                                             W);
  if ((err = cudaGetLastError()) != cudaSuccess || (err = mark(4)))
    return (int)err;
  median3_kernel<<<row_grid(H, W), ROW_THREADS, 0, stream>>>(pre, out, H,
                                                             W);
  if ((err = cudaGetLastError()) != cudaSuccess || (err = mark(5)))
    return (int)err;
  return 0;
}

}  // extern "C"
