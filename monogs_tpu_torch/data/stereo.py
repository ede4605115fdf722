"""Semi-global block matching for the EuRoC loader: the CUDA kernel
(``csrc/sgbm.cu``) beside its plain PyTorch version.

It reproduces ``cv2.StereoSGBM_create(minDisparity=0, numDisparities=64,
blockSize=20)`` with ``setUniquenessRatio(40)``, the call of
``monogs_tpu/data/datasets.py::StereoDataset.__getitem__``, with OpenCV's
defaults for what that call leaves at 0: a prefilter cap of 15 (``max(cap,
15) | 1``), P1 = 2 and P2 = 5, ``disp12MaxDiff`` 1, the one-pass
``MODE_SGBM`` path set (left to right, right to left and the three from the
row above: up-left, up, up-right), the parabola fit to 1/16 px, ``(minD - 1)
* 16`` for an invalid pixel and the 3x3 median filter that
``StereoSGBM::compute`` runs on the result. The costs are integers, stored
as OpenCV stores them (16-bit, the cost volume wrapping and the path sums
saturating where OpenCV's do), so the kernel, its plain version and
OpenCV's matcher give the same disparities.

- Per pixel: the Birchfield-Tomasi cost of a clipped horizontal Sobel image
  (in [0, 2 * cap]) plus that of the raw intensities shifted right by 2;
  OpenCV sets both images' first and last columns to the cap.
- Cost volume ``C[y, x, d]``: the pixel costs summed over a 21 x 21 window
  (``blockSize // 2`` each side) with rows and columns clamped, for x >=
  numDisparities.
- Paths: ``L_r(p, d) = C(p, d) + min(L_r(p - r, d), L_r(p - r, d +- 1) +
  P1, min_k L_r(p - r, k) + P2) - min_k L_r(p - r, k) - P2``, each path
  starting from zeros outside the image; ``S = sat(sat(L_lr + L_ul + L_u +
  L_ur) + L_rl)``.
- Selection: the first d of least S; the uniqueness test (no other d more
  than 1 away with ``S[d] * 60 < S_min * 100``); the right image's best
  match per column (least S, ties to the larger x); the parabola fit; the
  left-right check with ``disp12MaxDiff`` 1, rounding the disparity both
  ways; then the median.

The kernel (``sgbm``, five launches a pair, ``csrc/sgbm.cu``) replaces the
OpenCV call of the JAX package, not a TPU kernel. It is bounded by the
integer operations of its 21 M cells at 752x480 and by the latency of the
path chains: launch 1 builds the cost volume (a CTA per band of rows and
columns, the window sums running down the rows), launch 2 runs each of
the five paths of every row, column and diagonal as one warp, launch 3
selects each pixel's disparity, launch 4 is the left-right check and
launch 5 the median. Scratch: the 16-bit cost volume and the five paths'
int32 planes, allocated here.
"""

from __future__ import annotations

import torch

from ..render.blend_lists import count_launch

LAUNCHES = {"sgbm": 0}

NUM_DISP = 64
BLOCK = 20
UNIQUENESS = 40
P1, P2 = 2, 5
CAP = 15            # max(preFilterCap, 15) | 1 with preFilterCap 0
DISP12_MAX_DIFF = 1
DISP_SHIFT = 4
DISP_SCALE = 1 << DISP_SHIFT
INVALID = -DISP_SCALE   # (minDisparity - 1) * 16
MAX_COST = 32767


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _wrap16(x):
    """int32 -> the int16 value a C cast to short leaves, as int32."""
    return ((x + 32768) & 0xFFFF) - 32768


def _sat16(x):
    return x.clamp(-32768, 32767)


def _prefilter(img):
    """[H, W] uint8 -> (clipped horizontal Sobel, raw) int32 [H, W], first
    and last columns set to the cap as OpenCV's ``calcPixelCostBT`` does."""
    r = img.to(torch.int32)
    n = torch.cat([r[:1], r[:-1]], 0)    # the row above (itself at y 0)
    s = torch.cat([r[1:], r[-1:]], 0)    # the row below
    sob = torch.full_like(r, CAP)
    g = ((r[:, 2:] - r[:, :-2]) * 2 + n[:, 2:] - n[:, :-2]
         + s[:, 2:] - s[:, :-2])
    sob[:, 1:-1] = g.clamp(-CAP, CAP) + CAP
    raw = r.clone()
    raw[:, 0] = CAP
    raw[:, -1] = CAP
    return sob, raw


def _half_minmax(p):
    """Per pixel min and max of (p, the means with each neighbour), floored
    as integers; a border pixel's missing neighbour counts as itself."""
    left = torch.cat([p[:, :1], p[:, :-1]], 1)
    right = torch.cat([p[:, 1:], p[:, -1:]], 1)
    a = (p + left) // 2
    b = (p + right) // 2
    return (torch.minimum(torch.minimum(a, b), p),
            torch.maximum(torch.maximum(a, b), p))


def pixel_costs(left, right, num_disp=NUM_DISP):
    """Birchfield-Tomasi costs [H, W - num_disp, num_disp] int32 of left
    pixel x + num_disp against right pixel x + num_disp - d."""
    h, w = left.shape
    w1 = w - num_disp
    cost = torch.zeros((h, w1, num_disp), dtype=torch.int32,
                       device=left.device)
    xs = torch.arange(num_disp, w, device=left.device)
    x2 = xs[:, None] - torch.arange(num_disp, device=left.device)[None]
    for shift, (pl, pr) in zip((0, 2), zip(_prefilter(left),
                                           _prefilter(right))):
        u0, u1 = _half_minmax(pl)
        v0, v1 = _half_minmax(pr)
        u = pl[:, xs, None]
        u0, u1 = u0[:, xs, None], u1[:, xs, None]
        v, v0, v1 = pr[:, x2], v0[:, x2], v1[:, x2]
        c0 = torch.maximum(torch.maximum(u - v1, v0 - u),
                           torch.zeros_like(u - v1))
        c1 = torch.maximum(torch.maximum(v - u1, u0 - v),
                           torch.zeros_like(v - u1))
        cost += torch.minimum(c0, c1) >> shift
    return cost


def _box_clamped(x, dim, r):
    """Sums over a window of 2r+1 along ``dim``, indices clamped."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device)
    out = torch.zeros_like(x)
    for k in range(-r, r + 1):
        out += x.index_select(dim, (idx + k).clamp(0, n - 1))
    return out


def cost_volume(left, right, num_disp=NUM_DISP, block=BLOCK):
    """C [H, W - num_disp, num_disp] int32 holding OpenCV's int16 values."""
    r = block // 2
    pix = pixel_costs(left, right, num_disp)
    # OpenCV starts its cost buffer at P2 (cancelled by the paths' delta)
    return _wrap16(P2 + _box_clamped(_box_clamped(pix, 1, r), 0, r))


def _path_step(c, prev, prev_min):
    """One step of a path: L from the cost c [.., D] and the previous
    pixel's L (int16 values) and min (int16 value). Returns (L as int32
    before the store, L stored, min stored)."""
    big = torch.full_like(prev[..., :1], MAX_COST)
    lo = torch.cat([big, prev[..., :-1]], -1)
    hi = torch.cat([prev[..., 1:], big], -1)
    delta = prev_min[..., None] + P2
    m = torch.minimum(torch.minimum(prev, lo + P1),
                      torch.minimum(hi + P1, delta))
    lval = c + m - delta
    return lval, _wrap16(lval), _wrap16(lval.amin(-1))


def _horizontal(c, reverse):
    """One horizontal path over every row at once: [H, W1, D] int32."""
    h, w1, d = c.shape
    out = torch.empty_like(c)
    prev = torch.zeros((h, d), dtype=torch.int32, device=c.device)
    prev_min = torch.zeros((h,), dtype=torch.int32, device=c.device)
    for x in (range(w1 - 1, -1, -1) if reverse else range(w1)):
        lval, prev, prev_min = _path_step(c[:, x], prev, prev_min)
        out[:, x] = lval
    return out


def _shift_x(t, dx, fill=0):
    """t [W1, ...] with row x holding t[x + dx], ``fill`` outside."""
    out = torch.full_like(t, fill)
    if dx > 0:
        out[:-dx] = t[dx:]
    elif dx < 0:
        out[-dx:] = t[:dx]
    else:
        out = t.clone()
    return out


def aggregate(c):
    """S [H, W1, D] int32: the five paths summed and saturated as OpenCV's
    single pass does."""
    h, w1, d = c.shape
    l_lr = _horizontal(c, reverse=False)
    l_rl = _horizontal(c, reverse=True)
    s = torch.empty_like(c)
    prev = [torch.zeros((w1, d), dtype=torch.int32, device=c.device)
            for _ in range(3)]
    prev_min = [torch.zeros((w1,), dtype=torch.int32, device=c.device)
                for _ in range(3)]
    for y in range(h):
        vert = torch.zeros((w1, d), dtype=torch.int32, device=c.device)
        for i, dx in enumerate((-1, 0, 1)):   # up-left, up, up-right
            lval, prev[i], prev_min[i] = _path_step(
                c[y], _shift_x(prev[i], dx), _shift_x(prev_min[i], dx))
            vert += lval
        s[y] = _sat16(_sat16(l_lr[y] + vert) + l_rl[y])
    return s


def select(s, width, uniqueness=UNIQUENESS):
    """Disparities [H, W] int32 in 1/16 px from S [H, W1, D]: uniqueness,
    the parabola fit, the left-right check."""
    h, w1, d = s.shape
    dev = s.device
    min_d = d    # minX1: the first column with every disparity in range
    min_s, best = s.min(-1)             # first index of the least value
    ds = torch.arange(d, device=dev)
    rivals = ((s * (100 - uniqueness) < min_s[..., None] * 100)
              & ((best[..., None] - ds).abs() > 1))
    unique = ~rivals.any(-1)

    # right image: per matched column, the least S, ties to the larger x
    xs = torch.arange(w1, device=dev).expand(h, w1)
    x2 = xs + min_d - best
    key = min_s.to(torch.int64) * 8192 + (8191 - xs)
    key = torch.where(unique, key, torch.full_like(key, 1 << 40))
    best_key = torch.full((h, width), 1 << 40, dtype=torch.int64, device=dev)
    best_key.scatter_reduce_(1, x2.clamp(0, width - 1), key, "amin")
    has = best_key < (1 << 40)
    win_x = 8191 - (best_key % 8192)
    disp2 = torch.where(has, best.gather(1, win_x.clamp(0, w1 - 1)),
                        torch.full_like(win_x, INVALID))

    # the parabola through S[d - 1], S[d], S[d + 1]
    sm = s.gather(-1, (best - 1).clamp(0, d - 1)[..., None])[..., 0]
    s0 = min_s
    sp = s.gather(-1, (best + 1).clamp(0, d - 1)[..., None])[..., 0]
    denom2 = torch.clamp(sm + sp - 2 * s0, min=1)
    num = (sm - sp) * DISP_SCALE + denom2
    frac = torch.div(num, denom2 * 2, rounding_mode="trunc")
    inner = (best > 0) & (best < d - 1)
    d1 = torch.where(inner, best * DISP_SCALE + frac, best * DISP_SCALE)
    d1 = torch.where(unique, d1, torch.full_like(d1, INVALID))

    # left-right check: both roundings of the disparity must disagree
    x = xs + min_d
    lo = d1 >> DISP_SHIFT
    hi = (d1 + DISP_SCALE - 1) >> DISP_SHIFT

    def off(dd):
        xx = x - dd
        inside = (xx >= 0) & (xx < width)
        d2 = disp2.gather(1, xx.clamp(0, width - 1))
        return inside & (d2 >= 0) & ((d2 - dd).abs() > DISP12_MAX_DIFF)

    bad = (d1 != INVALID) & off(lo) & off(hi)
    d1 = torch.where(bad, torch.full_like(d1, INVALID), d1)
    out = torch.full((h, width), INVALID, dtype=torch.int32, device=dev)
    out[:, min_d:] = d1
    return out


def median3(disp):
    """3x3 median with replicated borders (OpenCV's ``medianBlur(.., 3)``)."""
    p = torch.nn.functional.pad(disp[None, None].float(), (1, 1, 1, 1),
                                mode="replicate")[0, 0]
    win = p.unfold(0, 3, 1).unfold(1, 3, 1).reshape(*disp.shape, 9)
    return win.median(-1).values.to(disp.dtype)


def sgbm_plain(left, right):
    """Disparities [H, W] int16 in 1/16 px of a rectified uint8 pair."""
    _check(left, right)
    c = cost_volume(left, right)
    s = aggregate(c)
    return median3(select(s, left.shape[1])).to(torch.int16)


def _check(left, right):
    if left.dtype != torch.uint8 or right.dtype != torch.uint8:
        raise ValueError("sgbm: the images must be uint8")
    if (left.dim() != 2 or left.shape != right.shape
            or left.device != right.device):
        raise ValueError(f"sgbm: expected two [H, W] images of one shape "
                         f"on one device, got {tuple(left.shape)} on "
                         f"{left.device} and {tuple(right.shape)} on "
                         f"{right.device}")
    if left.shape[1] <= NUM_DISP:
        raise ValueError(f"sgbm: width {left.shape[1]} must exceed "
                         f"numDisparities {NUM_DISP}")


def sgbm(left, right):
    """Disparities [H, W] int16 in 1/16 px (``StereoSGBM::compute``) of a
    rectified uint8 pair: the kernel on a CUDA tensor, else the plain
    version."""
    _check(left, right)
    if left.device.type != "cuda":
        return sgbm_plain(left, right)
    return _sgbm_cuda(left, right)


def _sgbm_cuda(left, right, marks=None):
    """The kernel's five launches; ``marks``: None, or six
    ``torch.cuda.Event``s (enable_timing) recorded before the first launch
    and after each, for the split of a call by launch."""
    import ctypes

    from .._build import library

    lib = library("sgbm")
    h, w = left.shape
    if w >= 8192:
        raise ValueError(f"sgbm: width {w} is too wide for the kernel, whose "
                         "right-image match keys hold a column in 13 bits")
    left, right = left.contiguous(), right.contiguous()
    dev, n = left.device, h * (w - NUM_DISP) * NUM_DISP
    cost = torch.empty(n, dtype=torch.int16, device=dev)
    paths = torch.empty(5 * n, dtype=torch.int32, device=dev)
    keys = torch.empty((h, w), dtype=torch.int32, device=dev)
    pre = torch.empty((h, w), dtype=torch.int16, device=dev)
    out = torch.empty((h, w), dtype=torch.int16, device=dev)
    stream = torch.cuda.current_stream(dev)
    handles = None
    if marks is not None:
        for e in marks:         # creates each event on the stream's device
            e.record(stream)
        handles = (ctypes.c_void_p * 6)(*[e.cuda_event for e in marks])
    rc = lib.sgbm_run(left.data_ptr(), right.data_ptr(), cost.data_ptr(),
                      paths.data_ptr(), keys.data_ptr(), pre.data_ptr(),
                      out.data_ptr(), h, w, stream.cuda_stream,
                      None if handles is None else ctypes.addressof(handles))
    if rc != 0:
        raise RuntimeError(f"sgbm_run: kernel launch failed with CUDA error "
                           f"{rc}")
    count_launch(LAUNCHES, "sgbm")
    return out


def sgbm_grids(h, w):
    """CTAs of each of the kernel's five launches for an [h, w] pair."""
    import ctypes

    from .._build import library

    ctas = (ctypes.c_int * 5)()
    library("sgbm").sgbm_grids(h, w, ctypes.addressof(ctas))
    return list(ctas)
