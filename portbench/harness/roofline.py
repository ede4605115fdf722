"""The yardstick's roofline: one H100's published peaks and the operations
a blend kernel's function needs on a run's (list entry, pixel) pairs.

Frozen here from the port's ``utils/roofline.py`` (``kernel_ops``,
``kernel_tc_ops``, ``kernel_bound``), so that a change to the program
cannot move them; expf is charged the 10 float32 operations its SASS
showed when the kernels were first built for the card. The pairs are
counted by the benchmark's own binning and blend
(``reference/render.py``), never by the program, so the count does not
move when a change fuses, replaces or renames a kernel.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the full 700 W limit):
3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores, 495
TFLOP/s in TF32.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
EXPF_OPS = 10
ROW_FLOATS = 10     # a list entry's inputs: u, v, the conic, log opacity,
                    # r, g, b, z (``reference.render.ROW_COLS``)


def kernel_ops(name: str, n: dict, e_exp: int = EXPF_OPS) -> int:
    """Float32 operations of the mapping step ``name`` on pairs ``n``
    (walked, ok, contrib, live): walked pairs the offset, the log-alpha
    quadratic, two clamps, expf and the two alpha tests; ok pairs 1 - a,
    T (1 - a) and its test; contributing pairs the weight and five weighted
    sums; its reverse on contributing pairs (13, 17 with a depth column)
    and on live pairs (a < 0.99) 16 more."""
    fwd = (16 + e_exp) * n["walked"] + 3 * n["ok"] + 10 * n["contrib"]
    live, dead = n["live"], n["contrib"] - n["live"]
    return {
        "map_grad": fwd + 29 * live + 13 * dead,
        "map_grad_rgbd": fwd + 33 * live + 17 * dead,
    }[name]


def kernel_tc_ops(name: str, n: dict) -> int:
    """The part of ``kernel_ops`` a kernel may do as TF32 products: the
    mapping step's feature sums and conic moments."""
    live, contrib = n["live"], n["contrib"]
    return {"map_grad": 6 * contrib + 12 * live,
            "map_grad_rgbd": 8 * contrib + 12 * live}.get(name, 0)


def map_grad_bytes(tiles: int, k_fine: int, pixels: int, rgbd: bool) -> int:
    """Bytes the mapping step reads and writes once: each list entry's
    inputs and their cotangents, and the frame's colour, mask (and depth)
    at every pixel of the tiles."""
    return 4 * (2 * tiles * k_fine * ROW_FLOATS
                + tiles * pixels * (5 if rgbd else 4))


def bound_s(name: str, n: dict, n_bytes: int) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate."""
    ops = kernel_ops(name, n)
    tc = kernel_tc_ops(name, n)
    t_ops = (ops - tc) / FP32_FLOPS_PER_S + tc / TF32_FLOPS_PER_S
    return max(n_bytes / HBM_BYTES_PER_S, t_ops)
