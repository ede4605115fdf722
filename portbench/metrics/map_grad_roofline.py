"""The monocular mapping step's share of its roofline in a BA iteration: the
least time the card could take for the step's work (counted by the
benchmark's own binning and blend at the window's views, turned into
operations and bytes by ``harness/roofline.py``) over the device time of
the kernels named here in the traced call, per iteration."""

KERNELS = ("map_grad_kernel<false",)
WORK = "map_grad"


def read(ctx):
    t, w = ctx.get("trace"), ctx.get("work")
    if not t or t.get("missing") or not w or w["kernel"] != WORK:
        return None
    dev_s = sum(s for name, (s, _) in t["kernels"].items()
                if any(k in name for k in KERNELS))
    if dev_s <= 0:
        return None
    return 100.0 * w["bound_s"] / (dev_s / ctx["chunk"])
