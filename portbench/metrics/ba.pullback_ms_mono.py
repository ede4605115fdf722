"""The pull-back of a view's row cotangents to the Gaussians in
``render_map_grad`` (``torch.autograd.grad`` through the gather
``packed[lists.idx]`` and the preprocess), in ms a BA iteration
(fr3-mono-ba): the device-timeline self time of the program's span
``ba.pullback`` in the traced call, over its ``ba.iters`` count."""

from portbench.harness.spans import self_ms_per_iter

SPANS = ("ba.pullback",)


def read(ctx):
    return self_ms_per_iter(SPANS)
