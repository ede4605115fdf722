"""``render_map_grad``'s preprocess and pack of the map for a view, and the
gather and mask of its listed rows, in ms a BA iteration (replica-sp-ba):
the device-timeline self time of the program's span ``ba.prep`` in the
traced call, over its ``ba.iters`` count."""

from portbench.harness.spans import self_ms_per_iter

SPANS = ("ba.prep",)


def read(ctx):
    return self_ms_per_iter(SPANS)
