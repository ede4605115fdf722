"""The BA loop's own work outside the spans within an iteration: the
densification statistics, the isotropic regulariser, the window
pose/exposure Adam and retraction, and the glue, in ms a BA iteration
(replica-sp-ba): the device-timeline self time of the program's span
``ba.iter`` in the traced call, over its ``ba.iters`` count."""

from portbench.harness.spans import self_ms_per_iter

SPANS = ("ba.iter",)


def read(ctx):
    return self_ms_per_iter(SPANS)
