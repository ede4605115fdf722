"""Binning: the views' tile lists, built at a call's start and rebuilt
within it, in ms a BA iteration (fr3-mono-ba): the device-timeline self time
of the program's span ``ba.rebin`` in the traced call, over its ``ba.iters``
count."""

from portbench.harness.spans import self_ms_per_iter

SPANS = ("ba.rebin",)


def read(ctx):
    return self_ms_per_iter(SPANS)
