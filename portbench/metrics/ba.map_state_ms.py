"""The map's state: its Adam step, densify and prune, and the opacity
resets, in ms a BA iteration (replica-sp-ba): the device-timeline self time
of the program's spans ``ba.map_adam`` and ``ba.densify`` in the traced
call, over its ``ba.iters`` count."""

from portbench.harness.spans import self_ms_per_iter

SPANS = ("ba.map_adam", "ba.densify")


def read(ctx):
    return self_ms_per_iter(SPANS)
