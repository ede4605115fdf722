"""Share of the traced BA call's wall time in which no operation ran on
the card (100 x (1 - busy / wall), busy the union of the profiler's device
events)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t.get("missing"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
