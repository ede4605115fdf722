"""Device operations (kernels, copies, fills) the profiler recorded in the
traced BA call, per iteration."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t.get("missing"):
        return None
    return t["launches"] / ctx["chunk"]
