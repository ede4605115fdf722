"""BA iterations a second over the traced run's window outside its traced
and sync-counted calls (host-paced in the monocular cell)."""


def read(ctx):
    if not ctx.get("rate_s"):
        return None
    return ctx["rate_iters"] / ctx["rate_s"]
