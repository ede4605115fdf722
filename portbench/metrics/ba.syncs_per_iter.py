"""Host synchronisations per BA iteration: the card's sync debug mode's
count over one ``map_iters`` call of the window, over its iterations."""


def read(ctx):
    if ctx.get("syncs") is None:
        return None
    return ctx["syncs"] / ctx["chunk"]
