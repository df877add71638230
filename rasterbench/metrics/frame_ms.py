"""frame_ms: the window's time over the requests it completed (host clock,
the whole window from the first issue to the last completion)."""


def read(ctx):
    if not ctx.window.completed:
        return None
    return ctx.window.seconds * 1e3 / ctx.window.completed
