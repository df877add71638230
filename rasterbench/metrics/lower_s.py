"""lower_s: seconds in render_plan.lower_scene (a span of the benchmark)."""


def read(ctx):
    return ctx.spans.get("lower")
