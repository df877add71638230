"""parse_s: seconds in frontend.svg.scene_from_str (a span of the benchmark)."""


def read(ctx):
    return ctx.spans.get("parse")
