"""setup_s: process start to the first timed request (generation, parse,
lowering, upload, the graph's capture, the warm-up requests; the first run
in a checkout also builds the kernels)."""


def read(ctx):
    return ctx.setup_s
