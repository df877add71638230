"""upload_s: seconds to upload the plan (CompiledScene) and to capture the
frame's graph (the first request), each span ended with a synchronize."""


def read(ctx):
    if "upload" not in ctx.spans or "capture" not in ctx.spans:
        return None
    return ctx.spans["upload"] + ctx.spans["capture"]
