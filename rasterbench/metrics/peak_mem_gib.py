"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and the
window, read before the reference runs, in GiB.  The window's peak is taken
less the bytes of the layers the run keeps for its check (2 frames), which
no deployment holds: the larger of that and set-up's peak."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
