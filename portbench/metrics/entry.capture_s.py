"""entry.capture_s: the entry's own ``capture_ms`` counter at the cell's
shape (one eager run that builds the kernels' launches and the solver's
set-up, then the capture into a CUDA graph), in seconds."""


def read(ctx):
    return ctx.capture_s
