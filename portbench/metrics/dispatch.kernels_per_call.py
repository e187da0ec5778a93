"""dispatch.kernels_per_call: the device's operations (kernels, copies
and fills) in the traced window over the calls in it.  Read from the
trace: the kernels' own launch counters do not move at a replay."""


def read(ctx):
    if ctx.summary is None or not ctx.calls:
        return None
    return ctx.summary.ops / ctx.calls
