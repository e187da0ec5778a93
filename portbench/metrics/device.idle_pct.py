"""device.idle_pct: the share of the traced window in which no operation
ran on the device (`torch.profiler`), in percent."""


def read(ctx):
    if ctx.summary is None or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.summary.busy_s / ctx.window_s)
