"""entry.host_ms_per_call: the host's milliseconds inside one call into
the entry (copy in, replay, copy out, all enqueued), a span the harness
takes around each call of the window, averaged over the window."""


def read(ctx):
    if not ctx.host:
        return None
    return 1e3 * sum(ctx.host) / len(ctx.host)
