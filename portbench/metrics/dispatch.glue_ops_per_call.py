"""dispatch.glue_ops_per_call: the device operations of a call that are
not the program's own kernels (the pad and crop, copies in and out,
fills, PyTorch's elementwise updates): the trace's operations over the
window's calls, less the program's launches per replay, which its
counters give (`repro_torch.obs`: ``kernels.replayed_launches`` over
``entry.replays``).  None without a trace or a replay counted."""


def read(ctx):
    if ctx.summary is None or not ctx.calls:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    c = obs.counters()
    replays = c.get("entry.replays", 0)
    if not replays:
        return None
    return (ctx.summary.ops / ctx.calls
            - c.get("kernels.replayed_launches", 0) / replays)
