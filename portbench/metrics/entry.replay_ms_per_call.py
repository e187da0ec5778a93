"""entry.replay_ms_per_call: the host's milliseconds in the CUDA graph's
launch alone (``g.replay()``), the mean of the program's ``entry.replay``
spans (`repro_torch.obs`), which it records only while a profiler
records: over the traced window.  None without a device trace, or
unless there is one span for each call of the window."""


def read(ctx):
    if ctx.summary is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    replays = obs.spans("entry.replay")
    if not replays or len(replays) != ctx.calls:
        return None
    return 1e3 * sum(s.seconds for s in replays) / len(replays)
