"""plan.pack_s: the seconds of the program's own ``plan.pack`` span
(`repro_torch.obs`): in ``plan("cuda")``, P to float32 host numpy, the
host's Block-ELL packing, its copy to the card and the sliced-ELL layout
packed there.  A set-up span, always recorded, read in a traced run (as
the device trace's readers are); None without a device trace or where
the program has no such span."""


def read(ctx):
    if ctx.summary is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    packs = obs.spans("plan.pack")
    return sum(s.seconds for s in packs) if packs else None
