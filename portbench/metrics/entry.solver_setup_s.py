"""entry.solver_setup_s: the seconds of the program's ``solver.setup``
spans (`repro_torch.obs`: diag(den(P)), rho and the solver's device
tables, where they miss the operator's memo) that run inside an entry's
capture (an ``entry.capture`` span around them): the set-up that the
entry's first call pays, and not the harness's own solves after the
window; 0 where the entry runs no solver.  Read in a traced run; None
without a device trace or where the program records no ``entry.capture``
span."""


def read(ctx):
    if ctx.summary is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    if not obs.spans("entry.capture"):
        return None
    return sum(s.seconds for s in obs.spans("solver.setup")
               if _in_capture(obs, s))


def _in_capture(obs, s) -> bool:
    while s.parent is not None:
        s = obs.get(s.parent)
        if s.name == "entry.capture":
            return True
    return False
