"""Seconds a Mbp of refinement: CoreSession.refine (the C pool) and
refine_batched.refine_batched, when that route runs."""

TARGETS = ("core.CoreSession.refine", "refine_batched.refine_batched")


def read(run):
    if run.mbp <= 0 or not run.found(*TARGETS):
        return None
    return run.seconds(*TARGETS) / run.mbp
