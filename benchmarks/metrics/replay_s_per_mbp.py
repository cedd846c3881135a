"""Seconds a Mbp of the C core's replay of the injected events:
CoreSession.set_events and CoreSession.scan."""

TARGETS = ("core.CoreSession.set_events", "core.CoreSession.scan")


def read(run):
    if run.mbp <= 0 or not run.found(*TARGETS):
        return None
    return run.seconds(*TARGETS) / run.mbp
