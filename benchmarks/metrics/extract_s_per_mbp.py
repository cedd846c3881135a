"""Seconds a Mbp in the device extractor (H2D, K1/K2, D2H, C decode):
spans around pipeline.scan_events_device, which returns host arrays, so
a host clock holds all of its work."""

TARGETS = ("pipeline.scan_events_device",)


def read(run):
    if run.mbp <= 0 or not run.found(*TARGETS):
        return None
    return run.seconds(*TARGETS) / run.mbp
