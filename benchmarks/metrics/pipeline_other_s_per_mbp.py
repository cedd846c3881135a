"""Seconds a Mbp that the consumer thread (the one that iterates the
records) spends in the record loop outside every layer span: waiting on
the device thread, encode, the FASTA read, the loop itself."""

TARGETS = ("pipeline.scan_events_device", "pipeline.scan_events_segmented",
           "core.CoreSession.set_events", "core.CoreSession.scan",
           "core.CoreSession.refine", "refine_batched.refine_batched")


def read(run):
    from harness.spans import union
    if run.mbp <= 0:
        return None
    busy = union((a, b) for _t, th, a, b, _n in run.spans
                 if th == run.main_thread)
    return (run.window_s - busy) / run.mbp
