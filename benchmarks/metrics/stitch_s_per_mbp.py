"""Seconds a Mbp of stitching (eventstitch: clip and merge): the self time
of pipeline.scan_events_segmented over its extractor calls, on contigs of
more than one segment (a one-segment contig is not stitched: nothing to
read)."""

TARGETS = ("pipeline.scan_events_segmented", "pipeline.scan_events_device")


def read(run):
    from harness.spans import self_seconds
    secs, most = self_seconds(run.spans, *TARGETS)
    if run.mbp <= 0 or most < 2:
        return None
    return secs / run.mbp
