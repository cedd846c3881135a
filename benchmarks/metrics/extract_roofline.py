"""The extraction work's share of its roofline, in %: the least time the
H100 needs for the anchor and event passes over the bp of each extractor
call that starts in the window (harness/roofline.py, frozen floors of
bytes and int32 operations), over the whole device time of every kernel
those calls launched (torch.profiler).

A kernel belongs to a call when its launch lies inside the call's
profiler range on the launching thread, all on the trace's clock
(harness/trace.py), so no kernel of a counted call drops out.  It counts
the work, whatever kernels do it and whatever they are named.  The floor
stays frozen: it leaves out the packed overlay that the event pass also
stores (12.4 B/bp at the defaults), since a floor that grows with what the
program chooses to write is no yardstick.  Nothing to read without device
kernels in those calls."""

TARGETS = ("pipeline.scan_events_device",)


def read(run):
    from harness.roofline import extract_floor_s
    if run.trace is None:
        return None
    secs, lengths = run.trace.kernel_seconds_in(TARGETS[0])
    if secs <= 0 or not lengths:
        return None
    floor = sum(extract_floor_s(L, run.min_shift, run.max_shift)
                for L in lengths)
    return 100.0 * floor / secs
