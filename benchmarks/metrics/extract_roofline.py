"""The extraction work's share of its roofline, in %: the least time the
H100 needs for the anchor and event passes over the bp each extractor
call covered (harness/roofline.py, frozen floors of bytes and int32
operations), over the device time of every kernel launched inside the
extractor's spans (torch.profiler).  It counts the work, whatever kernels
do it.  Nothing to read without device kernels in those spans."""

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
