"""Seconds a Mbp in filling the C core's packed overlay cache from the
event pass's words (CoreSession.set_overlay, with its device-to-host
copy): the program's replay.overlay spans, one a contig."""

from harness import program

TARGETS = ()
SPAN = "replay.overlay"

program.enable()


def read(run):
    return program.seconds_per_mbp(run, SPAN)
