"""The benchmark's plain reference of ribbit (numpy and Python alone):
engine.process_sequence gives the BED lines of one sequence, events.py of
this package the scanner replays, and streams.py the event streams that
the port's device extractor stitches."""
